"""The methanation march at an unphysical prior draw in float64, through
both packages: draw 0 of the JAX prior's ``sample(jax.random.key(3), 16)``
(a negative first kinetic parameter) on the 4-condition model of
``tests/torch_mesh.py::METH_KW``, where the two packages' float32 flows
part by up to 1.4 sccm in lanes that pass in both
(``test_torch_sharding_methanation.py``). Each package's plain route
("thomas": the JAX package's XLA scan, the port's Python loops) runs the
same march with float64 conditions, initial state and kinetics: the flows
agree, so the float32 difference is the march's sensitivity to rounding at
this theta, not a fault of the port. The JAX side runs under
``jax.enable_x64`` (restored on exit), its program traced at
``_NX_UNROLL = 1`` (the same arithmetic)."""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from smc_tpu.models import methanation as JM
from smc_tpu.ops import dae_fast as jdf
from smc_tpu_torch.models import methanation as TM
from tests.torch_mesh import METH_KW
from tests.torch_parity import methanation_pair


def _initial_guess_t(cond, nx):
    """The port's initial_guess in float64 (it makes float32)."""
    y = torch.zeros((cond.n_data, nx, 7), dtype=torch.float64)
    y[:, :, :5] = cond.C_in[:, None, :]
    y[:, :, 5] = 400.0
    y[:, 0, 5] = cond.T_in
    y[:, :, 6] = cond.u_in[:, None]
    return y


def _initial_guess_j(cond, nx):
    """The JAX package's initial_guess in float64 (it makes float32)."""
    y = jnp.zeros((cond.n_data, nx, 7), jnp.float64)
    y = y.at[:, :, :5].set(cond.C_in[:, None, :])
    y = y.at[:, :, 5].set(400.0)
    y = y.at[:, 0, 5].set(cond.T_in)
    return y.at[:, :, 6].set(cond.u_in[:, None])


def test_unphysical_draw_flows_agree_in_float64():
    """Draw 0's flows in float64: the two packages within 1e-6 sccm
    (measured 9e-9) with the same failed condition; the port's float32
    flows within 0.01 sccm of float64 (measured 0.0025; the JAX package's
    float32 flows were 1.43 sccm from it on the same CPU)."""
    jm, tm = methanation_pair(n_conditions=4, **METH_KW)
    theta = np.array(jm.prior.sample(jax.random.key(3), 16), np.float32)[:1]
    assert theta[0, 0] < 0
    full = np.array(tm.base_params, np.float64)[None]
    full[:, list(tm.est_idx)] = theta
    kin = full[:, :8]
    fields = [f.name for f in dataclasses.fields(tm.cond)]

    cond_t = TM.Conditions(*(getattr(tm.cond, f).double() for f in fields))
    port = dataclasses.replace(tm, cond=cond_t, solver="thomas")
    with mock.patch.object(TM, "initial_guess", _initial_guess_t):
        flows_t = port._flows_batch_bl(torch.from_numpy(kin))
    assert flows_t.dtype == torch.float64
    flows_t = flows_t.numpy()[0]

    with jax.enable_x64(True):
        cond_j = JM.Conditions(**{f: jnp.asarray(
            np.asarray(getattr(jm.cond, f)), jnp.float64) for f in fields})
        ref = dataclasses.replace(jm, cond=cond_j, solver="thomas")
        with mock.patch.object(JM, "initial_guess", _initial_guess_j), \
                mock.patch.object(jdf, "_NX_UNROLL", 1):
            flows_j = jax.jit(ref._flows_batch_bl)(jnp.asarray(kin))
            assert flows_j.dtype == jnp.float64
        flows_j = np.asarray(flows_j)[0]

    failed = (flows_j == -10000.0).all(axis=0)
    assert failed.any() and not failed.all()
    np.testing.assert_array_equal((flows_t == -10000.0).all(axis=0), failed)
    np.testing.assert_allclose(flows_t, flows_j, rtol=0, atol=1e-6)
    f32 = tm.log_likelihood(torch.from_numpy(theta))[1].numpy()[0]
    np.testing.assert_allclose(f32, flows_j, rtol=0, atol=0.01)

"""The methanation model and the ensemble over several processes, the
counterpart of ``tests/test_sharding_methanation.py`` (nx = 11): on a gloo
world of four CPU ranks, the likelihood with the particles split and the
condition axis split over a (2, 2) mesh's "data" axis (``lane_mesh``),
each against the JAX package's model on the same condition table,
observations and theta; the steady march's gradient through the lane mesh;
the MM ensemble (and SBC) on the (2, 2) mesh; and one sharded methanation
step. One world runs every case.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_parity  # noqa: F401  (one PyTorch thread per worker)
from smc_tpu.ops import dae_fast as jdf
from smc_tpu_torch import SMCConfig
from smc_tpu_torch.models import methanation as TM
from smc_tpu_torch.models.methanation import FAILURE_SENTINEL
from smc_tpu_torch.smc.driver import init_state, make_smc_step
from smc_tpu_torch.smc.ensemble import run_ensemble_on_device
from smc_tpu_torch.smc.sbc import mm_sbc_problem, sbc_ranks
from tests.torch_mesh import (ENSEMBLE_CFG, METH_KW, STEADY_KW,
                              ensemble_problem, load, methanation_cases,
                              methanation_from_arrays, methanation_theta,
                              run_world)
from tests.torch_parity import methanation_pair

RANKS = 4


@pytest.fixture(scope="module")
def jax_side():
    """The JAX model over a 4-condition table (the 2-D case's size), the
    port's one-process model over the same arrays, and JAX's likelihood at
    both cases' thetas: the first case's 16 particles and, as in
    tests/test_sharding_methanation.py, 16 prior draws of key 3. One
    program, traced with the NX-scan unroll at 1 (the same arithmetic,
    compiled in a sixth of the time)."""
    jm, tm = methanation_pair(n_conditions=4, **METH_KW)
    meth = dict(cond=TM.condition_table_numpy(4, nx=METH_KW["nx"]),
                obs=tm.obs.numpy(), theta_lik=methanation_theta(),
                theta_lane=np.array(jm.prior.sample(jax.random.key(3), 16),
                                    np.float32))
    with mock.patch.object(jdf, "_NX_UNROLL", 1):
        lik = jax.jit(jm.log_likelihood)
        want = {k: tuple(np.asarray(a) for a in lik(jnp.asarray(meth[k])))
                for k in ("theta_lik", "theta_lane")}
    return meth, want


@pytest.fixture(scope="module")
def world(tmp_path_factory, jax_side):
    return run_world(tmp_path_factory.mktemp("sharding_meth"), RANKS,
                     methanation_cases, jax_side[0])


def _hold_to_jax(got, want):
    ll, fl = want
    np.testing.assert_allclose(got["ll"], ll, rtol=1e-4, atol=0.05)
    np.testing.assert_allclose(got["flows"], fl, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(got["flows"] == FAILURE_SENTINEL,
                                  fl == FAILURE_SENTINEL)


def test_sharded_methanation_likelihood_matches(world, jax_side):
    """The 16 particles over four ranks: the gathered likelihood and flows
    are the JAX model's on the same theta."""
    _hold_to_jax(load(world, "lik"), jax_side[1]["theta_lik"])


def test_methanation_2d_mesh_condition_axis_sharded(world, jax_side):
    """lane_mesh on a (2, 2) mesh: each rank marches 2 of the 4
    conditions for its 8 of the 16 particles. At the first case's theta
    the summed likelihood and the gathered flows are the JAX model's. At
    the 16 prior draws the likelihood and the failed lanes are JAX's, and
    the flows are the port's one-process model's: there the port's own
    flows of draw 0 (a negative first kinetic parameter) part from JAX's
    beyond rtol 1e-3, without a mesh too (ROADMAP.md, Queue 3)."""
    got = load(world, "lane_theta_lik")
    assert int(got["local_conditions"]) == 2
    _hold_to_jax(got, jax_side[1]["theta_lik"])
    meth, want = jax_side
    got = load(world, "lane_theta_lane")
    ll, fl = want["theta_lane"]
    np.testing.assert_allclose(got["ll"], ll, rtol=1e-4, atol=0.05)
    np.testing.assert_array_equal(got["flows"] == FAILURE_SENTINEL,
                                  fl == FAILURE_SENTINEL)
    base = methanation_from_arrays(meth)
    one_ll, one_fl = base.log_likelihood(torch.from_numpy(meth["theta_lane"]))
    np.testing.assert_allclose(got["ll"], one_ll.numpy(), rtol=1e-4,
                               atol=0.05)
    np.testing.assert_allclose(got["flows"], one_fl.numpy(), rtol=1e-3,
                               atol=1e-3)
    with pytest.raises(ValueError, match="do not divide"):
        dataclasses.replace(
            base, lane_mesh=type("M", (), {"size": lambda self, i: 3})())


def test_lane_mesh_steady_gradient_matches_one_process(world):
    """The gradient of the summed likelihood through the lane mesh
    (march="steady", the gradient mutations' path): every rank's rows
    against the one-process gradient, and the two ranks of a data group,
    which hold the same rows, bit-equal (the same proposals follow)."""
    m = TM.MethanationModel.default(n_conditions=4, seed=0, device="cpu",
                                    **STEADY_KW)
    th = torch.from_numpy(methanation_theta()).requires_grad_(True)
    ll = m.log_likelihood(th)[0]
    (g,) = torch.autograd.grad(ll.sum(), th)
    assert torch.isfinite(g).all()
    by_rows = {}
    for r in range(RANKS):
        got = load(world, f"grad_r{r}")
        lo, hi = got["rows"].tolist()
        np.testing.assert_allclose(got["ll"], ll.detach()[lo:hi].numpy(),
                                   rtol=1e-5)
        np.testing.assert_allclose(got["grad"], g[lo:hi].numpy(),
                                   rtol=1e-3, atol=1e-6)
        by_rows.setdefault((lo, hi), []).append(got["grad"])
    assert len(by_rows) == 2
    for grads in by_rows.values():
        np.testing.assert_array_equal(grads[0], grads[1])


def test_ensemble_on_2d_dataset_sharded_mesh(world):
    """4 populations over the "data" axis x particle halves over the
    "particles" axis: each rank holds (2, 64, 3); every population
    converges; and one ensemble step on the mesh is the one-process
    ensemble's step from the same seed (the same draws), within
    reduction reassociation."""
    s = load(world, "ensemble")
    assert s["local"].tolist() == [2, 64, 3]
    assert (s["gamma"] == 1.0).all()
    p = s["particles"]
    assert p.shape == (4, 128, 3)
    assert np.abs(p[:, :, 0].mean(1) - 1.2).max() < 0.25
    assert np.abs(p[:, :, 1].mean(1) - 0.5).max() < 0.25
    got = load(world, "ensemble_step")
    prior, loglik, obs = ensemble_problem()
    want = run_ensemble_on_device(0, prior, loglik, obs, 4,
                                  SMCConfig(**ENSEMBLE_CFG, max_steps=1))
    assert (got["step"] == 1).all()
    np.testing.assert_allclose(got["gamma"], want.gamma.numpy(), rtol=1e-5)
    np.testing.assert_array_equal(got["n_mh"], want.n_mh.numpy())
    np.testing.assert_allclose(got["particles"], want.particles.numpy(),
                               rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(got["log_evidence"],
                               want.log_evidence.numpy(), rtol=1e-5)


def test_sbc_on_a_mesh(world):
    """sbc_ranks(mesh=) on the (2, 2) mesh: the same truths as in one
    process (the draws are the shared generator's) and ranks in [0, L]."""
    got = load(world, "sbc")
    prior, simulate, loglik = mm_sbc_problem(n_datasets=3, device="cpu")[:3]
    _, truths, _ = sbc_ranks(0, prior, simulate, loglik, 4,
                             SMCConfig(n_particles=64), 31)
    np.testing.assert_array_equal(got["truths"], truths)
    assert got["ranks"].shape == (4, 3)
    assert ((got["ranks"] >= 0) & (got["ranks"] <= 31)).all()


def test_sharded_methanation_smc_step(world):
    """One step of the methanation model with its 32 particles over four
    ranks: finite, each rank holding 8 rows, and the one-process step's
    particles within reduction reassociation."""
    got = load(world, "step")
    assert int(got["local_rows"]) == 8
    assert np.isfinite(got["particles"]).all()
    m = TM.MethanationModel.default(n_conditions=2, seed=0, device="cpu",
                                    **{**METH_KW, "particle_chunk": 32})
    cfg = SMCConfig(n_particles=32, mh_steps=1, mh_steps_final=1)
    want = make_smc_step(m, cfg)(init_state(0, m, cfg))
    np.testing.assert_allclose(got["particles"], want.particles.numpy(),
                               rtol=5e-4, atol=1e-5)
    assert float(got["gamma"]) == pytest.approx(float(want.gamma), rel=1e-5)

"""The port's conservative methanation path (``pivot=True``: full Newton
with the pivoted fused block-Thomas solve, plain PyTorch in both packages'
sense: the reference has no kernel for it) against the JAX package on the
CPU, and a whole small tempered-SMC run of the port on the methanation
likelihood.

The JAX side compiles one march here, once, for the likelihood and the
final state together; the lagged-Jacobian march is in
``test_torch_methanation.py``. The two files cannot share a compiled
march: their schedules differ (pivoted full Newton here, the lagged
Jacobian there), so their programs do.
"""
import numpy as np
import pytest
import torch

from smc_tpu_torch import SMCConfig, make_full_run_on_device, run_smc
from smc_tpu_torch.models import methanation as TM
from smc_tpu_torch.ops import dae_fast as tdf
from smc_tpu_torch.smc.diagnostics import failed_solve_count
from tests.torch_parity import (jax_loglik_and_final_state, methanation_pair,
                                torch_march_final_state)

NX, NC = 11, 2
THETA = np.array([[13.04, 52.2e3, 1.147e5, 96.7e3, 5.0],
                  [18.0, 54e3, 2e5, 1.0e5, 4.0]], np.float32)


@pytest.fixture(scope="module")
def pair():
    # The reference's own engine cross-check runs this schedule
    # (10 steps, growth 1.6, 3 Newton iterations, every step factored).
    return methanation_pair(NC, NX, n_steps=10, growth=1.6, pivot=True,
                            newton_iters=3, particle_chunk=4)


def test_pivoted_march_flows_and_loglik_match_jax(pair):
    """Flows at rtol 1e-3 / atol 5e-3 sccm, the tolerance the JAX package
    holds its lanes-major engine to against its per-system one."""
    jm, tm = pair
    ((jll, jfl, yj),) = jax_loglik_and_final_state(jm, (THETA,))
    tll, tfl = tm.log_likelihood(torch.from_numpy(THETA))
    np.testing.assert_allclose(tfl.numpy(), np.asarray(jfl), rtol=1e-3,
                               atol=5e-3)
    np.testing.assert_allclose(tll.numpy(), np.asarray(jll), rtol=1e-3,
                               atol=0.05)
    assert int(failed_solve_count(tfl)) == 0
    # and the whole final state, at 1e-4 of each field's largest value
    yt = torch_march_final_state(tm, THETA)
    scale = np.abs(yj).max(axis=(1, 2), keepdims=True)
    assert (np.abs(yt - yj) / scale).max() < 1e-4


def test_march_final_state_and_engine_options():
    """bdf_march_bl itself on a shared start: the per-step modified Newton
    (jac_stride 1), the lagged march and the pivoted full Newton converge to
    the same final state (they solve the same BDF equations), order 1 runs,
    a bad lag split is refused, and the tangent-built Jacobian slots give
    the closed-form march's state."""
    _, tm = methanation_pair(NC, NX, n_steps=12, growth=1.6, jac_stride=3,
                             dense_tail=3)
    rows, jac, y0, _ = tm._lane_problem(torch.tensor([TM.KIN_TRUE]))
    dts = tm._dts()
    # The three schemes differ only while Newton has not converged. On this
    # short schedule's large steps modified Newton converges linearly: after
    # 6 iterations it is within 5e-3 of each field's largest value.
    kw = dict(newton_iters=6, analytic_jac=jac)
    y_lag = tdf.bdf_march_bl(rows, y0, dts, pivot=False, jac_stride=3,
                             dense_tail=3, reuse_iters=6, solver="auto", **kw)
    y_dense = tdf.bdf_march_bl(rows, y0, dts, pivot=False, **kw)
    y_piv = tdf.bdf_march_bl(rows, y0, torch.from_numpy(dts), pivot=True,
                             **kw)
    assert y_lag.shape == y0.shape and torch.isfinite(y_lag).all()
    scale = y_piv.abs().amax(dim=(1, 2), keepdim=True)
    assert ((y_dense - y_piv).abs() / scale).max() < 5e-3
    assert ((y_lag - y_piv).abs() / scale).max() < 5e-3
    y_be = tdf.bdf_march_bl(rows, y0, dts, order=1, pivot=False, **kw)
    assert torch.isfinite(y_be).all()
    with pytest.raises(ValueError):
        tdf.bdf_march_bl(rows, y0, dts, pivot=False, jac_stride=5,
                         n_dense=0, **kw)
    # Slots the callback does not supply are built by tangent passes: none
    # ("ad") or only slot 2 give the closed-form march's state, to the
    # blocks' fp32 rounding carried through the march.
    y_ref = tdf.bdf_march_bl(rows, y0, dts, pivot=False, newton_iters=2,
                             analytic_jac=jac)
    for partial in (None, lambda *a: {2: jac(*a)[2]}):
        y_tan = tdf.bdf_march_bl(rows, y0, dts, pivot=False, newton_iters=2,
                                 analytic_jac=partial)
        assert ((y_tan - y_ref).abs() / scale).max() < 1e-4


def test_default_model_and_outputs():
    """``default`` builds its observations from the true kinetics with
    seeded noise; flows, mole fractions and the datalist subset."""
    kw = dict(nx=NX, n_steps=12, growth=1.6, jac_stride=3, dense_tail=3,
              device="cpu")
    m = TM.MethanationModel.default(n_conditions=3, **kw)
    clean = TM.MethanationModel.default(n_conditions=3, noise=False, **kw)
    again = TM.MethanationModel.default(n_conditions=3, **kw)
    assert torch.equal(m.obs, again.obs) and m.obs.shape == (5, 3)
    assert m.param_names == ("Af", "Eaf", "Ar", "Ear", "sigma")
    noise = (m.obs - clean.obs) / TM.SIGMA_TRUE
    assert 0.3 < float(noise.std()) < 2.0
    kin = torch.tensor(TM.KIN_TRUE)
    flows = m.simulate_flows(kin)
    assert torch.equal(flows, clean.obs) and (flows > -1.0).all()
    frac = m.simulate_molfractions(kin)
    torch.testing.assert_close(frac.sum(0), torch.ones(3))
    sub = TM.MethanationModel.default(n_conditions=3, datalist=(0, 2),
                                      noise=False, **kw)
    torch.testing.assert_close(sub.obs, clean.obs[:, [0, 2]])
    # elemental balances close at the outlet: carbon and argon
    c = m.cond
    F_in = (c.C_in * c.u_in[:, None] * TM.AREA * 60 * TM.R_GAS * 298
            / TM.P_STP * 1e6)
    torch.testing.assert_close(flows[1] + flows[2], F_in[:, 1], rtol=5e-3,
                               atol=0)
    torch.testing.assert_close(flows[4], F_in[:, 4], rtol=5e-3, atol=0)


@pytest.mark.parametrize("entry", ["full_run", "run_smc"])
def test_small_smc_run_reaches_gamma_one(entry, capsys):
    """The port alone: N = 32 on the methanation likelihood to gamma = 1
    with finite particles and evidence, through both run loops."""
    model = TM.MethanationModel.default(
        n_conditions=NC, nx=NX, n_steps=12, growth=1.6, jac_stride=3,
        dense_tail=3, particle_chunk=32, device="cpu")
    cfg = SMCConfig(n_particles=32, mh_steps=2, mh_steps_final=4,
                    max_steps=30)
    if entry == "full_run":
        state = make_full_run_on_device(model, cfg)(0)
    else:
        state = run_smc(model, cfg, 0, verbose=True)
        assert "New Gamma:1.000000" in capsys.readouterr().out
    p = state.particles
    assert float(state.gamma) == 1.0
    assert p.shape == (32, 5) and torch.isfinite(p).all()
    assert torch.isfinite(state.log_lik).all()
    assert np.isfinite(float(state.log_evidence))
    assert model.prior.in_support(p).all()
    assert 0.5 < float(p[:, 4].mean()) < 15.0

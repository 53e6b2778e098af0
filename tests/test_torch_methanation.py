"""The port's methanation model against the JAX package on the CPU, at
nx = 11, 2 conditions and at most 5 particles: condition table, prior,
schedule, residual rows, every Jacobian slot, and the lagged-Jacobian BDF2
march through to flows and log-likelihood. Both packages get the same
condition arrays and observations (``torch_parity.methanation_pair``).

The JAX side compiles one march here (the lagged schedule), once, for
both parameter sets (``jax_runs``); the pivoted full-Newton march is in
``test_torch_methanation_pivot.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smc_tpu.models import methanation as JM
from smc_tpu_torch.models import methanation as TM
from smc_tpu_torch.ops.dae import geometric_schedule
from smc_tpu_torch.smc.diagnostics import failed_solve_count
from tests.torch_parity import (jax_loglik_and_final_state, methanation_pair,
                                torch_march_final_state)

NX, NC = 11, 2
# jac_stride 3, dense_tail 3, 12 steps: a lagged middle of 3 blocks.
LAGGED = dict(n_steps=12, growth=1.6, jac_stride=3, dense_tail=3,
              particle_chunk=4)
THETA = np.array([[13.04, 52.2e3, 1.147e5, 96.7e3, 5.0],
                  [18.0, 54e3, 2e5, 1.0e5, 4.0]], np.float32)
# Extreme kinetics (the reference's own failure test).
CRAZY = np.array([[3e2, 1e3, 3e6, 1e3, 14.9],
                  [339.0, 0.0, 3.5e6, 0.0, 0.51]], np.float32)
# Flows: the tolerance the JAX package holds its own two engines to.
FLOW_TOL = dict(rtol=1e-3, atol=5e-3)


@pytest.fixture(scope="module")
def pair():
    return methanation_pair(NC, NX, **LAGGED)


@pytest.fixture(scope="module")
def jax_runs(pair):
    """The JAX model's (ll, flows, final state) at THETA and at CRAZY, from
    one compiled program (both are (2, 5))."""
    return dict(zip(("theta", "crazy"),
                    jax_loglik_and_final_state(pair[0], (THETA, CRAZY))))


def test_condition_table_bit_identical():
    for n, nx in ((30, 51), (2, 11), (7, 15)):
        want = JM.make_condition_table(n, nx=nx)
        got = TM.make_condition_table(n, nx=nx, device="cpu")
        for f in dataclasses.fields(want):
            np.testing.assert_array_equal(
                getattr(got, f.name).numpy(),
                np.asarray(getattr(want, f.name)), err_msg=f.name)
    sel = TM.make_condition_table(8, device="cpu").select((0, 2, 5))
    want = JM.make_condition_table(8).select((0, 2, 5))
    assert sel.n_data == 3
    np.testing.assert_array_equal(sel.C_in.numpy(), np.asarray(want.C_in))


@pytest.mark.parametrize("mode", ["uniform", "normal", "taylor"])
def test_prior_exactly_equal(mode):
    est = (0, 1, 2, 3, 4, 6, 8)
    want = JM.methanation_prior(est, mode=mode)
    got = TM.methanation_prior(est, mode=mode, device="cpu")
    for f in ("kind", "low", "high", "loc", "scale"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    with pytest.raises(ValueError):
        TM.methanation_prior(mode="cauchy", device="cpu")


@pytest.mark.parametrize("kw", [
    {}, LAGGED, dict(n_steps=20, jac_stride=4, n_dense=1, dense_tail=4),
    dict(pivot=True), dict(jac_stride=1, dense_tail=0)])
def test_schedule_exactly_equal(kw):
    """_dts (with the piecewise-constant lagged middle), the effective
    dense lead-in, and the port's own copy of geometric_schedule."""
    from smc_tpu.ops.dae import geometric_schedule as j_schedule
    cond = JM.make_condition_table(NC, nx=NX)
    jm = JM.MethanationModel(cond=cond, obs=jnp.zeros((5, NC)),
                             prior=JM.methanation_prior(), nx=NX, **kw)
    tm = TM.MethanationModel(
        cond=TM.make_condition_table(NC, nx=NX, device="cpu"),
        obs=torch.zeros((5, NC)), prior=TM.methanation_prior(device="cpu"),
        nx=NX, **kw)
    got = tm._dts()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(jm._dts()))
    assert tm._n_dense_eff == jm._n_dense_eff
    np.testing.assert_array_equal(geometric_schedule(75.0, 48, 1.28),
                                  j_schedule(75.0, 48, 1.28))


def _perturbed_state():
    """A state off the initial guess (as the reference's Jacobian test
    builds it), as NumPy arrays: Y_m, Y, Y_p, Yd (7, NX, 2), flags, condv,
    kin."""
    cond = TM.condition_table_numpy(NC, nx=NX)
    condv = np.stack([cond[k] for k in ("T_jacket", "u_in", "void", "dz",
                                        "P0")])                 # (5, 2)
    flags = np.zeros((3, NX, 1), np.float32)
    flags[0, 0], flags[1, 1], flags[2, -1] = 1.0, 1.0, 1.0
    kin = np.tile(np.asarray(TM.KIN_TRUE, np.float32)[:, None], (1, NC))
    y0 = TM.initial_guess(TM.Conditions.from_numpy(cond, "cpu"), NX).numpy()
    Y = (np.moveaxis(y0, 0, -1).transpose(1, 0, 2) * 1.03 + 0.01
         ).astype(np.float32)
    Yd = (Y * 0.001).astype(np.float32)
    Y_m = np.concatenate([Y[:, :1], Y[:, :-1]], axis=1)
    Y_p = np.concatenate([Y[:, 1:], Y[:, -1:]], axis=1)
    return (Y_m, Y, Y_p, Yd), flags, condv, kin


def test_initial_guess_and_flags_equal():
    cond = TM.condition_table_numpy(NC, nx=NX)
    got = TM.initial_guess(TM.Conditions.from_numpy(cond, "cpu"), NX)
    want = JM.initial_guess(JM.make_condition_table(NC, nx=NX), NX)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(TM._grid_flags(NX).numpy(),
                                  np.asarray(JM._grid_flags(NX)))


def test_rows_match_jax():
    """Residual rows at 1e-6 of their largest entry: the same fp32
    elementwise expressions, evaluated by two libraries."""
    ys, flags, condv, kin = _perturbed_state()
    want = np.asarray(JM._rows_bl(*map(jnp.asarray, ys), jnp.asarray(flags),
                                  jnp.asarray(condv), jnp.asarray(kin)))
    got = TM._rows_bl(*map(torch.from_numpy, ys), torch.from_numpy(flags),
                      torch.from_numpy(condv), torch.from_numpy(kin)).numpy()
    assert got.shape == want.shape == (7, NX, NC)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-6
    r_j = JM.rate_rCH4(jnp.asarray(ys[1][5]), *map(jnp.asarray, ys[1][:4]),
                       jnp.asarray(kin))
    r_t = TM.rate_rCH4(torch.from_numpy(ys[1][5]),
                       *map(torch.from_numpy, ys[1][:4]),
                       torch.from_numpy(kin))
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=1e-5)


@pytest.mark.parametrize("pad_cols", [0, 1])
def test_every_jacobian_slot_matches_jax(pad_cols):
    """Each of the four blocks at 1e-6 of the block's largest entry, with
    and without the pad column; the port's blocks are grid-major in
    memory."""
    ys, flags, condv, kin = _perturbed_state()
    want = JM._analytic_full_jac(
        jnp.asarray(flags), jnp.asarray(condv), jnp.asarray(kin),
        pad_cols=pad_cols)(*map(jnp.asarray, ys))
    got = TM._analytic_full_jac(
        torch.from_numpy(flags), torch.from_numpy(condv),
        torch.from_numpy(kin), pad_cols=pad_cols)(*map(torch.from_numpy, ys))
    assert sorted(got) == [0, 1, 2, 3]
    for slot in range(4):
        ref = np.asarray(want[slot])
        assert got[slot].shape == ref.shape == (7, 7 + pad_cols, NX, NC)
        err = np.abs(got[slot].numpy() - ref).max()
        assert err / np.abs(ref).max() < 1e-6, (slot, err)
        assert got[slot].movedim(2, 0).is_contiguous()


def test_lagged_march_flows_and_loglik_match_jax(pair, jax_runs):
    """The default kind of schedule (lagged Jacobian, predictor, cj
    compensation, dense tail) end to end."""
    _, tm = pair
    jll, jfl, yj = jax_runs["theta"]
    tll, tfl = tm.log_likelihood(torch.from_numpy(THETA))
    assert tfl.shape == (2, 5, NC) and tll.shape == (2,)
    np.testing.assert_allclose(tfl.numpy(), np.asarray(jfl), **FLOW_TOL)
    # ll sums 10 squared residuals of O(10 sccm) over 2 sigma^2: 1e-3
    # relative on the flows moves it by at most a few 1e-2.
    np.testing.assert_allclose(tll.numpy(), np.asarray(jll), rtol=1e-3,
                               atol=0.05)
    assert int(failed_solve_count(tfl)) == 0
    # The whole final state, not only the outlet row the flows read: 1e-4
    # of each field's largest value (fp32 reassociation and FMA contraction
    # carried through 12 implicit steps; measured 2e-6).
    yt = torch_march_final_state(tm, THETA)
    assert yt.shape == yj.shape == (7, NX, 2 * NC)
    scale = np.abs(yj).max(axis=(1, 2), keepdims=True)
    assert (np.abs(yt - yj) / scale).max() < 1e-4
    # solver="thomas" (plain loops) and "thomas_pl" (the wrappers, plain on
    # the CPU) are the same arithmetic here; the padded-factor route too.
    plain = dataclasses.replace(tm, solver="thomas")
    assert torch.equal(plain.log_likelihood(torch.from_numpy(THETA))[1], tfl)
    kin = torch.tensor([TM.KIN_TRUE])
    assert torch.equal(tm._flows_batch_bl(kin, pad_cols=1),
                       tm._flows_batch_bl(kin))


def test_crazy_kinetics_same_sentinel_lanes_no_nan(pair, jax_runs):
    _, tm = pair
    jll, jfl, _ = jax_runs["crazy"]
    tll, tfl = tm.log_likelihood(torch.from_numpy(CRAZY))
    assert not torch.isnan(tll).any() and not torch.isnan(tfl).any()
    np.testing.assert_array_equal(tfl.numpy() == -10000.0,
                                  np.asarray(jfl) == -10000.0)
    assert int(failed_solve_count(tfl)) == int(
        (np.asarray(jfl) == -10000.0).all(axis=1).sum())
    ok = np.asarray(jfl) != -10000.0
    np.testing.assert_allclose(tfl.numpy()[ok], np.asarray(jfl)[ok],
                               **FLOW_TOL)
    np.testing.assert_array_equal(np.isinf(tll.numpy()),
                                  np.isinf(np.asarray(jll)))


def test_trailing_chunk_is_padded_and_cut(pair):
    """N = 5 with chunks of 4: the padded trailing chunk gives the flows a
    single chunk of 5 gives (lanes never mix)."""
    _, tm = pair
    rng = np.random.default_rng(1)
    theta = torch.from_numpy(
        (THETA[0] * (1 + 0.05 * rng.normal(size=(5, 5)))).astype(np.float32))
    ll4, fl4 = tm.log_likelihood(theta)
    ll8, fl8 = dataclasses.replace(tm, particle_chunk=8).log_likelihood(theta)
    assert fl4.shape == (5, 5, NC)
    torch.testing.assert_close(fl4, fl8, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(ll4, ll8, rtol=1e-5, atol=1e-4)


def test_failed_or_degenerate_particles_never_give_nan(pair):
    """Sentinel flows give a finite, very low ll; sigma <= 0 gives a finite
    low ll or -inf, never NaN; failed_solve_count sees the sentinel."""
    _, tm = pair
    flows = torch.full((3, 5, NC), 50.0)
    flows[1] = -10000.0
    flows[2, :, 0] = -10000.0
    assert int(failed_solve_count(flows)) == 3
    ll = tm._ll_from_flows(flows, torch.tensor([5.0, 5.0, 5.0]))
    assert torch.isfinite(ll).all() and ll[1] < ll[2] < ll[0]
    assert ll[1] < -1e6
    for sigma in (0.0, -1.0, float("nan")):
        out = tm._ll_from_flows(flows, torch.full((3,), sigma))
        assert not torch.isnan(out).any()
        assert (out < -1e6).all()
    theta = torch.from_numpy(THETA).clone()
    theta[:, 4] = torch.tensor([0.0, -2.0])
    ll, _ = tm.log_likelihood(theta)
    assert not torch.isnan(ll).any()


def test_what_is_not_ported_raises():
    """Only the lane mesh still refuses (ROADMAP Queue 1 item 12); the
    steady march, the tangent-built Jacobians and the cr/babe solvers
    construct (tests/test_torch_steady.py, test_torch_solvers.py); an
    unknown solver, engine, march or Jacobian mode is an error, and so is
    babe at an even nx. The blocked engine and the CSV readers are ported
    (tests/test_torch_blocked.py, tests/test_torch_io.py)."""
    cond = TM.make_condition_table(NC, nx=NX, device="cpu")
    base = dict(cond=cond, obs=torch.zeros((5, NC)),
                prior=TM.methanation_prior(device="cpu"), nx=NX)
    with pytest.raises(NotImplementedError):
        TM.MethanationModel(**base, lane_mesh=object())
    for kw in (dict(march="steady"), dict(jac_mode="cd"),
               dict(jac_mode="ad"), dict(solver="cr"), dict(solver="babe"),
               dict(march="steady", jac_mode="ad", solver="babe")):
        m = TM.MethanationModel(**base, **kw)
        assert all(getattr(m, k) == v for k, v in kw.items())
    for kw in (dict(solver="qr"), dict(engine="dense"),
               dict(march="implicit"), dict(jac_mode="fd")):
        with pytest.raises(ValueError):
            TM.MethanationModel(**base, **kw)
    even = dict(base, cond=TM.make_condition_table(NC, nx=10, device="cpu"),
                nx=10)
    with pytest.raises(ValueError, match="odd NX"):
        TM.MethanationModel(**even, solver="babe")
    assert TM.MethanationModel(**even, solver="cr").nx == 10
    assert TM.MethanationModel(**base, engine="blocked").engine == "blocked"


def test_likelihood_call_path_copies_nothing_to_the_device():
    """What lets the likelihood run inside a captured CUDA graph: its
    constants (grid flags, base-parameter row, subset index) are made once
    per device and reused, and the march refuses a step schedule that lives
    on a device (reading it would wait for the device on every call)."""
    from smc_tpu_torch.ops.dae_fast import bdf_march_bl
    dev = torch.device("cpu")
    assert TM._grid_flags(11, dev) is TM._grid_flags(11, dev)
    base = TM._row(TM.KIN_TRUE, dev, torch.float32)
    assert base is TM._row(TM.KIN_TRUE, dev, torch.float32)
    assert TM._row((0, 8), dev) is TM._row((0, 8), dev)
    assert TM._row((0, 8), dev).dtype == torch.int64
    with pytest.raises(ValueError, match="host array"):
        bdf_march_bl(None, torch.zeros((7, 3, 2)),
                     torch.ones(4, device="meta"),
                     analytic_jac=lambda *a: {})

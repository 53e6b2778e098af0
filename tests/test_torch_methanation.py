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
from smc_tpu_torch.ops.dae_fast import bdf_march_bl
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
    """Nothing refuses any more: the steady march, the tangent-built
    Jacobians and the cr/babe solvers construct
    (tests/test_torch_steady.py, test_torch_solvers.py), and so does a
    lane mesh whose "data" axis divides the conditions
    (tests/test_torch_sharding_methanation.py); one that does not is an
    error, as is an unknown solver, engine, march or Jacobian mode, and
    babe at an even nx. The blocked engine and the CSV readers are ported
    (tests/test_torch_blocked.py, tests/test_torch_io.py)."""
    cond = TM.make_condition_table(NC, nx=NX, device="cpu")
    base = dict(cond=cond, obs=torch.zeros((5, NC)),
                prior=TM.methanation_prior(device="cpu"), nx=NX)

    class ThreeDataRanks:
        def size(self, axis):
            return 3
    with pytest.raises(ValueError, match="do not divide"):
        TM.MethanationModel(**base, lane_mesh=ThreeDataRanks())
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


def _march_state(b=6, seed=3):
    """A march state (7, NX, b) off the initial guess over every grid row
    (inlet, first interior, interior, outlet), its BDF constant and step,
    and the lane tensors (flags, condv, kin); lane 2 sits on the rate
    law's guard, P_H2 = 0.001 exactly, at grid point 4."""
    cond = TM.Conditions.from_numpy(TM.condition_table_numpy(NC, nx=NX),
                                    "cpu")
    tm = TM.MethanationModel(cond=cond, obs=torch.zeros((5, NC)),
                             prior=TM.methanation_prior(device="cpu"), nx=NX)
    rng = np.random.default_rng(seed)
    kin_b = torch.from_numpy((np.asarray(TM.KIN_TRUE, np.float32)
                              * (1 + 0.1 * rng.normal(size=(b // NC, 8)))
                              ).astype(np.float32))
    kin, condv, flags, y0 = tm._lane_tensors(kin_b)
    y = y0 * torch.from_numpy(
        (1 + 0.05 * rng.normal(size=y0.shape)).astype(np.float32))
    y[5] += torch.from_numpy(
        (40 * rng.random(size=y0[5].shape)).astype(np.float32))
    # P_H2 = C_H2 * (R T 1e-6) = 0.001 in float32: C_H2 nudged by ulps.
    rt6 = y[5, 4, 2] * TM.R_GAS * 1e-6
    c = torch.tensor(0.001, dtype=torch.float32) / rt6
    for _ in range(64):
        p = c * rt6
        if p == torch.tensor(0.001, dtype=torch.float32):
            break
        c = torch.nextafter(c, c * (2.0 if p < 0.001 else 0.5))
    y[0, 4, 2] = c
    assert y[0, 4, 2] * (y[5, 4, 2] * TM.R_GAS * 1e-6) == torch.tensor(
        0.001, dtype=torch.float32)
    const = -1.3 * y0 + 0.2 * y
    return y.contiguous(), const, 1.4, 0.37, flags, condv, kin


def test_march_plain_versions_equal_the_newton_composition():
    """The march kernels' plain versions (ops/march_cuda.py) are the
    march's PyTorch composition (``_newton_kit``'s residual and
    build_blocks over ``_rows_bl`` and ``_analytic_full_jac``), bit for
    bit, at every grid row and at the rate law's P_H2 = 0.001 tie, with a
    scalar step and a per-lane one; the tie lane's H2 partial is the
    branch above the guard (d r / d C_H2 = rf / (2 P_H2) * R T 1e-6)."""
    from smc_tpu_torch.ops import march_cuda as mc
    from smc_tpu_torch.ops.dae_fast import _newton_kit
    y, const, alpha, h, flags, condv, kin = _march_state()
    b = y.shape[-1]

    def rows(y_m, y_, y_p, yd):
        return TM._rows_bl(y_m, y_, y_p, yd, flags, condv, kin)
    kit = _newton_kit(rows, y, False, TM._analytic_full_jac(
        flags, condv, kin), "thomas")
    for hh in (h, torch.linspace(0.2, 0.5, b)):
        want = kit[1](y, alpha, const, hh)
        got = mc.march_rows_plain(y, const, alpha, hh, flags, condv, kin)
        assert got.shape == (NX, 7, b) and torch.equal(got, want)
        want_b = kit[2](y, alpha, const, hh)
        got_b = mc.march_blocks_plain(y, const, alpha, hh, flags, condv, kin)
        for g, w in zip(got_b, want_b):
            assert g.is_contiguous() and torch.equal(g, w)
        A_, B_, C_, _ = got_b
        assert not A_[0].any() and not C_[-1].any()
    # The tie: B[4][1, 0] (CO2 row, H2 column) is -(1 - void) dr/dC_H2 with
    # guard = 1, so it is not zero.
    assert float(B_[4, 1, 0, 2]) != 0.0


def test_march_kernels_dispatch_rule(monkeypatch):
    """Which Newton calls take the march kernels' pair: float32 inputs
    that autograd does not track, on the closed-form Jacobian's 7-column
    blocks. A tracked theta, jac_mode "cd" and "ad", pad_cols=1 and
    float64 inputs keep the PyTorch composition; each path's flows are
    the same bits either way on the CPU (the plain versions are that
    composition)."""
    from smc_tpu_torch.ops import march_cuda as mc
    _, tm = methanation_pair(NC, NX, **LAGGED)
    calls = {"rows": 0, "blocks": 0}
    plain = (mc.march_rows_plain, mc.march_blocks_plain)

    def counted(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped
    monkeypatch.setattr(mc, "march_rows_plain", counted("rows", plain[0]))
    monkeypatch.setattr(mc, "march_blocks_plain", counted("blocks", plain[1]))
    theta = torch.from_numpy(THETA)
    kin = torch.tensor([TM.KIN_TRUE])

    fl = tm.log_likelihood(theta)[1]
    # 12 steps: 3 lagged blocks of 3 and a tail of 3, 2 Newton iterations
    # and 1 reuse iteration: 6 builds and 12 more residuals, one for each
    # of the 18 solves.
    assert calls == {"rows": 12, "blocks": 6}
    rows, jac, y0, fused = tm._lane_problem(kin)
    assert isinstance(fused, mc.MarchKernels)
    kw = dict(newton_iters=tm.newton_iters, pivot=tm.pivot, analytic_jac=jac,
              jac_stride=tm.jac_stride, n_dense=tm._n_dense_eff,
              reuse_iters=tm.reuse_iters, dense_tail=tm.dense_tail,
              solver=tm.solver)
    assert torch.equal(bdf_march_bl(rows, y0, tm._dts(), fused=fused, **kw),
                       bdf_march_bl(rows, y0, tm._dts(), **kw))

    calls.update(rows=0, blocks=0)
    tracked = theta.clone().requires_grad_(True)
    ll, fl_t = tm.log_likelihood(tracked)
    torch.autograd.grad(ll.sum(), tracked)
    assert calls == {"rows": 0, "blocks": 0}
    assert torch.equal(fl_t.detach(), fl)
    for mode in ("cd", "ad"):
        m = dataclasses.replace(tm, jac_mode=mode)
        assert m._lane_problem(kin)[3] is None
        m.log_likelihood(theta)
    assert tm._lane_problem(kin, pad_cols=1)[3] is None
    padded = tm._flows_batch_bl(kin, pad_cols=1)
    assert calls == {"rows": 0, "blocks": 0}
    assert torch.equal(padded, tm._flows_batch_bl(kin))
    y, const, alpha, h, flags, condv, kin_bl = _march_state()
    f64 = mc.MarchKernels(flags, condv.double(), kin_bl.double())
    assert not f64.takes(y.double(), const.double(), h)
    assert not f64.takes(y, const, h)
    f32 = mc.MarchKernels(flags, condv, kin_bl)
    assert f32.takes(y, const, h)
    assert f32.takes(y, const, torch.full((y.shape[-1],), h))
    assert not f32.takes(y, const, torch.full((y.shape[-1],), h,
                                              dtype=torch.float64))
    assert not f32.takes(y.double(), const.double(), h)
    assert not f32.takes(y.clone().requires_grad_(True), const, h)
    with torch.no_grad():
        assert f32.takes(y.clone().requires_grad_(True), const, h)


def test_march_kernel_wrappers_on_the_cpu():
    """On the CPU each wrapper is its plain version; an input that
    autograd tracks is refused (the kernels have no backward), and a
    device that is neither the CPU nor CUDA is an error."""
    from smc_tpu_torch.ops import march_cuda as mc
    args = _march_state()
    y = args[0]
    assert torch.equal(mc.march_rows(*args), mc.march_rows_plain(*args))
    for g, w in zip(mc.march_blocks(*args), mc.march_blocks_plain(*args)):
        assert torch.equal(g, w)
    for fn in (mc.march_rows, mc.march_blocks):
        with pytest.raises(ValueError, match="no backward"):
            fn(y.clone().requires_grad_(True), *args[1:])
        with pytest.raises(ValueError, match="unsupported device"):
            fn(y.to("meta"), *args[1:])


def test_march_kernel_constants():
    """The model's constants compiled into csrc/march.cu are those of
    models/methanation.py in float32, each ``constexpr float`` against its
    Python value, and the stoichiometry and molar masses against SC and
    MOLW, so the two copies cannot drift apart."""
    import re
    from pathlib import Path

    src = (Path(TM.__file__).resolve().parent.parent / "csrc"
           / "march.cu").read_text()
    want = {"kR": TM.R_GAS, "kRcpR": 1.0 / TM.R_GAS, "kDisp": TM.DZ_DISP, "kRhos": TM.RHOS,
            "kCps": TM.CPS, "kMinusHR": -TM.HR, "kCpg": TM.CPG,
            "kKeff": TM.KEFF, "kKeff2": 2.0 * TM.KEFF,
            "kWall": 2.0 * TM.U_HT / TM.DINT, "kRate": 5075e3,
            "kGuard": 0.001, "kMega": 1e-6, "kMilli": 1e-3, "kKappa": 0.1}
    got = dict(re.findall(r"constexpr float (k\w+) = ([-0-9.e+]+)f;", src))
    assert set(got) == set(want)
    for name, value in want.items():
        assert np.float32(float(got[name])) == np.float32(value), name
    for fn, values in (("sc", TM.SC), ("molw", TM.MOLW)):
        body = re.search(rf"constexpr float {fn}\(int k\) \{{(.*?)\}}", src,
                         re.S).group(1)
        lits = [float(v) for v in re.findall(r"\? (-?[0-9.]+)f", body)]
        lits.append(float(re.findall(r": (-?[0-9.]+)f;", body)[-1]))
        assert np.array_equal(np.float32(lits), np.float32(values)), fn

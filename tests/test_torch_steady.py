"""The port's steady march (``march="steady"``: per-lane SER
pseudo-transient continuation, ``ops/dae_fast.py::steady_march_bl``) and
its tangent-built Jacobians (``jac_mode`` "cd" and "ad") against the JAX
package on the CPU.

The JAX side compiles one steady likelihood here (nx = 15, 3 conditions,
4 particles: the configuration of ``tests/test_methanation_grad.py``) and
serves both parameter sets from it; the Jacobian blocks are compared
eagerly (no march compile). The port's own checks (steady against a long
dense transient march, the cd/ad marches against full) compile nothing.
One more JAX program is the flagship width (nx = 51, 30 conditions, the
default ptc settings), traced with the NX-scan unroll at 1 (about 10 s to
compile), to hold the certificate's failed lanes of both packages side by
side.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smc_tpu.models import methanation as JM
from smc_tpu.ops import dae_fast as jdf
from smc_tpu_torch.models import methanation as TM
from smc_tpu_torch.ops import dae_fast as tdf
from tests.torch_parity import methanation_pair

NX, NC = 15, 3
STEADY = dict(n_steps=40, growth=1.3, particle_chunk=4, newton_iters=3,
              march="steady")
# The thetas of tests/test_methanation.py::test_steady_march_matches_long_
# transient, and a set with extreme kinetics (failed lanes) and wider draws.
THETA = np.array([[13.04, 52.2e3, 1.147e5, 96.7e3, 5.0],
                  [15.0, 52.5e3, 1.5e5, 9.7e4, 4.0],
                  [11.0, 51.9e3, 0.9e5, 9.6e4, 6.0],
                  [13.0, 52.0e3, 2.0e5, 9.8e4, 5.0]], np.float32)
WIDE = np.array([[3e2, 1e3, 3e6, 1e3, 14.9],
                 [339.0, 0.0, 3.5e6, 0.0, 0.51],
                 [20.0, 50e3, 3e5, 9e4, 5.0],
                 [8.0, 54e3, 6e4, 1.0e5, 5.0]], np.float32)
SENTINEL = -10000.0


@pytest.fixture(scope="module")
def pair():
    return methanation_pair(NC, NX, **STEADY)


@pytest.fixture(scope="module")
def jax_runs(pair):
    """The JAX model's (ll, flows) at THETA and WIDE from one program."""
    fn = jax.jit(pair[0].log_likelihood)
    return {k: tuple(np.asarray(a) for a in fn(jnp.asarray(th)))
            for k, th in (("theta", THETA), ("wide", WIDE))}


@pytest.mark.parametrize("which", ["theta", "wide"])
def test_steady_flows_match_jax(pair, jax_runs, which):
    """Flows within 0.01 sccm where both packages' certificates pass
    (measured 6e-5 at THETA), log-likelihoods within 1e-3 relative there;
    the lanes whose sentinel differs are counted and may be a few (SER
    with per-lane h and a convergence certificate can move a lane across
    conv_tol on the last bits), never NaN."""
    _, tm = pair
    th = THETA if which == "theta" else WIDE
    jll, jfl = jax_runs[which]
    tll, tfl = tm.log_likelihood(torch.from_numpy(th))
    tfl, tll = tfl.numpy(), tll.numpy()
    assert not np.isnan(tfl).any() and not np.isnan(tll).any()
    t_fail = (tfl == SENTINEL).all(axis=1)          # (N, n_cond) lanes
    j_fail = (jfl == SENTINEL).all(axis=1)
    differ = int((t_fail != j_fail).sum())
    print(f"lanes whose sentinel differs: {differ} of {t_fail.size}")
    assert differ <= 1
    both = ~t_fail & ~j_fail
    if which == "theta":
        assert both.all()
    d = np.abs(tfl - jfl).max(axis=1)[both]
    assert d.max() < 0.01, d.max()
    same = (t_fail == j_fail).all(axis=1)
    np.testing.assert_allclose(tll[same], jll[same], rtol=1e-3, atol=1e-3)


def test_steady_matches_long_dense_transient(pair):
    """The steady march solves the t -> inf state a long, dense transient
    march approaches (t_final 150, every step factored): flows within
    2 sccm wherever both pass, on at least 90% of the lanes (the bar of
    tests/test_methanation.py::test_steady_march_matches_long_transient;
    port only)."""
    _, tm = pair
    m_long = dataclasses.replace(tm, march="transient", jac_stride=1,
                                 dense_tail=0, t_final=150.0)
    _, fl_t = m_long.log_likelihood(torch.from_numpy(THETA))
    _, fl_s = tm.log_likelihood(torch.from_numpy(THETA))
    fl_t, fl_s = fl_t.numpy(), fl_s.numpy()
    ok = (fl_t > -9999) & (fl_s > -9999)
    assert ok.mean() > 0.9
    assert np.abs(np.where(ok, fl_t - fl_s, 0.0)).max() < 2.0


def _state(pair, theta):
    """A perturbed state of THETA's lanes (as the reference's Jacobian test
    builds it: the initial guess * 1.03 + 0.01), with the rows of both
    packages at it."""
    jm, tm = pair
    full = torch.tensor(tm.base_params).repeat(theta.shape[0], 1)
    full[:, list(tm.est_idx)] = torch.from_numpy(theta)
    kin_bl, condv, flags, y0 = tm._lane_tensors(full[:, :8])
    y = (y0 * 1.03 + 0.01).contiguous()
    jargs = tuple(jnp.asarray(a.numpy()) for a in (flags, condv, kin_bl))

    def jrows(y_m, yy, y_p, yd):
        return JM._rows_bl(y_m, yy, y_p, yd, *jargs)

    def trows(y_m, yy, y_p, yd):
        return TM._rows_bl(y_m, yy, y_p, yd, flags, condv, kin_bl)
    return y, (flags, condv, kin_bl), jargs, jrows, trows


@pytest.mark.parametrize("jac_mode", ["cd", "ad"])
def test_tangent_blocks_match_jax(pair, jac_mode):
    """build_blocks with the tangent-built slots against the JAX package's
    (jax.linearize passes) at a perturbed state, every block at 1e-6 of
    its largest entry; and against the closed-form blocks at 5e-6 (the
    bars of tests/test_methanation.py::test_analytic_jacobian_blocks_
    match_tangents)."""
    y, targs, jargs, jrows, trows = _state(pair, THETA[:2])
    yj = jnp.asarray(y.numpy())
    jjac = {"cd": JM._analytic_CD_jac(*jargs[:2]), "ad": None}[jac_mode]
    tjac = TM._jac_of(jac_mode, *targs)
    h = 0.37
    want = jdf._newton_kit(jrows, yj, False, jjac, "thomas")[2](
        yj, 1.0, -0.9 * yj, h)
    got = tdf._newton_kit(trows, y, False, tjac, "thomas")[2](
        y, 1.0, -0.9 * y, h)
    full = tdf._newton_kit(trows, y, False, TM._jac_of("full", *targs),
                           "thomas")[2](y, 1.0, -0.9 * y, h)
    for name, g, w, f in zip("ABC", got[:3], want[:3], full[:3]):
        w = np.asarray(w)
        assert g.shape == w.shape
        scale = np.abs(w).max()
        assert np.abs(g.numpy() - w).max() / scale < 1e-6, name
        assert np.abs(g.numpy() - f.numpy()).max() / scale < 5e-6, name
    r = np.asarray(want[3])
    assert np.abs(got[3].numpy() - r).max() / np.abs(r).max() < 1e-6


def test_tangent_blocks_take_the_analytic_width(pair):
    """The tangent-built slots take the analytic slots' column width: an
    8-column "cd" build pads them with a zero column."""
    y, targs, _, _, trows = _state(pair, THETA[:1])
    got = tdf._newton_kit(trows, y, False, TM._jac_of("cd", *targs, 1),
                          "thomas")[2](y, 1.0, -y, 0.5)
    ref = tdf._newton_kit(trows, y, False, TM._jac_of("cd", *targs),
                          "thomas")[2](y, 1.0, -y, 0.5)
    for g, r in zip(got[:3], ref[:3]):
        assert g.shape[2] == 8 and (g[:, :, 7] == 0).all()
        assert torch.equal(g[:, :, :7], r)


@pytest.mark.parametrize("march", ["steady", "transient"])
@pytest.mark.parametrize("jac_mode", ["cd", "ad"])
def test_jac_mode_marches_match_full(pair, march, jac_mode):
    """The cd and ad marches against the full-analytic march (port only):
    flows within 1e-3 sccm on every lane, the same failed lanes. The
    blocks agree to fp32 rounding, and the Newton iterations carry that
    to the flows."""
    _, tm = pair
    full = dataclasses.replace(tm, march=march)
    other = dataclasses.replace(full, jac_mode=jac_mode)
    th = torch.from_numpy(THETA[:2])
    f_full, f_other = full.log_likelihood(th)[1], other.log_likelihood(th)[1]
    assert (f_full != SENTINEL).all()
    np.testing.assert_allclose(f_other.numpy(), f_full.numpy(), atol=1e-3)


def test_solver_fields_carry_over_between_the_packages(tmp_path):
    """convert.methanation_model_from_numpy (through methanation_pair) and
    MethanationModel.from_csv carry march, jac_mode, solver and the ptc_*
    settings unchanged, so both packages build the same model."""
    kw = dict(march="steady", jac_mode="cd", solver="babe", ptc_steps=9,
              ptc_dt0=0.05, ptc_growth=5.0, ptc_floor=1.5, ptc_lag=3,
              ptc_reuse_iters=2, newton_iters=3)
    jm, tm = methanation_pair(2, 11, **kw)
    names = ("march", "jac_mode", "solver", "ptc_steps", "ptc_dt0",
             "ptc_growth", "ptc_floor", "ptc_lag", "ptc_reuse_iters",
             "newton_iters", "nx", "est_idx")
    for name in names:
        assert getattr(tm, name) == getattr(jm, name), name
    cond_csv, data_csv = tmp_path / "cond.csv", tmp_path / "data.csv"
    tm.cond.to_csv(str(cond_csv), nx=11)
    np.savetxt(data_csv, tm.obs.numpy(), delimiter=",")
    back = TM.MethanationModel.from_csv(str(cond_csv), str(data_csv), nx=11,
                                        device="cpu", **kw)
    for name in names:
        assert getattr(back, name) == getattr(tm, name), name
    th = torch.from_numpy(THETA[:1])
    torch.testing.assert_close(back.log_likelihood(th)[1],
                               tm.log_likelihood(th)[1], rtol=1e-4,
                               atol=1e-3)


def _certified(march, residual_of, norm, nan_where):
    """A steady march that also records each lane's certificate ratio,
    r_end / (conv_tol (r0 + 1)): the march runs unmasked, the ratio is
    taken from the package's own residual, and lanes at or above 1 (or
    non-finite) are masked to NaN as the march itself masks them."""
    seen = {}

    def run(rows, y0, **kw):
        tol = kw.pop("conv_tol", 1e-4)
        y = march(rows, y0, conv_tol=1e30, **kw)
        res = residual_of(rows, y0)
        r0 = norm(res(y0, 1.0, -y0, 1.0))
        r1 = norm(res(y, 1.0, -y, 1.0))
        seen["ratio"] = r1 / (tol * (r0 + 1.0))
        return nan_where(seen["ratio"], y)
    return run, seen


def test_flagship_width_failed_lanes_match_jax():
    """At the flagship width (nx = 51, 30 conditions, 14 pseudo-steps, lag
    2) both packages' steady marches fail the convergence certificate in
    the same way, at 64 draws 0.5% around the truth (the first the truth
    itself), seed 0. Each lane's certificate ratio (final residual over its
    limit) is taken in both: every lane at 2 or more, or non-finite, in
    either package fails in both (the march diverged, at conditions 17,
    22, 26 and 27); a lane whose verdict differs has both ratios within
    [0.5, 2] (condition 3 ends near its limit in both packages, and the
    last bits of fp32 move such a lane either way); flows within 0.01 sccm
    where both pass."""
    cond = TM.condition_table_numpy(30, nx=51)
    n = 64
    kw = dict(march="steady", particle_chunk=n)
    obs = np.zeros((5, 30), np.float32)
    tm = TM.MethanationModel(
        cond=TM.Conditions.from_numpy(cond, "cpu"), obs=torch.from_numpy(obs),
        prior=TM.methanation_prior(device="cpu"), nx=51, **kw)
    jm = JM.MethanationModel(
        cond=JM.Conditions(**{k: jnp.asarray(v) for k, v in cond.items()}),
        obs=jnp.asarray(obs), prior=JM.methanation_prior(), nx=51, **kw)
    truth = np.asarray(list(TM.KIN_TRUE[:4]) + [5.0], np.float32)
    rng = np.random.default_rng(0)
    th = (truth * (1 + 0.005 * rng.standard_normal((n, 5)))).astype(
        np.float32)
    th[0] = truth

    t_run, t_seen = _certified(
        tdf.steady_march_bl,
        lambda rows, y0: tdf._newton_kit(rows, y0, False, None, "thomas")[1],
        lambda r: torch.amax(torch.abs(r), dim=(0, 1)),
        lambda q, y: torch.where((q < 1)[None, None], y, torch.nan))
    with mock.patch.object(TM, "steady_march_bl", t_run):
        _, tfl = tm.log_likelihood(torch.from_numpy(th))
    j_ratio = {}

    def j_norm(r):
        return jnp.max(jnp.abs(r), axis=(0, 1))

    def j_mask(q, y):
        jax.debug.callback(
            lambda v: j_ratio.__setitem__("ratio", np.asarray(v)), q)
        return jnp.where((q < 1)[None, None], y, jnp.nan)

    j_run, _ = _certified(
        jdf.steady_march_bl,
        lambda rows, y0: jdf._newton_kit(rows, y0, False, None, "thomas")[1],
        j_norm, j_mask)
    with mock.patch.object(jdf, "_NX_UNROLL", 1), \
            mock.patch.object(jdf, "steady_march_bl", j_run):
        _, jfl = jax.jit(jm.log_likelihood)(jnp.asarray(th))
    tfl, jfl = tfl.numpy(), np.asarray(jfl)
    rt = t_seen["ratio"].numpy().reshape(n, 30)     # lane = particle x cond
    rj = j_ratio["ratio"].reshape(n, 30)
    t_fail = (tfl == SENTINEL).all(axis=1)
    j_fail = (jfl == SENTINEL).all(axis=1)
    np.testing.assert_array_equal(t_fail, ~(rt < 1))
    np.testing.assert_array_equal(j_fail, ~(rj < 1))
    far = ~(rt < 2) | ~(rj < 2)
    assert (t_fail & j_fail)[far].all()
    differ = t_fail != j_fail
    assert ((rt >= 0.5) & (rj >= 0.5))[differ].all()
    both = ~t_fail & ~j_fail
    assert np.abs(tfl - jfl).max(axis=1)[both].max() < 0.01
    print(f"failed lanes: port {t_fail.sum()}, JAX {j_fail.sum()} of "
          f"{t_fail.size}; verdicts differ in {differ.sum()} (conditions "
          f"{sorted(set(np.nonzero(differ)[1].tolist()))}); per condition "
          f"port {t_fail.sum(0).tolist()} JAX {j_fail.sum(0).tolist()}; "
          f"condition 3 median ratio port {np.median(rt[:, 3]):.3f} JAX "
          f"{np.median(rj[:, 3]):.3f}; max flow diff where both pass "
          f"{np.abs(tfl - jfl).max(axis=1)[both].max():.3g} sccm")

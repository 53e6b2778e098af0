"""The port's generic ODE models and explicit integrators
(``models/generic.py``, ``ops/ode.py``) against the JAX package's.

The same arrays (NumPy, from a seed) go through both packages: a JAX
``ODEModel`` and its port built by ``convert.ode_model_from_numpy`` from
the JAX model's obs, ts, y0 and prior. Tolerances: trajectories rtol
1e-5 (float32 arithmetic in another order), dopri5's error estimate 1e-5
of the state's scale;
log-likelihoods the same -inf rows exactly and the finite rows within
1e-5 of max(|ll|, 1). The posterior recovery is statistical (the port's
random stream is its own).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_parity  # noqa: F401  (one PyTorch thread per worker)
from smc_tpu.models import generic as JG
from smc_tpu.models.michaelis_menten import MichaelisMentenModel as JMM
from smc_tpu.ops.ode import dopri5_grid as j_dopri5
from smc_tpu_torch import SMCConfig, convert, run_smc
from smc_tpu_torch.models import generic as TG
from smc_tpu_torch.ops.ode import dopri5_grid
from smc_tpu_torch.priors import Prior
from smc_tpu_torch.rng import TorchDraws
from tests.torch_parity import assert_ll_close

RTOL = 1e-5


def _prior_arrays(p):
    return {f: np.asarray(getattr(p, f)) for f in
            ("kind", "low", "high", "loc", "scale")}


def port_of(jm, rhs, **kw):
    """The port's model of a JAX ODEModel, over its arrays and settings."""
    settings = dict(method=jm.method, substeps=jm.substeps,
                    est_sigma=jm.est_sigma, sigma_fixed=jm.sigma_fixed,
                    err_tol=jm.err_tol, alg_mask=jm.alg_mask)
    settings.update(kw)
    return convert.ode_model_from_numpy(
        rhs, jm.param_names, np.asarray(jm.obs), np.asarray(jm.ts),
        np.asarray(jm.y0), _prior_arrays(jm.prior), device="cpu",
        **settings)


def assert_ll_match(got, want):
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert not np.isnan(got).any() and not np.isnan(want).any()
    fin = np.isfinite(want)
    err = np.abs(got[fin].astype(np.float64) - want[fin])
    assert (err <= RTOL * np.maximum(np.abs(want[fin]), 1.0)).all(), \
        err.max()


@pytest.fixture(scope="module")
def lv():
    jm = JG.lotka_volterra_model()
    return jm, port_of(jm, TG.lotka_volterra_rhs)


def _lv_thetas(n=24, seed=0):
    rng = np.random.default_rng(seed)
    th = np.column_stack([
        rng.uniform(0.5, 1.5, n), rng.uniform(0.05, 0.15, n),
        rng.uniform(0.04, 0.1, n), rng.uniform(0.9, 2.0, n),
        rng.uniform(0.1, 1.0, n)]).astype(np.float32)
    th[0] = [1.0, 0.1, 0.075, 1.5, -0.1]             # sigma <= 0
    th[1] = [3.0, 0.5, 0.5, 3.0, 0.3]                # stiff prior corner
    return th


def test_builder_carries_the_jax_model(lv):
    jm, tm = lv
    for f in ("obs", "ts", "y0"):
        np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                      np.asarray(getattr(jm, f)))
    assert tm.param_names == jm.param_names and tm.method == "rk4"
    assert tm.err_tol == float("inf") and tm.substeps == 8


@pytest.mark.parametrize("method", ["rk4", "dopri5"])
def test_lv_likelihood_matches_jax(lv, method):
    jm, tm = lv
    jm = dataclasses.replace(jm, method=method)
    tm = dataclasses.replace(tm, method=method)
    th = _lv_thetas()
    want_ll, want_pred = jax.jit(jm.log_likelihood)(jnp.asarray(th))
    got_ll, got_pred = tm.log_likelihood(torch.from_numpy(th))
    assert_ll_match(got_ll.numpy(), np.asarray(want_ll))
    assert got_ll[0] == -np.inf and torch.isfinite(got_ll[2:]).all()
    fin = np.isfinite(np.asarray(want_pred))
    np.testing.assert_allclose(got_pred.numpy()[fin],
                               np.asarray(want_pred)[fin], rtol=RTOL,
                               atol=1e-4)


def test_dopri5_grid_matches_jax():
    """Trajectory and the batch-wide error estimate, same inputs."""
    rng = np.random.default_rng(1)
    n = 40
    p = rng.uniform([0.6, 0.05, 0.04, 1.0], [1.4, 0.15, 0.1, 2.0],
                    size=(n, 4)).astype(np.float32)
    y0 = rng.uniform(3.0, 12.0, size=(2, 3, n)).astype(np.float32)
    ts = np.linspace(0.0, 6.0, 13).astype(np.float32)
    names = ("alpha", "beta", "delta", "gamma")

    def rhs(mod, params):
        return lambda t, y: mod.lotka_volterra_rhs(t, y, params)
    ys_j, err_j = jax.jit(lambda y, s: j_dopri5(
        rhs(JG, dict(zip(names, s.T))), y, jnp.asarray(ts), substeps=3))(
            jnp.asarray(y0), jnp.asarray(p))
    tp = torch.from_numpy(p)
    ys_t, err_t = dopri5_grid(rhs(TG, dict(zip(names, tp.T))),
                              torch.from_numpy(y0), torch.from_numpy(ts),
                              substeps=3)
    assert err_t.dim() == 0
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=RTOL,
                               atol=1e-5)
    # |y5 - y4| is a difference of two nearly equal sums: its rounding is
    # that of the state's scale.
    scale = float(np.abs(np.asarray(ys_j)).max())
    assert abs(float(err_t) - float(err_j)) <= RTOL * scale


def test_dopri5_error_mask_is_batch_wide(lv):
    """The kept quirk: dopri5's error estimate is one scalar over the
    whole batch, so under a finite err_tol one diverging particle masks
    every particle, in both packages alike."""
    jm, tm = lv
    good = _lv_thetas()[2:8]
    bad = np.concatenate([good, [[3.0, 0.01, 0.5, 0.1, 0.3]]]).astype(
        np.float32)
    jm5 = dataclasses.replace(jm, method="dopri5")
    err_good = float(jax.jit(jm5.simulate)(jnp.asarray(good))[1])
    err_bad = float(jax.jit(jm5.simulate)(jnp.asarray(bad))[1])
    assert err_bad > 10 * err_good
    tol = float(np.sqrt(err_good * err_bad))
    jm5 = dataclasses.replace(jm5, err_tol=tol)
    tm5 = dataclasses.replace(tm, method="dopri5", err_tol=tol)
    for th, masked in ((good, False), (bad, True)):
        want = np.asarray(jax.jit(jm5.log_likelihood)(jnp.asarray(th))[0])
        got = tm5.log_likelihood(torch.from_numpy(th))[0].numpy()
        assert_ll_match(got, want)
        assert np.isinf(got).all() == masked and np.isfinite(got).all() \
            != masked


def test_mm_dopri5_matches_jax():
    """MM ``method="dopri5"`` (half the substeps, error unused) against
    the JAX model on the same arrays."""
    jm = JMM.default(method="dopri5", substeps=4)
    tm = convert.mm_model_from_numpy(
        np.asarray(jm.obs), np.asarray(jm.s0), np.asarray(jm.ts),
        Prior.uniform([0.0] * 3, [10.0] * 3, device="cpu"),
        method="dopri5", substeps=4, device="cpu")
    rng = np.random.default_rng(2)
    th = rng.uniform([0.5, 0.2, 0.01], [2.0, 1.0, 0.1],
                     size=(64, 3)).astype(np.float32)
    th[::13, 2] *= -1.0
    want = np.asarray(jax.jit(jm.log_likelihood)(jnp.asarray(th))[0])
    got = tm.log_likelihood(torch.from_numpy(th))[0].numpy()
    assert_ll_close(got, want, th, 6, 40, RTOL)
    rk4 = dataclasses.replace(tm, method="rk4").log_likelihood(
        torch.from_numpy(th))[0].numpy()
    assert_ll_close(got, rk4, th, 6, 40, 1e-3)


def test_lv_simulate_matches_scipy(lv):
    from scipy.integrate import solve_ivp
    _, tm = lv
    theta = torch.tensor([TG.LV_TRUE + (0.1,)])
    y_path, _ = tm.simulate(theta)                   # (T, n_series, 1)
    ts = tm.ts.double().numpy()
    a, b, d, g = TG.LV_TRUE
    for s in range(tm.y0.shape[1]):
        sol = solve_ivp(lambda t, y: [a * y[0] - b * y[0] * y[1],
                                      d * y[0] * y[1] - g * y[1]],
                        (ts[0], ts[-1]), tm.y0[:, s].double().numpy(),
                        t_eval=ts, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(y_path[:, s, 0].numpy(), sol.y[0],
                                   rtol=2e-3, atol=2e-3)


def test_generate_data_seed_and_draws():
    """A seed draws the noise on the CPU (the same data on any device); a
    Draws object is used as given."""
    a = TG.lotka_volterra_model(key=3, device="cpu")
    b = TG.lotka_volterra_model(key=3, device="cpu")
    c = TG.lotka_volterra_model(key=TorchDraws(3, "cpu"), device="cpu")
    assert torch.equal(a.obs, b.obs) and torch.equal(a.obs, c.obs)
    clean = TG.lotka_volterra_model(noise_std=0.0, device="cpu")
    noise = (a.obs - clean.obs).numpy()
    assert abs(noise.std() - TG.LV_TRUE_NOISE) < 0.05


def test_custom_observable_and_fixed_sigma(lv):
    _, base = lv
    m = dataclasses.replace(
        base, observe=lambda y: y[1],
        param_names=("alpha", "beta", "delta", "gamma"),
        prior=Prior.uniform([0.1, 0.01, 0.01, 0.1], [3.0, 0.5, 0.5, 3.0],
                            device="cpu"),
        est_sigma=False, sigma_fixed=TG.LV_TRUE_NOISE)
    m = m.generate_data(TG.LV_TRUE, 7, TG.LV_TRUE_NOISE)
    ll, pred = m.log_likelihood(torch.tensor([[1.0, 0.1, 0.075, 1.5]]))
    assert torch.isfinite(ll).all()
    assert tuple(pred.shape) == (1, 3, 50)
    with pytest.raises(ValueError, match="bdf2"):
        dataclasses.replace(m, alg_mask=(False, True))


def test_lv_posterior_recovers_truth():
    model = TG.lotka_volterra_model(device="cpu")
    state = run_smc(model, SMCConfig(n_particles=1024), 0, verbose=False)
    assert float(state.gamma) == 1.0
    p = state.particles.double().numpy()
    mean, std = p.mean(0), p.std(0)
    truth = np.asarray(TG.LV_TRUE + (TG.LV_TRUE_NOISE,))
    assert np.all(np.abs(mean - truth) < 4 * std + 0.05 * truth)
    prior_width = np.asarray([2.9, 0.49, 0.49, 2.9, 1.99]) / np.sqrt(12)
    assert np.all(std < 0.35 * prior_width)
    assert np.isfinite(float(state.log_evidence))

"""The port's Michaelis-Menten likelihoods against the JAX package on the
CPU, on shared arrays: the plain version of the CUDA likelihood kernel
against the Pallas kernel in interpret mode, the ``exact`` and ``rk4``
methods against the JAX model, and Lambert W."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smc_tpu.models.michaelis_menten import (MichaelisMentenModel as JaxMM,
                                             generate_mm_pseudo_data as jgen)
from smc_tpu.ops.lambertw import lambertw as jlambertw
from smc_tpu.ops.mm_pallas import (_lambertw_fast as j_wfast,
                                   mm_loglik_exact_pallas,
                                   mm_loglik_exact_pallas_batched)
from smc_tpu_torch import convert
from smc_tpu_torch.models.michaelis_menten import (MichaelisMentenModel,
                                                   generate_mm_pseudo_data)
from smc_tpu_torch.ops.lambertw import lambertw
from smc_tpu_torch.ops.mm_cuda import (_lambertw_fast, mm_loglik_exact,
                                       mm_loglik_exact_batched,
                                       mm_loglik_exact_plain)
from tests.torch_parity import assert_ll_close

_PRIOR = dict(kind=[0, 0, 0], low=[0.0] * 3, high=[10.0] * 3,
              loc=[5.0] * 3, scale=[10.0] * 3)


@pytest.fixture(scope="module")
def data():
    ts, obs, s0 = jgen()
    return ts, obs, s0, float(ts[1] - ts[0])


def _theta(n, seed, lo=0.0, hi=10.0):
    """Prior-range draws plus the edge rows: sigma < 0, sigma == 0,
    Km == 0 (clamped to 1e-8) and Km = 1e-9 (|ln z| > 60 at t = 0)."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    th[::97, 2] *= -1.0
    th[1::101, 2] = 0.0
    th[2::89, 1] = 0.0
    th[3::83, 1] = 1e-9
    th[4] = [1.2, 0.5, 0.02]            # the truth
    return th


def test_plain_kernel_matches_pallas_interpret(data):
    """The plain version of csrc/mm_exact.cu against the Pallas kernel run
    in interpret mode, at a ragged N with sigma <= 0 and Km ~ 0 rows,
    rtol 2e-5 (the two sides' fp32 exp/log differ in the last bits)."""
    ts, obs, s0, dt = data
    theta = _theta(3001, 0)
    want = np.asarray(mm_loglik_exact_pallas(
        jnp.asarray(theta), jnp.asarray(obs), jnp.asarray(s0), dt,
        block=256, interpret=True))
    got = mm_loglik_exact(torch.from_numpy(theta), torch.from_numpy(obs),
                          torch.from_numpy(s0), dt).numpy()
    assert got.shape == (3001,) and got.dtype == np.float32
    assert np.isneginf(got[::97]).all() and np.isneginf(got[1::101]).all()
    assert_ll_close(got, want, theta, 6, 40, 2e-5)


def test_plain_kernel_batched_matches_pallas_interpret(data):
    """Population axis: B = 3 populations, each with its own observations."""
    ts, obs, s0, dt = data
    b, n = 3, 700
    theta = np.stack([_theta(n, 10 + i) for i in range(b)])
    rng = np.random.default_rng(5)
    obs_b = (obs[None] + 0.02 * rng.normal(size=(b,) + obs.shape)
             ).astype(np.float32)
    s0_b = np.repeat(s0[None], b, axis=0)
    want = np.asarray(mm_loglik_exact_pallas_batched(
        jnp.asarray(theta), jnp.asarray(obs_b), jnp.asarray(s0_b), dt,
        interpret=True))
    got = mm_loglik_exact_batched(torch.from_numpy(theta),
                                  torch.from_numpy(obs_b),
                                  torch.from_numpy(s0_b), dt)
    assert tuple(got.shape) == (b, n)
    got = got.numpy()
    assert torch.equal(
        torch.from_numpy(got),
        mm_loglik_exact_plain(torch.from_numpy(theta),
                              torch.from_numpy(obs_b),
                              torch.from_numpy(s0_b), dt))
    assert_ll_close(got.ravel(), want.ravel(), theta.reshape(-1, 3), 6,
                     40, 2e-5)


def test_lambertw_fast_matches_jax():
    logz = np.linspace(-60, 60, 4001).astype(np.float32)
    z = np.exp(logz.astype(np.float64)).astype(np.float32)
    want = np.asarray(j_wfast(jnp.asarray(z), jnp.asarray(logz)))
    got = _lambertw_fast(torch.from_numpy(z), torch.from_numpy(logz)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-30)


def test_lambertw_matches_jax():
    z = np.concatenate([[0.0], np.logspace(-20, 25, 3000)]).astype(np.float32)
    want = np.asarray(jlambertw(jnp.asarray(z)))
    got = lambertw(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-30)


@pytest.mark.parametrize("method,rtol", [("exact", 2e-5), ("rk4", 2e-5),
                                         ("pallas_exact", 2e-5)])
def test_model_methods_match_jax(data, method, rtol):
    """Both packages' models built from the same arrays; the predictions of
    exact/rk4 too. Stable-regime draws for rk4 (fixed-step RK4 in fp32 is
    chaotic for stiff draws, where both sides reject anyway)."""
    ts, obs, s0, dt = data
    lo = 0.3 if method == "rk4" else 0.0
    theta = _theta(600, 7, lo=lo, hi=5.0)
    if method == "rk4":
        theta[:, 1] = np.abs(theta[:, 1]) + 0.3
    jm = JaxMM(obs=jnp.asarray(obs), s0=jnp.asarray(s0), ts=jnp.asarray(ts),
               prior=None, method=method)
    tm = convert.mm_model_from_numpy(obs, s0, ts, _PRIOR, method=method,
                                     device="cpu")
    assert tm.dt == dt
    want, jpred = jm.log_likelihood(jnp.asarray(theta))
    got, tpred = tm.log_likelihood(torch.from_numpy(theta))
    assert_ll_close(got.numpy(), np.asarray(want), theta, 6, 40, rtol)
    if method == "pallas_exact":
        assert tpred is None and jpred is None
    else:
        np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred),
                                   rtol=2e-5, atol=2e-6)


def test_fixed_sigma_mode_matches_jax(data):
    ts, obs, s0, _ = data
    theta = _theta(300, 9, hi=5.0)[:, :2].copy()
    for method in ("exact", "pallas_exact"):
        jm = JaxMM(obs=jnp.asarray(obs), s0=jnp.asarray(s0),
                   ts=jnp.asarray(ts), prior=None, method=method,
                   est_sigma=False)
        tm = convert.mm_model_from_numpy(obs, s0, ts, _PRIOR, method=method,
                                         est_sigma=False, device="cpu")
        assert tm.param_names == ("Vmax", "Km")
        want, _ = jm.log_likelihood(jnp.asarray(theta))
        got, _ = tm.log_likelihood(torch.from_numpy(theta))
        th3 = np.concatenate([theta, np.full((300, 1), 0.02, np.float32)], 1)
        assert_ll_close(got.numpy(), np.asarray(want), th3, 6, 40, 2e-5)


def test_generated_truth_matches_jax_and_noise_is_seeded():
    jt = jgen(return_truth=True)
    t1 = generate_mm_pseudo_data(return_truth=True)
    t2 = generate_mm_pseudo_data(return_truth=True)
    np.testing.assert_array_equal(jt[0], t1[0])            # ts
    np.testing.assert_array_equal(jt[2], t1[2])            # s0
    np.testing.assert_allclose(t1[3], jt[3], rtol=1e-5, atol=1e-6)  # truth
    np.testing.assert_array_equal(t1[1], t2[1])            # same seed
    noise = t1[1] - (t1[2][:, None] - t1[3])
    assert abs(noise.std() - 0.02) < 0.003 and abs(noise.mean()) < 0.005
    m = MichaelisMentenModel.default(method="exact", device="cpu", seed=3)
    assert tuple(m.obs.shape) == (6, 40) and m.dt == pytest.approx(10 / 39)


def test_unported_method_raises():
    """Every JAX method is ported (``dopri5`` since ROADMAP Queue 1 item
    11); a method neither package has still raises."""
    with pytest.raises(NotImplementedError, match="not implemented"):
        MichaelisMentenModel.default(method="euler", device="cpu")
    assert MichaelisMentenModel.default(method="dopri5",
                                        device="cpu").method == "dopri5"

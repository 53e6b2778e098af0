"""The port's fixed-step RK4 Michaelis-Menten likelihood (method="pallas",
CUDA kernel csrc/mm_rk4.cu) against the JAX package on the CPU: the kernel's
plain version and the model's method against ``mm_loglik_pallas`` run in
interpret mode, on shared arrays."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smc_tpu.models.michaelis_menten import generate_mm_pseudo_data as jgen
from smc_tpu.ops.mm_pallas import mm_loglik_pallas as j_mm_loglik_pallas
from smc_tpu_torch import SMCConfig, convert, make_full_run_on_device
from smc_tpu_torch.ops import mm_cuda
from smc_tpu_torch.ops.mm_cuda import mm_loglik_pallas, mm_loglik_rk4_plain
from tests.torch_parity import assert_ll_close

_PRIOR = dict(kind=[0, 0, 0], low=[0.0] * 3, high=[10.0] * 3,
              loc=[5.0] * 3, scale=[10.0] * 3)
# The two sides do the same fp32 operations in the same order; XLA may
# contract a multiply-add where PyTorch does not, and 156 RK4 steps carry
# such last-bit differences along. 2e-5 of the larger of ll's two terms
# holds them on stable draws (measured: 1.1e-6 at N = 1000).
RTOL = 2e-5
# chip_smoke.py holds the CUDA kernel to its plain version only where
# Km >= 0.3: below it fixed-step RK4 in fp32 is chaotic.
RK4_STABLE_KM = 0.3


@pytest.fixture(scope="module")
def data():
    ts, obs, s0 = jgen()
    return ts, obs, s0, float(ts[1] - ts[0])


def _stable_theta(n, seed):
    """Draws where fixed-step RK4 in fp32 is stable (Km not tiny; the
    regime tests/test_pallas.py uses), with the truth last and, from
    n = 64 on, the edge rows sigma < 0 and sigma == 0."""
    rng = np.random.default_rng(seed)
    th = np.column_stack([rng.uniform(0.3, 5.0, n), rng.uniform(0.3, 5.0, n),
                          rng.uniform(0.05, 5.0, n)]).astype(np.float32)
    if n >= 64:
        th[::37, 2] *= -1.0
        th[1::41, 2] = 0.0
    th[-1] = [1.2, 0.5, 0.02]
    return th


def _jax_ll(theta, obs, s0, dt, **kw):
    return np.asarray(j_mm_loglik_pallas(
        jnp.asarray(theta), jnp.asarray(obs), jnp.asarray(s0), dt,
        interpret=True, **kw))


@pytest.mark.parametrize("n,block", [(256, 256), (300, 256), (3, 256),
                                     (1000, 8192)])
def test_plain_rk4_matches_pallas_interpret(data, n, block):
    """The plain version of csrc/mm_rk4.cu against the Pallas kernel in
    interpret mode, at sizes that are and are not multiples of the TPU
    kernel's block (its pad-and-slice path; the port masks instead)."""
    ts, obs, s0, dt = data
    theta = _stable_theta(n, n)
    want = _jax_ll(theta, obs, s0, dt, block=block)
    got = mm_loglik_rk4_plain(torch.from_numpy(theta), torch.from_numpy(obs),
                              torch.from_numpy(s0), dt).numpy()
    assert got.shape == (n,) and got.dtype == np.float32
    assert np.isneginf(got[theta[:, 2] <= 0]).all()
    assert_ll_close(got, want, theta, 6, 40, RTOL)


@pytest.mark.parametrize("substeps", [1, 2])
def test_plain_rk4_substeps(data, substeps):
    ts, obs, s0, dt = data
    theta = _stable_theta(128, 5)
    want = _jax_ll(theta, obs, s0, dt, substeps=substeps, block=128)
    got = mm_loglik_rk4_plain(torch.from_numpy(theta), torch.from_numpy(obs),
                              torch.from_numpy(s0), dt, substeps).numpy()
    assert_ll_close(got, want, theta, 6, 40, RTOL)


def test_rk4_edge_rows_are_minus_inf_never_nan(data):
    """sigma <= 0 gives -inf. Km is not clamped in this kernel: Km = 0 with
    S reaching 0 makes 0/0, and Km = -S0 a division by zero at t = 0; a NaN
    log-likelihood comes out as -inf on both sides, never as NaN."""
    ts, obs, s0, dt = data
    theta = np.array([[1.2, 0.5, 0.02],
                      [1.2, 0.5, -1.0],
                      [1.2, 0.5, 0.0],
                      [5.0, 0.0, 0.5],        # Km = 0: S hits 0, then 0/0
                      [1.0, -2.0, 0.5],       # Km + S0 = 0 for S0 = 2
                      [np.nan, 0.5, 0.5],
                      [1.2, np.nan, 0.5],
                      [1.2, 0.5, np.nan]], np.float32)
    want = _jax_ll(theta, obs, s0, dt, block=8)
    got = mm_loglik_pallas(torch.from_numpy(theta), torch.from_numpy(obs),
                           torch.from_numpy(s0), dt).numpy()
    assert not np.isnan(got).any() and not np.isnan(want).any()
    assert np.isfinite(got[0])
    assert np.isneginf(got[[1, 2, 5, 6, 7]]).all()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4)


def test_model_method_pallas_matches_jax_model(data):
    """The model's method="pallas" (the plain version here, the CUDA kernel
    on the card) against the JAX model's, which runs its Pallas kernel in
    interpret mode on the CPU; and against the port's own "rk4" method,
    which is the same march written with ops/ode.py."""
    from smc_tpu.models.michaelis_menten import MichaelisMentenModel as JaxMM
    from smc_tpu.priors import Prior as JaxPrior
    ts, obs, s0, dt = data
    theta = _stable_theta(512, 9)
    jm = JaxMM(obs=jnp.asarray(obs), s0=jnp.asarray(s0), ts=jnp.asarray(ts),
               prior=JaxPrior.uniform([0.0] * 3, [10.0] * 3), method="pallas")
    want, pred = jm.log_likelihood(jnp.asarray(theta))
    assert pred is None
    tm = convert.mm_model_from_numpy(obs, s0, ts, _PRIOR, method="pallas",
                                     device="cpu")
    got, tpred = tm.log_likelihood(torch.from_numpy(theta))
    assert tpred is None
    assert_ll_close(got.numpy(), np.asarray(want), theta, 6, 40, RTOL)
    rk4 = convert.mm_model_from_numpy(obs, s0, ts, _PRIOR, method="rk4",
                                      device="cpu")
    ref = rk4.log_likelihood(torch.from_numpy(theta))[0].numpy()
    assert_ll_close(got.numpy(), ref, theta, 6, 40, 2e-4)


def test_model_method_pallas_fixed_sigma_and_substeps(data):
    ts, obs, s0, dt = data
    theta = _stable_theta(64, 2)
    tm = convert.mm_model_from_numpy(obs, s0, ts, _PRIOR, method="pallas",
                                     substeps=2, est_sigma=False,
                                     sigma_fixed=0.05, device="cpu")
    got = tm.log_likelihood(torch.from_numpy(theta[:, :2].copy()))[0].numpy()
    th3 = theta.copy()
    th3[:, 2] = 0.05
    want = _jax_ll(th3, obs, s0, dt, substeps=2, block=64)
    assert_ll_close(got, want, th3, 6, 40, RTOL)


def test_dopri5_still_raises(data):
    """``dopri5`` once raised here; it is ported now (ROADMAP Queue 1 item
    11): the builder makes the model, and its likelihood is rk4's within
    the two integrators' truncation error (the JAX comparison is in
    tests/test_torch_generic.py). An unknown method still raises."""
    ts, obs, s0, _ = data
    th = torch.from_numpy(_stable_theta(64, 3))
    lls = [convert.mm_model_from_numpy(obs, s0, ts, _PRIOR, method=m,
                                       device="cpu").log_likelihood(th)[0]
           for m in ("dopri5", "rk4")]
    torch.testing.assert_close(lls[0], lls[1], rtol=1e-3, atol=0.0)
    with pytest.raises(NotImplementedError):
        convert.mm_model_from_numpy(obs, s0, ts, _PRIOR, method="euler",
                                    device="cpu")


def test_wrapper_rejects_other_devices(data):
    """A tensor that is neither on the CPU nor on a CUDA device raises: the
    wrapper never falls back to the plain version for it."""
    ts, obs, s0, dt = data
    theta = torch.from_numpy(_stable_theta(8, 0)).to("meta")
    with pytest.raises(ValueError):
        mm_loglik_pallas(theta, torch.from_numpy(obs), torch.from_numpy(s0),
                         dt)


def test_run_with_method_pallas_reaches_gamma_one(data):
    """A whole run through method="pallas" at N = 512: gamma = 1 and a
    posterior around the truth (Vmax = 1.2, Km = 0.5, sigma = 0.02)."""
    ts, obs, s0, _ = data
    tm = convert.mm_model_from_numpy(obs, s0, ts, _PRIOR, method="pallas",
                                     device="cpu")
    s = make_full_run_on_device(tm, SMCConfig(n_particles=512))(1)
    assert float(s.gamma) == 1.0
    p = s.particles.numpy()
    mean, std = p.mean(0), p.std(0)
    assert abs(mean[0] - 1.2) < 4 * std[0] + 0.05
    assert abs(mean[1] - 0.5) < 4 * std[1] + 0.05
    assert abs(mean[2] - 0.02) < 4 * std[2] + 0.01
    assert bool(torch.isfinite(s.log_lik).all())


def _march_flushed(theta, obs, s0, dt, substeps=4):
    """mm_loglik_rk4_plain with one change, as csrc/mm_rk4.cu makes it: a
    state below FLT_MIN in magnitude is set to 0 after every step. Also
    returns, per row, whether the unflushed state would have been
    subnormal there."""
    n_ds, n_obs = obs.shape
    vmax, km, sig = theta[None, :, 0], theta[None, :, 1], theta[:, 2]
    s0c = s0[:, None]
    h, half_h, h_sixth = mm_cuda._rk4_steps(dt, substeps)
    tiny = torch.finfo(torch.float32).tiny

    def f(S):
        return -vmax * S / (km + S)

    S = s0c.expand(n_ds, theta.shape[0])
    under = torch.zeros(S.shape, dtype=torch.bool)
    r0 = obs[:, 0:1] - (s0c - S)
    acc = torch.zeros_like(r0) + r0 * r0
    for i in range(1, n_obs):
        for _ in range(substeps):
            k1 = f(S)
            k2 = f(S + half_h * k1)
            k3 = f(S + half_h * k2)
            k4 = f(S + h * k3)
            S = S + h_sixth * (k1 + 2 * k2 + 2 * k3 + k4)
            small = S.abs() < tiny
            under |= small & (S != 0)
            S = torch.where(small, torch.zeros_like(S), S)
        r = obs[:, i:i + 1] - (s0c - S)
        acc = acc + r * r
    total = acc[0]
    for ds in range(1, n_ds):
        total = total + acc[ds]
    sigma = torch.maximum(sig, theta.new_tensor(1e-12))
    ll = ((-0.5 * n_obs * n_ds) * (mm_cuda._LOG2PI + 2.0 * torch.log(sigma))
          - total / (2.0 * sigma * sigma))
    bad = (sig <= 0.0) | torch.isnan(ll)
    return torch.where(bad, theta.new_tensor(-np.inf), ll), under.any(0)


def test_flushing_subnormal_state_keeps_the_likelihood_bits(data):
    """What csrc/mm_rk4.cu rests on: on prior draws, many of whose states
    decay below FLT_MIN, setting such a state to 0 after every step gives
    the same ll bits as the unflushed march wherever Km >= RK4_STABLE_KM
    (s0 - S is s0 for any S that small), and the same -inf rows
    everywhere, Km = 0 and NaN rows included."""
    ts, obs, s0, dt = data
    rng = np.random.default_rng(11)
    theta = (rng.random((4096, 3)) * 10.0).astype(np.float32)
    theta[::97, 2] *= -1.0
    theta[1::101, 2] = 0.0
    theta[2::89, 1] = 0.0
    theta[3::113, 0] = np.nan
    theta[4::127, 1] = np.nan
    th, o, s = (torch.from_numpy(a) for a in (theta, obs, s0))
    want = mm_loglik_rk4_plain(th, o, s, dt)
    got, under = _march_flushed(th, o, s, dt)
    assert int(under.sum()) > 100          # the flush is exercised
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    assert not bool(torch.isnan(got).any())
    stable = th[:, 1] >= RK4_STABLE_KM
    assert int((under & stable).sum()) > 100
    assert torch.equal(got[stable], want[stable])


# --------------------------------------------------------------------------
# The population axis: kernel 5 under vmap (the ensemble's and SBC's
# method="pallas")
# --------------------------------------------------------------------------
D_POP, N_POP = 3, 256


def _population_inputs(data):
    """D_POP populations of N_POP stable draws, each with the pseudo-data
    plus its own 0.02 NumPy noise, and the shared s0 per population."""
    ts, obs, s0, dt = data
    rng = np.random.default_rng(21)
    theta = np.stack([_stable_theta(N_POP, 30 + p) for p in range(D_POP)])
    pobs = (obs[None] + 0.02 * rng.standard_normal((D_POP,) + obs.shape)
            ).astype(np.float32)
    ps0 = np.broadcast_to(s0, (D_POP,) + s0.shape).copy()
    return theta, pobs, ps0, dt


@pytest.fixture(scope="module")
def vmapped_jax(data):
    """jax.vmap of mm_loglik_pallas in interpret mode over the populations
    (theta and obs mapped, s0 shared), compiled once for this file."""
    import jax
    theta, pobs, ps0, dt = _population_inputs(data)
    fn = jax.jit(jax.vmap(
        lambda th, ob: j_mm_loglik_pallas(th, ob, jnp.asarray(ps0[0]), dt,
                                          block=N_POP, interpret=True)))
    return np.asarray(fn(jnp.asarray(theta), jnp.asarray(pobs)))


def test_batched_plain_rk4_matches_vmapped_pallas_interpret(data,
                                                             vmapped_jax):
    """The batched plain version of csrc/mm_rk4.cu (the kernel's grid.y =
    population) against the JAX package's kernel under vmap, in interpret
    mode: every population within the pinned RTOL of row 5's test."""
    theta, pobs, ps0, dt = _population_inputs(data)
    got = mm_cuda.mm_loglik_rk4_plain(
        torch.from_numpy(theta), torch.from_numpy(pobs),
        torch.from_numpy(ps0), dt).numpy()
    assert got.shape == (D_POP, N_POP) and got.dtype == np.float32
    for p in range(D_POP):
        assert_ll_close(got[p], vmapped_jax[p], theta[p], 6, 40, RTOL)


def test_batched_plain_rk4_with_one_population_is_the_unbatched(data):
    """B = 1 of the batched plain version has the unbatched entry's bits,
    and so has every row of a batch (the CPU side of the card's check that
    row p of a launch is the per-population launch)."""
    theta, pobs, ps0, dt = _population_inputs(data)
    th, ob, s = (torch.from_numpy(a) for a in (theta, pobs, ps0))
    batched = mm_cuda.mm_loglik_pallas_batched(th, ob, s, dt)
    for p in range(D_POP):
        one = mm_cuda.mm_loglik_pallas_batched(th[p:p + 1], ob[p:p + 1],
                                               s[p:p + 1], dt)
        assert one.shape == (1, N_POP)
        assert torch.equal(one[0], mm_loglik_pallas(th[p], ob[p], s[p], dt))
        assert torch.equal(batched[p], one[0])


def test_data_loglik_pallas_is_the_per_population_likelihood(data):
    """make_mm_data_loglik(method="pallas"), the ensemble's likelihood (one
    kernel launch for all D on the card), gives each population's own
    mm_loglik_pallas against its own observations, bit for bit."""
    from smc_tpu_torch.models.michaelis_menten import make_mm_data_loglik
    ts, _, s0, dt = data
    theta, pobs, _, _ = _population_inputs(data)
    fn = make_mm_data_loglik(torch.from_numpy(ts), torch.from_numpy(s0),
                             method="pallas", substeps=2)
    got, pred = fn(torch.from_numpy(theta), torch.from_numpy(pobs))
    assert pred is None and got.shape == (D_POP, N_POP)
    for p in range(D_POP):
        want = mm_loglik_pallas(torch.from_numpy(theta[p]),
                                torch.from_numpy(pobs[p]),
                                torch.from_numpy(s0), dt, 2)
        assert torch.equal(got[p], want)

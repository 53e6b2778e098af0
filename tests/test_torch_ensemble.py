"""The port's hierarchical ensemble against the JAX package on the CPU.

The batched gamma search, resampling and mutation sweep are held against
``jax.vmap`` of the JAX functions on shared arrays and shared draws, the way
tests/test_torch_{ladder,resample,smc}.py hold the unbatched ones; the whole
ensemble against D single runs of the port fed the same draws (what vmap
guarantees the JAX package) and, statistically, against the JAX ensemble.
Shapes are reused (D = 3, N = 256, d = 3) so JAX compiles little."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smc_tpu import SMCConfig as JaxConfig
from smc_tpu.models.michaelis_menten import (
    generate_mm_pseudo_data as jgen, make_mm_data_loglik as j_data_loglik)
from smc_tpu.ops.ladder_pallas import _ladder_stats_jnp
from smc_tpu.ops.mm_pallas import mm_loglik_exact_pallas_batched
from smc_tpu.priors import Prior as JaxPrior
from smc_tpu.smc import ensemble as je
from smc_tpu.smc import kernels as jk
from smc_tpu_torch import (SMCConfig, convert, make_ensemble_run,
                           run_ensemble_on_device, run_ensemble_sweeps,
                           run_smc_on_device, take_datasets)
from smc_tpu_torch.models.michaelis_menten import make_mm_data_loglik
from smc_tpu_torch.ops.ladder_cuda import ladder_stats, ladder_stats_plain
from smc_tpu_torch.priors import Prior
from smc_tpu_torch.rng import TorchDraws
from smc_tpu_torch.smc import ensemble as te
from smc_tpu_torch.smc import kernels as tk
from tests.torch_parity import (PopulationReplay, RecordingDraws, ReplayDraws,
                                assert_ll_close, jax_state_to_numpy,
                                sweep_draws)

D, N, DIM = 3, 256, 3
_PRIOR = dict(kind=[0, 0, 0], low=[0.0] * 3, high=[10.0] * 3,
              loc=[5.0] * 3, scale=[10.0] * 3)


@pytest.fixture(scope="module")
def data():
    """(ts, obs (D, 6, 40), s0): the pseudo-data plus 0.02 noise per
    population, NumPy float32 shared by both packages."""
    ts, obs0, s0 = jgen()
    rng = np.random.default_rng(11)
    obs = (obs0[None] + 0.02 * rng.normal(size=(D,) + obs0.shape)
           ).astype(np.float32)
    return ts, obs, s0


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_problem(data, method="exact"):
    ts, obs, s0 = data
    prior = Prior.uniform([0.0] * 3, [10.0] * 3, device="cpu")
    return prior, make_mm_data_loglik(_t(ts), _t(s0), method=method), _t(obs)


def _cloud(seed, n=N):
    """(D, n, 3) particles around the truth, and per-population widths."""
    rng = np.random.default_rng(seed)
    p = np.asarray([1.2, 0.5, 0.02]) + rng.normal(size=(D, n, 3)) * (
        np.asarray([0.2, 0.2, 0.01]) * np.arange(1, D + 1)[:, None, None])
    return np.abs(p).astype(np.float32)


# ---- the kernels' plain versions and the batched likelihood --------------

def test_batched_plain_ladder_matches_jnp():
    """(D, N) x (D, K) plain ladder against the JAX package's batched form
    (the one its vmapped ladder falls back to), rtol 2e-5; the wrapper on
    CPU tensors is the plain version, and row p equals the unbatched call
    on row p bit for bit."""
    rng = np.random.default_rng(9)
    b, n, k = 5, 1000, 81
    d_ll = -np.abs(rng.normal(size=(b, n))).astype(np.float32) * 4.0
    d_ll[:, ::53] = -np.inf
    dg = np.stack([(0.3 * 0.7 ** np.arange(k)) * (1.0 + 0.1 * i)
                   for i in range(b)]).astype(np.float32)
    r1, r2 = _ladder_stats_jnp(jnp.asarray(d_ll), jnp.asarray(dg))
    s1, s2 = ladder_stats(_t(d_ll), _t(dg))
    assert s1.shape == s2.shape == (b, k)
    np.testing.assert_allclose(s1.numpy(), np.asarray(r1), rtol=2e-5)
    np.testing.assert_allclose(s2.numpy(), np.asarray(r2), rtol=2e-5)
    for i in range(b):
        u1, u2 = ladder_stats_plain(_t(d_ll[i]), _t(dg[i]))
        assert torch.equal(u1, s1[i]) and torch.equal(u2, s2[i])


def test_data_loglik_pallas_exact_matches_batched_pallas_interpret(data):
    """make_mm_data_loglik("pallas_exact") (one batched call: the plain
    version of csrc/mm_exact.cu here) against the JAX package's batched
    Pallas kernel in interpret mode, D = 3 populations with their own
    observations, a ragged N; rtol 2e-5 of the larger ll term."""
    ts, obs, s0 = data
    rng = np.random.default_rng(3)
    n = 300
    theta = rng.uniform(0.05, 8.0, size=(D, n, 3)).astype(np.float32)
    theta[:, ::37, 2] *= -1.0
    dt = float(ts[1] - ts[0])
    want = np.asarray(mm_loglik_exact_pallas_batched(
        jnp.asarray(theta), jnp.asarray(obs),
        jnp.broadcast_to(jnp.asarray(s0), (D, 6)), dt, interpret=True))
    _, loglik, tobs = _port_problem(data, "pallas_exact")
    got, pred = loglik(_t(theta), tobs)
    assert pred is None and got.shape == (D, n)
    assert_ll_close(got.numpy(), want, theta, 6, 40, 2e-5)


@pytest.mark.parametrize("method", ["exact", "rk4", "pallas",
                                    "pallas_exact"])
def test_data_loglik_equals_the_model_per_population(data, method):
    """Every method's batched likelihood gives, for population p, the bits
    of the single model built on population p's observations."""
    ts, obs, s0 = data
    theta = _cloud(1, 64)
    _, loglik, tobs = _port_problem(data, method)
    got, pred = loglik(_t(theta), tobs)
    for p in range(D):
        m = convert.mm_model_from_numpy(obs[p], s0, ts, _PRIOR,
                                        method=method, device="cpu")
        want, wpred = m.log_likelihood(_t(theta[p]))
        assert torch.equal(got[p], want)
        if wpred is None:
            assert pred is None
        else:
            assert torch.equal(pred[p], wpred)


# ---- batched gamma search, resampling, covariance -------------------------

def _loglik_rows(seed):
    rng = np.random.default_rng(seed)
    ll = rng.normal(-50, 30, size=(D, 512)).astype(np.float32)
    ll *= np.asarray([1.0, 0.1, 3.0], np.float32)[:, None]
    ll[1:, ::50] = -np.inf       # row 0 stays finite: it may sit at gamma = 1
    return ll


@pytest.mark.parametrize("gamma_old", [(0.0, 0.0, 0.0), (0.13, 0.0, 0.9),
                                       (1.0, 0.5, 0.02)])
def test_batched_find_gamma_matches_vmap(gamma_old):
    """find_gamma on (D, N) with per-population gamma_old against jax.vmap
    of the JAX find_gamma: the same candidate index per population, gamma
    to 1e-6, ESS, weights and evidence increment to 1e-5. A population
    already at gamma = 1 takes a zero increment (flat weights)."""
    ll = _loglik_rows(int(sum(gamma_old) * 100))
    g_old = np.asarray(gamma_old, np.float32)
    jcfg, tcfg = JaxConfig(n_particles=512), SMCConfig(n_particles=512)
    jg = jax.vmap(lambda l, g: jk.find_gamma(l, g, jcfg))(
        jnp.asarray(ll), jnp.asarray(g_old))
    tg = tk.find_gamma(_t(ll), _t(g_old), tcfg)
    assert tg.gamma.shape == (D,) and tg.weights.shape == (D, 512)
    assert tg.n_reductions.dtype == torch.int32
    np.testing.assert_array_equal(tg.n_reductions.numpy(),
                                  np.asarray(jg.n_reductions))
    np.testing.assert_allclose(tg.gamma.numpy(), np.asarray(jg.gamma),
                               rtol=1e-6)
    np.testing.assert_allclose(tg.ess.numpy(), np.asarray(jg.ess), rtol=1e-5)
    np.testing.assert_array_equal(tg.max_log_lik.numpy(),
                                  np.asarray(jg.max_log_lik))
    np.testing.assert_allclose(tg.weights.numpy(), np.asarray(jg.weights),
                               rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(tg.log_z_inc.numpy(),
                               np.asarray(jg.log_z_inc), rtol=1e-5,
                               atol=1e-5)
    # and each row is the unbatched search on that row, bit for bit
    for p in range(D):
        one = tk.find_gamma(_t(ll[p]), torch.tensor(g_old[p]), tcfg)
        assert torch.equal(one.gamma, tg.gamma[p])
        assert torch.equal(one.weights, tg.weights[p])


def _weight_rows(n, seed):
    rng = np.random.default_rng(seed)
    w = rng.gamma(0.2, size=(D, n)).astype(np.float32)
    w[1, 7] = 1e6                      # one particle dominates
    w[2, : n // 2] = 0.0               # half the particles carry nothing
    return (w / w.sum(1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("n", [256, 1000, 4096 + 333])
def test_batched_counts_offsets_and_apply_bitwise(n):
    """Counts, offsets, ancestors and the resampled bundle for D populations
    at once against jax.vmap of the JAX functions with each population's
    own key (v0 drawn from it): the same bits."""
    w = _weight_rows(n, n)
    rng = np.random.default_rng(n + 1)
    parts = rng.normal(size=(D, n, 3)).astype(np.float32)
    lk = (rng.normal(size=(D, n)) * 100).astype(np.float32)
    lk[:, 3] = -np.inf
    keys = jax.random.split(jax.random.key(n), D)
    jc, jo = jax.vmap(jk._rs_counts_offsets)(keys, jnp.asarray(w))
    anc = jax.vmap(jk.residual_systematic_resample)(keys, jnp.asarray(w))
    v0 = _t(np.asarray(jax.vmap(lambda k: jax.random.uniform(k, ()))(keys)))
    tc, to = tk._rs_counts_offsets(v0, _t(w))
    assert tc.shape == to.shape == (D, n) and tc.dtype == torch.int32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert (tc.sum(1) == n).all() and int(tc.min()) >= 0
    np.testing.assert_array_equal(
        tk.residual_systematic_ancestors(v0, _t(w)).numpy(), np.asarray(anc))
    tp, tl = tk.residual_systematic_apply(v0, _t(w), _t(parts), _t(lk))
    take = jax.vmap(lambda x, a: jnp.take(x, a, 0))
    np.testing.assert_array_equal(tp.numpy(),
                                  np.asarray(take(jnp.asarray(parts), anc)))
    np.testing.assert_array_equal(tl.numpy(),
                                  np.asarray(take(jnp.asarray(lk), anc)))


def test_batched_covariance_and_cholesky():
    """(D, d, d) weighted covariance against jax.vmap of the JAX function
    (rtol 1e-5), and a degenerate population's factor goes NaN alone."""
    x = _cloud(4)
    cw = SMCConfig().cov_weight(3)
    got = tk._weighted_cov(_t(x), cw)
    want = jax.vmap(lambda a: jk._weighted_cov(a, jnp.asarray(cw.numpy())))(
        jnp.asarray(x))
    assert got.shape == (D, 3, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-12)
    for p in range(D):
        assert torch.equal(tk._weighted_cov(_t(x[p]), cw), got[p])
    bad = got.clone()
    bad[1] = torch.tensor([[1.0, 2.0, 0.0], [2.0, 1.0, 0.0],
                           [0.0, 0.0, 1.0]])
    chol = tk._cholesky_or_nan(bad)
    assert torch.isnan(chol[1]).all()
    assert torch.isfinite(chol[0]).all() and torch.isfinite(chol[2]).all()
    np.testing.assert_allclose(chol[0].numpy(),
                               np.linalg.cholesky(got[0].numpy()), rtol=1e-5,
                               atol=1e-9)


# ---- one ensemble sweep ---------------------------------------------------

def test_ensemble_sweep_with_shared_draws(data):
    """One RWM sweep of D populations against jax.vmap of the JAX sweep,
    each JAX population's z and u stacked into the ensemble's draws: the
    accept decisions are identical except on rows where log_acc is within
    1e-4 of log u (counted), the other rows' particles agree to 1e-5, and
    the per-population controller state (sweep count, stop latch, step
    ratio) is the same."""
    ts, obs, s0 = data
    parts = _cloud(0)
    gamma = np.asarray([0.05, 0.3, 1.0], np.float32)
    j_ll = j_data_loglik(jnp.asarray(ts), jnp.asarray(s0))
    ll = np.asarray(jax.vmap(lambda th, o: j_ll(th, o)[0])(
        jnp.asarray(parts), jnp.asarray(obs)))
    jcfg, tcfg = JaxConfig(n_particles=N), SMCConfig(n_particles=N)
    jprior = JaxPrior.uniform([0.0] * 3, [10.0] * 3)
    keys = jax.random.split(jax.random.key(4), D)

    def j_one(key, p, l, g, o):
        init, sweep = jk.make_mutation_sweeper(
            "rwm", lambda th: j_ll(th, o), jprior, jcfg)
        return sweep(init(key, p, l), g)

    jc = jax.jit(jax.vmap(j_one))(keys, jnp.asarray(parts), jnp.asarray(ll),
                                  jnp.asarray(gamma), jnp.asarray(obs))
    per_pop = [sweep_draws(k, N, DIM, 1) for k in keys]
    draws = ReplayDraws([
        ("normal", np.stack([np.asarray(e[0][1]) for e in per_pop])),
        ("uniform", np.stack([np.asarray(e[1][1]) for e in per_pop]))])
    prior, loglik, tobs = _port_problem(data)
    init, draw, core, admin, _ = tk.make_mutation_parts(
        "rwm", lambda th: loglik(th, tobs), prior, tcfg)
    c0 = init(draws, _t(parts), _t(ll))
    assert c0.j.shape == c0.done.shape == c0.mh_ratio.shape == (D,)
    _, (chol,), (z, log_u) = draw(c0)
    g = _t(gamma)
    tp, tl, lp, _, acc = core(c0.particles, c0.log_lik, c0.log_prior,
                              c0.grad, c0.mh_ratio, (chol,), (z, log_u), g)
    assert draws.used == 2
    c1 = admin(c0, draws, tp, tl, lp, c0.grad, acc, g)
    prop = c0.particles + z @ chol.transpose(1, 2)
    ins = prior.in_support(prop)
    pe = torch.where(ins[..., None], prop, c0.particles)
    log_acc = ((loglik(pe, tobs)[0] - c0.log_lik) * g[:, None]
               + (prior.log_pdf(pe) - c0.log_prior))
    margin = (log_acc - log_u).abs().numpy()
    j_acc = np.asarray(jc.r_ac)
    differ = acc.numpy() != j_acc
    assert (margin[differ] < 1e-4).all()
    assert differ.sum() <= max(1, (margin < 1e-4).sum())
    assert (j_acc.mean(1) > 0.02).all() and (j_acc.mean(1) < 0.98).all()
    same = ~differ
    np.testing.assert_allclose(tp.numpy()[same],
                               np.asarray(jc.particles)[same], rtol=0,
                               atol=1e-5)
    assert_ll_close(tl.numpy()[same], np.asarray(jc.log_lik)[same],
                    tp.numpy()[same], 6, 40, 2e-5)
    if not differ.any():
        np.testing.assert_array_equal(c1.done.numpy(), np.asarray(jc.done))
        np.testing.assert_array_equal(c1.mh_ratio.numpy(),
                                      np.asarray(jc.mh_ratio))
    np.testing.assert_array_equal(c1.j.numpy(), np.asarray(jc.j))


def test_inactive_populations_keep_their_carry(data):
    """sweep_fn with an active mask: the masked population's particles,
    log-likelihoods, counter, accepted set, ratio and latch stay as they
    were, while the others move."""
    prior, loglik, tobs = _port_problem(data)
    parts = _t(_cloud(2))
    ll = loglik(parts, tobs)[0]
    init, sweep = tk.make_mutation_sweeper(
        "rwm", lambda th: loglik(th, tobs), prior, SMCConfig(n_particles=N))
    c0 = init(TorchDraws(0, "cpu"), parts, ll)
    active = torch.tensor([True, False, True])
    c1 = sweep(c0, torch.tensor([0.1, 0.1, 0.1]), active)
    assert c1.j.tolist() == [1, 0, 1]
    assert torch.equal(c1.particles[1], c0.particles[1])
    assert torch.equal(c1.log_lik[1], c0.log_lik[1])
    assert not bool(c1.r_ac[1].any()) and bool(c1.r_ac[0].any())
    assert not torch.equal(c1.particles[0], c0.particles[0])
    assert not torch.equal(c1.particles[2], c0.particles[2])


def _grad_rows(got, want):
    """|got - want| within 1e-4 of each row's largest |want|."""
    row = np.abs(want).max(-1, keepdims=True)
    assert (np.abs(got - want) <= 1e-4 * row).all()


def test_batched_ll_and_grad_equals_each_population(data):
    """``_make_ll_and_grad`` of the (D, N) data likelihood (one backward
    pass over every population) against each population's own call and
    against jax.vmap of the JAX package's: the same log-likelihoods and
    -inf rows (sigma <= 0, gradient 0), gradients within 1e-4 of each row's
    largest |g|. A gradient taken from another population's rows fails."""
    ts, obs, s0 = data
    theta = _cloud(3)
    theta[:, ::9, 2] *= -1.0                   # sigma <= 0: -inf rows
    prior, loglik, tobs = _port_problem(data)
    ll, g = tk._make_ll_and_grad(lambda th: loglik(th, tobs))(_t(theta))
    assert ll.shape == (D, N) and g.shape == (D, N, DIM)
    inf = torch.isinf(ll)
    assert int(inf.sum()) == D * len(range(0, N, 9))
    assert bool((g[inf] == 0).all()) and not bool(torch.isnan(g).any())
    j_ll = j_data_loglik(jnp.asarray(ts), jnp.asarray(s0))
    jl, jg = (np.asarray(a) for a in jax.jit(jax.vmap(
        lambda th, o: jk._make_ll_and_grad(lambda t: j_ll(t, o))(th)))(
            jnp.asarray(theta), jnp.asarray(obs)))
    np.testing.assert_array_equal(np.isinf(jl), inf.numpy())
    keep = ~inf.numpy()
    for p in range(D):
        lp, gp = tk._make_ll_and_grad(
            lambda th: loglik(th[None], tobs[p:p + 1]))(_t(theta[p]))
        assert torch.equal(lp[0], ll[p])
        k = keep[p]
        _grad_rows(g[p].numpy()[k], gp.numpy()[k])
        assert_ll_close(ll[p].numpy()[k], jl[p][k], theta[p][k], 6, 40, 2e-5)
        _grad_rows(g[p].numpy()[k], jg[p][k])


@pytest.mark.parametrize("kind", ["mala", "hmc"])
def test_inactive_populations_keep_their_gradients(data, kind):
    """The gradient kinds' sweep with an active mask: the masked
    population's particles, log-likelihoods, gradients, counter and
    accepted set stay as they were; the others move, and every carried
    gradient is its own population's gradient at its particles (within
    1e-4 of each row's largest |g|)."""
    prior, loglik, tobs = _port_problem(data)
    parts = _t(_cloud(2))
    ll = loglik(parts, tobs)[0]
    fn = lambda th: loglik(th, tobs)          # noqa: E731
    init, sweep = tk.make_mutation_sweeper(
        kind, fn, prior, SMCConfig(n_particles=N, mutation=kind,
                                   hmc_leapfrog=3))
    c0 = init(TorchDraws(0, "cpu"), parts, ll)
    active = torch.tensor([True, False, True])
    # gamma 1e-3: at 0.1 the gradients of a cloud this wide reject every
    # proposal.
    c1 = sweep(c0, torch.full((D,), 1e-3), active)
    assert c1.j.tolist() == [1, 0, 1]
    for f in ("particles", "log_lik", "grad"):
        assert torch.equal(getattr(c1, f)[1], getattr(c0, f)[1]), f
    assert not bool(c1.r_ac[1].any())
    for p in (0, 2):
        assert bool(c1.r_ac[p].any())
        assert not torch.equal(c1.particles[p], c0.particles[p])
        assert not torch.equal(c1.grad[p], c0.grad[p])
    for c in (c0, c1):
        want = tk._make_ll_and_grad(fn)(c.particles)[1]
        for p in range(D):
            _grad_rows(c.grad[p].numpy(), want[p].numpy())


# ---- the whole ensemble ----------------------------------------------------

@pytest.mark.parametrize("method,mutation", [
    pytest.param("pallas_exact", "rwm", id="pallas_exact"),
    pytest.param("exact", "rwm", id="exact"),
    pytest.param("exact", "mala", id="exact-mala")])
def test_ensemble_equals_single_runs_with_the_same_draws(data, method,
                                                         mutation):
    """What vmap guarantees the JAX package, shown for the written-out
    axis: population p of the ensemble ends where ``run_smc_on_device``
    ends for p alone, fed p's rows of the ensemble's draws (keyed by step
    and sweep, since a finished population stops consuming sweeps). For
    MALA (the same draws; a population whose sweeps are done keeps its
    gradients with its particles) the runs are held statistically, for the
    reason :func:`_assert_same_posterior` gives.

    Tolerance: the elementwise arithmetic is the same bits per row; the
    reductions over the particle axis (ladder sums, weight sum, mean,
    covariance product) may be taken in another order for (D, N) than for
    (N,), which moves last bits of fp32. Counters and gamma must be equal;
    particles within 1e-5 and log-evidence within 1e-4."""
    ts, obs, s0 = data
    prior, loglik, tobs = _port_problem(data, method)
    cfg = SMCConfig(n_particles=N, mutation=mutation)
    rec = RecordingDraws(TorchDraws(5, "cpu"))
    ens = run_ensemble_on_device(rec, prior, loglik, tobs, D, cfg)
    assert (ens.gamma == 1.0).all()
    assert len(set(ens.step.tolist())) > 1 or len(set(
        ens.total_lik_evals.tolist())) > 1      # schedules really differ
    for p in range(D):
        m = convert.mm_model_from_numpy(obs[p], s0, ts, _PRIOR,
                                        method=method, device="cpu")
        one = run_smc_on_device(m, cfg, PopulationReplay(rec.entries, p))
        assert float(one.gamma) == float(ens.gamma[p]) == 1.0
        if mutation == "mala":
            _assert_same_posterior(one, ens, p)
            continue
        for f in ("step", "n_mh", "accepted", "n_gamma_reductions"):
            assert int(getattr(one, f)) == int(getattr(ens, f)[p]), f
        assert float(one.total_lik_evals) == float(ens.total_lik_evals[p])
        assert float(one.mh_ratio) == float(ens.mh_ratio[p])
        np.testing.assert_allclose(one.particles.numpy(),
                                   ens.particles[p].numpy(), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(float(one.log_evidence),
                                   float(ens.log_evidence[p]), rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(float(one.ess), float(ens.ess[p]),
                                   rtol=1e-5)


def _assert_same_posterior(one, ens, p):
    """MALA's case of the test above. The likelihood's rows are the same
    bits in the batched (D N) call and the single one, but the gradient's
    are not: autograd's backward through the exact likelihood adds the
    contributions over the broadcast time and dataset axes in another order
    for the (D N) batch (about 170 of 256 rows differ in their last bits),
    a proposal near its accept margin then flips, and the population's two
    runs part like two seeds. Held as two runs of one posterior: steps
    within 2, means within half a posterior sd, log-evidence within 2.5
    (one run's spread at N = 256, tests/test_torch_smc.py)."""
    assert abs(int(one.step) - int(ens.step[p])) <= 2
    a, b = one.particles.double(), ens.particles[p].double()
    assert bool(((a.mean(0) - b.mean(0)).abs() < 0.5 * b.std(0)).all())
    assert abs(float(one.log_evidence) - float(ens.log_evidence[p])) < 2.5


def test_ensemble_matches_jax_ensemble_statistically(data):
    """D = 3, N = 256 to gamma = 1 in both packages (different random
    streams), as tests/test_synthetic_ensemble.py: every population reaches
    gamma = 1 and recovers Vmax and Km to 0.2; the two packages' posterior
    means agree within 0.6 posterior sd per population and parameter, their
    step counts within 3, and their log-evidence within 25 (at N = 256 one
    run's estimate spreads by several units; both sit near 490)."""
    ts, obs, s0 = data
    jstates = je.run_ensemble_on_device(
        jax.random.key(0), JaxPrior.uniform([0.0] * 3, [10.0] * 3),
        j_data_loglik(jnp.asarray(ts), jnp.asarray(s0)), jnp.asarray(obs), D,
        JaxConfig(n_particles=N))
    prior, loglik, tobs = _port_problem(data)
    tstates = run_ensemble_on_device(0, prior, loglik, tobs, D,
                                     SMCConfig(n_particles=N))
    jp, tp = np.asarray(jstates.particles), tstates.particles.numpy()
    assert tp.shape == (D, N, 3)
    assert (np.asarray(jstates.gamma) == 1.0).all()
    assert (tstates.gamma.numpy() == 1.0).all()
    for p in (jp, tp):
        means = p.mean(1)
        assert (np.abs(means[:, 0] - 1.2) < 0.2).all()
        assert (np.abs(means[:, 1] - 0.5) < 0.2).all()
    assert (np.abs(jp.mean(1) - tp.mean(1)) < 0.6 * jp.std(1)).all()
    assert (np.abs(np.asarray(jstates.step) - tstates.step.numpy()) <= 3
            ).all()
    assert (tstates.step.numpy() >= 3).all()
    assert (np.abs(np.asarray(jstates.log_evidence)
                   - tstates.log_evidence.numpy()) < 25.0).all()
    # a JAX ensemble state crosses through convert.py
    back = convert.ensemble_state_from_numpy(jax_state_to_numpy(jstates),
                                             device="cpu")
    assert back.particles.shape == (D, N, 3) and back.gamma.shape == (D,)
    np.testing.assert_array_equal(back.particles.numpy(), jp)


def test_fused_equals_sweep_granularity(data):
    """make_ensemble_run and run_ensemble_sweeps are one loop: the same
    state, bit for bit, from the same seed (the reference's test of this,
    tests/test_synthetic_ensemble.py, can only ask for equal gamma
    trajectories)."""
    prior, loglik, tobs = _port_problem(data, "pallas_exact")
    cfg = SMCConfig(n_particles=N)
    fused = make_ensemble_run(prior, loglik, D, cfg)(7, tobs)
    gammas = []
    swept = run_ensemble_sweeps(7, prior, loglik, tobs, D, cfg,
                                callback=lambda s: gammas.append(
                                    s.gamma.clone()))
    for f in convert.STATE_FIELDS:
        if f != "key":
            assert torch.equal(getattr(fused, f), getattr(swept, f)), f
    assert len(gammas) == int(swept.step.max())
    assert (torch.stack(gammas).diff(dim=0) >= 0).all()


def test_finished_populations_are_frozen(data):
    """Once a population is at gamma = 1 its whole state stays as it is
    while the others go on: particles, log-likelihoods, step, evidence."""
    prior, loglik, tobs = _port_problem(data)
    seen = []
    run_ensemble_sweeps(3, prior, loglik, tobs, D, SMCConfig(n_particles=N),
                        callback=seen.append)
    checked = 0
    for a, b in zip(seen[:-1], seen[1:]):
        done = a.gamma >= 1.0
        for p in torch.nonzero(done).flatten().tolist():
            for f in convert.STATE_FIELDS:
                if f != "key":
                    assert torch.equal(getattr(a, f)[p], getattr(b, f)[p]), f
            checked += 1
    assert checked > 0, "no population finished before the others"
    assert (seen[-1].gamma == 1.0).all()


def test_stop_file_before_a_step_and_mid_step(data, tmp_path, capsys):
    prior, loglik, tobs = _port_problem(data)
    cfg = SMCConfig(n_particles=N)
    stop = tmp_path / "STOP"
    stop.touch()
    s = run_ensemble_sweeps(0, prior, loglik, tobs, D, cfg,
                            stop_file=str(stop))
    assert s.step.tolist() == [0] * D and s.gamma.tolist() == [0.0] * D
    assert "returning at max step 0" in capsys.readouterr().out
    stop.unlink()

    # Mid-step: the file appears during the first sweep of step 3 (the
    # likelihood is armed by the callback that follows step 2).
    calls = {"n": 0, "arm": False}

    def counting(theta, obs):
        if calls["arm"]:
            stop.touch()
        return loglik(theta, obs)

    def after_step(states):
        calls["n"] += 1
        calls["arm"] = calls["n"] == 2      # armed for step 3's first sweep

    s = run_ensemble_sweeps(0, prior, counting, tobs, D, cfg,
                            stop_file=str(stop), callback=after_step)
    out = capsys.readouterr().out
    assert "mid-step" in out and "last completed step 2" in out
    assert s.step.tolist() == [2] * D and (s.gamma < 1.0).all()


def test_resume_from_states(data, tmp_path):
    """A run stopped after 3 ensemble steps and resumed from its states
    with the same Draws ends where the uninterrupted run ends."""
    prior, loglik, tobs = _port_problem(data, "pallas_exact")
    cfg = SMCConfig(n_particles=N)
    whole = run_ensemble_sweeps(9, prior, loglik, tobs, D, cfg)
    stop = tmp_path / "STOP"
    draws = TorchDraws(9, "cpu")
    n_steps = []

    def after_step(states):
        n_steps.append(1)
        if len(n_steps) == 3:
            stop.touch()

    part = run_ensemble_sweeps(draws, prior, loglik, tobs, D, cfg,
                               stop_file=str(stop), callback=after_step)
    assert part.step.tolist() == [3] * D
    stop.unlink()
    rest = run_ensemble_sweeps(None, prior, loglik, tobs, D, cfg,
                               states=part)
    assert torch.equal(rest.particles, whole.particles)
    assert torch.equal(rest.log_evidence, whole.log_evidence)
    assert torch.equal(rest.step, whole.step)


def test_take_datasets(data):
    """Compaction keeps each selected population's state; a single-run
    state raises instead of being sliced along its particle axis; the
    compacted ensemble runs on to gamma = 1 on its slice of the data."""
    prior, loglik, tobs = _port_problem(data, "pallas_exact")
    cfg = SMCConfig(n_particles=N)
    stop_after = []

    class Stop(Exception):
        pass

    def after_step(states):
        stop_after.append(states)
        if len(stop_after) == 4:
            raise Stop

    with pytest.raises(Stop):
        run_ensemble_sweeps(2, prior, loglik, tobs, D, cfg,
                            callback=after_step)
    states = stop_after[-1]
    for idx in ([2, 0], torch.tensor([True, False, True])):
        sub = take_datasets(states, idx)
        assert sub.particles.shape == (2, N, 3) and sub.gamma.shape == (2,)
        assert sub.key is states.key
    sub = take_datasets(states, [2, 0])
    assert torch.equal(sub.particles[0], states.particles[2])
    assert torch.equal(sub.log_evidence, states.log_evidence[[2, 0]])
    done = run_ensemble_sweeps(None, prior, loglik, tobs[[2, 0]], 2, cfg,
                               states=sub)
    assert (done.gamma == 1.0).all() and done.particles.shape == (2, N, 3)
    m = convert.mm_model_from_numpy(data[1][0], data[2], data[0], _PRIOR,
                                    method="exact", device="cpu")
    single = run_smc_on_device(m, SMCConfig(n_particles=64), 0)
    with pytest.raises(ValueError, match="ensemble state"):
        take_datasets(single, [0])


def test_mesh_raises_and_state_round_trips(data):
    """A mesh needs its processes: outside a process group ``make_mesh``
    raises, naming torchrun (the ensemble on a mesh:
    tests/test_torch_sharding_methanation.py). The state round-trips
    through its arrays."""
    from smc_tpu_torch.parallel.mesh import make_mesh
    prior, loglik, tobs = _port_problem(data)
    with pytest.raises(ValueError, match="torchrun"):
        make_mesh(2)
    s = te.init_ensemble(1, prior, loglik, tobs, D, SMCConfig(n_particles=N))
    assert s.n_particles == N and s.dim == 3
    arrays = convert.ensemble_state_to_numpy(s)
    back = convert.ensemble_state_from_numpy(arrays, device="cpu")
    for f in convert.STATE_FIELDS:
        if f != "key":
            assert torch.equal(getattr(s, f), getattr(back, f)), f
    assert torch.equal(back.key.uniform((4,)), s.key.uniform((4,)))
    single = {k: (v if k == "key" else v[0]) for k, v in arrays.items()}
    with pytest.raises(ValueError):
        convert.ensemble_state_from_numpy(single, device="cpu")

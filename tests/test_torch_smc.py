"""The port's mutation, SMC step and whole run against the JAX package on
the CPU. Decisions that depend on random numbers are compared with the JAX
draws replayed into the port (tests/torch_parity.py); whole runs, whose
streams differ, statistically."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smc_tpu import SMCConfig as JaxConfig
from smc_tpu.models.michaelis_menten import (MichaelisMentenModel as JaxMM,
                                             generate_mm_pseudo_data as jgen)
from smc_tpu.priors import Prior as JaxPrior
from smc_tpu.smc import driver as jd
from smc_tpu.smc import kernels as jk
from smc_tpu_torch import (SMCConfig, convert, make_full_run_on_device,
                           mutate, run_smc, smc_step)
from smc_tpu_torch.smc import kernels as tk
from tests.torch_parity import (ReplayDraws, assert_ll_close,
                                jax_state_to_numpy, step_draws, sweep_draws)

_PRIOR = dict(kind=[0, 0, 0], low=[0.0] * 3, high=[10.0] * 3,
              loc=[5.0] * 3, scale=[10.0] * 3)
TRUTH = (1.2, 0.5, 0.02)


@pytest.fixture(scope="module")
def models():
    ts, obs, s0 = jgen()
    jm = JaxMM(obs=jnp.asarray(obs), s0=jnp.asarray(s0), ts=jnp.asarray(ts),
               prior=JaxPrior.uniform([0.0] * 3, [10.0] * 3), method="exact")
    tm = convert.mm_model_from_numpy(obs, s0, ts, _PRIOR, method="exact",
                                     device="cpu")
    return jm, tm


def _check_posterior(p):
    """As tests/test_e2e_mm.py: truth within ~4 posterior sds, posterior
    much tighter than the prior."""
    mean, std = p.mean(0), p.std(0)
    assert abs(mean[0] - TRUTH[0]) < 4 * std[0] + 0.05
    assert abs(mean[1] - TRUTH[1]) < 4 * std[1] + 0.05
    assert abs(mean[2] - TRUTH[2]) < 4 * std[2] + 0.01
    assert std[0] < 0.3 and std[1] < 0.3 and std[2] < 0.05


def test_rwm_sweep_with_replayed_draws(models):
    """One RWM sweep from shared particles with JAX's z and u: the accept
    decisions are identical except on rows where log_acc is within 1e-4 of
    log u (counted; fp32 rounding differs there), and the particles of the
    other rows agree to 1e-5."""
    jm, tm = models
    n, d, gamma = 512, 3, 0.05
    rng = np.random.default_rng(0)
    parts = (np.asarray(TRUTH) + rng.normal(size=(n, d))
             * [0.2, 0.2, 0.01]).astype(np.float32)
    parts = np.abs(parts)
    ll = np.asarray(jm.log_likelihood(jnp.asarray(parts))[0])
    key = jax.random.key(4)
    jcfg, tcfg = JaxConfig(n_particles=n), SMCConfig(n_particles=n)
    j_init, j_sweep = jk.make_mutation_sweeper("rwm", jm.log_likelihood,
                                               jm.prior, jcfg)
    jc = jax.jit(j_sweep)(j_init(key, jnp.asarray(parts), jnp.asarray(ll)),
                          jnp.float32(gamma))
    t_init, t_draw, t_core, t_admin, _ = tk.make_mutation_parts(
        "rwm", tm.log_likelihood, tm.prior, tcfg)
    draws = ReplayDraws(sweep_draws(key, n, d, 1))
    c0 = t_init(draws, torch.from_numpy(parts), torch.tensor(ll))
    _, (chol,), (z, log_u) = t_draw(c0)
    g = torch.tensor(gamma)
    tp, tl, _, _, acc = t_core(c0.particles, c0.log_lik, c0.log_prior,
                               c0.grad, c0.mh_ratio, (chol,), (z, log_u), g)
    assert draws.used == 2
    # the margin of every decision, recomputed from the port's pieces
    prop = c0.particles + (z @ chol.T) * c0.mh_ratio
    ins = tm.prior.in_support(prop)
    pe = torch.where(ins[:, None], prop, c0.particles)
    log_acc = ((tm.log_likelihood(pe)[0] - c0.log_lik) * g
               + (tm.prior.log_pdf(pe) - c0.log_prior))
    margin = (log_acc - log_u).abs().numpy()
    j_acc = np.asarray(jc.r_ac)
    differ = acc.numpy() != j_acc
    assert (margin[differ] < 1e-4).all()
    assert differ.sum() <= max(1, (margin < 1e-4).sum())
    assert 0.05 < j_acc.mean() < 0.95
    same = ~differ
    np.testing.assert_allclose(tp.numpy()[same], np.asarray(jc.particles)[same],
                               rtol=0, atol=1e-5)
    assert_ll_close(tl.numpy()[same], np.asarray(jc.log_lik)[same],
                    tp.numpy()[same], 6, 40, 2e-5)


def test_smc_step_with_replayed_draws(models):
    """One smc_step from a JAX state converted through convert.py, with
    JAX's v0, z and u replayed: same gamma, same ancestors (bitwise), the
    same sweep count, and particles within 1e-5."""
    jm, tm = models
    n, d = 256, 3
    jcfg, tcfg = JaxConfig(n_particles=n), SMCConfig(n_particles=n)
    step = jd.make_smc_step(jm, jcfg, donate=False)
    s = jd.init_state(jax.random.key(3), jm, jcfg)
    for _ in range(3):
        s = step(s)
    s_next = step(s)

    ts = convert.state_from_numpy(jax_state_to_numpy(s), device="cpu",
                                  draws=ReplayDraws(step_draws(s.key, n, d)))
    # ancestors of this step, both sides
    jg = jk.find_gamma(s.log_lik, s.gamma, jcfg)
    _, k_res, _ = jax.random.split(s.key, 3)
    j_anc = np.asarray(jk.residual_systematic_resample(k_res, jg.weights))
    tg = tk.find_gamma(ts.log_lik, ts.gamma, tcfg)
    v0 = torch.tensor(np.asarray(jax.random.uniform(k_res, ())))
    t_anc = tk.residual_systematic_ancestors(v0, tg.weights).numpy()
    np.testing.assert_array_equal(t_anc, j_anc)

    out = smc_step(ts, tm.log_likelihood, tm.prior, tcfg)
    assert 0.0 < float(out.gamma) < 1.0
    np.testing.assert_allclose(float(out.gamma), float(s_next.gamma),
                               rtol=1e-6)
    assert int(out.step) == int(s_next.step) == 4
    assert int(out.n_gamma_reductions) == int(s_next.n_gamma_reductions)
    assert int(out.n_mh) == int(s_next.n_mh)
    assert abs(int(out.accepted) - int(s_next.accepted)) <= 2
    np.testing.assert_allclose(out.particles.numpy(),
                               np.asarray(s_next.particles), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(float(out.log_evidence),
                               float(s_next.log_evidence), rtol=1e-5)
    assert float(out.total_lik_evals) == float(s_next.total_lik_evals)


def test_whole_run_matches_jax_statistically(models):
    """N = 1024 to gamma = 1 in both packages, four seeds each (different
    random streams): both posteriors bracket the truth, their means agree
    within half a posterior sd, and the mean log-evidence estimates agree
    within three standard errors of their difference, taken from the seeds'
    own spread (about 2.5 per run at this N)."""
    jm, tm = models
    n, seeds = 1024, range(4)
    run_t = make_full_run_on_device(tm, SMCConfig(n_particles=n))
    js = [jd.run_smc_on_device(jm, JaxConfig(n_particles=n),
                               jax.random.key(s)) for s in seeds]
    ts = [run_t(s) for s in seeds]
    for a, b in zip(js, ts):
        assert float(a.gamma) == float(b.gamma) == 1.0
        jp, tp = np.asarray(a.particles), b.particles.numpy()
        _check_posterior(jp)
        _check_posterior(tp)
        assert (np.abs(jp.mean(0) - tp.mean(0)) < 0.5 * jp.std(0)).all()
        assert abs(int(a.step) - int(b.step)) <= 3
    je = np.array([float(s.log_evidence) for s in js])
    te = np.array([float(s.log_evidence) for s in ts])
    se = np.sqrt((je.var(ddof=1) + te.var(ddof=1)) / len(je))
    assert abs(je.mean() - te.mean()) < 3 * se + 0.5, (je, te)


def test_pallas_exact_run_and_metric_lines(capsys, tmp_path):
    """The main path's method (the CUDA kernel's plain version here) to
    gamma = 1 through run_smc, with the per-step metric line; a stop file
    ends the run before its first step."""
    ts, obs, s0 = jgen()
    tm = convert.mm_model_from_numpy(obs, s0, ts, _PRIOR,
                                     method="pallas_exact", device="cpu")
    cfg = SMCConfig(n_particles=512)
    s = run_smc(tm, cfg, 2)
    assert float(s.gamma) == 1.0
    _check_posterior(s.particles.numpy())
    out = capsys.readouterr().out
    assert "iteration:1, nMH:" in out and "New Gamma:1.000000" in out
    stop = tmp_path / "STOP"
    stop.touch()
    s0_ = run_smc(tm, cfg, 2, stop_file=str(stop))
    assert int(s0_.step) == 0 and float(s0_.gamma) == 0.0


def test_degenerate_covariance_rejects_instead_of_nan(models):
    """A covariance that is not positive definite gives a NaN factor, as in
    JAX, and every proposal of that sweep is rejected; N = 8 runs to the
    end without NaN."""
    bad = torch.tensor([[1.0, 2.0], [2.0, 1.0]])
    assert torch.isnan(tk._cholesky_or_nan(bad)).all()
    assert np.isnan(np.asarray(jnp.linalg.cholesky(jnp.asarray(bad.numpy())))
                    ).any()
    jm, tm = models
    n = 64
    parts = torch.full((n, 3), 1.0)
    parts[:, 1] = 0.5
    parts[:, 2] = 0.02
    ll = tm.log_likelihood(parts)[0]
    cfg = SMCConfig(n_particles=n, mh_steps=2)
    init, _, core, _, _ = tk.make_mutation_parts("rwm", tm.log_likelihood,
                                                 tm.prior, cfg)
    c0 = init(ReplayDraws(sweep_draws(jax.random.key(0), n, 3, 1)), parts, ll)
    nan_chol = torch.full((3, 3), float("nan"))
    z = torch.randn(n, 3)
    log_u = torch.log(torch.rand(n))
    p1, l1, _, _, acc = core(c0.particles, c0.log_lik, c0.log_prior,
                             c0.grad, c0.mh_ratio, (nan_chol,), (z, log_u),
                             torch.tensor(0.5))
    assert not bool(acc.any()) and torch.equal(p1, parts)
    s = make_full_run_on_device(tm, SMCConfig(n_particles=8))(0)
    assert bool(torch.isfinite(s.particles).all())


def test_unported_options_raise(models):
    """What still refuses: a gradient kind on a CUDA kernel's likelihood
    (ValueError: the kernels have no backward), the MM kernels' and the
    methanation transient march's on its default solver (the block-Thomas
    kernels). MM ``method="dopri5"`` refused until item 11 ported it; it
    builds now. The methanation likelihood refused every gradient until
    item 8; ``tests/test_torch_methanation_grad.py`` tests the ones it
    has now."""
    from smc_tpu_torch.models import methanation as TM
    from smc_tpu_torch.models.michaelis_menten import MichaelisMentenModel
    _, tm = models
    cfg = SMCConfig(n_particles=16, mutation="mala")
    x = tm.prior.sample(convert.TorchDraws(0, "cpu"), 16)
    pe = MichaelisMentenModel.default(method="pallas_exact", device="cpu")
    with pytest.raises(ValueError, match="no backward"):
        mutate(None, x, pe.log_likelihood(x)[0], torch.tensor(0.5),
               pe.log_likelihood, pe.prior, cfg)
    assert MichaelisMentenModel.default(method="dopri5",
                                        device="cpu").method == "dopri5"
    meth = convert.methanation_model_from_numpy(
        TM.condition_table_numpy(2, nx=11), np.zeros((5, 2), np.float32),
        TM.methanation_prior(device="cpu"), nx=11, device="cpu")
    xm = meth.prior.sample(convert.TorchDraws(0, "cpu"), 16)
    with pytest.raises(ValueError, match="no backward"):
        mutate(None, xm, torch.zeros(16), torch.tensor(0.5),
               meth.log_likelihood, meth.prior, cfg)


def test_log_evidence_and_posterior_match_analytic_conjugate():
    """The analytic anchor of tests/test_evidence.py, in the port: prior
    N(2, 1), likelihood exp(-theta^2): log Z = -4/3 - ln(3)/2, posterior
    N(2/3, 1/3). Per-run MC spread of log Z at N = 8192 is ~1e-2."""
    import dataclasses

    from smc_tpu_torch.priors import Prior

    @dataclasses.dataclass(frozen=True)
    class Conjugate:
        prior: Prior

        def log_likelihood(self, theta):
            return -theta[:, 0] ** 2 / (2.0 * 0.5), None

    model = Conjugate(Prior.normal([2.0], [1.0], device="cpu"))
    run = make_full_run_on_device(model, SMCConfig(n_particles=8192))
    log_z_true = -4.0 / 3.0 - 0.5 * np.log(3.0)
    vals = []
    for seed in range(3):
        s = run(seed)
        assert float(s.gamma) == 1.0
        vals.append(float(s.log_evidence))
        p = s.particles[:, 0].double().numpy()
        assert abs(p.mean() - 2 / 3) < 0.05
        assert abs(p.var() - 1 / 3) < 0.05
    vals = np.asarray(vals)
    assert np.all(np.abs(vals - log_z_true) < 0.15), vals
    assert abs(vals.mean() - log_z_true) < 0.05, vals


def test_posterior_moments_match_sequential_reference_algorithm():
    """The port against the independent sequential NumPy implementation of
    the reference algorithm (tests/oracle_smc.py) on the same data, four
    replicas each at N = 256, with the Welch-style moment tolerance of
    tests/test_posterior_parity.py."""
    from tests.oracle_smc import run_reference_smc
    from tests.test_posterior_parity import _assert_moment_parity

    ts, obs, s0 = jgen()
    ref = []
    for seed in range(4):
        p, gamma, _ = run_reference_smc(obs, s0, ts, n_particle=256,
                                        seed=seed)
        assert gamma == 1.0
        ref.append(p)
    tm = convert.mm_model_from_numpy(obs, s0, ts, _PRIOR, method="exact",
                                     device="cpu")
    run = make_full_run_on_device(tm, SMCConfig(n_particles=256))
    ours = []
    for seed in range(4):
        s = run(seed)
        assert float(s.gamma) == 1.0
        ours.append(s.particles.double().numpy())
    _assert_moment_parity(ref, ours)

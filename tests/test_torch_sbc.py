"""The port's simulation-based calibration harness (smc_tpu_torch/smc/sbc.py)
against the JAX package on the CPU: the rank statistics exactly, on the same
ranks; the Michaelis-Menten calibration run and its power check as
tests/test_sbc.py runs them; the methanation problem at its cheap default."""
import numpy as np
import pytest
import torch

from smc_tpu.smc import sbc as jsbc
from smc_tpu_torch import SMCConfig
from smc_tpu_torch.rng import TorchDraws
from smc_tpu_torch.smc import sbc as tsbc
import tests.torch_parity  # noqa: F401  (one PyTorch thread)

L = 63  # posterior rank draws per replicate, as tests/test_sbc.py


@pytest.mark.parametrize("n_rank_draws,n_bins", [(63, 8), (100, 8), (127, 8),
                                                 (3, 8), (10, 4)])
def test_rank_statistics_equal_the_jax_package(n_rank_draws, n_bins):
    """_bin_expected, rank_chi2 and rank_chi2_pvalues are NumPy and SciPy on
    both sides: the same ranks give exactly the same numbers."""
    rng = np.random.default_rng(n_rank_draws)
    ranks = rng.integers(0, n_rank_draws + 1, size=(400, 3))
    ranks[:, 1] = np.minimum(ranks[:, 1], n_rank_draws // 2)    # skewed
    for a, b in zip(jsbc._bin_expected(n_rank_draws, n_bins),
                    tsbc._bin_expected(n_rank_draws, n_bins)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tsbc.rank_chi2(ranks, n_rank_draws, n_bins),
        jsbc.rank_chi2(ranks, n_rank_draws, n_bins))
    np.testing.assert_array_equal(
        tsbc.rank_chi2_pvalues(ranks, n_rank_draws, n_bins),
        jsbc.rank_chi2_pvalues(ranks, n_rank_draws, n_bins))


def test_rank_chi2_unequal_integer_bins():
    """(L+1) not divisible by n_bins: exactly proportional counts give a
    statistic of exactly 0 (tests/test_sbc.py's case)."""
    exact_uniform = np.tile(np.arange(101), 4)[:, None]
    assert tsbc.rank_chi2(exact_uniform, 100, n_bins=8)[0] < 1e-12
    assert tsbc.rank_chi2(np.tile(np.arange(64), 4)[:, None], 63)[0] < 1e-12
    p = tsbc.rank_chi2_pvalues(
        np.random.default_rng(0).integers(0, 4, size=(400, 1)), 3, n_bins=8)
    assert 0.0 <= p[0] <= 1.0


@pytest.fixture(scope="module")
def mm_run():
    """64 replicate MM posteriors at N = 512, as tests/test_sbc.py."""
    prior, simulate, loglik, names = tsbc.mm_sbc_problem(n_datasets=3,
                                                         device="cpu")
    cfg = SMCConfig(n_particles=512)
    ranks, thetas, states = tsbc.sbc_ranks(0, prior, simulate, loglik,
                                           n_replicates=64, cfg=cfg,
                                           n_rank_draws=L)
    return prior, simulate, loglik, cfg, ranks, thetas, states, names


def test_sbc_mm_ranks_uniform(mm_run):
    """Per-dimension chi-square on the rank histogram must not reject
    uniformity (alpha = 1e-3, the reference's own limit)."""
    *_, ranks, thetas, states, names = mm_run
    assert names == ("Vmax", "Km", "sigma")
    assert ranks.shape == thetas.shape == (64, 3)
    assert ranks.min() >= 0 and ranks.max() <= L
    assert (states.gamma == 1.0).all()
    pvals = tsbc.rank_chi2_pvalues(ranks, L)
    assert (pvals > 1e-3).all(), f"SBC uniformity rejected: p={pvals}"


def test_sbc_mm_power_check(mm_run):
    """The same posteriors judged against a truth shifted by about one
    posterior sd must fail decisively: the statistic can see
    miscalibration at the scale that matters."""
    *_, cfg, _, thetas, states, _ = mm_run
    p = states.particles
    post_sd = p.std(1).mean(0).numpy()
    shifted = torch.from_numpy(thetas + post_sd[None, :])
    u = TorchDraws(7, "cpu").uniform((64, cfg.n_particles))
    idx = torch.argsort(u, dim=1)[:, :L]
    sub = p.gather(1, idx[..., None].expand(-1, -1, 3))
    bad_ranks = (sub < shifted[:, None, :]).sum(1).numpy()
    bad_p = tsbc.rank_chi2_pvalues(bad_ranks, L)
    assert (bad_p < 1e-4).all(), f"power check: shifted truth passed {bad_p}"


def test_sbc_sweep_granularity_gives_the_same_ranks(capsys):
    prior, simulate, loglik, _ = tsbc.mm_sbc_problem(
        method="pallas_exact", n_datasets=3, device="cpu")
    cfg = SMCConfig(n_particles=128)
    a = tsbc.sbc_ranks(3, prior, simulate, loglik, 8, cfg, n_rank_draws=31)
    b = tsbc.sbc_ranks(3, prior, simulate, loglik, 8, cfg, n_rank_draws=31,
                       granularity="sweep", verbose=True)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert "ensemble step: 1  gamma<1: 8/8" in capsys.readouterr().out


def test_sbc_simulator_matches_the_jax_simulator():
    """The batched simulator's noise-free trajectories against the JAX
    package's per-replicate simulator on the same truths (its noise set to
    zero by sigma = 0): 1e-5."""
    import jax
    import jax.numpy as jnp
    jprior, jsim, _, _ = jsbc.mm_sbc_problem(n_datasets=5)
    prior, sim, _, _ = tsbc.mm_sbc_problem(n_datasets=5, device="cpu")
    np.testing.assert_array_equal(np.asarray(jprior.low), prior.low.numpy())
    np.testing.assert_array_equal(np.asarray(jprior.high), prior.high.numpy())
    rng = np.random.default_rng(0)
    thetas = rng.uniform([0.5, 0.1, 0.0], [2.0, 1.5, 0.0], size=(6, 3)
                         ).astype(np.float32)
    want = jax.vmap(jsim)(jax.random.split(jax.random.key(0), 6),
                          jnp.asarray(thetas))
    got = sim(TorchDraws(0, "cpu"), torch.from_numpy(thetas))
    assert got.shape == (6, 5, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_sbc_errors():
    prior, simulate, loglik, _ = tsbc.mm_sbc_problem(n_datasets=3,
                                                     device="cpu")
    with pytest.raises(ValueError, match="n_rank_draws"):
        tsbc.sbc_ranks(0, prior, simulate, loglik, 4,
                       SMCConfig(n_particles=64), n_rank_draws=64)
    with pytest.raises(ValueError, match="granularity"):
        tsbc.sbc_ranks(0, prior, simulate, loglik, 4,
                       SMCConfig(n_particles=64), n_rank_draws=31,
                       granularity="block")
    with pytest.raises(RuntimeError, match="did not reach gamma=1"):
        tsbc.sbc_ranks(0, prior, simulate, loglik, 4,
                       SMCConfig(n_particles=64, max_steps=2),
                       n_rank_draws=31)
    with pytest.raises(ValueError, match="narrow default prior"):
        tsbc.methanation_sbc_problem(est_idx=(0, 1, 8), device="cpu")


def test_sbc_methanation_small():
    """The methanation problem at its cheap default (nx = 11, 2 conditions,
    6 steps, (Af, sigma)), R = 4 replicates x N = 64: every replicate
    reaches gamma = 1 and the ranks are finite and in range; the batched
    likelihood agrees with the model's own on each population's
    observations (to 5e-3 of a log-likelihood near -23: the march's fp32
    Newton solves are ill-conditioned, and another lane count moves their
    last bits)."""
    import dataclasses
    prior, simulate, loglik, names = tsbc.methanation_sbc_problem(
        device="cpu")
    assert names == ("Af", "sigma")
    cfg = SMCConfig(n_particles=64, mh_steps=3, mh_steps_final=5)
    ranks, thetas, states = tsbc.sbc_ranks(1, prior, simulate, loglik,
                                           n_replicates=4, cfg=cfg,
                                           n_rank_draws=L)
    assert ranks.shape == (4, 2) and np.isfinite(ranks).all()
    assert ranks.min() >= 0 and ranks.max() <= L
    assert (states.gamma == 1.0).all()
    assert bool(torch.isfinite(states.particles).all())
    assert ((thetas >= prior.low.numpy()) & (thetas <= prior.high.numpy())
            ).all()
    # the batched likelihood against the single model, population by
    # population, on fresh data
    from smc_tpu_torch.models.methanation import MethanationModel
    draws = TorchDraws(2, "cpu")
    th = prior.sample(draws, 2)
    obs = simulate(draws, th)
    theta = prior.sample(draws, (2, 8))
    got, flows = loglik(theta, obs)
    assert got.shape == (2, 8) and flows.shape == (2, 8, 5, 2)
    model = MethanationModel.default(
        n_conditions=2, nx=11, est_idx=(0, 8), particle_chunk=64,
        noise=False, device="cpu", n_steps=6, growth=1.6)
    for p in range(2):
        want = dataclasses.replace(model, obs=obs[p]).log_likelihood(theta[p])
        g, w = got[p].numpy(), want[0].numpy()
        ok = w > -1e4        # a diverged lane gives garbage far below, twice
        assert ok.sum() >= 6 and (g[~ok] < -1e4).all()
        np.testing.assert_allclose(g[ok], w[ok], rtol=1e-4, atol=5e-3)

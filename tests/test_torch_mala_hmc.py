"""Whole runs of the port's gradient mutations (MALA, HMC) on the CPU,
mirroring tests/test_mala.py and tests/test_hmc.py: the exact Gaussian
target's moments, the banana ridge against the port's RWM and,
statistically, against the JAX package's MALA run, the MM posterior with
gradients through the closed-form likelihood against the JAX package's,
HMC's evaluation accounting, and the step and sweep granularities
bit-equal (both run the same pieces). The random streams of the two
packages differ, so runs compare by their moments."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from smc_tpu import SMCConfig as JaxConfig
from smc_tpu.models.synthetic import BananaModel as JaxBanana
from smc_tpu.smc import driver as jd
from smc_tpu_torch import (SMCConfig, make_full_run_on_device, run_smc,
                           run_smc_on_device)
from smc_tpu_torch.models.synthetic import BananaModel
from smc_tpu_torch.priors import Prior
from tests.test_torch_grad import _mm_pair
from tests.test_torch_smc import _check_posterior

FIELDS = ("particles", "log_lik", "gamma", "step", "ess", "max_log_lik",
          "n_mh", "accepted", "n_gamma_reductions", "mh_ratio",
          "total_lik_evals", "log_evidence")


@dataclasses.dataclass(frozen=True)
class GaussianTarget:
    """ll(x) = -|x - mu|^2 / (2 s^2) under a uniform prior much wider than
    s: the posterior at gamma = 1 is N(mu, s^2)."""
    prior: Prior = dataclasses.field(default_factory=lambda: Prior.uniform(
        [-8.0] * 3, [8.0] * 3, device="cpu"))
    mu: tuple = (1.5, -2.0, 0.5)
    s: float = 0.3

    def log_likelihood(self, theta):
        d = theta - theta.new_tensor(self.mu)
        return -0.5 * torch.sum(d * d, dim=1) / self.s ** 2, None


@pytest.mark.parametrize("kind", ["mala", "hmc"])
def test_gradient_kind_targets_the_exact_gaussian(kind):
    """As tests/test_mala.py and tests/test_hmc.py: N = 4096 to gamma = 1,
    mean within 10 iid standard errors, sd within 15%."""
    model = GaussianTarget()
    cfg = SMCConfig(n_particles=4096, mutation=kind, hmc_leapfrog=3)
    s = make_full_run_on_device(model, cfg)(0)
    assert float(s.gamma) == 1.0
    p = s.particles.double().numpy()
    se = model.s / np.sqrt(4096)
    np.testing.assert_allclose(p.mean(0), model.mu, atol=10 * se)
    np.testing.assert_allclose(p.std(0), model.s, rtol=0.15)


@pytest.fixture(scope="module")
def jax_banana_mala():
    """The JAX package's MALA run on the banana, N = 1024."""
    s = jd.run_smc_on_device(JaxBanana(), JaxConfig(n_particles=1024,
                                                    mutation="mala"),
                             jax.random.key(3))
    return np.asarray(s.particles)


@pytest.mark.parametrize("kind", ["mala", "hmc"])
def test_banana_against_rwm_and_the_jax_mala_run(kind, jax_banana_mala):
    """The banana at N = 4096: moments agree with the port's RWM run (as
    tests/test_mala.py::test_mala_matches_rwm_on_banana) and with the JAX
    package's MALA run at N = 1024 (atol 0.3, sd rtol 0.3); the ridge
    x1 = x0^2 is resolved."""
    model = BananaModel(device="cpu")
    rwm = make_full_run_on_device(model, SMCConfig(n_particles=4096))(3)
    grad = make_full_run_on_device(model, SMCConfig(
        n_particles=4096, mutation=kind))(3)
    assert float(grad.gamma) == 1.0
    pr, pg = rwm.particles.double().numpy(), grad.particles.double().numpy()
    np.testing.assert_allclose(pg.mean(0), pr.mean(0), atol=0.25)
    np.testing.assert_allclose(pg.std(0), pr.std(0), rtol=0.3)
    pj = jax_banana_mala
    np.testing.assert_allclose(pg.mean(0), pj.mean(0), atol=0.3)
    np.testing.assert_allclose(pg.std(0), pj.std(0), rtol=0.3)
    assert abs((pg[:, 1] - pg[:, 0] ** 2).mean()) < 0.1


@pytest.fixture(scope="module")
def mm_runs():
    """The JAX package's MALA and HMC (3 leapfrog steps) runs on the MM
    exact likelihood, N = 512, and the port's model of the same data."""
    jm, tm = _mm_pair("exact")
    out = {}
    for kind in ("mala", "hmc"):
        s = jd.run_smc_on_device(jm, JaxConfig(
            n_particles=512, mutation=kind, hmc_leapfrog=3),
            jax.random.key(1))
        out[kind] = np.asarray(s.particles)
    return tm, out


@pytest.mark.parametrize("kind", ["mala", "hmc"])
def test_mm_posterior_matches_jax_statistically(kind, mm_runs):
    """MM ``exact`` at N = 512 with gradients through Lambert W, as
    tests/test_mala.py::test_mala_through_ode_integrator: gamma = 1, no
    NaN, the posterior brackets the truth; the means agree with the JAX
    package's run of the same kind within half a posterior sd plus 0.005
    (different random streams)."""
    tm, jax_runs = mm_runs
    s = run_smc_on_device(tm, SMCConfig(n_particles=512, mutation=kind,
                                        hmc_leapfrog=3), 1)
    assert float(s.gamma) == 1.0
    p = s.particles.double().numpy()
    assert not np.isnan(p).any()
    truth = np.asarray([1.2, 0.5, 0.02])
    assert np.all(np.abs(p.mean(0) - truth) < 5 * p.std(0) + 0.02)
    _check_posterior(p)
    pj = jax_runs[kind]
    assert (np.abs(p.mean(0) - pj.mean(0)) < 0.5 * pj.std(0) + 0.005).all()


def test_hmc_eval_accounting():
    """tests/test_hmc.py::test_hmc_eval_accounting: total_lik_evals counts
    hmc_leapfrog evaluations per sweep, one for rwm and mala."""
    assert SMCConfig(mutation="hmc", hmc_leapfrog=4).evals_per_sweep == 4
    assert SMCConfig(mutation="rwm").evals_per_sweep == 1
    assert SMCConfig(mutation="mala").evals_per_sweep == 1
    n = 256
    cfg = SMCConfig(n_particles=n, mutation="hmc", hmc_leapfrog=4,
                    max_steps=3)
    s = run_smc(GaussianTarget(), cfg, 2, verbose=False)
    sweeps_counted = (float(s.total_lik_evals) - n) / n
    assert sweeps_counted % 4 == 0 and sweeps_counted >= 4
    assert int(s.step) == 3


@pytest.mark.parametrize("kind", ["mala", "hmc"])
def test_sweep_granularity_equals_step(kind):
    """Both granularities run the same pieces: the same state, bit for
    bit (the JAX package pins statistical parity for its separately
    compiled programs, tests/test_sweep_granularity.py)."""
    _, tm = _mm_pair("exact")
    cfg = SMCConfig(n_particles=256, mutation=kind, hmc_leapfrog=2)
    a = run_smc(tm, cfg, 4, verbose=False, granularity="step")
    b = run_smc(tm, cfg, 4, verbose=False, granularity="sweep")
    assert float(a.gamma) == 1.0
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f

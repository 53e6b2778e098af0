"""The port's synthetic targets (banana, Gaussian mixture) against the JAX
package's on the CPU: their log-likelihoods and the mixture's mode
fractions on the same points, and the counterparts of
tests/test_synthetic_ensemble.py's banana ridge and mode coverage runs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smc_tpu.models.synthetic import GaussianMixtureModel as JaxGMM
from smc_tpu_torch import SMCConfig, make_full_run_on_device
from smc_tpu_torch.models.synthetic import BananaModel, GaussianMixtureModel
from tests.test_torch_grad import _pair


@pytest.mark.parametrize("case", ["banana", "gmm"])
def test_log_likelihood_matches_jax(case):
    """1e-6 relative on 4096 points over the prior's box (the mixture's
    logsumexp far from every mode included)."""
    jm, tm = _pair(case)
    rng = np.random.default_rng(3)
    lo = np.asarray(tm.prior.low)
    hi = np.asarray(tm.prior.high)
    th = rng.uniform(lo, hi, size=(4096, lo.shape[0])).astype(np.float32)
    jl = np.asarray(jm.log_likelihood(jnp.asarray(th))[0])
    tl = tm.log_likelihood(torch.from_numpy(th))[0].numpy()
    np.testing.assert_allclose(tl, jl, rtol=1e-6, atol=1e-6)


def test_mode_fractions_match_jax():
    jm, tm = _pair("gmm")
    rng = np.random.default_rng(4)
    th = (np.asarray(jm.means)[rng.integers(0, 4, 2048)]
          + rng.normal(size=(2048, 2)) * 3.0).astype(np.float32)
    np.testing.assert_allclose(
        tm.mode_fractions(torch.from_numpy(th)).numpy(),
        np.asarray(jm.mode_fractions(jnp.asarray(th))), rtol=1e-6)
    d = GaussianMixtureModel.default(device="cpu")
    np.testing.assert_array_equal(d.means.numpy(),
                                  np.asarray(JaxGMM.default().means))


def test_banana_posterior_on_ridge():
    """tests/test_synthetic_ensemble.py::test_banana_posterior_on_ridge at
    N = 2048."""
    s = make_full_run_on_device(BananaModel(device="cpu"),
                                SMCConfig(n_particles=2048))(0)
    assert float(s.gamma) == 1.0
    p = s.particles.double().numpy()
    assert np.median(np.abs(p[:, 1] - p[:, 0] ** 2)) < 0.3
    assert abs(p[:, 0].mean() - 1.0) < 0.5


@pytest.mark.parametrize("kind", ["rwm", "mala"])
def test_gmm_mode_coverage(kind):
    """tests/test_synthetic_ensemble.py::test_gmm_mode_coverage at N = 2048:
    every one of the 4 separated modes keeps more than 8% of the particles
    (ideal 25%), and the particles sit on modes."""
    model = GaussianMixtureModel.default(k=4, d=2, sep=8.0, std=0.5,
                                         device="cpu")
    s = make_full_run_on_device(model, SMCConfig(n_particles=2048,
                                                 mutation=kind))(1)
    assert float(s.gamma) == 1.0
    frac = model.mode_fractions(s.particles).numpy()
    assert (frac > 0.08).all(), frac
    assert float(torch.median(model.log_likelihood(s.particles)[0])) > -5.0

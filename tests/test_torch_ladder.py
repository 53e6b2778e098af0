"""The port's gamma ladder and gamma search against the JAX package on the
CPU: the plain version of the CUDA ladder kernel against the Pallas kernel
in interpret mode, and find_gamma's decisions on shared log-likelihoods."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smc_tpu import SMCConfig as JaxConfig
from smc_tpu.ops.ladder_pallas import ladder_stats as j_ladder
from smc_tpu.smc.kernels import find_gamma as j_find_gamma
from smc_tpu_torch import SMCConfig, find_gamma
from smc_tpu_torch.ops.ladder_cuda import ladder_stats, ladder_stats_plain
import tests.torch_parity  # noqa: F401  (one PyTorch thread)


@pytest.mark.parametrize("n", [9000, 333])
def test_plain_ladder_matches_pallas_interpret(n):
    """K = 81, -inf failure sentinels, N not a multiple of the kernel tile;
    rtol 2e-5 (fp32 sums taken in different orders)."""
    rng = np.random.default_rng(n)
    d_ll = -np.abs(rng.normal(size=n)).astype(np.float32) * 5.0
    d_ll[::97] = -np.inf
    d_ll[7] = 0.0
    dg = (0.3 * 0.7 ** np.arange(81)).astype(np.float32)
    j1, j2 = j_ladder(jnp.asarray(d_ll), jnp.asarray(dg), interpret=True)
    t1, t2 = ladder_stats(torch.from_numpy(d_ll), torch.from_numpy(dg))
    np.testing.assert_allclose(t1.numpy(), np.asarray(j1), rtol=2e-5)
    np.testing.assert_allclose(t2.numpy(), np.asarray(j2), rtol=2e-5)
    w = np.exp(d_ll[None, :].astype(np.float64) * dg[:, None])
    np.testing.assert_allclose(t1.numpy(), w.sum(1), rtol=2e-5)
    np.testing.assert_allclose(t2.numpy(), (w * w).sum(1), rtol=2e-5)
    p1, _ = ladder_stats_plain(torch.from_numpy(d_ll), torch.from_numpy(dg))
    assert torch.equal(p1, t1)


def _compare(log_lik, gamma_old, **cfg_kw):
    jg = j_find_gamma(jnp.asarray(log_lik), jnp.float32(gamma_old),
                      JaxConfig(n_particles=len(log_lik), **cfg_kw))
    tg = find_gamma(torch.from_numpy(log_lik),
                    torch.tensor(gamma_old, dtype=torch.float32),
                    SMCConfig(n_particles=len(log_lik), **cfg_kw))
    assert int(tg.n_reductions) == int(jg.n_reductions)
    assert tg.n_reductions.dtype == torch.int32
    np.testing.assert_allclose(float(tg.gamma), float(jg.gamma), rtol=1e-6)
    np.testing.assert_allclose(float(tg.ess), float(jg.ess), rtol=1e-5)
    assert float(tg.max_log_lik) == float(jg.max_log_lik)
    np.testing.assert_allclose(tg.weights.numpy(), np.asarray(jg.weights),
                               rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(float(tg.log_z_inc), float(jg.log_z_inc),
                               rtol=1e-5, atol=1e-5)
    return tg


@pytest.mark.parametrize("gamma_old", [0.0, 0.13, 0.9])
def test_find_gamma_matches_jax(gamma_old):
    """Same candidate index, gamma, ESS, weights and evidence increment
    (JAX on the CPU takes its fused (K, N) branch: the same sums in
    another order)."""
    rng = np.random.default_rng(int(gamma_old * 100))
    log_lik = rng.normal(-50, 30, size=512).astype(np.float32)
    log_lik[::50] = -np.inf
    tg = _compare(log_lik, gamma_old)
    assert 0 < int(tg.n_reductions) < 80


def test_find_gamma_full_step_when_flat():
    tg = _compare(np.zeros(64, np.float32), 0.0)
    assert float(tg.gamma) == 1.0 and int(tg.n_reductions) == 0


def test_find_gamma_when_no_candidate_passes():
    """One particle carries all the weight at every candidate: ESS = 1/N
    everywhere, so the last (smallest) candidate is taken. (From gamma_old
    = 0 every increment stays > 0 in fp32; from gamma_old > 0 the smallest
    ones round to 0, which gives ESS = 1 in both packages.)"""
    log_lik = np.full(256, -1e30, np.float32)
    log_lik[17] = 0.0
    tg = _compare(log_lik, 0.0)
    assert int(tg.n_reductions) == 80
    assert float(tg.ess) < 0.5

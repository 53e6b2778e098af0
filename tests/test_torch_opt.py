"""The port's multi-start MAP estimation against the JAX package on the CPU:
its Adam and cosine schedule (tensor ops, so a step can be captured as a
CUDA graph) against optax on one gradient sequence, and ``map_estimate`` on
the MM exact likelihood from the same starts as the JAX package's, with
tests/test_opt.py's thresholds."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from smc_tpu import map_estimate as jax_map_estimate
from smc_tpu.models.michaelis_menten import MichaelisMentenModel as JaxMM
from smc_tpu.priors import Prior as JaxPrior
from smc_tpu_torch import MAPResult, convert, map_estimate
from smc_tpu_torch.models.michaelis_menten import MichaelisMentenModel
from smc_tpu_torch.opt import adam_init, adam_update, cosine_decay
from tests.test_torch_grad import _mm_pair
from tests.torch_parity import ReplayDraws, prior_draws


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_adam_matches_optax(schedule):
    """50 updates of (8, 3) parameters from one gradient sequence (scaled
    like the MAP's): the iterates within rtol 1e-6 of optax's adam with
    cosine_decay_schedule(0.1, 40, alpha=0.01) (past its end too) or a
    constant rate 0.002."""
    rng = np.random.default_rng(0)
    z0 = rng.normal(size=(8, 3)).astype(np.float32)
    grads = (rng.normal(size=(50, 8, 3))
             * np.logspace(-3, 2, 50)[:, None, None]).astype(np.float32)
    if schedule == "cosine":
        opt = optax.adam(optax.cosine_decay_schedule(0.1, 40, alpha=0.01))
    else:
        opt = optax.adam(0.002)
    z = jnp.asarray(z0)
    st = opt.init(z)
    tz = torch.from_numpy(z0)
    tst = adam_init(tz)
    for g in grads:
        up, st = opt.update(jnp.asarray(g), st, z)
        z = optax.apply_updates(z, up)
        rate = (cosine_decay(0.1, 40, tst.count) if schedule == "cosine"
                else 0.002)
        tup, tst = adam_update(torch.from_numpy(g), tst, rate)
        tz = tz + tup
        np.testing.assert_allclose(tz.numpy(), np.asarray(z), rtol=1e-6,
                                   atol=1e-7)
    assert float(tst.count) == 50.0


@pytest.fixture(scope="module")
def maps():
    """The JAX package's MAP (key 0, 8 starts, 800 steps) on the MM exact
    likelihood and the port's from the same prior draws."""
    jm, tm = _mm_pair("exact")
    key = jax.random.key(0)
    jr = jax_map_estimate(jm, key, n_starts=8)
    tr = map_estimate(tm, ReplayDraws(prior_draws(key, 8, 3)), n_starts=8)
    return jm, tm, jr, tr


def test_map_recovers_mm_truth(maps):
    """tests/test_opt.py::test_map_recovers_mm_truth's thresholds: Vmax and
    Km within 0.05 of the truth, sigma within 0.01, a log-posterior at
    least the truth's, every start finite."""
    _, tm, _, tr = maps
    th = tr.theta.numpy()
    assert abs(th[0] - 1.2) < 0.05
    assert abs(th[1] - 0.5) < 0.05
    assert abs(th[2] - 0.02) < 0.01
    truth = torch.tensor([[1.2, 0.5, 0.02]])
    lp_t = tm.log_likelihood(truth)[0] + tm.prior.log_pdf(truth)
    assert float(tr.log_post) >= float(lp_t[0]) - 1e-3
    assert bool(torch.isfinite(tr.all_log_post).all())


def test_map_matches_jax_from_the_same_starts(maps):
    """Every start's final theta within 0.02 of the JAX package's and its
    log-posterior within 0.05; the same best start; the result round-trips
    through convert.py."""
    _, _, jr, tr = maps
    np.testing.assert_allclose(tr.all_theta.numpy(),
                               np.asarray(jr.all_theta), rtol=0, atol=0.02)
    np.testing.assert_allclose(tr.all_log_post.numpy(),
                               np.asarray(jr.all_log_post), rtol=0,
                               atol=0.05)
    np.testing.assert_allclose(tr.theta.numpy(), np.asarray(jr.theta),
                               rtol=0, atol=0.02)
    back = convert.map_result_from_numpy(
        {k: np.asarray(v) for k, v in jr._asdict().items()}, device="cpu")
    assert isinstance(back, MAPResult)
    np.testing.assert_array_equal(back.all_theta.numpy(),
                                  np.asarray(jr.all_theta))
    again = convert.map_result_from_numpy(convert.map_result_to_numpy(tr),
                                          device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(again, tr))


class _CpuDraws:
    """Uniform, then normal draws from one seeded CPU generator (the starts
    chip_smoke.py's MAP phase gives the card and the CPU)."""

    def __init__(self, seed):
        self.gen = torch.Generator().manual_seed(seed)

    def uniform(self, shape, dtype=None):
        return torch.rand(shape, generator=self.gen)

    def normal(self, shape, dtype=None):
        return torch.randn(shape, generator=self.gen)


class _FixedStarts:
    """A JAX prior whose ``sample`` returns given starts."""

    def __init__(self, prior, starts):
        self._prior, self._starts = prior, starts

    def __getattr__(self, name):
        return getattr(self._prior, name)

    def sample(self, key, n, dtype=jnp.float32):
        assert n == len(self._starts)
        return jnp.asarray(self._starts, dtype)


def _near_truth(th):
    return (abs(th[0] - 1.2) < 0.05 and abs(th[1] - 0.5) < 0.05
            and abs(th[2] - 0.02) < 0.01)


def test_map_from_generator_starts_matches_jax():
    """From the starts of seeds 0 and 1 of a CPU generator on the port's
    default pseudo-data (chip_smoke.py's first MAP seeds, whose best starts
    miss the truth), the JAX package's MAP on the same data ends where the
    port's does, start by start: theta within 0.02 and log-posterior within
    1e-3 relative (a start still crossing the flat region far from the fit
    moves most), the same best start per seed, near the truth or in the
    same local mode. Both seeds' 8 starts go through one JAX call (the
    starts are independent rows)."""
    tm = MichaelisMentenModel.default(method="exact", device="cpu")
    jm = JaxMM(obs=jnp.asarray(tm.obs.numpy()), s0=jnp.asarray(
        tm.s0.numpy()), ts=jnp.asarray(tm.ts.numpy()),
        prior=JaxPrior.uniform([0.0] * 3, [10.0] * 3), method="exact")
    seeds = (0, 1)
    ours = [map_estimate(tm, _CpuDraws(s), n_starts=8) for s in seeds]
    starts = np.concatenate([tm.prior.sample(_CpuDraws(s), 8).numpy()
                             for s in seeds])
    fixed = types.SimpleNamespace(prior=_FixedStarts(jm.prior, starts),
                                  log_likelihood=jm.log_likelihood)
    jr = jax_map_estimate(fixed, jax.random.key(0), n_starts=len(starts))
    j_theta = np.asarray(jr.all_theta).reshape(len(seeds), 8, 3)
    j_lp = np.asarray(jr.all_log_post).reshape(len(seeds), 8)
    for tr, jt, jl in zip(ours, j_theta, j_lp):
        np.testing.assert_allclose(tr.all_theta.numpy(), jt, rtol=0,
                                   atol=0.02)
        np.testing.assert_allclose(tr.all_log_post.numpy(), jl, rtol=1e-3)
        best = int(np.argmax(jl))
        assert int(torch.argmax(tr.all_log_post)) == best
        assert _near_truth(tr.theta.numpy()) == _near_truth(jt[best])


def test_map_refuses_the_kernels():
    """MAP needs a likelihood autograd differentiates: on pallas_exact it
    raises ValueError, as the gradient mutations do."""
    _, tm = _mm_pair("pallas_exact")
    with pytest.raises(ValueError, match="no backward"):
        map_estimate(tm, 0, n_starts=2, steps=2)

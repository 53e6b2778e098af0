"""The port's resampling against the JAX package on the CPU, bitwise: the
plain version of the CUDA ancestor-merge kernel against the Pallas merge in
interpret mode, residual-systematic counts and offsets with the same
systematic offset v0, and the resampled particles against ``take``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smc_tpu.ops.resample_pallas import (_T, _W,
                                         sorted_offsets_to_ancestors as j_merge)
from smc_tpu.smc import kernels as jk
from smc_tpu_torch.ops.resample_cuda import (
    sorted_offsets_to_ancestors, sorted_offsets_to_ancestors_plain)
from smc_tpu_torch.smc import kernels as tk


def _offsets(counts):
    counts = np.asarray(counts, np.int64)
    return (np.cumsum(counts) - counts).astype(np.int32)


def _assert_merge_equal(offsets):
    want = np.asarray(j_merge(jnp.asarray(offsets), interpret=True))
    got = sorted_offsets_to_ancestors(torch.from_numpy(offsets))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # and the scatter construction itself
    n = len(offsets)
    hist = np.bincount(offsets, minlength=n + 1)[:n]
    np.testing.assert_array_equal(got.numpy(), np.cumsum(hist) - 1)


@pytest.mark.parametrize("n", [257, _W, 5000, 3 * _T + 17])
def test_plain_merge_matches_pallas_on_random_counts(n):
    rng = np.random.default_rng(n)
    raw = rng.integers(0, 4, n) * (rng.random(n) < 0.4)
    raw[0] += n - raw.sum()
    assert raw.sum() == n and (raw >= 0).all()
    _assert_merge_equal(_offsets(raw))


@pytest.mark.parametrize("case", ["first_takes_all", "last_takes_all",
                                  "all_ones", "middle_block",
                                  "two_survivors_far_apart",
                                  "alternating_zero"])
def test_plain_merge_degenerate_patterns(case):
    n = 2 * _T + 100
    counts = np.zeros(n, np.int64)
    if case == "first_takes_all":
        counts[0] = n
    elif case == "last_takes_all":
        counts[-1] = n
    elif case == "all_ones":
        counts[:] = 1
    elif case == "middle_block":
        counts[n // 2] = n
    elif case == "two_survivors_far_apart":
        counts[3] = n // 2
        counts[-3] = n - n // 2
    else:
        counts[::2] = 2
    assert counts.sum() == n
    _assert_merge_equal(_offsets(counts))


def _weights(n, seed, kind):
    rng = np.random.default_rng(seed)
    w = rng.gamma(0.2, size=n).astype(np.float32)
    if kind == "dominant":
        w[7] = 1e6
    elif kind == "half_zero":
        w[: n // 2] = 0.0
    elif kind == "flat":
        w[:] = 1.0
    return (w / w.sum()).astype(np.float32)


@pytest.mark.parametrize("n,kind", [(16, "gamma"), (1000, "gamma"),
                                    (1024, "dominant"), (1024, "half_zero"),
                                    (4096 + 333, "flat"),
                                    (200_003, "gamma")])
def test_counts_and_offsets_bitwise(n, kind):
    """The int64 prefix sum against the JAX package's chunked int32 one,
    with v0 drawn from the same key (n = 200,003 makes JAX split q into two
    chunks)."""
    w = _weights(n, n, kind)
    for seed in range(3):
        key = jax.random.key(seed)
        jc, jo = jk._rs_counts_offsets(key, jnp.asarray(w))
        v0 = torch.tensor(np.asarray(jax.random.uniform(key, ())))
        tc, to = tk._rs_counts_offsets(v0, torch.from_numpy(w))
        assert tc.dtype == to.dtype == torch.int32
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        assert int(tc.sum()) == n and int(tc.min()) >= 0


def test_apply_is_bitwise_take():
    """residual_systematic_apply against jnp.take with the JAX ancestors,
    -inf log-liks and adversarial weights included."""
    for seed, kind in enumerate(["gamma", "dominant", "half_zero"]):
        n = 1024
        w = _weights(n, 40 + seed, kind)
        rng = np.random.default_rng(seed)
        parts = rng.normal(size=(n, 3)).astype(np.float32)
        lk = (rng.normal(size=n) * 100).astype(np.float32)
        lk[3] = -np.inf
        key = jax.random.key(seed)
        anc = jk.residual_systematic_resample(key, jnp.asarray(w))
        v0 = torch.tensor(np.asarray(jax.random.uniform(key, ())))
        tp, tl = tk.residual_systematic_apply(
            v0, torch.from_numpy(w), torch.from_numpy(parts),
            torch.from_numpy(lk))
        np.testing.assert_array_equal(
            tp.numpy(), np.asarray(jnp.take(jnp.asarray(parts), anc, 0)))
        np.testing.assert_array_equal(
            tl.numpy(), np.asarray(jnp.take(jnp.asarray(lk), anc, 0)))
        np.testing.assert_array_equal(
            tk.residual_systematic_ancestors(v0, torch.from_numpy(w)).numpy(),
            np.asarray(anc))


def test_counts_to_ancestors_matches_jax():
    counts = np.array([0, 3, 1, 0, 2, 0], np.int32)
    np.testing.assert_array_equal(
        tk.counts_to_ancestors(torch.from_numpy(counts)).numpy(),
        [1, 1, 1, 2, 4, 4])
    rng = np.random.default_rng(2)
    c = rng.multinomial(500, np.ones(500) / 500).astype(np.int32)
    np.testing.assert_array_equal(
        tk.counts_to_ancestors(torch.from_numpy(c)).numpy(),
        np.asarray(jk.counts_to_ancestors(jnp.asarray(c))))
    assert torch.equal(
        sorted_offsets_to_ancestors_plain(torch.from_numpy(_offsets(c))),
        tk.counts_to_ancestors(torch.from_numpy(c)))

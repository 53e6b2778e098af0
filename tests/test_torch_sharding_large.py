"""Large-N exactness of the port's cross-rank resamplers, the counterpart
of ``tests/test_sharding_large.py``: on a gloo world of four CPU ranks the
sharded counts are bitwise the JAX package's ``residual_systematic_counts``
past the fp32 cliff at 2^24 and at off-grid sizes, and the ring resampler
bitwise its ancestors' particles at 2^24. One world runs every case; the
arrays go through .npy files in the test's directory."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from smc_tpu.smc.kernels import (residual_systematic_counts,
                                 residual_systematic_resample)
from tests.torch_mesh import large_cases, run_world

RANKS = 4
BIG = 1 << 24
OFF_GRID = ((8 * 1201, 0), (8 * 999_983 // 8 * 8, 1))


def _write(out, name, key, w, parts=None):
    np.save(os.path.join(out, name + "_w.npy"), np.asarray(w))
    np.save(os.path.join(out, name + "_v0.npy"),
            np.asarray(jax.random.uniform(key, ())))
    if parts is not None:
        np.save(os.path.join(out, name + "_parts.npy"), np.asarray(parts))


def _got(out, name):
    return np.concatenate([np.load(os.path.join(out, f"{name}_r{r}.npy"))
                           for r in range(RANKS)])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sharding_large"))
    want, cases = {}, []
    key = jax.random.key(123)
    w = jax.nn.softmax(jax.random.normal(jax.random.key(9), (BIG,),
                                         jnp.float32) * 3.0)
    _write(out, "big", key, w)
    want["big"] = np.asarray(jax.jit(residual_systematic_counts)(key, w))
    cases.append(("big", "counts"))

    key = jax.random.key(77)
    w = jax.nn.softmax(jax.random.normal(jax.random.key(5), (BIG,),
                                         jnp.float32) * 4.0)
    parts = jax.random.normal(jax.random.key(6), (BIG, 1))
    _write(out, "ring", key, w, parts)
    anc = np.asarray(jax.jit(residual_systematic_resample)(key, w))
    want["ring"] = np.asarray(parts)[anc]
    cases.append(("ring", "ring"))
    del w, parts, anc

    for n, wkey in OFF_GRID:
        key = jax.random.key(n)
        w = jnp.full((n,), 1.0 / n, jnp.float32)
        if wkey:
            w = jax.nn.softmax(jax.random.normal(jax.random.key(wkey),
                                                 (n,)) * 5.0)
        _write(out, f"off{n}", key, w)
        want[f"off{n}"] = np.asarray(residual_systematic_counts(key, w))
        cases.append((f"off{n}", "counts_fn"))
    run_world(out, RANKS, large_cases, cases)
    return out, want


def test_sharded_counts_bitwise_match_at_2e24(world):
    out, want = world
    got = _got(out, "big")
    assert int(got.sum()) == BIG == int(want["big"].sum())
    np.testing.assert_array_equal(got, want["big"])


def test_ring_resampler_bitwise_match_at_2e24(world):
    """The ring's slot arithmetic (rank * rows + iota, searchsorted over
    int32 slot starts) stays exact at 2^24; d = 1."""
    out, want = world
    np.testing.assert_array_equal(_got(out, "ring"), want["ring"])


def test_sharded_counts_bitwise_match_offgrid_sizes(world):
    """Sizes off the power-of-two grid, and uniform weights (every residual
    the same: the most carries in the prefix sum)."""
    out, want = world
    for n, _ in OFF_GRID:
        got = _got(out, f"off{n}")
        np.testing.assert_array_equal(got, want[f"off{n}"])
        assert int(got.sum()) == n

"""The port's native runtime (``smc_tpu_torch/runtime``) against the JAX
package's: the same C++ source byte for byte, the same SMCK container from
both writers in both directions, and the sequential residual-systematic
oracle against the port's resampling counts.

Tolerances: the containers and the counts are compared bit for bit; the
vectorized counts may differ from the sequential oracle by one slot at a
boundary tie, as the JAX package's test allows (at most 1 per slot, at
most 4 slots).
"""
import numpy as np
import pytest
import torch

import tests.torch_parity  # noqa: F401  (one PyTorch thread per worker)
from smc_tpu import runtime as JR
from smc_tpu_torch import runtime as TR
from smc_tpu_torch.smc.kernels import residual_systematic_counts


def _arrays(rng, i=0):
    return {
        "particles": rng.normal(size=(1000, 5)).astype(np.float32) + i,
        "log_lik": rng.normal(size=(1000,)).astype(np.float32),
        "gamma": np.asarray(0.37, np.float32),
        "step": np.asarray(4, np.int32),
        "evals": np.asarray(12.5, np.float64),
        "offsets": np.arange(7, dtype=np.int64),
        "key": rng.integers(0, 2**32, size=(6,), dtype=np.uint32),
    }


def _same(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])


def test_runtime_source_is_a_copy():
    assert TR.SOURCE.read_bytes() == open(
        JR._SRC, "rb").read(), "smc_runtime.cc differs between the packages"


def test_native_library_builds_into_build_dir():
    assert TR.native_available(), "g++ build of smc_runtime.cc failed"
    path = TR.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.name.startswith("libsmc_runtime_")


def test_async_checkpoint_roundtrip_both_packages(tmp_path):
    """Snapshots from the port's native writer read back by both packages'
    readers, and the JAX writer's by the port's, bit for bit."""
    rng = np.random.default_rng(0)
    snaps = [_arrays(rng, i) for i in range(6)]
    with TR.AsyncCheckpointer() as ck:
        assert ck.is_native
        for i, s in enumerate(snaps):
            ck.submit(str(tmp_path / f"t{i}.smck"), s)
        ck.flush()
        assert ck.stats() == {"written": 6, "errors": 0, "native": True}
    with JR.AsyncCheckpointer() as ck:
        ck.submit(str(tmp_path / "j.smck"), snaps[2])
        ck.flush()
    for i, s in enumerate(snaps):
        _same(TR.load_snapshot(str(tmp_path / f"t{i}.smck")), s)
        _same(JR.load_snapshot(str(tmp_path / f"t{i}.smck")), s)
    _same(TR.load_snapshot(str(tmp_path / "j.smck")), snaps[2])


def test_python_writer_same_container(tmp_path):
    """Without the native library the port writes the same bytes as both
    packages' writers (a 0-d array keeps its shape; another dtype is
    stored as float32, as in the JAX package)."""
    rng = np.random.default_rng(1)
    arrays = _arrays(rng)
    arrays["half"] = np.ones((3,), np.float16)
    TR.save_snapshot_py(str(tmp_path / "py.smck"), arrays)
    JR.save_snapshot_py(str(tmp_path / "jx.smck"), arrays)
    with TR.AsyncCheckpointer() as ck:
        ck.submit(str(tmp_path / "nat.smck"), arrays)
        ck.flush()
    raw = (tmp_path / "py.smck").read_bytes()
    assert raw == (tmp_path / "jx.smck").read_bytes()
    assert raw == (tmp_path / "nat.smck").read_bytes()
    back = TR.load_snapshot(str(tmp_path / "py.smck"))
    assert back["gamma"].shape == () and back["half"].dtype == np.float32


def test_checkpointer_without_the_library_falls_back(tmp_path, monkeypatch):
    """No compiler: the pure-Python writer runs, and stats() says so."""
    monkeypatch.setattr(TR, "load_library", lambda: None)
    arrays = _arrays(np.random.default_rng(2))
    with TR.AsyncCheckpointer() as ck:
        assert not ck.is_native
        ck.submit(str(tmp_path / "fb.smck"), arrays)
        assert ck.stats() == {"written": None, "errors": None,
                              "native": False}
    _same(JR.load_snapshot(str(tmp_path / "fb.smck")), arrays)
    with pytest.raises(RuntimeError, match="closed"):
        ck.submit(str(tmp_path / "late.smck"), arrays)


@pytest.mark.parametrize("n", [64, 1000, 5000])
def test_oracle_matches_port_counts(n):
    """The port's vectorized residual-systematic counts == the native
    sequential Algorithm 2 for the same offset (up to a boundary tie), and
    the native oracle == its Python fallback."""
    rng = np.random.default_rng(5 + n)
    w = rng.dirichlet(np.ones(n) * 0.5).astype(np.float32)
    v0 = float(rng.uniform())
    ours = residual_systematic_counts(torch.tensor(v0),
                                      torch.from_numpy(w)).numpy()
    oracle = TR.residual_systematic_oracle(w, v0)
    assert ours.sum() == n == oracle.sum()
    diff = np.abs(ours - oracle)
    assert diff.max() <= 1 and (diff > 0).sum() <= 4
    np.testing.assert_array_equal(oracle, JR.residual_systematic_oracle(w, v0))


def test_oracle_python_fallback_equals_native(monkeypatch):
    rng = np.random.default_rng(9)
    w = rng.dirichlet(np.ones(300))
    native = TR.residual_systematic_oracle(w, 0.25)
    monkeypatch.setattr(TR, "load_library", lambda: None)
    np.testing.assert_array_equal(TR.residual_systematic_oracle(w, 0.25),
                                  native)

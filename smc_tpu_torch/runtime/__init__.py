"""Native host runtime bindings (PyTorch port of ``smc_tpu.runtime``):
ctypes over ``smc_runtime.cc``, a byte-for-byte copy of the JAX package's
source, so both packages write the same ``.smck`` container.

The library is built with g++ at first use into ``smc_tpu_torch/_build/``
(listed in ``.gitignore``), named by a hash of the source and flags as the
CUDA library is (``ops/_build.py``): a changed source gives a new name and
so a rebuild. Nothing here runs at import. Without a compiler everything
falls back to pure Python: this is host I/O and a test oracle, not a
device kernel, and ``AsyncCheckpointer.stats()["native"]`` says which
writer ran.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "smc_runtime.cc"
BUILD_DIR = _HERE.parent / "_build"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False

_DTYPE_CODES = {
    np.dtype(np.float32): 0,
    np.dtype(np.float64): 1,
    np.dtype(np.int32): 2,
    np.dtype(np.int64): 3,
    np.dtype(np.uint32): 4,
}
_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libsmc_runtime_{h.hexdigest()[:16]}.so"


def _build(lib: Path) -> bool:
    """Compile to a private name, then rename: concurrent builders (test
    workers) each finish with a whole library in place."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{lib.stem}.{os.getpid()}.so"
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, lib)
    return True


def load_library() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native runtime; None if unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        path = library_path()
        if not path.exists() and not _build(path):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _build_failed = True
            return None
        lib.ckpt_writer_open.restype = ctypes.c_void_p
        lib.ckpt_begin.restype = ctypes.c_void_p
        lib.ckpt_begin.argtypes = [ctypes.c_char_p]
        lib.ckpt_add_array.restype = ctypes.c_int
        lib.ckpt_add_array.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p]
        lib.ckpt_submit.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.ckpt_writer_flush.argtypes = [ctypes.c_void_p]
        lib.ckpt_writer_errors.argtypes = [ctypes.c_void_p]
        lib.ckpt_writer_errors.restype = ctypes.c_int64
        lib.ckpt_writer_written.argtypes = [ctypes.c_void_p]
        lib.ckpt_writer_written.restype = ctypes.c_int64
        lib.ckpt_writer_close.argtypes = [ctypes.c_void_p]
        lib.residual_systematic_cpp.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_double,
            ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
        return _lib


def native_available() -> bool:
    return load_library() is not None


def _container_array(arr):
    """``arr`` as a C-contiguous array of a container dtype (others are
    cast to float32, as the JAX package does) and its dtype code."""
    # ascontiguousarray promotes 0-d to 1-d; restore the true shape
    a = np.ascontiguousarray(arr).reshape(np.shape(arr))
    code = _DTYPE_CODES.get(a.dtype)
    if code is None:
        a, code = a.astype(np.float32), 0
    return a, code


# ---------------------------------------------------------------------------
# Async checkpoint writer
# ---------------------------------------------------------------------------
class AsyncCheckpointer:
    """Streams {name: array} snapshots to disk on a native background thread.

    The caller's thread only pays for a memcpy; each snapshot is written to
    a temporary file and renamed. Falls back to synchronous writes of the
    same container without the native library."""

    def __init__(self):
        self._lib = load_library()
        self._handle = (ctypes.c_void_p(self._lib.ckpt_writer_open())
                        if self._lib else None)
        self._closed = False

    @property
    def is_native(self) -> bool:
        return self._handle is not None

    def submit(self, path: str, arrays: dict) -> None:
        if self._closed:
            raise RuntimeError("checkpointer closed")
        if self._lib is None:
            save_snapshot_py(path, arrays)
            return
        b = ctypes.c_void_p(self._lib.ckpt_begin(str(path).encode()))
        for name, arr in arrays.items():
            a, code = _container_array(arr)
            shape = (ctypes.c_int64 * a.ndim)(*a.shape)
            rc = self._lib.ckpt_add_array(
                b, name.encode(), code, a.ndim, shape,
                a.ctypes.data_as(ctypes.c_void_p))
            if rc != 0:
                raise ValueError(f"unsupported array for {name!r}")
        self._lib.ckpt_submit(self._handle, b)

    def flush(self) -> None:
        if self._handle is not None:
            self._lib.ckpt_writer_flush(self._handle)

    def stats(self):
        if self._handle is None:
            return {"written": None, "errors": None, "native": False}
        return {"written": int(self._lib.ckpt_writer_written(self._handle)),
                "errors": int(self._lib.ckpt_writer_errors(self._handle)),
                "native": True}

    def close(self) -> None:
        if self._handle is not None and not self._closed:
            self._lib.ckpt_writer_close(self._handle)
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# SMCK container readers/writers (Python side)
# ---------------------------------------------------------------------------
_MAGIC = 0x534D434B


def save_snapshot_py(path: str, arrays: dict) -> None:
    """Synchronous pure-Python writer of the same SMCK container."""
    path = str(path)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<II", _MAGIC, len(arrays)))
        for name, arr in arrays.items():
            a, code = _container_array(arr)
            nb = name.encode()
            f.write(struct.pack("<I", len(nb)))
            f.write(nb)
            f.write(struct.pack("<II", code, a.ndim))
            f.write(struct.pack(f"<{a.ndim}q", *a.shape))
            f.write(a.tobytes())
    os.replace(tmp, path)


def load_snapshot(path: str) -> dict:
    out = {}
    with open(path, "rb") as f:
        magic, n_arrays = struct.unpack("<II", f.read(8))
        if magic != _MAGIC:
            raise ValueError(f"{path}: not an SMCK snapshot")
        for _ in range(n_arrays):
            (name_len,) = struct.unpack("<I", f.read(4))
            name = f.read(name_len).decode()
            code, ndim = struct.unpack("<II", f.read(8))
            shape = struct.unpack(f"<{ndim}q", f.read(8 * ndim)) if ndim \
                else ()
            dtype = _CODE_DTYPES[code]
            count = int(np.prod(shape)) if ndim else 1
            data = f.read(count * dtype.itemsize)
            out[name] = np.frombuffer(data, dtype=dtype).reshape(shape)
    return out


# ---------------------------------------------------------------------------
# Golden oracle: sequential residual-systematic resampling
# ---------------------------------------------------------------------------
def residual_systematic_oracle(weights: np.ndarray,
                               wrand_unit: float) -> np.ndarray:
    """Exact sequential Algorithm 2 (native if available, else Python):
    the offspring counts of normalized ``weights`` for the systematic
    offset ``wrand_unit`` in [0, 1)."""
    w = np.ascontiguousarray(np.asarray(weights, np.float64))
    n = w.shape[0]
    lib = load_library()
    if lib is not None:
        counts = np.zeros(n, np.int32)
        lib.residual_systematic_cpp(
            w.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
            float(wrand_unit),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return counts
    inv_np = 1.0 / n
    counts = np.trunc(w * n).astype(np.int32)
    resid = w - counts * inv_np
    wrand = wrand_unit * inv_np
    s = 0.0
    for j in range(n):
        s += resid[j]
        if s >= wrand:
            counts[j] += 1
            wrand += inv_np
    return counts

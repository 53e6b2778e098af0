"""Build the hand-written Hopper kernels and load them with ctypes.

The CUDA sources in ``smc_tpu_torch/csrc/`` have a plain C interface (no
PyTorch headers), so each compiles in seconds. At first use every source is
compiled by its own ``nvcc`` process, all started together, and the objects
are linked into one shared library named by a hash of the sources and
flags, in ``smc_tpu_torch/_build/`` (listed in ``.gitignore``). A changed
source gives a new hash and so a rebuild. Nothing here runs at import.

Every C launch entry point takes device pointers and the CUDA stream as
``c_void_p`` and returns ``cudaGetLastError()`` after its launch; the
wrappers raise when that is not 0.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("mm_exact.cu", "mm_rk4.cu", "ladder.cu", "merge.cu",
           "thomas_factor.cu", "thomas_apply.cu", "thomas_apply_t.cu",
           "march.cu")
HEADERS = ("ring.cuh", "div_rn.cuh")  # included by sources; in the hash
# IEEE expf/logf/division throughout: no --use_fast_math.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Flags of single sources: march.cu rounds every product on its own, as
# the PyTorch operations it must equal bit for bit.
SOURCE_FLAGS = {"march.cu": ("-fmad=false",)}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # theta, obs, s0, ll, b, n, n_ds, n_obs, dt, stream
    "mm_exact_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    # theta, obs, s0, ll, b, n, n_ds, n_obs, substeps, h, h/2, h/6, stream
    "mm_rk4_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _P),
    # d_ll, dg, partial, tickets, s1, s2, b, n, k, stream
    "ladder_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # n -> the ladder grid's particle-block extent; k -> its
    # candidate-group extent (no launch)
    "ladder_blocks": (_I,),
    "ladder_groups": (_I,),
    # offsets, ancestors, b, n, stream
    "merge_launch": (_P, _P, _I, _I, _P),
    # n -> the merge grid's extent along the merged sequence (no launch)
    "merge_blocks": (_I,),
    # A, B, C, LU, Ms, nx, nb, cs, stream
    "thomas_factor_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # LU, Ms, C, rhs, x, nx, nb, stream (factor column stride 8, then 7)
    "thomas_apply_launch": (_P, _P, _P, _P, _P, _I, _I, _P),
    "thomas_apply_tiled_launch": (_P, _P, _P, _P, _P, _I, _I, _P),
    # LU, Ms, C, g, lam, nx, nb, cs, stream (the transposed solve)
    "thomas_apply_t_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # y, c, flags, condv, kin, h per lane (or null), rhs, nx, nb, flag
    # stride, grid stride, alpha, 1/h, alpha/h, stream
    "march_rows_launch": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                          _F, _F, _P),
    # the same with A, B, C before rhs
    "march_blocks_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                            _I, _I, _F, _F, _F, _P),
    # cs, nx, int[5] out: registers, shared bytes per block, blocks per
    # SM, spilled bytes, lanes per block (no launch)
    "thomas_factor_info": (_I, _I, _P),
    "thomas_apply_info": (_I, _I, _P),
    "thomas_apply_t_info": (_I, _I, _P),
}

# Launches of each kernel since the last reset (plain ints; each wrapper
# adds one right after its kernel launched, and nowhere else). Under CUDA
# graph capture a wrapper runs once and its kernel on every replay:
# ``launches_of`` takes the captured launches back out and keeps them per
# graph, ``count_replay`` adds them for each replay (smc/graphs.py).
launch_counts = {"mm_exact": 0, "mm_rk4": 0, "ladder": 0, "merge": 0,
                 "thomas_factor": 0, "thomas_apply": 0,
                 "thomas_apply_tiled": 0, "thomas_apply_t": 0,
                 "march_rows": 0, "march_blocks": 0}

# Collectives of a sharded run since the last reset (parallel/mesh.py):
# per kind the calls and, under "<kind>_bytes", the bytes each rank put
# in; "host_copies"/"host_copy_bytes" count the staging copies a gloo
# communicator makes for an operation it cannot run on CUDA tensors.
# Counted as the launches are, captures and replays included.
collective_counts: dict = {}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0
    collective_counts.clear()


def count_collective(kind: str, nbytes: int) -> None:
    collective_counts[kind] = collective_counts.get(kind, 0) + 1
    key = kind + "_bytes"
    collective_counts[key] = collective_counts.get(key, 0) + int(nbytes)


@contextlib.contextmanager
def launches_of(record: dict):
    """Record into ``record`` the launches (and, under ``("collective",
    kind)`` keys, the collectives) counted inside the block, and take them
    back out of the counts (a capture or a warm-up)."""
    before = dict(launch_counts)
    before_c = dict(collective_counts)
    try:
        yield record
    finally:
        for k, v in launch_counts.items():
            record[k] = v - before[k]
            launch_counts[k] = before[k]
        for k, v in collective_counts.items():
            if v != before_c.get(k, 0):
                record[("collective", k)] = v - before_c.get(k, 0)
        collective_counts.clear()
        collective_counts.update(before_c)


def count_replay(record: dict) -> None:
    """One replay of a graph whose capture recorded ``record``."""
    for k, v in record.items():
        if isinstance(k, tuple):
            collective_counts[k[1]] = collective_counts.get(k[1], 0) + v
        else:
            launch_counts[k] += v


def _nvcc() -> str:
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
             if os.environ.get("CUDA_HOME") else None,
             shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the Hopper kernels are built from smc_tpu_torch/csrc "
                       "at first use")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update(" ".join(SOURCE_FLAGS.get(name, ())).encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libsmc_kernels_{_digest()}.so"


def build() -> Path:
    """Compile (if the hashed library is missing) and return its path.
    Raises with nvcc's stderr when a compile or the link fails. The ptxas
    report (registers, shared memory, spills) is kept beside the library
    as ``<library>.ptxas.txt``."""
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    objs, procs = [], []
    for name in SOURCES:
        obj = BUILD_DIR / f"{tag}.{name}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(name, ()), "-c",
             str(CSRC / name), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    reports = []
    for name, p in zip(SOURCES, procs):
        out, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name} "
                               f"(exit {p.returncode}):\n{out}{err}")
        reports.append(f"== {name}\n{out}{err}")
    tmp = BUILD_DIR / f"{tag}.so"
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                           *map(str, objs)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed (exit {link.returncode}):\n"
                           f"{link.stdout}{link.stderr}")
    for obj in objs:
        obj.unlink()
    Path(str(lib) + ".ptxas.txt").write_text("\n".join(reports))
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, load once, and declare every entry point's types."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def build_seconds() -> float:
    """Build (or find) and load the library; the seconds it took."""
    t0 = time.perf_counter()
    load()
    return time.perf_counter() - t0


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_input(t: torch.Tensor, name: str, dtype: torch.dtype,
                ndim: int, device: torch.device) -> None:
    """Raise unless ``t`` is what a kernel takes: ``dtype``, ``ndim``
    dimensions, contiguous, on ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")

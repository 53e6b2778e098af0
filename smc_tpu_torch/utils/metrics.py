"""Observability: the per-step metrics stream and the profiler (PyTorch port
of ``smc_tpu.utils.metrics``).

- ``MetricsLogger``: one JSON line per SMC step (every ``SMCState``
  diagnostic and the wall clock) appended to ``metrics.jsonl``, in the JAX
  package's format, so :func:`read_metrics` reads either package's file.
- ``profile_trace``: a context manager around ``torch.profiler`` that
  writes a Chrome trace of the CPU and CUDA activity under ``logdir``.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import IO, Optional

import torch

_INT_FIELDS = ("step", "n_mh", "accepted", "n_gamma_reductions")


class MetricsLogger:
    """Append-only JSONL metrics stream, usable as a ``run_smc`` callback.

    The ten scalars come to the host in one copy of a stacked float64
    tensor (exact for the float32 and int32 fields): on CUDA every
    ``float()`` of a device scalar would wait for the device on its own.
    Returns the record it wrote."""

    FIELDS = ("step", "gamma", "ess", "max_log_lik", "n_mh", "accepted",
              "n_gamma_reductions", "mh_ratio", "total_lik_evals",
              "log_evidence")

    def __init__(self, path: str):
        self.path = path
        self._t0 = time.perf_counter()
        self._f: Optional[IO] = open(path, "a")

    def __call__(self, state) -> dict:
        vals = torch.stack([getattr(state, k).detach().to(torch.float64)
                            for k in self.FIELDS]).cpu().tolist()
        rec = dict(zip(self.FIELDS, vals))
        for k in _INT_FIELDS:
            rec[k] = int(rec[k])
        rec["wall_time_s"] = round(time.perf_counter() - self._t0, 4)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        return rec

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is present) and write its Chrome trace to
    ``logdir/trace_<time>_<pid>.json``; yields the profiler. A falsy
    ``logdir`` makes it a no-op that yields None.

    An exception raised in the block passes through unchanged, and no
    trace is written for it. A profiler that cannot start raises: asking
    for a trace never gives a quiet run without one."""
    if not logdir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    name = f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"
    prof.export_chrome_trace(os.path.join(logdir, name))


def read_metrics(path: str):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]

"""Observability: the per-step metrics stream and the profiler (PyTorch port
of ``smc_tpu.utils.metrics``).

- ``MetricsLogger``: one JSON line per SMC step (every ``SMCState``
  diagnostic and the wall clock) appended to ``metrics.jsonl``, in the JAX
  package's format, so :func:`read_metrics` reads either package's file.
- ``profile_trace``: a context manager around ``torch.profiler`` that
  writes a Chrome trace of the CPU and CUDA activity under ``logdir``.
- ``span``: the program's host spans at the step's seams (``smc.run``,
  ``smc.step``, ``smc.init_state``, ``smc.piece.<piece>``, ``smc.launch``,
  ``smc.read.step``, ``smc.read.sweep``, ``smc.warm_up``,
  ``smc.capture.<piece>``), recorded only while a ``torch.profiler``
  session records: each is a host-only profiler range (a function-scope
  record, which the profiler does not mirror on the device) and an entry
  of :data:`spans`. With no session a seam pays one bool check.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import time
from typing import IO, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

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


class Span:
    """One recorded span: ``name``; ``start`` and ``end`` on the host's
    ``time.perf_counter_ns`` clock; ``parent``, the index in :data:`spans`
    of the span it opened inside (-1 at the top); ``run``, the id of the
    ``smc.run`` span it lies in (None outside a run)."""
    __slots__ = ("name", "start", "end", "parent", "run", "_range")

    def __init__(self, name: str, new_run: bool):
        self.name = name
        self.parent = _open[-1] if _open else -1
        self.run = (next(_run_ids) if new_run
                    else spans[self.parent].run if self.parent >= 0 else None)
        self.start = self.end = 0

    def __enter__(self) -> "Span":
        self._range = torch._C._profiler._RecordFunctionFast(self.name)
        self._range.__enter__()
        _open.append(len(spans))
        spans.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end = time.perf_counter_ns()
        if _open and spans[_open[-1]] is self:
            _open.pop()
        self._range.__exit__(None, None, None)
        self._range = None


# The record of the spans since the last clear, in the order they opened;
# the indices of those still open, innermost last; the run ids.
spans: list = []
_open: list = []
_run_ids = itertools.count(1)
_OFF = contextlib.nullcontext()


def span(name: str, run: bool = False):
    """``with span(name):`` records the block as the span ``name`` while a
    profiler session records, and is a no-op otherwise. ``run`` starts a
    new run id, which every span inside the block carries."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return Span(name, run)


def clear_spans() -> None:
    del spans[:], _open[:]


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is present) and write its Chrome trace to
    ``logdir/trace_<time>_<pid>.json``; yields the profiler. A falsy
    ``logdir`` makes it a no-op that yields None. The program's spans
    (:func:`span`) appear in the trace beside the kernels; the record
    :data:`spans` is cleared when the session starts and holds the
    session's spans after it.

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
    clear_spans()
    with profile(activities=activities) as prof:
        yield prof
    name = f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"
    prof.export_chrome_trace(os.path.join(logdir, name))


def read_metrics(path: str):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]

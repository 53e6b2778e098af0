"""One run of one cell: set-up, the measured window (with a traced slice
when asked), the check, and the result line.

``run_cell`` takes the device to run on, so that the tests can drive the
whole of a run on the CPU at a small size; ``portbench/run.py`` refuses to
run without the cards a cell asks for.
"""
from __future__ import annotations

import gc
import statistics
import sys
import time
from types import SimpleNamespace

import torch

from portbench.harness import check, drivers, program, spec, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "smc_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``smc_tpu_torch`` is not ``smc_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def _window(drv, seconds, trace_cfg, traced: bool):
    """Requests back to back until ``seconds`` have passed, the last one
    completing; with ``traced``, the requests from the second on, until
    the slice's length (``trace_cfg``: ``seconds`` or ``steps``), inside
    one profiler session. Returns the per-request records, the elapsed
    seconds, the slice (or None) and the counters."""
    before = program.counters()
    recs, sl = [], None
    t0 = time.perf_counter()
    i = 0
    while True:
        if traced and sl is None and i == 1:
            def piece():
                out, t1 = [], time.perf_counter()
                while True:
                    out.append(drv.request(i + len(out)))
                    if "steps" in trace_cfg:
                        if len(out) >= trace_cfg["steps"]:
                            return out
                    elif time.perf_counter() - t1 >= trace_cfg["seconds"]:
                        return out
            c0 = program.counters()
            got, sl = trace.profiled(piece)
            sl["counters"] = program.delta(program.counters(), c0)
            sl["evals"] = sum(r["evals"] for r in got)
            sl["posteriors"] = sum(r["posteriors"] for r in got)
            sl["requests"] = len(got)
            recs += got
            i += len(got)
        else:
            recs.append(drv.request(i))
            i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    return recs, elapsed, sl, program.delta(program.counters(), before)


def _percentile(xs, q):
    xs = sorted(xs)
    if len(xs) == 1:
        return xs[0]
    return statistics.quantiles(xs, n=100, method="inclusive")[q - 1]


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             device, t_start: float, overrides: dict | None = None,
             bench: dict | None = None) -> dict:
    """The result of one run (the keys of the result line, ``checks``
    last)."""
    bench = bench or spec.benchmark()
    c = spec.cell(name, bench, overrides)
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        program.build_kernels()
    drv = drivers.DRIVERS[c["traffic"]["driver"]](c, seed, device)
    drv.warm()
    if traced and cuda:
        trace.warm_up()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    recs, elapsed, sl, counters = _window(drv, seconds, c["traffic"]["trace"],
                                          traced and cuda)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    drv.free()
    if cuda:
        torch.cuda.empty_cache()
    gc.collect()
    numbers = drv.numbers()
    for k, v in numbers.items():
        print(f"reading {k} {v!r}", file=sys.stderr)
    limits = c["traffic"]["check"]["limits"]
    failed = sum(r["failed"] for r in recs)
    correct = failed == 0 and check.verdict(numbers, limits)

    run = SimpleNamespace(
        cell=c, setup_s=setup_s, window_s=elapsed,
        posteriors=sum(r["posteriors"] for r in recs),
        requests=len(recs), latencies=[r["latency"] for r in recs],
        evals=sum(r["evals"] for r in recs), peak_bytes=peak,
        counters=counters, slice=sl, shapes=drv.shapes,
        n_particles=c["traffic"]["n_particles"],
        percentile=_percentile, peaks=spec.peaks(),
        cost=lambda mod, kernel, shape: spec.module("costs", mod).work(
            kernel, shape))
    metrics = {}
    for m in spec.metrics_for(name, traced, bench):
        value = spec.module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = dict(correct=bool(correct), attempted=len(recs), failed=failed,
               metrics=metrics, device=dev)
    if sl is not None:
        dev.update(busy_s=sl["busy_s"], window_s=sl["window_s"])
        out["breakdown"] = dict(
            device_ops=trace.top({k: v[0] for k, v in sl["kernels"].items()},
                                 scale=1e-6),
            idle_gaps=trace.top(sl["gaps"]))
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                     for k in limits}
    return out

"""Shared by the metric readers of the traced slice: the device time and
launches of the kernels whose name holds a given symbol, and the
roofline share of a kernel whose work ``portbench/costs/`` counts."""


def matching(run, symbol):
    """(seconds, launches) of the slice's device operations named with
    ``symbol``; None without a slice or without such an operation."""
    if run.slice is None:
        return None
    us = n = 0
    for name, (t, c) in run.slice["kernels"].items():
        if symbol in name:
            us, n = us + t, n + c
    return (us * 1e-6, n) if n else None


def roofline(run, cost_file, kernel, symbol):
    """The least time the chip needs for the slice's launches of
    ``kernel`` (the larger of its operations over the float32 peak and
    its bytes over the memory's), over their device time, in %."""
    got = matching(run, symbol)
    shape = run.shapes.get(kernel)
    if got is None or shape is None:
        return None
    seconds, launches = got
    w = run.cost(cost_file, kernel, shape)
    least = max(w["flops"] / run.peaks["fp32_flops_per_s"],
                w["bytes"] / run.peaks["hbm_bytes_per_s"])
    return 100.0 * least * launches / seconds

"""The device's idle share of the traced slice: 1 - (the union of its
operations' intervals) / (the slice's length), from torch.profiler."""
UNIT, SOURCE, MOVES = "%", "device_trace", "evals_per_s"
LAYER = "device"


def read(run):
    if run.slice is None or run.slice["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.slice["busy_s"] / run.slice["window_s"])

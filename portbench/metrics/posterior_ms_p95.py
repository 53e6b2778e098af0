"""The 95th percentile, over every request of the window, of the
milliseconds from handing the request to the program until its
posterior is on the host (the host clock)."""
UNIT, SOURCE, MOVES = "ms", "host_clock", None


def read(run):
    return 1e3 * run.percentile(run.latencies, 95)

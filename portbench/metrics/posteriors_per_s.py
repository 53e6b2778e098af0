"""Posteriors completed to gamma = 1 in the window over the window's
seconds (the host clock; each population of an ensemble request is one
posterior)."""
UNIT, SOURCE, MOVES = "posteriors/s", "host_clock", None


def read(run):
    return run.posteriors / run.window_s

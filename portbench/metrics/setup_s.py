"""Set-up seconds: from the start of the run's process to the start of
the measured window (the host clock): imports, the kernels' build or
load, inputs, the program's construction, and the warm request that
captures its CUDA graphs."""
UNIT, SOURCE, MOVES = "s", "host_clock", None


def read(run):
    return run.setup_s

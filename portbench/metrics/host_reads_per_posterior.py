"""Host reads of a device flag (``smc/graphs.py`` ``stats["host_reads"]``,
each a wait for the device) per posterior, over the window."""
LAYER = "run loop"
UNIT, SOURCE, MOVES = "reads", "program_counter", "posteriors_per_s"


def read(run):
    if not run.posteriors:
        return None
    return run.counters["host_reads"] / run.posteriors

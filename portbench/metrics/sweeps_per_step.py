"""Mutation sweeps per SMC step over the traced slice: the program's
``smc.piece.mut_init`` (the first sweep) and ``smc.piece.mut_sweep``
spans, over its ``smc.piece.finish`` spans (one a step)."""
from portbench.harness import program_trace as pt

LAYER = "tempering, resampling, mutation"
UNIT, SOURCE, MOVES = "sweeps", "program_counter", "posteriors_per_s"


def read(run):
    rec = pt.spans()
    if rec is None or run.slice is None:
        return None
    steps = pt.count(rec, "smc.piece.finish")
    if not steps:
        return None
    return (pt.count(rec, "smc.piece.mut_init")
            + pt.count(rec, "smc.piece.mut_sweep")) / steps

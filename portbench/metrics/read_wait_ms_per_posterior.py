"""Host milliseconds per posterior blocked on a device flag over the
traced slice: the program's ``smc.read.step`` and ``smc.read.sweep``
spans summed, over the slice's posteriors."""
from portbench.harness import program_trace as pt

LAYER = "run loop"
UNIT, SOURCE, MOVES = "ms", "program_counter", "posteriors_per_s"


def read(run):
    rec = pt.spans()
    if rec is None or run.slice is None:
        return None
    return pt.per_posterior_ms(run, pt.total_ns(rec, "smc.read."))

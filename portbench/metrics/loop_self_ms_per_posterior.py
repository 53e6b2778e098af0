"""Host milliseconds per posterior in the run loop's own Python over the
traced slice: the self time (duration less its children's cover) of the
program's ``smc.run`` and ``smc.piece.*`` spans, over the slice's
posteriors. A piece's self time is its generator-state copies and
bookkeeping around its launch; with the launch and read spans it makes
up the ``smc.run`` spans."""
from portbench.harness import program_trace as pt

LAYER = "run loop"
UNIT, SOURCE, MOVES = "ms", "program_counter", "posteriors_per_s"


def read(run):
    rec = pt.spans()
    if rec is None or run.slice is None:
        return None
    return pt.per_posterior_ms(
        run, pt.self_ns(rec, "smc.run") + pt.self_ns(rec, "smc.piece."))

"""The share of the methanation march's block-Thomas solves whose
right-hand side the march's own kernels computed, over the window:
100 x (``march_rows`` + ``march_blocks`` launches) / (``thomas_apply`` +
``thomas_apply_tiled`` launches). Each apply follows exactly one residual
evaluation, a bare one or a Newton system's, so this is how often the
march took its one-pass kernels instead of PyTorch's operations. A
program without those counters reports nothing."""
LAYER = "BDF2 march"
UNIT, SOURCE, MOVES = "%", "program_counter", "evals_per_s.march"


def read(run):
    launched = run.counters["launches"]
    if "march_rows" not in launched or "march_blocks" not in launched:
        return None
    applies = (launched.get("thomas_apply", 0)
               + launched.get("thomas_apply_tiled", 0))
    if not applies:
        return None
    return 100.0 * (launched["march_rows"] + launched["march_blocks"]) \
        / applies

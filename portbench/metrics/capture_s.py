"""Seconds of set-up spent warming up and capturing the CUDA graphs: each
piece's warm-up and capture seconds, summed over every captured shape
(the program's ``graphs.stats["shapes"]``)."""
from portbench.harness import program_trace as pt

LAYER = "run loop"
UNIT, SOURCE, MOVES = "s", "program_counter", "setup_s"


def read(run):
    shapes = pt.shapes()
    if shapes is None:
        return None
    return sum(w + c for s in shapes for w, c in s["pieces"].values())

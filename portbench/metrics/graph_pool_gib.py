"""GiB that the CUDA graphs' memory pools hold once captured: the bytes of
each captured shape's pool segments, as the caching allocator accounts
them, summed over the shapes (the program's ``graphs.stats["shapes"]``)."""
from portbench.harness import program_trace as pt

LAYER = "run loop"
UNIT, SOURCE, MOVES = "GiB", "program_counter", "peak_mem_gib"


def read(run):
    shapes = pt.shapes()
    if shapes is None:
        return None
    return sum(s["pool_bytes"] for s in shapes) / 2 ** 30

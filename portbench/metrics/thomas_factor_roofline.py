"""The block-Thomas factor kernel's share of its roofline in the traced
slice: the least time of its launches, counted from the algorithm's
bytes (``costs/thomas.py``), over their device time."""
from portbench.harness import kernels

LAYER = "kernels"
UNIT, SOURCE, MOVES = "%", "device_trace", "evals_per_s.march"


def read(run):
    return kernels.roofline(run, "thomas", "thomas_factor",
                            "thomas_factor_kernel")

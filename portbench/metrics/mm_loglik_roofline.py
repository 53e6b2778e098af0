"""The MM likelihood kernel's share of its roofline in the traced slice:
the least time of its launches, counted from the closed-form formula
(``costs/mm_loglik.py``), over their device time."""
from portbench.harness import kernels

LAYER = "kernels"
UNIT, SOURCE, MOVES = "%", "device_trace", "evals_per_s"


def read(run):
    return kernels.roofline(run, "mm_loglik", "mm_loglik", "mm_exact_kernel")

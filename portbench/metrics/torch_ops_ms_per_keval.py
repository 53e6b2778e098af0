"""Device milliseconds, per 1,000 particle evaluations in the traced
slice, of the operations the port did not write: not its hand-written
kernels (``csrc/``), not cuBLAS or cuSOLVER. In the methanation march
these are PyTorch's kernels of the residuals and Jacobian builds."""
LAYER = "BDF2 march"
UNIT, SOURCE, MOVES = "ms", "device_trace", "evals_per_s.march"

OWN = ("mm_exact_kernel", "mm_rk4_kernel", "ladder_kernel", "merge_kernel",
       "thomas_factor_kernel", "thomas_apply_kernel",
       "thomas_apply_t_kernel")
LIBRARY = ("gemm", "gemv", "cublas", "cutlass", "xmma", "cusolver", "potrf",
           "trsm", "getrf", "syrk", "splitKreduce")


def read(run):
    sl = run.slice
    if sl is None or not sl["evals"]:
        return None
    us = sum(t for name, (t, _) in sl["kernels"].items()
             if not any(s in name for s in OWN)
             and not any(s in name.lower() for s in LIBRARY))
    return us * 1e-3 / (sl["evals"] / 1e3)

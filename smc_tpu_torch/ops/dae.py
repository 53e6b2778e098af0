"""Implicit-DAE helpers (PyTorch port of the host-side part of
``smc_tpu.ops.dae``).

Only the step schedule is here: the per-system (blocked) engine of that
module is not ported yet, the lanes-major engine is ``ops/dae_fast.py``.
"""
from __future__ import annotations

import numpy as np


def geometric_schedule(t_final: float, n_steps: int, growth: float = 1.3
                       ) -> np.ndarray:
    """Step sizes dt_k = dt0 * growth^k summing exactly to t_final."""
    g = float(growth)
    w = g ** np.arange(n_steps)
    return (t_final * w / w.sum()).astype(np.float32)

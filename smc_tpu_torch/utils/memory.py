"""Device-memory reporting (PyTorch port of ``smc_tpu.utils.memory``):
the card's memory telemetry, for sizing particle counts and chunks."""
from __future__ import annotations

from typing import List, Optional

import torch


def device_memory_report() -> List[dict]:
    """One dict per visible CUDA device (bytes): ``bytes_in_use`` (the
    tensors PyTorch's allocator holds), ``bytes_reserved`` (what it has
    taken from the card), ``bytes_limit`` (the card's total) and
    ``bytes_free`` (the card's free memory, all processes counted).
    Returns [] where no card is present."""
    if not torch.cuda.is_available():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        out.append({"device": f"cuda:{i}",
                    "bytes_in_use": torch.cuda.memory_allocated(i),
                    "bytes_reserved": torch.cuda.memory_reserved(i),
                    "bytes_limit": total, "bytes_free": free})
    return out


def hbm_utilization() -> Optional[float]:
    """Max bytes_in_use / bytes_limit across devices, or None if unknown."""
    worst = None
    for rec in device_memory_report():
        used, lim = rec["bytes_in_use"], rec["bytes_limit"]
        if lim:
            frac = used / lim
            worst = frac if worst is None else max(worst, frac)
    return worst

"""Run-directory management and config archival (PyTorch port of
``smc_tpu.io.rundir``): a timestamped run directory with the reference's
subtrees, and a JSON snapshot of the ``SMCConfig`` and the model's
metadata in place of a copy of the configuration's source file."""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
from typing import Optional


class RunDir:
    SUBDIRS = ("pred", "hist_progress", "parity_box", "parity_mean",
               "checkpoints")

    def __init__(self, root: str = "runs", tag: Optional[str] = None,
                 timestamp: Optional[str] = None):
        ts = timestamp or datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
        name = f"{ts}_{tag}" if tag else ts
        self.path = os.path.join(root, name)
        os.makedirs(self.path, exist_ok=True)
        for s in self.SUBDIRS:
            os.makedirs(os.path.join(self.path, s), exist_ok=True)

    def sub(self, name: str) -> str:
        return os.path.join(self.path, name)

    def file(self, *parts: str) -> str:
        return os.path.join(self.path, *parts)

    def archive_config(self, cfg, model=None, extra: Optional[dict] = None):
        """JSON config snapshot (the reference's Initdata_<ts>.txt). The
        port's ``dtype`` is a torch dtype; it is written as its name
        (``"float32"``), the JAX package's spelling of the same dtype."""
        doc = {"config": dataclasses.asdict(cfg)}
        doc["config"]["dtype"] = str(doc["config"].get("dtype")).removeprefix(
            "torch.")
        if model is not None:
            doc["model"] = {
                "class": type(model).__name__,
                "param_names": list(getattr(model, "param_names", ())),
            }
        if extra:
            doc["extra"] = extra
        with open(self.file("config.json"), "w") as f:
            json.dump(doc, f, indent=2, default=str)

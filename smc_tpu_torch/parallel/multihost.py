"""Multi-process initialization helpers on ``torch.distributed`` (PyTorch
port of ``smc_tpu.parallel.multihost``).

Each process of a multi-GPU job runs the same program; the process group
wires them together. On a single process this module is a no-op, so the
same entry script runs everywhere. ``parallel/mesh.py`` builds the run's
mesh over the group (one SMC run across the processes), and the
primary process alone owns artifact IO (``runner.run_with_artifacts``).

Failure semantics (deliberately narrow: a real init failure must NOT
silently degrade to a single-process run that then proceeds with the
wrong world size):

- no cluster environment (none of ``MASTER_ADDR``, ``MASTER_PORT``,
  ``WORLD_SIZE``, ``RANK``, as ``torchrun`` sets them) and no explicit
  arguments: benign, a single-process run;
- a process group already up in this process (``dist.is_initialized()``):
  benign, nothing changes;
- anything else (a partial ``torchrun`` environment, any failure when
  explicit arguments were given, an unreachable store): **raised** to the
  caller.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from smc_tpu_torch.config import resolve_device

TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cuda") -> int:
    """Start the process group if this is a multi-process run; returns the
    number of devices the run spans: the world size when a process group
    is up, else the local device count (1 on the CPU).

    The backend is ``nccl`` for ``device`` CUDA and ``gloo`` for the CPU.
    Explicit arguments mean ``tcp://`` initialization at
    ``coordinator_address`` (``host:port``, or a ``tcp://`` URL) with
    that world size and rank, and all three must be given. With no
    arguments the ``torchrun`` environment is read (``env://``); without
    one this is a single-process no-op. With explicit arguments ANY
    failure raises: the caller asked for a process group and must not get
    a silent single-process run."""
    dev = resolve_device(device)
    if _group_up():
        return dist.get_world_size()
    explicit = (coordinator_address, num_processes, process_id)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if any(v is not None for v in explicit):
        if any(v is None for v in explicit):
            raise ValueError(
                "explicit initialization needs coordinator_address, "
                "num_processes and process_id together")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        dist.init_process_group(backend, init_method=url,
                                world_size=int(num_processes),
                                rank=int(process_id))
    else:
        present = [v for v in TORCHRUN_ENV if v in os.environ]
        if not present:
            return torch.cuda.device_count() if dev.type == "cuda" else 1
        if len(present) < len(TORCHRUN_ENV):
            missing = [v for v in TORCHRUN_ENV if v not in os.environ]
            raise ValueError(f"partial torchrun environment: {present} set, "
                             f"{missing} missing")
        dist.init_process_group(backend, init_method="env://")
    return dist.get_world_size()


def is_primary_host() -> bool:
    """True on the process that should own host-side IO (artifacts, logs):
    rank 0, or the only process when no group is up."""
    return not _group_up() or dist.get_rank() == 0

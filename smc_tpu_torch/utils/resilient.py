"""Crash/stall-resilient SMC execution (PyTorch port of
``smc_tpu.utils.resilient``).

The reference's resilience story is a Ray memory watchdog: restart the
worker pool whenever host RAM crosses 80% (methanation_functions.py:73-78).
Here recovery is checkpoint-based: reload the last per-step checkpoint and
continue, so a failure costs at most the in-flight SMC step. Since the
port's checkpoints restore the run's generator exactly (``io/checkpoint``),
a recovered run ends bit-equal to the uninterrupted one.

Two layers, both with a **progress-aware retry budget** (an attempt that
advanced ``state.step`` since the previous failure refreshes the budget;
only consecutive no-progress failures count against ``max_restarts``):

- :func:`run_resilient`: an in-process retry loop around ``run_smc`` with
  per-step checkpointing, for failures that surface as exceptions while
  the process's CUDA context stays usable (everything injectable in CPU
  tests, an out-of-memory error, a host-side failure in a callback).
- :func:`supervise`: a process-level supervisor for failures that poison
  the process (a sticky CUDA error, a segfault, an OOM kill): it restarts
  a worker command until it exits 0.
"""
from __future__ import annotations

import logging
import os
import subprocess
import time
from typing import Callable, Optional, Sequence

logger = logging.getLogger("smc_tpu_torch")


def _log(msg: str) -> None:
    if logger.handlers:
        logger.warning(msg)
    else:
        print(msg, flush=True)


def _save_for(path: str):
    from smc_tpu_torch.io.checkpoint import save_state, save_state_chunked
    if str(path).endswith(".smcd"):
        return save_state_chunked
    return save_state


def checkpoint_exists(path: str) -> bool:
    """True if ``path`` holds a loadable checkpoint (.npz/.smck file or
    .smcd directory; np.savez appends .npz, so check that spelling too)."""
    p = str(path)
    if os.path.isdir(p):
        return os.path.exists(os.path.join(p, "meta.json"))
    return os.path.exists(p) or os.path.exists(p + ".npz")


def run_resilient(model, cfg, key, *, checkpoint: Optional[str],
                  granularity: str = "step",
                  callback: Optional[Callable] = None,
                  max_restarts: int = 5, retry_delay_s: float = 30.0,
                  verbose: bool = True, state=None,
                  resume: bool = True, stop_file: Optional[str] = None,
                  psharding=None):
    """``run_smc`` with per-step checkpointing and reload-on-failure.

    Every completed SMC step is checkpointed to ``checkpoint`` (format by
    suffix: ``.smcd`` directory = bounded-host-memory streaming, anything
    else = ``.npz``), then ``callback`` (if any) runs. On any exception the
    state is reloaded from ``checkpoint`` onto the model's device and the
    run continues; at most ``max_restarts`` consecutive failures *without
    step progress* are retried before the last exception propagates. If
    ``resume`` and a checkpoint already exists, the run starts from it
    (crash-before-launch / supervised-reexec recovery). ``stop_file`` is
    forwarded to ``run_smc`` (cooperative preemption: the run returns its
    last completed, already-checkpointed step; not an error, no retry).

    On CUDA each retry's ``run_smc`` captures its graphs anew, and the new
    graphs read the reloaded state. A sticky CUDA error (an illegal
    address, for example) leaves the process's CUDA context unusable:
    every retry then fails the same way, the no-progress budget runs out
    and the error is raised. That is the right outcome here;
    :func:`supervise`, with a fresh process, is the path for that failure.

    ``psharding``: one run over a mesh's processes (``state`` their rows).
    Every process uses the primary process's ``checkpoint`` (the others
    may pass None) and takes the primary's word on whether it exists, so
    all resume from the same step. Each checkpoint is the gathered state,
    written by the primary process while the others wait at a barrier; a
    reload reads each process's rows. A failure raised on one process
    alone leaves its peers waiting in a collective: the retry covers
    failures every process sees (a reload, a stop), and :func:`supervise`
    the rest.
    """
    from smc_tpu_torch.io.checkpoint import load_state
    from smc_tpu_torch.smc import driver
    device = model.prior.device
    psh = psharding

    def from_primary(value):
        if psh is None:
            return value
        import torch.distributed as dist
        box = [value]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    checkpoint = from_primary(checkpoint)
    write = _save_for(checkpoint)

    def exists():
        return from_primary(checkpoint_exists(checkpoint))

    def save(path, st):
        if psh is None:
            return write(path, st)
        import torch.distributed as dist
        from smc_tpu_torch.parallel.mesh import gather_state
        st = gather_state(st, psh)
        if psh.world.rank == 0:
            write(path, st)
        dist.barrier()

    def cb(st):
        save(checkpoint, st)
        if callback is not None:
            callback(st)

    def load(path):
        return load_state(path, sharding=psh, device=device)

    if state is None and resume and exists():
        state = load(checkpoint)
        _log(f"run_resilient: resuming from step {int(state.step)} "
             f"gamma={float(state.gamma):.6f}")
    budget = max_restarts
    last_step = -1 if state is None else int(state.step)
    while True:
        try:
            if state is None:
                # Checkpoint right after the initial likelihood sweep (at
                # huge N it is minutes of device time worth not repeating).
                state = driver.init_state(key, model, cfg, psharding=psh)
                save(checkpoint, state)
            return driver.run_smc(model, cfg, key, callback=cb, state=state,
                                  verbose=verbose, granularity=granularity,
                                  stop_file=stop_file, psharding=psh)
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:  # noqa: BLE001 — deliberate catch-all:
            # anything unrecoverable exhausts the no-progress budget and
            # is re-raised.
            if exists():
                state = load(checkpoint)
                step = int(state.step)
            else:
                state, step = None, -1
            if step > last_step:
                budget = max_restarts  # made progress: refresh the budget
            else:
                budget -= 1
            last_step = step
            if budget < 0:
                raise
            _log(f"run_resilient: {type(e).__name__}: {e} — resuming from "
                 f"step {step} ({budget} no-progress retries left)")
            if retry_delay_s:
                time.sleep(retry_delay_s)


def _progress_stamp(path: Optional[str]) -> Optional[float]:
    """mtime of the progress file; for .smcd directories, of its meta.json
    (rewriting files inside a directory does not touch the dir's mtime)."""
    if path is None:
        return None
    for p in (os.path.join(path, "meta.json") if os.path.isdir(path)
              else path, str(path) + ".npz"):
        try:
            return os.stat(p).st_mtime
        except OSError:
            continue
    return None


def supervise(argv: Sequence[str], *, progress_file: Optional[str] = None,
              max_restarts: int = 5, retry_delay_s: float = 30.0,
              env: Optional[dict] = None) -> int:
    """Run ``argv`` as a child process, restarting on nonzero exit.

    Covers the failure mode :func:`run_resilient` cannot: a crash that
    poisons the whole process (a sticky CUDA error, a segfault, an OOM
    kill). A restart whose ``progress_file`` mtime advanced (e.g. the
    run's per-step checkpoint) refreshes the retry budget, so a long run
    survives any number of failures as long as each attempt completes at
    least one step. Returns the child's final returncode (0 on success,
    the last failing code once ``max_restarts`` consecutive no-progress
    restarts are exhausted).
    """
    budget = max_restarts
    last = _progress_stamp(progress_file)
    full_env = None if env is None else {**os.environ, **env}
    while True:
        rc = subprocess.call(list(argv), env=full_env)
        if rc == 0:
            return 0
        now = _progress_stamp(progress_file)
        if now is not None and (last is None or now > last):
            budget = max_restarts
        else:
            budget -= 1
        last = now
        if budget < 0:
            return rc
        _log(f"supervise: child exited {rc} — restarting "
             f"({budget} no-progress restarts left)")
        if retry_delay_s:
            time.sleep(retry_delay_s)

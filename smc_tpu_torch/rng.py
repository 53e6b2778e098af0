"""The random draws of a run, behind one small interface.

The JAX package threads a threefry key through the run. Here every draw of
the driver goes through a ``Draws`` object instead, in a fixed order:

- the prior draw: ``uniform((n, d))`` then ``normal((n, d))``;
- per resampling: ``uniform(())`` (the systematic offset v0; with
  ``resampling="stratified"`` or ``"multinomial"``, ``uniform((n,))``, one
  per output slot);
- per mutation sweep: ``normal((n, d))`` then ``uniform((n,))``.

An ensemble of D populations (smc/ensemble.py) draws from ONE ``Draws`` for
all of them, each request with a leading D:

- the prior draw: ``uniform((D, n, d))`` then ``normal((D, n, d))``;
- per ensemble step: ``uniform((D,))`` (every population's v0; for
  stratified or multinomial resampling ``uniform((D, n))``);
- per ensemble sweep: ``normal((D, n, d))`` then ``uniform((D, n))``.

Population p reads row p of each. A population that has finished, or whose
sweeps of a step are done, uses none of its rows, but the requests go on at
the full D while any population still runs.

SBC (smc/sbc.py) takes from the same ``Draws``, in this order: the prior
draw of the R truths, ``uniform((R, d))`` then ``normal((R, d))``; the
simulator's noise, one ``normal`` of the data's shape; the ensemble's draws
as above; last ``uniform((R, n))``, whose argsort picks the rank subsample.

``TorchDraws`` backs it with a ``torch.Generator`` on the run's device. A
test can back it with a replay of another stream (for example the JAX
package's draws) to compare decisions that depend on random numbers.

A run sharded over several processes (parallel/mesh.py) keeps one
generator state, the same on every rank. Each rank draws through a
``ShardedDraws`` view: a request at its own row count is made at the
global shape and the rank keeps its rows, so a sharded run sees the
random numbers of the one-device run.
"""
from __future__ import annotations

from typing import Protocol, Tuple

import numpy as np
import torch

from smc_tpu_torch.config import resolve_device


class Draws(Protocol):
    def uniform(self, shape: Tuple[int, ...],
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """U[0, 1) draws of ``shape``."""
        ...

    def normal(self, shape: Tuple[int, ...],
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Standard normal draws of ``shape``."""
        ...


class TorchDraws:
    """``Draws`` from a seeded ``torch.Generator`` on ``device``."""

    def __init__(self, seed: int, device="cuda"):
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    def uniform(self, shape, dtype=torch.float32) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator, dtype=dtype,
                          device=self.device)

    def normal(self, shape, dtype=torch.float32) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator, dtype=dtype,
                           device=self.device)

    def get_state(self) -> np.ndarray:
        """The generator's state as uint8 bytes (what a checkpoint keeps)."""
        return self.generator.get_state().numpy().copy()

    def set_state(self, state: np.ndarray) -> "TorchDraws":
        self.generator.set_state(
            torch.from_numpy(np.asarray(state, np.uint8).copy()))
        return self


class ShardedDraws:
    """One rank's view of the run's ``Draws``: the one place that tells a
    request for the rank's rows from a request every rank shares.

    ``rows`` is ``(lo, n_local, n_global)`` on the particle axis. For an
    ensemble, ``pops`` is ``(lo, d_local, d_global)`` on the leading
    population axis and the particle axis is the next one; for one
    population the particle axis leads. A request whose axis has the
    rank's local size is drawn at the global size from ``inner`` and
    sliced to the rank's block; any other request (a scalar, or the
    resampling's per-slot uniforms asked for at the global N) passes
    through whole. Every rank draws the same numbers from the same
    generator state, so all ranks stay in step. The cost is the global
    request on every rank: O(N d) draws per rank per sweep."""

    def __init__(self, inner, rows, pops=None):
        self.inner = inner
        self.rows = rows
        self.pops = pops

    def _plan(self, shape):
        shape = tuple(shape)
        axes = [(0, self.pops), (1, self.rows)] if self.pops else \
            [(0, self.rows)]
        full, index = list(shape), [slice(None)] * len(shape)
        for ax, spec in axes:
            if spec is None or ax >= len(shape):
                continue
            lo, n_local, n_global = spec
            if shape[ax] == n_local and n_local != n_global:
                full[ax] = n_global
                index[ax] = slice(lo, lo + n_local)
        return tuple(full), tuple(index)

    def _draw(self, fn, shape, dtype):
        full, index = self._plan(shape)
        out = fn(full, dtype)
        return out if full == tuple(shape) else out[index].contiguous()

    def uniform(self, shape, dtype=torch.float32) -> torch.Tensor:
        return self._draw(self.inner.uniform, shape, dtype)

    def normal(self, shape, dtype=torch.float32) -> torch.Tensor:
        return self._draw(self.inner.normal, shape, dtype)


def as_draws(key, device) -> Draws:
    """An int seed becomes ``TorchDraws(seed, device)``; a ``Draws`` object
    passes through."""
    if isinstance(key, (int, np.integer)):
        return TorchDraws(int(key), device)
    return key

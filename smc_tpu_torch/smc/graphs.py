"""The SMC step's pieces as captured CUDA graphs (the port's counterpart of
the JAX package's jitted pieces).

The JAX package jits the four seams of a step (``prep``: gamma search and
resampling; ``mut_init``; ``mut_sweep``: one mutation sweep; ``finish``:
fold the step into the state) and whole runs. PyTorch's counterpart of a
jitted, shape-static program is a CUDA graph: the kernels of one call
recorded once and replayed with one launch. Here each piece is one graph:

- ``init(key, data) -> (state, running)``: the prior draw and the initial
  likelihood sweep (full runs only);
- ``prep(state, data) -> p``: gamma search, resampling, the sweep limit;
- ``mut_init(state, p, data) -> (carry, more)``: the mutation carry and the
  first sweep, which needs no read;
- ``mut_sweep(state, p, carry, data) -> (carry, more)``: one sweep;
- ``finish(state, p, carry, data) -> (state, running)``: the fold.

``more`` and ``running`` are bool flags on the device, the only values the
host reads (:func:`read`): one per sweep after the first and one per step.

:class:`StepGraphs` holds the graphs of one shape. They read and write fixed
buffers: the state and the data are copied in when a run starts (not when
they already are the buffers), each sweep writes its carry back over the
carry it read, and ``finish`` writes the new state over the old. A returned
state is therefore the program's own buffer until the caller copies it
(:func:`clone`), as the entry points do before they return.

Random draws: every graph draws from the program's private CUDA generator,
registered with the graph, so a replay advances its Philox offset exactly
as the same calls would eagerly. Before a replay the run's ``TorchDraws``
state is copied into it and after the replay copied back, so the run's
stream is where the eager composition of the same pieces leaves it and the
final states are bit-equal. Draws of another kind cannot be replayed and
raise.

Kernel launches: the wrappers of ``ops/`` count a launch when the Python
call runs, which under capture happens once. ``_build.launches_of`` takes
the launches of the warm-up and of each capture back out of the counts and
records them per graph; every replay adds them again, so
``_build.launch_counts`` stays the number of kernel executions.

On the CPU there are no graphs: the same pieces run eagerly (the tests'
path).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Optional

import torch

from smc_tpu_torch.ops import _build
from smc_tpu_torch.rng import TorchDraws

# Since the last reset: host reads of a device flag, graph replays,
# captures (a graph each) and the seconds they took with their warm-up.
stats = {"host_reads": 0, "replays": 0, "captures": 0,
         "capture_seconds": 0.0}


def reset_stats() -> None:
    for k in stats:
        stats[k] = type(stats[k])(0)


def read(flag: torch.Tensor) -> bool:
    """Wait for the device and read one bool flag (counted)."""
    stats["host_reads"] += 1
    return bool(flag.item())


class Pieces(NamedTuple):
    """One SMC step cut at its seams (signatures in the module's text).
    ``init`` may be None where a run starts from a given state."""
    init: Optional[Callable]
    prep: Callable
    mut_init: Callable
    mut_sweep: Callable
    finish: Callable


def tree_map(fn, tree):
    """``fn`` applied to every tensor of a nest of dataclasses, named
    tuples, tuples and lists; other leaves (a ``Draws``, None) as they
    are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    return tree


def tensors(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def clone(tree):
    """A copy of every tensor of ``tree`` (other leaves shared)."""
    return tree_map(torch.clone, tree)


def _copy_into(dst, src) -> None:
    """Copy ``src``'s tensors into ``dst``'s, skipping those that already
    are the same tensor."""
    for d, s in zip(tensors(dst), tensors(src)):
        if d is not s:
            d.copy_(s)


def _generator(key) -> torch.Generator:
    if not isinstance(key, TorchDraws):
        raise TypeError(
            "a run on CUDA replays captured graphs, which draw from a "
            "torch.Generator: pass an int seed or a TorchDraws, not "
            f"{type(key).__name__}")
    return key.generator


class StepGraphs:
    """The pieces of one step (and, with ``pieces.init``, the start of a
    run) as CUDA graphs for one shape: (model, N, d, D, cfg) and the data's
    shapes. Captured at the first :meth:`bind`; the object then offers the
    pieces' own signatures and replays one graph per call."""

    def __init__(self, pieces: Pieces, device: torch.device):
        self.pieces = pieces
        self.device = device
        self.draws = TorchDraws(0, device)        # the private generator
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs = {}                          # name -> (graph, launches)
        self.S = self.D = self.P = self.C = None
        self.more = self.running = self.init_running = None
        self.replays = 0

    # -- capture ------------------------------------------------------------
    def _capture(self, state, data) -> None:
        """Warm up every piece once (eager, on a side stream; its launches
        and draws do not count), then capture each piece in run order into
        one memory pool. The pieces run strictly one after another, and
        what a later graph keeps (p, the carry) is not needed across the
        earlier graphs' replays, so they may share the pool."""
        t0 = time.perf_counter()
        _build.load()                        # build before any capture
        pcs = self.pieces
        self.D = clone(data)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with _build.launches_of({}), torch.cuda.stream(side):
            if pcs.init is not None:
                state = pcs.init(self.draws, self.D)[0]
            self.S = clone(state).replace(key=self.draws)
            p = pcs.prep(self.S, self.D)
            c, _ = pcs.mut_init(self.S, p, self.D)
            c, _ = pcs.mut_sweep(self.S, p, c, self.D)
            pcs.finish(self.S, p, c, self.D)
            del p, c
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        S, D = self.S, self.D

        if pcs.init is not None:
            def init():
                s, running = pcs.init(self.draws, D)
                _copy_into(S, s)
                return running
            self.init_running = self._record("init", init)
        self.P = self._record("prep", lambda: pcs.prep(S, D))
        self.C, self.more = self._record(
            "mut_init", lambda: pcs.mut_init(S, self.P, D))

        def sweep():
            c, more = pcs.mut_sweep(S, self.P, self.C, D)
            _copy_into(self.C, c)
            self.more.copy_(more)

        def finish():
            s, running = pcs.finish(S, self.P, self.C, D)
            _copy_into(S, s)
            return running
        self._record("mut_sweep", sweep)
        self.running = self._record("finish", finish)
        torch.cuda.synchronize(self.device)
        stats["capture_seconds"] += time.perf_counter() - t0

    def _record(self, name: str, fn):
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.draws.generator)
        launches = {}
        with _build.launches_of(launches):
            with torch.cuda.graph(graph, pool=self.pool):
                out = fn()
        self.graphs[name] = (graph, launches)
        stats["captures"] += 1
        return out

    def _replay(self, name: str, key) -> None:
        gen = _generator(key)
        graph, launches = self.graphs[name]
        own = self.draws.generator
        own.set_state(gen.get_state())
        graph.replay()
        gen.set_state(own.get_state())
        _build.count_replay(launches)
        self.replays += 1
        stats["replays"] += 1

    # -- the pieces -------------------------------------------------------
    def bind(self, state, data):
        """Capture at the first call; copy ``state`` (None for a run that
        starts with ``init``) and ``data`` into the buffers. Returns the
        buffers' ``(state, data)``, the arguments of the other methods."""
        if not self.graphs:
            self._capture(state, data)
        _copy_into(self.D, data)
        if state is None:
            return None, self.D
        _copy_into(self.S, state)
        return self.S.replace(key=state.key), self.D

    def init(self, key, data):
        self._replay("init", key)
        return self.S.replace(key=key), self.init_running

    def prep(self, s, data=None):
        self._replay("prep", s.key)
        return self.P

    def mut_init(self, s, p, data=None):
        self._replay("mut_init", s.key)
        return self._carry(s), self.more

    def mut_sweep(self, s, p, c, data=None):
        self._replay("mut_sweep", s.key)
        return self._carry(s), self.more

    def finish(self, s, p, c, data=None):
        self._replay("finish", s.key)
        return self.S.replace(key=s.key), self.running

    def _carry(self, s):
        c = self.C
        return c._replace(key=s.key) if hasattr(c, "key") else c


class Programs:
    """The capture cache of one ``make_*`` function: a :class:`StepGraphs`
    per shape, as a jitted function keeps one executable per shape."""

    def __init__(self, pieces: Pieces):
        self.pieces = pieces
        self.by_shape = {}

    def on(self, device: torch.device, state, data):
        """The pieces to run with, and the state and data to run them on:
        on CUDA the graphs of this shape (captured now if new) with the
        inputs copied into their buffers; on the CPU the eager pieces and
        the inputs as they are."""
        if device.type != "cuda":
            return self.pieces, state, data
        shape = tuple((tuple(t.shape), t.dtype)
                      for t in tensors(state) + tensors(data))
        shape += (state is None,)
        prog = self.by_shape.get(shape)
        if prog is None:
            prog = self.by_shape[shape] = StepGraphs(self.pieces, device)
        state, data = prog.bind(state, data)
        return prog, state, data

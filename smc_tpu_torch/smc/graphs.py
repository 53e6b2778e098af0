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

A block-granularity step (:class:`BlockPieces`, :class:`BlockGraphs`)
splits each sweep further: ``draw`` (the covariance factors and the full-N
draws), one ``core`` graph per slab of rows, over views of the carry and
the draws at its rows, and ``admin`` (the controller over the slabs'
outputs); the gradient kinds' initial gradients come from one ``grad``
graph per slab before ``mut_init``, which does not sweep. The gradient
kinds' backward passes are captured with their forward passes.

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

One module owns warm-up, capture and replay (:func:`warm_up`,
:func:`capture`, :func:`replay`): the step graphs here and
:func:`repeat`, which replays one captured update ``n`` times (MAP's Adam
step), all count their captures and replays in :data:`stats`.

On the CPU there are no graphs: the same pieces run eagerly (the tests'
path).

A sharded run's pieces (parallel/mesh.py) hold collectives. On NCCL they
are captured with the rest: before the first capture one eager collective
per group starts its communicator, whose lazy start a capture cannot
record. A gloo group cannot be captured: :class:`Programs` then gives the
eager pieces on CUDA too.
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


class BlockPieces(NamedTuple):
    """One block-granularity step cut at its seams; ``starts`` are the
    slabs' first rows. ``grad`` is None for a kind without gradients.

    - ``prep(state, data=None) -> p`` and ``finish(state, p, carry,
      data=None) -> (state, running)`` as in :class:`Pieces`;
    - ``grad(state, p, lo)``: one slab's initial gradients;
    - ``mut_init(state, p, grads) -> carry`` (no sweep);
    - ``draw(state, carry) -> a``: (key, covariance factors, draws);
    - ``core(state, p, carry, a, lo)``: one slab's proposal, evaluation
      and accept;
    - ``admin(state, p, carry, a, outs) -> (carry, more)``."""
    prep: Callable
    grad: Optional[Callable]
    mut_init: Callable
    draw: Callable
    core: Callable
    admin: Callable
    finish: Callable
    starts: tuple


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


def warm_up(fn: Callable, device: torch.device) -> None:
    """``fn()`` once, eagerly, on a side stream, as a capture needs before
    it (autograd's backward included); its launches are not counted."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with _build.launches_of({}), torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)


def capture(fn: Callable, pool=None, generator=None):
    """``fn()`` recorded as one CUDA graph (drawing from ``generator``, if
    given): ``(graph, launches, out)``, ``out`` being ``fn``'s outputs (the
    graph's buffers) and ``launches`` the kernel launches that each
    :func:`replay` adds to the counts."""
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    launches = {}
    with _build.launches_of(launches):
        with torch.cuda.graph(graph, pool=pool):
            out = fn()
    stats["captures"] += 1
    return graph, launches, out


def replay(graph: torch.cuda.CUDAGraph, launches: dict) -> None:
    graph.replay()
    _build.count_replay(launches)
    stats["replays"] += 1


def repeat(step: Callable, state: tuple, n: int) -> tuple:
    """``state`` (a tuple of tensors) after ``n`` applications of ``step``.
    On CUDA one step is warmed up, captured over buffers that it updates in
    place, and replayed ``n`` times; on the CPU it runs eagerly."""
    if n == 0:
        return state
    device = state[0].device
    if device.type != "cuda":
        for _ in range(n):
            state = step(state)
        return state
    t0 = time.perf_counter()
    buf = clone(state)
    warm_up(lambda: step(clone(buf)), device)
    graph, launches, _ = capture(lambda: _copy_into(buf, step(buf)))
    stats["capture_seconds"] += time.perf_counter() - t0
    for _ in range(n):
        replay(graph, launches)
    return buf


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

    def __init__(self, pieces: Pieces, device: torch.device, comm=None):
        self.pieces = pieces
        self.device = device
        self.comm = comm
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
        if self.comm is not None:
            self.comm.warm_up(self.device)   # start the communicators
        self.D = clone(data)
        warm_up(lambda: self._warm_up(state), self.device)
        self._record_pieces()
        torch.cuda.synchronize(self.device)
        stats["capture_seconds"] += time.perf_counter() - t0

    def _warm_up(self, state) -> None:
        pcs, D = self.pieces, self.D
        if pcs.init is not None:
            state = pcs.init(self.draws, D)[0]
        self.S = clone(state).replace(key=self.draws)
        p = pcs.prep(self.S, D)
        c, _ = pcs.mut_init(self.S, p, D)
        c, _ = pcs.mut_sweep(self.S, p, c, D)
        pcs.finish(self.S, p, c, D)

    def _record_pieces(self) -> None:
        pcs, S, D = self.pieces, self.S, self.D
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
        self._record("mut_sweep", sweep)
        self._record_finish()

    def _record_finish(self) -> None:
        pcs, S, D = self.pieces, self.S, self.D

        def finish():
            s, running = pcs.finish(S, self.P, self.C, D)
            _copy_into(S, s)
            return running
        self.running = self._record("finish", finish)

    def _record(self, name: str, fn):
        graph, launches, out = capture(fn, self.pool, self.draws.generator)
        self.graphs[name] = (graph, launches)
        return out

    def _replay(self, name: str, key) -> None:
        gen = _generator(key)
        own = self.draws.generator
        own.set_state(gen.get_state())
        replay(*self.graphs[name])
        gen.set_state(own.get_state())
        self.replays += 1

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


class BlockGraphs(StepGraphs):
    """The pieces of a block-granularity step (:class:`BlockPieces`) as
    CUDA graphs for one shape: ``prep``, a ``grad`` graph per slab (the
    gradient kinds), ``mut_init``, ``draw``, a ``core`` graph per slab,
    ``admin`` and ``finish``. A slab's graph reads views of the full-N
    buffers at its rows and keeps its outputs in buffers of its own, which
    ``admin`` reads. No graph copies from the host or reads the device."""

    def _warm_up(self, state) -> None:
        pcs, D = self.pieces, self.D
        self.S = clone(state).replace(key=self.draws)
        p = pcs.prep(self.S, D)
        grads = (None if pcs.grad is None
                 else [pcs.grad(self.S, p, lo) for lo in pcs.starts])
        c = pcs.mut_init(self.S, p, grads)
        a = pcs.draw(self.S, c)
        outs = [pcs.core(self.S, p, c, a, lo) for lo in pcs.starts]
        c, _ = pcs.admin(self.S, p, c, a, outs)
        pcs.finish(self.S, p, c, D)

    def _record_pieces(self) -> None:
        pcs, S, D = self.pieces, self.S, self.D
        self.P = self._record("prep", lambda: pcs.prep(S, D))
        self.G = None if pcs.grad is None else [
            self._record(("grad", lo), lambda lo=lo: pcs.grad(S, self.P, lo))
            for lo in pcs.starts]
        self.C = self._record("mut_init",
                              lambda: pcs.mut_init(S, self.P, self.G))
        self.A = self._record("draw", lambda: pcs.draw(S, self.C))
        self.O = {lo: self._record(
            ("core", lo), lambda lo=lo: pcs.core(S, self.P, self.C, self.A,
                                                 lo))
            for lo in pcs.starts}

        def admin():
            c, more = pcs.admin(S, self.P, self.C, self.A,
                                [self.O[lo] for lo in pcs.starts])
            _copy_into(self.C, c)
            return more
        self.more = self._record("admin", admin)
        self._record_finish()

    def grad(self, s, p, lo):
        self._replay(("grad", lo), s.key)
        return self.G[self.pieces.starts.index(lo)]

    def mut_init(self, s, p, grads):
        self._replay("mut_init", s.key)
        return self._carry(s)

    def draw(self, s, c):
        self._replay("draw", s.key)
        return (s.key,) + tuple(self.A[1:])

    def core(self, s, p, c, a, lo):
        self._replay(("core", lo), s.key)
        return self.O[lo]

    def admin(self, s, p, c, a, outs):
        self._replay("admin", s.key)
        return self._carry(s), self.more


class Programs:
    """The capture cache of one ``make_*`` function: a :class:`StepGraphs`
    per shape, as a jitted function keeps one executable per shape."""

    def __init__(self, pieces: Pieces, comm=None):
        self.pieces = pieces
        self.comm = comm                     # a ParticleSharding, or None
        self.by_shape = {}

    def on(self, device: torch.device, state, data):
        """The pieces to run with, and the state and data to run them on:
        on CUDA the graphs of this shape (captured now if new) with the
        inputs copied into their buffers; on the CPU the eager pieces and
        the inputs as they are. A gloo-sharded run gets the eager pieces
        on CUDA too."""
        if device.type != "cuda" or (self.comm is not None
                                     and not self.comm.capturable):
            return self.pieces, state, data
        shape = tuple((tuple(t.shape), t.dtype)
                      for t in tensors(state) + tensors(data))
        shape += (state is None,)
        prog = self.by_shape.get(shape)
        if prog is None:
            kind = (BlockGraphs if isinstance(self.pieces, BlockPieces)
                    else StepGraphs)
            prog = self.by_shape[shape] = kind(self.pieces, device,
                                               self.comm)
        state, data = prog.bind(state, data)
        return prog, state, data

"""One SMC run over several processes (PyTorch port of
``smc_tpu.parallel.mesh``).

The JAX package runs one process with several devices: the step stays one
jitted function and XLA's SPMD partitioner inserts the collectives. PyTorch
has no partitioner. Here each GPU (or CPU rank) is one process of a
``torch.distributed`` group, the mesh is PyTorch's
``DeviceMesh`` of shape (particles, data), and every reduction on the
step's path is an explicit collective over the mesh axis it runs along.

The model of a sharded run:

- Each rank holds rows ``[r N/S, (r + 1) N/S)`` of ``particles`` and
  ``log_lik`` (r its coordinate on the "particles" axis, S that axis's
  size). An ensemble also splits its D populations over the "data" axis.
- Every other field of ``SMCState`` is replicated and bit-equal on every
  rank: ``gamma``, ``step``, ``ess``, the counters, ``log_evidence`` and
  the generator state of the run's draws.
- Every flag the host reads is computed from all-reduced values, so all
  ranks take the same number of steps, sweeps and ring rounds. A rank that
  read a flag of its own would wait in a collective its peers never join.
- Draws: each rank makes the global request from the shared generator and
  keeps its rows (``rng.ShardedDraws``), so a sharded run sees the random
  numbers of the one-device run and differs from it only where sums are
  reassociated. It resumes from one generator state.

The collectives of one step (``Axis`` counts each, by kind and bytes):

- gamma search: the max log-likelihood (all-reduce MAX), the ladder
  kernel's local (s1, s2) (one all-reduce SUM of the (2, K + 1) stack),
  the weight normalizer (SUM);
- resampling: the shard totals of the exact integer prefix sums and the
  max weights (one all-gather), the count repair at the global first-max
  particle (SUM), then either the all-gather of the slot offsets and of
  the (N/S, d + 1) bundle (``resample_shmap.resample_sharded``) or the
  ring exchange (``resample_sharded_ring``);
- each mutation sweep: the covariance's mean (SUM) and its local GEMM
  (SUM), the accepted-at-least-once count (SUM).

On NCCL the collectives run inside the step's CUDA graphs: each group's
communicator is started by one eager collective before the first capture
(its lazy start cannot be captured). A gloo group cannot be captured; on
it the run's pieces run eagerly, and the entry points say so when they
start. Gloo runs some operations only on host tensors (``_GLOO_HOST_ONLY``):
those are staged through the host explicitly, and the copies are counted.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from smc_tpu_torch.config import SMCConfig
from smc_tpu_torch.ops import _build
from smc_tpu_torch.rng import ShardedDraws
from smc_tpu_torch.smc.state import SMCState

PARTICLE_AXIS = "particles"
DATA_AXIS = "data"

# Operations a gloo group cannot run on CUDA tensors; they go through the
# host. Gloo's all-reduce, all-gather and broadcast take CUDA tensors;
# its send and receive read the tensor's pointer as host memory.
_GLOO_HOST_ONLY = frozenset({"send_recv"})


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Axis:
    """The collectives of one process group (one mesh axis, or the whole
    mesh), counted in ``ops._build.collective_counts``. Each takes and
    returns tensors on the run's device and never reads one on the
    host."""

    def __init__(self, group, name: str):
        self.group = group
        self.name = name
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = dist.get_backend(group)

    def _host(self, op: str, t: torch.Tensor) -> bool:
        return (self.backend == "gloo" and t.is_cuda
                and op in _GLOO_HOST_ONLY)

    def _reduce(self, t: torch.Tensor, op, kind: str) -> torch.Tensor:
        out = t.reshape(-1).clone()              # a 0-d tensor as (1,)
        _build.count_collective(kind, _nbytes(out))
        if self.size > 1 or self.backend == "nccl":
            dist.all_reduce(out, op=op, group=self.group)
        return out.reshape(t.shape)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the group's ranks (all-reduce SUM). Differentiable
        for a result every rank consumes alike: its gradient is the
        result's own, so this rank's term gets it unchanged (pair it with
        :meth:`replicated` on the inputs that every rank shares)."""
        if _tracks_grad(t):
            return _SumOverRanks.apply(t, self)
        return self._reduce(t, dist.ReduceOp.SUM, "all_reduce_sum")

    def replicated(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` itself, an input every rank of the group holds alike and
        each uses for its own terms: its gradient is the sum of the
        ranks' gradients (all-reduce SUM in the backward pass)."""
        return _ReplicatedOverRanks.apply(t, self) if _tracks_grad(t) else t

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the group's ranks."""
        return self._reduce(t, dist.ReduceOp.MAX, "all_reduce_max")

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked on a new leading axis, in rank
        order (all-gather). Differentiable as :meth:`sum` is: this rank's
        ``t`` gets the gradient of its own slice."""
        if _tracks_grad(t):
            return _GatherOverRanks.apply(t, self)
        t = t.contiguous()
        _build.count_collective("all_gather", _nbytes(t))
        if self.size == 1 and self.backend != "nccl":
            return t[None].clone()
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t, group=self.group)
        return torch.stack(out)

    def any(self, flag: torch.Tensor) -> torch.Tensor:
        """A bool flag that is True on every rank if it is on any."""
        return self.max(flag.to(torch.int32)) > 0

    def agree(self, value: bool, device) -> bool:
        """A host-side bool made the same on every rank (True if any rank
        has it), for a decision the host takes between device programs
        (a stop file seen by one rank first)."""
        t = torch.tensor([int(value)], dtype=torch.int32, device=device)
        return bool(self.max(t).item())

    def exchange(self, fwd: torch.Tensor, bwd: torch.Tensor):
        """One two-way ring round: returns (the next rank's ``fwd``, the
        previous rank's ``bwd``). Gloo sends and receives host tensors
        only: there the buffers are staged through the host."""
        nxt = dist.get_global_rank(self.group, (self.rank + 1) % self.size)
        prv = dist.get_global_rank(self.group, (self.rank - 1) % self.size)
        _build.count_collective("send_recv", 2 * _nbytes(fwd))
        host = self._host("send_recv", fwd)
        if host:
            dev = fwd.device
            fwd, bwd = fwd.cpu(), bwd.cpu()
            _build.count_collective("host_copy", 2 * _nbytes(fwd))
        got_f, got_b = torch.empty_like(fwd), torch.empty_like(bwd)
        # Two tags: with two ranks both buffers go to the same peer.
        ops = [dist.P2POp(dist.isend, fwd.contiguous(), prv, self.group, 1),
               dist.P2POp(dist.irecv, got_f, nxt, self.group, 1),
               dist.P2POp(dist.isend, bwd.contiguous(), nxt, self.group, 2),
               dist.P2POp(dist.irecv, got_b, prv, self.group, 2)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        if host:
            got_f, got_b = got_f.to(dev), got_b.to(dev)
            _build.count_collective("host_copy", 2 * _nbytes(got_f))
        return got_f, got_b

    def warm_up(self, device) -> None:
        """One eager collective: starts the group's communicator, which a
        CUDA graph capture cannot do."""
        t = torch.zeros(1, device=device)
        dist.all_reduce(t, group=self.group)


def _tracks_grad(t: torch.Tensor) -> bool:
    return t.requires_grad and torch.is_grad_enabled()


# The backward passes of a run whose ranks split one sum over their terms
# (the lane mesh's conditions): the loss every rank differentiates is the
# same replicated value, so the cotangent of an all-reduced sum is already
# the one every term needs, and an input the ranks share gathers its
# gradient from every rank's terms. (An all-reduce in both directions, as
# torch.distributed.nn's, would scale the gradient by the group's size.)
class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        return axis._reduce(t, dist.ReduceOp.SUM, "all_reduce_sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReplicatedOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis._reduce(g.contiguous(), dist.ReduceOp.SUM,
                                "all_reduce_sum"), None


class _GatherOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        ctx.rank = axis.rank
        return axis.gather(t)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank], None


@dataclasses.dataclass(frozen=True, eq=False)
class ParticleSharding:
    """What ``psharding`` means in the port: the mesh, the collectives of
    its "particles" axis (a population's reductions), of its "data" axis
    (an ensemble's populations, the methanation lane mesh's conditions)
    and of the whole mesh (flags). The global particle count is the local
    one times ``particles.size``."""
    mesh: object
    particles: Axis
    data: Axis
    world: Axis

    @property
    def capturable(self) -> bool:
        """True when the collectives can run inside a CUDA graph (NCCL)."""
        return self.world.backend == "nccl"

    def n_global(self, n_local: int) -> int:
        return n_local * self.particles.size

    def rows(self, n_global: int) -> slice:
        """This rank's rows of a particle axis of ``n_global``."""
        n_l = n_global // self.particles.size
        return slice(self.particles.rank * n_l,
                     (self.particles.rank + 1) * n_l)

    def datasets(self, n_datasets: int) -> slice:
        """This rank's populations of an ensemble of ``n_datasets``."""
        d_l = n_datasets // self.data.size
        return slice(self.data.rank * d_l, (self.data.rank + 1) * d_l)

    def view(self, key, n_local: int, n_pops: Optional[int] = None):
        """This rank's view of the run's draws (``rng.ShardedDraws``):
        rows of ``n_local`` particles, and for an ensemble ``n_pops``
        local populations."""
        s = self.particles
        pops = None
        if n_pops is not None:
            pops = (self.data.rank * n_pops, n_pops, n_pops * self.data.size)
        return ShardedDraws(key, (s.rank * n_local, n_local,
                                  n_local * s.size), pops)

    def warm_up(self, device) -> None:
        if device.type == "cuda" and self.capturable:
            for ax in (self.world, self.particles, self.data):
                ax.warm_up(device)
            torch.cuda.synchronize(device)

    # -- state fields ------------------------------------------------------
    def field_index(self, name: str, ensemble: bool, n: int, d: int = 0):
        """The index of this rank's part of state field ``name`` (``n``
        the global particle count, ``d`` the global population count of
        an ensemble)."""
        rows = self.rows(n)
        if not ensemble:
            return (rows,) if name in ("particles", "log_lik") else ()
        pops = self.datasets(d)
        return (pops, rows) if name in ("particles", "log_lik") else (pops,)


def as_sharding(mesh_or_psh) -> Optional[ParticleSharding]:
    """A ``ParticleSharding`` from a mesh (or itself; None stays None)."""
    if mesh_or_psh is None or isinstance(mesh_or_psh, ParticleSharding):
        return mesh_or_psh
    return particle_sharding(mesh_or_psh)


def make_mesh(n_devices: Optional[int] = None, n_data: int = 1,
              device=None):
    """The (particles, data) ``DeviceMesh`` over the process group's
    ranks: ``n_devices // n_data`` along "particles" by ``n_data`` along
    "data". ``n_data > 1`` splits an ensemble's populations, or the
    methanation model's conditions (``lane_mesh``), over the second axis.

    Needs a process group (``initialize_distributed``, or ``torchrun``);
    ``n_devices`` (default: the world size) must be the world size: one
    process per device. ``device``: the run's CUDA device, made this
    process's current device before the mesh starts its NCCL
    communicators (the tensors' device is always the run's own)."""
    from torch.distributed.device_mesh import init_device_mesh
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            "make_mesh needs a torch.distributed process group: start the "
            "run under torchrun (torchrun --nproc-per-node N ...) or call "
            "parallel.multihost.initialize_distributed first")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(
            f"make_mesh({n_devices}) but the process group has {world} "
            f"process(es); one process per device: start N processes with "
            f"torchrun --nproc-per-node {n_devices} (or "
            f"initialize_distributed(..., num_processes={n_devices}, ...))")
    if n_devices % n_data != 0:
        raise ValueError(f"n_devices={n_devices} not divisible by "
                         f"n_data={n_data}")
    # A gloo group's mesh is a CPU mesh whatever the tensors' device: it
    # only supplies the axes' groups (two gloo ranks may share one card).
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if kind == "cuda" and device is not None \
            and torch.device(device).index is not None:
        torch.cuda.set_device(torch.device(device))
    return init_device_mesh(kind, (n_devices // n_data, n_data),
                            mesh_dim_names=(PARTICLE_AXIS, DATA_AXIS))


def particle_sharding(mesh) -> ParticleSharding:
    """The ``psharding`` of ``mesh``: its axes' collectives."""
    return ParticleSharding(mesh, Axis(mesh.get_group(PARTICLE_AXIS),
                                       PARTICLE_AXIS),
                            Axis(mesh.get_group(DATA_AXIS), DATA_AXIS),
                            Axis(dist.group.WORLD, "world"))


def _is_ensemble(state: SMCState) -> bool:
    return state.gamma.dim() == 1


def shard_state(state: SMCState, mesh) -> SMCState:
    """A whole state (every rank holding the same one) becomes this rank's
    rows: ``particles`` and ``log_lik`` by the "particles" axis (and an
    ensemble's fields by the "data" axis); the rest is kept."""
    psh = as_sharding(mesh)
    ens = _is_ensemble(state)
    n, d = state.particles.shape[-2], state.gamma.shape[0] if ens else 0
    if n % psh.particles.size or (ens and d % psh.data.size):
        raise ValueError(f"{n} particles (or {d} populations) do not "
                         f"divide over the mesh")
    return state.replace(**{
        f.name: getattr(state, f.name)[
            psh.field_index(f.name, ens, n, d)].contiguous()
        for f in dataclasses.fields(state) if f.name != "key"})


def gather_state(state: SMCState, mesh) -> SMCState:
    """The whole state from every rank's rows (the counterpart of
    ``np.asarray`` on a JAX global array): a collective, so every rank
    calls it, and every rank gets the whole state."""
    psh = as_sharding(mesh)
    ens = _is_ensemble(state)

    def whole(name, t):
        if name in ("particles", "log_lik"):
            ax = 1 if ens else 0
            g = psh.particles.gather(t)               # (S, ...)
            t = torch.cat(list(g.unbind(0)), dim=ax)
        if ens:
            t = torch.cat(list(psh.data.gather(t).unbind(0)), dim=0)
        return t
    return state.replace(**{
        f.name: whole(f.name, getattr(state, f.name))
        for f in dataclasses.fields(state) if f.name != "key"})


def run_smc_sharded(model, cfg: SMCConfig, key, mesh,
                    on_device: bool = False, verbose: bool = True
                    ) -> SMCState:
    """A whole SMC run with the particle axis split over ``mesh``'s
    "particles" axis; returns this rank's rows of the final state
    (:func:`gather_state` for the whole). The particle count must divide
    by that axis's size. ``key`` is an int seed (the same on every rank)
    or a ``Draws``."""
    from smc_tpu_torch.smc.driver import (init_state, run_smc,
                                          run_smc_on_device)
    psh = particle_sharding(mesh)
    n_shards = psh.particles.size
    if cfg.n_particles % n_shards != 0:
        raise ValueError(
            f"n_particles={cfg.n_particles} not divisible by particle-axis "
            f"size {n_shards}")
    state = init_state(key, model, cfg, psharding=psh)
    if on_device:
        return run_smc_on_device(model, cfg, key, state=state, psharding=psh)
    return run_smc(model, cfg, key, state=state, verbose=verbose,
                   psharding=psh)

"""Cross-rank resampling with every collective written out (PyTorch port
of ``smc_tpu.parallel.resample_shmap``).

Each function takes this rank's rows of the weights, particles and
log-likelihoods, the shared U[0, 1) offset ``v0`` (the same draw on every
rank) and the mesh (or its ``ParticleSharding``), and returns this rank's
rows of the result:

- the counts are the one-device kernel's, bit for bit: the residual prefix
  sums run in exact int64, lifted to global sums by exclusive shard
  offsets from one all-gather of the shard totals, and the quantization
  repair lands on the global first-max particle
  (``smc.kernels._rs_counts_offsets``); scalar-sized collectives only;
- :func:`resample_sharded` all-gathers the int32 slot offsets (4N bytes),
  runs the merge kernel (``csrc/merge.cu``) on the global offsets, takes
  this rank's window of slots and all-gathers the (N/S, d + 1) bundle of
  particles and log-likelihoods: O(N) traffic and memory per rank;
- :func:`resample_sharded_ring` fills its slots from its own block, then
  from blocks passed around the ring both ways: O(N/S) per round.

Both give ``take(particles, ancestors)`` of the one-device kernel with the
same ``v0``, bit for bit.
"""
from __future__ import annotations

import torch

from smc_tpu_torch.ops.resample_cuda import sorted_offsets_to_ancestors
from smc_tpu_torch.parallel.mesh import as_sharding
from smc_tpu_torch.smc.kernels import (_rs_counts_offsets, _shard_scan,
                                       resample_counts, split_bundle,
                                       take_rows)


def _bundle(particles: torch.Tensor, log_lik: torch.Tensor) -> torch.Tensor:
    return torch.cat([particles, log_lik[..., None]], dim=-1)


def _concat_ranks(g: torch.Tensor, axis: int) -> torch.Tensor:
    """Every rank's block (the leading axis of an all-gather) laid end to
    end along ``axis`` of the blocks."""
    return torch.cat(list(g.unbind(0)), dim=axis)


def resample_counts_sharded(v0: torch.Tensor, weights: torch.Tensor, mesh
                            ) -> torch.Tensor:
    """This rank's residual-systematic offspring counts of weights split
    over the mesh's "particles" axis; bitwise equal to the one-device
    counts. Kept apart so large-N tests can check counts without moving
    particles."""
    return _rs_counts_offsets(v0, weights, as_sharding(mesh))[0]


def resample_counts_sharded_fn(n: int, mesh=None):
    """``(v0, w_local) -> counts_local``: the per-rank body of
    :func:`resample_counts_sharded` for a global length ``n`` (the JAX
    package's shard_map body)."""
    psh = as_sharding(mesh)

    def counts_local(v0, w_l):
        if psh.n_global(w_l.shape[-1]) != n:
            raise ValueError(f"local rows {w_l.shape[-1]} x "
                             f"{psh.particles.size} ranks != {n}")
        return _rs_counts_offsets(v0, w_l, psh)[0]
    return counts_local


def _apply_offsets(offsets: torch.Tensor, particles: torch.Tensor,
                          log_lik: torch.Tensor, psh):
    """This rank's rows after resampling by the global slot ``offsets`` of
    its particles ((n,) or an ensemble's (D, n), int32): all-gather the
    offsets, the merge kernel on the global ladder, this rank's window of
    ancestors, all-gather the bundle, one row gather."""
    ax = psh.particles
    n_l = offsets.shape[-1]
    every = _concat_ranks(ax.gather(offsets), -1).contiguous()
    anc = sorted_offsets_to_ancestors(every)[..., ax.rank * n_l:
                                             (ax.rank + 1) * n_l]
    bundle = _concat_ranks(ax.gather(_bundle(particles, log_lik)), -2)
    return split_bundle(take_rows(anc, bundle))


def _offsets_of(counts: torch.Tensor, psh) -> torch.Tensor:
    """Global slot offsets of this rank's particles from their counts: the
    local exclusive prefix sum plus the counts of the earlier ranks."""
    csum = torch.cumsum(counts.to(torch.int64), -1)
    off = _shard_scan(csum[..., -1:], psh)[0]
    return (csum - counts + off).to(torch.int32)


def resample_apply_sharded(u: torch.Tensor, weights: torch.Tensor,
                           particles: torch.Tensor, log_lik: torch.Tensor,
                           scheme: str, mesh):
    """Resample this rank's rows by ``scheme`` (its uniforms ``u``: the
    shared ``v0``, or all N per-slot uniforms) through the all-gather
    form, as ``kernels.resample_apply`` does on one device."""
    psh = as_sharding(mesh)
    if scheme == "residual_systematic":
        offsets = _rs_counts_offsets(u, weights, psh)[1]
    else:
        offsets = _offsets_of(resample_counts(u, weights, scheme, psh), psh)
    return _apply_offsets(offsets, particles, log_lik, psh)


def resample_sharded(v0: torch.Tensor, weights: torch.Tensor,
                     particles: torch.Tensor, log_lik: torch.Tensor, mesh):
    """Residual-systematic resampling of rows split over the mesh's
    "particles" axis: ``weights``/``log_lik`` (n,) and ``particles``
    (n, d) are this rank's rows; returns this rank's rows of
    ``(particles', log_lik')``. Every rank receives every particle (the
    all-gather of the bundle), the simple form; the scalable one is
    :func:`resample_sharded_ring`."""
    psh = as_sharding(mesh)
    offsets = _rs_counts_offsets(v0, weights, psh)[1]
    return _apply_offsets(offsets, particles, log_lik, psh)


def _fill(out, filled, block, slots):
    """Fill the unfilled ``slots`` this rank owns from one block of
    particles: ``block`` is (n, d + 3), the bundle then the block's slot
    starts and counts as int32 bits. The owner of slot k is the last j
    with start_j <= k (zero-count particles share a start with their
    successor, and every j past the owner starts after k), and it owns k
    when k < start_j + count_j. Only unfilled slots are written, so a
    round that finds nothing new changes no bit."""
    n = block.shape[0]
    starts = block[:, -2].contiguous().view(torch.int32)
    counts = block[:, -1].contiguous().view(torch.int32)
    j = torch.searchsorted(starts, slots, right=True) - 1
    jc = torch.clamp(j, 0, n - 1)
    ok = (j >= 0) & (starts[jc] <= slots) & (slots < starts[jc] + counts[jc])
    take = ok & ~filled
    out = torch.where(take[:, None], block[jc, :-2], out)
    return out, filled | ok


def resample_sharded_ring(v0: torch.Tensor, weights: torch.Tensor,
                          particles: torch.Tensor, log_lik: torch.Tensor,
                          mesh):
    """The O(N/S)-traffic form of :func:`resample_sharded`: the
    residual-systematic slot starts are nondecreasing in the global
    particle id, so the ancestors of a rank's contiguous slots form a
    contiguous id range, nearly always its own block and a neighbour's.

    Each rank fills its n = N/S slots from its own block (``searchsorted``
    over the block's slot starts, no communication), then, while any rank
    has unfilled slots, passes two block-sized buffers around the ring, one
    forward and one backward, and fills from both: round r covers blocks
    s - r .. s + r, so at most ceil((S - 1) / 2) rounds. The round count
    comes from an all-reduced count of the unfilled slots, the same on
    every rank. Inside a CUDA graph capture the host cannot read that
    count, so the fixed ceil((S - 1) / 2) rounds run instead; a fill only
    writes unfilled slots, so the extra rounds change no bit.

    Per round each rank sends two blocks, 2 n (d + 3) 4 bytes."""
    psh = as_sharding(mesh)
    ax = psh.particles
    n_l = weights.shape[-1]
    counts, starts = _rs_counts_offsets(v0, weights, psh)
    slots = ax.rank * n_l + torch.arange(n_l, dtype=torch.int32,
                                         device=weights.device)
    block = torch.cat([_bundle(particles, log_lik),
                       starts.view(torch.float32)[:, None],
                       counts.view(torch.float32)[:, None]], dim=-1)
    out = torch.zeros_like(block[:, :-2])
    filled = torch.zeros(n_l, dtype=torch.bool, device=weights.device)
    out, filled = _fill(out, filled, block, slots)
    fwd = bwd = block
    capturing = weights.is_cuda and torch.cuda.is_current_stream_capturing()
    rounds = 0
    while True:
        if capturing:
            if rounds >= ax.size // 2:
                break
        else:
            missing = ax.sum(torch.sum(~filled).reshape(1))
            if int(missing.item()) == 0:
                break
        fwd, bwd = ax.exchange(fwd, bwd)
        out, filled = _fill(out, filled, fwd, slots)
        out, filled = _fill(out, filled, bwd, slots)
        rounds += 1
    return split_bundle(out)

"""Core SMC kernels: adaptive tempering, resampling, and the three
mutation kinds (random-walk Metropolis, preconditioned MALA and HMC);
PyTorch port of ``smc_tpu.smc.kernels``.

Every function takes and returns tensors on the run's device and never waits
for it, except the mutation loop, which reads one flag per sweep after the
first. Nothing here copies from the host to the device, so every piece can
be captured in a CUDA graph (smc/graphs.py), the gradient kinds' backward
passes included. On CUDA the
gamma ladder runs on ``csrc/ladder.cu``, the ancestor build on
``csrc/merge.cu``, and the likelihood wherever the model puts it.

Every function also takes an ensemble: D independent populations on a
leading axis (particles (D, N, d), log_lik (D, N), one gamma, offset draw,
step ratio and stop latch per population, (D,)). Nothing loops over D: the
reductions run along the particle axis, the two kernels take the axis in
their grids, and the bundle gather is one flat ``index_select``. The JAX
package gets the same from ``jax.vmap`` of the single-population functions.

A run sharded over several processes (parallel/mesh.py) passes its
``psharding`` (``psh``): then each function holds this rank's rows, every
reduction over the particle axis is completed by a collective of
``psh.particles``, and N is the global particle count. With ``psh`` None
nothing changes.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from smc_tpu_torch.config import SMCConfig
from smc_tpu_torch.ops.ladder_cuda import ladder_stats
from smc_tpu_torch.ops.resample_cuda import sorted_offsets_to_ancestors
from smc_tpu_torch.priors import Prior
from smc_tpu_torch.smc import graphs


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx] for an index tensor with x's leading dimensions (0-d for
    one population), without reading idx on the host."""
    return x.gather(-1, idx[..., None])[..., 0]


def _over(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-population value with trailing singleton axes, so it
    broadcasts against ``like``'s per-particle axes."""
    return x.reshape(x.shape + (1,) * (like.dim() - x.dim()))


def _n_global(n_local: int, psh) -> int:
    return n_local if psh is None else psh.n_global(n_local)


def _psum(x: torch.Tensor, psh) -> torch.Tensor:
    """``x`` summed over the particle axis's ranks (itself unsharded)."""
    return x if psh is None else psh.particles.sum(x)


# --------------------------------------------------------------------------
# Adaptive tempering (gamma search)
# --------------------------------------------------------------------------
class GammaResult(NamedTuple):
    # Shapes for one population; an ensemble adds a leading D to each.
    gamma: torch.Tensor        # () new tempering exponent
    weights: torch.Tensor      # (N,) normalized incremental weights
    ess: torch.Tensor          # () normalized ESS of the chosen candidate
    n_reductions: torch.Tensor  # () int32 shrink iterations used
    max_log_lik: torch.Tensor  # ()
    # log((1/N) sum_i exp(dgamma * ll_i)): this step's increment of the
    # log-evidence estimate, dgamma*max_ll + log(s1/N).
    log_z_inc: torch.Tensor    # ()


def find_gamma(log_lik: torch.Tensor, gamma_old: torch.Tensor,
               cfg: SMCConfig, psh=None) -> GammaResult:
    """ESS-controlled tempering-exponent search for log_lik (N,) with
    gamma_old (), or for an ensemble's (D, N) with (D,).

    The candidates gamma_k = gamma_old + (gamma0 - gamma_old) * rate^k,
    k = 0..gamma_reduction_iters, with gamma0 = min(gamma_old +
    d_gamma_max, 1), are all known up front; their weight sums come from one
    ladder pass (ops/ladder_cuda.py) and the first candidate whose
    normalized ESS exceeds ``ess_limit`` wins (the last one if none does).
    Sharded (``psh``): the max, the ladder's local sums and the weights'
    normalizer are completed across the ranks, so every rank picks the
    same gamma.
    """
    n = _n_global(log_lik.shape[-1], psh)
    max_ll = torch.amax(log_lik, dim=-1)
    if psh is not None:
        max_ll = psh.particles.max(max_ll)
    d_ll = log_lik - max_ll[..., None]          # <= 0; exp never overflows
    gamma0 = torch.clamp_max(gamma_old + cfg.d_gamma_max, 1.0)
    ks = torch.arange(cfg.gamma_reduction_iters + 1, device=log_lik.device)
    gammas = gamma_old[..., None] + (gamma0 - gamma_old)[..., None] \
        * torch.pow(cfg.gamma_reduction_rate, ks.to(d_ll.dtype))
    n_cand = gammas.shape[-1]

    s1, s2 = ladder_stats(d_ll.contiguous(),
                          (gammas - gamma_old[..., None]).contiguous())
    if psh is not None:
        s1, s2 = psh.particles.sum(torch.stack([s1, s2])).unbind(0)
    ess_all = (s1 * s1 / (s2 * n)).to(d_ll.dtype)
    ok = ess_all > cfg.ess_limit
    # argmax of the int cast picks the FIRST passing candidate.
    idx = torch.where(ok.any(dim=-1), torch.argmax(ok.to(torch.int32), dim=-1),
                      torch.full_like(ks[0], n_cand - 1))
    gamma = _take(gammas, idx)
    dg = gamma - gamma_old
    weights = torch.exp(d_ll * dg[..., None])
    log_z = dg * max_ll + torch.log(_take(s1, idx) / n)
    weights = weights / _psum(torch.sum(weights, dim=-1, keepdim=True), psh)
    return GammaResult(gamma, weights, _take(ess_all, idx),
                       idx.to(torch.int32), max_ll, log_z.to(d_ll.dtype))


# --------------------------------------------------------------------------
# Residual-systematic resampling
# --------------------------------------------------------------------------
# The residual prefix sum runs in exact integer arithmetic: residuals are
# quantized to q = floor(resid * 2^QBITS) (every fp32 in [0.5, 1) is already
# a multiple of 2^-24, so this is near-lossless) and summed in int64, which
# cannot overflow at any N a device holds. Integer addition is associative,
# so the counts do not depend on how the sum is laid out. The JAX package
# splits q into int32 chunks for the same exact sum; the results are
# bitwise equal.
_QBITS = 24


def _shard_scan(local_totals: torch.Tensor, psh):
    """``(offset, total, gathered)`` of per-rank totals ``local_totals``
    (..., k) from one all-gather: this rank's exclusive offset, the global
    total, and every rank's totals (S, ..., k). The offset is added up
    rank by rank in rank order, so the offset rank r + 1 starts at is, bit
    for bit, the end rank r computes for itself."""
    g = psh.particles.gather(local_totals)        # (S, ..., k)
    off = torch.zeros_like(local_totals)
    for r in range(psh.particles.rank):
        off = off + g[r]
    total = off
    for r in range(psh.particles.rank, psh.particles.size):
        total = total + g[r]
    return off, total, g


def _max_owner(weights: torch.Tensor, psh, gathered_bits=None):
    """Where the global first max weight lies: ``(here, before)``, bools
    with the population shape: on this rank, or on an earlier one. The
    owner is the lowest rank holding the global max (the fp32 bits of
    non-negative weights order as their int32 values)."""
    if gathered_bits is None:
        bits = torch.amax(weights, dim=-1).view(torch.int32).to(torch.int64)
        gathered_bits = psh.particles.gather(bits)
    owner = torch.argmax(gathered_bits, dim=0)     # first max rank
    rank = psh.particles.rank
    return owner == rank, owner < rank


def _rs_counts_offsets(v0: torch.Tensor, weights: torch.Tensor, psh=None):
    """Offspring counts of residual-systematic resampling and their
    exclusive prefix sum (the output slot offsets), both int32, (N,) or for
    an ensemble (D, N).

    ``v0`` (one U[0, 1) draw per population: 0-d, or (D,)) places the
    systematic grid {v0 + k}. The grid points at or below the residual
    prefix sum are (csum + 2^QBITS - v0q) >> QBITS; the offsets telescope
    from the two prefix sums without a third. The quantization remainder
    (the total off N by one or two) goes to the max-weight particle, never
    driving a count negative.

    Sharded (``psh``): ``weights`` are this rank's rows, N is global, and
    the offsets are global slots. Each int64 prefix sum gets this rank's
    exclusive shard offset (one all-gather of the shard totals and max
    weights), so the counts are the one-device counts bit for bit; the
    repair goes to the global first-max particle, on the lowest rank that
    holds the global max, and the offsets after it shift by what it
    applied (one all-reduce).
    """
    n_l = weights.shape[-1]
    n = _n_global(n_l, psh)
    scaled = weights * n
    det = torch.floor(scaled)
    resid = scaled - det                          # [0, 1), exact fp32
    v0q = torch.floor(v0 * (1 << _QBITS)).to(torch.int64)
    q = torch.floor(resid * (1 << _QBITS)).to(torch.int64)
    det_i = det.to(torch.int64)
    det_csum = torch.cumsum(det_i, -1)
    q_csum = torch.cumsum(q, -1)
    bias = ((1 << _QBITS) - v0q)[..., None]       # in [1, 2^QBITS]
    grid_start = bias >> _QBITS                   # grid below cumsum 0
    fix = torch.argmax(weights, dim=-1, keepdim=True)          # first max
    pos = torch.arange(n_l, device=weights.device)
    first, det_tot, q_tot = grid_start, det_csum[..., -1:], q_csum[..., -1:]
    at, after = pos == fix, pos > fix
    if psh is not None:
        bits = torch.amax(weights, dim=-1).view(torch.int32).to(torch.int64)
        off, tot, g = _shard_scan(torch.stack(
            [det_csum[..., -1], q_csum[..., -1], bits], dim=-1), psh)
        here, before = (f[..., None] for f in
                        _max_owner(weights, psh, g[..., 2]))
        det_csum = det_csum + off[..., 0:1]
        q_csum = q_csum + off[..., 1:2]
        first = (off[..., 1:2] + bias) >> _QBITS  # grid below this start
        det_tot, q_tot = tot[..., 0:1], tot[..., 1:2]
        at, after = here & at, before | (here & after)
    grid_below = (q_csum + bias) >> _QBITS
    prev = torch.cat([first, grid_below[..., :-1]], dim=-1)
    counts = det_i + grid_below - prev
    total = det_tot + ((q_tot + bias) >> _QBITS) - grid_start
    at_fix = counts.gather(-1, fix)
    if psh is not None:           # from the rank that holds the global max
        at_fix = psh.particles.sum(torch.where(here, at_fix, 0))
    applied = torch.maximum(n - total, -at_fix)
    counts = counts + torch.where(at, applied, 0)
    offsets = (det_csum - det_i) + (prev - grid_start)
    offsets = offsets + torch.where(after, applied, 0)
    return counts.to(torch.int32), offsets.to(torch.int32)


def residual_systematic_counts(v0: torch.Tensor, weights: torch.Tensor,
                               psh=None) -> torch.Tensor:
    """Per-particle offspring counts (N,) int32 (per population) summing
    exactly to N:
    floor(N w_i) deterministic copies plus the residual mass resampled
    systematically from the single offset ``v0``."""
    return _rs_counts_offsets(v0, weights, psh)[0]


def residual_systematic_ancestors(v0: torch.Tensor,
                                  weights: torch.Tensor) -> torch.Tensor:
    """Ancestor index per output slot (N,) int32 (per population), sorted:
    all copies of particle i are contiguous, in i order."""
    return sorted_offsets_to_ancestors(_rs_counts_offsets(v0, weights)[1])


def _gather_bundle(anc: torch.Tensor, particles: torch.Tensor,
                   log_lik: torch.Tensor):
    """(particles, log_lik) indexed by the ancestors ``anc`` (N,) or (D, N):
    one row gather of the (N, d + 1) bundle, bitwise equal to indexing each
    array. An ensemble's population p indexes the flattened (D N, d + 1)
    bundle at ``anc + p N``."""
    return split_bundle(take_rows(
        anc, torch.cat([particles, log_lik[..., None]], dim=-1)))


def split_bundle(out: torch.Tensor):
    """(particles, log_lik) of a (..., d + 1) bundle."""
    return out[..., :-1], out[..., -1]


def take_rows(anc: torch.Tensor, bundle: torch.Tensor) -> torch.Tensor:
    """Rows ``anc`` (M,) or (D, M) of ``bundle`` (N, k) or (D, N, k): one
    ``index_select`` (population p's rows at ``anc + p N`` of the
    flattened bundle)."""
    anc = anc.long()
    if anc.dim() == 2:
        n_pop, n = bundle.shape[:2]
        base = torch.arange(n_pop, device=anc.device)[:, None] * n
        return bundle.reshape(n_pop * n, -1).index_select(
            0, (anc + base).reshape(-1)).reshape(anc.shape
                                                 + bundle.shape[-1:])
    return bundle.index_select(0, anc)


def residual_systematic_apply(v0: torch.Tensor, weights: torch.Tensor,
                              particles: torch.Tensor,
                              log_lik: torch.Tensor):
    """Resample (particles (N, d), log_lik (N,)) by residual-systematic
    ancestors: one ancestor build (csrc/merge.cu on CUDA) and one row
    gather of the (N, d + 1) bundle, bitwise equal to indexing each array
    with the ancestors. An ensemble ((D, N, d), (D, N), v0 (D,)) takes one
    build and one gather too."""
    return _gather_bundle(residual_systematic_ancestors(v0, weights),
                          particles, log_lik)


def counts_to_ancestors(counts: torch.Tensor) -> torch.Tensor:
    """Offspring counts (N,) or (D, N) -> ancestor index per output slot,
    int32, slot layout as above: the exclusive prefix sum of the counts is
    the offset ladder the merge kernel takes."""
    counts = counts.to(torch.int32)
    offsets = (torch.cumsum(counts, -1) - counts).to(torch.int32)
    return sorted_offsets_to_ancestors(offsets)


# --------------------------------------------------------------------------
# The other resampling schemes (variants; the reference's is
# residual-systematic)
# --------------------------------------------------------------------------
# Each takes its uniforms from the caller, one U[0, 1) draw per population
# (systematic) or one per output slot (stratified, multinomial), as the JAX
# package draws them from its key, and gives counts (N,) or (D, N) int32;
# counts_to_ancestors turns them into ancestors. Nothing reads the device
# from the host, so each runs inside a captured graph.


def _prefix_sums(weights: torch.Tensor, psh=None):
    """The weights' inclusive prefix sums, added in float64 and rounded once
    to the weights' type. An fp32 scan need not be monotone (the reference's
    XLA cumsum is not, nor PyTorch's on CUDA), and a dip makes a systematic
    count negative, so the counts no longer sum to N and the offsets leave
    [0, N]. Rounding a float64 sum of non-negative weights is monotone on
    every device. Where the fp32 sums are exact this gives their bits; else
    a count can differ from the reference's where a grid point or a uniform
    falls within rounding of a prefix sum.

    Returns ``(ends, prev)``: sharded, ``ends`` is this rank's part of the
    global sums (the local float64 sums plus the exclusive float64 shard
    offset) and ``prev`` the previous rank's last sum; ``prev`` is None
    on the first rank and unsharded."""
    local = torch.cumsum(weights.to(torch.float64), -1)
    if psh is None:
        return local.to(weights.dtype), None
    off, _, _ = _shard_scan(local[..., -1:], psh)
    prev = off.to(weights.dtype) if psh.particles.rank else None
    return (local + off).to(weights.dtype), prev


def _count_slots(anc: torch.Tensor, n: int,
                 src: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Counts (..., n) int32 of the slot indices ``anc`` (..., M), each
    slot adding its ``src`` (default 1): a scatter-add, which needs no host
    read (``bincount`` would)."""
    counts = torch.zeros(anc.shape[:-1] + (n,), dtype=torch.int32,
                         device=anc.device)
    if src is None:
        src = torch.ones(anc.shape, dtype=torch.int32, device=anc.device)
    return counts.scatter_add_(-1, anc, src)


def _repair_at_max(counts: torch.Tensor, weights: torch.Tensor, n: int,
                   psh) -> torch.Tensor:
    """The counts' shortfall from ``n`` added at the (first) max-weight
    particle, globally when sharded."""
    fix = torch.argmax(weights, dim=-1, keepdim=True)
    diff = n - _psum(torch.sum(counts, -1, keepdim=True, dtype=torch.int32),
                     psh)
    if psh is not None:
        diff = torch.where(_max_owner(weights, psh)[0][..., None], diff, 0)
    return counts.scatter_add(-1, fix, diff.to(torch.int32))


def systematic_counts(v0: torch.Tensor, weights: torch.Tensor, psh=None
                      ) -> torch.Tensor:
    """Plain systematic resampling: counts_j = #{k : v0 + k in (N C_{j-1},
    N C_j]}, from one shared offset ``v0`` per population (0-d or (D,)).
    The total's shortfall goes to the (first) max-weight particle."""
    n = _n_global(weights.shape[-1], psh)
    csum, prev = _prefix_sums(weights, psh)
    csum = csum * n
    below = torch.clamp_min(torch.floor(csum - v0[..., None]) + 1.0, 0.0)
    head = (torch.zeros_like(below[..., :1]) if prev is None else
            torch.clamp_min(torch.floor(prev * n - v0[..., None]) + 1.0,
                            0.0))
    counts = torch.diff(below, dim=-1, prepend=head).to(torch.int32)
    counts = _repair_at_max(counts, weights, n, psh)
    return torch.clamp_min(counts, 0)


def _inverse_cdf_counts(u: torch.Tensor, weights: torch.Tensor, psh=None
                        ) -> torch.Tensor:
    """Counts of the particles whose prefix-sum interval (C_{j-1}, C_j]
    holds each point of ``u`` (..., N): the first j with C_j >= u
    (``searchsorted``, left), capped at N - 1. Sharded, ``u`` holds every
    one of the N global points and each rank counts those that fall in
    its rows' intervals."""
    n_l = weights.shape[-1]
    ends, prev = _prefix_sums(weights, psh)
    j = torch.searchsorted(ends.contiguous(), u.contiguous())
    mine = None                                  # every point is here
    if psh is not None and psh.particles.rank < psh.particles.size - 1:
        mine = j < n_l                           # the last rank takes the cap
    if prev is not None:
        mine = u > prev if mine is None else mine & (u > prev)
    return _count_slots(torch.clamp_max(j, n_l - 1), n_l,
                        None if mine is None else mine.to(torch.int32))


def stratified_counts(u: torch.Tensor, weights: torch.Tensor, psh=None
                      ) -> torch.Tensor:
    """Stratified resampling: one uniform ``u`` (..., N) per output slot,
    placed in its own 1/N stratum, (k + u_k) / N."""
    n = u.shape[-1]
    k = torch.arange(n, dtype=u.dtype, device=u.device)
    # Divide by a device tensor: PyTorch's CUDA division by a host scalar
    # multiplies by its reciprocal, which is not IEEE division.
    points = (k + u) / torch.full((), n, dtype=u.dtype, device=u.device)
    return _inverse_cdf_counts(points, weights, psh)


def multinomial_counts(u: torch.Tensor, weights: torch.Tensor, psh=None
                       ) -> torch.Tensor:
    """Multinomial resampling (iid ancestors) from one uniform ``u``
    (..., N) per output slot."""
    return _inverse_cdf_counts(u, weights, psh)


_RESAMPLERS = {
    "residual_systematic": residual_systematic_counts,
    "systematic": systematic_counts,
    "stratified": stratified_counts,
    "multinomial": multinomial_counts,
}


def resample_counts(u: torch.Tensor, weights: torch.Tensor,
                    scheme: str = "residual_systematic", psh=None
                    ) -> torch.Tensor:
    """Offspring counts of ``scheme`` from its uniforms ``u``
    (:func:`resample_uniforms`); sharded, this rank's rows' counts."""
    try:
        fn = _RESAMPLERS[scheme]
    except KeyError:
        raise ValueError(f"unknown resampling scheme {scheme!r}; "
                         f"one of {sorted(_RESAMPLERS)}") from None
    return fn(u, weights, psh)


def resample_uniforms(draws, scheme: str, pop_shape: tuple,
                      n: int) -> torch.Tensor:
    """The uniforms one resampling of ``scheme`` takes from ``draws``: one
    per population (shape ``pop_shape``) for the systematic schemes, one per
    output slot (``pop_shape + (n,)``) for stratified and multinomial."""
    if scheme in ("residual_systematic", "systematic"):
        return draws.uniform(pop_shape, torch.float32)
    return draws.uniform(pop_shape + (n,), torch.float32)


def residual_systematic_resample(u: torch.Tensor, weights: torch.Tensor,
                                 scheme: str = "residual_systematic"
                                 ) -> torch.Tensor:
    """Ancestor indices (N,) or (D, N) int32 for the chosen resampling
    scheme (default: the reference's residual-systematic, Algorithm 2),
    from its uniforms ``u``."""
    if scheme == "residual_systematic":
        return residual_systematic_ancestors(u, weights)
    return counts_to_ancestors(resample_counts(u, weights, scheme))


def resample_apply(u: torch.Tensor, weights: torch.Tensor,
                   particles: torch.Tensor, log_lik: torch.Tensor,
                   scheme: str = "residual_systematic"):
    """Resample (particles, log_lik) by ``scheme``'s ancestors: the merge
    kernel and one bundle gather, whatever the scheme."""
    return _gather_bundle(residual_systematic_resample(u, weights, scheme),
                          particles, log_lik)


# --------------------------------------------------------------------------
# Adaptive random-walk Metropolis mutation
# --------------------------------------------------------------------------
class MutationResult(NamedTuple):
    particles: torch.Tensor
    log_lik: torch.Tensor
    n_steps: torch.Tensor   # () int32 sweeps executed
    accepted: torch.Tensor  # () particles that accepted >= once
    mh_ratio: torch.Tensor  # () final proposal step ratio


def _weighted_cov(x: torch.Tensor, cov_weight: torch.Tensor,
                  eps: float = 1e-10, psh=None) -> torch.Tensor:
    """Biased empirical covariance (np.cov(bias=True)) of x (N, d) times the
    elementwise cov_weight, plus a relative jitter for Cholesky stability;
    (D, d, d) for an ensemble's (D, N, d), by one batched matmul.
    Sharded: the global mean (the local means weighted by their share of
    N, summed across the ranks), then the local GEMM summed across the
    ranks; at one rank the unsharded bits."""
    n_l = x.shape[-2]
    n = _n_global(n_l, psh)
    mu = torch.mean(x, dim=-2, keepdim=True)
    if psh is not None:
        mu = psh.particles.sum(mu * (n_l / n))
    xc = x - mu
    cov = _psum(xc.transpose(-1, -2) @ xc, psh) / n
    cov = cov * cov_weight
    d = cov.shape[-1]
    trace = torch.sum(torch.diagonal(cov, dim1=-2, dim2=-1), dim=-1)
    jitter = eps * (1.0 + trace / d)
    return cov + jitter[..., None, None] * torch.eye(d, dtype=cov.dtype,
                                                     device=cov.device)


def _cholesky_or_nan(cov: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor without a host sync; NaN where the matrix is
    not positive definite (as JAX's factor is), so every proposal of a
    degenerate sweep is rejected instead of raising. In an ensemble's
    (D, d, d) one degenerate population goes NaN alone."""
    chol, info = torch.linalg.cholesky_ex(cov)
    return torch.where((info == 0)[..., None, None], chol, math.nan)


class MutationCarry(NamedTuple):
    """Cross-sweep state of the adaptive mutation loop. Shapes for one
    population; an ensemble adds a leading D to every tensor (populations
    stop after different sweeps)."""
    j: torch.Tensor         # () int32 sweeps executed so far
    key: object             # the run's Draws
    particles: torch.Tensor  # (N, d)
    log_lik: torch.Tensor   # (N,)
    log_prior: torch.Tensor  # (N,)
    grad: torch.Tensor      # (N, d) likelihood gradients; () zero for rwm
    r_ac: torch.Tensor      # (N,) bool accepted-at-least-once
    mh_ratio: torch.Tensor  # () proposal step ratio (halved when stalled)
    done: torch.Tensor      # () bool early-stop latch


def _method_of(loglik_fn) -> Optional[str]:
    """The likelihood's ``method`` (a model's, or the one a data likelihood
    carries), for error messages."""
    owner = getattr(loglik_fn, "__self__", loglik_fn)
    return getattr(owner, "method", None)


def check_differentiable(ll: torch.Tensor, loglik_fn) -> None:
    """Raise ValueError unless ``ll`` (``loglik_fn``'s output on a theta
    that requires grad) carries an autograd graph."""
    if not ll.requires_grad:
        method = _method_of(loglik_fn)
        raise ValueError(
            "the gradient mutations (mala, hmc) and MAP need a "
            "differentiable log-likelihood, and "
            + (f"method {method!r}" if method else "this one")
            + " carries no autograd graph: the CUDA likelihood kernels have "
            "no backward, as the JAX package's Pallas kernels have none; "
            "use method='exact' or 'rk4'")


def _make_ll_and_grad(loglik_fn):
    """``th -> (log_lik, grad)``: every particle's log-likelihood and its
    gradient from ONE backward pass of the row sum (rows are independent,
    so the gradient of the sum is each particle's own gradient).

    -inf rows get a zero cotangent and non-finite gradients are set to 0:
    a diverged row falls back to a gradient-free proposal and stays under
    the exact accept test. The pass runs under an explicit
    ``torch.enable_grad()`` on a copy of ``th`` that requires grad, so a
    caller under ``no_grad`` gets it too; the results carry no graph.

    A likelihood whose output carries no autograd graph raises: the CUDA
    kernels (``pallas_exact``, ``pallas``) have no backward, as the JAX
    package's Pallas kernels have none (there ``jax.grad`` fails to
    linearize). The plain path is never taken in their place.
    """
    def ll_and_grad(th):
        with torch.enable_grad():
            t = th.detach().requires_grad_(True)
            ll, _ = loglik_fn(t)
            check_differentiable(ll, loglik_fn)
            total = torch.sum(torch.where(torch.isfinite(ll), ll, 0.0))
            (g,) = torch.autograd.grad(total, t)
        return ll.detach(), torch.where(torch.isfinite(g), g, 0.0)
    return ll_and_grad


def _accept_into(accept, prop, lk2, lp2, g2, parts, lk1, lp1, g1):
    """The accepted rows' proposal, log-likelihood, log-prior (and, for the
    gradient kinds, gradient) over the current ones."""
    parts = torch.where(accept[..., None], prop, parts)
    lk1 = torch.where(accept, lk2, lk1)
    lp1 = torch.where(accept, lp2, lp1)
    if g2 is not None:
        g1 = torch.where(accept[..., None], g2, g1)
    return parts, lk1, lp1, g1, accept


def make_mutation_parts(kind: str, loglik_fn, prior: Prior, cfg: SMCConfig,
                        psh=None):
    """Split one adaptive sweep into ``(init_fn, draw_fn, core_fn, admin_fn,
    grad_fn)`` as the JAX package does, for ``kind`` "rwm", "mala" or
    "hmc" (``grad_fn`` is None for "rwm").

    - ``init_fn(key, particles, log_lik, g0=None) -> MutationCarry``: no
      likelihood evaluation for "rwm"; the gradient kinds compute the
      initial gradient (one forward and backward pass) unless ``g0`` is
      given (the block driver computes it in slabs with ``grad_fn``);
    - ``draw_fn(carry) -> (key, aux_g, aux_r)``: the per-sweep factors of
      the weighted empirical covariance (``(chol,)``; MALA ``(cov, chol,
      linv)``), then the sweep's draws ``(z, log_u)``, normals first;
    - ``core_fn(parts, lk1, lp1, g1, ratio, aux_g, aux_r, gamma)``:
      propose, evaluate, accept. Every output row depends on its own input
      rows and ``aux_g`` only, so the core may run on any slab of rows;
    - ``admin_fn(carry, key, parts, lk1, lp1, g1, accept, gamma)``: the
      accepted-at-least-once set, the early stop, and step-ratio halving;
    - ``grad_fn(particles) -> (N, d)`` likelihood gradients.

    A sweep of "mala" takes one forward and backward pass, of "hmc"
    ``cfg.hmc_leapfrog`` (``cfg.evals_per_sweep``). Sharded (``psh``), the
    covariance and the accepted count are completed across the ranks; the
    core needs no collective.
    """
    if kind not in ("rwm", "mala", "hmc"):
        raise ValueError(f"unknown mutation kind {kind!r}")
    ll_and_grad = _make_ll_and_grad(loglik_fn)
    grad_based = kind != "rwm"

    def init_fn(key, particles, log_lik, g0=None):
        dev = particles.device
        pops = particles.shape[:-2]            # () or (D,)

        def per_pop(v, dtype):
            return torch.full(pops, v, dtype=dtype, device=dev)
        if not grad_based:
            g0 = torch.zeros((), dtype=particles.dtype, device=dev)
        elif g0 is None:
            g0 = ll_and_grad(particles)[1]
        return MutationCarry(
            j=per_pop(0, torch.int32), key=key,
            particles=particles, log_lik=log_lik,
            log_prior=prior.log_pdf(particles), grad=g0,
            r_ac=torch.zeros(particles.shape[:-1], dtype=torch.bool,
                             device=dev),
            mh_ratio=per_pop(1, particles.dtype),
            done=per_pop(False, torch.bool))

    def admin_fn(c, key, parts, lk1, lp1, g1, accept, gamma):
        n = _n_global(parts.shape[-2], psh)
        r_th = torch.where(gamma >= 1.0, cfg.accept_threshold_final,
                           cfg.accept_threshold)
        r_ac = c.r_ac | accept
        acc_sum = _psum(torch.sum(r_ac, dim=-1), psh)
        done = acc_sum > r_th * n
        halve = ~done & (acc_sum < cfg.accept_threshold_min * n)
        ratio = torch.where(halve, c.mh_ratio * cfg.mh_ratio_decay,
                            c.mh_ratio)
        return MutationCarry(c.j + 1, key, parts, lk1, lp1, g1, r_ac,
                             ratio, done)

    def draw_fn(c):
        shape = tuple(c.particles.shape)
        d = shape[-1]
        cov_weight = cfg.cov_weight(d, c.particles.device).to(
            c.particles.dtype)
        cov = _weighted_cov(c.particles, cov_weight, psh=psh)
        chol = _cholesky_or_nan(cov)
        z = c.key.normal(shape, c.particles.dtype)
        log_u = torch.log(c.key.uniform(shape[:-1], c.particles.dtype))
        if kind != "mala":
            return c.key, (chol,), (z, log_u)
        # L^-1 once per sweep on the small (d, d): the reverse move's
        # whitening is then a plain matmul per particle.
        eye = torch.eye(d, dtype=chol.dtype, device=chol.device)
        linv = torch.linalg.solve_triangular(chol, eye.expand_as(chol),
                                             upper=False)
        return c.key, (cov, chol, linv), (z, log_u)

    def rwm_core(parts, lk1, lp1, g1, ratio, aux_g, aux_r, gamma):
        (chol,) = aux_g
        z, log_u = aux_r
        prop = parts + (z @ chol.transpose(-1, -2)) * _over(ratio, parts)
        in_sup = prior.in_support(prop)
        # Out-of-support proposals are replaced by the current particle
        # before evaluation (a numerical no-op that keeps shapes fixed).
        prop_eval = torch.where(in_sup[..., None], prop, parts)
        lk2, _ = loglik_fn(prop_eval)
        lp2 = prior.log_pdf(prop_eval)
        # The prior ratio is included: the correct tempered-posterior kernel
        # for any prior, identical to the likelihood-only rule for uniform
        # priors.
        log_acc = (lk2 - lk1) * _over(gamma, lk1) + (lp2 - lp1)
        accept = in_sup & (log_acc >= log_u) & torch.isfinite(lk2)
        return _accept_into(accept, prop_eval, lk2, lp2, None,
                            parts, lk1, lp1, g1)

    def mala_core(parts, lk1, lp1, g1, ratio, aux_g, aux_r, gamma):
        # theta' = theta + (eps^2 / 2) gamma grad_ll(theta) @ S + eps z L^T
        # with S = L L^T; the accept adds log q(theta | theta') -
        # log q(theta' | theta), the forward term being -|z|^2 / 2.
        cov, chol, linv = aux_g
        z, log_u = aux_r
        half_e2 = _over(0.5 * ratio * ratio * gamma, parts)
        prop = (parts + half_e2 * (g1 @ cov)
                + (z @ chol.transpose(-1, -2)) * _over(ratio, parts))
        in_sup = prior.in_support(prop)
        prop_eval = torch.where(in_sup[..., None], prop, parts)
        lk2, g2 = ll_and_grad(prop_eval)
        lp2 = prior.log_pdf(prop_eval)
        # The reverse move's residual, whitened by L^-1.
        u = parts - prop_eval - half_e2 * (g2 @ cov)
        v = u @ linv.transpose(-1, -2)
        log_q_rev = (-0.5 * torch.sum(v * v, dim=-1)
                     / _over(ratio * ratio, lk1))
        log_q_fwd = -0.5 * torch.sum(z * z, dim=-1)
        log_acc = ((lk2 - lk1) * _over(gamma, lk1) + (lp2 - lp1)
                   + log_q_rev - log_q_fwd)
        accept = in_sup & (log_acc >= log_u) & torch.isfinite(lk2)
        return _accept_into(accept, prop_eval, lk2, lp2, g2,
                            parts, lk1, lp1, g1)

    def hmc_core(parts, lk1, lp1, g1, eps, aux_g, aux_r, gamma):
        # Leapfrog in whitened coordinates (identity mass; S = L L^T):
        # half kick, (n_leap - 1) x (drift, full kick), drift, half kick.
        # Each drift is one likelihood and gradient; the accept takes the
        # full target ratio and the kinetic-energy difference.
        (chol,) = aux_g
        z, log_u = aux_r
        n_leap = cfg.hmc_leapfrog
        p = z + _over(0.5 * eps * gamma, parts) * (g1 @ chol)
        th, lk2, g2 = parts, lk1, g1
        for k in range(n_leap):
            th = th + _over(eps, parts) * (p @ chol.transpose(-1, -2))
            lk2, g2 = ll_and_grad(th)
            kick = _over(gamma, parts) * (g2 @ chol)
            w = 1.0 if k < n_leap - 1 else 0.5
            p = p + _over(w * eps, parts) * kick
        in_sup = prior.in_support(th)
        lp2 = prior.log_pdf(th)
        log_acc = ((lk2 - lk1) * _over(gamma, lk1) + (lp2 - lp1)
                   - 0.5 * (torch.sum(p * p, dim=-1)
                            - torch.sum(z * z, dim=-1)))
        accept = (in_sup & (log_acc >= log_u) & torch.isfinite(lk2)
                  & torch.isfinite(th).all(dim=-1))
        return _accept_into(accept, th, lk2, lp2, g2, parts, lk1, lp1, g1)

    core_fn = {"rwm": rwm_core, "mala": mala_core, "hmc": hmc_core}[kind]
    grad_fn = (lambda p: ll_and_grad(p)[1]) if grad_based else None
    return init_fn, draw_fn, core_fn, admin_fn, grad_fn


def make_mutation_sweeper(kind: str, loglik_fn, prior: Prior,
                          cfg: SMCConfig, psh=None):
    """``(init_fn, sweep_fn)``: ``sweep_fn(carry, gamma) -> carry`` runs ONE
    sweep (draws, proposal, ``cfg.evals_per_sweep`` likelihood
    evaluations, accept, controller update), composed from
    :func:`make_mutation_parts`.

    For an ensemble, ``sweep_fn(carry, gamma, active)`` takes a bool (D,)
    mask: every population is swept (one batched likelihood), and those
    with ``active[p]`` False keep their old carry (their gradients
    too)."""
    init_fn, draw_fn, core_fn, admin_fn, _ = make_mutation_parts(
        kind, loglik_fn, prior, cfg, psh)

    def sweep_fn(c, gamma, active=None):
        key, aux_g, aux_r = draw_fn(c)
        parts, lk1, lp1, g1, accept = core_fn(
            c.particles, c.log_lik, c.log_prior, c.grad, c.mh_ratio,
            aux_g, aux_r, gamma)
        new = admin_fn(c, key, parts, lk1, lp1, g1, accept, gamma)
        if active is None:
            return new
        return MutationCarry(*(
            n if f == "key" or n.dim() == 0
            else torch.where(_over(active, n), n, o)
            for f, o, n in zip(MutationCarry._fields, c, new)))

    return init_fn, sweep_fn


def sweep_limit(gamma: torch.Tensor, cfg: SMCConfig) -> torch.Tensor:
    """A step's sweep limit, chosen on the device: ``mh_steps``, or
    ``mh_steps_final`` where gamma == 1."""
    return torch.where(gamma >= 1.0, cfg.mh_steps_final, cfg.mh_steps)


def make_sweep_loop_pieces(kind: str, loglik_fn, prior: Prior,
                           cfg: SMCConfig, psh=None):
    """``(mut_init, mut_sweep)``: one population's adaptive loop cut where
    the host reads.

    - ``mut_init(key, particles, log_lik, gamma, n_mh) -> (carry, more)``:
      the carry and the first sweep, which needs no read;
    - ``mut_sweep(carry, gamma, n_mh) -> (carry, more)``: one more sweep.

    ``more`` is the device flag "another sweep is due": fewer than
    ``n_mh`` sweeps so far and no early stop."""
    init_fn, sweep_fn = make_mutation_sweeper(kind, loglik_fn, prior, cfg,
                                              psh)

    def mut_sweep(c, gamma, n_mh):
        c = sweep_fn(c, gamma)
        return c, (c.j < n_mh) & ~c.done

    def mut_init(key, particles, log_lik, gamma, n_mh):
        return mut_sweep(init_fn(key, particles, log_lik), gamma, n_mh)

    return mut_init, mut_sweep


def sweep_until_done(c, more, mut_sweep, poll=None):
    """The host side of the adaptive loop: while the flag the last sweep
    wrote says another sweep is due, ``poll()`` (when given; it may raise)
    and ``c, more = mut_sweep(c)``. One host read per sweep after the
    first."""
    while graphs.read(more, "sweep"):
        if poll is not None:
            poll()
        c, more = mut_sweep(c)
    return c


def mutation_result(c: MutationCarry, psh=None) -> MutationResult:
    """The loop's result from its last carry (per population for an
    ensemble's); sharded, the accepted count is the global one."""
    return MutationResult(c.particles, c.log_lik, c.j,
                          _psum(torch.sum(c.r_ac, dim=-1), psh), c.mh_ratio)


def _run_sweeps(kind: str, key, particles, log_lik, gamma, loglik_fn,
                prior: Prior, cfg: SMCConfig) -> MutationResult:
    """The adaptive sweep loop of ``kind``: up to ``mh_steps`` sweeps
    (``mh_steps_final`` at gamma == 1), one host read after each sweep but
    the first."""
    n_mh = sweep_limit(gamma, cfg)
    mut_init, mut_sweep = make_sweep_loop_pieces(kind, loglik_fn, prior,
                                                 cfg)
    c = sweep_until_done(*mut_init(key, particles, log_lik, gamma, n_mh),
                         lambda c: mut_sweep(c, gamma, n_mh))
    return mutation_result(c)


def mh_mutation(key, particles: torch.Tensor, log_lik: torch.Tensor,
                gamma: torch.Tensor,
                loglik_fn: Callable[[torch.Tensor], tuple],
                prior: Prior, cfg: SMCConfig) -> MutationResult:
    """Adaptive random-walk Metropolis sweeps: up to ``mh_steps`` sweeps
    (``mh_steps_final`` at gamma == 1), stopping early once the
    accepted-at-least-once fraction passes the threshold. Per sweep: the
    proposal covariance is the weighted empirical particle covariance,
    recomputed every sweep; proposal = particles + N(0, cov) * mh_ratio;
    out-of-support proposals are replaced by the current particle; accept
    iff (lk2 - lk1) * gamma + (lp2 - lp1) >= log U. ``key`` is the run's
    ``Draws``."""
    return _run_sweeps("rwm", key, particles, log_lik, gamma, loglik_fn,
                       prior, cfg)


def mala_mutation(key, particles: torch.Tensor, log_lik: torch.Tensor,
                  gamma: torch.Tensor,
                  loglik_fn: Callable[[torch.Tensor], tuple],
                  prior: Prior, cfg: SMCConfig) -> MutationResult:
    """Preconditioned Metropolis-adjusted Langevin sweeps, with the
    controller of :func:`mh_mutation`. With S = cov(particles) *
    cov_weight = L L^T and step ratio eps the proposal is

        theta' = theta + (eps^2 / 2) gamma grad_ll(theta) @ S + eps z @ L^T

    and the accept adds log q(theta | theta') - log q(theta' | theta) to
    (lk2 - lk1) gamma + (lp2 - lp1). Needs a differentiable ``loglik_fn``
    (torch.autograd); each sweep takes one forward and backward pass."""
    return _run_sweeps("mala", key, particles, log_lik, gamma, loglik_fn,
                       prior, cfg)


def hmc_mutation(key, particles: torch.Tensor, log_lik: torch.Tensor,
                 gamma: torch.Tensor,
                 loglik_fn: Callable[[torch.Tensor], tuple],
                 prior: Prior, cfg: SMCConfig) -> MutationResult:
    """Preconditioned Hamiltonian sweeps, with the controller of
    :func:`mh_mutation`: each proposal is ``cfg.hmc_leapfrog`` leapfrog
    steps of the tempered-likelihood dynamics in whitened coordinates
    (positions move by eps p @ L^T, kicks are eps gamma grad @ L), accepted
    on the full target ratio minus the kinetic-energy difference; an
    out-of-support or non-finite end point is rejected. Each sweep takes
    ``hmc_leapfrog`` forward and backward passes."""
    return _run_sweeps("hmc", key, particles, log_lik, gamma, loglik_fn,
                       prior, cfg)


_MUTATION_KERNELS = {"rwm": mh_mutation, "mala": mala_mutation,
                     "hmc": hmc_mutation}


def mutate(key, particles: torch.Tensor, log_lik: torch.Tensor,
           gamma: torch.Tensor, loglik_fn, prior: Prior,
           cfg: SMCConfig) -> MutationResult:
    """Dispatch to the configured mutation kernel (cfg.mutation)."""
    return _MUTATION_KERNELS[cfg.mutation](key, particles, log_lik, gamma,
                                           loglik_fn, prior, cfg)

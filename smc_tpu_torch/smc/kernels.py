"""Core SMC kernels: adaptive tempering, resampling, RW-MH mutation
(PyTorch port of the main-path parts of ``smc_tpu.smc.kernels``).

Every function takes and returns tensors on the run's device and never waits
for it, except the mutation loop, which reads one flag per sweep. On CUDA the
gamma ladder runs on ``csrc/ladder.cu``, the ancestor build on
``csrc/merge.cu``, and the likelihood wherever the model puts it.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from smc_tpu_torch.config import SMCConfig
from smc_tpu_torch.ops.ladder_cuda import ladder_stats
from smc_tpu_torch.ops.resample_cuda import sorted_offsets_to_ancestors
from smc_tpu_torch.priors import Prior


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] for a 0-d index tensor, without reading idx on the host."""
    return x.gather(0, idx.reshape(1))[0]


# --------------------------------------------------------------------------
# Adaptive tempering (gamma search)
# --------------------------------------------------------------------------
class GammaResult(NamedTuple):
    gamma: torch.Tensor        # () new tempering exponent
    weights: torch.Tensor      # (N,) normalized incremental weights
    ess: torch.Tensor          # () normalized ESS of the chosen candidate
    n_reductions: torch.Tensor  # () int32 shrink iterations used
    max_log_lik: torch.Tensor  # ()
    # log((1/N) sum_i exp(dgamma * ll_i)): this step's increment of the
    # log-evidence estimate, dgamma*max_ll + log(s1/N).
    log_z_inc: torch.Tensor    # ()


def find_gamma(log_lik: torch.Tensor, gamma_old: torch.Tensor,
               cfg: SMCConfig) -> GammaResult:
    """ESS-controlled tempering-exponent search.

    The candidates gamma_k = gamma_old + (gamma0 - gamma_old) * rate^k,
    k = 0..gamma_reduction_iters, with gamma0 = min(gamma_old +
    d_gamma_max, 1), are all known up front; their weight sums come from one
    ladder pass (ops/ladder_cuda.py) and the first candidate whose
    normalized ESS exceeds ``ess_limit`` wins (the last one if none does).
    """
    n = log_lik.shape[0]
    max_ll = torch.max(log_lik)
    d_ll = log_lik - max_ll                     # <= 0; exp never overflows
    gamma0 = torch.clamp_max(gamma_old + cfg.d_gamma_max, 1.0)
    ks = torch.arange(cfg.gamma_reduction_iters + 1, device=log_lik.device)
    gammas = gamma_old + (gamma0 - gamma_old) * torch.pow(
        cfg.gamma_reduction_rate, ks.to(d_ll.dtype))
    n_cand = gammas.shape[0]

    s1, s2 = ladder_stats(d_ll.contiguous(), gammas - gamma_old)
    ess_all = (s1 * s1 / (s2 * n)).to(d_ll.dtype)
    ok = ess_all > cfg.ess_limit
    # argmax of the int cast picks the FIRST passing candidate.
    idx = torch.where(ok.any(), torch.argmax(ok.to(torch.int32)),
                      torch.full_like(ks[0], n_cand - 1)).to(torch.int32)
    gamma = _take(gammas, idx)
    weights = torch.exp(d_ll * (gamma - gamma_old))
    log_z = (gamma - gamma_old) * max_ll + torch.log(_take(s1, idx) / n)
    weights = weights / torch.sum(weights)
    return GammaResult(gamma, weights, _take(ess_all, idx), idx, max_ll,
                       log_z.to(d_ll.dtype))


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


def _rs_counts_offsets(v0: torch.Tensor, weights: torch.Tensor):
    """Offspring counts of residual-systematic resampling and their
    exclusive prefix sum (the output slot offsets), both int32 (N,).

    ``v0`` (a 0-d U[0, 1) draw) places the systematic grid {v0 + k}. The
    grid points at or below the residual prefix sum are
    (csum + 2^QBITS - v0q) >> QBITS; the offsets telescope from the two
    prefix sums without a third. The quantization remainder (the total
    off N by one or two) goes to the max-weight particle, never driving a
    count negative.
    """
    n = weights.shape[0]
    scaled = weights * n
    det = torch.floor(scaled)
    resid = scaled - det                          # [0, 1), exact fp32
    v0q = torch.floor(v0 * (1 << _QBITS)).to(torch.int64)
    q = torch.floor(resid * (1 << _QBITS)).to(torch.int64)
    det_i = det.to(torch.int64)
    det_csum = torch.cumsum(det_i, 0)
    bias = (1 << _QBITS) - v0q                    # in [1, 2^QBITS]
    grid_below = (torch.cumsum(q, 0) + bias) >> _QBITS
    grid_start = bias >> _QBITS                   # grid below cumsum 0
    prev = torch.cat([grid_start.reshape(1), grid_below[:-1]])
    counts = det_i + grid_below - prev
    total = det_csum[-1] + grid_below[-1] - grid_start
    fix = torch.argmax(weights)                   # first max
    applied = torch.maximum(n - total, -_take(counts, fix))
    pos = torch.arange(n, device=weights.device)
    counts = counts + torch.where(pos == fix, applied, 0)
    offsets = (det_csum - det_i) + (prev - grid_start)
    offsets = offsets + torch.where(pos > fix, applied, 0)
    return counts.to(torch.int32), offsets.to(torch.int32)


def residual_systematic_counts(v0: torch.Tensor,
                               weights: torch.Tensor) -> torch.Tensor:
    """Per-particle offspring counts (N,) int32 summing exactly to N:
    floor(N w_i) deterministic copies plus the residual mass resampled
    systematically from the single offset ``v0``."""
    return _rs_counts_offsets(v0, weights)[0]


def residual_systematic_ancestors(v0: torch.Tensor,
                                  weights: torch.Tensor) -> torch.Tensor:
    """Ancestor index per output slot (N,) int32, sorted: all copies of
    particle i are contiguous, in i order."""
    return sorted_offsets_to_ancestors(_rs_counts_offsets(v0, weights)[1])


def residual_systematic_apply(v0: torch.Tensor, weights: torch.Tensor,
                              particles: torch.Tensor,
                              log_lik: torch.Tensor):
    """Resample (particles (N, d), log_lik (N,)) by residual-systematic
    ancestors: one ancestor build (csrc/merge.cu on CUDA) and one row
    gather of the (N, d + 1) bundle, bitwise equal to indexing each array
    with the ancestors."""
    anc = residual_systematic_ancestors(v0, weights).long()
    bundle = torch.cat([particles, log_lik[:, None]], dim=1)
    out = bundle.index_select(0, anc)
    return out[:, :-1], out[:, -1]


def counts_to_ancestors(counts: torch.Tensor) -> torch.Tensor:
    """Offspring counts (N,) -> ancestor index per output slot (N,) int32,
    slot layout as above."""
    counts = counts.to(torch.int32)
    offsets = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    return sorted_offsets_to_ancestors(offsets)


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
                  eps: float = 1e-10) -> torch.Tensor:
    """Biased empirical covariance (np.cov(bias=True)) times the elementwise
    cov_weight, plus a relative jitter for Cholesky stability."""
    n = x.shape[0]
    mu = torch.mean(x, dim=0)
    xc = x - mu
    cov = (xc.T @ xc) / n
    cov = cov * cov_weight
    d = cov.shape[0]
    jitter = eps * (1.0 + torch.trace(cov) / d)
    return cov + jitter * torch.eye(d, dtype=cov.dtype, device=cov.device)


def _cholesky_or_nan(cov: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor without a host sync; NaN where the matrix is
    not positive definite (as JAX's factor is), so every proposal of a
    degenerate sweep is rejected instead of raising."""
    chol, info = torch.linalg.cholesky_ex(cov)
    return torch.where(info == 0, chol, math.nan)


class MutationCarry(NamedTuple):
    """Cross-sweep state of the adaptive mutation loop."""
    j: int                  # sweeps executed so far (host int: no sync)
    key: object             # the run's Draws
    particles: torch.Tensor  # (N, d)
    log_lik: torch.Tensor   # (N,)
    log_prior: torch.Tensor  # (N,)
    grad: torch.Tensor      # () zero for rwm
    r_ac: torch.Tensor      # (N,) bool accepted-at-least-once
    mh_ratio: torch.Tensor  # () proposal step ratio (halved when stalled)
    done: torch.Tensor      # () bool early-stop latch


def make_mutation_parts(kind: str, loglik_fn, prior: Prior, cfg: SMCConfig):
    """Split one adaptive sweep into ``(init_fn, draw_fn, core_fn, admin_fn,
    grad_fn)`` as the JAX package does; only ``"rwm"`` is ported
    (``grad_fn`` is None for it).

    - ``init_fn(key, particles, log_lik) -> MutationCarry``;
    - ``draw_fn(carry) -> (key, (chol,), (z, log_u))``: the per-sweep
      proposal factor of the weighted empirical covariance, then the
      sweep's draws, normals first;
    - ``core_fn(parts, lk1, lp1, g1, ratio, aux_g, aux_r, gamma)``:
      propose, clip to the support, evaluate, accept;
    - ``admin_fn(carry, key, parts, lk1, lp1, g1, accept, gamma)``: the
      accepted-at-least-once set, the early stop, and step-ratio halving.
    """
    if kind in ("mala", "hmc"):
        raise NotImplementedError(
            f"mutation {kind!r} is not ported yet; only 'rwm' runs")
    if kind != "rwm":
        raise ValueError(f"unknown mutation kind {kind!r}")

    def init_fn(key, particles, log_lik):
        n = particles.shape[0]
        dev = particles.device
        return MutationCarry(
            j=0, key=key, particles=particles, log_lik=log_lik,
            log_prior=prior.log_pdf(particles),
            grad=torch.zeros((), dtype=particles.dtype, device=dev),
            r_ac=torch.zeros(n, dtype=torch.bool, device=dev),
            mh_ratio=torch.ones((), dtype=particles.dtype, device=dev),
            done=torch.zeros((), dtype=torch.bool, device=dev))

    def admin_fn(c, key, parts, lk1, lp1, g1, accept, gamma):
        n = parts.shape[0]
        r_th = torch.where(gamma >= 1.0, cfg.accept_threshold_final,
                           cfg.accept_threshold)
        r_ac = c.r_ac | accept
        acc_sum = torch.sum(r_ac)
        done = acc_sum > r_th * n
        halve = ~done & (acc_sum < cfg.accept_threshold_min * n)
        ratio = torch.where(halve, c.mh_ratio * cfg.mh_ratio_decay,
                            c.mh_ratio)
        return MutationCarry(c.j + 1, key, parts, lk1, lp1, g1, r_ac,
                             ratio, done)

    def draw_fn(c):
        n, d = c.particles.shape
        cov_weight = cfg.cov_weight(d, c.particles.device).to(
            c.particles.dtype)
        chol = _cholesky_or_nan(_weighted_cov(c.particles, cov_weight))
        z = c.key.normal((n, d), c.particles.dtype)
        log_u = torch.log(c.key.uniform((n,), c.particles.dtype))
        return c.key, (chol,), (z, log_u)

    def core_fn(parts, lk1, lp1, g1, ratio, aux_g, aux_r, gamma):
        (chol,) = aux_g
        z, log_u = aux_r
        prop = parts + (z @ chol.T) * ratio
        in_sup = prior.in_support(prop)
        # Out-of-support proposals are replaced by the current particle
        # before evaluation (a numerical no-op that keeps shapes fixed).
        prop_eval = torch.where(in_sup[:, None], prop, parts)
        lk2, _ = loglik_fn(prop_eval)
        lp2 = prior.log_pdf(prop_eval)
        # The prior ratio is included: the correct tempered-posterior kernel
        # for any prior, identical to the likelihood-only rule for uniform
        # priors.
        log_acc = (lk2 - lk1) * gamma + (lp2 - lp1)
        accept = in_sup & (log_acc >= log_u) & torch.isfinite(lk2)
        parts = torch.where(accept[:, None], prop_eval, parts)
        lk1 = torch.where(accept, lk2, lk1)
        lp1 = torch.where(accept, lp2, lp1)
        return parts, lk1, lp1, g1, accept

    return init_fn, draw_fn, core_fn, admin_fn, None


def make_mutation_sweeper(kind: str, loglik_fn, prior: Prior,
                          cfg: SMCConfig):
    """``(init_fn, sweep_fn)``: ``sweep_fn(carry, gamma) -> carry`` runs ONE
    sweep (draws, proposal, one likelihood evaluation, accept, controller
    update), composed from :func:`make_mutation_parts`."""
    init_fn, draw_fn, core_fn, admin_fn, _ = make_mutation_parts(
        kind, loglik_fn, prior, cfg)

    def sweep_fn(c, gamma):
        key, aux_g, aux_r = draw_fn(c)
        parts, lk1, lp1, g1, accept = core_fn(
            c.particles, c.log_lik, c.log_prior, c.grad, c.mh_ratio,
            aux_g, aux_r, gamma)
        return admin_fn(c, key, parts, lk1, lp1, g1, accept, gamma)

    return init_fn, sweep_fn


def _run_sweeps(kind: str, key, particles, log_lik, gamma, loglik_fn,
                prior: Prior, cfg: SMCConfig) -> MutationResult:
    """The adaptive sweep loop: up to ``mh_steps`` sweeps (``mh_steps_final``
    at gamma == 1), stopping early once the accepted-at-least-once fraction
    passes the threshold. The host reads one flag per sweep after the
    first; the sweep count limit is chosen on the device."""
    init_fn, sweep_fn = make_mutation_sweeper(kind, loglik_fn, prior, cfg)
    n_mh = torch.where(gamma >= 1.0, cfg.mh_steps_final, cfg.mh_steps)
    c = sweep_fn(init_fn(key, particles, log_lik), gamma)
    while bool(((c.j < n_mh) & ~c.done).item()):
        c = sweep_fn(c, gamma)
    n_steps = torch.tensor(c.j, dtype=torch.int32, device=particles.device)
    return MutationResult(c.particles, c.log_lik, n_steps,
                          torch.sum(c.r_ac), c.mh_ratio)


def mh_mutation(key, particles: torch.Tensor, log_lik: torch.Tensor,
                gamma: torch.Tensor,
                loglik_fn: Callable[[torch.Tensor], tuple],
                prior: Prior, cfg: SMCConfig) -> MutationResult:
    """Adaptive random-walk Metropolis sweeps. Per sweep: the proposal
    covariance is the weighted empirical particle covariance, recomputed
    every sweep; proposal = particles + N(0, cov) * mh_ratio; out-of-support
    proposals are replaced by the current particle; accept iff
    (lk2 - lk1) * gamma + (lp2 - lp1) >= log U. ``key`` is the run's
    ``Draws``."""
    return _run_sweeps("rwm", key, particles, log_lik, gamma, loglik_fn,
                       prior, cfg)


def mutate(key, particles: torch.Tensor, log_lik: torch.Tensor,
           gamma: torch.Tensor, loglik_fn, prior: Prior,
           cfg: SMCConfig) -> MutationResult:
    """Dispatch to the configured mutation kernel (cfg.mutation); only
    ``"rwm"`` is ported, ``"mala"``/``"hmc"`` raise NotImplementedError."""
    if cfg.mutation != "rwm":
        raise NotImplementedError(
            f"mutation {cfg.mutation!r} is not ported yet; only 'rwm' runs")
    return mh_mutation(key, particles, log_lik, gamma, loglik_fn, prior, cfg)

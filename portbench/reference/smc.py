"""Plain likelihood-tempered SMC pieces: the benchmark's yardstick for
the tempering and resampling layers.

Each function is batched over a leading population axis P (one
posterior: P = 1) and written in plain PyTorch, so the same code runs in
float64 (the reference) and in bfloat16 (the control). It follows the
algorithm the configuration states (the reference implementation's
knobs, ``configs/<name>.json`` under ``"smc"``), not the program's code:

- gamma search: the candidates gamma_k = g + (min(g + d_gamma_max, 1) - g)
  rate^k, k = 0..iters; the first whose normalized ESS
  (sum w)^2 / (N sum w^2), w = exp(dgamma (ll - max ll)), exceeds
  ``ess_limit`` wins, the last one if none does; the log-evidence
  increment is dgamma max ll + ln(mean w);
- residual-systematic resampling: floor(N w_i) copies of particle i, the
  remaining slots by one systematic pass over the residuals.

It imports nothing of the program.
"""
from __future__ import annotations

import torch


def gamma_search(ll, gamma_old, knobs):
    """ll (P, N), gamma_old (P,) -> (gamma, weights, ess, logz_inc, k):
    the ladder rule of the module text, each (P,) but the weights (P, N)
    and the chosen rung k (P,) int64, computed in ll's dtype."""
    dt = ll.dtype
    g0 = gamma_old.to(dt)
    n = ll.shape[-1]
    mx = torch.amax(ll, dim=-1)
    d = ll - mx[:, None]
    top = torch.clamp(g0 + knobs["d_gamma_max"], max=1.0)
    ks = torch.arange(knobs["gamma_reduction_iters"] + 1, device=ll.device)
    rate = torch.tensor(knobs["gamma_reduction_rate"], dtype=dt,
                        device=ll.device)
    gammas = g0[:, None] + (top - g0)[:, None] * rate ** ks.to(dt)
    dg = gammas - g0[:, None]                                   # (P, K)
    w = torch.exp(d[:, None, :] * dg[:, :, None])               # (P, K, N)
    s1, s2 = w.sum(-1), (w * w).sum(-1)
    ess = s1 * s1 / (s2 * n)
    ok = ess > knobs["ess_limit"]
    last = torch.full_like(ks[:1].expand(ok.shape[0]), ks.numel() - 1)
    k = torch.where(ok.any(-1), torch.argmax(ok.to(torch.int8), dim=-1),
                    last)
    take = k[:, None]
    gamma = gammas.gather(1, take)[:, 0]
    dgk = gamma - g0
    wk = torch.exp(d * dgk[:, None])
    logz = dgk * mx + torch.log(s1.gather(1, take)[:, 0] / n)
    return gamma, wk / wk.sum(-1, keepdim=True), ess.gather(1, take)[:, 0], \
        logz, k


def residual_systematic(weights, u):
    """weights (P, N) normalized, u (P,) in [0, 1) -> ancestors (P, N):
    floor(N w) copies, then the residual mass by systematic sampling."""
    p, n = weights.shape
    w = weights.to(torch.float64)
    scaled = w * n
    det = torch.floor(scaled)
    resid = scaled - det
    n_res = n - det.sum(-1)                                      # (P,)
    # Systematic points u + j, j = 0..n_res-1, over the residual cumsum.
    csum = torch.cumsum(resid, -1)
    j = torch.arange(n, device=w.device, dtype=torch.float64)
    pts = u.to(torch.float64)[:, None] + j[None, :]
    res_idx = torch.searchsorted(csum, pts.contiguous(), right=True)
    res_idx = torch.clamp(res_idx, max=n - 1)
    valid = j[None, :] < n_res[:, None]
    counts = det.to(torch.int64)
    counts.scatter_add_(1, torch.where(valid, res_idx, 0),
                        valid.to(torch.int64))
    # Rounding can leave the total one off: the largest weight takes it.
    fix = n - counts.sum(-1)
    top = torch.argmax(w, dim=-1, keepdim=True)
    counts.scatter_add_(1, top, fix[:, None])
    idx = torch.arange(n, device=w.device).expand(p, n)
    return torch.stack([torch.repeat_interleave(idx[i], counts[i])
                        for i in range(p)])

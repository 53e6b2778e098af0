"""The comparisons that decide ``correct``: what the timed path produced,
against the plain reference (``portbench/reference/``), computed again
from the benchmark's own inputs.

Each function takes the values a side claims and returns the numbers
that are held against the traffic file's limits:

- ``ll_gap`` (nats): the widest gap between a particle's stored
  log-likelihood and the reference's at the same parameters;
- ``ll_gap_q`` (nats): for a model whose failed solves carry a sentinel,
  a quantile of the particles' gaps (``lanes``);
- ``grad_gap_q``: the same quantile of the particles' gradient gaps, each
  the worst parameter's |claimed - reference| over the larger of the
  reference's magnitude and the median particle's (``grads``);
- ``post_ll_ks``: a quantile, over sampled posteriors, of the
  Kolmogorov-Smirnov distance between the log-likelihoods of a
  posterior's particles and the exact posterior's distribution of the
  log-likelihood (``ks``);
- ``ess_gap`` (share of N) and ``logz_gap`` (nats): a step's ESS and
  log-evidence increment against the reference's at the step's own
  gamma, from the step's input log-likelihoods; ``gamma_rule``: the
  steps whose gamma is not the ladder rung the reference picks (exact);

The same functions serve the control (``portbench/control.py``), which
puts the reference, computed in a lower precision, in the program's
place.
"""
from __future__ import annotations

import math

import torch

from portbench.reference import smc


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over finite pairs; inf where exactly one side is not
    finite."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if bool((fa != fb).any()):
        return math.inf
    both = fa & fb
    if not bool(both.any()):
        return 0.0
    return float((a[both] - b[both]).abs().max())


def ll_gap(claimed: torch.Tensor, reference: torch.Tensor) -> float:
    return _gap(claimed, reference)


Q = 0.9


def quantile(x, q=Q):
    """The ``q`` quantile of ``x``, as the nearest reading at or above
    it, so that an infinite reading stays one."""
    return float(torch.quantile(x.to(torch.float64), q,
                                interpolation="higher"))


def _failed(ll, failed_below):
    return ~(ll.to(torch.float64) > failed_below)


def lanes(claimed: torch.Tensor, reference: torch.Tensor,
          failed_below: float, q: float = Q) -> dict:
    """For a model whose failed solves carry a sentinel (a particle's
    log-likelihood then lies below ``failed_below``), each sampled
    particle's gap: |claimed - reference| where both sides solved it, 0
    where both mark it failed, inf where exactly one does. ``ll_gap`` is
    the widest, ``ll_gap_q`` the ``q`` quantile (``quantile``): a march
    that is ill-conditioned in a few lanes moves the widest gap by
    orders of magnitude between seeds and leaves the quantile steady."""
    c, r = claimed.to(torch.float64), reference.to(torch.float64)
    fc, fr = _failed(c, failed_below), _failed(r, failed_below)
    gap = torch.where(fc | fr, 0.0, (c - r).abs())
    gap = torch.where(fc != fr, math.inf, gap)
    return dict(ll_gap=float(gap.max()), ll_gap_q=quantile(gap, q))


def grads(claimed, reference, claimed_ll, reference_ll, failed_below: float,
          q: float = Q) -> dict:
    """Gradients (k, d) at the same k particles, with each side's
    log-likelihoods there (k,). A particle's gap is the worst
    parameter's |claimed - reference| / max(|reference|, the median
    solved particle's |reference| of that parameter), so that a
    parameter whose gradient is all but zero at one particle is not
    judged by rounding; 0 where both sides mark the particle failed (a
    sentinel's gradient is no answer), inf where exactly one does or the
    gap is not finite. ``grad_gap_q`` is its ``q`` quantile."""
    g, r = claimed.to(torch.float64), reference.to(torch.float64)
    fc = _failed(claimed_ll, failed_below)
    fr = _failed(reference_ll, failed_below)
    solved = ~fc & ~fr
    if not bool(solved.any()):
        return dict(grad_gap_q=0.0)
    med = r[solved].abs().median(0).values
    gap = ((g - r).abs() / torch.maximum(r.abs(), med)).amax(-1)
    gap = torch.where(torch.isfinite(gap), gap, math.inf)
    gap = torch.where(fc | fr, 0.0, gap)
    gap = torch.where(fc != fr, math.inf, gap)
    return dict(grad_gap_q=quantile(gap, q))


def ks(a, wa, b, wb) -> float:
    """The Kolmogorov-Smirnov distance between two weighted samples (a,
    wa) and (b, wb) of one quantity, weights summing to 1 on each side:
    the widest gap between their distribution functions, read at every
    value either side holds."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    wa, wb = wa.to(torch.float64), wb.to(torch.float64)
    x = torch.cat([a, b]).sort().values

    def cdf(v, w):
        o = torch.argsort(v)
        c = torch.cumsum(w[o], 0)
        i = torch.searchsorted(v[o].contiguous(), x, right=True)
        return torch.where(i > 0, c[(i - 1).clamp_min(0)], 0.0)
    return float((cdf(a, wa) - cdf(b, wb)).abs().max())


def tempering(pre_ll, pre_gamma, post_gamma, post_rung, post_ess, dlogz,
              knobs: dict) -> dict:
    """Per step (stacked on a leading step axis S): the step's input
    log-likelihoods (S, N) and gamma (S,), and what it claims: gamma,
    the ladder rung, ESS and log-evidence increment (S,)."""
    f64 = torch.float64
    ll, g0 = pre_ll.to(f64), pre_gamma.to(f64)
    _, _, _, _, k_ref = smc.gamma_search(ll, g0, knobs)
    g = post_gamma.to(f64)
    mx = ll.amax(-1, keepdim=True)
    w = torch.exp((ll - mx) * (g - g0)[:, None])
    n = ll.shape[-1]
    ess = w.sum(-1) ** 2 / (n * (w * w).sum(-1))
    logz = (g - g0) * mx[:, 0] + torch.log(w.sum(-1) / n)
    return dict(ess_gap=_gap(post_ess, ess), logz_gap=_gap(dlogz, logz),
                gamma_rule=int((post_rung.to(torch.int64).cpu()
                                != k_ref.cpu()).sum()))


def verdict(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in limits)

"""Plain Michaelis-Menten likelihood, the benchmark's yardstick for the
``mm`` configuration.

The substrate of dS/dt = -Vmax S / (Km + S) from S(0) = S0 is
S(t) = Km W(z(t)), z(t) = (S0 / Km) exp((S0 - Vmax t) / Km), W the
principal branch of Lambert's function. W is found in log space: w solves
w + ln w = L with L = ln z, by Newton's method from a standard starting
point, so no z is ever formed and nothing is clipped. The product
P = S0 - S is observed with iid Gaussian noise of standard deviation
sigma; the log-likelihood sums, over datasets and points,
-0.5 ln(2 pi) - ln sigma - (obs - P)^2 / (2 sigma^2); sigma <= 0 gives -inf.

Written in plain PyTorch so that the same code runs in float64 (the
reference) and in bfloat16 (the control), on any device. It imports
nothing of the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch

LOG_2PI = math.log(2.0 * math.pi)


def lambertw_log(L: torch.Tensor, iters: int = 40) -> torch.Tensor:
    """W(e^L) for real L, elementwise, in L's dtype: Newton on
    f(w) = w + ln w - L, f'(w) = 1 + 1/w. From w0 = L - ln L (L > 1) or
    w0 = e^L / (1 + e^L) (L <= 1) the iterates stay positive and converge
    quadratically; a fixed count keeps the code branch-free."""
    big = L > 1.0
    Lc = torch.where(big, L, torch.ones_like(L))
    e = torch.exp(torch.clamp(L, max=1.0))
    w = torch.where(big, Lc - torch.log(Lc), e / (1.0 + e))
    for _ in range(iters):
        w = w - (w + torch.log(w) - L) / (1.0 + 1.0 / w)
        w = torch.clamp_min(w, torch.finfo(w.dtype).tiny)
    return w


def product(vmax, km, s0, ts):
    """P = S0 - S (..., n_ds, T) for vmax, km (...,), s0 (n_ds,) and the
    grid ts (T,), in vmax's dtype."""
    vmax, km = vmax[..., None, None], km[..., None, None]
    s0c, tc = s0[:, None], ts[None, :]
    L = torch.log(s0c / km) + (s0c - vmax * tc) / km
    return s0c - km * lambertw_log(L)


def log_likelihood(theta, obs, s0, ts):
    """theta (..., 3) = (Vmax, Km, sigma); obs (..., n_ds, T) broadcasting
    against theta's leading axes -> log-likelihood (...), in theta's
    dtype."""
    dt = theta.dtype
    obs, s0, ts = obs.to(dt), s0.to(dt), ts.to(dt)
    vmax, km, sigma = theta[..., 0], theta[..., 1], theta[..., 2]
    good = (km > 0) & (sigma > 0)
    km_s = torch.where(good, km, torch.ones_like(km))
    sig_s = torch.where(good, sigma, torch.ones_like(sigma))
    r = obs - product(vmax, km_s, s0, ts)
    n = r.shape[-1] * r.shape[-2]
    ll = (-0.5 * n * LOG_2PI - n * torch.log(sig_s)
          - torch.sum(r * r, dim=(-1, -2)) / (2.0 * sig_s * sig_s))
    return torch.where(good & torch.isfinite(ll), ll,
                       torch.full_like(ll, -math.inf))


def true_product_numpy(vmax: float, km: float, s0, ts) -> np.ndarray:
    """The noise-free product (n_ds, T) at the truth, float64 on the host."""
    th = torch.tensor([vmax, km, 1.0], dtype=torch.float64)
    return product(th[0], th[1], torch.as_tensor(s0, dtype=torch.float64),
                   torch.as_tensor(ts, dtype=torch.float64)).numpy()



def _mode(obs, s0, ts, start, iters: int = 30):
    """The maximum-likelihood (Vmax, Km, sigma) in float64: Gauss-Newton
    on the sum of squares over (Vmax, Km) from ``start``, then sigma^2 =
    SS / n, the likelihood's own maximiser."""
    x = torch.as_tensor(start[:2], dtype=torch.float64, device=obs.device)

    def resid(v):
        return (obs - product(v[0], v[1], s0, ts)).reshape(-1)
    for _ in range(iters):
        J = torch.func.jacfwd(resid)(x)
        x = x - torch.linalg.lstsq(J, resid(x)[:, None]).solution[:, 0]
    ss = torch.sum(resid(x) ** 2)
    return torch.cat([x, torch.sqrt(ss / obs.numel())[None]])


def _laplace(obs, s0, ts, start):
    """(mode (3,), L (3, 3)) in float64: the maximum-likelihood point and
    the Cholesky factor of the inverse Hessian of the negative
    log-likelihood there."""
    f64 = torch.float64
    obs64, s064, ts64 = obs.to(f64), s0.to(f64), ts.to(f64)
    mode = _mode(obs64, s064, ts64, start)
    H = torch.func.hessian(
        lambda th: -log_likelihood(th, obs64, s064, ts64))(mode)
    return mode, torch.linalg.cholesky(torch.linalg.inv(H))


def posterior_log_lik(obs, s0, ts, low, high, start, gen,
                      dtype=torch.float64, draws: int = 1 << 15,
                      widen: float = 1.5):
    """The exact posterior's distribution of the log-likelihood, as a
    weighted sample (values (M,), weights (M,) summing to 1), under the
    uniform prior on the box [low, high] and the likelihood of the module
    text, for one dataset ``obs`` (n_ds, T) of float32 values.

    By importance sampling: ``draws`` points from the Gaussian around the
    maximum-likelihood point (found from ``start``) with the Laplace
    covariance widened ``widen`` times, drawn in float64 from ``gen``;
    each point's log-likelihood and weight (likelihood inside the box
    over the proposal's density, 0 outside) are computed in ``dtype``
    (float64: the reference; bfloat16: the control)."""
    mode, L = _laplace(obs, s0, ts, start)
    z = torch.randn(draws, 3, generator=gen, dtype=torch.float64,
                    device=obs.device)
    theta = (mode + widen * z @ L.T).to(dtype)
    lo = torch.as_tensor(low, dtype=dtype, device=obs.device)
    hi = torch.as_tensor(high, dtype=dtype, device=obs.device)
    ll = log_likelihood(theta, obs, s0, ts)
    inside = ((theta > lo) & (theta < hi)).all(-1) & torch.isfinite(ll)
    logw = torch.where(inside, ll + (0.5 * (z * z).sum(-1)).to(dtype),
                       torch.full_like(ll, -math.inf))
    w = torch.exp(logw - logw.max())
    return ll, w / w.sum()

"""Multi-start MAP estimation on any model whose likelihood autograd
differentiates (PyTorch port of ``smc_tpu.opt``).

All starts are optimized at once on the particle axis: a (K, d) batch
through the same vectorized ``log_likelihood`` the SMC sweeps use, so K
starts cost one likelihood and one backward pass per step. Optimization
runs in a per-dimension standardized space (uniform dimensions scaled by
width / sqrt(12), normal ones by their sd), iterates are projected back
into the uniform support after every update, and a start whose likelihood
fails contributes zero gradient.

The card has no optax: :func:`adam_update` and :func:`cosine_decay` are
optax's ``adam`` and ``cosine_decay_schedule`` written as tensor ops, so a
step reads nothing on the host. On CUDA one optimizer step is captured as
a CUDA graph and replayed ``steps`` times.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Union

import torch

from smc_tpu_torch.priors import UNIFORM
from smc_tpu_torch.rng import as_draws
from smc_tpu_torch.smc import graphs
from smc_tpu_torch.smc.kernels import check_differentiable

# optax.adam's defaults.
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
# The explore pass's cosine decay ends at this fraction of the rate.
COSINE_ALPHA = 0.01


class MAPResult(NamedTuple):
    theta: torch.Tensor         # (d,) best start's final iterate
    log_post: torch.Tensor      # () its unnormalized log-posterior
    all_theta: torch.Tensor     # (K, d) every start's final iterate
    all_log_post: torch.Tensor  # (K,)


class AdamState(NamedTuple):
    count: torch.Tensor   # () float32 updates taken
    mu: torch.Tensor      # first moment
    nu: torch.Tensor      # second moment


def adam_init(params: torch.Tensor) -> AdamState:
    zero = torch.zeros_like(params)
    return AdamState(torch.zeros((), dtype=torch.float32,
                                 device=params.device), zero, zero.clone())


def adam_update(g: torch.Tensor, state: AdamState,
                lr: Union[float, torch.Tensor]):
    """optax ``scale_by_adam`` then ``scale_by_learning_rate``: returns
    ``(updates, state)`` with updates = -lr * mu_hat / (sqrt(nu_hat) +
    eps), the moments bias-corrected at the incremented count."""
    mu = (1 - ADAM_B1) * g + ADAM_B1 * state.mu
    nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * state.nu
    count = state.count + 1
    mu_hat = mu / (1 - torch.pow(ADAM_B1, count))
    nu_hat = nu / (1 - torch.pow(ADAM_B2, count))
    updates = -lr * (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS))
    return updates, AdamState(count, mu, nu)


def cosine_decay(lr: float, steps: int, count: torch.Tensor,
                 alpha: float = COSINE_ALPHA) -> torch.Tensor:
    """optax ``cosine_decay_schedule(lr, steps, alpha)`` at ``count``."""
    count = torch.clamp_max(count, float(steps))
    decay = 0.5 * (1 + torch.cos(math.pi * count / float(steps)))
    return lr * ((1 - alpha) * decay + alpha)


def map_estimate(model, key, n_starts: int = 8, steps: int = 800,
                 lr: float = 0.1) -> MAPResult:
    """Multi-start MAP: argmax_theta log P(y | theta) + log P(theta).

    ``n_starts`` prior draws (``key``: an int seed or a ``Draws``) are
    optimized together with cosine-decayed Adam for ``steps`` updates in
    the standardized space, each start keeping the best iterate it has
    seen; then each restarts from its best with Adam at ``lr * 0.02`` for
    ``steps // 4`` updates. Returns the best start's and every start's
    result. The model's likelihood must be differentiable (MM ``exact`` or
    ``rk4``, the methanation model; the CUDA MM kernels have no backward
    and raise ValueError)."""
    prior = model.prior
    uni = prior.kind == UNIFORM
    width = prior.high - prior.low
    scale = torch.where(uni, width / math.sqrt(12.0), prior.scale)
    center = torch.where(uni, 0.5 * (prior.low + prior.high), prior.loc)
    # Keep uniform dimensions strictly inside the support (log_pdf is -inf
    # on its edge); the 1e-4 relative inset is below any posterior scale.
    lo = torch.where(uni, prior.low + 1e-4 * width, -math.inf)
    hi = torch.where(uni, prior.high - 1e-4 * width, math.inf)
    z_lo, z_hi = (lo - center) / scale, (hi - center) / scale

    def clip(z):
        # maximum then minimum, as jnp.clip: at a bound autograd splits the
        # gradient between the two sides, as JAX does.
        return torch.minimum(torch.maximum(z, z_lo), z_hi)

    def theta_of(z):
        return center + clip(z) * scale

    def log_post(z):
        th = theta_of(z)
        ll = model.log_likelihood(th)[0]
        if z.requires_grad:
            check_differentiable(ll, model.log_likelihood)
        return ll + prior.log_pdf(th)

    def keep_best(z, v, z_best, v_best):
        v = torch.where(torch.isfinite(v), v, -math.inf)
        better = v > v_best
        return (torch.where(better[:, None], z, z_best),
                torch.maximum(v, v_best))

    def sweep(z, z_best, v_best, n, rate):
        def step(st):
            z, count, mu, nu, z_best, v_best = st
            with torch.enable_grad():
                t = z.detach().requires_grad_(True)
                v = log_post(t)
                obj = -torch.sum(torch.where(torch.isfinite(v), v, 0.0))
                (g,) = torch.autograd.grad(obj, t)
            g = torch.where(torch.isfinite(g), g, 0.0)
            z_best, v_best = keep_best(z, v.detach(), z_best, v_best)
            updates, (count, mu, nu) = adam_update(
                g, AdamState(count, mu, nu), rate(count))
            return (clip(z + updates), count, mu, nu, z_best, v_best)

        st = graphs.repeat(
            step, (z,) + tuple(adam_init(z)) + (z_best, v_best), n)
        z, z_best, v_best = st[0], st[4], st[5]
        with torch.no_grad():
            return keep_best(z, log_post(z), z_best, v_best)

    draws = as_draws(key, prior.device)
    z0 = (prior.sample(draws, n_starts) - center) / scale
    v0 = torch.full((n_starts,), -math.inf, device=z0.device)
    # explore: cosine-decayed Adam from the prior draws
    z_best, v_best = sweep(z0, z0, v0, steps,
                           lambda c: cosine_decay(lr, steps, c))
    # polish: restart at each start's best point with a small rate
    z_best, v_best = sweep(z_best, z_best, v_best, max(steps // 4, 1),
                           lambda c: lr * 0.02)
    best = torch.argmax(v_best)
    th = theta_of(z_best)
    return MAPResult(th[best], v_best[best], th, v_best)

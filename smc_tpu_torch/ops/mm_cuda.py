"""Fused Michaelis-Menten log-likelihoods: CUDA kernels and plain versions.

Port of ``smc_tpu/ops/mm_pallas.py``: the closed form
(``mm_loglik_exact_pallas`` and its batched form, kernel
``csrc/mm_exact.cu``) and the fixed-step RK4 march (``mm_loglik_pallas``
and its batched form, the JAX function under ``vmap``, kernel
``csrc/mm_rk4.cu``). Each plain PyTorch version below repeats its
kernel's arithmetic op for op. A CUDA tensor launches the kernel (or
raises); a CPU tensor takes the plain version. Neither carries an autograd
graph: the kernels have no backward, so the gradient mutations refuse
these likelihoods (smc/kernels.py::_make_ll_and_grad).
"""
from __future__ import annotations

import math

import torch

from smc_tpu_torch.ops import _build

_LOG2PI = math.log(2 * math.pi)

# Initializer coefficients of W (fit offline against scipy's lambertw):
# - [3/3] Pade of W(z)/z on z in [0, e];
# - [3/3] rational of W(e^u)/u in t = (u - 30.5)/29.5 on u = ln z in [1, 60].
# One Halley step after either makes W exact to fp32 over ln z in [-60, 60].
_PADE_W = (2.0756442, 0.736134059, 0.0134467679,
           3.0754228, 2.31554992, 0.353759838)
_GOU = (0.8917337208536824, 1.8982396128879397, 1.2165240727257451,
        0.20561353314077788,
        2.0499910593108703, 1.2599020418616451, 0.20550595307370517)


def _lambertw_fast(z: torch.Tensor, logz: torch.Tensor) -> torch.Tensor:
    """W(z) given z and logz = ln z: rational initializer plus one Halley
    step (one exp), as ``csrc/mm_exact.cu`` does."""
    a1, a2, a3, b1, b2, b3 = _PADE_W
    w_small = z * (1.0 + z * (a1 + z * (a2 + z * a3))) \
        / (1.0 + z * (b1 + z * (b2 + z * b3)))
    g0, g1, g2, g3, h1, h2, h3 = _GOU
    t = (logz - 30.5) * (1.0 / 29.5)
    w_big = logz * (g0 + t * (g1 + t * (g2 + t * g3))) \
        / (1.0 + t * (h1 + t * (h2 + t * h3)))
    w = torch.where(z > math.e, w_big, w_small)
    ew = torch.exp(w)
    f = w * ew - z
    denom = ew * (w + 1.0) - (w + 2.0) * f / (2.0 * w + 2.0)
    return w - f / torch.where(torch.abs(denom) < 1e-30,
                               torch.full_like(denom, 1e-30), denom)


def mm_loglik_exact_plain(theta: torch.Tensor, obs: torch.Tensor,
                          s0: torch.Tensor, dt: float) -> torch.Tensor:
    """theta (B, N, 3), obs (B, n_ds, T), s0 (B, n_ds) -> ll (B, N).

    Plain PyTorch form of the kernel (one Halley step): the same operations
    in the same order, with the datasets summed one after another as the
    kernel does.
    """
    n_ds, n_obs = obs.shape[1], obs.shape[2]
    one = theta.new_tensor
    vmax = theta[:, None, :, 0]                              # (B, 1, N)
    km = torch.maximum(theta[:, None, :, 1], one(1e-8))
    sig = theta[..., 2]                                      # (B, N)
    s0c = s0[:, :, None]                                     # (B, n_ds, 1)
    inv_km = 1.0 / km
    bdt = vmax * dt * inv_km
    decay = torch.exp(-bdt)
    logz = torch.log(km) * (-1.0) + torch.log(s0c) + s0c * inv_km
    z = torch.exp(torch.clamp(logz, -60.0, 60.0))           # t = 0 only
    r0 = obs[:, :, 0:1]
    acc = r0 * r0                                            # t = 0: S = s0
    for i in range(1, n_obs):
        z = z * decay
        logz = logz - bdt
        w = _lambertw_fast(z, logz)
        r = obs[:, :, i:i + 1] - (s0c - km * w)
        acc = acc + r * r
    total = acc[:, 0]
    for ds in range(1, n_ds):
        total = total + acc[:, ds]
    sigma = torch.maximum(sig, one(1e-12))
    ll = ((-0.5 * n_obs * n_ds) * (_LOG2PI + 2.0 * torch.log(sigma))
          - total / (2.0 * sigma * sigma))
    bad = (sig <= 0.0) | torch.isnan(ll)
    return torch.where(bad, one(-math.inf), ll)


def mm_loglik_exact_batched(theta: torch.Tensor, obs: torch.Tensor,
                            s0: torch.Tensor, dt: float) -> torch.Tensor:
    """theta (B, N, 3), obs (B, n_ds, T), s0 (B, n_ds) -> ll (B, N), float32.

    B populations, each with its own observations, in one launch (grid.y).
    CUDA tensors launch ``csrc/mm_exact.cu``; CPU tensors take
    :func:`mm_loglik_exact_plain`, without autograd: the kernel has no
    backward, and its stand-in on the CPU has none either.
    """
    if theta.device.type == "cpu":
        with torch.no_grad():
            return mm_loglik_exact_plain(theta, obs, s0, dt)
    if theta.device.type != "cuda":
        raise ValueError(f"unsupported device {theta.device}")
    dev = theta.device
    _build.check_input(theta, "theta", torch.float32, 3, dev)
    _build.check_input(obs, "obs", torch.float32, 3, dev)
    _build.check_input(s0, "s0", torch.float32, 2, dev)
    b, n = theta.shape[0], theta.shape[1]
    n_ds, n_obs = obs.shape[1], obs.shape[2]
    if theta.shape[2] != 3 or obs.shape[0] != b or tuple(s0.shape) != (b, n_ds):
        raise ValueError(f"shape mismatch: theta {tuple(theta.shape)}, obs "
                         f"{tuple(obs.shape)}, s0 {tuple(s0.shape)}")
    if n_obs < 1 or (n_ds * n_obs + n_ds) * 4 > 48 * 1024:
        raise ValueError("obs must hold 1 to ~12k points (shared memory)")
    if n >= 2 ** 31 or b > 65535:
        raise ValueError("N must be < 2^31 and B <= 65535")
    ll = torch.empty((b, n), dtype=torch.float32, device=dev)
    err = _build.load().mm_exact_launch(
        theta.data_ptr(), obs.data_ptr(), s0.data_ptr(), ll.data_ptr(),
        b, n, n_ds, n_obs, float(dt), _build.stream_ptr(theta))
    _build.check(err, "mm_exact")
    _build.launch_counts["mm_exact"] += 1
    return ll


def mm_loglik_exact(theta: torch.Tensor, obs: torch.Tensor,
                    s0: torch.Tensor, dt: float) -> torch.Tensor:
    """theta (N, 3), obs (n_ds, T), s0 (n_ds,) -> ll (N,): one population."""
    return mm_loglik_exact_batched(theta[None], obs[None], s0[None], dt)[0]


def _rk4_steps(dt: float, substeps: int):
    """(h, h/2, h/6) of the RK4 march: computed in double, rounded to fp32
    where they meet the state, as the JAX package's Python floats are."""
    h = float(dt) / int(substeps)
    return h, 0.5 * h, h / 6.0


def mm_loglik_rk4_plain(theta: torch.Tensor, obs: torch.Tensor,
                        s0: torch.Tensor, dt: float,
                        substeps: int = 4) -> torch.Tensor:
    """theta (B, N, 3), obs (B, n_ds, T), s0 (B, n_ds) -> ll (B, N); or one
    population, theta (N, 3), obs (n_ds, T), s0 (n_ds,) -> ll (N,).

    Plain PyTorch form of ``csrc/mm_rk4.cu``: ``substeps`` classical RK4
    steps per grid interval on f(S) = -Vmax S / (Km + S) with the state
    (B, n_ds, N), the same operations in the same order, each population
    against its own observations. Km is not clamped; a NaN result comes out
    as -inf.
    """
    if theta.dim() == 2:
        return mm_loglik_rk4_plain(theta[None], obs[None], s0[None], dt,
                                   substeps)[0]
    n_ds, n_obs = obs.shape[1], obs.shape[2]
    one = theta.new_tensor
    vmax, km = theta[:, None, :, 0], theta[:, None, :, 1]   # (B, 1, N)
    sig = theta[..., 2]                                      # (B, N)
    s0c = s0[:, :, None]                                     # (B, n_ds, 1)
    h, half_h, h_sixth = _rk4_steps(dt, substeps)

    def f(S):
        return -vmax * S / (km + S)

    S = s0c.expand(theta.shape[0], n_ds, theta.shape[1])
    r0 = obs[:, :, 0:1] - (s0c - S)
    acc = torch.zeros_like(r0) + r0 * r0
    for i in range(1, n_obs):
        for _ in range(substeps):
            k1 = f(S)
            k2 = f(S + half_h * k1)
            k3 = f(S + half_h * k2)
            k4 = f(S + h * k3)
            S = S + h_sixth * (k1 + 2 * k2 + 2 * k3 + k4)
        r = obs[:, :, i:i + 1] - (s0c - S)
        acc = acc + r * r
    total = acc[:, 0]
    for ds in range(1, n_ds):
        total = total + acc[:, ds]
    sigma = torch.maximum(sig, one(1e-12))
    ll = ((-0.5 * n_obs * n_ds) * (_LOG2PI + 2.0 * torch.log(sigma))
          - total / (2.0 * sigma * sigma))
    bad = (sig <= 0.0) | torch.isnan(ll)
    return torch.where(bad, one(-math.inf), ll)


def mm_loglik_pallas_batched(theta: torch.Tensor, obs: torch.Tensor,
                             s0: torch.Tensor, dt: float,
                             substeps: int = 4) -> torch.Tensor:
    """theta (B, N, 3), obs (B, n_ds, T), s0 (B, n_ds), dt = uniform grid
    spacing -> ll (B, N), float32: the fixed-step RK4 likelihood of B
    populations, each with its own observations, in one launch (grid.y),
    as the JAX package's ``mm_loglik_pallas`` under ``vmap``.

    CUDA tensors launch ``csrc/mm_rk4.cu``; CPU tensors take
    :func:`mm_loglik_rk4_plain`, without autograd (the kernel has no
    backward).
    """
    if theta.device.type == "cpu":
        with torch.no_grad():
            return mm_loglik_rk4_plain(theta, obs, s0, dt, substeps)
    if theta.device.type != "cuda":
        raise ValueError(f"unsupported device {theta.device}")
    dev = theta.device
    _build.check_input(theta, "theta", torch.float32, 3, dev)
    _build.check_input(obs, "obs", torch.float32, 3, dev)
    _build.check_input(s0, "s0", torch.float32, 2, dev)
    b, n = theta.shape[0], theta.shape[1]
    n_ds, n_obs = obs.shape[1], obs.shape[2]
    if theta.shape[2] != 3 or obs.shape[0] != b or tuple(s0.shape) != (b, n_ds):
        raise ValueError(f"shape mismatch: theta {tuple(theta.shape)}, obs "
                         f"{tuple(obs.shape)}, s0 {tuple(s0.shape)}")
    if n_obs < 1 or (n_ds * n_obs + n_ds) * 4 > 48 * 1024:
        raise ValueError("obs must hold 1 to ~12k points (shared memory)")
    if n >= 2 ** 31 or b > 65535 or substeps < 1:
        raise ValueError("N must be < 2^31, B <= 65535 and substeps >= 1")
    ll = torch.empty((b, n), dtype=torch.float32, device=dev)
    h, half_h, h_sixth = _rk4_steps(dt, substeps)
    err = _build.load().mm_rk4_launch(
        theta.data_ptr(), obs.data_ptr(), s0.data_ptr(), ll.data_ptr(),
        b, n, n_ds, n_obs, int(substeps), h, half_h, h_sixth,
        _build.stream_ptr(theta))
    _build.check(err, "mm_rk4")
    _build.launch_counts["mm_rk4"] += 1
    return ll


def mm_loglik_pallas(theta: torch.Tensor, obs: torch.Tensor,
                     s0: torch.Tensor, dt: float,
                     substeps: int = 4) -> torch.Tensor:
    """theta (N, 3), obs (n_ds, T), s0 (n_ds,) -> ll (N,): one population
    of :func:`mm_loglik_pallas_batched`, the likelihood behind the model's
    ``method="pallas"`` (named as in the JAX package)."""
    return mm_loglik_pallas_batched(theta[None], obs[None], s0[None], dt,
                                    substeps)[0]

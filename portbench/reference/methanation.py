"""Plain methanation-reactor likelihood, the benchmark's yardstick for the
``methanation`` configuration: a frozen copy, in any float precision, of
the transient march the configuration states.

The reactor is a 1-D plug-flow DAE with 7 fields (5 species
concentrations, temperature, velocity) on NX grid points, one system per
(particle, condition) lane. The march is BDF2 over a geometric step
schedule with a fixed number of Newton iterations and an IDA-style
lagged Jacobian: after the leading steps, the block-tridiagonal Jacobian
is built and factored once per ``jac_stride`` steps at the predictor and
reused, with the mass-coefficient compensation 2 / (1 + cj / cj_f); the
last ``dense_tail`` steps factor per step again. That is the algorithm of
the reference implementation's flagship (``configs/methanation.json``),
and the number of iterations is part of the likelihood, so the copy keeps
it step for step.

What the copy works out on its own: the condition table (the same
deterministic sweep), the residual rows (the same physics), the Jacobian
blocks (by forward-mode differentiation of the rows, not the program's
closed forms), the block-tridiagonal solve (block LU with
``torch.linalg.solve`` on each 7 x 7 block, no hand-unrolled
elimination), the outlet flows and the Gaussian likelihood. It imports
nothing of the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import jvp

SC = (-4.0, -1.0, 1.0, 2.0, 0.0)
DZ_DISP = 0.95e-5
RHOS = 5075.0
HR = -164940.0
R_GAS = 8.3144589
AREA = math.pi * (0.01 / 2) ** 2
CPG = 2800.0
CPS = 698.0
KEFF = 0.72
DINT = 0.005
U_HT = 68.2480
P_STP = 1.013e5
MOLW = (2.0, 44.0, 16.0, 18.0, 40.0)
FAILED_FLOW = -10000.0
FLOW_SANE = 1e6


def condition_table(n: int, nx: int, t_jacket_c=(120.0, 180.0),
                    total_sccm=(200.0, 600.0), h2_co2_ratio=(4.0, 5.0),
                    ar_frac=(0.15, 0.40), p_gauge_mpa=(0.0, 0.2),
                    length_mm=150.0, void_frac=0.39) -> dict:
    """The deterministic condition sweep (low-discrepancy grids over
    jacket temperature, total flow, H2:CO2 ratio, Ar share, pressure),
    float64 NumPy arrays keyed C_in (n, 5), T_in, T_jacket, u_in, void,
    dz, P0 (n,)."""
    i = np.arange(n)
    frac = (i * 0.6180339887) % 1.0
    tj = np.linspace(t_jacket_c[0], t_jacket_c[1], n) + 273.0
    tot = total_sccm[0] + frac * (total_sccm[1] - total_sccm[0])
    ratio = h2_co2_ratio[0] + ((i * 0.3819660113) % 1.0) * (
        h2_co2_ratio[1] - h2_co2_ratio[0])
    arf = ar_frac[0] + ((i * 0.2360679775) % 1.0) * (ar_frac[1] - ar_frac[0])
    pg = p_gauge_mpa[0] + ((i * 0.7639320225) % 1.0) * (
        p_gauge_mpa[1] - p_gauge_mpa[0])
    react = 1.0 - arf
    flows = np.stack([tot * react * ratio / (1.0 + ratio),
                      tot * react / (1.0 + ratio), np.zeros(n), np.zeros(n),
                      tot * arf], axis=1)
    p_abs = pg * 1e6 + 101325.0
    u_in = tot * 1.667e-8 / AREA * (101325.0 * tj) / (p_abs * 298.0)
    c_in = (p_abs / (R_GAS * tj))[:, None] * flows / tot[:, None]
    return dict(C_in=c_in, T_in=tj, T_jacket=tj, u_in=u_in,
                void=np.full(n, void_frac),
                dz=np.full(n, (length_mm / 1000.0) / (nx - 1)),
                P0=c_in.sum(1) * R_GAS * tj)


def step_schedule(t_final, n_steps, growth, jac_stride, dense_tail):
    """Geometric steps summing to t_final; the lagged middle made
    piecewise constant per block of jac_stride steps (block sums kept)."""
    w = float(growth) ** np.arange(n_steps)
    dts = t_final * w / w.sum()
    n_lag = n_steps - dense_tail
    n_dense = n_lag % jac_stride
    mid = dts[n_dense:n_lag].reshape(-1, jac_stride)
    return np.concatenate([dts[:n_dense],
                           np.repeat(mid.mean(1), jac_stride),
                           dts[n_lag:]]), n_dense


def _rate(T, C, kin):
    """LHHW methanation rate, mol/(m^3 s)."""
    p = [C[i] * R_GAS * T * 1e-6 for i in range(4)]
    k = [kin[2 * i] * torch.exp(-kin[2 * i + 1] / (R_GAS * T))
         for i in range(4)]
    rf = (5075e3 * k[0] * k[2] * p[1] * torch.clamp_min(p[0], 0.001) ** 0.5
          / (1.0 + k[2] * p[1]) ** 2)
    rr = 5075e3 * k[1] * k[3] * p[3] * p[2] ** 2 / (1.0 + k[3] * p[3]) ** 2
    return rf - rr


def rows(y_m, y, y_p, yd, flags, cv, kin):
    """Residual rows (7, NX, B) of the reactor DAE at states y_m, y, y_p
    (the neighbours, edge-duplicated) and time derivative yd, each
    (7, NX, B); flags (3, NX, 1) = inlet, first interior, outlet; cv
    (5, B) = T_jacket, u_in, void, dz, P0; kin (8, B)."""
    tjk, u_in, void, dz, p0 = cv
    first = flags[1]
    C_m, T_m, u_m = y_m[:5], y_m[5], y_m[6]
    C, T, u = y[:5], y[5], y[6]
    C_p, T_p = y_p[:5], y_p[5]
    Cd, Td = yd[:5], yd[5]
    sc = torch.tensor(SC, dtype=y.dtype, device=y.device)[:, None, None]
    mw = torch.tensor(MOLW, dtype=y.dtype, device=y.device)[:, None, None]
    r = _rate(T, C, kin)
    conv = (u * C - u_m * C_m) / dz
    lap = torch.where(first > 0, C_p - C, C_p - 2.0 * C + C_m) / dz ** 2
    res_c = -void * Cd - conv + void * DZ_DISP * lap + (1 - void) * sc * r
    tmb = (-u * p0 * (1.0 / T - 1.0 / T_m) / dz
           - p0 / T * (u - u_m) / dz
           + void * DZ_DISP * p0 * (1.0 / T_p - 2.0 / T + 1.0 / T_m)
           / dz ** 2
           + (1 - void) * R_GAS * (-2.0) * r)
    tmb = tmb + torch.where(first > 0, p0 * void / T ** 2 * Td, 0.0)
    rho = p0 / (R_GAS * T) * torch.sum(C * mw, 0) / torch.sum(C, 0) * 1e-3
    heatcap = void * rho * CPG + (1 - void) * RHOS * CPS
    kappa = torch.where(first > 0, 1.0, 0.1)
    enb = (-kappa * heatcap * Td
           - rho * CPG * (T * u - T_m * u_m) / dz
           + KEFF * (T_p - 2.0 * T + T_m) / dz ** 2
           + (1 - void) * (-HR) * r
           - 2.0 * U_HT / DINT * (T - tjk))
    pde = torch.cat([res_c, tmb[None], enb[None]], 0)
    inlet = torch.cat([Cd, Td[None], (u - u_in)[None]], 0)
    outlet = torch.cat([C - C_m, (u - u_m)[None], (T - T_m)[None]], 0)
    return torch.where(flags[0][None] > 0, inlet,
                       torch.where(flags[2][None] > 0, outlet, pde))


class Problem:
    """One batch of lanes: kin (k, 8) particles x the n conditions of
    ``cond`` on NX points, lanes particle-major (B = k n)."""

    def __init__(self, kin, cond: dict, nx: int):
        dt, dev = kin.dtype, kin.device
        k, n = kin.shape[0], cond["T_in"].shape[0]

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float64)).to(dev, dt)
        self.kin = kin.T[:, :, None].expand(-1, k, n).reshape(8, k * n)
        self.cv = torch.stack([t(cond[f]) for f in
                               ("T_jacket", "u_in", "void", "dz", "P0")]
                              ).repeat(1, k)
        fl = np.zeros((3, nx, 1))
        fl[0, 0], fl[1, 1], fl[2, -1] = 1.0, 1.0, 1.0
        self.flags = t(fl)
        y0 = torch.zeros((n, nx, 7), dtype=dt, device=dev)
        y0[:, :, :5] = t(cond["C_in"])[:, None, :]
        y0[:, :, 5] = 400.0
        y0[:, 0, 5] = t(cond["T_in"])
        y0[:, :, 6] = t(cond["u_in"])[:, None]
        self.y0 = y0.permute(2, 1, 0).repeat(1, 1, k)          # (7, NX, B)

    def _args(self, y, alpha, const, h):
        y_m = torch.cat([y[:, :1], y[:, :-1]], 1)
        y_p = torch.cat([y[:, 1:], y[:, -1:]], 1)
        return y_m, y, y_p, (alpha * y + const) / h

    def f(self, *a):
        return rows(*a, self.flags, self.cv, self.kin)

    def residual(self, y, alpha, const, h):
        """-F (NX, 7, B)."""
        return -self.f(*self._args(y, alpha, const, h)).movedim(1, 0)

    def blocks(self, y, alpha, const, h):
        """Block rows (A, B, C) (B, NX, 7, 7) of dF/dy at y, by one
        forward-mode pass per slot and column; the duplicated edge
        neighbours folded into the diagonal blocks."""
        args = self._args(y, alpha, const, h)
        cols = [[], [], [], []]
        for slot in range(4):
            for c in range(7):
                tan = [torch.zeros_like(a) for a in args]
                tan[slot][c] = 1.0
                cols[slot].append(jvp(self.f, args, tuple(tan))[1])
        A, B, C, D = (torch.stack(c, 1).permute(3, 2, 0, 1) for c in cols)
        B = B + D * (alpha / h)
        B[:, 0] += A[:, 0]
        B[:, -1] += C[:, -1]
        A[:, 0] = 0.0
        C[:, -1] = 0.0
        return A, B, C


def _solve(a, b):
    """a^-1 b on the batch of small blocks, NaN where a block is singular
    (the lane then fails, as a diverged march does); a precision with no
    factorization (bfloat16, float16) solves in float32 and rounds
    back."""
    low = a.dtype in (torch.bfloat16, torch.float16)
    x, info = torch.linalg.solve_ex(a.float() if low else a,
                                    b.float() if low else b)
    x = torch.where((info != 0)[..., None, None], math.nan, x)
    return x.to(a.dtype)


def factor(A, B, C):
    """Block LU of the block-tridiagonal matrix with blocks (B, NX, 7, 7):
    the Schur diagonal blocks D_i and multipliers m_i = A_i D_{i-1}^-1."""
    D, M = [B[:, 0]], [torch.zeros_like(B[:, 0])]
    for i in range(1, B.shape[1]):
        m = _solve(D[-1].transpose(-1, -2),
                               A[:, i].transpose(-1, -2)).transpose(-1, -2)
        D.append(B[:, i] - m @ C[:, i - 1])
        M.append(m)
    return D, M, C


def solve(fac, rhs):
    """x (NX, 7, B) of the factored system for rhs (NX, 7, B)."""
    D, M, C = fac
    r = rhs.permute(2, 0, 1)[..., None]                          # (B,NX,7,1)
    fwd = [r[:, 0]]
    for i in range(1, len(D)):
        fwd.append(r[:, i] - M[i] @ fwd[-1])
    x = [_solve(D[-1], fwd[-1])]
    for i in range(len(D) - 2, -1, -1):
        x.append(_solve(D[i], fwd[i] - C[:, i] @ x[-1]))
    return torch.stack(x[::-1], 1)[..., 0].permute(1, 2, 0)


def march(prob: Problem, dts, n_dense, newton_iters, jac_stride,
          reuse_iters, dense_tail):
    """The lagged BDF2 march of the module text: y (7, NX, B) at
    sum(dts)."""
    def coeffs(y_n, y_nm1, h, h_prev, first):
        r = 0.0 if first else h / h_prev
        return (1 + 2 * r) / (1 + r), -(1 + r) * y_n + r * r / (1 + r) * y_nm1

    def upd(fac, rhs):
        return solve(fac, rhs).movedim(0, 1)

    def full_step(y_n, y_nm1, h, h_prev, first):
        a, c = coeffs(y_n, y_nm1, h, h_prev, first)
        fac = factor(*prob.blocks(y_n, a, c, h))
        y = y_n + upd(fac, prob.residual(y_n, a, c, h))
        for _ in range(newton_iters - 1):
            y = y + upd(fac, prob.residual(y, a, c, h))
        return y

    n = len(dts)
    y_n = y_nm1 = prob.y0
    h_prev = dts[0]
    for k in range(n_dense):
        y_n, y_nm1, h_prev = full_step(y_n, y_nm1, dts[k], h_prev, k == 0), \
            y_n, dts[k]
    n_lag = n - dense_tail
    for k0 in range(n_dense, n_lag, jac_stride):
        h = dts[k0]
        first = k0 == 0
        a, c = coeffs(y_n, y_nm1, h, h_prev, first)
        r = 0.0 if first else h / h_prev
        y = y_n + r * (y_n - y_nm1)
        fac = factor(*prob.blocks(y, a, c, h))
        cj_f = a / h
        y = y + upd(fac, prob.residual(y, a, c, h))
        for _ in range(newton_iters - 1):
            y = y + upd(fac, prob.residual(y, a, c, h))
        y_n, y_nm1, h_prev = y, y_n, h
        for j in range(1, jac_stride):
            h = dts[k0 + j]
            a, c = coeffs(y_n, y_nm1, h, h_prev, False)
            comp = 2.0 / (1.0 + (a / h) / cj_f)
            y = y_n + (h / h_prev) * (y_n - y_nm1)
            for _ in range(reuse_iters):
                y = y + comp * upd(fac, prob.residual(y, a, c, h))
            y_n, y_nm1, h_prev = y, y_n, h
    for k in range(n_lag, n):
        y_n, y_nm1, h_prev = full_step(y_n, y_nm1, dts[k], h_prev, k == 0), \
            y_n, dts[k]
    return y_n


def outlet_flows(kin, cond: dict, m: dict):
    """kin (k, 8) -> outlet flows (k, 5, n) in sccm, the failure value
    -10000 on every flow of a lane whose flows are not finite or exceed
    1e6 in magnitude. ``m`` is the configuration's march settings."""
    dts, n_dense = step_schedule(m["t_final"], m["n_steps"], m["growth"],
                                 m["jac_stride"], m["dense_tail"])
    prob = Problem(kin, cond, m["nx"])
    y = march(prob, [float(h) for h in dts], n_dense, m["newton_iters"],
              m["jac_stride"], m["reuse_iters"], m["dense_tail"])
    fl = y[:5, -1] * y[6, -1] * AREA * 60.0 * R_GAS * 298.0 / P_STP * 1e6
    k, n = kin.shape[0], cond["T_in"].shape[0]
    fl = fl.reshape(5, k, n)
    ok = (torch.isfinite(fl) & (fl.abs() < FLOW_SANE)).all(0, keepdim=True)
    return torch.where(ok, fl, FAILED_FLOW).movedim(1, 0)


def full_params(theta, m: dict):
    """theta (k, len(est_idx)) -> the full 9-vector per particle: the
    true parameters with the estimated ones put in."""
    full = torch.tensor(m["kin_true"] + [m["sigma_true"]], dtype=theta.dtype,
                        device=theta.device).repeat(theta.shape[0], 1)
    full[:, list(m["est_idx"])] = theta
    return full


def log_likelihood(theta, obs, cond: dict, m: dict):
    """theta (k, d) -> log-likelihood (k,): the Gaussian of the outlet
    flows around obs (5, n) with the particle's sigma, without the 2 pi
    constant (as the configuration states it)."""
    full = full_params(theta, m)
    fl = outlet_flows(full[:, :8], cond, m)
    sig = torch.clamp_min(full[:, 8], 1e-12)
    res = fl - obs.to(fl.dtype)
    ll = (torch.sum(-(0.5 / sig[:, None, None] ** 2) * res ** 2, (-1, -2))
          - 5 * obs.shape[-1] * torch.log(sig))
    return torch.where(torch.isfinite(ll), ll, -math.inf)

"""Methanation tubular-reactor model (PyTorch port of the default path of
``smc_tpu.models.methanation``).

Physics (see the reference module for the citations into the original
code):

- LHHW kinetic rate law: CO2 + 4 H2 <-> CH4 + 2 H2O over 8 Arrhenius
  parameters (Af, Eaf, Ar, Ear, BCO2, dHCO2, BH2O, dHH2O).
- Method-of-lines DAE: 7 fields x NX = 51 grid points (5 species
  concentrations, temperature T, velocity u); species
  convection-dispersion-reaction balances, total-mass and energy balances;
  inlet rows pin the initial condition, outlet rows are zero-gradient. The
  reference's quirks are kept: the first interior point uses a one-sided
  second difference for the species dispersion, carries the transient
  total-mass term and an unscaled energy accumulation (interior points
  scale it by 0.1), and the outlet rows of T and u are swapped.
- Observation: outlet standard-state flows in sccm.
- Gaussian log-likelihood over the 5 species flows without the 2*pi
  constant: -(0.5/sigma^2) * sum r^2 - n_data * log(sigma).
- Solver-failure containment: a failed solve (non-finite or absurd final
  state of the fixed-iteration Newton march) gives the flow sentinel
  -10000, so the likelihood kills the particle.
- Subset estimation: the particle holds only the estimated parameters; the
  rest stay at their base values.

What runs: the lanes-major engine (``ops/dae_fast.py``): the transient BDF2
march with the lagged Jacobian, or the steady march (``march="steady"``,
per-lane pseudo-transient continuation) whose gradient is the
implicit-function adjoint (``_make_steady_solve``); Jacobian blocks in
closed form (``jac_mode="full"``), in part (``"cd"``) or wholly (``"ad"``)
by tangent passes; on "full" with 7-column blocks, the march's residuals
and Newton systems by the one-pass kernels of ``ops/march_cuda.py``
wherever the march is float32 and untracked (``_fused_of``); the
block-Thomas kernels of ``ops/thomas_cuda.py``
(differentiable: the transposed-solve kernel is their backward) or the
plain "thomas", "cr" and "babe" solvers. The per-system engine
(``engine="blocked"``, ``ops/dae.py``: local Jacobians by
``torch.func.jacfwd``, block-Thomas through ``ops/linalg.py``) is the
oracle of the lanes-major one. The CSV readers and writer of the condition
table. The lane mesh (``lane_mesh``): the conditions split over a mesh's
"data" axis, each process marching its share of its particle rows' lanes.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from smc_tpu_torch.config import resolve_device
from smc_tpu_torch.ops.dae import geometric_schedule, implicit_euler_dae
from smc_tpu_torch.ops.dae_fast import (_newton_kit, bdf_march_bl,
                                        block_thomas_bl, resolve_solver,
                                        steady_march_bl)
from smc_tpu_torch.ops.march_cuda import MarchKernels
from smc_tpu_torch.priors import Prior
from smc_tpu_torch.smc.diagnostics import FAILURE_SENTINEL

# ---- physical constants ---------------------------------------------------
SC = (-4.0, -1.0, 1.0, 2.0, 0.0)   # stoichiometry (H2, CO2, CH4, H2O, Ar)
DZ_DISP = 0.95e-5                  # axial dispersion, m^2/s
RHOS = 5075.0                      # catalyst density, kg/m^3
HR = -164940.0                     # reaction enthalpy, J/mol
R_GAS = 8.3144589                  # J/mol/K
RR = 0.01 / 2                      # reactor radius, m
AREA = float(np.pi * RR ** 2)      # cross-section, m^2
CPG = 2800.0                       # gas heat capacity, J/kg/K
CPS = 698.0                        # catalyst heat capacity, J/kg/K
KEFF = 0.72                        # effective conductivity, W/m/K
DINT = 0.005                       # internal diameter, m
U_HT = 68.2480                     # wall heat-transfer coeff, W/m^2/K
P_STP = 1.013e5                    # Pa
MOLW = (2.0, 44.0, 16.0, 18.0, 40.0)

# True parameters.
KIN_TRUE = (13.04, 52.2e3, 1.147e5, 96.7e3, 23.34, -6.0, 0.72, -2.51e3)
SIGMA_TRUE = 5.0
PARAM_NAMES = ("Af", "Eaf", "Ar", "Ear", "BCO2", "dHCO2", "BH2O", "dHH2O",
               "sigma")
# Prior bound multipliers.
HIGH_K = (25.0, 1.0, 30.0, 2.0, 1.0, -2.0, 1.0, -2.0, 2.0)
LOW_K = (4.0, 1.0, 4.0, 1.0, 1.0, -2.0, 1.0, -2.0, 0.9)
# Default estimated subset.
EST_DEFAULT = (0, 1, 2, 3, 8)

NX = 51

# Flow-sanity bound for the failure sentinel: physical outlet flows are
# O(10^2) sccm (bounded by the inlet totals), but the fixed-iteration Newton
# march has no internal error exit. At extreme kinetic draws it can diverge
# to FINITE garbage that an isfinite-only check would pass into the
# likelihood. Anything past this bound is a failed solve.
FLOW_SANE = 1e6


@functools.lru_cache(maxsize=None)
def _const(values: Tuple[float, ...], device: torch.device,
           dtype: torch.dtype) -> torch.Tensor:
    """``values`` as a (len, 1, 1) tensor, made once per device: a fresh
    host-to-device copy per residual call would make the host wait for the
    device each time."""
    return torch.tensor(values, dtype=dtype, device=device)[:, None, None]


@functools.lru_cache(maxsize=None)
def _row(values: Tuple, device: torch.device,
         dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``values`` as a 1-D tensor (an int64 index for ``dtype`` None), made
    once per device, for the same reason; none of these is ever written."""
    return torch.tensor(values, dtype=dtype, device=device)


def rate_rCH4(T, Ca, Cb, Cc, Cd, kin):
    """LHHW methanation rate, mol/(m^3 s)."""
    PH2 = Ca * R_GAS * T * 1e-6
    PCO2 = Cb * R_GAS * T * 1e-6
    PCH4 = Cc * R_GAS * T * 1e-6
    PH2O = Cd * R_GAS * T * 1e-6
    kf = kin[0] * torch.exp(-kin[1] / (R_GAS * T))
    ks = kin[2] * torch.exp(-kin[3] / (R_GAS * T))
    kCO2 = kin[4] * torch.exp(-kin[5] / (R_GAS * T))
    kH2O = kin[6] * torch.exp(-kin[7] / (R_GAS * T))
    rf = 5075e3 * kf * kCO2 * PCO2 * torch.clamp_min(PH2, 0.001) ** 0.5 \
        / (1.0 + kCO2 * PCO2) ** 2
    rr = 5075e3 * ks * kH2O * PH2O * PCH4 ** 2 / (1.0 + kH2O * PH2O) ** 2
    return rf - rr


def gas_density(C, T, P0):
    """Ideal-gas mixture density, kg/m^3. C: (..., 5)."""
    mw = _row(MOLW, C.device, C.dtype)
    return P0 / (R_GAS * T) * torch.sum(C * mw, -1) / torch.sum(C, -1) * 1e-3


# ---------------------------------------------------------------------------
# Condition table
# ---------------------------------------------------------------------------
_COND_FIELDS = ("C_in", "T_in", "T_jacket", "u_in", "void", "dz", "P0")


@dataclasses.dataclass(frozen=True)
class Conditions:
    """Per-experiment operating conditions (derived quantities
    precomputed), float32 tensors on one device."""
    C_in: torch.Tensor      # (n, 5) inlet concentrations, mol/m^3
    T_in: torch.Tensor      # (n,) K
    T_jacket: torch.Tensor  # (n,) K
    u_in: torch.Tensor      # (n,) m/s
    void: torch.Tensor      # (n,)
    dz: torch.Tensor        # (n,) m  (= length / (NX-1))
    P0: torch.Tensor        # (n,) Pa (total pressure = sum(C_in) R T_in)

    @property
    def n_data(self) -> int:
        return self.T_in.shape[0]

    @property
    def device(self) -> torch.device:
        return self.T_in.device

    def select(self, idx) -> "Conditions":
        i = torch.as_tensor(np.asarray(idx), dtype=torch.long,
                            device=self.device)
        return Conditions(*(getattr(self, f)[i] for f in _COND_FIELDS))

    @staticmethod
    def from_numpy(arrays: dict, device="cuda") -> "Conditions":
        """From a mapping of the seven fields as arrays (cast to float32)."""
        dev = resolve_device(device)
        return Conditions(*(torch.as_tensor(
            np.asarray(arrays[f], np.float32), device=dev)
            for f in _COND_FIELDS))

    # -- CSV interchange: a documented clean schema (header below), and an
    #    adapter for the reference's 30-column positional information.csv.
    #    The unit conversions run in float64 NumPy, as in the JAX package,
    #    so both packages read a file to the same float32 bits. --
    CSV_HEADER = ("T_jacket_C,T_in_C,P_gauge_MPa,f_h2_sccm,f_co2_sccm,"
                  "f_ch4_sccm,f_h2o_sccm,f_ar_sccm,void_frac,length_mm")

    @staticmethod
    def from_csv(path: str, nx: int = NX, device="cuda") -> "Conditions":
        """Load operating conditions from CSV (header ``CSV_HEADER``), with
        the reference loader's unit conversions: deg-C -> K, total sccm ->
        inlet velocity at (T, P), gauge MPa -> absolute Pa, per-species
        flow fractions -> inlet concentrations."""
        raw = np.atleast_1d(np.genfromtxt(path, delimiter=",", names=True))
        tj = raw["T_jacket_C"] + 273.0
        t_in = raw["T_in_C"] + 273.0
        p_abs = raw["P_gauge_MPa"] * 1e6 + 101325.0
        flows = np.stack([raw["f_h2_sccm"], raw["f_co2_sccm"],
                          raw["f_ch4_sccm"], raw["f_h2o_sccm"],
                          raw["f_ar_sccm"]], axis=1)
        tot = flows.sum(1)
        u_in = tot * 1.667e-8 / AREA * (101325.0 * t_in) / (p_abs * 298.0)
        c_in = (p_abs / (R_GAS * t_in))[:, None] * flows / tot[:, None]
        dz = (raw["length_mm"] / 1000.0) / (nx - 1)
        return Conditions.from_numpy(dict(
            C_in=c_in, T_in=t_in, T_jacket=tj, u_in=u_in,
            void=raw["void_frac"], dz=dz, P0=c_in.sum(1) * R_GAS * t_in),
            device)

    @staticmethod
    def from_reference_csv(path: str, datalist=None, nx: int = NX,
                           device="cuda"):
        """Adapter for the reference's 30-column positional
        ``information.csv`` layout: col 4 reactor length (mm), col 5
        T_jacket (degC), col 6 void fraction, col 7 T_in (degC), col 9
        total pressure (gauge MPa), cols 10, 11, 12, 14, 15 inlet flows
        H2/CO2/CH4/H2O/Ar (sccm), col 16 total inlet flow, cols 17, 18, 19,
        21, 22 measured outlet flows (sccm), cols 24, 25, 26, 28, 29 outlet
        mole fractions. Empty cells are read as 0 (the loader's
        ``fillna(0)``).

        ``datalist`` selects experiment rows BY INDEX (the reference slices
        ``iloc[datalist[0]:datalist[-1]+1]``, ignoring the interior of its
        own list; the JAX package selects the listed rows, and so does
        this).

        Returns (Conditions, obs_flows (5, n), obs_molfractions (5, n)).
        """
        dev = resolve_device(device)
        raw = np.genfromtxt(path, delimiter=",", skip_header=1,
                            filling_values=0.0)
        # genfromtxt still yields NaN for empty cells (filling_values only
        # covers flagged missing tokens); the reference does fillna(0).
        raw = np.nan_to_num(np.atleast_2d(raw), nan=0.0)
        if datalist is not None:
            raw = raw[np.asarray(datalist)]
        t_in = raw[:, 7] + 273.0
        p_abs = raw[:, 9] * 1e6 + 101325.0
        flows_in = raw[:, (10, 11, 12, 14, 15)]
        tot = raw[:, 16]
        u_in = tot * 1.667e-8 / AREA * (101325.0 * t_in) / (p_abs * 298.0)
        c_in = (p_abs / (R_GAS * t_in))[:, None] * flows_in \
            / flows_in.sum(1)[:, None]
        cond = Conditions.from_numpy(dict(
            C_in=c_in, T_in=t_in, T_jacket=raw[:, 5] + 273.0, u_in=u_in,
            void=raw[:, 6], dz=(raw[:, 4] / 1000.0) / (nx - 1),
            P0=c_in.sum(1) * R_GAS * t_in), dev)

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)
        return (cond, f32(raw[:, (17, 18, 19, 21, 22)].T),
                f32(raw[:, (24, 25, 26, 28, 29)].T))

    def to_csv(self, path: str, nx: int = NX) -> None:
        """Inverse of :meth:`from_csv` (recovers the raw operating
        quantities)."""
        c = {k: getattr(self, k).double().cpu().numpy()
             for k in _COND_FIELDS}
        p_abs = c["P0"]
        frac = c["C_in"] / c["C_in"].sum(1)[:, None]
        tot_sccm = (c["u_in"] * AREA * p_abs * 298.0
                    / (1.667e-8 * 101325.0 * c["T_in"]))
        rows = np.column_stack([
            c["T_jacket"] - 273.0, c["T_in"] - 273.0,
            (p_abs - 101325.0) / 1e6,
            frac * tot_sccm[:, None], c["void"], c["dz"] * (nx - 1) * 1000.0])
        np.savetxt(path, rows, delimiter=",", header=self.CSV_HEADER,
                   comments="")


def condition_table_numpy(n_conditions: int = 30,
                          nx: int = NX,
                          t_jacket_c=(120.0, 180.0),
                          total_sccm=(200.0, 600.0),
                          h2_co2_ratio=(4.0, 5.0),
                          ar_frac=(0.15, 0.40),
                          p_gauge_mpa=(0.0, 0.2),
                          length_mm: float = 150.0,
                          void_frac: float = 0.39) -> dict:
    """The deterministic condition table as float32 NumPy arrays: the same
    arithmetic, in float64, as the reference's ``make_condition_table``, so
    the two tables are bit-identical."""
    i = np.arange(n_conditions)
    frac = (i * 0.6180339887) % 1.0  # golden-ratio low-discrepancy sweep
    tj = np.linspace(t_jacket_c[0], t_jacket_c[1], n_conditions) + 273.0
    tot = total_sccm[0] + frac * (total_sccm[1] - total_sccm[0])
    ratio = h2_co2_ratio[0] + ((i * 0.3819660113) % 1.0) * (
        h2_co2_ratio[1] - h2_co2_ratio[0])
    arf = ar_frac[0] + ((i * 0.2360679775) % 1.0) * (ar_frac[1] - ar_frac[0])
    pg = p_gauge_mpa[0] + ((i * 0.7639320225) % 1.0) * (
        p_gauge_mpa[1] - p_gauge_mpa[0])

    react = 1.0 - arf
    f_co2 = tot * react / (1.0 + ratio)
    f_h2 = tot * react * ratio / (1.0 + ratio)
    f_ar = tot * arf
    flows = np.stack([f_h2, f_co2, np.zeros(n_conditions),
                      np.zeros(n_conditions), f_ar], axis=1)  # (n, 5) sccm

    T_in = tj
    P_abs = pg * 1e6 + 101325.0
    u_in = tot * 1.667e-8 / AREA * (101325.0 * T_in) / (P_abs * 298.0)
    C_in = (P_abs / (R_GAS * T_in))[:, None] * flows / tot[:, None]
    dz = np.full(n_conditions, (length_mm / 1000.0) / (nx - 1))
    void = np.full(n_conditions, void_frac)
    P0 = C_in.sum(1) * R_GAS * T_in
    out = dict(C_in=C_in, T_in=T_in, T_jacket=tj, u_in=u_in, void=void,
               dz=dz, P0=P0)
    return {k: v.astype(np.float32) for k, v in out.items()}


def make_condition_table(n_conditions: int = 30, nx: int = NX,
                         device="cuda", **ranges) -> Conditions:
    """Deterministic lab-plausible condition table.

    Conditions sweep jacket temperature, total flow, H2:CO2 feed ratio, Ar
    dilution and pressure on low-discrepancy grids (reproducible; no RNG
    state). Inlet is CH4/H2O-free; T_in = T_jacket (preheated feed). The
    default ranges straddle the light-off curve of the true kinetics, and
    H2 is fed in stoichiometric excess so full conversion never drives
    concentrations negative. ``ranges`` are the keyword ranges of
    :func:`condition_table_numpy`."""
    return Conditions.from_numpy(
        condition_table_numpy(n_conditions, nx, **ranges), device)


# ---------------------------------------------------------------------------
# DAE residual (batch-last rows) and its Jacobian
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _grid_flags(nx: int, device="cpu") -> torch.Tensor:
    """(nx, 3) floats = [is_inlet, is_first_interior, is_outlet], made once
    per device (never written)."""
    f = np.zeros((nx, 3), np.float32)
    f[0, 0] = 1.0
    f[1, 1] = 1.0
    f[-1, 2] = 1.0
    return torch.as_tensor(f, device=device)


def initial_guess(cond: Conditions, nx: int = NX) -> torch.Tensor:
    """(n, nx, 7) initial state: inlet values everywhere, interior T=400."""
    n = cond.n_data
    y = torch.zeros((n, nx, 7), dtype=torch.float32, device=cond.device)
    y[:, :, :5] = cond.C_in[:, None, :]
    y[:, :, 5] = 400.0
    y[:, 0, 5] = cond.T_in
    y[:, :, 6] = cond.u_in[:, None]
    return y


def _local_rows(y_m, y, y_p, yd, flags, cond_vec, kin):
    """Residual rows for one grid point (the blocked engine's); the same
    physics as ``_rows_bl``, block-tridiagonal coupling.

    y_*: (7,) = [Ca..Ce, T, u] at the neighbour/current grid points.
    flags: (3,) floats = [is_inlet, is_first_interior, is_outlet].
    cond_vec: (5,) = [T_jacket, u_in, void, dz, P0]. kin: (8,).
    """
    T_jacket, u_in, void, dz, P0 = (cond_vec[0], cond_vec[1], cond_vec[2],
                                    cond_vec[3], cond_vec[4])
    is_inlet, is_first, is_outlet = flags[0], flags[1], flags[2]

    C_m, T_m, u_m = y_m[:5], y_m[5], y_m[6]
    C, T, u = y[:5], y[5], y[6]
    C_p, T_p = y_p[:5], y_p[5]
    Cd, Td = yd[:5], yd[5]

    sc = _row(SC, y.device, y.dtype)
    r = rate_rCH4(T, C[0], C[1], C[2], C[3], kin)

    # species balances (one-sided dispersion at the first interior point)
    conv = (u * C - u_m * C_m) / dz
    lap = torch.where(is_first > 0, C_p - C, C_p - 2.0 * C + C_m) / dz ** 2
    res_c = -void * Cd - conv + void * DZ_DISP * lap + (1 - void) * sc * r

    # total-mass balance (T-block row; transient term only at i=1)
    invT_m, invT, invT_p = 1.0 / T_m, 1.0 / T, 1.0 / T_p
    tmb = (-u * P0 * (invT - invT_m) / dz
           - P0 * invT * (u - u_m) / dz
           + void * DZ_DISP * P0 * (invT_p - 2.0 * invT + invT_m) / dz ** 2
           + (1 - void) * R_GAS * (-2.0) * r)
    tmb = tmb + torch.where(is_first > 0, P0 * void * invT ** 2 * Td, 0.0)

    # energy balance (u-block row; accumulation scaled 0.1 in the interior,
    # unscaled at i=1)
    rho = gas_density(C, T, P0)
    heatcap = void * rho * CPG + (1 - void) * RHOS * CPS
    kappa = torch.where(is_first > 0, 1.0, 0.1)
    enb = (-kappa * heatcap * Td
           - rho * CPG * (T * u - T_m * u_m) / dz
           + KEFF * (T_p - 2.0 * T + T_m) / dz ** 2
           + (1 - void) * (-HR) * r
           - 2.0 * U_HT / DINT * (T - T_jacket))

    pde_rows = torch.cat([res_c, tmb[None], enb[None]])
    # inlet: dX=0 for concentrations and T, u pinned to u_in
    inlet_rows = torch.cat([Cd, Td[None], (u - u_in)[None]])
    # outlet: zero gradient; the reference's swapped T/u rows
    outlet_rows = torch.cat([C - C_m, (u - u_m)[None], (T - T_m)[None]])
    return torch.where(is_inlet > 0, inlet_rows,
                       torch.where(is_outlet > 0, outlet_rows, pde_rows))


def solve_condition(y0: torch.Tensor, cond_vec: torch.Tensor,
                    kin: torch.Tensor, dts: torch.Tensor,
                    newton_iters: int = 3) -> torch.Tensor:
    """Integrate conditions to t_final with the blocked engine
    (ops/dae.py): y0 (..., nx, 7), cond_vec (..., 5), kin (..., 8), dts a
    tensor on y0's device; leading dims a batch of systems (one condition
    at one kinetic vector each). Returns the final states, y0's shape."""
    nx = y0.shape[-2]

    def rows(y_m, y, y_p, yd, fl, aux):
        return _local_rows(y_m, y, y_p, yd, fl, aux[:5], aux[5:])

    batch = y0.shape[:-2]
    aux = torch.cat([cond_vec.expand(*batch, 5), kin.expand(*batch, 8)],
                    dim=-1)
    return implicit_euler_dae(rows, y0, _grid_flags(nx, y0.device), dts,
                              newton_iters, aux=aux)


def outlet_flows(y_final: torch.Tensor) -> torch.Tensor:
    """Outlet standard-state flows (..., 5) in sccm from final states
    (..., nx, 7); the reference's T/P factors cancel."""
    C_out = y_final[..., -1, :5]
    u_out = y_final[..., -1, 6:7]
    return C_out * u_out * AREA * 60.0 * R_GAS * 298.0 / P_STP * 1e6


def outlet_molfractions(y_final: torch.Tensor) -> torch.Tensor:
    C_out = y_final[..., -1, :5]
    return C_out / torch.sum(C_out, -1, keepdim=True)


def _rows_bl(Y_m, Y, Y_p, Yd, flags, condv, kin):
    """Batch-last residual: Y_* (7, NX, B); flags (3, NX, 1); condv (5, B)
    = [T_jacket, u_in, void, dz, P0]; kin (8, B). Every op is elementwise
    over the flattened particle x condition batch on the lane axis."""
    T_jacket, u_in, void, dz, P0 = condv[0], condv[1], condv[2], condv[3], \
        condv[4]
    is_first = flags[1]                                   # (NX, 1)

    C_m, T_m, u_m = Y_m[:5], Y_m[5], Y_m[6]
    C, T, u = Y[:5], Y[5], Y[6]
    C_p, T_p = Y_p[:5], Y_p[5]
    Cd, Td = Yd[:5], Yd[5]

    sc = _const(SC, Y.device, Y.dtype)
    r = rate_rCH4(T, C[0], C[1], C[2], C[3], kin)        # (NX, B)

    conv = (u * C - u_m * C_m) / dz
    lap = torch.where(is_first > 0, C_p - C, C_p - 2.0 * C + C_m) / dz ** 2
    res_c = -void * Cd - conv + void * DZ_DISP * lap + (1 - void) * sc * r

    invT_m, invT, invT_p = 1.0 / T_m, 1.0 / T, 1.0 / T_p
    tmb = (-u * P0 * (invT - invT_m) / dz
           - P0 * invT * (u - u_m) / dz
           + void * DZ_DISP * P0 * (invT_p - 2.0 * invT + invT_m) / dz ** 2
           + (1 - void) * R_GAS * (-2.0) * r)
    tmb = tmb + torch.where(is_first > 0, P0 * void * invT ** 2 * Td, 0.0)

    mw = _const(MOLW, Y.device, Y.dtype)
    rho = P0 / (R_GAS * T) * torch.sum(C * mw, 0) / torch.sum(C, 0) * 1e-3
    heatcap = void * rho * CPG + (1 - void) * RHOS * CPS
    kappa = torch.where(is_first > 0, 1.0, 0.1)
    enb = (-kappa * heatcap * Td
           - rho * CPG * (T * u - T_m * u_m) / dz
           + KEFF * (T_p - 2.0 * T + T_m) / dz ** 2
           + (1 - void) * (-HR) * r
           - 2.0 * U_HT / DINT * (T - T_jacket))

    pde = torch.cat([res_c, tmb[None], enb[None]], dim=0)
    inlet = torch.cat([Cd, Td[None], (u - u_in)[None]], dim=0)
    outlet = torch.cat([C - C_m, (u - u_m)[None], (T - T_m)[None]], dim=0)
    fl = flags[:, None]  # (3, 1, NX, 1) -> broadcast over (7, NX, B)
    return torch.where(fl[0] > 0, inlet,
                       torch.where(fl[2] > 0, outlet, pde))


# Gaussian prior coefficients (std = coeff * |parameter|); parameters forced
# uniform in "taylor" mode.
NORMAL_COEFF = (0.5, 0.5, 0.5, 0.5, 0.3, 0.3, 0.3, 0.3, 0.5)
UNI_LIST = (0, 1, 2, 3, 8)

ENGINES = ("batch_last", "blocked")
MARCHES = ("transient", "steady")
JAC_MODES = ("full", "cd", "ad")


def _assemble(entries, y, pad_cols):
    """One Jacobian block from ``entries`` ((row, col) -> value
    broadcastable to (NX, B)); the rest, and ``pad_cols`` zero columns,
    stay zero. Assembled grid-major, as (NX, 7, ncol, B) in memory, and
    returned as a view in the reference's (7, ncol, NX, B) order: the
    march's sweeps and the kernels then read it without a copy."""
    nf, nx, bt = y.shape
    blk = torch.zeros((nx, nf, nf + pad_cols, bt), dtype=y.dtype,
                      device=y.device)
    for (i, j), v in entries.items():
        blk[:, i, j, :] = v
    return blk.permute(1, 2, 0, 3)


def _analytic_CD_jac(flags, condv, pad_cols: int = 0):
    """Closed-form y_p (slot 2) and yd (slot 3) Jacobian blocks of
    ``_rows_bl``: these slots enter only linearly (the dispersion and
    conduction stencils and the mass terms), so the march builds only the
    y_m and y slots by tangent passes (``jac_mode="cd"``, the autodiff
    cross-check path)."""
    is_inlet, is_first, is_outlet = flags[0], flags[1], flags[2]  # (NX, 1)
    void, dz, P0 = condv[2], condv[3], condv[4]

    def jac(y_m, y, y_p, yd):
        nf, nx, bt = y.shape
        T, T_p, C = y[5], y_p[5], y[:5]
        pde = (1.0 - is_inlet) * (1.0 - is_outlet)        # (NX, 1)
        ones = torch.ones((nx, bt), dtype=y.dtype, device=y.device)

        disp = pde * void * DZ_DISP / dz ** 2             # (NX, B)
        eC = {(k, k): disp for k in range(5)}
        eC[(5, 5)] = -disp * P0 / (T_p * T_p)
        eC[(6, 5)] = pde * KEFF / dz ** 2 * ones

        mw = _const(MOLW, y.device, y.dtype)
        rho = P0 / (R_GAS * T) * torch.sum(C * mw, 0) / torch.sum(C, 0) \
            * 1e-3
        heatcap = void * rho * CPG + (1 - void) * RHOS * CPS
        kappa = torch.where(is_first > 0, 1.0, 0.1)

        eD = {(k, k): is_inlet - pde * void for k in range(5)}
        eD[(5, 5)] = is_inlet + pde * is_first * P0 * void / (T * T)
        eD[(6, 5)] = pde * (-kappa * heatcap)
        return {2: _assemble(eC, y, pad_cols), 3: _assemble(eD, y, pad_cols)}

    return jac


def _jac_of(jac_mode: str, flags, condv, kin, pad_cols: int = 0):
    """The ``analytic_jac`` callback of a Jacobian mode: every slot in
    closed form ("full"), slots 2 and 3 ("cd"), or none ("ad": all 28
    block columns by tangent passes)."""
    if jac_mode == "full":
        return _analytic_full_jac(flags, condv, kin, pad_cols=pad_cols)
    if jac_mode == "cd":
        return _analytic_CD_jac(flags, condv, pad_cols=pad_cols)
    return None


def _fused_of(jac_mode: str, flags, condv, kin, pad_cols: int = 0):
    """The one-pass residual and Newton system of the march
    (``ops/march_cuda.py``) for the closed-form Jacobian on 7-column
    blocks; None otherwise (the tangent passes need the rows as PyTorch
    operations, and the kernels write no pad column)."""
    if jac_mode != "full" or pad_cols:
        return None
    return MarchKernels(flags, condv, kin)


def _analytic_full_jac(flags, condv, kin, pad_cols: int = 0):
    """Closed-form Jacobian blocks of ``_rows_bl`` for ALL four argument
    slots (0 = y_m, 1 = y, 2 = y_p, 3 = yd), each (7, 7 + pad_cols, NX, B).

    The rate-law partials are shared by the species, total-mass and energy
    rows, so the whole build is a handful of elementwise expressions per
    block entry. Each block is assembled grid-major, as (NX, 7, ncol, B)
    in memory, and returned as a view in the reference's (7, ncol, NX, B)
    order: the march's sweeps and the kernels then read it without a copy.
    """
    is_inlet, is_first, is_outlet = flags[0], flags[1], flags[2]  # (NX, 1)
    void, dz, P0 = condv[2], condv[3], condv[4]

    def jac(y_m, y, y_p, yd):
        nf, nx, bt = y.shape
        pde = (1.0 - is_inlet) * (1.0 - is_outlet)      # (NX, 1)
        C, T, u = y[:5], y[5], y[6]
        C_m, T_m, u_m = y_m[:5], y_m[5], y_m[6]
        T_p = y_p[5]
        Td = yd[5]
        invT, invT_m = 1.0 / T, 1.0 / T_m
        ones = torch.ones((nx, bt), dtype=y.dtype, device=y.device)

        def asm(entries):
            return _assemble(entries, y, pad_cols)

        # ---- rate-law partials (shared by rows 0-6) ----------------------
        RT6 = R_GAS * T * 1e-6
        PH2, PCO2 = C[0] * RT6, C[1] * RT6
        PCH4, PH2O = C[2] * RT6, C[3] * RT6
        kf = kin[0] * torch.exp(-kin[1] / (R_GAS * T))
        ks = kin[2] * torch.exp(-kin[3] / (R_GAS * T))
        kC = kin[4] * torch.exp(-kin[5] / (R_GAS * T))
        kW = kin[6] * torch.exp(-kin[7] / (R_GAS * T))
        PH2g = torch.clamp_min(PH2, 0.001)
        s = PH2g ** 0.5
        # The guard's derivative goes to PH2 on ties (PH2 >= 0.001).
        guard = (PH2 >= 0.001).to(y.dtype)
        a, b = kC * PCO2, kW * PH2O
        rf = 5075e3 * kf * a * s / (1.0 + a) ** 2
        rr = 5075e3 * ks * kW * PH2O * PCH4 ** 2 / (1.0 + b) ** 2
        invRT2 = 1.0 / (R_GAS * T * T)
        dr_dC = (
            rf * guard * (0.5 / PH2g) * RT6,                        # H2
            5075e3 * kf * s * kC * (1.0 - a) / (1.0 + a) ** 3 * RT6,  # CO2
            -(5075e3 * ks * kW * PH2O * 2.0 * PCH4
              / (1.0 + b) ** 2) * RT6,                              # CH4
            -(5075e3 * ks * PCH4 ** 2 * kW * (1.0 - b)
              / (1.0 + b) ** 3) * RT6,                              # H2O
        )
        dlnrf_dT = kin[1] * invRT2 + guard * 0.5 * invT \
            + (kin[5] * invRT2 + invT) * (1.0 - a) / (1.0 + a)
        dlnrr_dT = kin[3] * invRT2 + 2.0 * invT \
            + (kin[7] * invRT2 + invT) * (1.0 - b) / (1.0 + b)
        dr_dT = rf * dlnrf_dT - rr * dlnrr_dT

        # ---- density / heat-capacity partials (energy row) ---------------
        mw = _const(MOLW, y.device, y.dtype)
        S0, S1 = torch.sum(C, 0), torch.sum(C * mw, 0)
        rho = P0 * invT / R_GAS * S1 / S0 * 1e-3
        heatcap = void * rho * CPG + (1 - void) * RHOS * CPS
        kappa = torch.where(is_first > 0, 1.0, 0.1)
        # d(enb)/d(rho) prefactor: accumulation + convection terms.
        denb_drho = -kappa * void * CPG * Td \
            - CPG * (T * u - T_m * u_m) / dz
        drho_dT = -rho * invT

        sc = SC
        disp = void * DZ_DISP / dz ** 2

        # ---- slot 1: B (d rows / d y) ------------------------------------
        eB = {}
        lap_diag = disp * torch.where(is_first > 0, -1.0, -2.0)
        for k in range(5):
            diag = -u / dz + lap_diag
            if k < 4:
                diag = diag + (1 - void) * sc[k] * dr_dC[k]
            eB[(k, k)] = pde * diag + is_outlet * ones
            for j in range(4):
                if j != k:
                    eB[(k, j)] = pde * (1 - void) * sc[k] * dr_dC[j]
            eB[(k, 5)] = pde * (1 - void) * sc[k] * dr_dT
            eB[(k, 6)] = pde * (-C[k] / dz)
        # row 5: total-mass balance (outlet: u - u_m).
        for j in range(4):
            eB[(5, j)] = pde * (1 - void) * R_GAS * (-2.0) * dr_dC[j]
        eB[(5, 5)] = pde * (
            u * P0 * invT ** 2 / dz
            + P0 * (u - u_m) * invT ** 2 / dz
            + 2.0 * disp * P0 * invT ** 2
            + (1 - void) * R_GAS * (-2.0) * dr_dT
            - is_first * 2.0 * P0 * void * invT ** 3 * Td)
        eB[(5, 6)] = (pde * (-P0 * (invT - invT_m) / dz - P0 * invT / dz)
                      + is_outlet * ones)
        # row 6: energy balance (outlet: T - T_m; inlet: u - u_in).
        kappa0 = P0 * invT / R_GAS * 1e-3 / S0
        for j in range(5):
            entry = denb_drho * kappa0 * (MOLW[j] - S1 / S0)
            if j < 4:
                entry = entry + (1 - void) * (-HR) * dr_dC[j]
            eB[(6, j)] = pde * entry
        eB[(6, 5)] = (
            pde * (denb_drho * drho_dT - rho * CPG * u / dz
                   - 2.0 * KEFF / dz ** 2 + (1 - void) * (-HR) * dr_dT
                   - 2.0 * U_HT / DINT)
            + is_outlet * ones)
        eB[(6, 6)] = pde * (-rho * CPG * T / dz) + is_inlet * ones
        Bb = asm(eB)

        # ---- slot 0: A (d rows / d y_m) ----------------------------------
        eA = {}
        for k in range(5):
            eA[(k, k)] = (pde * (u_m / dz + disp * (1.0 - is_first))
                          - is_outlet * ones)
            eA[(k, 6)] = pde * (C_m[k] / dz)
        eA[(5, 5)] = pde * (-u * P0 * invT_m ** 2 / dz
                            - disp * P0 * invT_m ** 2)
        eA[(5, 6)] = pde * (P0 * invT / dz) - is_outlet * ones
        eA[(6, 5)] = (pde * (rho * CPG * u_m / dz + KEFF / dz ** 2)
                      - is_outlet * ones)
        eA[(6, 6)] = pde * (rho * CPG * T_m / dz)
        Ab = asm(eA)

        # ---- slots 2 & 3: C and D (linear in the state) ------------------
        eC = {(k, k): pde * disp * ones for k in range(5)}
        eC[(5, 5)] = -pde * disp * P0 / (T_p * T_p)
        eC[(6, 5)] = pde * KEFF / dz ** 2 * ones
        Cb = asm(eC)

        eD = {(k, k): (is_inlet - pde * void) * ones for k in range(5)}
        eD[(5, 5)] = is_inlet * ones + pde * is_first * P0 * void * invT ** 2
        eD[(6, 5)] = pde * (-kappa * heatcap)
        Db = asm(eD)
        return {0: Ab, 1: Bb, 2: Cb, 3: Db}

    return jac


class _SteadySolve(torch.autograd.Function):
    """The steady solve with the implicit-function-theorem adjoint as its
    backward (see :func:`_make_steady_solve`)."""

    @staticmethod
    def forward(ctx, kin_bl, condv, flags, y0, spec):
        # The march records no autograd graph (grad mode is off here).
        jac_mode, pad, march_kw = spec

        def rows(y_m, y, y_p, yd):
            return _rows_bl(y_m, y, y_p, yd, flags, condv, kin_bl)
        yf = steady_march_bl(rows, y0, analytic_jac=_jac_of(
            jac_mode, flags, condv, kin_bl, pad), fused=_fused_of(
                jac_mode, flags, condv, kin_bl, pad), **march_kw)
        ctx.save_for_backward(kin_bl, condv, flags, yf)
        ctx.h_max = march_kw.get("h_max", 1e6)
        return yf

    @staticmethod
    def backward(ctx, ybar):
        kin_bl, condv, flags, yf = ctx.saved_tensors

        def rows(y_m, y, y_p, yd):
            return _rows_bl(y_m, y, y_p, yd, flags, condv, kin_bl)

        # Jh = dF/dy + D/h_max at y*, the march's terminal Newton system
        # (alpha = 1, const = -y*: yd = 0 at the point, and the mass term
        # D/h_max regularizes the singular bare J), edge-folded as the
        # residual's neighbour shifts are; layout (NX, 7, 7, B).
        shift, _, build_blocks = _newton_kit(rows, yf, True,
                                             _analytic_full_jac(
                                                 flags, condv, kin_bl),
                                             "thomas")[:3]
        A_, B_, C_, _ = build_blocks(yf, 1.0, -yf, ctx.h_max)
        # J^T is block-tridiagonal with sub'_i = C_{i-1}^T, diag' = B_i^T,
        # super'_i = A_{i+1}^T (a blockwise transpose swaps the 7-axes).
        zpad = torch.zeros_like(A_[:1])
        A_T = torch.cat([zpad, C_.transpose(1, 2)[:-1]])
        C_T = torch.cat([A_.transpose(1, 2)[1:], zpad])
        lam = block_thomas_bl(A_T, B_.transpose(1, 2), C_T,
                              ybar.movedim(1, 0), pivot=True)
        # kin cotangent: the rows give -F, so pulling lam back through
        # them gives -lam^T dF/dkin, which is dl/dkin. Autograd switches
        # grad mode off inside a backward; this VJP needs it on.
        y_m, y_p = shift(yf)
        with torch.enable_grad():
            kin = kin_bl.detach().requires_grad_(True)
            F = _rows_bl(y_m, yf, y_p, torch.zeros_like(yf), flags, condv,
                         kin)
            (kbar,) = torch.autograd.grad(-F.movedim(1, 0), kin, lam)
        return kbar, None, None, None, None


def _make_steady_solve(steady_kwargs: dict):
    """The steady-state solve with a custom backward: the DIFFERENTIABLE
    flagship likelihood path. Returns ``solve(kin_bl, condv, flags, y0) ->
    yf``.

    Forward = the SER pseudo-transient march
    (``ops.dae_fast.steady_march_bl``), recording no autograd graph.
    Backward = the implicit-function-theorem adjoint at the converged
    state: with F(y*, kin) = 0,

        dl/dkin = -lambda^T dF/dkin,   Jh^T lambda = dl/dy*,

    i.e. ONE transposed block-tridiagonal solve (the pivoted plain
    ``block_thomas_bl``) plus one VJP of the residual rows with respect to
    the kinetic parameters: no backprop through the march, no stored
    trajectory.

    Jh = dF/dy* + D/h_max is the march's own terminal Newton system, not
    the bare steady Jacobian, which is numerically singular on this
    discretized reactor: the null component of lambda cancels in the kin
    contraction, and the regularized adjoint matches central differences
    (tests/test_torch_methanation_grad.py).

    A failed lane (yf = NaN from the march's convergence certificate), or
    a lane whose adjoint is not finite, gives a non-finite gradient in its
    own particle's row only: lanes never mix in the block solves. The
    gradient mutations set non-finite gradients to 0. The cotangents of
    condv, flags and y0 are None (the JAX package's are zeros): the steady
    state does not depend on the guess, and the conditions are data.

    The backward reads nothing on the host, so it captures into a CUDA
    graph with its forward (the gradient mutations' graphs)."""
    kw = dict(steady_kwargs)
    jac_mode, pad = kw.pop("jac_mode", "full"), kw.pop("pad", 0)
    spec = (jac_mode, pad, kw)

    def solve(kin_bl, condv, flags, y0):
        return _SteadySolve.apply(kin_bl, condv, flags, y0, spec)

    return solve


def methanation_prior(est_idx=EST_DEFAULT, mode: str = "uniform",
                      device="cuda") -> Prior:
    """Prior over the estimated parameter subset.

    - "uniform" (the default): bounds use_params +- use_params * k.
    - "normal": N(base_i, (coeff_i * |base_i|)^2).
    - "taylor": parameters in UNI_LIST keep the uniform prior, the rest are
      Gaussian (one mixed-kind Prior).
    """
    use = np.asarray(KIN_TRUE + (SIGMA_TRUE,))
    hi = use + use * np.asarray(HIGH_K)
    lo = use - use * np.asarray(LOW_K)
    specs = []
    for i in est_idx:
        normal = {"dist": "normal", "mu": float(use[i]),
                  "sigma": float(abs(use[i]) * NORMAL_COEFF[i])}
        uniform = {"dist": "uniform", "low": float(lo[i]),
                   "high": float(hi[i])}
        if mode == "uniform":
            specs.append(uniform)
        elif mode == "normal":
            specs.append(normal)
        elif mode == "taylor":
            specs.append(uniform if i in UNI_LIST else normal)
        else:
            raise ValueError(f"unknown prior mode {mode!r}")
    return Prior.from_specs(specs, device=device)


@dataclasses.dataclass(frozen=True)
class MethanationModel:
    """Batched methanation log-likelihood: all particles x conditions of a
    chunk are lanes of one implicit DAE march. Field names and defaults are
    the reference's, so one configuration means the same likelihood in both
    packages."""

    cond: Conditions
    obs: torch.Tensor                # (5, n_data) observed flows, sccm
    prior: Prior
    est_idx: Tuple[int, ...] = EST_DEFAULT
    base_params: Tuple[float, ...] = KIN_TRUE + (SIGMA_TRUE,)
    nx: int = NX
    t_final: float = 75.0
    # 48 BDF2 steps (growth 1.28) x 2 Newton iterations. Pivoting in the 7x7
    # block elimination is off by default: at physical states the blocks
    # are diagonally dominant, and a rare breakdown at extreme kinetic draws
    # yields inf/nan that the -10000 failure sentinel converts to a rejected
    # particle.
    n_steps: int = 48
    newton_iters: int = 2
    pivot: bool = False
    growth: float = 1.28
    # IDA-style Jacobian lag (ops/dae_fast.bdf_march_bl jac_stride): after
    # n_dense per-step-factored startup steps, factor the block-Thomas
    # Jacobian once per jac_stride steps and reuse it; the last dense_tail
    # steps factor per step again. The lagged middle of the dt schedule is
    # made piecewise-constant per block (block sums preserved). jac_stride=1
    # disables the lag.
    jac_stride: int = 6
    n_dense: int = 0
    reuse_iters: int = 1
    dense_tail: int = 6
    # Jacobian-block construction: "full" = closed-form blocks for all four
    # slots; "cd" = closed-form y_p/yd blocks and tangent passes for the
    # y_m/y slots (the autodiff cross-check); "ad" = all 28 block columns
    # by tangent passes (ops.dae_fast._tangent_blocks).
    jac_mode: str = "full"
    # Linear solver for the Newton updates: "auto"/"thomas_pl" = the CUDA
    # block-Thomas kernels (their plain versions on the CPU); "thomas" = the
    # plain loops on any device; "cr" = block cyclic reduction; "babe" =
    # the two-ended block-Thomas sweep (odd nx). See
    # ops.dae_fast.resolve_solver. Under a gradient the kernels solve
    # through ops.thomas_cuda.block_thomas_solve_pl, whose backward is the
    # transposed-solve kernel.
    solver: str = "auto"
    # Particles are processed in chunks of (chunk x n_data) simultaneous DAE
    # systems, which bounds the live Jacobian working set
    # (6 x 49 x NX x chunk x n_data x 4 B of blocks and factors). Any N
    # works (the trailing chunk is padded).
    particle_chunk: int = 512
    # "batch_last": the lanes-major engine (ops/dae_fast.py), the hot path.
    # "blocked": the per-system engine (ops/dae.py), the oracle for tests;
    # it ignores the solver, chunk and Jacobian-lag settings.
    engine: str = "batch_last"
    # "transient": time-accurate BDF2 to t_final. "steady": per-lane SER
    # pseudo-transient continuation straight to the t -> inf steady state
    # (ops.dae_fast.steady_march_bl; ptc_steps pseudo-steps from ptc_dt0,
    # growth capped at ptc_growth with floor ptc_floor, the factors reused
    # ptc_lag - 1 times with ptc_reuse_iters applies), valid because the
    # likelihood reads only the endpoint; its gradient is the
    # implicit-function adjoint (_make_steady_solve). batch_last engine
    # only (the blocked engine marches in time whatever this says).
    march: str = "transient"
    ptc_steps: int = 14
    ptc_dt0: float = 0.02
    ptc_growth: float = 6.0
    ptc_floor: float = 2.0
    ptc_lag: int = 2
    ptc_reuse_iters: int = 1
    # A (particles, data) mesh (parallel/mesh.py::make_mesh): each process
    # of a "data" group marches n_data / n_d of the conditions for the
    # particle rows it is given; the log-likelihood is summed over the
    # group. None: every condition here.
    lane_mesh: object = None

    def __post_init__(self):
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}; one of "
                             f"{ENGINES}")
        if self.march not in MARCHES:
            raise ValueError(f"unknown march {self.march!r}; one of "
                             f"{MARCHES}")
        if self.jac_mode not in JAC_MODES:
            raise ValueError(f"unknown jac_mode {self.jac_mode!r}; one of "
                             f"{JAC_MODES}")
        if self.lane_mesh is not None:
            n_d = self.lane_mesh.size(1)
            if self.cond.n_data % n_d:
                raise ValueError(f"{self.cond.n_data} conditions do not "
                                 f"divide over {n_d} data ranks")
        if resolve_solver(self.solver) == "babe" and self.nx % 2 == 0:
            raise ValueError(f"babe solver requires odd NX, got {self.nx}")

    @property
    def device(self) -> torch.device:
        return self.obs.device

    @property
    def param_names(self) -> Tuple[str, ...]:
        return tuple(PARAM_NAMES[i] for i in self.est_idx)

    @property
    def _n_dense_eff(self) -> int:
        """Leading per-step-factored steps, rounded up so the lagged middle
        is an exact number of jac_stride blocks."""
        k = self.jac_stride
        n_lag = self.n_steps - self.n_dense - self.dense_tail
        return self.n_dense + n_lag % k

    def _dts(self) -> np.ndarray:
        """The step schedule, float32 on the host (the march turns it into
        scalar coefficients there)."""
        dts = geometric_schedule(self.t_final, self.n_steps, self.growth)
        if (self.engine == "batch_last" and not self.pivot
                and self.jac_stride > 1):
            # Flatten the lagged middle to piecewise-constant h per block.
            k, nd = self.jac_stride, self._n_dense_eff
            nl = self.n_steps - self.dense_tail
            mid = dts[nd:nl].reshape(-1, k)
            dts = np.concatenate(
                [dts[:nd], np.repeat(mid.mean(1), k).astype(np.float32),
                 dts[nl:]])
        return dts

    def _cond_vecs(self) -> torch.Tensor:
        c = self.cond
        return torch.stack([c.T_jacket, c.u_in, c.void, c.dz, c.P0], dim=1)

    def simulate_flows(self, kin: torch.Tensor) -> torch.Tensor:
        """(5, n_data) outlet flows at one kinetic parameter vector, with the
        -10000 failure sentinel applied per condition."""
        if self.engine == "blocked":
            return self._flows_blocked(kin[None])[0]
        return self._flows_batch_bl(kin[None])[0]

    def _flows_blocked(self, kin_b: torch.Tensor) -> torch.Tensor:
        """Blocked engine: kin_b (Nc, 8) -> flows (Nc, 5, n_data), every
        (particle, condition) system through ``solve_condition`` at once,
        with the failure sentinel per condition (the JAX package maps the
        per-system solve with vmap over conditions and particles)."""
        n, nc = kin_b.shape[0], self.cond.n_data
        y0 = initial_guess(self.cond, self.nx).expand(n, -1, -1, -1)
        dts = torch.as_tensor(self._dts(), device=kin_b.device)
        yf = solve_condition(y0, self._cond_vecs()[None], kin_b[:, None],
                             dts, self.newton_iters)   # (Nc, nc, NX, 7)
        flows = outlet_flows(yf)                       # (Nc, nc, 5)
        ok = torch.all(torch.isfinite(flows)
                       & (torch.abs(flows) < FLOW_SANE), dim=-1,
                       keepdim=True)
        return torch.where(ok, flows, FAILURE_SENTINEL).transpose(1, 2)

    def simulate_molfractions(self, kin: torch.Tensor) -> torch.Tensor:
        """(5, n_data) outlet mole fractions (failure -> 0). Kept for
        parity plots; the likelihood itself is on flows."""
        flows = self.simulate_flows(kin)          # sentinel already applied
        ok = torch.all(flows != FAILURE_SENTINEL, dim=0, keepdim=True)
        tot = torch.sum(torch.where(ok, flows, 0.0), dim=0, keepdim=True)
        return torch.where(ok & (tot > 0),
                           flows / torch.where(tot == 0, 1.0, tot), 0.0)

    def _lane_tensors(self, kin_b: torch.Tensor):
        """kin_b (Nc, 8) -> (kin_bl (8, B), condv (5, B), flags (3, NX, 1),
        y0 (7, NX, B)) of the flattened batch: particles x conditions on
        one lane axis B = Nc * n_data (particle-major), y0 the initial
        guess."""
        nc = self.cond.n_data
        n = kin_b.shape[0]
        kin_bl = kin_b.T[:, :, None].expand(-1, n, nc).reshape(-1, n * nc)
        condv = self._cond_vecs().T.repeat(1, n)           # (5, B)
        y0 = initial_guess(self.cond, self.nx)             # (nc, NX, 7)
        y0 = y0.permute(2, 1, 0).repeat(1, 1, n)           # (7, NX, B)
        flags = _grid_flags(self.nx, self.device).T[:, :, None]  # (3, NX, 1)
        return kin_bl, condv, flags, y0

    def _lane_problem(self, kin_b: torch.Tensor, pad_cols: int = 0):
        """kin_b (Nc, 8) -> (rows, jac, y0, fused): the residual and
        Jacobian callbacks the marches take (``jac`` by ``jac_mode``; None
        for "ad"), the initial guess (7, NX, B) and the one-pass kernels
        of both (``_fused_of``; None but for "full" on 7 columns).
        ``pad_cols=1`` makes ``jac`` emit 8-column blocks, the reference's
        padded layout."""
        kin_bl, condv, flags, y0 = self._lane_tensors(kin_b)

        def rows(y_m, y, y_p, yd):
            return _rows_bl(y_m, y, y_p, yd, flags, condv, kin_bl)

        mode = self.jac_mode
        return (rows, _jac_of(mode, flags, condv, kin_bl, pad_cols), y0,
                _fused_of(mode, flags, condv, kin_bl, pad_cols))

    def _steady_kwargs(self, pad_cols: int = 0) -> dict:
        """The steady solve's settings, as the JAX package passes them."""
        return dict(jac_mode=self.jac_mode, pad=pad_cols,
                    n_steps=self.ptc_steps, h0=self.ptc_dt0,
                    grow_cap=self.ptc_growth, grow_floor=self.ptc_floor,
                    lag=self.ptc_lag, reuse_iters=self.ptc_reuse_iters,
                    newton_iters=self.newton_iters, pivot=self.pivot,
                    solver=self.solver)

    def _flows_batch_bl(self, kin_b: torch.Tensor, pad_cols: int = 0
                        ) -> torch.Tensor:
        """kin_b (Nc, 8) -> flows (Nc, 5, n_data): ONE batch-last march
        (transient BDF or steady) for all Nc * n_data systems. With
        ``pad_cols=1`` the march runs on padded factors (the stride-8 apply
        kernel) and must give the same flows."""
        nc = self.cond.n_data
        n = kin_b.shape[0]
        if self.march == "steady":
            solve = _make_steady_solve(self._steady_kwargs(pad_cols))
            yf = solve(*self._lane_tensors(kin_b))
        else:
            rows, jac, y0, fused = self._lane_problem(kin_b, pad_cols)
            yf = bdf_march_bl(rows, y0, self._dts(),
                              newton_iters=self.newton_iters,
                              pivot=self.pivot,
                              analytic_jac=jac,
                              jac_stride=self.jac_stride,
                              n_dense=self._n_dense_eff,
                              reuse_iters=self.reuse_iters,
                              dense_tail=self.dense_tail,
                              solver=self.solver, fused=fused)
        flows = (yf[:5, -1, :] * yf[6, -1, :] * AREA * 60.0 * R_GAS * 298.0
                 / P_STP * 1e6)                            # (5, B)
        flows = flows.reshape(5, n, nc)
        ok = torch.all(torch.isfinite(flows)
                       & (torch.abs(flows) < FLOW_SANE), dim=0, keepdim=True)
        flows = torch.where(ok, flows, FAILURE_SENTINEL)
        return flows.movedim(1, 0)                         # (Nc, 5, nc)

    def _ll_from_flows(self, flows: torch.Tensor, sigma: torch.Tensor,
                       obs: Optional[torch.Tensor] = None):
        """flows (..., 5, n_data), sigma (...,) -> log-lik (...,): Gaussian
        without the 2*pi constant; -inf where it is not finite. ``obs``
        replaces the model's observations (anything that broadcasts against
        ``flows``, such as one set per population of an ensemble)."""
        obs = self.obs if obs is None else obs
        sigma_safe = torch.clamp_min(sigma, 1e-12)
        resid = flows - obs
        n_data = obs.shape[-1]
        ll = torch.sum(-(0.5 / sigma_safe[..., None, None] ** 2) * resid ** 2,
                       dim=(-1, -2)) - 5 * n_data * torch.log(sigma_safe)
        return torch.where(torch.isfinite(ll), ll, -torch.inf)

    def log_likelihood(self, theta: torch.Tensor):
        """theta (N, n_est) -> (log_lik (N,), flows (N, 5, n_data)).

        All particles' parameters are scattered into full 9-vectors (the
        base-parameter overwrite of subset estimation) and the flattened
        particle x condition batch runs through one lanes-major march per
        chunk of ``particle_chunk`` particles.

        Gradients (a theta that requires grad: the gradient mutations,
        MAP): with ``march="steady"`` through the implicit-function adjoint,
        whatever the solver; with ``march="transient"`` through the march
        itself, as the JAX package differentiates its XLA scan: on "auto"
        and "thomas_pl" the block-Thomas kernels with the transposed-solve
        kernel as their backward (``ops/thomas_cuda.py::
        block_thomas_solve_pl``), on "thomas", "cr" and "babe" the plain
        loops.
        """
        if self.lane_mesh is not None:
            return self._lane_mesh_log_likelihood(theta)
        flows, sigma = self._flows_and_sigma(theta)
        return self._ll_from_flows(flows, sigma), flows

    @functools.cached_property
    def _lane_share(self):
        """(this process's model over its share of the conditions, the
        mesh's "data" axis)."""
        from smc_tpu_torch.parallel.mesh import particle_sharding
        ax = particle_sharding(self.lane_mesh).data
        per = self.cond.n_data // ax.size
        mine = list(range(ax.rank * per, (ax.rank + 1) * per))
        part = dataclasses.replace(self, cond=self.cond.select(mine),
                                   obs=self.obs[:, mine], lane_mesh=None)
        return part, ax

    def _lane_mesh_log_likelihood(self, theta: torch.Tensor):
        """``log_likelihood`` with the conditions split over the lane
        mesh's "data" axis: this process marches its conditions for the
        rows ``theta`` (N, n_est) it is given (kernels 6 and 8 on the
        smaller lane count), its part of the Gaussian sum is all-reduced
        over the axis, and the flows (N, 5, n_data) are all-gathered in
        condition order. A failed lane carries its -10000 sentinel in the
        flows every process returns; its term enters the sum once, from
        the process that marched it. One process: the unsplit bits.

        Differentiable (``march="steady"``): ``theta`` is the same on every
        process of the axis, so its gradient is the sum of each process's
        conditions' gradients (``Axis.replicated``), the same on all of
        them, and the replicated rows take the same proposals."""
        part, ax = self._lane_share
        flows, sigma = part._flows_and_sigma(ax.replicated(theta))
        ll = ax.sum(part._ll_from_flows(flows, sigma))
        flows = torch.cat(list(ax.gather(flows).unbind(0)), dim=-1)
        return torch.where(torch.isfinite(ll), ll, -torch.inf), flows

    def _flows_and_sigma(self, theta: torch.Tensor):
        """theta (N, n_est) -> (flows (N, 5, n_data), sigma (N,)): the part
        of the likelihood that does not read the observations."""
        n = theta.shape[0]
        # No host-to-device copy per call (a captured graph could not hold
        # one): the base row and the index are made once per device.
        full = _row(self.base_params, theta.device, theta.dtype).repeat(n, 1)
        full.index_copy_(1, _row(self.est_idx, theta.device), theta)
        kin_b, sigma = full[:, :8], full[:, 8]

        if self.engine == "blocked":
            return self._flows_blocked(kin_b), sigma
        chunk = min(self.particle_chunk, n)
        if n == chunk:
            flows = self._flows_batch_bl(kin_b)
        else:
            # Pad the trailing chunk (repeat the last particle) so any N
            # works.
            n_pad = (-n) % chunk
            kin_p = torch.cat([kin_b, kin_b[-1:].repeat(n_pad, 1)]) \
                if n_pad else kin_b
            flows = torch.cat([self._flows_batch_bl(k)
                               for k in kin_p.split(chunk)])[:n]
        return flows, sigma

    # -- construction -------------------------------------------------------
    @staticmethod
    def from_csv(conditions_csv: str, data_csv: str, est_idx=EST_DEFAULT,
                 nx: int = NX, prior_mode: str = "uniform", datalist=None,
                 device="cuda", **solver_kw) -> "MethanationModel":
        """Real-data mode: operating conditions from ``conditions_csv``
        (schema: ``Conditions.CSV_HEADER``) and observed outlet flows from
        ``data_csv`` ((5, n_data), sccm, no header). ``datalist`` selects
        an experiment subset by row index."""
        dev = resolve_device(device)
        cond = Conditions.from_csv(conditions_csv, nx=nx, device=dev)
        obs = np.atleast_2d(np.loadtxt(data_csv, delimiter=","))
        if obs.shape != (5, cond.n_data):
            raise ValueError(f"data.csv shape {obs.shape} != (5, "
                             f"{cond.n_data})")
        if datalist is not None:
            cond = cond.select(datalist)
            obs = obs[:, np.asarray(datalist)]
        return MethanationModel(
            cond=cond,
            obs=torch.as_tensor(np.asarray(obs, np.float32), device=dev),
            prior=methanation_prior(est_idx, mode=prior_mode, device=dev),
            est_idx=tuple(est_idx), nx=nx, **solver_kw)

    @staticmethod
    def from_reference_csv(information_csv: str, est_idx=EST_DEFAULT,
                           nx: int = NX, prior_mode: str = "uniform",
                           datalist=None, device="cuda", **solver_kw
                           ) -> "MethanationModel":
        """Build from a file in the reference's information.csv layout
        (``Conditions.from_reference_csv``), with the measured outlet flows
        in that file as the observations."""
        dev = resolve_device(device)
        cond, obs_flows, _ = Conditions.from_reference_csv(
            information_csv, datalist=datalist, nx=nx, device=dev)
        return MethanationModel(
            cond=cond, obs=obs_flows,
            prior=methanation_prior(est_idx, mode=prior_mode, device=dev),
            est_idx=tuple(est_idx), nx=nx, **solver_kw)

    @staticmethod
    def default(n_conditions: int = 30, est_idx=EST_DEFAULT,
                seed: Optional[int] = None, noise: bool = True, nx: int = NX,
                datalist=None, device="cuda", **solver_kw
                ) -> "MethanationModel":
        """Model over the synthetic condition table with observations
        generated from the true parameters + N(0, sigma_true) noise (drawn
        from a CPU ``torch.Generator`` seeded with ``seed``; not the JAX
        package's noise, so compare the two packages on shared arrays).
        ``datalist`` selects a subset of the generated conditions by
        index."""
        dev = resolve_device(device)
        cond = make_condition_table(n_conditions, nx=nx, device=dev)
        if datalist is not None:
            cond = cond.select(datalist)
            n_conditions = cond.n_data
        model0 = MethanationModel(
            cond=cond,
            obs=torch.zeros((5, n_conditions), dtype=torch.float32,
                            device=dev),
            prior=methanation_prior(est_idx, device=dev),
            est_idx=tuple(est_idx), nx=nx, **solver_kw)
        flows_obs = model0.simulate_flows(
            torch.tensor(KIN_TRUE, dtype=torch.float32, device=dev))
        if noise:
            gen = torch.Generator().manual_seed(
                20250205 if seed is None else seed)
            flows_obs = flows_obs + SIGMA_TRUE * torch.randn(
                flows_obs.shape, generator=gen).to(dev)
        return dataclasses.replace(model0, obs=flows_obs)

"""The transient methanation march's gradient through the block-Thomas
kernels' route on the CPU (``solver="auto"``, where the kernel wrappers
take their plain versions): the plain transposed solve
(``ops/dae_fast.py::block_thomas_apply_t``) against a dense solve of the
transposed system; ``gradcheck`` of the solve's ``torch.autograd.Function``
(``ops/thomas_cuda.py::block_thomas_solve_pl``) in float64 and its
gradient against autograd through the plain factor and apply loops; the
lagged default-kind schedule's likelihood gradient against the port's
plain-loop ("thomas") gradient and central differences; MALA and HMC runs
on "auto" to gamma = 1. Nothing here compiles a JAX program: the "auto"
gradient against ``jax.grad`` of the JAX model is
``test_torch_methanation_grad.py::
test_transient_gradient_through_the_plain_loops``, on the JAX gradient
that file compiles already (the lagged march's gradient took XLA:CPU about
two minutes to compile)."""
import dataclasses

import numpy as np
import pytest
import torch

from smc_tpu_torch import SMCConfig, run_smc
from smc_tpu_torch.ops import dae_fast as T
from smc_tpu_torch.ops import thomas_cuda as TC
from tests.torch_parity import methanation_pair

THETAS = np.asarray([[13.04, 52.2e3, 1.147e5, 96.7e3, 5.0],
                     [15.0, 52.5e3, 1.5e5, 9.7e4, 4.0]], np.float32)
# The default kind of schedule, cut short: a lagged Jacobian (stride 3)
# with predictor and cj compensation, then a per-step-factored tail.
LAGGED = dict(n_steps=12, growth=1.6, jac_stride=3, dense_tail=3,
              particle_chunk=4)


def _system(seed, nx, b, dtype=np.float64):
    """Random diagonally dominant blocks (A[0] and C[-1] zero) and a
    right-hand side."""
    rng = np.random.default_rng(seed)
    A = 0.3 * rng.standard_normal((nx, 7, 7, b))
    C = 0.3 * rng.standard_normal((nx, 7, 7, b))
    B = 0.3 * rng.standard_normal((nx, 7, 7, b)) \
        + 4.0 * np.eye(7)[None, :, :, None]
    A[0], C[-1] = 0.0, 0.0
    r = rng.standard_normal((nx, 7, b))
    return [torch.from_numpy(a.astype(dtype)) for a in (A, B, C, r)]


def _dense(A, B, C):
    """The assembled (b, 7 NX, 7 NX) matrices of the block systems."""
    nx, _, _, b = A.shape
    M = torch.zeros((b, 7 * nx, 7 * nx), dtype=A.dtype)
    for i in range(nx):
        rows = slice(7 * i, 7 * i + 7)
        M[:, rows, rows] = B[i].permute(2, 0, 1)
        if i > 0:
            M[:, rows, 7 * i - 7:7 * i] = A[i].permute(2, 0, 1)
        if i < nx - 1:
            M[:, rows, 7 * i + 7:7 * i + 14] = C[i].permute(2, 0, 1)
    return M


@pytest.mark.parametrize("ncol", [7, 8])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_transposed_solve_matches_a_dense_solve(ncol, dtype):
    """M^T lam = g from the no-pivot factors against
    ``torch.linalg.solve(M^T, g)`` in float64 on the assembled matrix:
    1e-12 of lam's largest entry in float64, 1e-5 in float32; 8-column
    (padded) factors give the 7-column bits."""
    A, B, C, g = _system(1, 11, 5, dtype)
    LUs, ms = T.block_thomas_factor(A, B, C)
    Cf = C
    if ncol == 8:
        LUs, ms, Cf = TC.pad_factors(LUs, ms, C)
    lam = TC.block_thomas_apply_t_pl(LUs, ms, Cf, g)
    if ncol == 8:
        assert torch.equal(lam, T.block_thomas_apply_t(
            LUs[:, :, :7], ms[:, :, :7], C, g))
    M = _dense(A, B, C).double()
    want = torch.linalg.solve(M.transpose(1, 2),
                              g.double().permute(2, 0, 1).reshape(5, -1))
    got = lam.double().permute(2, 0, 1).reshape(5, -1)
    tol = 1e-12 if dtype == np.float64 else 1e-5
    assert (got - want).abs().max() <= tol * want.abs().max()


def _solve_fn(A, B, C, r):
    """The march's route: factor the detached blocks, solve through the
    Function with the tracked ones."""
    LUs, ms, _ = TC.block_thomas_factor_pl(A.detach(), B.detach(),
                                           C.detach())
    return TC.block_thomas_solve_pl(A, B, C, LUs, ms, r)


def test_solve_function_gradcheck_float64():
    """``torch.autograd.gradcheck`` of the solve (blocks and rhs, every
    factor recomputed from the perturbed blocks) in float64."""
    ins = [t.requires_grad_(True) for t in _system(2, 3, 2)]
    assert torch.autograd.gradcheck(_solve_fn, ins)


@pytest.mark.parametrize("ncol", [7, 8])
def test_solve_gradient_matches_autograd_through_the_plain_loops(ncol):
    """The Function's vector-Jacobian product against autograd through
    ``block_thomas_factor`` + ``block_thomas_apply`` in float32, 1e-5 of
    each cotangent's largest entry, at 7- and 8-column blocks (the pad
    column's cotangent zero); A[0] and C[-1] get zero."""
    A, B, C, r = _system(3, 11, 6, np.float32)
    w = torch.from_numpy(np.random.default_rng(4).standard_normal(
        r.shape).astype(np.float32))
    ins = [t.clone().requires_grad_(True) for t in (A, B, C, r)]
    blk = [TC.pad_blocks(*ins[:3])[i] if ncol == 8 else ins[i]
           for i in range(3)]
    x = _solve_fn(*blk, ins[3])
    got = torch.autograd.grad((x * w).sum(), ins)
    plain = [t.clone().requires_grad_(True) for t in (A, B, C, r)]
    xp = T.block_thomas_apply(*T.block_thomas_factor(*plain[:3]), plain[2],
                              plain[3])
    want = torch.autograd.grad((xp * w).sum(), plain)
    torch.testing.assert_close(x, xp, rtol=0, atol=1e-6)
    for g, gw in zip(got, want):
        assert (g - gw).abs().max() <= 1e-5 * gw.abs().max()
    assert not got[0][0].any() and not got[2][-1].any()


@pytest.fixture(scope="module")
def lagged_pair():
    return methanation_pair(2, 11, solver="auto", **LAGGED)


def _port_grads(tm, thetas):
    th = torch.as_tensor(thetas).clone().requires_grad_(True)
    ll, _ = tm.log_likelihood(th)
    (g,) = torch.autograd.grad(ll.sum(), th)
    return ll.detach().numpy(), g.numpy()


def test_lagged_auto_gradient_matches_the_plain_loops(lagged_pair):
    """The lagged march's likelihood gradient on "auto" (the kernels'
    route, their plain versions here), where one set of stale factors
    serves several solves, against the port's plain-loop ("thomas")
    gradient within 1e-4 of each parameter's largest |g|, the likelihoods
    equal to 1e-6 relative; the solve's backward is what autograd ran."""
    tm = lagged_pair[1]
    ll, g = _port_grads(tm, THETAS)
    llp, gp = _port_grads(dataclasses.replace(tm, solver="thomas"), THETAS)
    assert np.isfinite(g).all()
    np.testing.assert_allclose(ll, llp, rtol=1e-6)
    scale = np.abs(gp).max(axis=0)
    assert (np.abs(g - gp) <= 1e-4 * scale).all(), (g, gp)
    th = torch.from_numpy(THETAS).requires_grad_(True)
    seen, stack = set(), [tm.log_likelihood(th)[0].grad_fn]
    while stack:
        f = stack.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        stack += [n for n, _ in f.next_functions]
    assert any("_SolveBackward" in type(f).__name__ for f in seen)


def test_lagged_auto_gradient_matches_central_differences(lagged_pair):
    """Af, Eaf and sigma within 10% of central differences at 1e-3 |theta|
    on "auto", as the plain solvers are held
    (``test_torch_methanation_grad.py``)."""
    tm = lagged_pair[1]
    th0 = THETAS[1]
    _, g = _port_grads(tm, th0[None])

    def f(th):
        return float(tm.log_likelihood(torch.from_numpy(th[None]))[0][0])
    for i in (0, 1, 4):
        eps = 1e-3 * abs(th0[i])
        tp, tn = th0.copy(), th0.copy()
        tp[i] += eps
        tn[i] -= eps
        fd = (f(tp) - f(tn)) / (2 * eps)
        assert abs(g[0, i] - fd) < 0.1 * abs(fd), (i, g[0, i], fd)


@pytest.mark.parametrize("kind", ["mala", "hmc"])
def test_gradient_runs_on_auto_reach_gamma_one(lagged_pair, kind):
    """run_smc with the gradient kinds on the kernels' route: 8 particles
    to gamma = 1, finite particles and log-evidence."""
    tm = dataclasses.replace(lagged_pair[1], particle_chunk=8)
    cfg = SMCConfig(n_particles=8, mutation=kind, hmc_leapfrog=2,
                    mh_steps=1, mh_steps_final=2)
    s = run_smc(tm, cfg, 0, verbose=False)
    assert float(s.gamma) == 1.0
    assert bool(torch.isfinite(s.particles).all())
    assert np.isfinite(float(s.log_evidence))

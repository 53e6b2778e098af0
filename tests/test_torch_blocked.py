"""The port's per-system ("blocked") methanation engine (``ops/dae.py``,
``ops/linalg.py``, ``models/methanation.py`` with ``engine="blocked"``)
against the JAX package's blocked engine and against the port's own
lanes-major engine with ``pivot=True`` (the same full-Newton iteration).

At nx = 11 and 2 conditions, the JAX side compiles one march (its blocked
``log_likelihood`` jitted once for one theta shape). JAX models are built
by ``tests/torch_parity.py::methanation_pair``.

Tolerances: ``solve_small`` rtol 2e-3 and atol 1e-4 against float64
``numpy.linalg.solve`` (the JAX test's), and 1e-5 of the solution's scale
against the JAX function; the blocked flows rtol 1e-4 and atol 1e-3 sccm
of the JAX blocked engine's (float32 in another operation order, its
local Jacobians by another AD), and rtol 1e-3, atol 5e-3 of the lanes-major
engine's (the JAX package's engine-agreement tolerance).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smc_tpu.ops.linalg import solve_small as j_solve_small
from smc_tpu_torch.models import methanation as TM
from smc_tpu_torch.ops.dae import block_thomas_solve, implicit_euler_dae
from smc_tpu_torch.ops.linalg import solve_small
from tests.torch_parity import methanation_pair

THETA = np.asarray([[13.04, 52.2e3, 1.147e5, 96.7e3, 5.0],
                    [18.0, 54e3, 2e5, 1.0e5, 4.0],
                    [13.04, 52.2e3, 1.147e5, 96.7e3, -1.0]], np.float32)


@pytest.fixture(scope="module")
def models():
    """The port's blocked and lanes-major (pivot=True) models at nx = 11,
    2 conditions, 10 BDF2 steps (the JAX engine-agreement test's
    schedule), and the JAX blocked engine's (ll, flows) at THETA."""
    jm, tm = methanation_pair(2, 11, n_steps=10, growth=1.6, pivot=True,
                              particle_chunk=4)
    jb = dataclasses.replace(jm, engine="blocked")
    want = tuple(np.asarray(a) for a in
                 jax.jit(jb.log_likelihood)(jnp.asarray(THETA)))
    return dataclasses.replace(tm, engine="blocked"), tm, want


@pytest.mark.parametrize("k", [1, 3])
def test_solve_small_matches_jax_and_numpy(k):
    rng = np.random.default_rng(k)
    A = rng.normal(size=(33, 7, 7)).astype(np.float32)
    A[:, 0, 0] = 0.0                                 # force pivoting
    A[0] = np.eye(7)[::-1]                           # a pure permutation
    b = rng.normal(size=(33, 7, k)).astype(np.float32)
    rhs = b[..., 0] if k == 1 else b
    got = solve_small(torch.from_numpy(A), torch.from_numpy(rhs)).numpy()
    want = np.asarray(j_solve_small(jnp.asarray(A), jnp.asarray(rhs)))
    ref = np.linalg.solve(A.astype(np.float64), b.astype(np.float64))
    ref = ref[..., 0] if k == 1 else ref
    assert got.shape == rhs.shape
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_solve_small_zero_pivot_guard():
    """A singular system divides by the 1e-30 guard, as in the JAX
    package: large but not a NaN from 0/0 in the pivot itself."""
    A = torch.zeros((1, 3, 3))
    A[0, 0, 0] = 1.0
    x = solve_small(A, torch.ones((1, 3)))
    want = np.asarray(j_solve_small(jnp.asarray(A.numpy()),
                                    jnp.ones((1, 3))))
    np.testing.assert_array_equal(x.numpy(), want)


def test_block_thomas_matches_dense_solve():
    """The recurrence over NX against numpy's dense solve of the assembled
    block-tridiagonal matrix, for a batch of 3 systems."""
    rng = np.random.default_rng(1)
    nb, nx, b = 3, 6, 7
    A = rng.normal(size=(nb, nx, b, b)) * 0.3
    B = rng.normal(size=(nb, nx, b, b)) + 4.0 * np.eye(b)
    C = rng.normal(size=(nb, nx, b, b)) * 0.3
    r = rng.normal(size=(nb, nx, b))
    x = block_thomas_solve(*(torch.tensor(a, dtype=torch.float32)
                             for a in (A, B, C, r))).numpy()
    for s in range(nb):
        M = np.zeros((nx * b, nx * b))
        for i in range(nx):
            M[i * b:(i + 1) * b, i * b:(i + 1) * b] = B[s, i]
            if i:
                M[i * b:(i + 1) * b, (i - 1) * b:i * b] = A[s, i]
            if i < nx - 1:
                M[i * b:(i + 1) * b, (i + 1) * b:(i + 2) * b] = C[s, i]
        want = np.linalg.solve(M, r[s].ravel()).reshape(nx, b)
        np.testing.assert_allclose(x[s], want, rtol=1e-4, atol=1e-5)


def test_implicit_euler_dae_on_a_linear_system():
    """Per-point rows of a diffusion-decay chain with an exact order-1
    solution: implicit Euler reaches the analytic discrete answer (each
    step one linear solve), and systems in a batch are independent."""
    nx, b = 5, 2

    def rows(y_m, y, y_p, yd, fl, aux):
        return yd + aux[0] * y - 0.1 * (y_m - 2 * y + y_p) * (1 - fl[0])

    flags = torch.zeros((nx, 1))
    y0 = torch.rand((2, nx, b), generator=torch.Generator().manual_seed(0))
    rate = torch.tensor([[0.5], [2.0]])
    dts = torch.full((4,), 0.25)
    got = implicit_euler_dae(rows, y0, flags, dts, newton_iters=1, order=1,
                             aux=rate)
    for s in range(2):
        one = implicit_euler_dae(rows, y0[s], flags, dts, newton_iters=1,
                                 order=1, aux=rate[s])
        torch.testing.assert_close(got[s], one, rtol=1e-6, atol=1e-7)
    # Implicit Euler for yd = -rate*y + D*lap(y), Neumann ends.
    L = -2 * np.eye(nx) + np.eye(nx, k=1) + np.eye(nx, k=-1)
    L[0, 0] = L[-1, -1] = -1.0
    for s in range(2):
        y = y0[s].double().numpy()
        Mstep = np.eye(nx) * (1 + 0.25 * float(rate[s])) - 0.25 * 0.1 * L
        for _ in range(4):
            y = np.linalg.solve(Mstep, y)
        np.testing.assert_allclose(got[s].numpy(), y, rtol=1e-5, atol=1e-6)


def test_blocked_engine_matches_jax_blocked(models):
    tb, _, (ll_j, fl_j) = models
    ll, flows = tb.log_likelihood(torch.from_numpy(THETA))
    assert tuple(flows.shape) == (3, 5, 2)
    np.testing.assert_allclose(flows.numpy(), fl_j, rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(np.isinf(ll.numpy()), np.isinf(ll_j))
    fin = np.isfinite(ll_j)
    np.testing.assert_allclose(ll.numpy()[fin], ll_j[fin], rtol=1e-4)


def test_blocked_engine_matches_batch_last_pivot(models):
    tb, tl, _ = models
    th = torch.from_numpy(THETA)
    ll_b, fl_b = tb.log_likelihood(th)
    ll_l, fl_l = tl.log_likelihood(th)
    np.testing.assert_allclose(fl_b.numpy(), fl_l.numpy(), rtol=1e-3,
                               atol=5e-3)
    fin = torch.isfinite(ll_l)
    np.testing.assert_allclose(ll_b[fin].numpy(), ll_l[fin].numpy(),
                               rtol=1e-3, atol=0.05)


def test_blocked_outputs_and_failure(models):
    """simulate_flows / simulate_molfractions through the blocked engine,
    the per-condition helpers, and the sentinel for a failed solve."""
    tb, _, _ = models
    kin = torch.tensor(TM.KIN_TRUE)
    flows = tb.simulate_flows(kin)
    assert tuple(flows.shape) == (5, 2) and torch.isfinite(flows).all()
    frac = tb.simulate_molfractions(kin)
    torch.testing.assert_close(frac.sum(0), torch.ones(2))
    yf = TM.solve_condition(TM.initial_guess(tb.cond, tb.nx),
                            tb._cond_vecs(), kin,
                            torch.from_numpy(tb._dts()), tb.newton_iters)
    torch.testing.assert_close(TM.outlet_flows(yf).T, flows)
    torch.testing.assert_close(TM.outlet_molfractions(yf).T, frac)
    bad = kin.clone()
    bad[0] = 1e30                                    # a runaway rate
    assert (tb.simulate_flows(bad) == -10000.0).any()
    assert not torch.isnan(tb.simulate_molfractions(bad)).any()

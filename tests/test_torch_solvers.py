"""The port's block solvers against the JAX package on the same random
blocks (no march compile): the stored-pivot LU, the block-Thomas factor
and apply, the two-ended ("babe") sweep and block cyclic reduction, and
the kernel wrappers' refusal of tracked inputs; then the methanation
likelihood
with ``solver`` "cr" and "babe" against "thomas" at nx = 11 (port only:
the JAX side's end-to-end cases are ``tests/test_babe.py``'s).

Blocks are made as ``tests/test_babe.py`` makes them: standard normal
off-diagonals, 12 I + N(0, 1) diagonals, and optionally the outlet's
row-permuted identity as the last diagonal block.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smc_tpu.ops import dae_fast as J
from smc_tpu_torch.models import methanation as TM
from smc_tpu_torch.ops import dae_fast as T
import tests.torch_parity  # noqa: F401  (one PyTorch thread)

BSZ = 16


def _system(seed, nx, permuted_outlet=True, nf=7):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((nx, nf, nf, BSZ)).astype(np.float32)
    C = rng.standard_normal((nx, nf, nf, BSZ)).astype(np.float32)
    B = (rng.standard_normal((nx, nf, nf, BSZ))
         + 12 * np.eye(nf)[None, :, :, None]).astype(np.float32)
    A[0] = 0.0
    C[-1] = 0.0
    if permuted_outlet:
        P = np.eye(nf, dtype=np.float32)
        P[[5, 6]] = P[[6, 5]]
        B[-1] = np.repeat(P[:, :, None], BSZ, axis=2)
    rhs = rng.standard_normal((nx, nf, BSZ)).astype(np.float32)
    return A, B, C, rhs


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


def _close(got, want, rel):
    """|got - want| within rel of want's largest magnitude (or of 1)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = max(np.abs(want).max(), 1.0)
    err = np.abs(got - want).max()
    assert err <= rel * scale, (err, scale)


def _block(seed, dominant=True):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((7, 7, BSZ)).astype(np.float32)
    if dominant:
        A += 8 * np.eye(7, dtype=np.float32)[:, :, None]
    r = rng.standard_normal((7, 3, BSZ)).astype(np.float32)
    return A, r


def test_lu7_pivot_and_solve_match_jax():
    """Stored-pivot LU on blocks that need it (a zero leading pivot, the
    outlet's permuted identity): factors and permutation 1e-6 of the
    block's scale, the solve 1e-5 and against numpy's solve."""
    A, r = _block(0, dominant=False)
    A[0, 0] = 0.0                                  # no-pivot LU divides by 0
    P = np.eye(7, dtype=np.float32)
    P[[5, 6]] = P[[6, 5]]
    A[:, :, 1] = P
    (ja, jr), (ta, tr) = _both(A, r)
    jlu, jp = J.lu7_pivot(ja)
    tlu, tp = T.lu7_pivot(ta)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    _close(tlu.numpy(), jlu, 1e-6)
    x = T.lu7_pivot_solve(tlu, tp, tr).numpy()
    _close(x, J.lu7_pivot_solve(jlu, jp, jr), 1e-5)
    want = np.linalg.solve(np.moveaxis(A, -1, 0).astype(np.float64),
                           np.moveaxis(r, -1, 0).astype(np.float64))
    _close(np.moveaxis(x, -1, 0), want, 1e-4)


def test_thomas_factor_and_apply_match_jax():
    """block_thomas_factor / _apply against the JAX functions: factors and
    x 1e-5."""
    A, B, C, rhs = _system(2, 11, permuted_outlet=False)
    (jA, jB, jC, jr), (tA, tB, tC, tr) = _both(A, B, C, rhs)
    jLU, jm = J.block_thomas_factor(jA, jB, jC)
    tLU, tm = T.block_thomas_factor(tA, tB, tC)
    _close(tLU.numpy(), jLU, 1e-5)
    _close(tm.numpy(), jm, 1e-5)
    x = T.block_thomas_apply(tLU, tm, tC, tr)
    _close(x.numpy(), J.block_thomas_apply(jLU, jm, jC, jr), 1e-5)


@pytest.mark.parametrize("wrapper", ["block_thomas_factor_pl",
                                     "block_thomas_apply_pl",
                                     "block_thomas_apply_tiled"])
def test_kernel_wrappers_refuse_tracked_inputs(wrapper):
    """The kernels have no backward: a wrapper given an input that autograd
    tracks raises ValueError on the CPU too (its plain stand-in must not
    differentiate where the card cannot), and runs under no_grad or on
    detached inputs."""
    from smc_tpu_torch.ops import thomas_cuda as TC
    A, B, C, rhs = _system(6, 11, permuted_outlet=False)
    tA, tB, tC, tr = map(torch.from_numpy, (A, B, C, rhs))
    LUs, ms = T.block_thomas_factor(tA, tB, tC)
    args = {"block_thomas_factor_pl": (tA, tB, tC)}.get(
        wrapper, (LUs, ms, tC, tr))
    fn = getattr(TC, wrapper)
    tracked = (args[0].clone().requires_grad_(True),) + args[1:]
    with pytest.raises(ValueError, match="no backward"):
        fn(*tracked)
    with torch.no_grad():
        got = fn(*tracked)
    want = fn(*args)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)
    if wrapper != "block_thomas_factor_pl":
        assert torch.equal(want, T.block_thomas_apply(LUs, ms, tC, tr))


@pytest.mark.parametrize("nx", [7, 11, 51])
@pytest.mark.parametrize("permuted_outlet", [False, True])
def test_babe_matches_jax_and_thomas(nx, permuted_outlet):
    """The two-ended sweep against the JAX babe (1e-5) and the plain
    Thomas solve (2e-4, tests/test_babe.py's bar), the outlet's permuted
    identity included (no-pivot Thomas factors it only because the
    forward sweep Schur-updates it first)."""
    A, B, C, rhs = _system(nx, nx, permuted_outlet)
    (jA, jB, jC, jr), (tA, tB, tC, tr) = _both(A, B, C, rhs)
    x = T.block_thomas_babe_apply(T.block_thomas_babe_factor(tA, tB, tC), tr)
    want = J.block_thomas_babe_apply(J.block_thomas_babe_factor(jA, jB, jC),
                                     jr)
    _close(x.numpy(), want, 1e-5)
    LUs, ms = T.block_thomas_factor(tA, tB, tC)
    _close(x.numpy(), T.block_thomas_apply(LUs, ms, tC, tr).numpy(), 2e-4)


def test_babe_factor_reuse_and_even_nx():
    """Stored factors serve several right-hand sides: each solve within
    2e-4 of the JAX package's Thomas solve (tests/test_babe.py's bar for
    its own babe; these blocks amplify rounding, and the babe solves of
    both packages lie 4e-5 to 1.4e-4 from a float64 solve where Thomas
    lies 3e-6); even NX raises."""
    A, B, C, _ = _system(0, 11)
    (jA, jB, jC), (tA, tB, tC) = _both(A, B, C)
    fac = T.block_thomas_babe_factor(tA, tB, tC)
    jLU, jm = J.block_thomas_factor(jA, jB, jC)
    rng = np.random.default_rng(5)
    for _ in range(3):
        r = rng.standard_normal((11, 7, BSZ)).astype(np.float32)
        _close(T.block_thomas_babe_apply(fac, torch.from_numpy(r)).numpy(),
               J.block_thomas_apply(jLU, jm, jC, jnp.asarray(r)), 2e-4)
    A, B, C, _ = _system(1, 10, permuted_outlet=False)
    with pytest.raises(ValueError, match="odd NX"):
        T.block_thomas_babe_factor(*map(torch.from_numpy, (A, B, C)))


@pytest.mark.parametrize("nx", [7, 11, 51])
def test_cr_matches_jax_and_thomas(nx):
    """Cyclic reduction (the level axis folded into the lanes) against the
    JAX cyclic reduction (1e-5) and the plain Thomas solve (2e-4), at a
    padded size (11, 51) and an exact 2^k - 1 (7); factors reused."""
    A, B, C, rhs = _system(10 + nx, nx)
    (jA, jB, jC, jr), (tA, tB, tC, tr) = _both(A, B, C, rhs)
    fac = T.block_cr_factor(tA, tB, tC)
    jfac = J.block_cr_factor(jA, jB, jC)
    x = T.block_cr_apply(fac, tr)
    _close(x.numpy(), J.block_cr_apply(jfac, jr), 1e-5)
    LUs, ms = T.block_thomas_factor(tA, tB, tC)
    _close(x.numpy(), T.block_thomas_apply(LUs, ms, tC, tr).numpy(), 2e-4)
    _close(T.block_cr_apply(fac, tr * 2.0).numpy(), 2.0 * x.numpy(), 1e-6)


@pytest.mark.parametrize("solver", ["thomas", "cr", "babe"])
def test_plain_solvers_are_differentiable(solver):
    """The plain loops run under autograd (the transient likelihood's
    gradient): d(sum x)/d(rhs) equals the solve of the transposed system,
    by every solver."""
    A, B, C, rhs = _system(4, 11, permuted_outlet=False)
    tA, tC = torch.from_numpy(A), torch.from_numpy(C)
    tB = torch.from_numpy(B).requires_grad_(True)
    r = torch.from_numpy(rhs).requires_grad_(True)
    kit = T._newton_kit(None, torch.zeros((7, 11, BSZ)), False, None, solver)
    x = kit[4](kit[3](tA, tB, tC), r)
    g, gB = torch.autograd.grad(x.sum(), (r, tB))
    # the transposed system: sub' = C^T shifted, diag' = B^T, super' = A^T
    sw = lambda M: M.transpose(1, 2)                      # noqa: E731
    z = torch.zeros_like(tA[:1])
    AT = torch.cat([z, sw(tC)[:-1]])
    CT = torch.cat([sw(tA)[1:], z])
    lam = T.block_thomas_bl(AT, sw(tB.detach()), CT, torch.ones_like(r),
                            pivot=True)
    _close(g.numpy(), lam.numpy(), 1e-4)
    # d(sum x)/dB_i = -lam_i x_i^T, lane by lane
    xt = x.detach().movedim(0, 1)                          # (NX, 7, B)
    _close(gB.numpy(), (-lam[:, :, None] * xt[:, None]).numpy(), 1e-4)


@pytest.fixture(scope="module")
def thomas_model():
    cond = TM.condition_table_numpy(2, nx=11)
    return TM.MethanationModel(
        cond=TM.Conditions.from_numpy(cond, "cpu"),
        obs=torch.full((5, 2), 30.0),
        prior=TM.methanation_prior(device="cpu"), nx=11,
        particle_chunk=8, solver="thomas")


@pytest.mark.parametrize("solver", ["cr", "babe"])
def test_methanation_likelihood_with_cr_and_babe(thomas_model, solver):
    """The default lagged march at nx = 11 (48 steps) with each solver
    against "thomas": flows within 1e-3 sccm where the march converges,
    the same failed lanes, log-likelihoods within rtol 1e-4 (the bars of
    tests/test_babe.py)."""
    other = dataclasses.replace(thomas_model, solver=solver)
    kin = torch.tensor(TM.KIN_TRUE)
    f_t, f_o = thomas_model.simulate_flows(kin), other.simulate_flows(kin)
    assert (f_t != -10000.0).all()
    np.testing.assert_allclose(f_o.numpy(), f_t.numpy(), atol=1e-3)
    from smc_tpu_torch.rng import TorchDraws
    th = thomas_model.prior.sample(TorchDraws(0, torch.device("cpu")), 16)
    ll_t, fl_t = thomas_model.log_likelihood(th)
    ll_o, fl_o = other.log_likelihood(th)
    np.testing.assert_array_equal(fl_o.numpy() == -10000.0,
                                  fl_t.numpy() == -10000.0)
    np.testing.assert_allclose(ll_o.numpy(), ll_t.numpy(), rtol=1e-4,
                               atol=1e-3)

"""The port's block-Thomas factor and applies against the JAX package on the
CPU: the same NumPy blocks go through the Pallas kernels in interpret mode
(and the JAX scans) and through the port's wrappers, which take their plain
versions for CPU tensors. Both sides are also held to a float64 oracle.

Blocks are diagonally dominant (0.1 N(0,1) + 8 I). On weaker diagonals
(0.3 N(0,1) + 4 I) one ill-conditioned lane already separates the JAX kernel
from the JAX scan by 9e-5 of the largest LU entry, so a tight tolerance
there would test the conditioning of the draw, not the port.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smc_tpu.ops import dae_fast as jdf
from smc_tpu.ops import thomas_pallas as jtp
from smc_tpu_torch.ops import dae_fast as tdf
from smc_tpu_torch.ops import thomas_cuda as ttc
import tests.torch_parity  # noqa: F401  (one PyTorch thread)

NX, NF = 11, 7
# Per lane, relative to the lane's largest magnitude. 2e-5: the two sides do
# the same fp32 operations and differ in summation order and FMA contraction
# only (a few ulp, grown by the 11-row recurrence).
RTOL_PARITY = 2e-5
# fp32 against float64 through an 11-row recurrence of 7x7 eliminations:
# both packages sit near 1e-5 of the largest entry, 1e-4 bounds them.
RTOL_ORACLE = 1e-4


def _system(b, seed=0, nx=NX):
    rng = np.random.default_rng(seed)

    def blk(scale):
        return (rng.normal(size=(nx, NF, NF, b)) * scale).astype(np.float32)
    A, B, C = blk(0.1), blk(0.1), blk(0.1)
    B += 8.0 * np.eye(NF, dtype=np.float32)[None, :, :, None]
    A[0] = 0.0
    C[-1] = 0.0
    r = rng.normal(size=(nx, NF, b)).astype(np.float32)
    return A, B, C, r


def _oracle_factor(A, B, C):
    """Float64 factors per lane: Doolittle LU without pivoting of the Schur
    complements, multipliers by numpy.linalg.inv."""
    nx, nf, _, b = A.shape
    A, B, C = (np.moveaxis(M.astype(np.float64), -1, 0)
               for M in (A, B, C))                 # lane first

    def lu(M):
        M = M.copy()
        for c in range(nf):
            M[:, c + 1:, c] /= M[:, c, c][:, None]
            M[:, c + 1:, c + 1:] -= (M[:, c + 1:, c][:, :, None]
                                     * M[:, c, c + 1:][:, None, :])
        return M

    LUs = np.zeros_like(B)
    ms = np.zeros_like(B)
    Bp = np.zeros_like(B)
    Bp[:, 0] = B[:, 0]
    LUs[:, 0] = lu(B[:, 0])
    for i in range(1, nx):
        ms[:, i] = A[:, i] @ np.linalg.inv(Bp[:, i - 1])
        Bp[:, i] = B[:, i] - ms[:, i] @ C[:, i - 1]
        LUs[:, i] = lu(Bp[:, i])
    back = lambda M: np.moveaxis(M, 0, -1)  # noqa: E731
    return back(LUs), back(ms)


def _oracle_solve(A, B, C, r):
    """Float64 x of the assembled dense system, per lane."""
    nx, nf, _, b = A.shape
    x = np.zeros((nx, nf, b))
    for t in range(b):
        dense = np.zeros((nx * nf, nx * nf))
        for i in range(nx):
            s = slice(i * nf, (i + 1) * nf)
            dense[s, s] = B[i, :, :, t]
            if i > 0:
                dense[s, (i - 1) * nf:i * nf] = A[i, :, :, t]
            if i < nx - 1:
                dense[s, (i + 1) * nf:(i + 2) * nf] = C[i, :, :, t]
        x[:, :, t] = np.linalg.solve(
            dense, r[:, :, t].astype(np.float64).ravel()).reshape(nx, nf)
    return x


def _lane_rel(got, want):
    """Largest |got - want| per lane over that lane's largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    axes = tuple(range(got.ndim - 1))
    return (np.abs(got - want).max(axes) / np.abs(want).max(axes)).max()


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


@pytest.fixture(scope="module")
def system():
    A, B, C, r = _system(128)
    return dict(A=A, B=B, C=C, r=r,
                oracle=_oracle_factor(A, B, C) + (_oracle_solve(A, B, C, r),))


@pytest.fixture(scope="module")
def jax_factors(system):
    """The Pallas factor kernel in interpret mode: 8-column factors."""
    LUs, ms, Cp = jtp.block_thomas_factor_pl(
        *map(jnp.asarray, (system["A"], system["B"], system["C"])),
        interpret=True)
    return np.asarray(LUs), np.asarray(ms), np.asarray(Cp)


def test_factor_matches_pallas_kernel_and_scan(system, jax_factors):
    jLU, jms, _ = jax_factors
    A8, B8, C8 = ttc.pad_blocks(*_t(system["A"], system["B"], system["C"]))
    LUs, ms, Cp = ttc.block_thomas_factor_pl(A8, B8, C8)
    assert LUs.shape == ms.shape == (NX, NF, 8, 128) and Cp is C8
    assert _lane_rel(LUs.numpy(), jLU) < RTOL_PARITY
    assert _lane_rel(ms.numpy(), jms) < RTOL_PARITY
    # the JAX scan, and the port's own loops
    sLU, sms = jdf.block_thomas_factor(
        *map(jnp.asarray, (system["A"], system["B"], system["C"])))
    pLU, pms = tdf.block_thomas_factor(
        *_t(system["A"], system["B"], system["C"]))
    assert _lane_rel(pLU.numpy(), np.asarray(sLU)) < RTOL_PARITY
    assert _lane_rel(pms.numpy(), np.asarray(sms)) < RTOL_PARITY
    assert torch.equal(pLU, LUs[:, :, :NF]) and torch.equal(pms,
                                                            ms[:, :, :NF])


def test_factor_both_sides_near_float64_oracle(system, jax_factors):
    oLU, oms, _ = system["oracle"]
    jLU, jms, _ = jax_factors
    LUs, ms, _ = ttc.block_thomas_factor_pl(
        *_t(system["A"], system["B"], system["C"]))
    for got in (LUs.numpy(), jLU[:, :, :NF]):
        assert _lane_rel(got, oLU) < RTOL_ORACLE
    for got in (ms.numpy(), jms[:, :, :NF]):
        assert _lane_rel(got, oms) < RTOL_ORACLE


@pytest.mark.parametrize("which", ["apply_pl", "apply_tiled"])
def test_apply_matches_pallas_kernel_scan_and_oracle(system, jax_factors,
                                                     which):
    jLU, jms, jC = jax_factors
    r = system["r"]
    if which == "apply_pl":      # padded factors, streaming kernel
        jx = jtp.block_thomas_apply_pl(*map(jnp.asarray, (jLU, jms, jC, r)),
                                       interpret=True)
        x = ttc.block_thomas_apply_pl(*_t(jLU, jms, jC, r))
    else:                        # unpadded factors, lane-tiled kernel
        raw = [M[:, :, :NF] for M in (jLU, jms, jC)]
        jx = jtp.block_thomas_apply_tiled(*map(jnp.asarray, (*raw, r)),
                                          interpret=True)
        x = ttc.block_thomas_apply_tiled(*_t(*raw, r))
    assert x.shape == (NX, NF, 128)
    assert _lane_rel(x.numpy(), np.asarray(jx)) < RTOL_PARITY
    sx = jdf.block_thomas_apply(*map(jnp.asarray, (jLU, jms, jC, r)))
    assert _lane_rel(x.numpy(), np.asarray(sx)) < RTOL_PARITY
    assert _lane_rel(x.numpy(), system["oracle"][2]) < RTOL_ORACLE
    assert _lane_rel(np.asarray(jx), system["oracle"][2]) < RTOL_ORACLE


def _residual(A, B, C, x, r):
    """max |T x - r| of the assembled block-tridiagonal system, float64."""
    A, B, C, x, r = (np.asarray(M, np.float64) for M in (A, B, C, x, r))
    Tx = np.einsum("irct,ict->irt", B, x)
    Tx[1:] += np.einsum("irct,ict->irt", A[1:], x[:-1])
    Tx[:-1] += np.einsum("irct,ict->irt", C[:-1], x[1:])
    return np.abs(Tx - r).max()


def test_factor_then_apply_residual(system):
    """The port's factor + apply solves the system as well as the JAX
    factor + apply does: residual |T x - r| within 2x of it and below 1e-5
    (unit-scale rhs, blocks of norm ~8, fp32)."""
    A, B, C, r = (system[k] for k in "ABCr")
    LUs, ms, Cp = ttc.block_thomas_factor_pl(*_t(A, B, C))
    x = ttc.block_thomas_apply_tiled(LUs, ms, Cp, torch.from_numpy(r))
    jLU, jms = jdf.block_thomas_factor(*map(jnp.asarray, (A, B, C)))
    jx = jdf.block_thomas_apply(jLU, jms, jnp.asarray(C), jnp.asarray(r))
    res_t = _residual(A, B, C, x.numpy(), r)
    res_j = _residual(A, B, C, np.asarray(jx), r)
    assert res_t < 1e-5 and res_t < 2 * res_j + 1e-7


def test_pad_contract():
    """Eighth column zero, ms[0] zero, 7- and 8-column inputs give the same
    factors, and every apply entry point gives the same x."""
    A, B, C, r = _t(*_system(32, seed=3))
    LU7, ms7, C7 = ttc.block_thomas_factor_pl(A, B, C)
    LU8, ms8, C8 = ttc.block_thomas_factor_pl(*ttc.pad_blocks(A, B, C))
    assert LU7.shape == (NX, NF, NF, 32) and LU8.shape == (NX, NF, 8, 32)
    assert torch.equal(LU8[:, :, :NF], LU7) and torch.equal(ms8[:, :, :NF],
                                                            ms7)
    for M in (LU8, ms8, C8):
        assert torch.count_nonzero(M[:, :, NF]) == 0
    assert torch.count_nonzero(ms7[0]) == 0 == torch.count_nonzero(ms8[0])
    p = ttc.pad_factors(LU7, ms7, C7)
    assert all(torch.equal(a, b) for a, b in zip(p, (LU8, ms8, C8)))
    x7 = ttc.block_thomas_apply_tiled(LU7, ms7, C7, r)
    assert torch.equal(ttc.block_thomas_apply_pl(LU8, ms8, C8, r), x7)
    assert torch.equal(ttc.block_thomas_apply_pl(LU7, ms7, C7, r), x7)
    assert torch.equal(tdf.block_thomas_apply(LU8, ms8, C8, r), x7)
    with pytest.raises(ValueError):
        ttc.block_thomas_apply_tiled(LU8, ms8, C8, r)
    with pytest.raises(ValueError):
        ttc.block_thomas_factor_pl(A[:, :, :5], B[:, :, :5], C[:, :, :5])


@pytest.mark.parametrize("b", [37, 130])
def test_ragged_batch(b):
    """A lane count that is not a multiple of 128 (where the Pallas kernels
    fall back to the scan): against the JAX entry points and the oracle."""
    A, B, C, r = _system(b, seed=b)
    jLU, jms, jC = jtp.block_thomas_factor_pl(*map(jnp.asarray, (A, B, C)))
    jx = jtp.block_thomas_apply_pl(jLU, jms, jC, jnp.asarray(r))
    LUs, ms, Cp = ttc.block_thomas_factor_pl(*_t(A, B, C))
    x = ttc.block_thomas_apply_tiled(LUs, ms, Cp, torch.from_numpy(r))
    assert _lane_rel(LUs.numpy(), np.asarray(jLU)[:, :, :NF]) < RTOL_PARITY
    assert _lane_rel(ms.numpy(), np.asarray(jms)[:, :, :NF]) < RTOL_PARITY
    assert _lane_rel(x.numpy(), np.asarray(jx)) < RTOL_PARITY
    assert _lane_rel(x.numpy(), _oracle_solve(A, B, C, r)) < RTOL_ORACLE


def test_singular_pivot_stays_in_its_lane():
    """No pivoting, no guard: a zero pivot gives non-finite values in that
    lane only, in both packages."""
    A, B, C, r = _system(16, seed=5)
    B[0, 0, 0, 5] = 0.0          # the first pivot of lane 5
    LUs, ms, Cp = ttc.block_thomas_factor_pl(*_t(A, B, C))
    x = ttc.block_thomas_apply_tiled(LUs, ms, Cp, torch.from_numpy(r))
    bad = ~torch.isfinite(x).all(dim=(0, 1))
    assert bad.tolist() == [i == 5 for i in range(16)]
    assert not torch.isfinite(LUs[..., 5]).all()
    ok = [i for i in range(16) if i != 5]
    assert torch.isfinite(LUs[..., ok]).all()
    assert torch.isfinite(ms[..., ok]).all()
    jLU, jms = jdf.block_thomas_factor(*map(jnp.asarray, (A, B, C)))
    jx = np.asarray(jdf.block_thomas_apply(jLU, jms, jnp.asarray(C),
                                           jnp.asarray(r)))
    np.testing.assert_array_equal(~np.isfinite(jx).all((0, 1)), bad.numpy())
    assert _lane_rel(x.numpy()[..., ok], jx[..., ok]) < RTOL_PARITY


def test_small_block_algebra_matches_jax():
    """lu7_nopivot, lu7_solve, lu7_solve_T, solve7 (pivoted, with a zero
    leading entry) and the lanes-major products, at rtol 1e-5 / atol 1e-6
    (same operations; summation order and FMA contraction differ)."""
    rng = np.random.default_rng(7)
    M = (rng.normal(size=(NF, NF, 33)) * 0.3).astype(np.float32)
    M += 4.0 * np.eye(NF, dtype=np.float32)[:, :, None]
    rhs = rng.normal(size=(NF, 3, 33)).astype(np.float32)
    (tM, trhs), jM, jrhs = _t(M, rhs), jnp.asarray(M), jnp.asarray(rhs)
    kw = dict(rtol=1e-5, atol=1e-6)
    tLU, jLU = tdf.lu7_nopivot(tM), jdf.lu7_nopivot(jM)
    np.testing.assert_allclose(tLU.numpy(), np.asarray(jLU), **kw)
    np.testing.assert_allclose(tdf.lu7_solve(tLU, trhs).numpy(),
                               np.asarray(jdf.lu7_solve(jLU, jrhs)), **kw)
    np.testing.assert_allclose(tdf.lu7_solve_T(tLU, trhs).numpy(),
                               np.asarray(jdf.lu7_solve_T(jLU, jrhs)), **kw)
    np.testing.assert_allclose(tdf._matmul_bl(tM, trhs).numpy(),
                               np.asarray(jdf._matmul_bl(jM, jrhs)), **kw)
    np.testing.assert_allclose(tdf._matvec_bl(tM, trhs[:, 0]).numpy(),
                               np.asarray(jdf._matvec_bl(jM, jrhs[:, 0])),
                               **kw)
    M[0, 0] = 0.0                # forces the pairwise swaps
    (tM,), jM = _t(M), jnp.asarray(M)
    for pivot in (True, False):
        got = tdf.solve7(tM, trhs, pivot=pivot).numpy()
        want = np.asarray(jdf.solve7(jM, jrhs, pivot=pivot))
        if pivot:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        else:                    # zero pivot: non-finite in both
            assert not np.isfinite(got).any() and not np.isfinite(want).any()
    # the pivoted fused solve of the conservative path, on 3 grid rows
    # (first, interior, last: every kind of row there is; the JAX side's
    # compile takes twice as long at 11)
    A, B, C, r = _system(4, seed=9, nx=3)
    B[-1, 5, 5] = B[-1, 6, 6] = 0.0      # outlet-like permutation block
    B[-1, 5, 6] = B[-1, 6, 5] = 1.0
    got = tdf.block_thomas_bl(*_t(A, B, C, r), pivot=True).numpy()
    want = np.asarray(jdf.block_thomas_bl(*map(jnp.asarray, (A, B, C, r)),
                                          pivot=True))
    assert _lane_rel(got, want) < RTOL_PARITY
    assert _lane_rel(got, _oracle_solve(A, B, C, r)) < RTOL_ORACLE


def test_cuda_tensor_never_reaches_a_plain_version(monkeypatch):
    """Only a CPU tensor takes a plain version. Without a card the nearest
    thing to show is that a tensor on any other device (meta here) is
    refused, with the plain versions replaced by a tripwire; that a failed
    build raises on a CUDA tensor is a card-only test."""
    A, B, C, r = _t(*_system(4))

    def plain_must_not_run(*a, **k):
        raise AssertionError("plain version reached")
    monkeypatch.setattr(ttc, "block_thomas_factor_plain", plain_must_not_run)
    monkeypatch.setattr(ttc, "block_thomas_apply_plain", plain_must_not_run)
    with pytest.raises(ValueError):
        ttc.block_thomas_factor_pl(A.to("meta"), B.to("meta"), C.to("meta"))
    for fn in (ttc.block_thomas_apply_tiled, ttc.block_thomas_apply_pl):
        with pytest.raises(ValueError):
            fn(A.to("meta"), B.to("meta"), C.to("meta"), r.to("meta"))

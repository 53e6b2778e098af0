"""Card-only tests of the hand-written CUDA kernels: each kernel against its
plain PyTorch version on the card, the wrappers' input checks, a short run
of the Michaelis-Menten main path through its three kernels, and a
methanation likelihood through the block-Thomas kernels.

Every test here needs an NVIDIA GPU with nvcc and skips without one (the
``cuda`` fixture decides, inside the test). This file imports neither JAX
nor the JAX package, so on a machine without JAX it runs alone with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import math

import pytest
import torch

from smc_tpu_torch import SMCConfig, make_full_run_on_device
from smc_tpu_torch.models.michaelis_menten import MichaelisMentenModel
from smc_tpu_torch.ops import _build
from smc_tpu_torch.ops import ladder_cuda as ld
from smc_tpu_torch.ops import mm_cuda as mm
from smc_tpu_torch.ops import resample_cuda as rs
from smc_tpu_torch.ops import thomas_cuda as tc

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernels run only on "
                    "the card; their plain versions are tested on the CPU)")
    return torch.device("cuda")


def test_mm_kernel_matches_plain(cuda):
    """rtol 1e-5 of the larger of ll's two terms (FMA contraction in the
    kernel moves the last bits of each); the -inf rows exactly."""
    m = MichaelisMentenModel.default(method="pallas_exact", device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    b, n = 2, 1001
    theta = torch.rand((b, n, 3), generator=g, device=cuda) * 10.0
    theta[:, ::7, 2] *= -1.0
    theta[:, 1::11, 1] = 0.0
    obs = m.obs[None].repeat(b, 1, 1).contiguous()
    s0 = m.s0[None].repeat(b, 1).contiguous()
    got = mm.mm_loglik_exact_batched(theta, obs, s0, m.dt)
    want = mm.mm_loglik_exact_plain(theta, obs, s0, m.dt)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    sigma = theta[..., 2].clamp_min(1e-12)[fin]
    t1 = -120.0 * (math.log(2 * math.pi) + 2 * torch.log(sigma))
    scale = torch.maximum(t1.abs(), (t1 - want[fin]).abs())
    assert bool(((got[fin] - want[fin]).abs() <= 1e-5 * scale).all())


def test_ladder_kernel_matches_plain_and_repeats(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    d = -torch.rand(70001, generator=g, device=cuda) * 50.0
    d[::13] = -math.inf
    dg = (0.7 ** torch.arange(81, device=cuda, dtype=torch.float64)).float()
    s1, s2 = ld.ladder_stats(d, dg)
    r1, r2 = ld.ladder_stats_plain(d, dg)
    torch.testing.assert_close(s1, r1, rtol=1e-5, atol=0)
    torch.testing.assert_close(s2, r2, rtol=1e-5, atol=0)
    t1, t2 = ld.ladder_stats(d, dg)
    assert torch.equal(s1, t1) and torch.equal(s2, t2)


@pytest.mark.parametrize("case", ["first", "last", "ones", "alternating",
                                  "random"])
def test_merge_kernel_is_bitwise_plain(cuda, case):
    n = 50_003
    c = torch.zeros(n, dtype=torch.int64, device=cuda)
    if case == "first":
        c[0] = n
    elif case == "last":
        c[-1] = n
    elif case == "ones":
        c[:] = 1
    elif case == "alternating":
        c[::2] = 2
        c[0] += n - int(c.sum())
    else:
        c = torch.multinomial(torch.ones(n, device=cuda), n,
                              replacement=True).bincount(minlength=n)
    offsets = (torch.cumsum(c, 0) - c).to(torch.int32)
    got = rs.sorted_offsets_to_ancestors(offsets)
    assert torch.equal(got, rs.sorted_offsets_to_ancestors_plain(offsets))


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    m = MichaelisMentenModel.default(method="pallas_exact", device=cuda)
    theta = torch.rand((1, 64, 3), device=cuda)
    with pytest.raises(TypeError):
        mm.mm_loglik_exact_batched(theta.double(), m.obs[None],
                                   m.s0[None], m.dt)
    with pytest.raises(ValueError):
        mm.mm_loglik_exact_batched(theta.transpose(1, 2).contiguous()
                                   .transpose(1, 2), m.obs[None],
                                   m.s0[None], m.dt)
    with pytest.raises(TypeError):
        rs.sorted_offsets_to_ancestors(torch.zeros(8, device=cuda,
                                                   dtype=torch.int64))
    with pytest.raises(ValueError):
        ld.ladder_stats(torch.zeros(8, device=cuda), torch.ones(8))


def test_main_path_launches_every_kernel(cuda):
    m = MichaelisMentenModel.default(method="pallas_exact", device=cuda)
    _build.reset_launch_counts()
    s = make_full_run_on_device(m, SMCConfig(n_particles=4096))(0)
    assert float(s.gamma) == 1.0
    counts = dict(_build.launch_counts)
    assert counts["ladder"] == counts["merge"] == int(s.step)
    assert counts["mm_exact"] == int(round(float(s.total_lik_evals) / 4096))
    mean = s.particles.mean(0).cpu()
    assert abs(float(mean[0]) - 1.2) < 0.1 and abs(float(mean[1]) - 0.5) < 0.1


def _blocks(cuda, nx, b, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)

    def blk():
        return torch.randn((nx, 7, 7, b), generator=g, device=cuda) * 0.1
    A, B, C = blk(), blk(), blk()
    B += 8.0 * torch.eye(7, device=cuda)[None, :, :, None]
    return A, B, C, torch.randn((nx, 7, b), generator=g, device=cuda)


def _lane_rel(got, want):
    dims = tuple(range(got.dim() - 1))
    return float(((got - want).abs().amax(dims)
                  / want.abs().amax(dims)).max())


@pytest.mark.parametrize("nx,b", [(51, 4096), (11, 1037), (1, 5), (3, 33)])
def test_thomas_factor_kernel_matches_plain(cuda, nx, b):
    """Per lane at 1e-4 of the lane's largest value (FMA contraction moves
    the last bits; the recurrence carries them along NX rows), at both
    column widths, with the pad contract."""
    A, B, C, _ = _blocks(cuda, nx, b, nx * b)
    LU, ms, Cp = tc.block_thomas_factor_pl(A, B, C)
    pLU, pms = tc.block_thomas_factor_plain(A, B, C)
    assert Cp is C and LU.shape == (nx, 7, 7, b)
    assert _lane_rel(LU, pLU) < 1e-4
    assert nx == 1 or _lane_rel(ms[1:], pms[1:]) < 1e-4   # ms[0] is zero
    LU8, ms8, _ = tc.block_thomas_factor_pl(*tc.pad_blocks(A, B, C))
    assert LU8.shape == (nx, 7, 8, b)
    assert torch.equal(LU8[:, :, :7], LU) and torch.equal(ms8[:, :, :7], ms)
    assert not LU8[:, :, 7].any() and not ms8[:, :, 7].any()
    assert not ms[0].any()


@pytest.mark.parametrize("nx,b", [(51, 4096), (11, 1037), (1, 5), (3, 33)])
def test_thomas_apply_kernels_match_plain(cuda, nx, b):
    A, B, C, r = _blocks(cuda, nx, b, nx + b)
    LU, ms, _ = tc.block_thomas_factor_pl(A, B, C)
    want = tc.block_thomas_apply_plain(LU, ms, C, r)
    x7 = tc.block_thomas_apply_tiled(LU, ms, C, r)
    x8 = tc.block_thomas_apply_pl(*tc.pad_factors(LU, ms, C), r)
    assert _lane_rel(x7, want) < 1e-4 and _lane_rel(x8, want) < 1e-4
    assert torch.equal(tc.block_thomas_apply_pl(LU, ms, C, r), x8)


def test_thomas_singular_pivot_stays_in_its_lane(cuda):
    A, B, C, r = _blocks(cuda, 11, 64, 3)
    B[0, 0, 0, 5] = 0.0
    LU, ms, _ = tc.block_thomas_factor_pl(A, B, C)
    x = tc.block_thomas_apply_tiled(LU, ms, C, r)
    bad = ~torch.isfinite(x).all(dim=(0, 1))
    assert bad.tolist() == [i == 5 for i in range(64)]


def test_thomas_wrappers_launch_or_raise(cuda, monkeypatch):
    """On a CUDA tensor a wrapper launches its kernel or raises: wrong
    inputs are refused, and when the build fails nothing falls back to the
    plain version."""
    A, B, C, r = _blocks(cuda, 5, 32, 1)
    LU, ms, _ = tc.block_thomas_factor_pl(A, B, C)
    with pytest.raises(TypeError):
        tc.block_thomas_factor_pl(A.double(), B.double(), C.double())
    with pytest.raises(ValueError):
        tc.block_thomas_factor_pl(A, B[:4], C)
    with pytest.raises(ValueError):
        tc.block_thomas_apply_tiled(LU, ms, C, r.transpose(0, 1))
    with pytest.raises(ValueError):
        tc.block_thomas_apply_pl(LU, ms, C.cpu(), r)

    def plain_must_not_run(*a, **k):
        raise AssertionError("plain version reached on a CUDA tensor")

    def failed_build():
        raise RuntimeError("nvcc failed")
    monkeypatch.setattr(tc, "block_thomas_factor_plain", plain_must_not_run)
    monkeypatch.setattr(tc, "block_thomas_apply_plain", plain_must_not_run)
    monkeypatch.setattr(_build, "load", failed_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tc.block_thomas_factor_pl(A, B, C)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tc.block_thomas_apply_tiled(LU, ms, C, r)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tc.block_thomas_apply_pl(LU, ms, C, r)


def test_methanation_likelihood_launches_the_thomas_kernels(cuda):
    """A small methanation likelihood on the card: 13 factor and 61 apply
    launches per chunk for the default march, flows equal to the plain
    loops' (solver="thomas") within 0.05 sccm."""
    import dataclasses

    from smc_tpu_torch.models.methanation import KIN_TRUE, MethanationModel
    m = MethanationModel.default(n_conditions=3, nx=11, particle_chunk=8,
                                 device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    truth = torch.tensor(KIN_TRUE[:4] + (5.0,), device=cuda)
    theta = truth * (1 + 0.03 * torch.randn((12, 5), generator=g,
                                            device=cuda))
    _build.reset_launch_counts()
    ll, flows = m.log_likelihood(theta)
    counts = dict(_build.launch_counts)
    assert counts["thomas_factor"] == 2 * 13
    assert counts["thomas_apply_tiled"] == 2 * 61
    assert counts["thomas_apply"] == 0
    _, want = dataclasses.replace(m, solver="thomas").log_likelihood(theta)
    assert dict(_build.launch_counts) == counts
    assert torch.isfinite(ll).all() and (flows != -10000.0).all()
    torch.testing.assert_close(flows, want, rtol=0, atol=0.05)

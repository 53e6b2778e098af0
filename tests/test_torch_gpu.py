"""Card-only tests of the hand-written CUDA kernels: each kernel against its
plain PyTorch version on the card, the wrappers' input checks, and a short
run of the main path through all three kernels.

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

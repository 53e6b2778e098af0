"""Card-only tests of the hand-written CUDA kernels: each kernel against its
plain PyTorch version on the card, the wrappers' input checks, a short run
of the Michaelis-Menten main path through its three kernels, the
block-Thomas kernels at lane counts around their 32-lane tiles and at the
march's width (and their refusal of inputs autograd tracks), the
transposed-solve kernel and the solve's backward through it, a methanation
likelihood and its gradient through them, the RK4 likelihood
kernel with and without its population axis, the ladder and merge kernels
under the ensemble's population axis (unaligned rows, K = 1 and 200, the
merge's zero-count runs where it cuts its pieces) and replayed in one
captured graph, each resampling scheme's counts and run, an ensemble on
the card against the same ensemble on the CPU, and the graphed runs
(captured CUDA graphs of the step's pieces; for MALA and HMC with their
backward passes) against the eager composition of the same pieces, bit for
bit, with their launch accounting; block granularity against sweep
granularity; the autograd gradients and a MAP estimate on the card
against the CPU's; a checkpoint taken inside a graphed run resumed
bit-equal in each format, the Robertson ``bdf2`` march graphed against
eager, MM ``dopri5`` to gamma = 1, the blocked methanation engine at
the flagship's full width and depth against the lanes-major one, and the
steady methanation march (through the kernels against the plain loops at
full width; its implicit-function adjoint against the CPU's; the cd/ad
Jacobians and the cr/babe solvers; a graphed MALA run against eager),
and the operations layer: the CLI's run on the main path, its resume
from each checkpoint format and a ``run_resilient`` recovery, each
bit-equal to ``run_smc``; a ``--profile`` trace naming kernels 1-3; the
card's memory report; an NCCL process group of one; collectives of a
mesh of one NCCL rank captured in a CUDA graph, and ``--mesh 1`` under a
one-process ``torchrun`` bit-equal to ``run_smc``.

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


_ZERO_RUNS = {"zero_run_inside_a_tile": (1100, 1700),
              "ties_across_1024": (1019, 1029),
              "ties_across_2048": (2043, 2053),
              "ties_across_4096": (4091, 4101),
              "zero_run_longer_than_any_window": (11, 3011)}


@pytest.mark.parametrize("case", ["first", "last", "ones", "alternating",
                                  "random", *_ZERO_RUNS])
def test_merge_kernel_is_bitwise_plain(cuda, case):
    """Bitwise the plain version, on degenerate counts and on zero-count
    runs where the kernel cuts its pieces: inside a 1024-slot tile, across
    1024, 2048 and 4096, and longer than a block's 2048 positions of the
    offsets merged with the slots."""
    n = 50_003
    c = torch.zeros(n, dtype=torch.int64, device=cuda)
    if case in _ZERO_RUNS:
        lo, hi = _ZERO_RUNS[case]
        c[:] = 1
        c[lo:hi] = 0
        c[hi] += hi - lo
    elif case == "first":
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


@pytest.mark.parametrize("scheme", ["systematic", "stratified",
                                    "multinomial"])
def test_each_resampling_scheme_runs_on_the_card(cuda, scheme):
    """The variant schemes go counts -> merge kernel -> bundle gather inside
    the graphed pieces: gamma reaches 1, one merge per step."""
    m = MichaelisMentenModel.default(method="pallas_exact", device=cuda)
    _build.reset_launch_counts()
    s = make_full_run_on_device(
        m, SMCConfig(n_particles=4096, resampling=scheme))(0)
    assert float(s.gamma) == 1.0
    assert _build.launch_counts["merge"] == int(s.step)
    mean = s.particles.mean(0).cpu()
    assert abs(float(mean[0]) - 1.2) < 0.1 and abs(float(mean[1]) - 0.5) < 0.1


@pytest.mark.parametrize("scheme", ["systematic", "stratified",
                                    "multinomial"])
def test_scheme_counts_sum_to_n_on_the_card(cuda, scheme):
    """On weights whose fp32 scan on the card is not monotone, the counts
    are still non-negative and sum to N in every row, and the merge gives
    the plain version's ancestors."""
    from smc_tpu_torch.smc import kernels as sk
    g = torch.Generator(device=cuda).manual_seed(3)
    d, n = 4, 100_003
    w = -torch.log(torch.rand((d, n), generator=g, device=cuda)) ** 5
    w = w / w.sum(1, keepdim=True)
    shape = (d,) if scheme == "systematic" else (d, n)
    u = torch.rand(shape, generator=g, device=cuda)
    c = sk.resample_counts(u, w, scheme)
    assert bool((c >= 0).all()) and bool((c.sum(1) == n).all())
    offs = (torch.cumsum(c, 1) - c).to(torch.int32)
    assert torch.equal(sk.counts_to_ancestors(c),
                       rs.sorted_offsets_to_ancestors_plain(offs))


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


@pytest.mark.parametrize("nx", [1, 2, 51, 80])
@pytest.mark.parametrize("b", [1, 31, 32, 33, 1037, 1110, 15360])
def test_thomas_ring_kernels_at_every_lane_count(cuda, nx, b):
    """The factor and both applies against their plain versions at 1e-4 of
    each lane's largest value, at lane counts below, at and around one
    32-lane tile, ragged and at the march's width; at row counts that leave
    the ring fewer rows than stages, and at one (80) where the apply keeps
    rp in x rather than in shared memory."""
    A, B, C, r = _blocks(cuda, nx, b, 7 * nx + b)
    LU, ms, _ = tc.block_thomas_factor_pl(A, B, C)
    pLU, pms = tc.block_thomas_factor_plain(A, B, C)
    assert _lane_rel(LU, pLU) < 1e-4
    assert nx == 1 or _lane_rel(ms[1:], pms[1:]) < 1e-4
    assert not ms[0].any()
    want = tc.block_thomas_apply_plain(LU, ms, C, r)
    assert _lane_rel(tc.block_thomas_apply_tiled(LU, ms, C, r), want) < 1e-4
    x8 = tc.block_thomas_apply_pl(*tc.pad_factors(LU, ms, C), r)
    assert _lane_rel(x8, want) < 1e-4


def test_thomas_column_strides_give_equal_bits(cuda):
    """The 7- and 8-column entry points run one body: equal inputs give
    equal bits, for the factor and for the apply."""
    A, B, C, r = _blocks(cuda, 51, 1037, 11)
    LU, ms, _ = tc.block_thomas_factor_pl(A, B, C)
    LU8, ms8, C8 = tc.block_thomas_factor_pl(*tc.pad_blocks(A, B, C))
    assert torch.equal(LU8[:, :, :7], LU) and torch.equal(ms8[:, :, :7], ms)
    assert torch.equal(tc.block_thomas_apply_pl(LU8, ms8, C8, r),
                       tc.block_thomas_apply_tiled(LU, ms, C, r))


def test_thomas_march_width_is_not_refused(cuda):
    """At the march's shape (51, 15,360) the ring fits: every kernel has a
    resident block per SM within the card's shared memory, and launches."""
    for name in ("thomas_factor", "thomas_apply", "thomas_apply_tiled",
                 "thomas_apply_t"):
        info = tc.kernel_info(name, 51)
        assert info["blocks_per_sm"] >= 1 and info["spill_bytes"] == 0
        assert 0 < info["smem_bytes"] <= 227 * 1024
    A, B, C, r = _blocks(cuda, 51, 15360, 2)
    _build.reset_launch_counts()
    LU, ms, _ = tc.block_thomas_factor_pl(A, B, C)
    x = tc.block_thomas_apply_tiled(LU, ms, C, r)
    tc.block_thomas_apply_pl(*tc.pad_factors(LU, ms, C), r)
    lam = tc.block_thomas_apply_t_pl(LU, ms, C, r)
    torch.cuda.synchronize()
    assert torch.isfinite(x).all() and torch.isfinite(lam).all()
    assert (_build.launch_counts["thomas_factor"],
            _build.launch_counts["thomas_apply_tiled"],
            _build.launch_counts["thomas_apply"],
            _build.launch_counts["thomas_apply_t"]) == (1, 1, 1, 1)


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
    monkeypatch.setattr(tc, "block_thomas_apply_t_plain", plain_must_not_run)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tc.block_thomas_apply_t_pl(LU, ms, C, r)


def test_thomas_wrappers_refuse_tracked_inputs_on_the_card(cuda):
    """The factor and the applies have no backward (the solve's route is
    block_thomas_solve_pl): an input that autograd tracks is a ValueError
    before anything launches, and the same call under no_grad launches as
    usual."""
    A, B, C, r = _blocks(cuda, 5, 32, 1)
    LU, ms, _ = tc.block_thomas_factor_pl(A, B, C)
    before = dict(_build.launch_counts)
    for fn, args in ((tc.block_thomas_factor_pl, (A, B, C)),
                     (tc.block_thomas_apply_pl, (LU, ms, C, r)),
                     (tc.block_thomas_apply_tiled, (LU, ms, C, r)),
                     (tc.block_thomas_apply_t_pl, (LU, ms, C, r))):
        tracked = (args[0].clone().requires_grad_(True),) + args[1:]
        with pytest.raises(ValueError, match="no backward"):
            fn(*tracked)
    assert dict(_build.launch_counts) == before
    with torch.no_grad():
        x = tc.block_thomas_apply_tiled(LU.requires_grad_(True), ms, C, r)
    assert torch.equal(x, tc.block_thomas_apply_tiled(LU.detach(), ms, C, r))


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


@pytest.mark.parametrize("nx,b", [(51, 15360), (51, 1037), (1, 5), (2, 33),
                                  (80, 64)])
def test_thomas_apply_t_kernel_matches_plain(cuda, nx, b):
    """The transposed solve (csrc/thomas_apply_t.cu) against its plain
    version on kernel 6's factors: within 1e-5 of the largest |lam| at the
    march's width (1e-4 per lane elsewhere), the 8-column entry the same
    bits, one launch; at one row, two rows (the ring longer than the
    sweep) and at 80 rows (z kept in lam, not in shared memory)."""
    A, B, C, g = _blocks(cuda, nx, b, 5 * nx + b)
    LU, ms, _ = tc.block_thomas_factor_pl(A, B, C)
    _build.reset_launch_counts()
    lam = tc.block_thomas_apply_t_pl(LU, ms, C, g)
    assert _build.launch_counts["thomas_apply_t"] == 1
    want = tc.block_thomas_apply_t_plain(LU, ms, C, g)
    assert float((lam - want).abs().max()) <= 1e-5 * float(
        want.abs().max())
    assert _lane_rel(lam, want) < 1e-4
    assert torch.equal(tc.block_thomas_apply_t_pl(
        *tc.pad_factors(LU, ms, C), g), lam)


def test_solve_backward_on_the_card_matches_the_cpu(cuda):
    """block_thomas_solve_pl's gradient (blocks and rhs) on the card, its
    forward through the apply kernel and its backward through the
    transposed kernel (one launch each), against the same solve's on the
    CPU (plain loops both ways): 1e-5 of each cotangent's largest entry."""
    A, B, C, r = _blocks(cuda, 51, 1037, 9)
    w = torch.randn_like(r)
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        ins = [t.to(dev).clone().requires_grad_(True) for t in (A, B, C, r)]
        LU, ms, _ = tc.block_thomas_factor_pl(*(t.detach()
                                               for t in ins[:3]))
        _build.reset_launch_counts()
        x = tc.block_thomas_solve_pl(*ins[:3], LU, ms, ins[3])
        grads[dev.type] = torch.autograd.grad((x * w.to(dev)).sum(), ins)
        if dev.type == "cuda":
            assert (_build.launch_counts["thomas_apply_tiled"],
                    _build.launch_counts["thomas_apply_t"]) == (1, 1)
    for g, c in zip(grads["cuda"], grads["cpu"]):
        assert float((g.cpu() - c).abs().max()) <= 1e-5 * float(
            c.abs().max())


def test_transient_gradient_on_auto_matches_the_plain_loops(cuda):
    """The transient likelihood's gradient through the kernels ("auto")
    against the plain loops' ("thomas") on the card, at draws near the
    truth on a small lagged march: the same failed lanes, each parameter
    within 1e-3 of its largest |g| over the particles that pass; the
    launches of a likelihood-and-gradient: 13 factors, 61 applies and 61
    transposed applies per chunk."""
    import dataclasses

    from smc_tpu_torch.models.methanation import KIN_TRUE, MethanationModel
    m = MethanationModel.default(n_conditions=3, nx=11, particle_chunk=8,
                                 device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    truth = torch.tensor(KIN_TRUE[:4] + (5.0,), device=cuda)
    theta = truth * (1 + 0.005 * torch.randn((16, 5), generator=g,
                                             device=cuda))
    out = {}
    for solver in ("auto", "thomas"):
        t = theta.clone().requires_grad_(True)
        _build.reset_launch_counts()
        ll, flows = dataclasses.replace(m, solver=solver).log_likelihood(t)
        (gr,) = torch.autograd.grad(ll.sum(), t)
        out[solver] = (gr, flows.detach(), dict(_build.launch_counts))
    (gk, fk, ck), (gp, fp, cp) = out["auto"], out["thomas"]
    assert (ck["thomas_factor"], ck["thomas_apply_tiled"],
            ck["thomas_apply_t"]) == (2 * 13, 2 * 61, 2 * 61)
    assert not any(cp.values())
    fail = (fk == -10000.0).all(dim=1)
    assert torch.equal(fail, (fp == -10000.0).all(dim=1))
    keep = ~fail.any(dim=1)
    assert int(keep.sum()) >= 8
    scale = gp[keep].abs().amax(dim=0)
    assert bool(((gk - gp)[keep].abs() <= 1e-3 * scale).all())


# ---- the RK4 likelihood, the population axis, the ensemble ----------------

@pytest.mark.parametrize("n", [4096, 1001])
def test_rk4_kernel_matches_plain(cuda, n):
    """csrc/mm_rk4.cu against its plain version: the same -inf rows
    (sigma <= 0, NaN inputs) and never a NaN; on stable draws (Km >= 0.3)
    within 5e-5 of the larger of ll's two terms."""
    m = MichaelisMentenModel.default(method="pallas", device=cuda)
    g = torch.Generator(device=cuda).manual_seed(n)
    theta = torch.rand((n, 3), generator=g, device=cuda) * 10.0
    theta[::7, 2] *= -1.0
    theta[1::11, 2] = 0.0
    theta[2::13, 1] = 0.0
    theta[3::17, 0] = math.nan
    _build.reset_launch_counts()
    got = mm.mm_loglik_pallas(theta, m.obs, m.s0, m.dt, 4)
    assert _build.launch_counts["mm_rk4"] == 1
    want = mm.mm_loglik_rk4_plain(theta, m.obs, m.s0, m.dt, 4)
    assert not bool(torch.isnan(got).any())
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert bool(torch.isneginf(got[::7]).all())
    assert bool(torch.isneginf(got[3::17]).all())
    ok = torch.isfinite(want) & (theta[:, 1] >= 0.3)
    sigma = theta[:, 2].clamp_min(1e-12)[ok]
    t1 = -120.0 * (math.log(2 * math.pi) + 2 * torch.log(sigma))
    scale = torch.maximum(t1.abs(), (t1 - want[ok]).abs())
    assert bool(((got[ok] - want[ok]).abs() <= 5e-5 * scale).all())
    # through the model
    ll, pred = m.log_likelihood(theta)
    assert pred is None and torch.equal(ll, got)


def test_rk4_wrapper_launches_or_raises(cuda):
    m = MichaelisMentenModel.default(method="pallas", device=cuda)
    theta = torch.rand((64, 3), device=cuda)
    with pytest.raises(TypeError):
        mm.mm_loglik_pallas(theta.double(), m.obs, m.s0, m.dt)
    with pytest.raises(ValueError):
        mm.mm_loglik_pallas(theta, m.obs, m.s0[:3], m.dt)
    with pytest.raises(ValueError):
        mm.mm_loglik_pallas(theta, m.obs, m.s0, m.dt, substeps=0)


def _edge_theta(cuda, n, seed, nan_rows=True):
    """Prior draws U[0, 10]^3 with the edge rows: sigma < 0, sigma = 0,
    Km = 0 and, for the RK4 kernel, NaN Vmax and Km."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    theta = torch.rand((n, 3), generator=g, device=cuda) * 10.0
    theta[::7, 2] *= -1.0
    theta[1::11, 2] = 0.0
    theta[2::13, 1] = 0.0
    if nan_rows:
        theta[3::17, 0] = math.nan
        theta[4::19, 1] = math.nan
    return theta, g


def _term_scale(theta, ll, n_ds, n_obs):
    sigma = theta[:, 2].clamp_min(1e-12)
    t1 = (-0.5 * n_ds * n_obs) * (math.log(2 * math.pi)
                                  + 2 * torch.log(sigma))
    return torch.maximum(t1.abs(), (t1 - ll).abs())


# n_ds = 5 and 6 take mm_rk4's template instances, 1, 3 and 7 its generic
# path (mm_exact has one path for every count); N is ragged against every
# block size.
@pytest.mark.parametrize("n_ds,n", [(6, 1037), (5, 999), (1, 1037), (3, 1037),
                                    (7, 515)])
def test_mm_exact_kernel_at_every_dataset_count(cuda, n_ds, n):
    """csrc/mm_exact.cu against its plain version, two populations: the
    same -inf rows, rtol 1e-5 of the larger ll term elsewhere, and the
    same bits on a second launch."""
    theta, g = _edge_theta(cuda, 2 * n, 100 + n_ds, nan_rows=False)
    theta = theta.reshape(2, n, 3).contiguous()
    obs = (torch.rand((2, n_ds, 40), generator=g, device=cuda) * 2.0)
    s0 = 0.1 + 3.0 * torch.rand((2, n_ds), generator=g, device=cuda)
    _build.reset_launch_counts()
    got = mm.mm_loglik_exact_batched(theta, obs, s0, 0.25)
    assert _build.launch_counts["mm_exact"] == 1
    want = mm.mm_loglik_exact_plain(theta, obs, s0, 0.25)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert not bool(torch.isnan(got).any())
    fin = torch.isfinite(want)
    scale = _term_scale(theta[fin], want[fin], n_ds, 40)
    assert bool(((got[fin] - want[fin]).abs() <= 1e-5 * scale).all())
    assert torch.equal(mm.mm_loglik_exact_batched(theta, obs, s0, 0.25), got)
    # one population through the batched entry: the same bits per row
    one = mm.mm_loglik_exact(theta[1].contiguous(), obs[1].contiguous(),
                             s0[1].contiguous(), 0.25)
    assert torch.equal(one, got[1])


@pytest.mark.parametrize("n_ds,n", [(6, 1037), (5, 999), (1, 1037), (3, 1037),
                                    (7, 515)])
def test_mm_rk4_kernel_at_every_dataset_count(cuda, n_ds, n):
    """csrc/mm_rk4.cu against its plain version on prior draws: the same
    -inf rows and never a NaN (Km = 0 and NaN rows included), within 5e-5
    of the larger ll term where Km >= 0.3, and the same bits on a second
    launch."""
    theta, g = _edge_theta(cuda, n, 200 + n_ds)
    obs = torch.rand((n_ds, 40), generator=g, device=cuda) * 2.0
    s0 = 0.1 + 3.0 * torch.rand((n_ds,), generator=g, device=cuda)
    _build.reset_launch_counts()
    got = mm.mm_loglik_pallas(theta, obs, s0, 0.25, 4)
    assert _build.launch_counts["mm_rk4"] == 1
    want = mm.mm_loglik_rk4_plain(theta, obs, s0, 0.25, 4)
    assert not bool(torch.isnan(got).any())
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert bool(torch.isneginf(got[::7]).all())
    assert bool(torch.isneginf(got[3::17]).all())
    ok = torch.isfinite(want) & (theta[:, 1] >= 0.3)
    scale = _term_scale(theta[ok], want[ok], n_ds, 40)
    assert bool(((got[ok] - want[ok]).abs() <= 5e-5 * scale).all())
    assert torch.equal(mm.mm_loglik_pallas(theta, obs, s0, 0.25, 4), got)


@pytest.mark.parametrize("d,n,k", [
    (64, 2048, 81), (5, 70001, 81), (1, 100000, 81),
    (3, 2049, 81), (3, 2050, 81), (3, 2051, 81),   # rows not 16-byte aligned
    (4, 1000, 1), (2, 5000, 200),                  # K = 1, K = 200
    (3, 300, 81),                                  # N below one chunk
    (2, 300_000, 81)])                             # several chunks a block
def test_batched_ladder_kernel(cuda, d, n, k):
    """(D, N) x (D, K): against the plain form (rtol 1e-5), the same bits
    on two runs, one launch, and each row the unbatched entry's bits (also
    from a copy of the row at another alignment)."""
    g = torch.Generator(device=cuda).manual_seed(d)
    dl = -torch.rand((d, n), generator=g, device=cuda) * 50.0
    dl[:, ::13] = -math.inf
    dg = (0.7 ** torch.arange(k, device=cuda, dtype=torch.float64)).float()
    dg = (dg[None] * (0.1 + torch.rand((d, 1), generator=g, device=cuda))
          ).contiguous()
    _build.reset_launch_counts()
    s1, s2 = ld.ladder_stats(dl, dg)
    assert _build.launch_counts["ladder"] == 1 and s1.shape == (d, k)
    r1, r2 = ld.ladder_stats_plain(dl, dg)
    torch.testing.assert_close(s1, r1, rtol=1e-5, atol=0)
    torch.testing.assert_close(s2, r2, rtol=1e-5, atol=0)
    t1, t2 = ld.ladder_stats(dl, dg)
    assert torch.equal(s1, t1) and torch.equal(s2, t2)
    for p in {0, d - 1}:
        u1, u2 = ld.ladder_stats(dl[p].contiguous(), dg[p].contiguous())
        assert torch.equal(u1, s1[p]) and torch.equal(u2, s2[p])
        v1, v2 = ld.ladder_stats(dl[p].clone(), dg[p].clone())
        assert torch.equal(v1, s1[p]) and torch.equal(v2, s2[p])


def test_ladder_and_merge_replay_in_a_graph(cuda):
    """A ladder and a merge captured in one CUDA graph and replayed three
    times give the eager calls' bits every time: the ladder's ticket
    counters are back at zero after each launch."""
    g = torch.Generator(device=cuda).manual_seed(11)
    dl = -torch.rand((4, 5003), generator=g, device=cuda) * 30.0
    dg = (0.7 ** torch.arange(81, device=cuda, dtype=torch.float64)).float()
    dg = dg[None].repeat(4, 1).contiguous()
    c = torch.multinomial(torch.ones(5003, device=cuda), 4 * 5003,
                          replacement=True, generator=g).reshape(4, 5003)
    c = torch.stack([row.bincount(minlength=5003) for row in c])
    offs = (torch.cumsum(c, 1) - c).to(torch.int32).contiguous()
    e1, e2 = ld.ladder_stats(dl, dg)
    ea = rs.sorted_offsets_to_ancestors(offs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ld.ladder_stats(dl, dg)
        rs.sorted_offsets_to_ancestors(offs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        c1, c2 = ld.ladder_stats(dl, dg)
        ca = rs.sorted_offsets_to_ancestors(offs)
    for _ in range(3):
        c1.zero_()
        ca.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(c1, e1) and torch.equal(c2, e2)
        assert torch.equal(ca, ea)


@pytest.mark.parametrize("d,n", [(64, 2048), (3, 50003), (1, 4097),
                                 (5, 2176), (4, 2177), (7, 3)])
def test_batched_merge_kernel(cuda, d, n):
    """(D, N) offset ladders with zero-count ties, one-takes-all and
    all-ones rows: bitwise the plain form, and each row the unbatched
    entry's bits."""
    c = torch.multinomial(torch.ones(n, device=cuda), d * n,
                          replacement=True).reshape(d, n)
    c = torch.stack([row.bincount(minlength=n) for row in c])
    c[0] = 0
    c[0, n // 3] = n                       # one takes all
    if d > 1:
        c[1] = 1                           # all ones
    offs = (torch.cumsum(c, 1) - c).to(torch.int32).contiguous()
    _build.reset_launch_counts()
    got = rs.sorted_offsets_to_ancestors(offs)
    assert _build.launch_counts["merge"] == 1
    assert torch.equal(got, rs.sorted_offsets_to_ancestors_plain(offs))
    for p in range(min(d, 3)):
        assert torch.equal(rs.sorted_offsets_to_ancestors(offs[p].contiguous()),
                           got[p])


def test_batched_wrappers_reject_bad_shapes(cuda):
    with pytest.raises(ValueError):
        ld.ladder_stats(torch.zeros((2, 8), device=cuda),
                        torch.ones((3, 4), device=cuda))
    with pytest.raises(ValueError):
        ld.ladder_stats(torch.zeros((2, 2, 8), device=cuda),
                        torch.ones((2, 2, 4), device=cuda))
    with pytest.raises(ValueError):
        rs.sorted_offsets_to_ancestors(
            torch.zeros((2, 2, 8), dtype=torch.int32, device=cuda))


class _CpuDrawsOn:
    """Draws from one CPU generator, moved to ``device``."""

    def __init__(self, seed, device):
        self.gen, self.device = torch.Generator().manual_seed(seed), device

    def uniform(self, shape, dtype=None):
        return torch.rand(shape, generator=self.gen).to(self.device)

    def normal(self, shape, dtype=None):
        return torch.randn(shape, generator=self.gen).to(self.device)


def _eager_run(model, cfg, key):
    """The eager composition of a run: init_state, then smc_step until
    gamma = 1."""
    from smc_tpu_torch import init_state, smc_step
    s = init_state(key, model, cfg)
    while bool(((s.step < cfg.max_steps) & (s.gamma < 1.0)).item()):
        s = smc_step(s, model.log_likelihood, model.prior, cfg)
    return s


def _eager_ensemble(prior, loglik, d, cfg, key, data):
    """The eager composition of an ensemble run from the un-captured pieces
    of make_ensemble_sweep_fns (the loop the graphed entry points run)."""
    from smc_tpu_torch.smc.ensemble import make_ensemble_sweep_fns
    einit, prep, mut_init, mut_sweep, finish = make_ensemble_sweep_fns(
        prior, loglik, d, cfg)
    s = einit(key, data)
    while bool(torch.any((s.gamma < 1.0) & (s.step < cfg.max_steps))):
        key_, k_mh, g, parts, lk = prep(s)
        n_mh = torch.where(g.gamma >= 1.0, cfg.mh_steps_final, cfg.mh_steps)
        frozen = s.gamma >= 1.0
        c = mut_init(k_mh, parts, lk, data)
        first = True
        while True:
            active = ~c.done & (c.j < n_mh) & ~frozen
            if not first and not bool(active.any()):
                break
            c = mut_sweep(c, g.gamma, data, active)
            first = False
        s = finish(s, key_, g, c)
    return s


def test_ensemble_on_the_card_matches_the_cpu_with_the_same_draws(cuda):
    """D = 4 populations x N = 2048 through the kernels against the same
    ensemble on the CPU (plain versions): steps per population within one,
    posterior means within a quarter of a posterior sd, log-evidence within
    0.5; one batched launch of each kernel per ensemble sweep or step."""
    from smc_tpu_torch import Prior, make_ensemble_run
    from smc_tpu_torch.models.michaelis_menten import (
        generate_mm_pseudo_data, make_mm_data_loglik)
    ts, obs0, s0 = generate_mm_pseudo_data()
    d, cfg = 4, SMCConfig(n_particles=2048)
    gen = torch.Generator().manual_seed(5)
    obs = torch.tensor(obs0)[None] + 0.02 * torch.randn(
        (d,) + obs0.shape, generator=gen)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        prior = Prior.uniform([0.0] * 3, [10.0] * 3, device=dev)
        ll = make_mm_data_loglik(torch.tensor(ts, device=dev),
                                 torch.tensor(s0, device=dev),
                                 method="pallas_exact")
        _build.reset_launch_counts()
        # The card side through the eager pieces: graphed runs draw from a
        # torch.Generator, not from CPU draws moved over.
        out[dev.type] = _eager_ensemble(prior, ll, d, cfg,
                                        _CpuDrawsOn(7, dev), obs.to(dev))
        if dev.type == "cuda":
            counts = dict(_build.launch_counts)
    g, c = out["cuda"], out["cpu"]
    assert bool((g.gamma == 1.0).all()) and bool((c.gamma == 1.0).all())
    # a flipped accept lets a population's two runs drift apart like two
    # seeds: a step more or less is allowed
    assert int((g.step.cpu() - c.step).abs().max()) <= 1
    assert counts["ladder"] == counts["merge"] == int(g.step.max())
    assert counts["mm_exact"] > counts["ladder"] and counts["mm_rk4"] == 0
    pg, pc = g.particles.cpu(), c.particles
    assert bool(((pg.mean(1) - pc.mean(1)).abs() < 0.25 * pc.std(1)).all())
    assert bool(((g.log_evidence.cpu() - c.log_evidence).abs() < 0.5).all())


_STATE_FIELDS = ("particles", "log_lik", "gamma", "step", "ess",
                 "max_log_lik", "n_mh", "accepted", "n_gamma_reductions",
                 "mh_ratio", "total_lik_evals", "log_evidence")


# The steady march's small configuration (tests/test_methanation_grad.py's).
_STEADY_SMALL = dict(n_conditions=3, nx=15, n_steps=40, growth=1.3,
                     particle_chunk=4, newton_iters=3, march="steady")


def _graph_case(case, cuda):
    """(graphed run, eager run) of one path, each a function of a seed."""
    if case in ("mm", "mm_mala", "mm_hmc"):
        kind = "rwm" if case == "mm" else case[3:]
        m = MichaelisMentenModel.default(
            method="pallas_exact" if kind == "rwm" else "exact", device=cuda)
        cfg = SMCConfig(n_particles=4096, mutation=kind, hmc_leapfrog=3)
        return (make_full_run_on_device(m, cfg),
                lambda seed: _eager_run(m, cfg, seed))
    if case == "methanation":
        from smc_tpu_torch.models.methanation import MethanationModel
        m = MethanationModel.default(
            n_conditions=3, nx=11, n_steps=12, growth=1.6, jac_stride=3,
            dense_tail=3, device=cuda)
        cfg = SMCConfig(n_particles=64, mh_steps=2, mh_steps_final=4)
        return (make_full_run_on_device(m, cfg),
                lambda seed: _eager_run(m, cfg, seed))
    if case.startswith("methanation_transient"):
        from smc_tpu_torch.models.methanation import MethanationModel
        m = MethanationModel.default(
            n_conditions=3, nx=11, n_steps=12, growth=1.6, jac_stride=3,
            dense_tail=3, particle_chunk=64, device=cuda)
        cfg = SMCConfig(n_particles=64, mutation=case.split("_")[-1],
                        hmc_leapfrog=3, mh_steps=2, mh_steps_final=3)
        return (make_full_run_on_device(m, cfg),
                lambda seed: _eager_run(m, cfg, seed))
    if case == "methanation_steady_mala":
        from smc_tpu_torch.models.methanation import MethanationModel
        m = MethanationModel.default(**dict(_STEADY_SMALL,
                                            particle_chunk=64), device=cuda)
        cfg = SMCConfig(n_particles=64, mutation="mala", mh_steps=2,
                        mh_steps_final=3)
        return (make_full_run_on_device(m, cfg),
                lambda seed: _eager_run(m, cfg, seed))
    from smc_tpu_torch import Prior, make_ensemble_run
    from smc_tpu_torch.models.michaelis_menten import (
        generate_mm_pseudo_data, make_mm_data_loglik)
    ts, obs0, s0 = generate_mm_pseudo_data()
    d = 3
    cfg = SMCConfig(n_particles=1024, mutation="mala"
                    if case == "ensemble_mala" else "rwm")
    gen = torch.Generator().manual_seed(5)
    obs = (torch.tensor(obs0)[None] + 0.02 * torch.randn(
        (d,) + obs0.shape, generator=gen)).to(cuda)
    prior = Prior.uniform([0.0] * 3, [10.0] * 3, device=cuda)
    ll = make_mm_data_loglik(torch.tensor(ts, device=cuda),
                             torch.tensor(s0, device=cuda),
                             method={"ensemble_pallas": "pallas",
                                     "ensemble_mala": "exact"}.get(
                                         case, "pallas_exact"))
    run = make_ensemble_run(prior, ll, d, cfg)
    return (lambda seed: run(seed, obs),
            lambda seed: _eager_ensemble(prior, ll, d, cfg, seed, obs))


@pytest.mark.parametrize("case", ["mm", "ensemble", "ensemble_pallas",
                                  "methanation", "mm_mala", "mm_hmc",
                                  "ensemble_mala", "methanation_steady_mala",
                                  "methanation_transient_mala",
                                  "methanation_transient_hmc"])
def test_graphed_run_is_bit_equal_to_the_eager_composition(cuda, case):
    """The graphed entry point (each piece of a step one CUDA graph replay)
    and the eager composition of the same pieces give the same final state,
    bit for bit, with the same kernel launches; the first call captures,
    the second replays."""
    graphed, eager = _graph_case(case, cuda)
    for seed in (1, 2):
        _build.reset_launch_counts()
        g = graphed(seed)
        g_counts = dict(_build.launch_counts)
        _build.reset_launch_counts()
        e = eager(seed)
        assert dict(_build.launch_counts) == g_counts
        for f in _STATE_FIELDS:
            assert torch.equal(getattr(g, f), getattr(e, f)), (seed, f)
    assert bool((g.gamma == 1.0).all())


def test_second_graphed_run_leaves_the_first_state(cuda):
    graphed, _ = _graph_case("mm", cuda)
    first = graphed(3)
    kept = {f: getattr(first, f).clone() for f in _STATE_FIELDS}
    second = graphed(4)
    assert not torch.equal(second.particles, first.particles)
    for f in _STATE_FIELDS:
        assert torch.equal(getattr(first, f), kept[f]), f


def test_graphed_run_refuses_draws_it_cannot_replay(cuda):
    graphed, _ = _graph_case("mm", cuda)
    with pytest.raises(TypeError, match="TorchDraws"):
        graphed(_CpuDrawsOn(0, cuda))


def test_launch_accounting_under_replay(cuda):
    """launch_counts counts kernel executions: a graphed run counts what the
    eager run launches, the capture and its warm-up count nothing, and
    every replay of a piece adds the launches recorded at its capture."""
    from smc_tpu_torch.smc.driver import _Stepper
    m = MichaelisMentenModel.default(method="pallas_exact", device=cuda)
    cfg = SMCConfig(n_particles=4096)
    stepper = _Stepper(m, cfg, init=True)
    _build.reset_launch_counts()
    s = stepper.run(None, 5)
    counts = dict(_build.launch_counts)
    prog = next(iter(stepper.programs.by_shape.values()))
    sweeps = int(round(float(s.total_lik_evals) / 4096)) - 1
    steps = int(s.step)
    assert counts["mm_exact"] == sweeps + 1
    assert counts["ladder"] == counts["merge"] == steps
    assert prog.graphs["init"][1]["mm_exact"] == 1
    assert prog.graphs["prep"][1]["ladder"] == 1
    assert prog.graphs["mut_sweep"][1]["mm_exact"] == 1
    # init + per step: prep, mut_init, finish, and one mut_sweep per later
    # sweep
    assert prog.replays == 1 + 3 * steps + (sweeps - steps)
    _build.reset_launch_counts()
    stepper.run(None, 5)
    assert dict(_build.launch_counts) == counts


@pytest.mark.parametrize("d", [1, 3, 64])
def test_batched_mm_rk4_kernel(cuda, d):
    """Kernel 5 with a population axis (grid.y): each row has the bits of
    the per-population launch (B = 1: the unbatched entry), the same -inf
    rows as the batched plain version and rtol 5e-5 of the larger ll term
    where Km >= 0.3; a ragged N."""
    m = MichaelisMentenModel.default(method="pallas", device=cuda)
    g = torch.Generator(device=cuda).manual_seed(d)
    n = 2053
    theta = torch.rand((d, n, 3), generator=g, device=cuda) * 10.0
    theta[:, ::97, 2] *= -1.0
    theta[:, 2::89, 1] = 0.0
    theta[:, 3::113, 0] = math.nan
    obs = (m.obs[None] + 0.02 * torch.randn((d,) + m.obs.shape, generator=g,
                                            device=cuda)).contiguous()
    s0 = m.s0[None].repeat(d, 1).contiguous()
    got = mm.mm_loglik_pallas_batched(theta, obs, s0, m.dt, 4)
    for p in range(d):
        one = mm.mm_loglik_pallas(theta[p].contiguous(), obs[p].contiguous(),
                                  s0[p].contiguous(), m.dt, 4)
        assert torch.equal(got[p], one)
    want = mm.mm_loglik_rk4_plain(theta, obs, s0, m.dt, 4)
    assert not bool(torch.isnan(got).any())
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want) & (theta[..., 1] >= 0.3)
    sigma = theta[..., 2].clamp_min(1e-12)[fin]
    t1 = -120.0 * (math.log(2 * math.pi) + 2 * torch.log(sigma))
    scale = torch.maximum(t1.abs(), (t1 - want[fin]).abs())
    assert bool(((got[fin] - want[fin]).abs() <= 5e-5 * scale).all())
    assert torch.equal(mm.mm_loglik_pallas_batched(theta, obs, s0, m.dt, 4),
                       got)


@pytest.mark.parametrize("kind,method", [("rwm", "pallas_exact"),
                                         ("mala", "exact"), ("hmc", "exact")])
def test_block_is_bit_equal_to_sweep_on_the_card(cuda, kind, method):
    """run_smc(granularity="block") against "sweep" from the same seed: a
    slab's core graph reads views of the full-N buffers, and every row's
    arithmetic is the full-N core's, so the final states are equal bit for
    bit; each core graph replays once per sweep and slab."""
    from smc_tpu_torch import run_smc
    from smc_tpu_torch.smc import graphs
    m = MichaelisMentenModel.default(method=method, device=cuda)
    cfg = SMCConfig(n_particles=4096, mutation=kind, hmc_leapfrog=2)
    sweep = run_smc(m, cfg, 3, verbose=False, granularity="sweep")
    graphs.reset_stats()
    block = run_smc(m, cfg.replace(block_particles=1024), 3, verbose=False,
                    granularity="block")
    for f in _STATE_FIELDS:
        assert torch.equal(getattr(block, f), getattr(sweep, f)), f
    sweeps = round(float(block.total_lik_evals - 4096)
                   / (4096 * cfg.evals_per_sweep))
    assert graphs.stats["host_reads"] == int(block.step) + sweeps + 1
    grads = 4 if kind != "rwm" else 0
    # per step: prep, grads, mut_init, finish; per sweep: draw, 4 cores,
    # admin
    assert graphs.stats["replays"] == (int(block.step) * (3 + grads)
                                       + sweeps * 6)


def test_autograd_gradient_on_the_card_matches_the_cpu(cuda):
    """_make_ll_and_grad of the MM exact likelihood on the card against the
    CPU on the same particles: the same -inf rows and zero gradients there,
    log-likelihoods within 1e-5 of the larger ll term, gradients within
    1e-3 of each row's largest |g| (elementwise fp32 on two devices; the
    backward of Lambert W's Halley steps compounds the last bits)."""
    from smc_tpu_torch.smc.kernels import _make_ll_and_grad
    g = torch.Generator().manual_seed(2)
    theta = (torch.tensor([1.2, 0.5, 0.02]) + torch.randn(
        (4096, 3), generator=g) * torch.tensor([0.3, 0.3, 0.01])).abs()
    theta[::17, 2] = -0.01
    out = {}
    for dev in (cuda, torch.device("cpu")):
        m = MichaelisMentenModel.default(method="exact", device=dev)
        out[dev.type] = _make_ll_and_grad(m.log_likelihood)(theta.to(dev))
    (lg, gg), (lc, gc) = out["cuda"], out["cpu"]
    lg, gg = lg.cpu(), gg.cpu()
    assert torch.equal(torch.isinf(lg), torch.isinf(lc))
    assert bool((gc[torch.isinf(lc)] == 0).all())
    assert bool((gg[torch.isinf(lg)] == 0).all())
    fin = torch.isfinite(lc)
    sigma = theta[fin, 2].clamp_min(1e-12)
    t1 = -120.0 * (math.log(2 * math.pi) + 2 * torch.log(sigma))
    scale = torch.maximum(t1.abs(), (t1 - lc[fin]).abs())
    assert bool(((lg[fin] - lc[fin]).abs() <= 1e-5 * scale).all())
    row = gc[fin].abs().amax(1, keepdim=True)
    assert bool(((gg[fin] - gc[fin]).abs() <= 1e-3 * row).all())


def test_gradient_kinds_refuse_the_kernels_on_the_card(cuda):
    """A gradient kind on a CUDA likelihood raises, with no fallback."""
    from smc_tpu_torch import run_smc
    for method in ("pallas_exact", "pallas"):
        m = MichaelisMentenModel.default(method=method, device=cuda)
        with pytest.raises(ValueError, match="no backward"):
            run_smc(m, SMCConfig(n_particles=256, mutation="mala"), 0,
                    verbose=False)


def test_map_on_the_card_matches_the_cpu(cuda):
    """map_estimate from the same starts (a CPU generator's prior draws) on
    the card and on the CPU: the best start's theta within 0.02 and its
    log-posterior within 0.05 (each step one CUDA graph replay on the card,
    eager on the CPU). Starts that end in the flat region far from the fit
    may part by more: there the last bits steer Adam."""
    from smc_tpu_torch import map_estimate
    out = {}
    for dev in (cuda, torch.device("cpu")):
        m = MichaelisMentenModel.default(method="exact", device=dev)
        out[dev.type] = map_estimate(m, _CpuDrawsOn(2, dev), n_starts=8)
    g, c = out["cuda"], out["cpu"]
    assert bool(((g.theta.cpu() - c.theta).abs() < 0.02).all())
    assert abs(float(g.log_post) - float(c.log_post)) < 0.05


@pytest.mark.parametrize("fmt", ["npz", "smck", "smcd"])
def test_checkpoint_in_a_graphed_run_resumes_bit_equal(cuda, tmp_path, fmt):
    """A checkpoint taken by run_smc's callback (the run's steps graph
    replays) in each format resumes on the card to the uninterrupted run's
    final state, bit for bit, with its generator state."""
    from smc_tpu_torch import run_smc
    from smc_tpu_torch.io import checkpoint as ck
    from smc_tpu_torch.runtime import AsyncCheckpointer
    m = MichaelisMentenModel.default(method="pallas_exact", device=cuda)
    cfg = SMCConfig(n_particles=20_000)
    path = str(tmp_path / "mid")
    with AsyncCheckpointer() as writer:
        def callback(s):
            if int(s.step) != 3:
                return
            if fmt == "npz":
                ck.save_state(path + ".npz", s)
            elif fmt == "smck":
                ck.save_state_async(writer, path + ".smck", s)
            else:
                ck.save_state_chunked(path, s, max_bytes=50_000)
        final = run_smc(m, cfg, 5, callback=callback, verbose=False)
        writer.flush()
        assert writer.stats() == {"written": int(fmt == "smck"),
                                  "errors": 0, "native": True}
    resumed = run_smc(m, cfg, None, verbose=False,
                      state=ck.load_state(f"{path}.{fmt}", device=cuda))
    assert int(final.step) > 3 and bool(final.gamma == 1.0)
    for f in _STATE_FIELDS:
        assert torch.equal(getattr(resumed, f), getattr(final, f)), f
    assert torch.equal(resumed.key.generator.get_state(),
                       final.key.generator.get_state())


@pytest.mark.parametrize("form", ["ode", "dae"])
def test_robertson_bdf2_graphed_is_bit_equal_to_eager(cuda, form):
    """The implicit march (forward-mode Jacobians, pivoted solves) inside
    the captured graphs gives the eager composition's bits; a short run
    (2 steps of 2 sweeps)."""
    from smc_tpu_torch.models.generic import robertson_model
    m = robertson_model(form=form, device=cuda)
    cfg = SMCConfig(n_particles=1024, max_steps=2, mh_steps=2)
    g = make_full_run_on_device(m, cfg)(1)
    e = _eager_run(m, cfg, 1)
    assert int(g.step) == 2 and bool(torch.isfinite(g.log_evidence))
    for f in _STATE_FIELDS:
        assert torch.equal(getattr(g, f), getattr(e, f)), f


def test_mm_dopri5_runs_to_gamma_one(cuda):
    m = MichaelisMentenModel.default(method="dopri5", device=cuda)
    s = make_full_run_on_device(m, SMCConfig(n_particles=20_000))(3)
    assert bool(s.gamma == 1.0) and bool(torch.isfinite(s.particles).all())
    mean = s.particles.double().mean(0).cpu()
    assert abs(float(mean[0]) - 1.2) < 0.05 and abs(float(mean[1]) - 0.5) \
        < 0.05


def test_blocked_engine_at_flagship_depth_matches_lanes_major(cuda):
    """The blocked oracle at the flagship's full width and depth (nx = 51,
    30 conditions, the 48-step march) against the lanes-major engine with
    ``pivot=True``: flows within rtol 1e-3 and atol 5e-3, the JAX
    package's tolerance between its two engines, at N = 64 posterior-bulk
    thetas; about a minute a side, bound by the host's launches."""
    import dataclasses

    from smc_tpu_torch.models.methanation import MethanationModel
    m = MethanationModel.default(device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(16)
    truth = torch.tensor([m.base_params[i] for i in m.est_idx], device=cuda)
    theta = truth * (1.0 + 0.005 * torch.randn(
        (64, len(m.est_idx)), generator=gen, device=cuda))
    ll_b, flows_b = dataclasses.replace(m, engine="blocked").log_likelihood(
        theta)
    ll_l, flows_l = dataclasses.replace(m, pivot=True).log_likelihood(theta)
    assert m.nx == 51 and m.cond.n_data == 30 and m.n_steps == 48
    assert bool(torch.isfinite(ll_b).all())
    torch.testing.assert_close(flows_b, flows_l, rtol=1e-3, atol=5e-3)


# ---- the steady march and its adjoint ------------------------------------

def test_steady_march_through_the_kernels_matches_the_plain_loops(cuda):
    """The steady march at the flagship's full width (nx = 51, 30
    conditions) through the block-Thomas kernels against solver="thomas"
    (the plain loops) on the card: 14 factor and 42 tiled-apply launches
    per chunk, the same failed lanes, flows within 0.05 sccm, at N = 64
    posterior-bulk thetas."""
    import dataclasses

    from smc_tpu_torch.models.methanation import MethanationModel
    m = MethanationModel.default(march="steady", particle_chunk=64,
                                 device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(17)
    truth = torch.tensor([m.base_params[i] for i in m.est_idx], device=cuda)
    theta = truth * (1.0 + 0.005 * torch.randn(
        (64, len(m.est_idx)), generator=gen, device=cuda))
    _build.reset_launch_counts()
    ll, flows = m.log_likelihood(theta)
    counts = dict(_build.launch_counts)
    assert counts["thomas_factor"] == 14
    assert counts["thomas_apply_tiled"] == 42
    assert counts["thomas_apply"] == 0
    _, want = dataclasses.replace(m, solver="thomas").log_likelihood(theta)
    assert dict(_build.launch_counts) == counts
    assert bool(torch.isfinite(ll).all())
    assert torch.equal(flows == -10000.0, want == -10000.0)
    ok = want != -10000.0
    assert float((flows - want)[ok].abs().max()) <= 0.05


def _steady_pair(cuda, **kw):
    """The small steady model on the card and on the CPU over the same
    arrays (the CPU's observations)."""
    from smc_tpu_torch.convert import methanation_model_from_numpy
    from smc_tpu_torch.models.methanation import (MethanationModel,
                                                  condition_table_numpy)
    cfg = dict(_STEADY_SMALL, **kw)
    cpu = MethanationModel.default(device="cpu", **cfg)
    cfg.pop("n_conditions")
    card = methanation_model_from_numpy(
        condition_table_numpy(3, nx=15), cpu.obs.numpy(), cpu.prior,
        device=cuda, **cfg)
    return card, cpu


_STEADY_THETA = ((13.04, 52.2e3, 1.147e5, 96.7e3, 5.0),
                 (15.0, 52.5e3, 1.5e5, 9.7e4, 4.0),
                 (11.0, 51.9e3, 0.9e5, 9.6e4, 6.0),
                 (13.0, 52.0e3, 2.0e5, 9.8e4, 5.0))


def test_steady_adjoint_on_the_card_matches_the_cpu(cuda):
    """The implicit-function adjoint on the card against the CPU port on
    the same draws: the likelihoods within 1e-5 relative, each gradient
    component within 1% of the parameter's largest |gradient| over the
    draws (the adjoint's regularized system amplifies the devices'
    rounding; the CPU port is within 3e-4 of jax.grad)."""
    card, cpu = _steady_pair(cuda)
    grads = []
    for m, dev in ((card, cuda), (cpu, torch.device("cpu"))):
        th = torch.tensor(_STEADY_THETA, device=dev).requires_grad_(True)
        ll, _ = m.log_likelihood(th)
        (g,) = torch.autograd.grad(ll.sum(), th)
        grads.append((ll.detach().cpu(), g.cpu()))
    (ll_g, g_g), (ll_c, g_c) = grads
    torch.testing.assert_close(ll_g, ll_c, rtol=1e-5, atol=0)
    assert bool(torch.isfinite(g_g).all())
    scale = g_c.abs().amax(dim=0)
    assert bool(((g_g - g_c).abs() <= 1e-2 * scale).all()), (g_g, g_c)


@pytest.mark.parametrize("jac_mode,solver", [("cd", "auto"), ("ad", "auto"),
                                             ("full", "cr"),
                                             ("full", "babe")])
def test_steady_options_run_on_the_card(cuda, jac_mode, solver):
    """The tangent-built Jacobians and the cr/babe solvers on the card:
    flows within 1e-3 sccm of the default (full, the kernels) at the same
    draws, and a finite adjoint gradient."""
    import dataclasses
    card, _ = _steady_pair(cuda)
    other = dataclasses.replace(card, jac_mode=jac_mode, solver=solver)
    th = torch.tensor(_STEADY_THETA, device=cuda)
    _, want = card.log_likelihood(th)
    t = th.clone().requires_grad_(True)
    ll, got = other.log_likelihood(t)
    (g,) = torch.autograd.grad(ll.sum(), t)
    assert bool((want != -10000.0).all())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)
    assert bool(torch.isfinite(g).all())



# -- the operations layer and the CLI on the card ---------------------------

_N_CLI = 100_000


def _same_run(got, want):
    for f in _STATE_FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert torch.equal(got.key.generator.get_state(),
                       want.key.generator.get_state())


@pytest.fixture(scope="module")
def mm_main_run():
    """The MM main path (pallas_exact, N = 1e5, seed 0) through run_smc:
    what the CLI's runs on the card are held to."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    from smc_tpu_torch import run_smc
    m = MichaelisMentenModel.default(method="pallas_exact", device="cuda")
    cfg = SMCConfig(n_particles=_N_CLI)
    return m, cfg, run_smc(m, cfg, 0, verbose=False)


def _only_dir(path):
    import os
    (name,) = os.listdir(path)
    return os.path.join(path, name)


def _checkpoint(run, name):
    import glob
    import os
    (path,) = glob.glob(os.path.join(run, "checkpoints", name + ".*"))
    return path


@pytest.mark.parametrize("fmt", ["npz", "auto", "smcd"])
def test_cli_run_and_resume_are_the_library_run_on_the_card(
        cuda, tmp_path, mm_main_run, fmt):
    """``smc-tpu-torch run`` on the main path (pallas_exact, N = 1e5) ends
    bit-equal to run_smc with the same seed, and a resume from its step-3
    checkpoint in each format ('auto' = the native .smck) does too. The
    resume parser takes only rk4/exact (as the reference's), so the
    pallas_exact run resumes through run_with_artifacts, the body of the
    resume command."""
    from smc_tpu_torch.cli import main
    from smc_tpu_torch.io.checkpoint import load_state
    from smc_tpu_torch.io.rundir import RunDir
    from smc_tpu_torch.runner import run_with_artifacts
    model, cfg, want = mm_main_run
    assert main(["run", "--model", "mm", "--mm-method", "pallas_exact",
                 "--particles", str(_N_CLI), "--checkpoint-format", fmt,
                 "--outdir", str(tmp_path / "a"), "--quiet",
                 "--no-plots"]) == 0
    run = _only_dir(tmp_path / "a")
    _same_run(load_state(_checkpoint(run, "final"), device=cuda), want)
    ck = _checkpoint(run, "step3")
    assert ck.endswith({"npz": ".npz", "auto": ".smck", "smcd": ".smcd"}[fmt])
    final, rd = run_with_artifacts(
        model, cfg, None, rundir=RunDir(root=str(tmp_path / "b"),
                                        tag="mm_resume"),
        resume_from=ck, plots_enabled=False, verbose=False,
        checkpoint_format=fmt)
    _same_run(final, want)
    _same_run(load_state(_checkpoint(rd.path, "final"), device=cuda), want)


def test_cli_resume_command_on_the_card(cuda, tmp_path):
    """The resume command itself on the card (MM exact, N = 20,000): the
    resumed run's final checkpoint is the uninterrupted run's."""
    from smc_tpu_torch import run_smc
    from smc_tpu_torch.cli import main
    from smc_tpu_torch.io.checkpoint import load_state
    args = ["--model", "mm", "--mm-method", "exact", "--particles", "20000",
            "--quiet", "--no-plots"]
    assert main(["run", "--outdir", str(tmp_path / "a")] + args) == 0
    ck = _checkpoint(_only_dir(tmp_path / "a"), "step2")
    assert main(["resume", "--checkpoint", ck, "--outdir",
                 str(tmp_path / "b")] + args) == 0
    want = run_smc(MichaelisMentenModel.default(method="exact", device=cuda),
                   SMCConfig(n_particles=20_000), 0, verbose=False)
    got = load_state(_checkpoint(_only_dir(tmp_path / "b"), "final"),
                     device=cuda)
    _same_run(got, want)


def test_run_resilient_recovers_inside_a_graphed_run(cuda, tmp_path,
                                                     mm_main_run):
    """A failure injected after step 2 of a graphed run: run_resilient
    reloads the step-2 checkpoint onto the card, captures its graphs anew
    and ends bit-equal to the uninterrupted run."""
    from smc_tpu_torch.utils.resilient import run_resilient
    model, cfg, want = mm_main_run
    armed = [True]

    def boom(s):
        if armed[0] and int(s.step) == 2:
            armed[0] = False
            raise RuntimeError("injected")

    got = run_resilient(model, cfg, 0, checkpoint=str(tmp_path / "ck.npz"),
                        callback=boom, retry_delay_s=0.0, verbose=False)
    assert not armed[0]
    _same_run(got, want)


def test_cli_profile_writes_a_trace_naming_the_main_kernels(cuda, tmp_path):
    import glob
    import json
    from smc_tpu_torch.cli import main
    assert main(["run", "--model", "mm", "--mm-method", "pallas_exact",
                 "--particles", "20000", "--profile", str(tmp_path / "p"),
                 "--outdir", str(tmp_path / "o"), "--quiet",
                 "--no-plots"]) == 0
    (path,) = glob.glob(str(tmp_path / "p" / "trace_*.json"))
    with open(path) as f:
        names = " ".join(str(e.get("name")) for e in
                         json.load(f)["traceEvents"])
    for kernel in ("mm_exact_kernel", "ladder_kernel", "merge_kernel"):
        assert kernel in names, kernel


def test_device_memory_report_on_the_card(cuda):
    from smc_tpu_torch.utils.memory import device_memory_report, \
        hbm_utilization
    x = torch.empty(2 ** 28, dtype=torch.uint8, device=cuda)
    rep = device_memory_report()
    assert len(rep) == torch.cuda.device_count() >= 1
    assert rep[0]["bytes_in_use"] >= x.numel()
    assert rep[0]["bytes_limit"] > rep[0]["bytes_free"] > 0
    u = hbm_utilization()
    assert u is not None and 0.0 < u <= 1.0
    del x


def test_initialize_distributed_nccl_world_size_one(cuda):
    import socket
    import torch.distributed as dist
    from smc_tpu_torch.parallel.multihost import (initialize_distributed,
                                                  is_primary_host)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    try:
        assert initialize_distributed(f"tcp://127.0.0.1:{port}", 1, 0,
                                      device=cuda) == 1
        assert dist.get_backend() == "nccl"
        group = dist.group.WORLD
        assert initialize_distributed(device=cuda) == 1
        assert dist.group.WORLD is group and is_primary_host()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_nccl_collectives_captured_in_a_cuda_graph(cuda):
    """A mesh of one NCCL rank: after one eager collective per group
    (``warm_up``), all-reduces and an all-gather record into a CUDA graph
    and replay on new inputs; each replay counts its collectives."""
    import socket
    import torch.distributed as dist
    from smc_tpu_torch.parallel.mesh import make_mesh, particle_sharding
    from smc_tpu_torch.parallel.multihost import initialize_distributed
    from smc_tpu_torch.smc import graphs
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    try:
        initialize_distributed(f"tcp://127.0.0.1:{port}", 1, 0, device=cuda)
        psh = particle_sharding(make_mesh())
        assert psh.capturable and psh.particles.size == 1
        psh.warm_up(cuda)
        x = torch.arange(6, dtype=torch.float32, device=cuda)

        def body():
            y = psh.particles.sum(x * 2)
            m = psh.particles.max(torch.amax(y))
            return torch.cat([psh.particles.gather(y)[0] + m,
                              psh.world.any(torch.any(y > 100)).float()[None]])
        graphs.warm_up(body, cuda)
        graph, launches, out = graphs.capture(body)
        assert launches[("collective", "all_reduce_sum")] == 1
        _build.reset_launch_counts()
        x.add_(1)
        graphs.replay(graph, launches)
        torch.cuda.synchronize()
        assert out.tolist() == [14.0, 16.0, 18.0, 20.0, 22.0, 24.0, 0.0]
        assert _build.collective_counts["all_gather"] == 1
        assert _build.collective_counts["all_reduce_max"] == 2
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_cli_mesh_one_under_torchrun_is_the_library_run(cuda, tmp_path,
                                                        mm_main_run):
    """``torchrun --nproc-per-node 1 -m smc_tpu_torch.cli run --mesh 1`` on
    the main path (pallas_exact, N = 1e5): the sharded run's posterior is
    run_smc's, bit for bit (the collectives of one NCCL rank inside the
    step's graphs)."""
    import glob
    import os
    import subprocess
    import sys
    import numpy as np
    _, _, want = mm_main_run
    env = dict(os.environ)
    for v in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(v, None)
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "1", "--standalone", "-m", "smc_tpu_torch.cli", "run",
         "--model", "mm", "--mm-method", "pallas_exact", "--particles",
         str(_N_CLI), "--mesh", "1", "--outdir", str(tmp_path), "--quiet"],
        capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "gamma: 1.0" in out.stdout
    (path,) = glob.glob(str(tmp_path / "*" / "Posterior_Distribution.csv"))
    got = np.loadtxt(path, delimiter=",", skiprows=1)
    np.testing.assert_array_equal(got, want.particles.double().cpu().numpy())

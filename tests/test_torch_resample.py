"""The port's resampling against the JAX package on the CPU, bitwise: the
plain version of the CUDA ancestor-merge kernel against the Pallas merge in
interpret mode, residual-systematic counts and offsets with the same
systematic offset v0, the resampled particles against ``take``, and the
other schemes (systematic, stratified, multinomial) with the same
uniforms."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smc_tpu.ops.resample_pallas import (_T, _W,
                                         sorted_offsets_to_ancestors as j_merge)
from smc_tpu.smc import kernels as jk
from smc_tpu_torch.ops.resample_cuda import (
    sorted_offsets_to_ancestors, sorted_offsets_to_ancestors_plain)
from smc_tpu_torch.smc import kernels as tk
import tests.torch_parity  # noqa: F401  (one PyTorch thread)


def _offsets(counts):
    counts = np.asarray(counts, np.int64)
    return (np.cumsum(counts) - counts).astype(np.int32)


def _assert_merge_equal(offsets):
    want = np.asarray(j_merge(jnp.asarray(offsets), interpret=True))
    got = sorted_offsets_to_ancestors(torch.from_numpy(offsets))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # and the scatter construction itself
    n = len(offsets)
    hist = np.bincount(offsets, minlength=n + 1)[:n]
    np.testing.assert_array_equal(got.numpy(), np.cumsum(hist) - 1)


@pytest.mark.parametrize("n", [257, _W, 5000, 3 * _T + 17])
def test_plain_merge_matches_pallas_on_random_counts(n):
    rng = np.random.default_rng(n)
    raw = rng.integers(0, 4, n) * (rng.random(n) < 0.4)
    raw[0] += n - raw.sum()
    assert raw.sum() == n and (raw >= 0).all()
    _assert_merge_equal(_offsets(raw))


_WIDE_CASES = ("zero_run_inside_a_tile", "ties_across_1024",
               "ties_across_2048", "ties_across_4096",
               "zero_run_longer_than_any_window")


@pytest.mark.parametrize("case", ["first_takes_all", "last_takes_all",
                                  "all_ones", "middle_block",
                                  "two_survivors_far_apart",
                                  "alternating_zero", *_WIDE_CASES])
def test_plain_merge_degenerate_patterns(case):
    """The cases that cut the CUDA merge's pieces at awkward places too: a
    zero-count run inside one 1024-slot tile; a run of ties whose indices
    and whose survivor's slots straddle 1024, 2048 and 4096 (the kernel
    gives each block 2048 positions of the offsets merged with the slots);
    two survivors with adjacent slots, 3000 zero-count particles apart,
    more than a block's 2048 positions."""
    n = 2 * _T + 100 if case not in _WIDE_CASES else 5 * _T + 100
    counts = np.zeros(n, np.int64)
    if case in _WIDE_CASES:
        counts[:] = 1
        if case == "zero_run_inside_a_tile":
            lo, hi = 1100, 1700
        elif case.startswith("ties_across_"):
            edge = int(case.rsplit("_", 1)[1])
            lo, hi = edge - 5, edge + 5
        else:
            lo, hi = 11, 3011
        counts[lo:hi] = 0
        counts[hi] += hi - lo
    elif case == "first_takes_all":
        counts[0] = n
    elif case == "last_takes_all":
        counts[-1] = n
    elif case == "all_ones":
        counts[:] = 1
    elif case == "middle_block":
        counts[n // 2] = n
    elif case == "two_survivors_far_apart":
        counts[3] = n // 2
        counts[-3] = n - n // 2
    else:
        counts[::2] = 2
    assert counts.sum() == n
    _assert_merge_equal(_offsets(counts))


def _weights(n, seed, kind):
    rng = np.random.default_rng(seed)
    w = rng.gamma(0.2, size=n).astype(np.float32)
    if kind == "dominant":
        w[7] = 1e6
    elif kind == "half_zero":
        w[: n // 2] = 0.0
    elif kind == "flat":
        w[:] = 1.0
    return (w / w.sum()).astype(np.float32)


@pytest.mark.parametrize("n,kind", [(16, "gamma"), (1000, "gamma"),
                                    (1024, "dominant"), (1024, "half_zero"),
                                    (4096 + 333, "flat"),
                                    (200_003, "gamma")])
def test_counts_and_offsets_bitwise(n, kind):
    """The int64 prefix sum against the JAX package's chunked int32 one,
    with v0 drawn from the same key (n = 200,003 makes JAX split q into two
    chunks)."""
    w = _weights(n, n, kind)
    for seed in range(3):
        key = jax.random.key(seed)
        jc, jo = jk._rs_counts_offsets(key, jnp.asarray(w))
        v0 = torch.tensor(np.asarray(jax.random.uniform(key, ())))
        tc, to = tk._rs_counts_offsets(v0, torch.from_numpy(w))
        assert tc.dtype == to.dtype == torch.int32
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        assert int(tc.sum()) == n and int(tc.min()) >= 0


def test_apply_is_bitwise_take():
    """residual_systematic_apply against jnp.take with the JAX ancestors,
    -inf log-liks and adversarial weights included."""
    for seed, kind in enumerate(["gamma", "dominant", "half_zero"]):
        n = 1024
        w = _weights(n, 40 + seed, kind)
        rng = np.random.default_rng(seed)
        parts = rng.normal(size=(n, 3)).astype(np.float32)
        lk = (rng.normal(size=n) * 100).astype(np.float32)
        lk[3] = -np.inf
        key = jax.random.key(seed)
        anc = jk.residual_systematic_resample(key, jnp.asarray(w))
        v0 = torch.tensor(np.asarray(jax.random.uniform(key, ())))
        tp, tl = tk.residual_systematic_apply(
            v0, torch.from_numpy(w), torch.from_numpy(parts),
            torch.from_numpy(lk))
        np.testing.assert_array_equal(
            tp.numpy(), np.asarray(jnp.take(jnp.asarray(parts), anc, 0)))
        np.testing.assert_array_equal(
            tl.numpy(), np.asarray(jnp.take(jnp.asarray(lk), anc, 0)))
        np.testing.assert_array_equal(
            tk.residual_systematic_ancestors(v0, torch.from_numpy(w)).numpy(),
            np.asarray(anc))


@pytest.mark.parametrize("kind", ["gamma", "dominant", "half_zero"])
def test_apply_bitwise_at_n_1000_below_the_reference_merge_threshold(kind):
    """N = 1000, the methanation run's particle count: below 4096 the JAX
    package takes its scatter-and-cumsum form and never its merge kernel,
    while the port takes its merge (plain on the CPU) at every N. Same v0
    and weights: the resampled particles and log-likelihoods must be the
    same bits as ``jk.residual_systematic_apply`` gives."""
    n = 1000
    w = _weights(n, 77, kind)
    rng = np.random.default_rng(5)
    parts = rng.normal(size=(n, 5)).astype(np.float32)
    lk = (rng.normal(size=n) * 100).astype(np.float32)
    lk[11] = -np.inf
    for seed in range(3):
        key = jax.random.key(seed)
        jp, jl = jk.residual_systematic_apply(
            key, jnp.asarray(w), (jnp.asarray(parts), jnp.asarray(lk)))
        v0 = torch.tensor(np.asarray(jax.random.uniform(key, ())))
        tp, tl = tk.residual_systematic_apply(
            v0, torch.from_numpy(w), torch.from_numpy(parts),
            torch.from_numpy(lk))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_counts_to_ancestors_matches_jax():
    counts = np.array([0, 3, 1, 0, 2, 0], np.int32)
    np.testing.assert_array_equal(
        tk.counts_to_ancestors(torch.from_numpy(counts)).numpy(),
        [1, 1, 1, 2, 4, 4])
    rng = np.random.default_rng(2)
    c = rng.multinomial(500, np.ones(500) / 500).astype(np.int32)
    np.testing.assert_array_equal(
        tk.counts_to_ancestors(torch.from_numpy(c)).numpy(),
        np.asarray(jk.counts_to_ancestors(jnp.asarray(c))))
    assert torch.equal(
        sorted_offsets_to_ancestors_plain(torch.from_numpy(_offsets(c))),
        tk.counts_to_ancestors(torch.from_numpy(c)))


# ---- the other resampling schemes -----------------------------------------
_SCHEMES = ("systematic", "stratified", "multinomial")


def _exact_sum_weights(n, seed, kind):
    """Weights m_i / 2^20 with integer m_i summing to 2^20: every prefix sum
    is a float32 number, so it comes out the same however the adds are
    associated and in whatever precision (the JAX package adds the weights
    in an fp32 scan, the port in float64, rounded once)."""
    rng = np.random.default_rng(seed)
    if kind == "flat":
        m = np.full(n, (1 << 20) // n)
        m[0] += (1 << 20) - m.sum()
    else:
        p = rng.gamma(0.2, size=n)
        if kind == "dominant":
            p[7] = 1e3 * p.sum()
        elif kind == "half_zero":
            p[: n // 2] = 0.0
        m = rng.multinomial(1 << 20, p / p.sum())
    w = (m / float(1 << 20)).astype(np.float32)
    assert w.sum(dtype=np.float64) == 1.0
    return w


def _scheme_uniforms(key, scheme, n):
    """The uniforms the JAX scheme draws from ``key``, as the port takes
    them."""
    shape = () if scheme == "systematic" else (n,)
    return np.array(jax.random.uniform(key, shape))


@pytest.mark.parametrize("kind", ["gamma", "dominant", "half_zero", "flat"])
@pytest.mark.parametrize("scheme", _SCHEMES)
def test_scheme_counts_and_ancestors_bitwise(scheme, kind):
    """Counts, ancestors (the merge's plain version) and the resampled
    particles against the JAX functions with the same uniforms, bitwise, on
    weights whose prefix sums are exact."""
    for n in (16, 1000, 4429):
        w = _exact_sum_weights(n, n, kind)
        tw = torch.from_numpy(w)
        for seed in range(2):
            key = jax.random.key(seed)
            u = torch.from_numpy(_scheme_uniforms(key, scheme, n))
            jc = np.asarray(getattr(jk, f"{scheme}_counts")(key,
                                                           jnp.asarray(w)))
            tc = tk.resample_counts(u, tw, scheme)
            assert tc.dtype == torch.int32
            np.testing.assert_array_equal(tc.numpy(), jc)
            assert int(tc.sum()) == n and int(tc.min()) >= 0
            ja = np.asarray(jk.residual_systematic_resample(
                key, jnp.asarray(w), scheme=scheme))
            np.testing.assert_array_equal(
                tk.residual_systematic_resample(u, tw, scheme).numpy(), ja)
            np.testing.assert_array_equal(
                tk.counts_to_ancestors(tc).numpy(),
                np.asarray(jk.counts_to_ancestors(jnp.asarray(jc))))
            parts = np.random.default_rng(seed).normal(
                size=(n, 3)).astype(np.float32)
            lk = parts[:, 0] * 10.0
            tp, tl = tk.resample_apply(u, tw, torch.from_numpy(parts),
                                       torch.from_numpy(lk), scheme)
            np.testing.assert_array_equal(tp.numpy(), parts[ja])
            np.testing.assert_array_equal(tl.numpy(), lk[ja])


@pytest.mark.parametrize("scheme", _SCHEMES)
def test_scheme_counts_near_jax_on_general_weights(scheme):
    """On weights whose prefix sums the two packages round differently (an
    fp32 scan in the JAX package, a float64 one rounded once in the port),
    a count moves only where a point falls within rounding of a prefix sum:
    by one slot, at under 1% of the particles (N = 4429). The port's
    counts always sum to N."""
    n = 4429
    rng = np.random.default_rng(3)
    w = rng.gamma(0.2, size=n).astype(np.float32)
    w = (w / w.sum()).astype(np.float32)
    for seed in range(5):
        key = jax.random.key(seed)
        u = torch.from_numpy(_scheme_uniforms(key, scheme, n))
        jc = np.asarray(getattr(jk, f"{scheme}_counts")(key, jnp.asarray(w)))
        tc = tk.resample_counts(u, torch.from_numpy(w), scheme).numpy()
        assert tc.sum() == n and tc.min() >= 0
        assert np.abs(tc - jc).max() <= 1
        assert (tc != jc).mean() < 0.01


@pytest.mark.parametrize("scheme", _SCHEMES)
def test_ensemble_scheme_counts_match_vmapped_jax(scheme):
    """(D, N) weights and uniforms: every row the vmapped JAX scheme's
    counts and ancestors."""
    d, n = 3, 1000
    w = np.stack([_exact_sum_weights(n, 10 + p, kind) for p, kind in
                  enumerate(["gamma", "dominant", "half_zero"])])
    keys = jax.random.split(jax.random.key(4), d)
    u = torch.from_numpy(np.stack([_scheme_uniforms(k, scheme, n)
                                   for k in keys]))
    jfn = getattr(jk, f"{scheme}_counts")
    jc = np.asarray(jax.vmap(jfn)(keys, jnp.asarray(w)))
    tc = tk.resample_counts(u, torch.from_numpy(w), scheme)
    assert tc.shape == (d, n)
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_array_equal(
        tk.residual_systematic_resample(u, torch.from_numpy(w),
                                        scheme).numpy(),
        np.asarray(jax.vmap(jk.counts_to_ancestors)(jnp.asarray(jc))))


def test_inverse_cdf_ties_agree_with_jax_searchsorted():
    """Zero weights make equal prefix sums, and points placed exactly on a
    prefix sum: the port's ``torch.searchsorted`` (left, ``right=False``)
    picks the same particle as ``jnp.searchsorted(side="left")``, so
    multinomial counts agree on ties too."""
    n = 64
    w = np.zeros(n, np.float32)
    w[[3, 4, 20, 21, 40, 63]] = [0.125, 0.125, 0.25, 0.125, 0.25, 0.125]
    ends = np.cumsum(w, dtype=np.float32)
    u = np.concatenate([ends[::2], np.float32([0.0, 0.125, 0.5, 1.0])])
    u = np.resize(u, n).astype(np.float32)
    j_idx = np.asarray(jnp.searchsorted(jnp.asarray(ends), jnp.asarray(u),
                                        side="left"))
    t_idx = torch.searchsorted(torch.from_numpy(ends), torch.from_numpy(u),
                               right=False).numpy()
    np.testing.assert_array_equal(t_idx, j_idx)
    want = np.bincount(np.minimum(j_idx, n - 1), minlength=n)
    np.testing.assert_array_equal(
        tk.multinomial_counts(torch.from_numpy(u), torch.from_numpy(w))
        .numpy(), want)


def test_resample_counts_rejects_unknown_scheme():
    with pytest.raises(ValueError, match="bogus"):
        tk.resample_counts(torch.zeros(()), torch.ones(8) / 8, "bogus")


@pytest.mark.parametrize("scheme", _SCHEMES)
def test_each_scheme_runs_to_gamma_one(scheme):
    """The driver dispatches on ``cfg.resampling``: a short Michaelis-Menten
    run on the CPU reaches gamma = 1 with the posterior near the truth."""
    from smc_tpu_torch import SMCConfig, make_full_run_on_device
    from smc_tpu_torch.models.michaelis_menten import MichaelisMentenModel
    m = MichaelisMentenModel.default(method="pallas_exact", device="cpu")
    s = make_full_run_on_device(
        m, SMCConfig(n_particles=512, resampling=scheme))(0)
    assert float(s.gamma) == 1.0
    mean = s.particles.mean(0).numpy()
    np.testing.assert_allclose(mean, [1.2, 0.5, 0.02], atol=0.05)

"""Each kernel's work count against a count by hand at a small shape."""
from portbench.harness import spec


def test_mm_loglik_counts_by_hand():
    w = spec.module("costs", "mm_loglik").work(
        "mm_loglik", dict(b=2, n=3, n_ds=2, n_obs=4))
    # 6 particles x (10 + 2 datasets x (6 + 3 later points x 33)).
    assert w["flops"] == 6 * (10 + 2 * (6 + 3 * 33))
    # theta in and ll out per particle; obs (2 x 4) and s0 (2) per
    # population, all float32.
    assert w["bytes"] == 4 * (6 * 4 + 2 * (8 + 2))


def test_thomas_counts_by_hand():
    cost = spec.module("costs", "thomas")
    nx, lanes = 3, 5
    f = cost.work("thomas_factor", dict(nx=nx, lanes=lanes))
    # Reads A[1:] (2), B (3), C[:-1] (2); writes LU (3), m (3): 13 blocks.
    assert f["bytes"] == 13 * 49 * 4 * lanes
    assert f["flops"] == ((196 + 147 + 343 + 112 + 13) * 2 + 118) * lanes
    a = cost.work("thomas_apply", dict(nx=nx, lanes=lanes))
    # Reads LU (3), m[1:] (2), C[:-1] (2) blocks, rhs (3 vectors); writes
    # x (3 vectors).
    assert a["bytes"] == (7 * 49 + 6 * 7) * 4 * lanes
    assert a["flops"] == (168 * 2 + 56 + 7 * 3) * lanes


def test_roofline_share_of_a_known_slice():
    """A slice whose kernel ran exactly as long as the least time reads
    100%, one that ran twice as long 50%."""
    from types import SimpleNamespace
    from portbench.harness import kernels
    shape = dict(nx=51, lanes=15360)
    w = spec.module("costs", "thomas").work("thomas_apply", shape)
    peaks = spec.peaks()
    least = max(w["flops"] / peaks["fp32_flops_per_s"],
                w["bytes"] / peaks["hbm_bytes_per_s"])
    for factor, want in ((1.0, 100.0), (2.0, 50.0)):
        run = SimpleNamespace(
            slice={"kernels": {"void thomas_apply_kernel<7>(float*)":
                               (3 * least * factor * 1e6, 3)}},
            shapes={"thomas_apply": shape}, peaks=peaks,
            cost=lambda m, k, s: spec.module("costs", m).work(k, s))
        got = kernels.roofline(run, "thomas", "thomas_apply",
                               "thomas_apply_kernel")
        assert abs(got - want) < 1e-9

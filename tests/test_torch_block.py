"""Block granularity (``run_smc(granularity="block")``,
``make_block_step_fns``) and the slab-wise initial sweep on the CPU,
mirroring tests/test_sweep_granularity.py's block tests: the port's block
runs against its sweep runs, every core execution's row count, the stop
file between slabs, and one JAX block run statistically.

The port draws once over full N and forms the covariance factors over full
N, and every core row depends on its own rows only, so block and sweep
give the same state bit for bit here (and on the card,
tests/test_torch_gpu.py). The JAX package compiles the likelihood per
slab shape and pins statistical parity instead."""
import jax
import numpy as np
import pytest
import torch

from smc_tpu import SMCConfig as JaxConfig
from smc_tpu.smc import driver as jd
from smc_tpu_torch import SMCConfig, StopRequested, init_state, run_smc
from smc_tpu_torch.models.michaelis_menten import MichaelisMentenModel
from smc_tpu_torch.smc import driver as td
from smc_tpu_torch.smc import graphs
from tests.test_torch_grad import _mm_pair
from tests.test_torch_smc import _check_posterior

FIELDS = ("particles", "log_lik", "gamma", "step", "ess", "max_log_lik",
          "n_mh", "accepted", "n_gamma_reductions", "mh_ratio",
          "total_lik_evals", "log_evidence")


def assert_same_state(a, b):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("kind,method", [("rwm", "pallas_exact"),
                                         ("mala", "exact")])
def test_block_equals_sweep_bitwise(kind, method):
    """N = 1024 in slabs of 256 against one execution per sweep, from the
    same seed: the same state bit for bit, with the same host reads."""
    m = MichaelisMentenModel.default(method=method, device="cpu")
    cfg = SMCConfig(n_particles=1024, mutation=kind)
    graphs.reset_stats()
    sweep = run_smc(m, cfg, 0, verbose=False, granularity="sweep")
    reads = graphs.stats["host_reads"]
    graphs.reset_stats()
    block = run_smc(m, cfg.replace(block_particles=256), 0, verbose=False,
                    granularity="block")
    assert float(block.gamma) == 1.0
    assert_same_state(block, sweep)
    assert graphs.stats["host_reads"] == reads


@pytest.mark.parametrize("method,n,b,bitwise", [
    ("pallas_exact", 1000, 200, True), ("exact", 1024, 256, True),
    ("exact", 1000, 200, False)])
def test_init_state_in_slabs_equals_the_unsplit_sweep(method, n, b,
                                                      bitwise):
    """The initial sweep in slabs of ``b`` rows gives the unsplit sweep's
    state, bit for bit, except where one op changes its bits with the row
    count: on the CPU, ``torch.sum`` over the time axis of the ``exact``
    likelihood's (T, n_ds, N) squared residuals (``_gaussian_ll``) runs
    vectorized across rows and takes a slab's last rows through its
    remainder path, which adds in another order when the row count is not
    a multiple of the vector width (13 of 1000 rows at slabs of 200). Those
    rows agree to 1e-6; the kernel's plain version (``pallas_exact``) sums
    in a loop and keeps its bits at any slab."""
    m = MichaelisMentenModel.default(method=method, device="cpu")
    cfg = SMCConfig(n_particles=n)
    whole = init_state(3, m, cfg)
    slabs = init_state(3, m, cfg.replace(block_particles=b))
    if bitwise:
        assert_same_state(whole, slabs)
        return
    np.testing.assert_allclose(slabs.log_lik.numpy(), whole.log_lik.numpy(),
                               rtol=1e-6)
    assert_same_state(whole, slabs.replace(log_lik=whole.log_lik,
                                           max_log_lik=whole.max_log_lik))


@pytest.mark.parametrize("kind", ["rwm", "mala"])
def test_block_bounds_every_execution(kind, monkeypatch):
    """Every core call covers exactly block_particles rows, and so does
    every initial-gradient call of a gradient kind: counted at the piece
    boundaries (tests/test_sweep_granularity.py::
    test_block_bounds_every_execution)."""
    calls = {"core": 0, "draw": 0, "grad": 0, "prep": 0}
    orig = td.make_block_step_fns

    def counting(model_, cfg_):
        prep, mut_init, draw, core, admin, grad, finish = orig(model_, cfg_)

        def prep2(s):
            calls["prep"] += 1
            return prep(s)

        def draw2(s, c):
            calls["draw"] += 1
            return draw(s, c)

        def core2(*a):
            out = core(*a)
            assert out[0].shape[0] == out[1].shape[0] == 64
            calls["core"] += 1
            return out

        def grad2(*a):
            out = grad(*a)
            assert out.shape == (64, 3)
            calls["grad"] += 1
            return out

        return (prep2, mut_init, draw2, core2, admin,
                None if grad is None else grad2, finish)

    monkeypatch.setattr(td, "make_block_step_fns", counting)
    m = MichaelisMentenModel.default(method="exact", device="cpu")
    cfg = SMCConfig(n_particles=256, block_particles=64, mutation=kind)
    s = run_smc(m, cfg, 2, verbose=False, granularity="block")
    assert float(s.gamma) == 1.0
    assert calls["prep"] == int(s.step)
    assert calls["core"] == 4 * calls["draw"]
    assert calls["draw"] == (float(s.total_lik_evals) - 256) / 256
    assert calls["grad"] == (4 * int(s.step) if kind == "mala" else 0)


def test_stop_file_between_slabs(tmp_path):
    """The stop file is polled before every slab's core: it appears during
    the first slab of step 2's first sweep, StopRequested is raised before
    the second slab, and run_smc returns the state after step 1."""
    import dataclasses
    stop = tmp_path / "STOP"
    base = MichaelisMentenModel.default(method="pallas_exact", device="cpu")

    @dataclasses.dataclass(frozen=True)
    class Touching:
        """The model, creating the stop file at its ``at``-th call."""
        at: int
        calls: list = dataclasses.field(default_factory=lambda: [0])

        @property
        def prior(self):
            return base.prior

        def log_likelihood(self, theta):
            self.calls[0] += 1
            if self.calls[0] == self.at:
                stop.write_text("stop")
            return base.log_likelihood(theta)

    cfg = SMCConfig(n_particles=512, block_particles=128)
    # Calls: 4 for the initial sweep (slabs), then 4 per sweep.
    m = Touching(at=5)
    s = init_state(1, m, cfg)
    fns = td.make_block_step_fns(m, cfg)
    with pytest.raises(StopRequested):
        td._run_step_by_blocks(s, cfg, fns, str(stop))
    assert m.calls[0] == 5
    stop.unlink()

    ref = run_smc(base, cfg.replace(max_steps=1), 1, verbose=False,
                  granularity="block")
    sweeps_1 = round(float(ref.total_lik_evals) / 512) - 1
    m = Touching(at=4 + 4 * sweeps_1 + 1)
    got = run_smc(m, cfg, 1, verbose=False, granularity="block",
                  stop_file=str(stop))
    assert stop.exists() and int(got.step) == 1
    assert_same_state(got, ref)


def test_block_matches_jax_block_run_statistically():
    """N = 1024 in slabs of 256 in both packages (MM exact, RWM; different
    random streams): both reach gamma = 1 and bracket the truth, and their
    means agree within half a posterior sd, as tests/test_torch_smc.py
    holds whole runs."""
    jm, tm = _mm_pair("exact")
    js = jd.run_smc(jm, JaxConfig(n_particles=1024, block_particles=256),
                    jax.random.key(0), verbose=False, granularity="block")
    ts = run_smc(tm, SMCConfig(n_particles=1024, block_particles=256), 0,
                 verbose=False, granularity="block")
    assert float(js.gamma) == float(ts.gamma) == 1.0
    jp, tp = np.asarray(js.particles), ts.particles.double().numpy()
    _check_posterior(jp)
    _check_posterior(tp)
    assert (np.abs(jp.mean(0) - tp.mean(0)) < 0.5 * jp.std(0)).all()
    assert abs(int(js.step) - int(ts.step)) <= 3

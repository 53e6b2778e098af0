"""The step's pieces and the run entry points built on them (the port's
``make_sweep_step_fns``, ``make_smc_step``, ``make_run_on_device``,
``run_smc(granularity="sweep")`` and ``StopRequested``), mirroring
tests/test_sweep_granularity.py on the CPU, where the pieces run eagerly
(on the card they are captured CUDA graphs; tests/test_torch_gpu.py holds
those against the eager composition). One step through each entry point
is held against the JAX package's on the same state, with the JAX draws
replayed.

Both granularities run the same pieces, so unlike the JAX package's
sweep-against-fused test the states are bit-equal (for MALA and HMC too,
tests/test_torch_mala_hmc.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smc_tpu import SMCConfig as JaxConfig
from smc_tpu.models.michaelis_menten import (MichaelisMentenModel as JaxMM,
                                             generate_mm_pseudo_data as jgen)
from smc_tpu.priors import Prior as JaxPrior
from smc_tpu.smc import driver as jd
from smc_tpu_torch import (SMCConfig, StopRequested, TorchDraws, convert,
                           init_state, make_full_run_on_device,
                           make_run_on_device, make_smc_step,
                           make_sweep_step_fns, run_smc, run_smc_on_device,
                           smc_step)
from smc_tpu_torch.models.michaelis_menten import MichaelisMentenModel
from smc_tpu_torch.smc import graphs
from smc_tpu_torch.smc.driver import run_step, step_pieces
from tests.torch_parity import ReplayDraws, jax_state_to_numpy, step_draws

N = 1024
FIELDS = ("particles", "log_lik", "gamma", "step", "ess", "max_log_lik",
          "n_mh", "accepted", "n_gamma_reductions", "mh_ratio",
          "total_lik_evals", "log_evidence")


@pytest.fixture(scope="module")
def model():
    return MichaelisMentenModel.default(method="pallas_exact", device="cpu")


def assert_same_state(a, b):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def eager_run(model, cfg, key):
    """The eager composition: init_state, then smc_step until gamma = 1."""
    s = init_state(key, model, cfg)
    while bool(((s.step < cfg.max_steps) & (s.gamma < 1.0)).item()):
        s = smc_step(s, model.log_likelihood, model.prior, cfg)
    return s


def test_rwm_sweep_bitwise_matches_step(model):
    cfg = SMCConfig(n_particles=N)
    s_step = run_smc(model, cfg, 0, verbose=False, granularity="step")
    s_sweep = run_smc(model, cfg, 0, verbose=False, granularity="sweep")
    assert float(s_step.gamma) == 1.0
    assert_same_state(s_step, s_sweep)


def test_full_run_is_the_eager_composition(model):
    """make_full_run_on_device (the graphed run on the card) against
    init_state and smc_step, from the same seed."""
    cfg = SMCConfig(n_particles=N)
    assert_same_state(make_full_run_on_device(model, cfg)(3),
                      eager_run(model, cfg, 3))


def test_run_on_device_from_a_state_equals_run_smc_on_device(model):
    cfg = SMCConfig(n_particles=N)
    run = make_run_on_device(model, cfg)
    got = run(init_state(4, model, cfg))
    want = run_smc_on_device(model, cfg, 4)
    assert float(got.gamma) == 1.0
    assert_same_state(got, want)
    # The same function again, from a later state of another seed.
    mid = smc_step(init_state(5, model, cfg), model.log_likelihood,
                   model.prior, cfg)
    assert_same_state(run(mid), run_smc_on_device(
        model, cfg, None, state=smc_step(init_state(5, model, cfg),
                                         model.log_likelihood, model.prior,
                                         cfg)))


def test_smc_step_fn_and_sweep_pieces_compose_to_smc_step(model):
    """make_smc_step's step and a hand-written loop over
    make_sweep_step_fns's four pieces both give smc_step's state."""
    cfg = SMCConfig(n_particles=N)
    s0 = [init_state(6, model, cfg) for _ in range(3)]
    want = smc_step(s0[0], model.log_likelihood, model.prior, cfg)
    assert_same_state(make_smc_step(model, cfg)(s0[1]), want)
    prep, mut_init, mut_sweep, finish = make_sweep_step_fns(model, cfg)
    s = s0[2]
    p = prep(s)
    c, more = mut_init(s, p)
    sweeps = 1
    while bool(more):
        c, more = mut_sweep(s, p, c)
        sweeps += 1
    got, running = finish(s, p, c)
    assert_same_state(got, want)
    assert int(got.n_mh) == sweeps
    assert bool(running) == (float(got.gamma) < 1.0)


@pytest.fixture(scope="module")
def jax_step():
    """A JAX state after three steps (N = 256, the exact MM likelihood),
    the port's model of the same data, and the configs: ``max_steps`` = 4,
    so a run from the state is one step."""
    n = 256
    ts, obs, s0 = jgen()
    jm = JaxMM(obs=jnp.asarray(obs), s0=jnp.asarray(s0), ts=jnp.asarray(ts),
               prior=JaxPrior.uniform([0.0] * 3, [10.0] * 3), method="exact")
    tm = convert.mm_model_from_numpy(
        obs, s0, ts, dict(kind=[0, 0, 0], low=[0.0] * 3, high=[10.0] * 3,
                          loc=[5.0] * 3, scale=[10.0] * 3),
        method="exact", device="cpu")
    jcfg = JaxConfig(n_particles=n, max_steps=4)
    tcfg = SMCConfig(n_particles=n, max_steps=4)
    step = jd.make_smc_step(jm, jcfg, donate=False)
    s = jd.init_state(jax.random.key(3), jm, jcfg)
    for _ in range(3):
        s = step(s)
    return jm, tm, jcfg, tcfg, s, step(s)


def _port_step(way, tm, tcfg, state):
    if way == "make_smc_step":
        return make_smc_step(tm, tcfg)(state)
    if way == "make_run_on_device":
        return make_run_on_device(tm, tcfg)(state)
    prep, mut_init, mut_sweep, finish = make_sweep_step_fns(tm, tcfg)
    p = prep(state)
    c, more = mut_init(state, p)
    while bool(more):
        c, more = mut_sweep(state, p, c)
    return finish(state, p, c)[0]


def _jax_step(way, jm, jcfg, s, fused):
    """The JAX package's entry point of the same name on ``s``."""
    if way == "make_smc_step":
        return fused
    if way == "make_run_on_device":
        return jd.make_run_on_device(jm, jcfg)(s)
    return jd._run_step_by_sweeps(s, jcfg, jd.make_sweep_step_fns(jm, jcfg))


@pytest.mark.parametrize("way", ["make_smc_step", "make_sweep_step_fns",
                                 "make_run_on_device"])
def test_step_entry_points_match_the_jax_package(jax_step, way):
    """One step from the same state through the port's entry point and the
    JAX package's of the same name, JAX's v0, z and u replayed: the same
    gamma, step, gamma reductions and sweep count, accepted within 2, and
    particles within 1e-5, as tests/test_torch_smc.py holds smc_step."""
    jm, tm, jcfg, tcfg, s, fused = jax_step
    n, d = tcfg.n_particles, 3
    want = _jax_step(way, jm, jcfg, s, fused)
    ts = convert.state_from_numpy(jax_state_to_numpy(s), device="cpu",
                                  draws=ReplayDraws(step_draws(s.key, n, d)))
    out = _port_step(way, tm, tcfg, ts)
    assert 0.0 < float(out.gamma) < 1.0
    np.testing.assert_allclose(float(out.gamma), float(want.gamma),
                               rtol=1e-6)
    assert int(out.step) == int(want.step) == 4
    assert int(out.n_gamma_reductions) == int(want.n_gamma_reductions)
    assert int(out.n_mh) == int(want.n_mh)
    assert abs(int(out.accepted) - int(want.accepted)) <= 2
    np.testing.assert_allclose(out.particles.numpy(),
                               np.asarray(want.particles), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(out.log_evidence),
                               float(want.log_evidence), rtol=1e-5)
    assert float(out.total_lik_evals) == float(want.total_lik_evals)


def test_host_reads_one_per_step_and_one_per_sweep(model):
    """A run reads one flag before every step (and one more at the end) and
    one after every sweep: steps + sweeps + 1 in all."""
    cfg = SMCConfig(n_particles=N)
    run = make_full_run_on_device(model, cfg)
    graphs.reset_stats()
    s = run(7)
    sweeps = round(float(s.total_lik_evals) / N) - 1
    assert graphs.stats["host_reads"] == int(s.step) + sweeps + 1


def test_returned_state_is_not_changed_by_a_later_run(model):
    cfg = SMCConfig(n_particles=N)
    run = make_full_run_on_device(model, cfg)
    first = run(8)
    kept = first.particles.clone()
    run(9)
    assert torch.equal(first.particles, kept)


def test_stop_requested_between_sweeps(model, tmp_path):
    """The stop file is polled between the sweeps of a step: it appears
    during a step's first sweep, StopRequested is raised before the
    second, and run_smc(granularity="sweep") returns the last completed
    step's state (the state before that step)."""
    stop = tmp_path / "STOP"

    @dataclasses.dataclass(frozen=True)
    class Touching:
        """The model, creating the stop file at its ``at``-th likelihood
        call."""
        base: object
        at: int
        calls: list = dataclasses.field(default_factory=lambda: [0])

        @property
        def prior(self):
            return self.base.prior

        def log_likelihood(self, theta):
            self.calls[0] += 1
            if self.calls[0] == self.at:
                stop.write_text("stop")
            return self.base.log_likelihood(theta)

    cfg = SMCConfig(n_particles=N)
    # Calls: 1 = the initial sweep, 2 = the first sweep of step 1.
    m = Touching(model, at=2)
    s = init_state(10, m, cfg)
    with pytest.raises(StopRequested):
        run_step(step_pieces(m.log_likelihood, m.prior, cfg), s,
                 stop_file=str(stop))
    assert m.calls[0] == 2

    stop.unlink()
    m = Touching(model, at=4)          # during step 2's first sweep
    ref = smc_step(init_state(11, model, cfg), model.log_likelihood,
                   model.prior, cfg)
    got = run_smc(m, cfg, 11, verbose=False, granularity="sweep",
                  stop_file=str(stop))
    assert int(got.step) == 1 and stop.exists()
    assert_same_state(got, ref)
    # granularity="step" polls only before a step: that step completes.
    stop.unlink()
    m = Touching(model, at=4)
    got = run_smc(m, cfg, 11, verbose=False, granularity="step",
                  stop_file=str(stop))
    assert int(got.step) == 2


def test_unknown_and_unported_granularity(model):
    """An unknown granularity raises; "block" (no longer unported) runs and
    gives the sweep granularity's state (tests/test_torch_block.py holds
    it further)."""
    cfg = SMCConfig(n_particles=64)
    with pytest.raises(ValueError, match="granularity"):
        run_smc(model, cfg, 0, verbose=False, granularity="bogus")
    block = run_smc(model, cfg.replace(block_particles=16), 0, verbose=False,
                    granularity="block")
    assert float(block.gamma) == 1.0
    assert_same_state(block, run_smc(model, cfg, 0, verbose=False,
                                     granularity="sweep"))


def test_graphs_refuse_draws_they_cannot_replay():
    """On CUDA a run replays graphs that draw from a torch.Generator; a
    Draws of another kind raises instead of running eagerly. Checked here
    on the helper, without a card."""
    class Other:
        pass
    with pytest.raises(TypeError, match="TorchDraws"):
        graphs._generator(Other())
    assert graphs._generator(TorchDraws(0, "cpu")).device.type == "cpu"

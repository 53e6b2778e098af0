"""One SMC run over several processes (``smc_tpu_torch/parallel/``), the
counterpart of ``tests/test_sharding.py``: its ten cases on a gloo world of
four CPU ranks, against the port's one-process run and the JAX package's
sharded functions on the conftest's virtual 8-device mesh.

The world (tests/torch_mesh.py) is spawned once for the file and runs
every case; each test reads one case's outputs. The JAX side runs here, in
the test process.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smc_tpu import SMCConfig as JaxConfig
from smc_tpu.models.michaelis_menten import MichaelisMentenModel as JaxMM
from smc_tpu.models.michaelis_menten import generate_mm_pseudo_data as jgen
from smc_tpu.parallel import mesh as jmesh
from smc_tpu.priors import Prior as JaxPrior
from smc_tpu.smc import driver as jd
from smc_tpu.smc.kernels import residual_systematic_resample
from smc_tpu_torch import SMCConfig, convert, run_smc_on_device
from smc_tpu_torch.smc.driver import make_smc_step
from tests.torch_mesh import load, mm_model, run_world, sharding_cases
from tests.torch_parity import ReplayDraws, jax_state_to_numpy, step_draws

RANKS = 4
N = 512


def _resample_inputs():
    """The inputs of tests/test_sharding.py's sharded-resampler cases and
    what the JAX package gives for them: ``take(parts,
    residual_systematic_resample(key, w))``, the single-chip result that
    tests/test_sharding.py holds the JAX package's ``resample_sharded``
    and ``resample_sharded_ring`` to, bit for bit (each of those eager
    shard_map calls compiles for ~10 s on the virtual mesh)."""
    n, d = 1024, 3
    parts = jax.random.normal(jax.random.key(2), (n, d))
    lk = jax.random.normal(jax.random.key(3), (n,))
    w_plain = jax.nn.softmax(jax.random.normal(jax.random.key(1), (n,)) * 2.0)
    resample = jax.jit(residual_systematic_resample)

    def taken(key, w):
        anc = resample(key, w)
        return np.asarray(parts[anc]), np.asarray(lk[anc])
    want = {"resample_sharded": taken(jax.random.key(7), w_plain)}
    ins = dict(parts=np.asarray(parts), lk=np.asarray(lk),
               w_plain=np.asarray(w_plain),
               v0_plain=np.asarray(jax.random.uniform(jax.random.key(7), ())),
               v0_ring=np.asarray(jax.random.uniform(jax.random.key(11), ())))
    for conc in (2, 12):
        w = jax.nn.softmax(jax.random.normal(jax.random.key(4), (n,)) * conc)
        ins[f"w_{conc}"] = np.asarray(w)
        want[f"ring_{conc}"] = taken(jax.random.key(11), w)
    return ins, want


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    ts, obs, s0 = jgen()
    mm = dict(obs=obs, s0=s0, ts=ts)
    jm = JaxMM(obs=jnp.asarray(obs), s0=jnp.asarray(s0), ts=jnp.asarray(ts),
               prior=JaxPrior.uniform([0.0] * 3, [10.0] * 3), method="exact")
    jcfg = JaxConfig(n_particles=N)
    state0 = jd.init_state(jax.random.key(0), jm, jcfg)
    mesh = jmesh.make_mesh()
    jax_step = jd.make_smc_step(jm, jcfg, donate=False,
                                psharding=jmesh.particle_sharding(mesh))(
        jmesh.shard_state(state0, mesh))
    step_in = dict(arrays=jax_state_to_numpy(state0),
                   entries=step_draws(state0.key, N, 3))
    step_in["entries"] = [(k, np.asarray(a)) for k, a in step_in["entries"]]
    res_in, res_want = _resample_inputs()
    out = run_world(tmp_path_factory.mktemp("sharding"), RANKS,
                    sharding_cases, mm, step_in, res_in)
    return dict(out=out, mm=mm, state0=state0, step_in=step_in,
                jax_step=jax_step, res_want=res_want)


def _posterior_near_truth(p, tol):
    assert abs(p[:, 0].mean() - 1.2) < tol
    assert abs(p[:, 1].mean() - 0.5) < tol


def test_mesh_has_4_ranks(world):
    m = load(world["out"], "mesh")
    assert m["shape"].tolist() == [RANKS, 1]
    assert m["sizes"].tolist() == [RANKS, 1, RANKS]
    assert m["names"].tolist() == ["particles", "data"]
    assert "torchrun" in str(m["world_error"])
    assert "not divisible" in str(m["data_error"])


def test_sharded_step_matches_single_device(world):
    """One step from the same state with JAX's draws replayed: the sharded
    step against the port's one-process step and the JAX package's sharded
    step, within reduction reassociation; the step's collectives are each
    of the kinds the step needs."""
    got = load(world["out"], "step")
    ts = convert.state_from_numpy(
        world["step_in"]["arrays"], device="cpu",
        draws=ReplayDraws(world["step_in"]["entries"]))
    single = make_smc_step(mm_model(world["mm"]), SMCConfig(n_particles=N))(ts)
    want = world["jax_step"]
    for ref in (single.particles.numpy(), np.asarray(want.particles)):
        np.testing.assert_allclose(got["particles"], ref, rtol=5e-4,
                                   atol=1e-5)
    assert float(got["gamma"]) == pytest.approx(float(single.gamma),
                                                rel=1e-5)
    assert float(got["gamma"]) == pytest.approx(float(want.gamma), rel=1e-5)
    assert int(got["n_mh"]) == int(single.n_mh) == int(want.n_mh)
    assert float(got["total_lik_evals"]) == float(want.total_lik_evals)
    kinds = dict(zip(got["kinds"].tolist(), got["counts"].tolist()))
    for k in ("all_reduce_max", "all_reduce_sum", "all_gather"):
        assert kinds[k] > 0, kinds


def test_full_sharded_run_posterior(world):
    s = load(world["out"], "run")
    assert float(s["gamma"]) == 1.0
    assert s["particles"].shape == (N, 3)
    _posterior_near_truth(s["particles"], 0.15)


def test_ring_resampling_full_run_matches_default(world):
    """The ring redistribution is exact: the whole sharded run with
    resampling="ring" is the default run's."""
    ring = load(world["out"], "run9_ring")
    default = load(world["out"], "run9_residual_systematic")
    assert float(ring["gamma"]) == 1.0
    assert int(ring["step"]) == int(default["step"])
    np.testing.assert_allclose(ring["particles"], default["particles"],
                               rtol=1e-5, atol=1e-6)


def test_ring_resampling_unsharded_fallback(world):
    """resampling="ring" in one process is the residual-systematic run."""
    m = mm_model(world["mm"])
    s = run_smc_on_device(m, SMCConfig(n_particles=256, resampling="ring"), 2)
    s0 = run_smc_on_device(m, SMCConfig(n_particles=256), 2)
    assert torch.equal(s.particles, s0.particles)


def test_indivisible_particle_count_raises(world):
    assert "not divisible" in str(load(world["out"], "indivisible")["error"])


def test_large_sharded_fused_run(world):
    """2^15 particles over four ranks, the whole run graphed-or-eager as
    on one device (collectives: reductions, the exact prefix sums, the
    cross-rank gather)."""
    s = load(world["out"], "large")
    assert float(s["gamma"]) == 1.0
    _posterior_near_truth(s["particles"], 0.05)


def test_full_run_from_key_sharded(world):
    """make_full_run_on_device(psharding=): each rank draws its rows of
    the prior and returns its rows of the posterior."""
    s = load(world["out"], "full")
    assert int(s["local_rows"]) == N // RANKS
    assert float(s["gamma"]) == 1.0
    _posterior_near_truth(s["particles"], 0.15)


def test_explicit_shard_map_resampler_matches_single_chip(world):
    """resample_sharded on four ranks, fed JAX's v0, is bit for bit the
    JAX package's result (its resample_sharded's, by
    tests/test_sharding.py)."""
    got = load(world["out"], "resample_sharded")
    want = world["res_want"]["resample_sharded"]
    assert int(got["local_rows"]) == 1024 // RANKS
    np.testing.assert_array_equal(got["particles"], want[0])
    np.testing.assert_array_equal(got["log_lik"], want[1])


@pytest.mark.parametrize("concentration", [2, 12])
def test_ring_resampler_matches_single_chip(world, concentration):
    """resample_sharded_ring is, bit for bit, the JAX package's result
    (its ring resampler's); concentration 12 spikes the weights on a few
    particles so the ancestors span ranks and the ring runs its rounds."""
    got = load(world["out"], f"ring_{concentration}")
    want = world["res_want"][f"ring_{concentration}"]
    np.testing.assert_array_equal(got["particles"], want[0])
    np.testing.assert_array_equal(got["log_lik"], want[1])

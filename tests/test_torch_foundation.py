"""The port's foundation against the JAX package: SMCConfig, Prior,
diagnostics, the state converter, the import boundary (no JAX, no
smc_tpu inside smc_tpu_torch) and the CUDA-by-default entry points."""
import ast
import dataclasses
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smc_tpu_torch
from smc_tpu import SMCConfig as JaxConfig
from smc_tpu.priors import Prior as JaxPrior
from smc_tpu.smc import diagnostics as jdiag
from smc_tpu_torch import SMCConfig, TorchDraws, convert
from smc_tpu_torch.priors import Prior
from smc_tpu_torch.smc import diagnostics as tdiag

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_config_fields_and_defaults_match_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(JaxConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(SMCConfig)]
    assert [n for n, _ in jf] == [n for n, _ in tf]
    for (name, jd), (_, td) in zip(jf, tf):
        if name == "dtype":
            assert jnp.dtype(jd).name == str(td).replace("torch.", "")
        else:
            assert jd == td, name
    j, t = JaxConfig(), SMCConfig()
    assert j.evals_per_sweep == t.evals_per_sweep
    assert JaxConfig(mutation="hmc").evals_per_sweep == \
        SMCConfig(mutation="hmc").evals_per_sweep
    np.testing.assert_array_equal(np.asarray(j.cov_weight(3)),
                                  t.cov_weight(3).numpy())


@pytest.mark.parametrize("bad", [
    {"n_particles": 1}, {"ess_limit": 0.0}, {"ess_limit": 1.5},
    {"gamma_reduction_rate": 1.0}, {"mh_steps": 0}, {"resampling": "x"},
    {"mutation": "x"}, {"hmc_leapfrog": 0},
    {"n_particles": 10, "block_particles": 3}])
def test_config_checks_match_jax(bad):
    with pytest.raises(ValueError):
        JaxConfig(**bad)
    with pytest.raises(ValueError):
        SMCConfig(**bad)


def _mixed_priors():
    specs = [{"dist": "uniform", "low": 0.0, "high": 10.0},
             {"dist": "normal", "mu": 1.0, "sigma": 0.5},
             {"dist": "uniform", "low": -2.0, "high": 3.0}]
    return JaxPrior.from_specs(specs), Prior.from_specs(specs, device="cpu")


def test_prior_log_pdf_and_support_exact():
    """Exact equality on shared inputs, inside and outside the uniform
    supports, on the bounds, and with normal dimensions."""
    jp, tp = _mixed_priors()
    rng = np.random.default_rng(0)
    theta = rng.uniform(-4, 12, size=(2000, 3)).astype(np.float32)
    theta[:5] = [[0, 1, -2], [10, 0, 3], [10.0001, 1, 0],
                 [5, 100, 0], [-1e-7, 0, 0]]
    for f in ("kind", "low", "high", "loc", "scale"):
        np.testing.assert_array_equal(np.asarray(getattr(jp, f)),
                                      getattr(tp, f).numpy())
    tt = torch.from_numpy(theta)
    np.testing.assert_array_equal(np.asarray(jp.in_support(theta)),
                                  tp.in_support(tt).numpy())
    np.testing.assert_array_equal(np.asarray(jp.log_pdf(theta)),
                                  tp.log_pdf(tt).numpy())
    ju = JaxPrior.uniform([0.0, 0.0], [10.0, 2.0])
    tu = Prior.uniform([0.0, 0.0], [10.0, 2.0], device="cpu")
    np.testing.assert_array_equal(np.asarray(ju.log_pdf(theta[:, :2])),
                                  tu.log_pdf(tt[:, :2]).numpy())
    jn = JaxPrior.normal([0.0, 1.0], [1.0, 3.0])
    tn = Prior.normal([0.0, 1.0], [1.0, 3.0], device="cpu")
    np.testing.assert_array_equal(np.asarray(jn.log_pdf(theta[:, :2])),
                                  tn.log_pdf(tt[:, :2]).numpy())


def test_prior_sample_moments():
    _, tp = _mixed_priors()
    x = tp.sample(TorchDraws(3, device="cpu"), 40000).double().numpy()
    assert x.shape == (40000, 3)
    # uniform(0, 10): mean 5, sd 10/sqrt(12); normal(1, .5); uniform(-2, 3)
    np.testing.assert_allclose(x.mean(0), [5.0, 1.0, 0.5], atol=0.05)
    np.testing.assert_allclose(x.std(0), [10 / 12 ** .5, 0.5, 5 / 12 ** .5],
                               rtol=0.02)
    assert (x[:, 0] >= 0).all() and (x[:, 0] < 10).all()
    assert (x[:, 2] >= -2).all() and (x[:, 2] < 3).all()


def test_diagnostics_match_jax():
    rng = np.random.default_rng(1)
    w = rng.dirichlet(np.ones(300)).astype(np.float32)
    np.testing.assert_allclose(float(tdiag.normalized_ess(torch.from_numpy(w))),
                               float(jdiag.normalized_ess(jnp.asarray(w))),
                               rtol=1e-6)
    anc = rng.integers(0, 300, 300).astype(np.int32)
    assert float(tdiag.unique_ancestor_fraction(torch.from_numpy(anc))) == \
        pytest.approx(float(jdiag.unique_ancestor_fraction(jnp.asarray(anc))))
    flows = rng.normal(size=(7, 5, 4)).astype(np.float32)
    flows[2] = tdiag.FAILURE_SENTINEL
    flows[5, :, 1] = tdiag.FAILURE_SENTINEL
    assert int(tdiag.failed_solve_count(torch.from_numpy(flows))) == \
        int(jdiag.failed_solve_count(jnp.asarray(flows))) == 5


def test_import_leaves_jax_and_smc_tpu_out():
    code = ("import sys, smc_tpu_torch, smc_tpu_torch.convert, "
            "smc_tpu_torch.ops.mm_cuda; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'smc_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_no_module_of_the_port_imports_jax_or_smc_tpu():
    files = sorted((REPO / "smc_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        roots = set(_imported_roots(f))
        assert not roots & {"jax", "jaxlib", "smc_tpu"}, (f, roots)


def test_entry_points_raise_without_cuda(monkeypatch):
    from smc_tpu_torch.models.michaelis_menten import MichaelisMentenModel
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arrays = dict(kind=[0], low=[0.0], high=[1.0], loc=[.5], scale=[1.0])
    calls = [
        lambda: Prior.uniform([0.0], [1.0]),
        lambda: Prior.normal([0.0], [1.0]),
        lambda: Prior.from_specs([{"dist": "uniform", "low": 0, "high": 1}]),
        lambda: TorchDraws(0),
        lambda: MichaelisMentenModel.default(),
        lambda: convert.prior_from_numpy(**arrays),
        lambda: convert.mm_model_from_numpy(
            np.zeros((6, 40)), np.ones(6), np.linspace(0, 10, 40), arrays),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # the explicit CPU request runs
    m = MichaelisMentenModel.default(device="cpu", method="pallas_exact")
    assert m.device.type == "cpu" and m.prior.device.type == "cpu"


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert smc_tpu_torch.__version__


def test_state_round_trip():
    from smc_tpu_torch.models.michaelis_menten import MichaelisMentenModel
    from smc_tpu_torch.smc.driver import init_state
    m = MichaelisMentenModel.default(method="exact", device="cpu")
    s = init_state(5, m, SMCConfig(n_particles=64))
    d = convert.state_to_numpy(s)
    assert set(d) == set(convert.STATE_FIELDS) and len(d) == 13
    s2 = convert.state_from_numpy(d, device="cpu")
    for f in convert.STATE_FIELDS:
        if f != "key":
            a, b = getattr(s, f), getattr(s2, f)
            assert a.dtype == b.dtype, f
            assert torch.equal(a, b), f
    # the restored generator continues the same stream
    assert torch.equal(s.key.uniform((5,)), s2.key.uniform((5,)))


def test_cpu_tensors_take_the_plain_versions_without_a_build(monkeypatch):
    """On the CPU no kernel is built or loaded, and nothing is counted as
    a launch; a tensor on any other device raises."""
    from smc_tpu_torch.ops import _build, ladder_cuda, mm_cuda, resample_cuda

    def no_build():
        raise AssertionError("a CPU tensor reached the CUDA kernels")
    monkeypatch.setattr(_build, "load", no_build)
    _build.reset_launch_counts()
    theta = torch.rand(1, 50, 3) * 5
    obs, s0 = torch.rand(1, 6, 40), torch.rand(1, 6) + 0.5
    ll = mm_cuda.mm_loglik_exact_batched(theta, obs, s0, 0.25)
    assert torch.equal(ll, mm_cuda.mm_loglik_exact_plain(theta, obs, s0,
                                                         0.25))
    ladder_cuda.ladder_stats(-torch.rand(50), torch.rand(4))
    resample_cuda.sorted_offsets_to_ancestors(
        torch.arange(50, dtype=torch.int32))
    assert all(v == 0 for v in _build.launch_counts.values())
    with pytest.raises(ValueError, match="device"):
        mm_cuda.mm_loglik_exact_batched(theta.to("meta"), obs.to("meta"),
                                        s0.to("meta"), 0.25)
    with pytest.raises(ValueError, match="device"):
        resample_cuda.sorted_offsets_to_ancestors(
            torch.arange(5, dtype=torch.int32, device="meta"))

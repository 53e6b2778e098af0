"""The port's run files (``smc_tpu_torch/io``, ``viz``, the methanation CSV
readers) against the JAX package's.

- Checkpoints cross the packages in both directions, in every format
  (``.npz``, ``.smck``, ``.smcd``), for single and ensemble states: the 12
  fields that are not the key bit for bit; the key by the rule of
  ``smc_tpu_torch.convert`` (a port key restores its generator exactly, a
  JAX key seeds a fresh one).
- A run resumed in the port from each format ends bit-equal to the
  uninterrupted run.
- The committed ``benchmarks/results/run_sbc/sbc_cont_ck.smcd`` loads.
- The CSV readers read the files of ``tests/test_reference_csv.py`` to the
  JAX package's bits; round trips through ``to_csv`` hold to rtol 1e-5.

No JAX program is compiled here: JAX states are built from arrays.
"""
import dataclasses
import json
import os
import tracemalloc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_parity  # noqa: F401  (one PyTorch thread per worker)
from smc_tpu import runtime as JR
from smc_tpu.io import checkpoint as JC
from smc_tpu.models import methanation as JM
from smc_tpu.smc.state import SMCState as JState
from smc_tpu_torch import SMCConfig, convert, run_smc
from smc_tpu_torch.io import checkpoint as TC
from smc_tpu_torch.io.csvio import (load_particles_csv, save_particles_csv,
                                    save_posterior_csv)
from smc_tpu_torch.io.rundir import RunDir
from smc_tpu_torch.models import methanation as TM
from smc_tpu_torch.models.michaelis_menten import MichaelisMentenModel
from smc_tpu_torch.rng import TorchDraws
from smc_tpu_torch.runtime import AsyncCheckpointer
from tests.test_reference_csv import (OUT_FLOWS, OUT_MOLF,
                                      _write_reference_csv)

FIELDS = tuple(f for f in convert.STATE_FIELDS if f != "key")
INT_FIELDS = ("step", "n_mh", "accepted", "n_gamma_reductions")
FORMATS = ("npz", "smck", "smcd")
SBC_CK = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                      "results", "run_sbc", "sbc_cont_ck.smcd")


def _arrays(rng, d=None, n=300, dim=3):
    """The 12 non-key fields as arrays (leading ``d`` for an ensemble)."""
    lead = () if d is None else (d,)
    out = {"particles": rng.normal(size=lead + (n, dim)),
           "log_lik": rng.normal(size=lead + (n,))}
    for f in FIELDS[2:]:
        out[f] = (rng.integers(0, 50, size=lead) if f in INT_FIELDS
                  else rng.normal(size=lead))
    out["log_lik"].flat[::17] = -np.inf
    return {f: np.asarray(v, np.int32 if f in INT_FIELDS else np.float32)
            for f, v in out.items()}


def _port_state(arrays, seed=11):
    return convert.state_from_numpy(
        arrays, device="cpu", draws=TorchDraws(seed, "cpu"))


def _jax_state(arrays, d=None):
    key = (jax.random.key(3) if d is None
           else jax.random.split(jax.random.key(3), d))
    return JState(key=key, **{f: jnp.asarray(v) for f, v in arrays.items()})


def _port_save(fmt, path, state):
    if fmt == "npz":
        TC.save_state(path + ".npz", state)
        return path + ".npz"
    if fmt == "smck":
        with AsyncCheckpointer() as ck:
            TC.save_state_async(ck, path + ".smck", state)
            ck.flush()
            assert ck.stats()["errors"] == 0
        return path + ".smck"
    return TC.save_state_chunked(path, state, max_bytes=512)


def _jax_save(fmt, path, state):
    if fmt == "npz":
        JC.save_state(path + ".npz", state)
        return path + ".npz"
    if fmt == "smck":
        with JR.AsyncCheckpointer() as ck:
            JC.save_state_async(ck, path + ".smck", state)
            ck.flush()
        return path + ".smck"
    return JC.save_state_chunked(path, state, max_bytes=512)


def _jax_read_arrays(fmt, path):
    """What the JAX package's array readers see in a file: np.load, the
    runtime's load_snapshot, the .smcd memmaps and meta.json."""
    if fmt == "npz":
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    if fmt == "smck":
        return JR.load_snapshot(path)
    with open(os.path.join(path, "meta.json")) as fh:
        meta = json.load(fh)
    out = {"key": np.asarray(meta["key"], np.uint32)}
    for spec in meta["fields"]:
        name = spec["name"]
        out[name] = (np.load(os.path.join(path, name + ".npy"),
                             mmap_mode="r") if spec["kind"] == "npy"
                     else np.asarray(meta["scalars"][name],
                                     dtype=np.dtype(spec["dtype"])))
    return out


def _assert_fields(state, arrays):
    for f in FIELDS:
        got = getattr(state, f)
        got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(
            got)
        assert got.dtype == arrays[f].dtype and got.shape == arrays[f].shape
        np.testing.assert_array_equal(got, arrays[f], err_msg=f)


@pytest.mark.parametrize("d", [None, 4], ids=["single", "ensemble"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_port_files_read_by_the_jax_package(tmp_path, fmt, d):
    arrays = _arrays(np.random.default_rng(0), d)
    ts = _port_save(fmt, str(tmp_path / "ck"), _port_state(arrays))
    got = _jax_read_arrays(fmt, ts)
    for f in FIELDS:
        assert got[f].dtype == arrays[f].dtype, f
        np.testing.assert_array_equal(got[f], arrays[f], err_msg=f)
    words = got["key"]
    assert words.dtype == np.uint32 and words[0] == convert.KEY_TAG
    # The recorded deviation: the JAX package's load_state cannot wrap a
    # generator state as a threefry key.
    with pytest.raises(Exception):
        JC.load_state(ts)


@pytest.mark.parametrize("d", [None, 4], ids=["single", "ensemble"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_jax_files_read_by_the_port(tmp_path, fmt, d):
    arrays = _arrays(np.random.default_rng(1), d)
    jstate = _jax_state(arrays, d)
    path = _jax_save(fmt, str(tmp_path / "ck"), jstate)
    back = TC.load_state(path, device="cpu")
    _assert_fields(back, arrays)
    kd = np.asarray(jax.random.key_data(jstate.key))
    want = convert.draws_from_key(kd, "cpu")
    assert torch.equal(back.key.generator.get_state(),
                       want.generator.get_state())


@pytest.mark.parametrize("fmt", FORMATS)
def test_port_roundtrip_restores_the_generator(tmp_path, fmt):
    arrays = _arrays(np.random.default_rng(2), 3)
    state = _port_state(arrays, seed=5)
    state.key.normal((7,))                      # move it off its seed
    path = _port_save(fmt, str(tmp_path / "ck"), state)
    back = TC.load_state(path, device="cpu")
    _assert_fields(back, arrays)
    assert torch.equal(back.key.uniform((100,)), state.key.uniform((100,)))


def test_key_rule():
    g = TorchDraws(4, "cpu")
    words = convert.key_to_words(g)
    assert words.dtype == np.uint32 and words[0] == convert.KEY_TAG
    assert words[1] == g.get_state().size and words.size == 2 + 5056 // 4
    for raw in (g.get_state(), words):
        assert torch.equal(convert.draws_from_key(raw, "cpu").uniform((9,)),
                           TorchDraws(4, "cpu").uniform((9,)))
    # A JAX key (two words per row) seeds a generator from its bytes, even
    # one whose first word happens to be the tag.
    for raw in (np.asarray([convert.KEY_TAG, 4], np.uint32),
                np.asarray([[1, 2], [3, 4]], np.uint32)):
        seed = int.from_bytes(raw.tobytes()[:8], "little") & (2 ** 63 - 1)
        assert torch.equal(convert.draws_from_key(raw, "cpu").uniform((3,)),
                           TorchDraws(seed, "cpu").uniform((3,)))
    # A CUDA generator's 16 bytes cannot restore a CPU generator.
    cuda_words = np.concatenate([[convert.KEY_TAG, 16],
                                 np.arange(4)]).astype(np.uint32)
    with pytest.raises(ValueError, match="16 bytes"):
        convert.draws_from_key(cuda_words, "cpu")
    with pytest.raises(TypeError):
        convert.key_to_words(object())


@pytest.fixture(scope="module")
def mm_run():
    """An uninterrupted MM run (N = 256, exact) and its state after step 3,
    saved in every format by the run's callback."""
    model = MichaelisMentenModel.default(method="exact", device="cpu")
    cfg = SMCConfig(n_particles=256)
    saved = {}

    def callback(s):
        if int(s.step) == 3:
            saved["state"] = s
            saved["rng"] = s.key.get_state()
    final = run_smc(model, cfg, 7, callback=callback, verbose=False)
    return model, cfg, final, saved


@pytest.mark.parametrize("fmt", FORMATS)
def test_resume_is_bit_equal_to_the_uninterrupted_run(tmp_path, mm_run,
                                                      fmt):
    model, cfg, final, saved = mm_run
    mid = saved["state"]
    state = dataclasses.replace(mid, key=TorchDraws(0, "cpu").set_state(
        saved["rng"]))
    path = _port_save(fmt, str(tmp_path / "mid"), state)
    resumed = run_smc(model, cfg, None, state=TC.load_state(path,
                                                            device="cpu"),
                      verbose=False)
    assert float(final.gamma) == 1.0 and int(final.step) > 3
    for f in convert.STATE_FIELDS:
        if f != "key":
            assert torch.equal(getattr(resumed, f), getattr(final, f)), f
    assert torch.equal(resumed.key.generator.get_state(),
                       final.key.generator.get_state())


def test_committed_sbc_checkpoint_loads():
    st = TC.load_state(SBC_CK, device="cpu")
    assert tuple(st.particles.shape) == (24, 512, 5)
    for f in FIELDS:
        want = np.load(os.path.join(SBC_CK, f + ".npy"))
        np.testing.assert_array_equal(getattr(st, f).numpy(), want,
                                      err_msg=f)
    with open(os.path.join(SBC_CK, "meta.json")) as fh:
        key = np.asarray(json.load(fh)["key"], np.uint32)
    assert torch.equal(st.key.generator.get_state(),
                       convert.draws_from_key(key, "cpu")
                       .generator.get_state())
    assert bool((st.gamma == 1.0).all())


def test_smcd_slabs_bound_host_memory(tmp_path):
    """Each slab written holds at most max_bytes and every row once; a
    load goes through host memory one slab at a time."""
    rng = np.random.default_rng(3)
    n, d = 1 << 16, 8
    arrays = _arrays(rng, n=n, dim=d)
    state = _port_state(arrays)
    budget = arrays["particles"].nbytes // 16
    seen = np.zeros(n, int)
    for ofs, slab in TC._iter_row_slabs(state.particles, budget):
        assert slab.nbytes <= budget
        seen[ofs:ofs + slab.shape[0]] += 1
    assert (seen == 1).all()
    path = TC.save_state_chunked(str(tmp_path / "big"), state,
                                 max_bytes=budget)
    tracemalloc.start()
    back = TC._load_state_chunked(path, "cpu", max_bytes=budget)
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    _assert_fields(back, arrays)
    assert peak < arrays["particles"].nbytes // 4, peak


def test_sharding_is_not_ported(tmp_path):
    path = _port_save("npz", str(tmp_path / "s"),
                      _port_state(_arrays(np.random.default_rng(4))))
    with pytest.raises(NotImplementedError, match="item 12"):
        TC.load_state(path, sharding=object(), device="cpu")


def test_rundir_and_config_archive(tmp_path):
    rd = RunDir(root=str(tmp_path), tag="mm", timestamp="20260101_000000")
    for s in RunDir.SUBDIRS:
        assert os.path.isdir(rd.sub(s))
    rd.archive_config(SMCConfig(n_particles=10),
                      model=MichaelisMentenModel.default(method="exact",
                                                         device="cpu"),
                      extra={"seed": 3})
    with open(rd.file("config.json")) as fh:
        doc = json.load(fh)
    assert doc["config"]["n_particles"] == 10
    assert doc["config"]["dtype"] == "float32"
    assert doc["model"] == {"class": "MichaelisMentenModel",
                            "param_names": ["Vmax", "Km", "sigma"]}
    assert doc["extra"] == {"seed": 3}


def test_posterior_csv_roundtrip(tmp_path):
    p = torch.from_numpy(np.random.default_rng(0).normal(
        size=(50, 3)).astype(np.float32))
    f1 = str(tmp_path / "post.csv")
    save_posterior_csv(f1, p, ["Vmax", "Km", "sigma"])
    assert open(f1).readline().strip() == "Vmax,Km,sigma"
    np.testing.assert_allclose(load_particles_csv(f1), p.numpy(), rtol=1e-6)
    f2 = str(tmp_path / "raw.csv")
    save_particles_csv(f2, p)
    np.testing.assert_allclose(load_particles_csv(f2), p.numpy(), rtol=1e-6)


def test_plots_smoke(tmp_path, monkeypatch):
    from smc_tpu_torch.viz import plots
    rng = np.random.default_rng(0)
    p1 = torch.from_numpy(rng.normal(size=(100, 3)))
    p2 = torch.from_numpy(rng.normal(size=(100, 3)) * 0.3)
    names = ["a", "b", "c"]
    assert plots.plot_marginal_histograms(p2, str(tmp_path / "h.png"),
                                          names, true_values=[0, 0, 0])
    assert plots.plot_prior_posterior_compare(p1, p2, str(tmp_path / "c.png"),
                                              names)
    assert plots.plot_pairplot(p2, str(tmp_path / "pp.png"), names)
    obs = rng.normal(size=(5, 6))
    pred = torch.from_numpy(obs[None] + rng.normal(size=(20, 5, 6)) * 0.1)
    assert plots.plot_parity(obs, pred, str(tmp_path / "box.png"),
                             str(tmp_path / "mean.png"))
    assert os.path.exists(tmp_path / "box_4.png")
    # Without matplotlib every plot is skipped and says so.
    monkeypatch.setattr(plots, "_mpl", lambda: None)
    assert not plots.plot_marginal_histograms(p2, str(tmp_path / "x.png"),
                                              names)
    assert not plots.plot_pairplot(p2, str(tmp_path / "y.png"), names)


_COND = ("C_in", "T_in", "T_jacket", "u_in", "void", "dz", "P0")


def _assert_cond_equal(tcond, jcond):
    for k in _COND:
        np.testing.assert_array_equal(getattr(tcond, k).numpy(),
                                      np.asarray(getattr(jcond, k)),
                                      err_msg=k)


def test_reference_csv_reads_to_the_jax_bits(tmp_path):
    path = _write_reference_csv(tmp_path / "information.csv")
    tc, tflows, tmolf = TM.Conditions.from_reference_csv(path, device="cpu")
    jc, jflows, jmolf = JM.Conditions.from_reference_csv(path)
    _assert_cond_equal(tc, jc)
    np.testing.assert_array_equal(tflows.numpy(), np.asarray(jflows))
    np.testing.assert_array_equal(tmolf.numpy(), np.asarray(jmolf))
    np.testing.assert_allclose(tflows.numpy(), OUT_FLOWS.T, rtol=2e-5)
    np.testing.assert_allclose(tmolf.numpy(), OUT_MOLF.T, rtol=2e-5)
    sub, sflows, _ = TM.Conditions.from_reference_csv(path, datalist=(0, 2),
                                                      device="cpu")
    assert sub.n_data == 2
    np.testing.assert_array_equal(sub.T_in.numpy(), tc.T_in.numpy()[[0, 2]])
    np.testing.assert_array_equal(sflows.numpy(), tflows.numpy()[:, [0, 2]])


def test_clean_schema_roundtrips_across_packages(tmp_path):
    """to_csv then from_csv, across the packages in both directions: the
    same file reads to the same bits in both; the round trip holds to
    rtol 1e-5 (float32 fields written and read back)."""
    path = _write_reference_csv(tmp_path / "information.csv")
    tc, _, _ = TM.Conditions.from_reference_csv(path, device="cpu")
    jc, _, _ = JM.Conditions.from_reference_csv(path)
    tc.to_csv(str(tmp_path / "port.csv"))
    jc.to_csv(str(tmp_path / "jax.csv"))
    for name in ("port.csv", "jax.csv"):
        t2 = TM.Conditions.from_csv(str(tmp_path / name), device="cpu")
        _assert_cond_equal(t2, JM.Conditions.from_csv(str(tmp_path / name)))
        for k in _COND:
            np.testing.assert_allclose(getattr(t2, k).numpy(),
                                       getattr(tc, k).numpy(), rtol=1e-5,
                                       err_msg=k)


def test_model_csv_constructors(tmp_path):
    path = _write_reference_csv(tmp_path / "information.csv")
    m = TM.MethanationModel.from_reference_csv(path, nx=11, n_steps=6,
                                               device="cpu")
    np.testing.assert_allclose(m.obs.numpy(), OUT_FLOWS.T, rtol=2e-5)
    assert m.param_names == ("Af", "Eaf", "Ar", "Ear", "sigma")
    theta = torch.tensor([[TM.KIN_TRUE[i] if i < 8 else 5.0
                           for i in m.est_idx]] * 2)
    ll, flows = m.log_likelihood(theta)
    assert torch.isfinite(ll).all() and tuple(flows.shape) == (2, 5, 3)

    m.cond.to_csv(str(tmp_path / "conditions.csv"), nx=11)
    np.savetxt(str(tmp_path / "data.csv"), m.obs.numpy(), delimiter=",")
    m2 = TM.MethanationModel.from_csv(
        str(tmp_path / "conditions.csv"), str(tmp_path / "data.csv"), nx=11,
        n_steps=6, datalist=(0, 2), prior_mode="taylor", device="cpu")
    assert m2.cond.n_data == 2
    np.testing.assert_array_equal(m2.obs.numpy(), m.obs.numpy()[:, [0, 2]])
    np.testing.assert_allclose(m2.cond.u_in.numpy(),
                               m.cond.u_in.numpy()[[0, 2]], rtol=1e-5)
    np.savetxt(str(tmp_path / "bad.csv"), np.zeros((5, 2)), delimiter=",")
    with pytest.raises(ValueError, match="data.csv shape"):
        TM.MethanationModel.from_csv(str(tmp_path / "conditions.csv"),
                                     str(tmp_path / "bad.csv"),
                                     device="cpu")

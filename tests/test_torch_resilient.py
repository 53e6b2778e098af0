"""Crash/stall-resilient execution of the PyTorch port
(``smc_tpu_torch/utils/resilient.py``), the counterpart of
``tests/test_resilient.py``, plus the port's metrics, profiler and memory
helpers (``utils/metrics.py``, ``utils/memory.py``).

The port's checkpoints restore the run's generator exactly, so where the
JAX tests show that a recovered run completes, these also hold it bit-equal
to the uninterrupted ``run_smc`` with the same seed. On the CPU, N = 256.
"""
import glob
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from tests.torch_parity import assert_same_run  # one PyTorch thread
from smc_tpu_torch import SMCConfig, init_state, run_smc
from smc_tpu_torch.models.michaelis_menten import MichaelisMentenModel
from smc_tpu_torch.utils.resilient import (checkpoint_exists, run_resilient,
                                           supervise)


@pytest.fixture(scope="module")
def model():
    return MichaelisMentenModel.default(method="exact", device="cpu")


def _cfg():
    return SMCConfig(n_particles=256)


@pytest.fixture(scope="module")
def uninterrupted(model):
    """The uninterrupted run of each seed, made once."""
    runs = {}

    def get(seed):
        if seed not in runs:
            runs[seed] = run_smc(model, _cfg(), seed, verbose=False)
        return runs[seed]
    return get


def test_recovers_from_midrun_failure(model, uninterrupted, tmp_path):
    """One injected failure at step 2: the run reloads the step-2
    checkpoint and completes, bit-equal to the uninterrupted run; only the
    in-flight step is retried."""
    ckpt = str(tmp_path / "ck.npz")
    boom = {"armed": True, "failed_at": None, "steps_seen": []}

    def cb(st):
        boom["steps_seen"].append(int(st.step))
        if boom["armed"] and int(st.step) == 2:
            boom["armed"] = False
            boom["failed_at"] = int(st.step)
            raise RuntimeError("injected worker crash")

    st = run_resilient(model, _cfg(), 0, checkpoint=ckpt, callback=cb,
                       retry_delay_s=0.0, verbose=False)
    assert float(st.gamma) == 1.0
    assert boom["failed_at"] == 2
    # resumed AT the checkpointed step, not from scratch: step 1 appears
    # exactly once, step 3 follows the re-raised step-2 checkpoint
    assert boom["steps_seen"].count(1) == 1
    assert 3 in boom["steps_seen"]
    assert checkpoint_exists(ckpt)
    assert_same_run(st, uninterrupted(0))


def test_progress_refreshes_budget(model, uninterrupted, tmp_path):
    """A failure after EVERY step with max_restarts=0 still completes: each
    attempt advances one step, so the no-progress budget is never consumed;
    the run is still the uninterrupted one, bit for bit."""
    ckpt = str(tmp_path / "ck.npz")
    n_fail = {"n": 0}

    def cb(st):
        n_fail["n"] += 1
        raise RuntimeError("crash after every step")

    st = run_resilient(model, _cfg(), 1, checkpoint=ckpt, callback=cb,
                       max_restarts=0, retry_delay_s=0.0, verbose=False)
    assert float(st.gamma) == 1.0
    assert n_fail["n"] == int(st.step)  # one injected crash per step
    assert_same_run(st, uninterrupted(1))


def test_exhausts_no_progress_budget(model, tmp_path, monkeypatch):
    """Failures with no step progress stop after max_restarts retries and
    re-raise the last error."""
    from smc_tpu_torch.smc import driver as drv
    calls = {"n": 0}

    def always_fail(*a, **k):
        calls["n"] += 1
        raise ValueError("permanently broken")

    monkeypatch.setattr(drv, "run_smc", always_fail)
    with pytest.raises(ValueError, match="permanently broken"):
        run_resilient(model, _cfg(), 2, checkpoint=str(tmp_path / "ck.npz"),
                      max_restarts=2, retry_delay_s=0.0, verbose=False)
    # attempt 1 fails -> reload finds the post-init step-0 checkpoint
    # (progress vs -1, budget refreshed), then 1 + max_restarts
    # no-progress attempts
    assert calls["n"] == 4


def test_resumes_from_existing_checkpoint(model, uninterrupted, tmp_path):
    """resume=True picks up a checkpoint left by a killed process (the
    supervise() re-exec path) and continues the same run, bit for bit."""
    from smc_tpu_torch import make_smc_step
    from smc_tpu_torch.io.checkpoint import save_state
    ckpt = str(tmp_path / "ck.npz")
    cfg = _cfg()
    s0 = init_state(3, model, cfg)
    step = make_smc_step(model, cfg)
    save_state(ckpt, step(step(s0)))

    seen = []
    st = run_resilient(model, cfg, 99, checkpoint=ckpt,
                       callback=lambda s: seen.append(int(s.step)),
                       retry_delay_s=0.0, verbose=False)
    assert float(st.gamma) == 1.0
    assert min(seen) == 3  # continued after the saved step-2 state
    # the checkpointed trajectory IS the uninterrupted one
    assert_same_run(st, uninterrupted(3))


def test_checkpoint_exists_spellings(tmp_path):
    assert not checkpoint_exists(str(tmp_path / "nope.npz"))
    p = tmp_path / "a.npz"
    p.write_bytes(b"x")
    assert checkpoint_exists(str(p))
    # np.savez appends .npz: bare path must still be found
    assert checkpoint_exists(str(tmp_path / "a"))
    d = tmp_path / "ck.smcd"
    d.mkdir()
    assert not checkpoint_exists(str(d))  # dir without meta.json
    (d / "meta.json").write_text("{}")
    assert checkpoint_exists(str(d))


_CHILD = textwrap.dedent("""
    import os, sys, time
    cnt_file, prog_file, fail_until = sys.argv[1], sys.argv[2], int(sys.argv[3])
    n = int(open(cnt_file).read()) if os.path.exists(cnt_file) else 0
    n += 1
    open(cnt_file, "w").write(str(n))
    if prog_file != "-":
        # monotone mtime even within one clock tick
        open(prog_file, "w").write(str(n))
        os.utime(prog_file, (n, n))
    sys.exit(0 if n >= fail_until else 3)
""")


def _child_argv(tmp_path, prog: bool, fail_until: int):
    script = tmp_path / "child.py"
    script.write_text(_CHILD)
    cnt = tmp_path / "count.txt"
    prog_file = str(tmp_path / "prog.npz") if prog else "-"
    # -S: the children are tiny scripts; skip site (and any torch import).
    return ([sys.executable, "-S", str(script), str(cnt), prog_file,
             str(fail_until)], cnt, prog_file)


def test_supervise_restarts_until_success(tmp_path):
    """Each attempt advances the progress file, so max_restarts=0 still
    tolerates arbitrarily many crashes."""
    argv, cnt, prog = _child_argv(tmp_path, prog=True, fail_until=4)
    rc = supervise(argv, progress_file=prog, max_restarts=0,
                   retry_delay_s=0.0)
    assert rc == 0
    assert int(cnt.read_text()) == 4


def test_supervise_exhausts_budget(tmp_path):
    argv, cnt, _ = _child_argv(tmp_path, prog=False, fail_until=10**9)
    rc = supervise(argv, max_restarts=2, retry_delay_s=0.0)
    assert rc == 3
    assert int(cnt.read_text()) == 3  # 1 + max_restarts attempts


def test_supervise_passes_env(tmp_path):
    script = tmp_path / "env.py"
    script.write_text("import os,sys; sys.exit(0 if "
                      "os.environ.get('SMC_T')=='1' else 5)")
    assert supervise([sys.executable, "-S", str(script)], env={"SMC_T": "1"},
                     max_restarts=0, retry_delay_s=0.0) == 0


def test_stop_file_between_steps(model, uninterrupted, tmp_path):
    """Cooperative preemption: touching stop_file makes the run return its
    last completed (checkpointed) step instead of tempering to gamma=1; a
    later resume from that checkpoint completes the same run, bit for
    bit."""
    ckpt = str(tmp_path / "ck.npz")
    stop = str(tmp_path / "STOP")

    def cb(st):
        if int(st.step) == 2:
            open(stop, "w").close()

    st = run_resilient(model, _cfg(), 4, checkpoint=ckpt, callback=cb,
                       retry_delay_s=0.0, verbose=False, stop_file=stop)
    assert int(st.step) == 2
    assert float(st.gamma) < 1.0
    os.remove(stop)
    st2 = run_resilient(model, _cfg(), 4, checkpoint=ckpt,
                        retry_delay_s=0.0, verbose=False, stop_file=stop)
    assert float(st2.gamma) == 1.0
    assert int(st2.step) > 2
    assert_same_run(st2, uninterrupted(4))


def test_stop_file_mid_step_block_granularity(model, tmp_path):
    """A stop file present before the first slab aborts the in-flight step
    and returns the last completed state."""
    cfg = SMCConfig(n_particles=256, block_particles=64)
    stop = str(tmp_path / "STOP")
    st0 = init_state(4, model, cfg)
    open(stop, "w").close()
    st = run_smc(model, cfg, 4, state=st0, verbose=False,
                 granularity="block", stop_file=stop)
    assert int(st.step) == int(st0.step)
    assert float(st.gamma) == float(st0.gamma)


def test_smcd_checkpoint_recovers_bit_equal(model, uninterrupted, tmp_path):
    """The same injected failure with a .smcd checkpoint directory."""
    ckpt = str(tmp_path / "ck.smcd")
    armed = [True]

    def cb(st):
        if armed[0] and int(st.step) == 3:
            armed[0] = False
            raise RuntimeError("injected")

    st = run_resilient(model, _cfg(), 0, checkpoint=ckpt, callback=cb,
                       retry_delay_s=0.0, verbose=False)
    assert os.path.exists(os.path.join(ckpt, "meta.json"))
    assert_same_run(st, uninterrupted(0))


# -- metrics, profiler, memory -----------------------------------------------

def test_metrics_logger_lines(model, tmp_path):
    """One JSON line per step with the JAX package's keys and types, read
    back by read_metrics; the scalars equal the state's."""
    from smc_tpu_torch.utils.metrics import MetricsLogger, read_metrics
    path = str(tmp_path / "metrics.jsonl")
    log = MetricsLogger(path)
    states = []

    def cb(s):
        states.append(s)
        log(s)
    run_smc(model, _cfg(), 5, callback=cb, verbose=False)
    log.close()
    recs = read_metrics(path)
    assert [r["step"] for r in recs] == list(range(1, len(states) + 1))
    assert list(recs[0]) == list(MetricsLogger.FIELDS) + ["wall_time_s"]
    for rec, s in zip(recs, states):
        for k in MetricsLogger.FIELDS:
            v = getattr(s, k)
            want = int(v) if v.dtype == torch.int32 else float(v)
            assert rec[k] == want and type(rec[k]) is type(want), k


def test_profile_trace_lets_the_error_through(tmp_path):
    """The run's own exception leaves the profiled block unchanged (the
    JAX version's second yield turns it into 'generator didn't stop after
    throw()'); no trace is written for it."""
    from smc_tpu_torch.utils.metrics import profile_trace
    err = ValueError("the run's own error")
    with pytest.raises(ValueError) as info:
        with profile_trace(str(tmp_path / "prof")):
            torch.ones(4).sum()
            raise err
    assert info.value is err
    assert glob.glob(str(tmp_path / "prof" / "*.json")) == []
    with pytest.raises(KeyError):
        with profile_trace(None):
            raise KeyError("no-op path")


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    from smc_tpu_torch.utils.metrics import profile_trace
    with profile_trace(str(tmp_path / "prof")) as prof:
        (torch.arange(64.0) * 2.0).sum()
    assert prof is not None
    (path,) = glob.glob(str(tmp_path / "prof" / "trace_*.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mul" in names
    with profile_trace("") as none:
        assert none is None


def test_memory_report_without_a_card(monkeypatch):
    from smc_tpu_torch.utils import memory
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert memory.device_memory_report() == []
    assert memory.hbm_utilization() is None
    monkeypatch.setattr(memory, "device_memory_report", lambda: [
        {"device": "cuda:0", "bytes_in_use": 10, "bytes_reserved": 20,
         "bytes_limit": 100, "bytes_free": 80},
        {"device": "cuda:1", "bytes_in_use": 30, "bytes_reserved": 30,
         "bytes_limit": 100, "bytes_free": 70}])
    assert memory.hbm_utilization() == pytest.approx(0.3)


def test_new_modules_import_no_jax():
    """The operations layer and the CLI import neither JAX nor the JAX
    package (a fresh interpreter, since this one has JAX loaded)."""
    code = ("import sys; import smc_tpu_torch.cli, smc_tpu_torch.runner, "
            "smc_tpu_torch.utils.resilient, smc_tpu_torch.utils.memory, "
            "smc_tpu_torch.parallel.multihost; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'smc_tpu.')) or m == 'smc_tpu']; "
            "assert not bad, bad")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root)

"""The PyTorch port's CLI and runner (``smc_tpu_torch/cli.py``,
``smc_tpu_torch/runner.py``) on the CPU: the counterparts of
``tests/test_cli_runner.py`` and ``tests/test_cli_sbc.py``, made stronger
where the port can: its checkpoints restore the generator exactly, so a
resumed run, a stop-file run with its resume and a run through the artifact
writer end bit-equal to the uninterrupted ``run_smc`` with the same seed.
Also each of the CLI's refusals. Every command gets ``--device cpu``; N is
at most 512 and plots are off (the plots are held in
``tests/test_torch_cli_parity.py``).
"""
import glob
import os
import subprocess
import sys

import numpy as np
import pytest

from tests.torch_parity import assert_same_run  # one PyTorch thread
from smc_tpu_torch import SMCConfig, run_smc
from smc_tpu_torch.cli import main
from smc_tpu_torch.io.checkpoint import load_state
from smc_tpu_torch.models.michaelis_menten import MichaelisMentenModel
from smc_tpu_torch.models.synthetic import BananaModel

CPU = ["--device", "cpu", "--quiet", "--no-plots"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_dir(outdir):
    (name,) = os.listdir(outdir)
    return os.path.join(outdir, name)


def _final(run):
    """The final state a run directory holds (``final.npz``, or
    ``final.smcd`` with that format)."""
    (path,) = glob.glob(os.path.join(run, "checkpoints", "final.*"))
    return load_state(path, device="cpu")


def _step_file(run, step):
    (path,) = glob.glob(os.path.join(run, "checkpoints", f"step{step}.*"))
    return path


@pytest.fixture(scope="module")
def mm_reference():
    """The uninterrupted library run the MM CLI runs are held to."""
    m = MichaelisMentenModel.default(method="exact", device="cpu")
    return run_smc(m, SMCConfig(n_particles=256), 0, verbose=False)


def test_cli_run_banana(tmp_path, capsys):
    rc = main(["run", "--model", "banana", "--particles", "512",
               "--outdir", str(tmp_path)] + CPU)
    assert rc == 0
    assert "gamma: 1.0" in capsys.readouterr().out
    run = _run_dir(tmp_path)
    assert os.path.exists(os.path.join(run, "Posterior_Distribution.csv"))
    assert os.path.exists(os.path.join(run, "pred", "last_p_pred.csv"))
    assert os.path.exists(os.path.join(run, "checkpoints", "final.npz"))
    # The artifact writer leaves the run's bits as they were.
    want = run_smc(BananaModel(device="cpu"), SMCConfig(n_particles=512), 0,
                   verbose=False)
    assert_same_run(_final(run), want)
    post = np.loadtxt(os.path.join(run, "Posterior_Distribution.csv"),
                      delimiter=",", skiprows=1, dtype=np.float32)
    assert np.array_equal(post, want.particles.numpy())


def test_cli_run_block_granularity(tmp_path, capsys):
    rc = main(["run", "--model", "banana", "--particles", "512",
               "--granularity", "block", "--block-particles", "128",
               "--outdir", str(tmp_path)] + CPU)
    assert rc == 0
    assert "gamma: 1.0" in capsys.readouterr().out


def test_cli_run_max_restarts(tmp_path, capsys, mm_reference):
    """--max-restarts routes through utils/resilient.run_resilient, leaves
    a checkpoints/latest.npz for crash resume, and changes no bit."""
    rc = main(["run", "--model", "mm", "--mm-method", "exact",
               "--particles", "256", "--max-restarts", "2",
               "--outdir", str(tmp_path)] + CPU)
    assert rc == 0
    assert "gamma: 1.0" in capsys.readouterr().out
    run = _run_dir(tmp_path)
    assert os.path.exists(os.path.join(run, "checkpoints", "latest.npz"))
    assert_same_run(_final(run), mm_reference)


@pytest.mark.parametrize("fmt", ["npz", "auto", "smcd"])
def test_cli_run_mm_and_resume_bit_equal(tmp_path, capsys, mm_reference,
                                         fmt):
    """A CLI run writes per-step checkpoints in each format ('auto' is the
    native .smck where the runtime builds, else .npz); `resume` from step
    2 ends bit-equal to the uninterrupted library run, as does the run
    itself."""
    rc = main(["run", "--model", "mm", "--mm-method", "exact",
               "--particles", "256", "--checkpoint-format", fmt,
               "--outdir", str(tmp_path / "a")] + CPU)
    assert rc == 0
    run = _run_dir(tmp_path / "a")
    assert os.path.exists(os.path.join(run, "config.json"))
    assert os.path.exists(os.path.join(run, "metrics.jsonl"))
    assert_same_run(_final(run), mm_reference)
    ck = _step_file(run, 2)
    from smc_tpu_torch.runtime import native_available
    want_ext = {"npz": ".npz", "smcd": ".smcd",
                "auto": ".smck" if native_available() else ".npz"}[fmt]
    assert ck.endswith(want_ext)
    capsys.readouterr()
    rc = main(["resume", "--checkpoint", ck, "--model", "mm",
               "--mm-method", "exact", "--particles", "256",
               "--checkpoint-format", fmt,
               "--outdir", str(tmp_path / "b")] + CPU)
    assert rc == 0
    assert "gamma: 1.0" in capsys.readouterr().out
    resumed = _run_dir(tmp_path / "b")
    assert resumed.endswith("_mm_resume")
    assert_same_run(_final(resumed), mm_reference)


def test_cli_run_smcd_checkpoints_and_resume(tmp_path, capsys):
    """--checkpoint-format smcd writes streaming-slab directories per step
    and a final.smcd, and resume accepts the directory path."""
    rc = main(["run", "--model", "banana", "--particles", "256",
               "--checkpoint-format", "smcd",
               "--outdir", str(tmp_path / "a")] + CPU)
    assert rc == 0
    run = _run_dir(tmp_path / "a")
    final = os.path.join(run, "checkpoints", "final.smcd")
    assert os.path.isdir(final)
    assert os.path.exists(os.path.join(final, "particles.npy"))
    assert os.path.exists(os.path.join(final, "meta.json"))
    steps = [d for d in os.listdir(os.path.join(run, "checkpoints"))
             if d.startswith("step") and d.endswith(".smcd")]
    assert steps
    rc = main(["resume", "--checkpoint",
               os.path.join(run, "checkpoints", steps[0]),
               "--model", "banana", "--particles", "256",
               "--outdir", str(tmp_path / "b")] + CPU)
    assert rc == 0
    assert "gamma: 1.0" in capsys.readouterr().out


def test_cli_generate_data(tmp_path):
    rc = main(["generate-data", "--outdir", str(tmp_path / "d"),
               "--device", "cpu"])
    assert rc == 0
    for i in range(6):
        path = tmp_path / "d" / f"mm_pseudo_data_{i}.csv"
        assert os.path.exists(path)
        assert open(path).readline().strip() == "t,S_true,P_true,P_obs"
        arr = np.loadtxt(path, delimiter=",", skiprows=1)
        assert arr.shape == (40, 4)


def test_cli_ensemble(capsys):
    """Every population reports gamma=1 and a mean line; --method
    pallas_exact runs all populations through the batched kernel's entry
    (its plain version on the CPU)."""
    rc = main(["ensemble", "--datasets", "2", "--particles", "64",
               "--method", "pallas_exact", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "dataset 0: gamma=1.000" in out
    assert "dataset 1: gamma=1.000" in out


def test_cli_run_stop_file_preempts_and_resumes(tmp_path, capsys):
    """--stop-file present from the start: the run finalizes at once with
    its initial state (artifacts + checkpoint written), and a later
    'resume' without the stop file completes to gamma=1, bit-equal to the
    run that was never stopped."""
    stop = tmp_path / "STOP"
    stop.write_text("")
    rc = main(["run", "--model", "banana", "--particles", "256",
               "--stop-file", str(stop), "--outdir", str(tmp_path / "o")]
              + CPU)
    assert rc == 0
    assert "gamma: 0.0" in capsys.readouterr().out  # preempted at once
    ck = os.path.join(_run_dir(tmp_path / "o"), "checkpoints", "final.npz")
    assert os.path.exists(ck)
    os.remove(stop)
    rc = main(["resume", "--checkpoint", ck, "--model", "banana",
               "--particles", "256", "--outdir", str(tmp_path / "r")] + CPU)
    assert rc == 0
    assert "gamma: 1.0" in capsys.readouterr().out
    want = run_smc(BananaModel(device="cpu"), SMCConfig(n_particles=256), 0,
                   verbose=False)
    assert_same_run(_final(_run_dir(tmp_path / "r")), want)


def test_cli_sbc_mm(tmp_path, capsys):
    csv = str(tmp_path / "ranks.csv")
    rc = main(["sbc", "--model", "mm", "--replicates", "16",
               "--particles", "128", "--rank-draws", "31",
               "--ranks-csv", csv, "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "calibrated: True" in out
    assert "Vmax" in out and "chi2" in out
    with open(csv) as f:
        lines = f.read().strip().splitlines()
    assert lines[0] == "Vmax,Km,sigma"
    assert len(lines) == 1 + 16
    ranks = [int(v) for v in lines[1].split(",")]
    assert all(0 <= r <= 31 for r in ranks)


def test_cli_device_loop_and_profile(tmp_path, capsys):
    """--device-loop writes only the posterior CSV, the final particles of
    run_smc_on_device; --profile writes a torch.profiler trace."""
    from smc_tpu_torch import run_smc_on_device
    prof = tmp_path / "prof"
    rc = main(["run", "--model", "banana", "--particles", "256",
               "--device-loop", "--profile", str(prof),
               "--outdir", str(tmp_path / "o")] + CPU)
    assert rc == 0
    assert "gamma: 1.0" in capsys.readouterr().out
    run = _run_dir(tmp_path / "o")
    files = {os.path.relpath(os.path.join(d, f), run)
             for d, _, fs in os.walk(run) for f in fs}
    assert files == {"Posterior_Distribution.csv"}
    want = run_smc_on_device(BananaModel(device="cpu"),
                             SMCConfig(n_particles=256), 0)
    post = np.loadtxt(os.path.join(run, "Posterior_Distribution.csv"),
                      delimiter=",", skiprows=1, dtype=np.float32)
    assert np.array_equal(post, want.particles.numpy())
    assert len(glob.glob(str(prof / "trace_*.json"))) == 1


def test_cli_map(capsys):
    rc = main(["map", "--model", "mm", "--starts", "2", "--steps", "40",
               "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "log posterior (unnormalized)" in out
    assert "Vmax:" in out and "(true 1.2)" in out


# -- refusals ---------------------------------------------------------------

@pytest.mark.parametrize("argv,match", [
    (["run", "--model", "mm", "--mm-method", "pallas_exact", "--mutation",
      "mala"], "exact/rk4/dopri5"),
    (["run", "--model", "mm", "--mm-method", "pallas", "--mutation",
      "hmc"], "exact/rk4/dopri5"),
])
def test_gradient_kinds_refused_up_front(argv, match):
    """A gradient mutation on a likelihood the MM kernels compute exits
    before any model is built, as the JAX command's does."""
    with pytest.raises(SystemExit) as info:
        main(argv + ["--device", "cpu"])
    assert "needs a differentiable likelihood" in str(info.value)
    assert match in str(info.value)


@pytest.mark.parametrize("kind", ["mala", "hmc"])
def test_methanation_gradient_kinds_run(kind, tmp_path, capsys):
    """``run --model methanation --mutation mala|hmc`` runs, as the JAX
    command does (the default transient march differentiates through the
    block-Thomas kernels' route), at the smallest sizes the command takes,
    and ends bit-equal to ``run_smc`` with the same seed."""
    from smc_tpu_torch.models.methanation import MethanationModel
    rc = main(["run", "--model", "methanation", "--mutation", kind,
               "--conditions", "2", "--nx", "11", "--chunk", "4",
               "--particles", "4", "--max-steps", "1", "--mh-steps", "1",
               "--mh-steps-final", "1", "--hmc-leapfrog", "2",
               "--outdir", str(tmp_path)] + CPU)
    assert rc == 0
    m = MethanationModel.default(n_conditions=2, nx=11, particle_chunk=4,
                                 device="cpu")
    want = run_smc(m, SMCConfig(n_particles=4, max_steps=1, mh_steps=1,
                                mh_steps_final=1, mutation=kind,
                                hmc_leapfrog=2), 0, verbose=False)
    assert int(want.step) == 1
    assert_same_run(_final(_run_dir(tmp_path)), want)


@pytest.mark.parametrize("cmd", ["run", "ensemble"])
def test_ring_resampling_on_one_device_is_residual_systematic(cmd, tmp_path,
                                                              capsys):
    """--resampling ring without --mesh is the residual-systematic run, its
    output bit for bit (the ring redistributes across processes only;
    tests/test_torch_mesh_ops.py runs it on a mesh)."""
    argv = (["run", "--model", "mm", "--mm-method", "exact",
             "--particles", "128", "--max-steps", "3"] if cmd == "run" else
            ["ensemble", "--datasets", "2", "--particles", "64",
             "--max-steps", "3"])
    outs = []
    for extra in ([], ["--resampling", "ring"]):
        main(argv + extra + ["--outdir", str(tmp_path / str(len(outs)))]
             + CPU)
        outs.append(capsys.readouterr().out.split("artifacts:")[0])
    assert outs[0] == outs[1] and "gamma" in outs[0]


def test_run_with_artifacts_logs_the_error(tmp_path):
    """A run that raises keeps its traceback in error.log beside the
    artifacts, and the error passes through."""
    from smc_tpu_torch.io.rundir import RunDir
    from smc_tpu_torch.runner import run_with_artifacts
    calls = []

    class Failing(BananaModel):
        def log_likelihood(self, theta):    # the initial sweep, then fail
            calls.append(theta.shape)
            if len(calls) > 1:
                raise FloatingPointError("likelihood blew up")
            return super().log_likelihood(theta)

    rd = RunDir(root=str(tmp_path), tag="failing")
    with pytest.raises(FloatingPointError, match="blew up"):
        run_with_artifacts(Failing(device="cpu"), SMCConfig(n_particles=64),
                           0, rundir=rd, plots_enabled=False, verbose=False)
    with open(rd.file("error.log")) as f:
        assert "FloatingPointError: likelihood blew up" in f.read()
    assert os.path.exists(rd.file("pred", "first_p_pred.csv"))


def test_cuda_without_a_card_exits_nonzero(tmp_path, monkeypatch):
    """Without --device the command asks for the card; on a host without
    one it exits with resolve_device's message, in-process and as
    ``python -m smc_tpu_torch.cli`` (which imports no JAX)."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as info:
        main(["run", "--model", "banana", "--outdir", str(tmp_path)])
    assert "CUDA is not available" in str(info.value)
    assert os.listdir(tmp_path) == []
    code = ("import sys, runpy, torch; torch.cuda.is_available = "
            "lambda: False; sys.argv = ['smc-tpu-torch'] + sys.argv[1:]; "
            "runpy.run_module('smc_tpu_torch.cli', run_name='__main__')")
    out = subprocess.run(
        [sys.executable, "-c", code, "run", "--model", "banana",
         "--outdir", str(tmp_path)], cwd=ROOT, capture_output=True,
        text=True)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert os.listdir(tmp_path) == []


def test_python_m_cli_runs_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "smc_tpu_torch.cli", "run", "--model", "mm",
         "--mm-method", "exact", "--particles", "256", "--outdir",
         str(tmp_path)] + CPU, cwd=ROOT, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert "gamma: 1.0" in out.stdout

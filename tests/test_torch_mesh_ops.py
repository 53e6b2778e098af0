"""The operations layer over several processes: ``load_state(sharding=)``
from each checkpoint format, ``run_with_artifacts(mesh=)`` with its
resume, and the CLI's ``--mesh`` (run, resume, ensemble) and
``--resampling ring``, on a gloo world of two CPU ranks spawned once for
the file (tests/torch_mesh.py); ``cli.main`` runs inside the ranks, whose
process group is up as under ``torchrun``.
"""
import glob
import os

import numpy as np
import pytest

import tests.torch_parity  # noqa: F401  (one PyTorch thread per worker)
from smc_tpu_torch.cli import main
from smc_tpu_torch.models.michaelis_menten import generate_mm_pseudo_data
from tests.torch_mesh import load, ops_cases, run_world

RANKS = 2


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    ts, obs, s0 = generate_mm_pseudo_data()
    return run_world(tmp_path_factory.mktemp("mesh_ops"), RANKS, ops_cases,
                     dict(obs=obs, s0=s0, ts=ts))


@pytest.mark.parametrize("fmt", ["npz", "smck", "smcd"])
def test_load_state_reads_this_ranks_rows(world, fmt):
    """Each rank loads its rows of a whole-state checkpoint, bit-equal to
    shard_state of the state, with the run's generator state."""
    for r in range(RANKS):
        assert bool(load(world, f"load_r{r}")[fmt]), (fmt, r)


def test_run_with_artifacts_on_a_mesh_and_its_resume(world):
    """run_with_artifacts(mesh=): only rank 0 writes; every rank returns
    the whole final state; the run resumed on the mesh from its step-3
    checkpoint ends bit-equal to the uninterrupted run."""
    for r in range(RANKS):
        got = load(world, f"rwa_r{r}")
        assert str(got["rundir"]) == str(r == 0)
        for f in ("particles", "log_lik", "gamma", "step", "log_evidence"):
            np.testing.assert_array_equal(got["resumed_" + f],
                                          got["final_" + f])
        assert float(got["final_gamma"]) == 1.0
        assert got["final_particles"].shape == (256, 3)
    assert len(glob.glob(os.path.join(world, "rwa", "*", "checkpoints",
                                      "final.npz"))) == 1


def test_run_resilient_on_a_mesh_recovers_bit_equal(world):
    """run_resilient(psharding=) with the checkpoint named on rank 0 only:
    a failure every rank sees at step 2 reloads the step-2 checkpoint on
    both ranks, which go on in step and end bit-equal to the uninterrupted
    run on the mesh (run_with_artifacts' above)."""
    for r in range(RANKS):
        got = load(world, f"resilient_r{r}")
        seen = got["seen"].tolist()
        assert seen.count(1) == 1 and seen.count(2) == 1 and 3 in seen
        want = load(world, f"rwa_r{r}")
        for f in ("particles", "log_lik", "gamma", "step", "log_evidence",
                  "ess", "n_mh"):
            np.testing.assert_array_equal(got[f], want["final_" + f])
    assert os.path.exists(os.path.join(world, "resilient.npz"))


def _posterior(world, tag):
    (path,) = glob.glob(os.path.join(world, tag, "*",
                                     "Posterior_Distribution.csv"))
    return open(path).read()


def test_cli_mesh_run_and_ring(world):
    """--mesh 2 under a two-process world: rank 0 prints and writes the
    posterior, rank 1 neither; --resampling ring gives the same posterior
    bit for bit (the ring redistribution is exact)."""
    for tag in ("cli_default", "cli_ring"):
        out0, out1 = (load(world, f"{tag}_r{r}") for r in range(RANKS))
        assert int(out0["rc"]) == int(out1["rc"]) == 0
        assert "gamma: 1.0" in str(out0["stdout"])
        assert str(out1["stdout"]) == ""
    assert _posterior(world, "cli_default") == _posterior(world, "cli_ring")


def test_cli_mesh_resume_and_ensemble(world):
    for tag in ("cli_resume", "cli_ensemble"):
        out0, out1 = (load(world, f"{tag}_r{r}") for r in range(RANKS))
        assert int(out0["rc"]) == int(out1["rc"]) == 0
        assert str(out1["stdout"]) == ""
    assert "gamma: 1.0" in str(load(world, "cli_resume_r0")["stdout"])
    assert "dataset 1: gamma=1.000" in str(
        load(world, "cli_ensemble_r0")["stdout"])


@pytest.mark.parametrize("argv", [
    ["run", "--model", "banana", "--mesh", "2"],
    ["resume", "--checkpoint", "x.npz", "--model", "banana", "--mesh", "2"],
    ["ensemble", "--datasets", "2", "--mesh", "2"],
])
def test_mesh_without_its_processes_exits(argv, tmp_path, monkeypatch):
    """--mesh N outside a world of N processes exits nonzero, naming
    torchrun, before anything is written."""
    for v in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(v, raising=False)
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2"):
        main(argv + ["--outdir", str(tmp_path), "--device", "cpu"])
    assert os.listdir(tmp_path) == []

"""Multi-process helpers of the PyTorch port
(``smc_tpu_torch/parallel/multihost.py``): failure semantics and
primary-process IO gating, the counterpart of ``tests/test_multihost.py``.

The failure cases monkeypatch ``torch.distributed``; one real gloo group of
world size 1 on a local TCP store checks the explicit path end to end.
"""
import os
import socket

import pytest
import torch.distributed as dist

import tests.torch_parity  # noqa: F401  (one PyTorch thread per worker)
from smc_tpu_torch.parallel import multihost


@pytest.fixture
def no_cluster(monkeypatch):
    for v in multihost.TORCHRUN_ENV + ("LOCAL_RANK",):
        monkeypatch.delenv(v, raising=False)


def _refuse(**kw):
    raise AssertionError(f"init_process_group called with {kw}")


def test_autodetect_miss_is_single_process_noop(no_cluster, monkeypatch):
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: _refuse(**kw))
    assert multihost.initialize_distributed(device="cpu") == 1
    assert multihost.is_primary_host()


def test_double_initialize_is_idempotent(no_cluster, monkeypatch):
    """A group already up: nothing is initialized again, and the world
    size is the group's."""
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: _refuse(**kw))
    assert multihost.initialize_distributed(device="cpu") == 4
    assert multihost.initialize_distributed(
        "127.0.0.1:1234", 4, 0, device="cpu") == 4


def test_real_init_failure_raises(no_cluster, monkeypatch):
    """A full torchrun environment whose store cannot be reached raises."""
    for k, v in (("MASTER_ADDR", "10.0.0.1"), ("MASTER_PORT", "1234"),
                 ("WORLD_SIZE", "2"), ("RANK", "0")):
        monkeypatch.setenv(k, v)
    seen = {}

    def fake_init(backend, **kw):
        seen.update(kw, backend=backend)
        raise RuntimeError("failed to connect to the store at 10.0.0.1:1234")
    monkeypatch.setattr(dist, "init_process_group", fake_init)
    with pytest.raises(RuntimeError, match="store"):
        multihost.initialize_distributed(device="cpu")
    assert seen == {"backend": "gloo", "init_method": "env://"}


def test_partial_torchrun_environment_raises(no_cluster, monkeypatch):
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: _refuse(**kw))
    with pytest.raises(ValueError, match="partial torchrun environment"):
        multihost.initialize_distributed(device="cpu")


def test_explicit_args_failure_raises(no_cluster, monkeypatch):
    """With explicit arguments any failure is raised: the caller asked for
    a process group and must not get a silent single-process run."""
    seen = {}

    def fake_init(backend, **kw):
        seen.update(kw, backend=backend)
        raise ValueError("bad init_method")
    monkeypatch.setattr(dist, "init_process_group", fake_init)
    with pytest.raises(ValueError, match="bad init_method"):
        multihost.initialize_distributed("10.0.0.1:1234", 2, 0,
                                         device="cpu")
    assert seen == {"backend": "gloo", "init_method": "tcp://10.0.0.1:1234",
                    "world_size": 2, "rank": 0}
    with pytest.raises(ValueError, match="together"):
        multihost.initialize_distributed("10.0.0.1:1234", device="cpu")


def test_is_primary_host(monkeypatch):
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 0)
    assert multihost.is_primary_host()
    monkeypatch.setattr(dist, "get_rank", lambda: 3)
    assert not multihost.is_primary_host()


def test_run_with_artifacts_non_primary_writes_nothing(monkeypatch,
                                                       tmp_path):
    """A non-primary process runs the SMC compute but creates no run dir,
    writes no files, and returns rundir=None."""
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.chdir(tmp_path)

    from smc_tpu_torch.config import SMCConfig
    from smc_tpu_torch.models.synthetic import BananaModel
    from smc_tpu_torch.runner import run_with_artifacts

    state, rd = run_with_artifacts(
        BananaModel(device="cpu"), SMCConfig(n_particles=128), 0,
        verbose=False)
    assert rd is None
    assert float(state.gamma) == 1.0
    assert os.listdir(tmp_path) == []  # nothing written anywhere under cwd


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def gloo_group(no_cluster):
    yield f"tcp://127.0.0.1:{_free_port()}"
    if dist.is_initialized():
        dist.destroy_process_group()


def test_real_gloo_group_of_one(gloo_group):
    """Explicit arguments start a real gloo group (world size 1 on a local
    TCP store); a second call changes nothing; rank 0 is primary."""
    assert multihost.initialize_distributed(gloo_group, 1, 0,
                                            device="cpu") == 1
    assert dist.is_initialized() and dist.get_backend() == "gloo"
    group = dist.group.WORLD
    assert multihost.initialize_distributed(device="cpu") == 1
    assert dist.group.WORLD is group
    assert multihost.is_primary_host()

"""The port's host spans and capture counters on the CPU's eager pieces
(``smc_tpu_torch/utils/metrics.py``, ``smc/graphs.py``): nothing is
recorded without a profiler session, and a run is the same with one; inside
``profile_trace`` the spans nest run, then step or piece, then launch, and
carry their run's id; the read spans are the counted host reads, named by
the loop that reads; each step's sweep spans are its ``n_mh``; every span
is a host event of the profiler's. Then the benchmark's six readers of
these records (``portbench/metrics``) against numbers worked out by hand
on a small synthetic record."""
import json
import os
from types import SimpleNamespace

import pytest
import torch

from smc_tpu_torch import (SMCConfig, init_state, make_full_run_on_device,
                           make_smc_step, run_smc)
from smc_tpu_torch.models.michaelis_menten import (MichaelisMentenModel,
                                                   make_mm_data_loglik)
from smc_tpu_torch.smc import graphs
from smc_tpu_torch.smc.ensemble import make_ensemble_run
from smc_tpu_torch.utils import metrics
from smc_tpu_torch.utils.metrics import profile_trace

FIELDS = ("particles", "log_lik", "gamma", "step", "ess", "n_mh",
          "accepted", "total_lik_evals", "log_evidence")
CFG = SMCConfig(n_particles=256)


@pytest.fixture(scope="module")
def mm():
    return MichaelisMentenModel.default(method="pallas_exact", device="cpu")


def _traced(fn, logdir):
    """``fn()`` inside ``profile_trace(logdir)``: (result, the spans, the
    profiler, the host reads it counted)."""
    reads = graphs.stats["host_reads"]
    with profile_trace(str(logdir)) as prof:
        out = fn()
    return out, list(metrics.spans), prof, graphs.stats["host_reads"] - reads


def _named(rec, prefix):
    return [s for s in rec if s.name.startswith(prefix)]


def test_without_a_session_nothing_is_recorded_and_the_run_is_the_same(
        mm, tmp_path):
    run = make_full_run_on_device(mm, CFG)
    metrics.clear_spans()
    assert not torch.autograd.profiler._is_profiler_enabled
    assert metrics.span("smc.launch") is metrics.span("smc.read.step")
    plain = run(3)
    assert metrics.spans == []
    traced, rec, _, _ = _traced(lambda: run(3), tmp_path)
    again = run(3)
    assert rec and len(metrics.spans) == len(rec)
    for f in FIELDS:
        assert torch.equal(getattr(plain, f), getattr(traced, f)), f
        assert torch.equal(getattr(plain, f), getattr(again, f)), f


def test_a_full_run_nests_run_piece_and_read_under_one_id(mm, tmp_path):
    run = make_full_run_on_device(mm, CFG)
    s, rec, prof, reads = _traced(lambda: run(5), tmp_path)
    top = [i for i, x in enumerate(rec) if x.parent == -1]
    assert [rec[i].name for i in top] == ["smc.run"]
    rid = rec[top[0]].run
    assert rid is not None and all(x.run == rid for x in rec)
    for x in rec:
        assert x.start <= x.end
        if x.parent >= 0:
            p = rec[x.parent]
            assert p.start <= x.start and x.end <= p.end
        if x.name.startswith(("smc.piece.", "smc.read.")):
            assert rec[x.parent].name == "smc.run"
    steps = int(s.step)
    # one read per check of the step loop: each step's, and the last
    assert len(_named(rec, "smc.read.step")) == steps + 1
    assert len(_named(rec, "smc.read.")) == reads
    assert len(_named(rec, "smc.piece.init")) == 1
    assert len(_named(rec, "smc.piece.finish")) == steps
    # the eager pieces launch no graph
    assert not _named(rec, "smc.launch")
    assert {"smc.run", "smc.piece.prep", "smc.piece.mut_init",
            "smc.piece.mut_sweep", "smc.piece.finish",
            "smc.read.sweep"} <= {x.name for x in rec}


def test_every_span_is_a_host_event_of_the_session(mm, tmp_path):
    from torch.autograd import DeviceType
    run = make_full_run_on_device(mm, CFG)
    _, rec, prof, _ = _traced(lambda: run(7), tmp_path)
    events = {}
    for e in prof.events():
        events.setdefault(e.name, []).append(e.device_type)
    for name in {x.name for x in rec}:
        assert set(events.get(name, ())) == {DeviceType.CPU}, name
        assert len(events[name]) == sum(1 for y in rec if y.name == name)
    (trace,) = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    with open(tmp_path / trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {x.name for x in rec} <= names


def test_each_steps_sweep_spans_are_its_n_mh(mm, tmp_path):
    step = make_smc_step(mm, CFG)

    def steps():
        s = init_state(11, mm, CFG)
        out = []
        while float(s.gamma) < 1.0:
            s = step(s)
            out.append(int(s.n_mh))
        return out
    n_mh, rec, _, reads = _traced(steps, tmp_path)
    stepped = [i for i, x in enumerate(rec) if x.name == "smc.step"]
    assert len(stepped) == len(n_mh) > 1
    for i, want in zip(stepped, n_mh):
        kids = [x.name for x in rec if x.parent == i]
        assert kids.count("smc.piece.mut_init") + \
            kids.count("smc.piece.mut_sweep") == want
        assert kids.count("smc.read.sweep") == want
        assert all(x.run is None for x in rec)
    assert len(_named(rec, "smc.read.")) == reads
    assert len(_named(rec, "smc.init_state")) == 1


@pytest.mark.parametrize("granularity", ["step", "sweep", "block"])
def test_run_smc_reads_are_its_read_spans(mm, tmp_path, granularity):
    cfg = CFG.replace(block_particles=128)
    s, rec, _, reads = _traced(
        lambda: run_smc(mm, cfg, 2, verbose=False,
                        granularity=granularity), tmp_path)
    assert len(_named(rec, "smc.read.")) == reads
    assert len(_named(rec, "smc.read.step")) == int(s.step) + 1
    runs = _named(rec, "smc.run")
    assert len(runs) == 1
    assert all(x.run == runs[0].run for x in rec
               if x.name != "smc.init_state")
    if granularity == "block":
        assert len(_named(rec, "smc.piece.core")) == \
            2 * len(_named(rec, "smc.piece.draw"))
        assert len(_named(rec, "smc.piece.admin")) == \
            len(_named(rec, "smc.piece.draw"))


def test_an_ensemble_run_records_its_reads_and_pieces(mm, tmp_path):
    d = 3
    g = torch.Generator().manual_seed(0)
    data = mm.obs[None] + 0.02 * torch.randn((d,) + mm.obs.shape,
                                             generator=g)
    run = make_ensemble_run(mm.prior, make_mm_data_loglik(
        mm.ts, mm.s0, method="pallas_exact"), d, CFG)
    s, rec, _, reads = _traced(lambda: run(0, data), tmp_path)
    assert len(_named(rec, "smc.read.")) == reads
    assert len(_named(rec, "smc.read.step")) == int(s.step.max()) + 1
    assert len(_named(rec, "smc.run")) == 1
    assert len(_named(rec, "smc.piece.finish")) == int(s.step.max())
    assert len({x.run for x in rec}) == 1


def test_the_record_is_cleared_when_a_session_starts(mm, tmp_path):
    run = make_full_run_on_device(mm, CFG)
    _, first, _, _ = _traced(lambda: run(1), tmp_path / "a")
    _, second, _, _ = _traced(lambda: run(1), tmp_path / "b")
    assert [x.name for x in first] == [x.name for x in second]
    assert second[0].run != first[0].run


def test_reset_stats_keeps_each_counters_kind():
    graphs.stats["piece_replays"]["prep"] = 3
    graphs.stats["shapes"].append({"pieces": {}, "pool_bytes": 1})
    graphs.reset_stats()
    assert graphs.stats == {"host_reads": 0, "replays": 0,
                            "piece_replays": {}, "captures": 0,
                            "capture_seconds": 0.0, "shapes": []}


# ---- the benchmark's readers on a synthetic record ------------------------

def _span(name, start, end, parent, run=1):
    s = metrics.Span.__new__(metrics.Span)
    s.name, s.start, s.end, s.parent, s.run = name, start, end, parent, run
    return s


# Two posteriors in 10 ms (times in microseconds, as ns x 1000): a run of
# 9,000 us holding a read, two pieces with a launch each, two sweep reads,
# and a finish; a second run of one piece. By hand: launches 300 + 500 +
# 200 + 100 = 1,100 us; reads 400 + 100 + 150 + 50 = 700 us; the runs'
# self time 9,000 - (400 + 2,000 + 100 + 1,000 + 150 + 500) = 4,850 and
# 1,000 - (300 + 50) = 650, the pieces' 2,000 - 800 + 1,000 - 200
# + 500 - 100 = 2,400 and 300, so loop self 8,200 us; sweeps 2 over 2
# finishes.
_US = 1000
_RECORD = [
    ("smc.run", 0, 9000, -1),
    ("smc.read.step", 0, 400, 0),
    ("smc.piece.mut_init", 500, 2500, 0),
    ("smc.launch", 600, 900, 2),
    ("smc.launch", 1000, 1500, 2),
    ("smc.read.sweep", 2600, 2700, 0),
    ("smc.piece.finish", 3000, 4000, 0),
    ("smc.launch", 3100, 3300, 6),
    ("smc.read.sweep", 4100, 4250, 0),
    ("smc.piece.finish", 5000, 5500, 0),
    ("smc.launch", 5100, 5200, 9),
    ("smc.run", 10000, 11000, -1),
    ("smc.piece.mut_sweep", 10100, 10400, 11),
    ("smc.read.step", 10500, 10550, 11),
]
_SHAPES = [{"pieces": {"prep": [0.5, 0.25], "mut_sweep": [1.0, 0.125]},
            "pool_bytes": 3 * 2 ** 28},
           {"pieces": {"finish": [2.0, 0.125]}, "pool_bytes": 2 ** 28}]


@pytest.mark.parametrize("name,want", [
    ("launch_ms_per_posterior", 1.1 / 2),
    ("read_wait_ms_per_posterior", 0.7 / 2),
    ("loop_self_ms_per_posterior", 8.2 / 2),
    ("sweeps_per_step", 2 / 2),
    ("capture_s", 4.0),
    ("graph_pool_gib", 1.0),
])
def test_the_benchmarks_readers_on_a_synthetic_record(monkeypatch, name,
                                                      want):
    from portbench.harness import spec
    monkeypatch.setattr(metrics, "spans", [
        _span(n, a * _US, b * _US, p) for n, a, b, p in _RECORD])
    monkeypatch.setitem(graphs.stats, "shapes", _SHAPES)
    run = SimpleNamespace(slice={"posteriors": 2, "window_s": 0.01},
                          posteriors=5)
    assert spec.module("metrics", name).read(run) == pytest.approx(
        want, rel=1e-12)
    # nothing to read: no record (or no capture), or no traced slice
    monkeypatch.setattr(metrics, "spans", [])
    monkeypatch.setitem(graphs.stats, "shapes", [])
    assert spec.module("metrics", name).read(run) is None

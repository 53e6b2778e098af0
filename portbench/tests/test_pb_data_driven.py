"""The benchmark is driven by data: every name in BENCHMARK.json finds a
file of its own, and a new cell or metric needs new files only."""
import json
import shutil
import time

import pytest

from portbench.harness import cell, spec


def test_every_name_finds_its_file():
    b = spec.benchmark()
    for c in b["configs"]:
        assert (spec.ROOT / c["file"]).is_file()
    for w in b["workloads"]:
        assert (spec.PB / "traffic" / f"{w['traffic']}.json").is_file()
        c = spec.cell(w["name"], b)
        assert c["traffic"]["driver"] in ("full_run", "ensemble", "steps")
        assert set(c["traffic"]["check"]["limits"])
    for m in b["end_to_end"] + b["per_layer"]:
        mod = spec.module("metrics", m["name"])
        assert mod.UNIT == m["unit"] and mod.SOURCE == m["source"]
        if "layer" in m:
            assert mod.LAYER == m["layer"] and mod.MOVES == m["moves"]
    for name in ("mm_loglik", "thomas"):
        assert callable(spec.module("costs", name).work)


def test_each_cell_reports_its_metrics():
    b = spec.benchmark()
    e2e = {m["name"] for m in b["end_to_end"]}
    for w in b["workloads"]:
        mine = {m["name"] for m in spec.metrics_for(w["name"], False, b)}
        assert "setup_s" in mine and len(mine) >= 2 and mine <= e2e
        layers = spec.metrics_for(w["name"], True, b)
        assert layers and all(m["moves"] in mine for m in layers)


@pytest.fixture
def copy_of_benchmark(tmp_path, monkeypatch):
    """The benchmark's files in a directory of their own, which the
    harness then reads."""
    shutil.copytree(spec.PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    monkeypatch.setattr(spec, "PB", tmp_path / "portbench")
    return tmp_path


def test_a_new_cell_and_metric_need_only_new_files(copy_of_benchmark):
    root = copy_of_benchmark
    traffic = json.loads((root / "portbench/traffic/rwm-n1e5.json")
                         .read_text())
    traffic.update(n_particles=512)
    traffic["check"]["particles"] = 64
    (root / "portbench/traffic/rwm-n512.json").write_text(
        json.dumps(traffic))
    (root / "portbench/metrics/requests_in_window.py").write_text(
        'LAYER = "run loop"\n'
        'UNIT, SOURCE, MOVES = "requests", "program_counter", '
        '"posteriors_per_s"\n\n\n'
        'def read(run):\n    return float(run.requests)\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(name="mm-rwm-n512", config="mm",
                                   traffic="rwm-n512", chips=1, why="test"))
    for m in bench["end_to_end"]:
        if "workloads" in m and "mm-rwm-n1e5" in m["workloads"]:
            m["workloads"].append("mm-rwm-n512")
    bench["per_layer"].append(dict(
        name="requests_in_window", unit="requests", better="higher",
        source="program_counter", layer="run loop",
        moves="posteriors_per_s"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    names = {m["name"] for m in spec.metrics_for("mm-rwm-n512", True)}
    assert "requests_in_window" in names
    out = cell.run_cell("mm-rwm-n512", 9, 0.5, False, "cpu",
                        time.perf_counter())
    assert out["attempted"] >= 1
    assert set(out["metrics"]) == {"setup_s", "posteriors_per_s",
                                   "posterior_ms_p95", "evals_per_s",
                                   "peak_mem_gib"}
    assert list(out)[-1] == "checks"
    # Traced (on the CPU: no slice, so the device's readers read nothing
    # and are left out), the new reader reports.
    out = cell.run_cell("mm-rwm-n512", 9, 0.5, True, "cpu",
                        time.perf_counter())
    got = out["metrics"]["requests_in_window"]
    assert got == {"value": float(out["attempted"]), "unit": "requests"}
    assert "mm_loglik_roofline" not in out["metrics"]

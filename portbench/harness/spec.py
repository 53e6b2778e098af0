"""Where the benchmark's data lives, and how a name finds its file.

``BENCHMARK.json`` at the checkout's root names the cells; everything of
one configuration, traffic mix, metric or kernel's work count is a file
of its own under ``portbench/``, found by its name:

- ``configs/<config>.json``: a deployment's sizes and settings;
- ``traffic/<traffic>.json``: a traffic mix's parameters;
- ``metrics/<metric>.py``: the reader of one metric (``read(run)``);
- ``costs/<name>.py``: the work of one kernel's launch (``work(kernel,
  shape)``), counted from the algorithm;
- ``reference/<model>.py``: a model's plain reference.

Nothing here imports the program.
"""
from __future__ import annotations

import copy
import importlib.util
import json
from pathlib import Path

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def cell(name: str, bench: dict | None = None,
         overrides: dict | None = None) -> dict:
    """The cell ``name`` of BENCHMARK.json with its configuration and
    traffic files read: ``{"name", "chips", "config": {...}, "traffic":
    {...}}``. ``overrides`` (tests) are merged into the two files."""
    bench = bench or benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    cfg_file = next(c["file"] for c in bench["configs"]
                    if c["name"] == w["config"])
    over = overrides or {}
    return dict(
        name=name, chips=w["chips"], config_name=w["config"],
        traffic_name=w["traffic"],
        config=_merge(load_json(ROOT / cfg_file), over.get("config")),
        traffic=_merge(load_json(PB / "traffic" / f"{w['traffic']}.json"),
                       over.get("traffic")))


def metrics_for(name: str, trace: bool, bench: dict | None = None) -> list:
    """The metric entries a run of cell ``name`` reports: its end-to-end
    metrics with ``trace`` off, its per-layer metrics with it on. A
    metric with a ``workloads`` key belongs to the cells it lists; an
    end-to-end one without it to every cell; a per-layer one without it
    to every cell that reports the end-to-end metric it moves."""
    bench = bench or benchmark()
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in mine)]


def module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots and
    dashes, so it is loaded from its path)."""
    path = PB / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name}".replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def peaks() -> dict:
    return load_json(PB / "peaks.json")

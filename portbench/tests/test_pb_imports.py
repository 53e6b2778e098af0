"""Nothing the benchmark runs loads JAX or the JAX package: a scan of
every module of ``portbench/`` and a run of a cell in a fresh process.
Top-level names are compared whole, so ``smc_tpu_torch`` passes and
``smc_tpu`` does not."""
import ast
import json
import subprocess
import sys
from pathlib import Path

from portbench.harness import cell

PB = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "smc_tpu"}


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_of_the_benchmark_imports_jax():
    files = sorted(PB.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not _imports(f) & FORBIDDEN, f


def test_references_import_nothing_of_the_program():
    for f in (PB / "reference").glob("*.py"):
        assert "smc_tpu_torch" not in _imports(f), f
    users = {f.relative_to(PB).as_posix() for f in PB.rglob("*.py")
             if "smc_tpu_torch" in _imports(f)
             and f.parent.name != "tests"}
    assert users == {"harness/program.py"}


def test_the_check_compares_top_level_names_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "smc_tpu_torch_like", sys)
    assert "smc_tpu" not in cell.forbidden_modules()
    monkeypatch.setitem(sys.modules, "smc_tpu.ops", sys)
    assert "smc_tpu" in cell.forbidden_modules()


def test_a_run_loads_no_jax():
    code = f"""
import json, sys, time
sys.path.insert(0, {str(PB.parent)!r})
from portbench.harness import cell
out = cell.run_cell("mm-rwm-n1e5", 5, 0.5, False, "cpu",
                    time.perf_counter(), overrides={{"traffic": {{
                        "n_particles": 256, "check": {{"particles": 16}}}}}})
print(json.dumps(cell.forbidden_modules()))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []

"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the NVIDIA GPUs the cell
asks for. The last line of standard output is one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), device, with --trace 1 breakdown, and
last checks (each number compared, beside its limit), which the last
lines of standard error repeat. Exits non-zero, with no result, when the
cards are missing or when JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    os.chdir(ROOT)
    from portbench.harness import cell as harness, spec
    bench = spec.benchmark()
    chips = spec.cell(args.workload, bench)["chips"]

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: cell {args.workload} needs {chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    print("portbench: " + _card(), file=sys.stderr, flush=True)
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", T_START, bench=bench)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


def _card() -> str:
    """The card's name and power limit, beside which every share of a
    published peak is read."""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


if __name__ == "__main__":
    sys.exit(main())

"""The control of ``correct``: the plain reference put in the program's
place, computed one precision below the configuration's float32
(bfloat16), read through the same comparisons as the program.

    python3 portbench/control.py --workload <name> --seeds 1 2 3 \
        --seconds <s> [--controls <k>]

For each seed one short window of the program at the cell's own size is
run (its inputs made exactly as a benchmark run makes them), then both
sides are read: the program's numbers, and the control's, which claims
the log-likelihoods (and in a gradient cell their gradients) at the same
particles, the gamma search's results on the same input
log-likelihoods, and (the Michaelis-Menten cells) each sampled
posterior's mean log-likelihood by the reference's quadrature in
bfloat16. One JSON
line per seed and side. The benchmark's own runs never run this; a limit
lies between the program's largest reading and the control's smallest.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(name, seed, seconds, device, overrides=None, control=True):
    """{"program": numbers, "control": numbers} of one seed (without the
    control's when ``control`` is false)."""
    import gc

    import torch

    from portbench.harness import cell, drivers, spec
    c = spec.cell(name, overrides=overrides)
    dev = torch.device(device)
    drv = drivers.DRIVERS[c["traffic"]["driver"]](c, seed, dev)
    drv.warm()
    cell._window(drv, seconds, c["traffic"]["trace"], False)
    drv.free()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out = {"program": drv.numbers()}
    if control:
        out["control"] = drv.numbers(control=torch.bfloat16)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--controls", type=int, default=None,
                    help="read the control on the first this many seeds "
                    "only (default: every seed)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        got = readings(args.workload, seed, args.seconds, "cuda",
                       control=args.controls is None or i < args.controls)
        for side, nums in got.items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "side": side, "numbers": nums,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

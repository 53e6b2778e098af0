"""The benchmark's tests run on the CPU at small sizes; ``ROOT`` on the
path makes ``portbench`` importable."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Sizes a test run holds on the CPU: the same paths and checks, fewer
# particles, populations, kept requests, a coarser grid and fewer
# conditions. A posterior of a few hundred particles strays from the
# exact one by as much as a broken step does, so the Michaelis-Menten
# posteriors keep thousands.
SMALL = {
    "mm-rwm-n1e5": {"traffic": {"n_particles": 4096,
                                "check": {"requests": 1,
                                          "particles": 64}}},
    "mm-ensemble-64x2048": {"traffic": {"n_populations": 2,
                                        "check": {"requests": 1,
                                                  "particles": 32}}},
    "methanation-rwm-n1000": {
        "config": {"nx": 11, "n_conditions": 3,
                   "march": {"n_steps": 12, "growth": 1.6, "jac_stride": 3,
                             "dense_tail": 3}},
        "traffic": {"n_particles": 32, "check": {"particles": 4}}},
}
SMALL["methanation-mala-n1000"] = {
    "config": SMALL["methanation-rwm-n1000"]["config"],
    "traffic": {"n_particles": 32,
                "check": {"particles": 4, "grad_steps": 2,
                          "grad_particles": 4}}}

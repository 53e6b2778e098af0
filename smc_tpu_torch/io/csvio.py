"""Posterior persistence as CSV (PyTorch port of ``smc_tpu.io.csvio``):
the named-column posterior file and the raw particle file. Particles may
be tensors on any device or arrays."""
from __future__ import annotations

import numpy as np
import torch


def _host(particles) -> np.ndarray:
    if isinstance(particles, torch.Tensor):
        return particles.detach().cpu().numpy()
    return np.asarray(particles)


def save_particles_csv(path: str, particles) -> None:
    np.savetxt(path, _host(particles), delimiter=",")


def save_posterior_csv(path: str, particles, param_names) -> None:
    header = ",".join(param_names)
    np.savetxt(path, _host(particles), delimiter=",", header=header,
               comments="")


def load_particles_csv(path: str) -> np.ndarray:
    with open(path) as fh:
        first = fh.readline()
    skip = 0 if first.lstrip()[:1] in "-+.0123456789" else 1
    return np.loadtxt(path, delimiter=",", skiprows=skip)

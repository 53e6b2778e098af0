"""Every input of a run, made by the benchmark from ``--seed``.

A seed is any whole number; ``derive(seed, *path)`` turns it and a path
of labels into an independent 63-bit seed (NumPy's SeedSequence), so
the same seed gives the same inputs and no two uses share a stream. The
observations are made from the configuration's truth by the plain
reference, then handed, as float32, to the program and the reference
alike.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch


def derive(seed: int, *path) -> int:
    words = [int(seed) % (1 << 64), int(seed) >> 64]
    for p in path:
        words.append(p if isinstance(p, int) else zlib.crc32(str(p).encode()))
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0] >> 1)


def rng(seed: int, *path) -> np.random.Generator:
    return np.random.default_rng(derive(seed, *path))


def generator(seed: int, device, *path) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, *path))
    return g


# ---- Michaelis-Menten --------------------------------------------------
def mm_grid(cfg: dict):
    """(ts (T,), s0 (n_ds,)) float64 NumPy arrays."""
    ts = np.linspace(cfg["t_span"][0], cfg["t_span"][1], cfg["n_points"])
    return ts, np.asarray(cfg["s0"], np.float64)


def mm_truth(cfg: dict) -> np.ndarray:
    """The noise-free product (n_ds, T) at the configuration's truth."""
    from portbench.reference import mm
    ts, s0 = mm_grid(cfg)
    tp = cfg["true_params"]
    return mm.true_product_numpy(tp["vmax"], tp["km"], s0, ts)


def mm_obs(cfg: dict, truth: np.ndarray, gen: torch.Generator,
           pops: int | None, device) -> torch.Tensor:
    """float32 observations: the truth plus N(0, noise_std^2) noise drawn
    on ``device`` from ``gen``; (n_ds, T), or (pops, n_ds, T)."""
    shape = truth.shape if pops is None else (pops,) + truth.shape
    noise = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float64)
    t = torch.as_tensor(truth, device=device)
    return (t + cfg["true_params"]["noise_std"] * noise).to(torch.float32)


# ---- methanation -------------------------------------------------------
def methanation_conditions(cfg: dict) -> dict:
    from portbench.reference import methanation
    return methanation.condition_table(cfg["n_conditions"], cfg["nx"])


def march_settings(cfg: dict) -> dict:
    m = dict(cfg["march"])
    m.update(nx=cfg["nx"], kin_true=list(cfg["kin_true"]),
             sigma_true=cfg["sigma_true"], est_idx=list(cfg["est_idx"]))
    return m


def methanation_obs(cfg: dict, seed: int) -> np.ndarray:
    """float32 observed outlet flows (5, n_conditions): the reference's
    float64 march at the true parameters (on the host) plus
    N(0, sigma_true^2) noise from the seed."""
    from portbench.reference import methanation
    kin = torch.tensor([cfg["kin_true"]], dtype=torch.float64)
    flows = methanation.outlet_flows(kin, methanation_conditions(cfg),
                                     march_settings(cfg))[0].numpy()
    noise = rng(seed, "methanation-obs").standard_normal(flows.shape)
    return (flows + cfg["sigma_true"] * noise).astype(np.float32)

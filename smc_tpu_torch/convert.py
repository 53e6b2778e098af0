"""Carry data across from NumPy: priors, models and sampler states.

This system has no weights. What crosses between the JAX package and this
one is a model's data and prior and a sampler's state, as NumPy arrays;
nothing here imports JAX. A JAX state's ``key`` (threefry key data) cannot
drive a ``torch.Generator``: it seeds a fresh ``TorchDraws`` instead, or the
caller passes the ``Draws`` to continue with.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from smc_tpu_torch.config import resolve_device
from smc_tpu_torch.models.michaelis_menten import MichaelisMentenModel
from smc_tpu_torch.priors import Prior
from smc_tpu_torch.rng import TorchDraws
from smc_tpu_torch.smc.state import SMCState

STATE_FIELDS = tuple(f.name for f in dataclasses.fields(SMCState))
_INT_FIELDS = ("step", "n_mh", "accepted", "n_gamma_reductions")


def prior_from_numpy(kind, low, high, loc, scale, device="cuda") -> Prior:
    """A Prior from per-dimension arrays (kind: 0 uniform, 1 normal)."""
    dev = resolve_device(device)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
    return Prior(kind=t(kind, torch.int32), low=t(low, torch.float32),
                 high=t(high, torch.float32), loc=t(loc, torch.float32),
                 scale=t(scale, torch.float32))


def mm_model_from_numpy(obs, s0, ts, prior, method: str = "rk4",
                        substeps: int = 4, est_sigma: bool = True,
                        sigma_fixed: float = 0.02, device="cuda"
                        ) -> MichaelisMentenModel:
    """A Michaelis-Menten model from obs (n_ds, T), s0 (n_ds,), ts (T,) and
    a prior: a port ``Prior`` or a mapping of the five prior arrays."""
    dev = resolve_device(device)
    if isinstance(prior, Mapping):
        prior = prior_from_numpy(device=dev, **prior)
    else:
        prior = prior.to(dev)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return MichaelisMentenModel(obs=f32(obs), s0=f32(s0), ts=f32(ts),
                                prior=prior, method=method,
                                substeps=substeps, est_sigma=est_sigma,
                                sigma_fixed=float(sigma_fixed))


def state_to_numpy(state: SMCState) -> dict:
    """The 13 fields as NumPy arrays; ``key`` becomes the generator state
    (uint8) of the state's ``TorchDraws``."""
    out = {f: getattr(state, f).detach().cpu().numpy()
           for f in STATE_FIELDS if f != "key"}
    out["key"] = state.key.get_state()
    return out


def state_from_numpy(d: Mapping, device="cuda",
                     draws: Optional[object] = None) -> SMCState:
    """An SMCState from a mapping of the 13 fields (NumPy arrays or
    scalars). ``key``: ``draws`` when given; else a uint8 generator state
    (from :func:`state_to_numpy`) is restored, and any other array (such as
    JAX key data) seeds a new ``TorchDraws`` from its bytes."""
    dev = resolve_device(device)
    missing = set(STATE_FIELDS) - set(d)
    if missing:
        raise KeyError(f"state fields missing: {sorted(missing)}")
    if draws is None:
        raw = np.asarray(d["key"])
        if raw.dtype == np.uint8:
            draws = TorchDraws(0, dev).set_state(raw)
        else:
            seed = int.from_bytes(raw.tobytes()[:8].ljust(8, b"\0"),
                                  "little") & (2 ** 63 - 1)
            draws = TorchDraws(seed, dev)
    fields = {}
    for f in STATE_FIELDS:
        if f == "key":
            continue
        a = np.asarray(d[f])
        dtype = torch.int32 if f in _INT_FIELDS else torch.float32
        fields[f] = torch.tensor(a, dtype=dtype, device=dev)
    return SMCState(key=draws, **fields)

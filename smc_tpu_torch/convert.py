"""Carry data across from NumPy: priors, models, sampler states and MAP
results.

This system has no weights. What crosses between the JAX package and this
one is a model's data and prior and a sampler's state, as NumPy arrays;
nothing here imports JAX.

The ``key`` field. The JAX state holds threefry key data (uint32, (2,) or
(D, 2) for an ensemble); the port's holds a ``TorchDraws``, whose
``torch.Generator`` state is uint8 bytes (16 on CUDA, 5,056 on the CPU).
A key array is read by one rule (:func:`draws_from_key`):

- uint8 bytes (:func:`state_to_numpy`) restore the generator exactly;
- uint32 words that open with :data:`KEY_TAG` (:func:`key_to_words`, what
  the checkpoint files hold, since the ``.smck`` container has no uint8
  code) restore it exactly too: ``[KEY_TAG, n_bytes, the n_bytes packed
  little-endian into words, zero-padded]``;
- anything else (JAX key data) cannot drive a ``torch.Generator``: its
  bytes seed a fresh ``TorchDraws``, or the caller passes the ``Draws`` to
  continue with.

A JAX key is never mistaken for a generator state: it has two words per
row, and a tagged key has at least three.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from smc_tpu_torch.config import resolve_device
from smc_tpu_torch.models.generic import ODEModel
from smc_tpu_torch.models.methanation import (EST_DEFAULT, Conditions,
                                              MethanationModel)
from smc_tpu_torch.models.michaelis_menten import MichaelisMentenModel
from smc_tpu_torch.models.synthetic import BananaModel, GaussianMixtureModel
from smc_tpu_torch.opt import MAPResult
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


def _as_prior(prior, dev) -> Prior:
    if isinstance(prior, Mapping):
        return prior_from_numpy(device=dev, **prior)
    return prior.to(dev)


def mm_model_from_numpy(obs, s0, ts, prior, method: str = "rk4",
                        substeps: int = 4, est_sigma: bool = True,
                        sigma_fixed: float = 0.02, device="cuda"
                        ) -> MichaelisMentenModel:
    """A Michaelis-Menten model from obs (n_ds, T), s0 (n_ds,), ts (T,) and
    a prior: a port ``Prior`` or a mapping of the five prior arrays."""
    dev = resolve_device(device)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return MichaelisMentenModel(obs=f32(obs), s0=f32(s0), ts=f32(ts),
                                prior=_as_prior(prior, dev), method=method,
                                substeps=substeps, est_sigma=est_sigma,
                                sigma_fixed=float(sigma_fixed))


def methanation_model_from_numpy(cond: Mapping, obs, prior,
                                 est_idx=EST_DEFAULT, device="cuda",
                                 **solver_kw) -> MethanationModel:
    """A methanation model from ``cond`` (a mapping of the seven
    ``Conditions`` fields as arrays), obs (5, n_data) in sccm and a prior: a
    port ``Prior`` or a mapping of the five prior arrays. ``solver_kw`` are
    further ``MethanationModel`` fields (nx, n_steps, jac_stride, march,
    jac_mode, solver, the ptc_* settings, ...), passed unchanged, so the
    JAX package's model with the same keywords is the same model."""
    dev = resolve_device(device)
    return MethanationModel(
        cond=Conditions.from_numpy(cond, dev),
        obs=torch.as_tensor(np.asarray(obs, np.float32), device=dev),
        prior=_as_prior(prior, dev), est_idx=tuple(est_idx), **solver_kw)


def ode_model_from_numpy(rhs, param_names, obs, ts, y0, prior,
                         device="cuda", **settings) -> ODEModel:
    """A generic ODE model from obs (n_series, T), ts (T,), y0 (state_dim,
    n_series) and a prior (a port ``Prior`` or a mapping of the five prior
    arrays), with the torch ``rhs`` (and ``observe``, ``jac`` in
    ``settings``) written for the port. ``settings`` are the other
    ``ODEModel`` fields as the JAX model holds them (method, substeps,
    est_sigma, sigma_fixed, err_tol, alg_mask)."""
    dev = resolve_device(device)

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)
    if "err_tol" in settings:
        settings["err_tol"] = float(settings["err_tol"])
    if settings.get("alg_mask") is not None:
        settings["alg_mask"] = tuple(bool(a) for a in settings["alg_mask"])
    return ODEModel(rhs=rhs, param_names=tuple(param_names), obs=f32(obs),
                    ts=f32(ts), y0=f32(y0), prior=_as_prior(prior, dev),
                    **settings)


def banana_model_from_numpy(prior, a: float = 1.0, b: float = 20.0,
                            scale0: float = 1.0, device="cuda"
                            ) -> BananaModel:
    """A banana target with the JAX model's constants and prior (a port
    ``Prior`` or a mapping of the five prior arrays)."""
    dev = resolve_device(device)
    return BananaModel(a=float(a), b=float(b), scale0=float(scale0),
                       prior=_as_prior(prior, dev), device=dev.type)


def gmm_model_from_numpy(means, stds, log_weights, prior,
                         device="cuda") -> GaussianMixtureModel:
    """A Gaussian mixture from means (K, d), stds (K,), log_weights (K,)
    and a prior (a port ``Prior`` or a mapping of the five prior
    arrays)."""
    dev = resolve_device(device)

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)
    means = f32(means)
    return GaussianMixtureModel(
        means=means, stds=f32(stds), log_weights=f32(log_weights),
        prior=_as_prior(prior, dev),
        param_names=tuple(f"x{i}" for i in range(means.shape[1])))


def map_result_to_numpy(res: MAPResult) -> dict:
    """A MAP result's four fields as NumPy arrays."""
    return {f: getattr(res, f).detach().cpu().numpy()
            for f in MAPResult._fields}


def map_result_from_numpy(d: Mapping, device="cuda") -> MAPResult:
    """A MAPResult from a mapping of its four fields (the JAX package's
    ``MAPResult._asdict()`` as NumPy arrays, or :func:`map_result_to_numpy`'s
    output)."""
    dev = resolve_device(device)
    return MAPResult(*(torch.tensor(np.asarray(d[f], np.float32),
                                    device=dev)
                       for f in MAPResult._fields))


# "TGEN", little-endian: the first word of a generator state as uint32 words.
KEY_TAG = 0x4E454754


def key_to_words(draws) -> np.ndarray:
    """A ``TorchDraws``'s generator state as tagged uint32 words (the
    module's rule), the form a checkpoint file keeps."""
    if not isinstance(draws, TorchDraws):
        raise TypeError("only a TorchDraws can be saved with a state, not "
                        f"{type(draws).__name__}")
    raw = draws.get_state()
    body = np.concatenate([raw, np.zeros((-raw.size) % 4, np.uint8)])
    return np.concatenate([np.asarray([KEY_TAG, raw.size], np.uint32),
                           body.view("<u4").astype(np.uint32)])


def _is_words(raw: np.ndarray) -> bool:
    return (raw.dtype == np.uint32 and raw.ndim == 1 and raw.size > 2
            and int(raw[0]) == KEY_TAG
            and raw.size == 2 + -(-int(raw[1]) // 4))


def draws_from_key(raw, device) -> TorchDraws:
    """The run's ``TorchDraws`` from a key array, by the module's rule."""
    dev = resolve_device(device)
    raw = np.asarray(raw)
    if raw.dtype == np.uint8 or _is_words(raw):
        state = (raw if raw.dtype == np.uint8 else
                 raw[2:].astype("<u4").view(np.uint8)[:int(raw[1])])
        try:
            return TorchDraws(0, dev).set_state(state)
        except RuntimeError as e:
            raise ValueError(
                f"a generator state of {state.size} bytes does not fit a "
                f"{dev.type} generator (a CUDA state is 16 bytes, a CPU "
                "state 5,056): resume on the device type the state was "
                "saved from") from e
    seed = int.from_bytes(raw.tobytes()[:8].ljust(8, b"\0"),
                          "little") & (2 ** 63 - 1)
    return TorchDraws(seed, dev)


def state_to_numpy(state: SMCState) -> dict:
    """The 13 fields as NumPy arrays; ``key`` becomes the generator state
    (uint8) of the state's ``TorchDraws``."""
    out = {f: getattr(state, f).detach().cpu().numpy()
           for f in STATE_FIELDS if f != "key"}
    out["key"] = state.key.get_state()
    return out


def state_from_numpy(d: Mapping, device="cuda",
                     draws: Optional[object] = None) -> SMCState:
    """An SMCState from a mapping of the 13 fields (NumPy arrays, scalars,
    or tensors, which are moved to ``device``). ``key``: ``draws`` when
    given, else :func:`draws_from_key` of it (the module's rule)."""
    dev = resolve_device(device)
    missing = set(STATE_FIELDS) - set(d)
    if draws is not None:
        missing.discard("key")
    if missing:
        raise KeyError(f"state fields missing: {sorted(missing)}")
    if draws is None:
        draws = draws_from_key(d["key"], dev)
    fields = {}
    for f in STATE_FIELDS:
        if f == "key":
            continue
        dtype = torch.int32 if f in _INT_FIELDS else torch.float32
        a = d[f]
        fields[f] = (a.to(dev, dtype) if isinstance(a, torch.Tensor) else
                     torch.tensor(np.asarray(a), dtype=dtype, device=dev))
    return SMCState(key=draws, **fields)


def _check_stacked(shapes: Mapping) -> None:
    """Raise unless the shapes are an ensemble's: gamma (D,) and the same
    leading D on every tensor field."""
    if len(shapes["gamma"]) != 1:
        raise ValueError("an ensemble state has per-dataset gamma (D,), got "
                         f"shape {tuple(shapes['gamma'])}")
    d = shapes["gamma"][0]
    for f, shp in shapes.items():
        want = {"particles": 3, "log_lik": 2}.get(f, 1)
        if len(shp) != want or shp[0] != d:
            raise ValueError(f"ensemble field {f} has shape {tuple(shp)}; "
                             f"expected {want} dims with leading D = {d}")


def ensemble_state_to_numpy(states: SMCState) -> dict:
    """:func:`state_to_numpy` for a stacked ensemble state (leading dataset
    axis D on every field; ``key`` is the one generator state)."""
    _check_stacked({f: getattr(states, f).shape
                    for f in STATE_FIELDS if f != "key"})
    return state_to_numpy(states)


def ensemble_state_from_numpy(d: Mapping, device="cuda",
                              draws: Optional[object] = None) -> SMCState:
    """:func:`state_from_numpy` for a stacked ensemble state: particles
    (D, N, d), log_lik (D, N), every other field (D,). The JAX package's
    per-dataset keys cannot be carried over: as there, ``draws`` (or the
    bytes of ``key``) gives the ensemble's one ``Draws``."""
    _check_stacked({f: np.shape(d[f]) for f in STATE_FIELDS
                    if f != "key" and f in d})
    return state_from_numpy(d, device=device, draws=draws)

"""The system under test, built from a configuration: the only module of
the harness that imports the program (``smc_tpu_torch``), and only its
public entry points, models, counters and kernel names."""
from __future__ import annotations

import numpy as np
import torch


def smc_config(cfg: dict, traffic: dict):
    from smc_tpu_torch import SMCConfig
    return SMCConfig(n_particles=traffic["n_particles"],
                     mutation=traffic["mutation"],
                     dtype=getattr(torch, cfg["dtype"]), **cfg["smc"])


def prior(cfg: dict, device):
    from smc_tpu_torch.priors import Prior
    p = cfg["prior"]
    if p["kind"] != "uniform":
        raise ValueError(f"prior kind {p['kind']!r} is not one the "
                         "harness builds")
    return Prior.uniform(p["low"], p["high"], device=device)


def mm_model(cfg: dict, obs: torch.Tensor, ts, s0, device):
    from smc_tpu_torch.models.michaelis_menten import MichaelisMentenModel

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    return MichaelisMentenModel(obs=obs, s0=f32(s0), ts=f32(ts),
                                prior=prior(cfg, device),
                                method=cfg["likelihood"])


def mm_data_loglik(cfg: dict, ts, s0, device):
    from smc_tpu_torch.models.michaelis_menten import make_mm_data_loglik

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    return make_mm_data_loglik(f32(ts), f32(s0), method=cfg["likelihood"])


def methanation_model(cfg: dict, obs: np.ndarray, device):
    from smc_tpu_torch.models.methanation import (MethanationModel,
                                                  make_condition_table)
    m = cfg["march"]
    return MethanationModel(
        cond=make_condition_table(cfg["n_conditions"], nx=cfg["nx"],
                                  device=device),
        obs=torch.as_tensor(obs, device=device), prior=prior(cfg, device),
        est_idx=tuple(cfg["est_idx"]),
        base_params=tuple(cfg["kin_true"]) + (cfg["sigma_true"],),
        nx=cfg["nx"], t_final=m["t_final"], n_steps=m["n_steps"],
        newton_iters=m["newton_iters"], pivot=m["pivot"],
        growth=m["growth"], jac_stride=m["jac_stride"],
        n_dense=m["n_dense"], reuse_iters=m["reuse_iters"],
        dense_tail=m["dense_tail"], jac_mode=m["jac_mode"],
        solver=m["solver"], particle_chunk=m["particle_chunk"],
        march=m["kind"])


def draws(seed: int, device):
    from smc_tpu_torch.rng import TorchDraws
    return TorchDraws(seed, device)


def full_run(model, cfg):
    from smc_tpu_torch import make_full_run_on_device
    return make_full_run_on_device(model, cfg)


def ensemble_run(cfg_json: dict, loglik, pops: int, cfg, device):
    from smc_tpu_torch.smc.ensemble import make_ensemble_run
    return make_ensemble_run(prior(cfg_json, device), loglik, pops, cfg)


def stepper(model, cfg):
    """(init(seed) -> state, step(state) -> state)."""
    from smc_tpu_torch import init_state, make_smc_step
    step = make_smc_step(model, cfg)
    dev = model.prior.device

    def init(seed):
        return init_state(draws(seed, dev), model, cfg)
    return init, step


def ll_and_grad(model):
    """``theta (N, d) -> (log_lik (N,), grad (N, d))``: the program's own
    likelihood-and-gradient function of ``model``, the one its gradient
    mutations capture in their graphs and replay every sweep."""
    from smc_tpu_torch.smc.kernels import _make_ll_and_grad
    return _make_ll_and_grad(model.log_likelihood)


def counters() -> dict:
    """The program's own counters: host reads of a device flag, graph
    replays, and kernel launches by name (each counted per replay)."""
    from smc_tpu_torch.ops import _build
    from smc_tpu_torch.smc import graphs
    return dict(host_reads=graphs.stats["host_reads"],
                replays=graphs.stats["replays"],
                launches=dict(_build.launch_counts))


def delta(after: dict, before: dict) -> dict:
    out = {}
    for k, v in after.items():
        out[k] = delta(v, before[k]) if isinstance(v, dict) else \
            v - before[k]
    return out


def build_kernels() -> None:
    """Build (first run in a checkout) or load the program's kernels."""
    from smc_tpu_torch.ops import _build
    _build.load()

"""Diagnostic plots (PyTorch port of ``smc_tpu.viz.plots``).

The reference's observability surface:
- per-step posterior marginal histograms with mean and true-value lines,
- simulated-vs-observed parity plots, boxplot-over-particles and
  mean-marker variants,
- a seaborn corner pairplot,
- overlaid prior-vs-posterior histograms.

Inputs may be tensors on any device (copied to the host) or arrays.
matplotlib and seaborn are imported lazily and every function returns
False, drawing nothing, when they are not installed, so a machine without
them runs the sampler all the same.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _mpl():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except ImportError:
        return None


def plot_marginal_histograms(particles, path: str,
                             param_names: Sequence[str],
                             true_values: Optional[Sequence[float]] = None,
                             ranges: Optional[Sequence] = None,
                             bins: int = 50) -> bool:
    plt = _mpl()
    if plt is None:
        return False
    p = _host(particles)
    d = p.shape[1]
    fig, axes = plt.subplots(d, 1, figsize=(10, 2.2 * d))
    if d == 1:
        axes = [axes]
    for i, ax in enumerate(axes):
        rng = tuple(ranges[i]) if ranges is not None else None
        ax.hist(p[:, i], bins, range=rng, density=True)
        ax.axvline(p[:, i].mean(), color="red", linestyle="dashed",
                   linewidth=1)
        if true_values is not None:
            ax.axvline(true_values[i], color="black", linewidth=2)
        ax.grid(True)
        ax.set_ylabel(param_names[i])
    fig.tight_layout()
    fig.savefig(path, bbox_inches="tight", dpi=150)
    plt.close(fig)
    return True


def plot_parity(obs, predictions, box_path: str, mean_path: str,
                labels: Optional[Sequence[str]] = None) -> bool:
    """obs (k, n_data); predictions (N, k, n_data) over particles."""
    plt = _mpl()
    if plt is None:
        return False
    obs = _host(obs)
    pred = _host(predictions)
    if labels is None:
        labels = (["Xa", "Xb", "Xc", "Xd", "Xe"] if obs.shape[0] == 5
                  else [f"y{i}" for i in range(obs.shape[0])])
    for i in range(obs.shape[0]):
        data = [pred[:, i, k] for k in range(obs.shape[1])]
        pos = obs[i]
        lo = min(obs[i].min(), pred[:, i].min())
        hi = max(obs[i].max(), pred[:, i].max())
        for path, mean_only in ((box_path, False), (mean_path, True)):
            fig, ax = plt.subplots(figsize=(6, 6))
            ax.plot([lo, hi], [lo, hi], "r--")
            if mean_only:
                ax.scatter(pos, [np.mean(d) for d in data], s=12)
            else:
                width = 0.01 * (hi - lo + 1e-9)
                ax.boxplot(data, positions=pos, vert=True, showfliers=False,
                           widths=width, manage_ticks=False)
            ax.set_xlabel(f"data {labels[i]}")
            ax.set_ylabel(f"simulation {labels[i]}")
            fig.savefig(path.replace(".png", f"_{i}.png"),
                        bbox_inches="tight", dpi=150)
            plt.close(fig)
    return True


def plot_pairplot(particles, path: str, param_names: Sequence[str]) -> bool:
    plt = _mpl()
    if plt is None:
        return False
    try:
        import pandas as pd
        import seaborn as sns
    except ImportError:
        return False
    df = pd.DataFrame(_host(particles), columns=list(param_names))
    g = sns.pairplot(df, corner=True)
    g.savefig(path, dpi=150)
    plt.close("all")
    return True


def plot_prior_posterior_compare(prior_particles, posterior_particles,
                                 path: str, param_names: Sequence[str],
                                 true_values: Optional[Sequence[float]] = None,
                                 bins: int = 50) -> bool:
    plt = _mpl()
    if plt is None:
        return False
    p1 = _host(prior_particles)
    p2 = _host(posterior_particles)
    d = p1.shape[1]
    fig, axes = plt.subplots(d, 1, figsize=(10, 2.2 * d))
    if d == 1:
        axes = [axes]
    for i, ax in enumerate(axes):
        lo = min(p1[:, i].min(), p2[:, i].min())
        hi = max(p1[:, i].max(), p2[:, i].max())
        ax.hist(p1[:, i], bins, range=(lo, hi), density=True,
                color=(0, 0, 1, 0.3))
        ax.axvline(p1[:, i].mean(), color="blue", linestyle="dashed",
                   linewidth=1)
        ax.hist(p2[:, i], bins, range=(lo, hi), density=True,
                color=(1, 0, 0, 0.7))
        ax.axvline(p2[:, i].mean(), color="purple", linestyle="dashed",
                   linewidth=1)
        if true_values is not None:
            ax.axvline(true_values[i], color="black", linewidth=2)
        ax.grid(True)
        ax.set_ylabel(param_names[i])
    fig.tight_layout()
    fig.savefig(path, bbox_inches="tight", dpi=150)
    plt.close(fig)
    return True

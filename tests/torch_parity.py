"""Helpers for the parity tests of the PyTorch port against the JAX package:
a ``Draws`` replay of JAX's random stream, and the JAX key-split order of a
run, so both packages can be fed the same random numbers."""
import numpy as np
import torch

import jax


class ReplayDraws:
    """The port's ``Draws`` interface served from a fixed list of
    ("uniform" | "normal", array) entries, in order; the kind and shape of
    every request must match the next entry."""

    def __init__(self, entries):
        self.entries = list(entries)
        self.used = 0

    def _next(self, kind, shape):
        if self.used >= len(self.entries):
            raise AssertionError(f"replay exhausted at a {kind} draw")
        k, arr = self.entries[self.used]
        self.used += 1
        arr = np.asarray(arr)
        if k != kind or tuple(arr.shape) != tuple(shape):
            raise AssertionError(f"replay expected {k}{arr.shape}, got "
                                 f"{kind}{tuple(shape)}")
        return torch.from_numpy(arr.astype(np.float32))

    def uniform(self, shape, dtype=torch.float32):
        return self._next("uniform", shape)

    def normal(self, shape, dtype=torch.float32):
        return self._next("normal", shape)


def prior_draws(k_init, n, d):
    """Prior.sample's draws from the key it is given (u, then z)."""
    ku, kn = jax.random.split(k_init)
    return [("uniform", jax.random.uniform(ku, (n, d))),
            ("normal", jax.random.normal(kn, (n, d)))]


def sweep_draws(k_mh, n, d, n_sweeps):
    """The mutation loop's draws: per sweep z (n, d), then u (n,)."""
    out, k = [], k_mh
    for _ in range(n_sweeps):
        k, k_z, k_u = jax.random.split(k, 3)
        out += [("normal", jax.random.normal(k_z, (n, d))),
                ("uniform", jax.random.uniform(k_u, (n,)))]
    return out


def step_draws(state_key, n, d, n_sweeps=20):
    """One smc_step's draws from the state's key: v0, then the sweeps."""
    _, k_res, k_mh = jax.random.split(state_key, 3)
    return ([("uniform", jax.random.uniform(k_res, ()))]
            + sweep_draws(k_mh, n, d, n_sweeps))


def jax_state_to_numpy(state):
    """A JAX SMCState as the mapping convert.state_from_numpy takes."""
    import dataclasses
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        out[f.name] = (np.asarray(jax.random.key_data(v)) if f.name == "key"
                       else np.asarray(v))
    return out


def _term_scale(theta, ll, n_ds, n_obs):
    """The larger of ll's two terms, -0.5 n (ln 2pi + 2 ln sigma) and
    sum r^2 / (2 sigma^2): the magnitude the rounding of either acts on."""
    sigma = np.maximum(theta[..., 2].astype(np.float64), 1e-12)
    t1 = -0.5 * n_obs * n_ds * (np.log(2 * np.pi) + 2 * np.log(sigma))
    return np.maximum(np.abs(t1), np.abs(t1 - ll))


def assert_ll_close(got, want, theta, n_ds, n_obs, rtol):
    """MM log-likelihoods equal in their -inf/NaN pattern and within rtol
    of ll itself, or, where ll's two terms cancel toward 0, of the larger
    term."""
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    assert fin.sum() > 0.9 * want.size
    err = np.abs(got[fin].astype(np.float64) - want[fin])
    scale = np.maximum(np.abs(want[fin]),
                       _term_scale(theta[fin], want[fin], n_ds, n_obs))
    assert (err <= rtol * scale).all(), (err / scale).max()

"""Helpers for the parity tests of the PyTorch port against the JAX package:
a ``Draws`` replay of JAX's random stream, and the JAX key-split order of a
run, so both packages can be fed the same random numbers.

Importing this module pins PyTorch to one intra-op and one inter-op thread.
Every ``tests/test_torch_*.py`` that runs with JAX imports it: the suite
runs in several worker processes at once, and PyTorch's default of one
thread per core in each of them oversubscribes the cores several times
over (the port's tests took twice as long that way)."""
import numpy as np
import torch

import jax

from tests.torch_mesh import ReplayDraws  # noqa: F401

torch.set_num_threads(1)
try:
    torch.set_num_interop_threads(1)
except RuntimeError:     # already set, or inter-op work already started
    pass


class RecordingDraws:
    """A ``Draws`` that passes every request on to ``inner`` and keeps what
    came back, in order, as ("uniform" | "normal", array) entries."""

    def __init__(self, inner):
        self.inner = inner
        self.entries = []

    def uniform(self, shape, dtype=torch.float32):
        out = self.inner.uniform(shape, dtype)
        self.entries.append(("uniform", out.cpu().numpy().copy()))
        return out

    def normal(self, shape, dtype=torch.float32):
        out = self.inner.normal(shape, dtype)
        self.entries.append(("normal", out.cpu().numpy().copy()))
        return out


class PopulationReplay:
    """One population's share of an ensemble's recorded draws, served to a
    single run of that population alone.

    The ensemble draws (rng.py): the prior pair with a leading D; then per
    ensemble step ``uniform((D,))`` followed by one ``normal((D, n, d))``,
    ``uniform((D, n))`` pair per ensemble sweep. The replay is keyed by
    step and sweep: the single run's ``uniform(())`` opens the next recorded
    step and returns row ``pop`` of its v0; each of its sweeps takes row
    ``pop`` of that step's next pair. A population that stops sweeping
    before the ensemble does leaves the step's later pairs unread, as it
    did inside the ensemble."""

    def __init__(self, entries, pop):
        self.pop = pop
        self.prior = list(entries[:2])
        self.steps = []                      # [v0 (D,), [pair entries...]]
        for kind, arr in entries[2:]:
            if kind == "uniform" and arr.ndim == 1:
                self.steps.append([arr, []])
            else:
                self.steps[-1][1].append((kind, arr))
        self.step = -1
        self.pos = 0

    def _row(self, kind, want_kind, arr, shape):
        row = np.asarray(arr[self.pop])
        if kind != want_kind or tuple(row.shape) != tuple(shape):
            raise AssertionError(f"replay expected {kind}{row.shape}, got "
                                 f"{want_kind}{tuple(shape)}")
        return torch.from_numpy(row.astype(np.float32))

    def _next(self, want_kind, shape):
        if self.prior:
            kind, arr = self.prior.pop(0)
            return self._row(kind, want_kind, arr, shape)
        if want_kind == "uniform" and tuple(shape) == ():
            self.step += 1
            self.pos = 0
            return torch.tensor(float(self.steps[self.step][0][self.pop]))
        kind, arr = self.steps[self.step][1][self.pos]
        self.pos += 1
        return self._row(kind, want_kind, arr, shape)

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


def methanation_pair(n_conditions=2, nx=11, seed=0, **solver_kw):
    """The JAX methanation model and the port's (on the CPU) over the same
    condition table and the same observations: the port's flows at the true
    kinetics plus NumPy noise, handed to both as arrays. Building the JAX
    model directly compiles nothing; ``MethanationModel.default`` would
    compile a march just to make its observations."""
    import jax.numpy as jnp
    from smc_tpu.models import methanation as JM
    from smc_tpu_torch.convert import methanation_model_from_numpy
    from smc_tpu_torch.models import methanation as TM

    cond = TM.condition_table_numpy(n_conditions, nx=nx)
    prior = TM.methanation_prior(device="cpu")
    tm = methanation_model_from_numpy(
        cond, np.zeros((5, n_conditions), np.float32), prior, nx=nx,
        device="cpu", **solver_kw)
    truth = tm.simulate_flows(torch.tensor(TM.KIN_TRUE)).numpy()
    rng = np.random.default_rng(seed)
    obs = (truth + 5.0 * rng.normal(size=truth.shape)).astype(np.float32)
    tm = methanation_model_from_numpy(cond, obs, prior, nx=nx, device="cpu",
                                      **solver_kw)
    jm = JM.MethanationModel(
        cond=JM.Conditions(**{k: jnp.asarray(v) for k, v in cond.items()}),
        obs=jnp.asarray(obs), prior=JM.methanation_prior(), nx=nx,
        **solver_kw)
    return jm, tm


def jax_loglik_and_final_state(jm, thetas):
    """For each theta (N, n_est) of ``thetas``: the JAX model's
    ``log_likelihood`` and the final DAE state (7, NX, N * n_data) of the
    march that produced its flows, as NumPy arrays. One jitted program,
    compiled once for every theta of one shape: a march of this size takes
    about a minute to compile on the CPU, and eager calls compile it anew
    each time. The state is taken from inside ``log_likelihood``, by
    wrapping the reference's ``bdf_march_bl`` while the program is traced,
    so the flows and the whole state come from the same march. N must fit
    in one particle chunk."""
    import jax.numpy as jnp
    from unittest import mock
    from smc_tpu.ops import dae_fast as jdf

    march = jdf.bdf_march_bl

    def run(theta):
        seen = []

        def capture(*args, **kwargs):
            seen.append(march(*args, **kwargs))
            return seen[-1]
        with mock.patch.object(jdf, "bdf_march_bl", capture):
            ll, flows = jm.log_likelihood(theta)
        assert len(seen) == 1, "one march per call (N within one chunk)"
        return ll, flows, seen[0]

    fn = jax.jit(run)
    return [tuple(np.asarray(a) for a in fn(jnp.asarray(t))) for t in thetas]


def torch_march_final_state(tm, theta):
    """The port's final DAE state (7, NX, N * n_data) for theta (N, n_est),
    the counterpart of the state :func:`jax_loglik_and_final_state`
    returns."""
    from smc_tpu_torch.ops.dae_fast import bdf_march_bl as t_march

    theta = torch.as_tensor(theta)
    full = theta.new_tensor(tm.base_params).repeat(theta.shape[0], 1)
    full[:, list(tm.est_idx)] = theta
    rows, jac, y0, fused = tm._lane_problem(full[:, :8])
    return t_march(rows, y0, tm._dts(), newton_iters=tm.newton_iters,
                   pivot=tm.pivot, analytic_jac=jac,
                   jac_stride=tm.jac_stride, n_dense=tm._n_dense_eff,
                   reuse_iters=tm.reuse_iters, dense_tail=tm.dense_tail,
                   solver=tm.solver, fused=fused).numpy()


def assert_same_run(got, want):
    """Two port states are one run's: every tensor field and the
    generator's state bit-equal."""
    from smc_tpu_torch.convert import STATE_FIELDS
    for f in STATE_FIELDS:
        if f != "key":
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert torch.equal(got.key.generator.get_state(),
                       want.key.generator.get_state())

"""The port's implicit integrator (``ops/implicit_ode.py``: ``bdf2_grid``,
``make_consistent``) and the Robertson models (``models/generic.py``)
against the JAX package's, on the same inputs.

Tolerances: trajectories rtol 1e-4 and 1e-6 of the state's scale (a
Newton iteration of a float32 stiff system, its Jacobian from another
AD); per-lane Newton residuals 1e-5 absolute (the residual of a float32
Newton iterate whose terms are O(1)); log-likelihoods the same -inf rows
exactly and the finite rows within 1e-4 of max(|ll|, 1). The posterior
recovery is statistical (the port's random stream is its own).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_parity  # noqa: F401  (one PyTorch thread per worker)
from smc_tpu.models import generic as JG
from smc_tpu.ops import implicit_ode as JI
from smc_tpu_torch import SMCConfig, run_smc
from smc_tpu_torch.models import generic as TG
from smc_tpu_torch.ops import implicit_ode as TI
from tests.test_torch_generic import port_of

RTOL = 1e-4
THETA = np.asarray([list(TG.ROBERTSON_TRUE) + [0.01],
                    [-1.0, 7.0, 4.5, 0.02],
                    list(TG.ROBERTSON_TRUE) + [-0.01],    # sigma <= 0
                    [0.0, 8.5, 5.5, 0.01],                # stiffest corner
                    [-2.5, 6.0, 3.0, 0.05]], np.float32)


@pytest.fixture(scope="module")
def rob():
    return {form: (lambda jm: (jm, port_of(
        jm, TG.robertson_dae_rhs if form == "dae" else TG.robertson_rhs,
        observe=TG.robertson_observe)))(JG.robertson_model(form=form))
        for form in ("ode", "dae")}


def _params(mod_np, lk):
    return {k: mod_np(lk[:, i].copy()) for i, k in
            enumerate(("lk1", "lk2", "lk3"))}


def _state_close(got, want):
    scale = float(np.abs(want[np.isfinite(want)]).max())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6 * scale)


def test_bdf2_grid_matches_jax():
    rng = np.random.default_rng(0)
    n = 12
    lk = np.column_stack([rng.uniform(-2.5, -0.5, n), rng.uniform(6, 8, n),
                          rng.uniform(3, 5, n)]).astype(np.float32)
    y0 = np.zeros((3, 2, n), np.float32)
    y0[0] = rng.uniform(0.8, 1.0, (2, n))
    ts = np.concatenate([[0.0], np.logspace(-2, 3, 9)]).astype(np.float32)

    def jf(y, p):
        return JI.bdf2_grid(lambda t, yy: JG.robertson_rhs(t, yy, p), y,
                            jnp.asarray(ts), substeps=3, newton_iters=3)
    ys_j, res_j = jax.jit(jf)(jnp.asarray(y0), _params(jnp.asarray, lk))
    p = _params(torch.from_numpy, lk)
    ys_t, res_t = TI.bdf2_grid(lambda t, yy: TG.robertson_rhs(t, yy, p),
                               torch.from_numpy(y0), torch.from_numpy(ts),
                               substeps=3, newton_iters=3)
    assert tuple(res_t.shape) == (2, n)
    _state_close(ys_t.numpy(), np.asarray(ys_j))
    np.testing.assert_allclose(res_t.numpy(), np.asarray(res_j), atol=1e-5)


def test_make_consistent_matches_jax_and_projects():
    """An inconsistent c0 is Newton-projected onto a + b + c = 1 with the
    differential rows pinned, as in the JAX package."""
    lk = np.asarray([TG.ROBERTSON_TRUE, [-1.0, 7.0, 4.5]], np.float32)
    y0 = np.asarray([[[0.7, 0.5]], [[0.1, 0.2]], [[0.9, 0.0]]], np.float32)
    mask = (False, False, True)
    yj, rj = jax.jit(lambda y, p: JI.make_consistent(
        lambda t, yy: JG.robertson_dae_rhs(t, yy, p), y, 0.0, mask))(
            jnp.asarray(y0), _params(jnp.asarray, lk))
    p = _params(torch.from_numpy, lk)
    yt, rt = TI.make_consistent(
        lambda t, yy: TG.robertson_dae_rhs(t, yy, p), torch.from_numpy(y0),
        torch.tensor(0.0), mask)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(yt[:2].numpy(), y0[:2], rtol=1e-6)  # pinned
    np.testing.assert_allclose(yt[2, 0].numpy(), [0.2, 0.3], atol=1e-6)
    assert float(rt.max()) < 1e-6 and float(np.asarray(rj).max()) < 1e-6
    with pytest.raises(ValueError, match="alg_mask shape"):
        TI.make_consistent(lambda t, yy: yy, torch.from_numpy(y0),
                           torch.tensor(0.0), (True,))


@pytest.mark.parametrize("form", ["ode", "dae"])
def test_robertson_likelihood_matches_jax(rob, form):
    jm, tm = rob[form]
    want_ll, want_pred = jax.jit(jm.log_likelihood)(jnp.asarray(THETA))
    got_ll, got_pred = tm.log_likelihood(torch.from_numpy(THETA))
    got_ll, want_ll = got_ll.numpy(), np.asarray(want_ll)
    np.testing.assert_array_equal(np.isinf(got_ll), np.isinf(want_ll))
    assert not np.isnan(got_ll).any()
    assert got_ll[2] == -np.inf and np.isfinite(got_ll[0])
    fin = np.isfinite(want_ll)
    err = np.abs(got_ll[fin].astype(np.float64) - want_ll[fin])
    assert (err <= RTOL * np.maximum(np.abs(want_ll[fin]), 1.0)).all(), err
    _state_close(got_pred.numpy()[fin], np.asarray(want_pred)[fin])


def test_newton_residual_is_per_lane():
    """A lane whose Newton iteration cannot converge does not poison a
    benign lane's residual."""
    p = {"lk1": torch.tensor([np.log10(0.04), 14.0]),
         "lk2": torch.tensor([np.log10(3e7), 16.0]),
         "lk3": torch.tensor([4.0, 15.0])}
    y0 = torch.tensor([[1.0], [0.0], [0.0]])[..., None].expand(3, 1, 2)
    ts = torch.tensor(np.concatenate([[0.0], np.logspace(-2, 2, 8)]),
                      dtype=torch.float32)
    _, res = TI.bdf2_grid(lambda t, y: TG.robertson_rhs(t, y, p), y0, ts,
                          substeps=4, newton_iters=3)
    assert tuple(res.shape) == (1, 2)
    assert torch.isfinite(res[0, 0]) and res[0, 0] < 1e-3
    assert not bool(res[0, 1] < 1e-3)                # big or nan


def test_analytic_jac_matches_forward_mode(rob):
    def rob_jac(t, y, p):
        k1, k2, k3 = (10.0 ** p[k] for k in ("lk1", "lk2", "lk3"))
        a, b, c = y[0], y[1], y[2]
        z = torch.zeros_like(a)
        return [torch.stack([-k1 + z, k1 + z, z]),
                torch.stack([k3 * c, -k3 * c - 2 * k2 * b, 2 * k2 * b]),
                torch.stack([k3 * b, -k3 * b, z])]

    _, tm = rob["ode"]
    th = torch.from_numpy(THETA[:2])
    y_ad, _ = tm.simulate(th)
    y_an, _ = dataclasses.replace(tm, jac=rob_jac).simulate(th)
    np.testing.assert_allclose(y_an.numpy(), y_ad.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_stacked_jacobian_pass_equals_one_jvp_per_column():
    """``_build_jac``'s one forward-mode pass over n stacked copies of the
    state gives, bit for bit, the Jacobian of n ``torch.func.jvp`` passes
    (one per unit tangent) for an rhs elementwise over the batch axes."""
    rng = np.random.default_rng(3)
    n = 7
    lk = np.column_stack([rng.uniform(-2.5, -0.5, n), rng.uniform(6, 8, n),
                          rng.uniform(3, 5, n)]).astype(np.float32)
    p = _params(torch.from_numpy, lk)
    y = torch.from_numpy(rng.uniform(0.0, 1.0, (3, 2, n)).astype(np.float32))
    t = torch.zeros(())

    def f(tt, yy):
        return TG.robertson_rhs(tt, yy, p)

    fv, jac = TI._build_jac(f, t, y, 3)
    assert torch.equal(fv, f(t, y))
    for j in range(3):
        e = torch.zeros_like(y)
        e[j] = 1.0
        _, col = torch.func.jvp(lambda yy: f(t, yy), (y,), (e,))
        assert torch.equal(jac[:, j], col.to(y.dtype)), j


def test_dae_form_matches_ode_form(rob):
    _, t_ode = rob["ode"]
    _, t_dae = rob["dae"]
    th = torch.from_numpy(THETA[:2])
    np.testing.assert_allclose(t_dae.simulate(th)[0].numpy(),
                               t_ode.simulate(th)[0].numpy(), atol=5e-3)
    ll_o = t_ode.log_likelihood(th)[0]
    ll_d = dataclasses.replace(t_dae, obs=t_ode.obs).log_likelihood(th)[0]
    assert torch.isfinite(ll_d).all()
    np.testing.assert_allclose(ll_d.numpy(), ll_o.numpy(), rtol=2e-2,
                               atol=2.0)
    with pytest.raises(ValueError, match="bdf2"):
        dataclasses.replace(t_dae, method="rk4")


def test_bdf2_matches_scipy_bdf():
    from scipy.integrate import solve_ivp
    m = TG.robertson_model(device="cpu")
    y_path, _ = m.simulate(torch.tensor([list(TG.ROBERTSON_TRUE) + [0.01]],
                                        dtype=torch.float32))
    ts = m.ts.double().numpy()
    k1, k2, k3 = (10.0 ** v for v in TG.ROBERTSON_TRUE)

    def rhs(t, y):
        da = -k1 * y[0] + k3 * y[1] * y[2]
        dc = k2 * y[1] * y[1]
        return [da, -da - dc, dc]
    sol = solve_ivp(rhs, (ts[0], ts[-1]), [1.0, 0.0, 0.0], t_eval=ts,
                    method="BDF", rtol=1e-10, atol=1e-14)
    want = sol.y * np.asarray([1.0, 1e4, 1.0])[:, None]
    np.testing.assert_allclose(y_path[:, :, 0].numpy().T, want, atol=2e-2)


def test_robertson_posterior_recovers_truth():
    model = TG.robertson_model(device="cpu")
    state = run_smc(model, SMCConfig(n_particles=512), 1, verbose=False)
    assert float(state.gamma) == 1.0
    p = state.particles.double().numpy()
    mean, std = p.mean(0), p.std(0)
    truth = np.asarray(TG.ROBERTSON_TRUE + (TG.ROBERTSON_TRUE_NOISE,))
    assert np.all(np.abs(mean - truth) < 4 * std + 0.05 * np.abs(truth))
    prior_width = np.asarray([3.0, 3.0, 3.0, 0.099]) / np.sqrt(12)
    assert np.all(std < 0.5 * prior_width)

"""The methanation likelihood's gradient in the port against the JAX
package on the CPU: the steady solve's implicit-function adjoint
(``models/methanation.py::_make_steady_solve``, a
``torch.autograd.Function``) against ``jax.grad`` of the JAX model, central
differences and sigma's closed form; failed-lane containment; the
two-condition table's non-finite kinetic gradients, in both packages; the
transient march's gradient through the plain loops. The gradient's
consumers (a MALA run, ``map_estimate``) are in
``test_torch_methanation_mala.py``.

The JAX side compiles four programs, once each: the observations of
``tests/test_methanation_grad.py``'s model (nx = 15, 3 conditions; a
steady forward march), the steady gradient on it, the steady gradient at 2
conditions (nx = 11) and a short transient march's gradient.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smc_tpu.models import methanation as JM
from smc_tpu.ops import dae_fast as jdf
from smc_tpu_torch import SMCConfig, run_smc
from smc_tpu_torch.convert import methanation_model_from_numpy
from smc_tpu_torch.models import methanation as TM
from smc_tpu_torch.smc.kernels import _make_ll_and_grad
from tests.torch_parity import methanation_pair

STEADY = dict(n_steps=40, growth=1.3, particle_chunk=4, newton_iters=3,
              march="steady")
THETA0 = np.asarray([13.04, 52.2e3, 1.147e5, 96.7e3, 5.0], np.float32)
THETAS = np.asarray([THETA0, [15.0, 52.5e3, 1.5e5, 9.7e4, 4.0]], np.float32)
CORNER = np.asarray([1e5, 1.0, 1e6, 1.0, 5.0], np.float32)


@pytest.fixture(scope="module", autouse=True)
def nx_unroll_one():
    """Every JAX program of this file is traced with the reference's
    NX-scan unroll at 1 in place of 6: the same arithmetic, a program a
    sixth the size (the gradient of the default unroll's transient march
    takes minutes to compile on the CPU)."""
    with mock.patch.object(jdf, "_NX_UNROLL", 1):
        yield


def _jax_grads(jm, thetas):
    """(ll (N,), grad (N, 5), flows) of the JAX model from one program:
    jax.grad of the summed log-likelihood (rows are independent, so row i
    of the gradient is particle i's)."""
    def total(th):
        ll, flows = jm.log_likelihood(th)
        return jnp.sum(ll), (ll, flows)
    g, (ll, flows) = jax.jit(jax.grad(total, has_aux=True))(
        jnp.asarray(thetas))
    return np.asarray(ll), np.asarray(g), np.asarray(flows)


def _port_grads(tm, thetas):
    th = torch.as_tensor(thetas).clone().requires_grad_(True)
    ll, flows = tm.log_likelihood(th)
    (g,) = torch.autograd.grad(ll.sum(), th)
    return ll.detach().numpy(), g.numpy(), flows.detach().numpy()


@pytest.fixture(scope="module")
def pair3():
    """tests/test_methanation_grad.py's model (its observations are the
    JAX package's steady flows at the truth plus its own noise) and the
    port's model over the same arrays. On other noise (methanation_pair's
    seed 0) Af's influence at the truth falls under the "both tiny"
    threshold and Eaf's gradient is a small residual of cancelling terms,
    where a central difference at 1e-3 |theta| carries a 20% truncation
    error; these observations keep the JAX test's three checked
    parameters."""
    jm = JM.MethanationModel.default(n_conditions=3, nx=15, **STEADY)
    cond = {f.name: np.array(getattr(jm.cond, f.name))
            for f in dataclasses.fields(jm.cond)}
    tm = methanation_model_from_numpy(
        cond, np.array(jm.obs), TM.methanation_prior(device="cpu"), nx=15,
        device="cpu", **STEADY)
    return jm, tm


@pytest.fixture(scope="module")
def jax3(pair3):
    return _jax_grads(pair3[0], THETAS)


def test_adjoint_matches_jax_grad(pair3, jax3):
    """Every component within 1% of the JAX gradient's (measured 3e-4 on
    Af and Eaf; the adjoint solves the regularized terminal Newton system,
    whose conditioning amplifies fp32 rounding), the likelihoods within
    1e-4 relative; the IFT backward is what autograd ran."""
    ll, g, _ = _port_grads(pair3[1], THETAS)
    jll, jg, _ = jax3
    assert np.isfinite(g).all() and np.isfinite(jg).all()
    np.testing.assert_allclose(ll, jll, rtol=1e-4)
    np.testing.assert_allclose(g, jg, rtol=1e-2, atol=0)
    th = torch.from_numpy(THETAS).requires_grad_(True)
    fn = pair3[1].log_likelihood(th)[0].grad_fn
    seen, stack = set(), [fn]
    while stack:
        f = stack.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        stack += [n for n, _ in f.next_functions]
    assert any("_SteadySolve" in type(f).__name__ for f in seen)


def test_adjoint_matches_central_differences(pair3):
    """The rule of tests/test_methanation_grad.py on its own model: 10%
    relative at eps = 1e-3 |theta|, or "both tiny" where a parameter's
    influence is below fp32 resolution; at least 3 of the 5 parameters
    checked, not tiny (here Af, Eaf and sigma; measured within 0.25%)."""
    tm = pair3[1]
    _, g, _ = _port_grads(tm, THETA0[None])
    g = g[0]

    def f(th):
        return float(tm.log_likelihood(torch.from_numpy(th[None]))[0][0])
    checked = 0
    for i in range(5):
        eps = 1e-3 * abs(THETA0[i])
        tp, tn = THETA0.copy(), THETA0.copy()
        tp[i] += eps
        tn[i] -= eps
        fd = (f(tp) - f(tn)) / (2 * eps)
        assert np.isfinite(fd)
        if max(abs(fd), abs(g[i])) * eps < 1e-3:
            assert abs(g[i] - fd) * eps < 1e-3, (i, g[i], fd)
            continue
        checked += 1
        assert abs(g[i] - fd) < 0.1 * max(abs(fd), abs(g[i])), (i, g[i], fd)
    assert checked >= 3


def test_sigma_gradient_is_its_closed_form(pair3):
    """sigma enters only the Gaussian: its gradient is sum(r^2)/s^3 -
    5 n_data / s, to rtol 1e-4."""
    tm = pair3[1]
    _, g, flows = _port_grads(tm, THETA0[None])
    r = flows[0].astype(np.float64) - tm.obs.numpy()
    s = float(THETA0[-1])
    want = (r ** 2).sum() / s ** 3 - 5 * tm.obs.shape[1] / s
    np.testing.assert_allclose(g[0, -1], want, rtol=1e-4)


def test_failed_lane_is_contained(pair3):
    """A particle at an absurd prior corner (its march fails: the -10000
    sentinel) leaves a healthy particle's gradient finite and equal to the
    gradient it has alone: lanes never mix in the block solves."""
    tm = pair3[1]
    theta = torch.from_numpy(np.stack([THETA0, CORNER]))
    ll_and_grad = _make_ll_and_grad(tm.log_likelihood)
    ll, g = ll_and_grad(theta)
    _, g_alone = ll_and_grad(theta[:1])
    assert (tm.log_likelihood(theta)[1][1] == -10000.0).all()
    assert torch.isfinite(g[0]).all()
    # equal to fp32 rounding: on the CPU a sum over a block row adds in
    # an order that depends on the lane count (measured 2.7e-5)
    torch.testing.assert_close(g[0], g_alone[0], rtol=1e-3, atol=0)
    # _make_ll_and_grad zeroes the failed particle's non-finite gradient
    assert torch.isfinite(g).all()
    th = theta.clone().requires_grad_(True)
    ll_raw = tm.log_likelihood(th)[0]
    (g_raw,) = torch.autograd.grad(ll_raw.sum(), th)
    assert not torch.isfinite(g_raw[1]).all()


def test_two_condition_kinetic_gradients_are_non_finite_in_both():
    """The two-condition table at nx = 11 (tests/test_mala.py's size): in
    both packages the likelihood and sigma's gradient are finite and the
    four kinetic components are not. Traced to condition 1 (T_jacket
    453 K): its steady march fails the convergence certificate at THETA0 in
    both packages, so its flows are the -10000 sentinel (and so are its
    observations, made by the same march at the truth). The sentinel's
    mask passes a zero cotangent to flows that are NaN, the product is
    NaN, and the adjoint carries it to the particle's kinetic row. A
    failed lane, not an adjoint fault on a passing lane."""
    jm, tm = methanation_pair(2, 11, **STEADY)
    thetas = np.stack([THETA0, THETA0 * np.float32(1.01)])
    jll, jg, jflows = _jax_grads(jm, thetas)
    ll, g, flows = _port_grads(tm, thetas)
    for lls, gs in ((jll, jg), (ll, g)):
        assert np.isfinite(lls).all()
        assert np.isfinite(gs[:, 4]).all()
        assert not np.isfinite(gs[:, :4]).any()
    np.testing.assert_allclose(ll, jll, rtol=1e-4)
    np.testing.assert_allclose(g[:, 4], jg[:, 4], rtol=1e-4)
    # condition 1 failed, condition 0 did not, in the port and the JAX
    # package's flows alike
    for fl in (flows, jflows):
        assert (fl[:, :, 1] == -10000.0).all()
        assert (fl[:, :, 0] != -10000.0).all()
    assert (tm.obs[:, 1] < -9000.0).all()
    # condition 0 alone: a finite gradient (port)
    tm0 = dataclasses.replace(tm, cond=tm.cond.select([0]),
                              obs=tm.obs[:, :1])
    _, g0, _ = _port_grads(tm0, thetas)
    assert np.isfinite(g0).all()


@pytest.fixture(scope="module")
def transient_pair():
    # a short per-step-factored schedule on the plain loops
    return methanation_pair(2, 11, n_steps=6, growth=1.6, jac_stride=1,
                            dense_tail=0, particle_chunk=4, solver="thomas")


def test_transient_gradient_through_the_plain_loops(transient_pair):
    """march="transient" with solver="thomas": autograd through the plain
    loops against jax.grad through the JAX package's scans, within 1% of
    each parameter's largest |gradient| (a 6-step march rounds rows and
    blocks differently in each package). With "auto" (the kernels) the
    gradient kinds raise ValueError."""
    jm, tm = transient_pair
    jll, jg, _ = _jax_grads(jm, THETAS)
    ll, g, _ = _port_grads(tm, THETAS)
    assert np.isfinite(g).all()
    np.testing.assert_allclose(ll, jll, rtol=1e-3, atol=0.05)
    scale = np.abs(jg).max(axis=0)
    assert (np.abs(g - jg) <= 1e-2 * scale).all(), (g, jg)
    auto = dataclasses.replace(tm, solver="auto")
    with pytest.raises(ValueError, match="no backward"):
        _make_ll_and_grad(auto.log_likelihood)(torch.from_numpy(THETAS))
    with pytest.raises(ValueError, match="no backward"):
        run_smc(auto, SMCConfig(n_particles=8, mutation="mala"), 0,
                verbose=False)


@pytest.mark.parametrize("solver", ["thomas", "cr", "babe"])
def test_lagged_transient_gradient_matches_central_differences(solver):
    """The default kind of schedule (lagged Jacobian, predictor, cj
    compensation, dense tail) differentiated through each plain solver,
    port only: Af, Eaf and sigma within 10% of central differences at
    1e-3 |theta|, at a theta off the truth (where the gradient is not a
    residual of cancelling noise terms)."""
    _, tm = methanation_pair(2, 11, n_steps=12, growth=1.6, jac_stride=3,
                             dense_tail=3, particle_chunk=4, solver=solver)
    th0 = THETAS[1]
    _, g, _ = _port_grads(tm, th0[None])

    def f(th):
        return float(tm.log_likelihood(torch.from_numpy(th[None]))[0][0])
    for i in (0, 1, 4):
        eps = 1e-3 * abs(th0[i])
        tp, tn = th0.copy(), th0.copy()
        tp[i] += eps
        tn[i] -= eps
        fd = (f(tp) - f(tn)) / (2 * eps)
        assert abs(g[0, i] - fd) < 0.1 * abs(fd), (i, g[0, i], fd)



"""The gradient half of the port's mutation against the JAX package on the
CPU: the per-row value and gradient (``_make_ll_and_grad``, one backward
pass of the row sum through torch.autograd against one VJP through
jax.grad) on every differentiable likelihood the port has, and one MALA
and one HMC core (propose, evaluate, accept) fed the same particles,
gradients, covariance factors and draws on both sides."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smc_tpu import SMCConfig as JaxConfig
from smc_tpu.models.michaelis_menten import (MichaelisMentenModel as JaxMM,
                                             generate_mm_pseudo_data as jgen)
from smc_tpu.models.synthetic import (BananaModel as JaxBanana,
                                      GaussianMixtureModel as JaxGMM)
from smc_tpu.priors import Prior as JaxPrior
from smc_tpu.smc import kernels as jk
from smc_tpu_torch import SMCConfig, convert, mutate
from smc_tpu_torch.priors import Prior
from smc_tpu_torch.smc import kernels as tk
from tests.torch_parity import ReplayDraws, assert_ll_close

N = 256
_PRIOR = dict(kind=[0, 0, 0], low=[0.0] * 3, high=[10.0] * 3,
              loc=[5.0] * 3, scale=[10.0] * 3)
TRUTH = (1.2, 0.5, 0.02)


@dataclasses.dataclass(frozen=True)
class JaxGaussian:
    """tests/test_mala.py's Gaussian target, in JAX."""
    prior: object
    mu: tuple = (1.5, -2.0, 0.5)
    s: float = 0.3

    def log_likelihood(self, theta):
        d = theta - jnp.asarray(self.mu, theta.dtype)
        return -0.5 * jnp.sum(d * d, axis=1) / self.s ** 2, None


@dataclasses.dataclass(frozen=True)
class TorchGaussian:
    """The same target in the port."""
    prior: object
    mu: tuple = (1.5, -2.0, 0.5)
    s: float = 0.3

    def log_likelihood(self, theta):
        d = theta - theta.new_tensor(self.mu)
        return -0.5 * torch.sum(d * d, dim=1) / self.s ** 2, None


def _mm_pair(method):
    """The JAX and the port's MM model of method ``method`` on the JAX
    package's pseudo-data."""
    ts, obs, s0 = jgen()
    jm = JaxMM(obs=jnp.asarray(obs), s0=jnp.asarray(s0), ts=jnp.asarray(ts),
               prior=JaxPrior.uniform([0.0] * 3, [10.0] * 3), method=method)
    return jm, convert.mm_model_from_numpy(obs, s0, ts, _PRIOR,
                                           method=method, device="cpu")


def _pair(case):
    if case in ("exact", "rk4"):
        return _mm_pair(case)
    if case == "banana":
        jm = JaxBanana()
        return jm, convert.banana_model_from_numpy(
            dict(kind=[0, 0], low=[-6.0, -10.0], high=[6.0, 40.0],
                 loc=[0.0, 15.0], scale=[12.0, 50.0]), device="cpu")
    if case == "gmm":
        jm = JaxGMM.default()
        p = jm.prior
        return jm, convert.gmm_model_from_numpy(
            np.asarray(jm.means), np.asarray(jm.stds),
            np.asarray(jm.log_weights),
            {f: np.asarray(getattr(p, f)) for f in
             ("kind", "low", "high", "loc", "scale")}, device="cpu")
    return (JaxGaussian(JaxPrior.uniform([-8.0] * 3, [8.0] * 3)),
            TorchGaussian(Prior.uniform([-8.0] * 3, [8.0] * 3,
                                        device="cpu")))


def _theta(case, n=N, seed=0):
    """Rows around each target's mass, float32; the MM rows include sigma
    <= 0 (ll = -inf) and Km = 0."""
    rng = np.random.default_rng(seed)
    if case in ("exact", "rk4"):
        th = np.abs(np.asarray(TRUTH) + rng.normal(size=(n, 3))
                    * [0.3, 0.3, 0.01])
        th[::17, 2] = -0.01
        th[3::29, 2] = 0.0
        th[7::31, 1] = 0.0
        return th.astype(np.float32)
    if case == "banana":
        x0 = rng.normal(size=n) * 1.5
        return np.stack([x0, x0 ** 2 + rng.normal(size=n) * 0.5],
                        1).astype(np.float32)
    if case == "gmm":
        return (rng.uniform(-11.0, 11.0, size=(n, 2))).astype(np.float32)
    return (np.asarray([1.5, -2.0, 0.5]) + rng.normal(size=(n, 3))
            ).astype(np.float32)


@pytest.mark.parametrize("case", ["exact", "rk4", "banana", "gmm",
                                  "gaussian"])
def test_ll_and_grad_matches_jax(case):
    """Same -inf rows (with gradient 0 on both sides), log-likelihoods as
    the likelihood tests hold them, and gradients within 1e-4 of each row's
    largest |g|. MM ``rk4`` is held where Km >= 0.3: below it fp32 RK4 is
    chaotic (tests/test_torch_mm_rk4.py) and so is its gradient."""
    jm, tm = _pair(case)
    th = _theta(case)
    jl, jg = (np.asarray(a) for a in jax.jit(
        jk._make_ll_and_grad(jm.log_likelihood))(jnp.asarray(th)))
    tl, tg = (a.numpy() for a in tk._make_ll_and_grad(tm.log_likelihood)(
        torch.from_numpy(th)))
    np.testing.assert_array_equal(np.isinf(tl), np.isinf(jl))
    assert not np.isnan(tl).any() and not np.isnan(tg).any()
    inf = np.isinf(jl)
    assert (tg[inf] == 0).all() and (jg[inf] == 0).all()
    keep = ~inf
    if case in ("exact", "rk4"):
        assert inf.sum() >= N // 17
        if case == "rk4":
            keep &= th[:, 1] >= 0.3
        assert_ll_close(tl[keep], jl[keep], th[keep], 6, 40, 2e-5)
    else:
        np.testing.assert_allclose(tl, jl, rtol=1e-6, atol=1e-6)
    assert keep.sum() > N // 2
    row = np.abs(jg[keep]).max(1, keepdims=True)
    assert (np.abs(tg[keep] - jg[keep]) <= 1e-4 * row).all()


def _core_inputs(kind, gamma=0.1, ratio=0.8, seed=1):
    """Shared inputs of one MM-exact sweep core: particles, their log-lik,
    log-prior and gradient (the JAX package's), the port's draw (its
    covariance factors, held against JAX's), z and log u."""
    jm, tm = _mm_pair("exact")
    rng = np.random.default_rng(seed)
    parts = np.abs(np.asarray(TRUTH) + rng.normal(size=(N, 3))
                   * [0.05, 0.05, 0.003]).astype(np.float32)
    lk, g = (np.asarray(a) for a in jax.jit(
        jk._make_ll_and_grad(jm.log_likelihood))(jnp.asarray(parts)))
    lp = np.asarray(jm.prior.log_pdf(jnp.asarray(parts)))
    z = rng.normal(size=(N, 3)).astype(np.float32)
    u = rng.uniform(size=N).astype(np.float32)
    cfg = SMCConfig(n_particles=N, mutation=kind, hmc_leapfrog=3)
    init, draw, _, _, _ = tk.make_mutation_parts(kind, tm.log_likelihood,
                                                 tm.prior, cfg)
    c0 = init(ReplayDraws([("normal", z), ("uniform", u)]),
              torch.from_numpy(parts), torch.from_numpy(lk),
              torch.from_numpy(g))
    _, aux_g, (tz, log_u) = draw(c0)
    cov = np.asarray(jk._weighted_cov(jnp.asarray(parts),
                                      jnp.full((3, 3), 0.5)))
    chol = np.linalg.cholesky(cov.astype(np.float64))
    want = {"cov": cov, "chol": chol, "linv": np.linalg.inv(chol)}
    names = ("cov", "chol", "linv") if kind == "mala" else ("chol",)
    for name, got in zip(names, aux_g):
        np.testing.assert_allclose(got.numpy(), want[name], rtol=2e-4,
                                   atol=1e-6 * np.abs(want[name]).max())
    args = [parts, lk, lp, g, np.float32(ratio)]
    return jm, tm, cfg, args, aux_g, tz, log_u, np.float32(gamma)


@pytest.mark.parametrize("kind", ["mala", "hmc"])
def test_gradient_core_matches_jax(kind):
    """One MALA or HMC core (HMC: 3 leapfrog steps) on the same particles,
    log-likelihoods, log-priors, gradients, ratio, factors, z, log u and
    gamma in both packages: the accept decisions agree except on rows
    whose decision moves when log u moves by 1e-3 (fp32 rounding of
    log-likelihoods near 600 reaches that far), and the accepted rows'
    particles, log-likelihoods and gradients agree (particles to 1e-5,
    log-likelihoods as the likelihood tests hold them, gradients within
    1e-3 of each row's largest |g|: HMC's end point carries three
    gradient evaluations)."""
    jm, tm, cfg, args, aux_g, z, log_u, gamma = _core_inputs(kind)
    jcfg = JaxConfig(n_particles=N, mutation=kind, hmc_leapfrog=3)
    j_core = jk.make_mutation_parts(kind, jm.log_likelihood, jm.prior,
                                    jcfg)[2]
    jp, jl, _, jg, jacc = (np.asarray(a) for a in jax.jit(j_core)(
        *(jnp.asarray(a) for a in args),
        tuple(jnp.asarray(a.numpy()) for a in aux_g),
        (jnp.asarray(z.numpy()), jnp.asarray(log_u.numpy())),
        jnp.asarray(gamma)))
    t_core = tk.make_mutation_parts(kind, tm.log_likelihood, tm.prior,
                                    cfg)[2]
    targs = [torch.tensor(a) for a in args]

    def port(shift):
        return t_core(*targs, aux_g, (z, log_u + shift), torch.tensor(gamma))
    tp, tl, _, tg, tacc = (a.numpy() for a in port(0.0))
    near = port(-1e-3)[4].numpy() != port(1e-3)[4].numpy()
    differ = tacc != jacc
    assert not (differ & ~near).any()
    assert 0.1 < jacc.mean() < 0.95, jacc.mean()
    both = tacc & jacc
    np.testing.assert_allclose(tp[both], jp[both], rtol=0, atol=1e-5)
    assert_ll_close(tl[both], jl[both], tp[both], 6, 40, 2e-5)
    row = np.abs(jg[both]).max(1, keepdims=True)
    assert (np.abs(tg[both] - jg[both]) <= 1e-3 * row).all()
    rejected = ~tacc
    assert np.array_equal(tp[rejected], args[0][rejected])


def test_gradient_kinds_refuse_the_kernels():
    """A gradient kind on the CUDA kernels' likelihood raises ValueError
    (here through the kernel's plain version, which carries no graph
    either); the JAX package cannot differentiate its Pallas kernel
    (interpret mode) either."""
    jm, tm = _mm_pair("pallas_exact")
    th = _theta("exact", n=16)
    with pytest.raises(Exception):
        jax.grad(lambda t: jnp.sum(jm.log_likelihood(t)[0]))(jnp.asarray(th))
    x = torch.from_numpy(np.abs(th))
    cfg = SMCConfig(n_particles=16, mutation="hmc")
    with pytest.raises(ValueError, match="'pallas_exact'.*no backward"):
        mutate(None, x, tm.log_likelihood(x)[0], torch.tensor(0.5),
               tm.log_likelihood, tm.prior, cfg)

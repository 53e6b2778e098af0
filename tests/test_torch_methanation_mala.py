"""The methanation gradient's consumers in the port, on the CPU: a small
MALA run on the steady model to gamma = 1 (the configuration of
``tests/test_mala.py::test_mala_steady_methanation_small``) and
``map_estimate`` through the steady solve's implicit-function adjoint.
Port only: the JAX package's counterparts are ``tests/test_mala.py`` and
``tests/test_opt.py``; the gradient itself is held against ``jax.grad`` in
``test_torch_methanation_grad.py``.
"""
import numpy as np
import torch

import tests.torch_parity  # noqa: F401  (one PyTorch thread)
from smc_tpu_torch import SMCConfig, run_smc
from smc_tpu_torch.models import methanation as TM
from smc_tpu_torch.opt import map_estimate
from smc_tpu_torch.rng import as_draws


def test_mala_on_the_steady_model_reaches_gamma_one():
    """tests/test_mala.py::test_mala_steady_methanation_small in the port
    (2 conditions, nx = 11, est (Af, sigma), N = 48): gamma reaches 1 with
    finite particles and sigma's posterior mean in (0.5, 15). Af's drift is
    zero on this table: condition 1's march fails at every particle (the
    test in test_torch_methanation_grad.py), its gradient is non-finite
    and MALA sets it to 0, so Af
    moves by the proposal's noise alone, as in the JAX package."""
    model = TM.MethanationModel.default(
        n_conditions=2, nx=11, n_steps=6, growth=1.6, est_idx=(0, 8),
        particle_chunk=48, march="steady", device="cpu")
    cfg = SMCConfig(n_particles=48, mutation="mala", mh_steps=2,
                    mh_steps_final=3, max_steps=25)
    st = run_smc(model, cfg, 0, verbose=False)
    p = st.particles.numpy()
    assert float(st.gamma) == 1.0
    assert np.isfinite(p).all()
    assert 0.5 < p[:, 1].mean() < 15.0


def test_map_estimate_on_a_small_steady_model():
    """map_estimate runs through the adjoint (tests/test_methanation_grad.py's
    model size: nx = 15, 3 conditions): from 2 prior starts, 12 Adam steps
    and 3 polish steps, every start's log-posterior finite and the best no
    lower than the best start's."""
    tm = TM.MethanationModel.default(
        n_conditions=3, nx=15, n_steps=40, growth=1.3, particle_chunk=4,
        newton_iters=3, march="steady", device="cpu")
    res = map_estimate(tm, 0, n_starts=2, steps=12)
    assert torch.isfinite(res.log_post).all()
    assert torch.isfinite(res.theta).all()
    start = tm.prior.sample(as_draws(0, tm.prior.device), 2)
    v0 = tm.log_likelihood(start)[0] + tm.prior.log_pdf(start)
    assert float(res.log_post) >= float(v0.max()) - 1e-3


def test_mala_ensemble_on_the_steady_model():
    """The ensemble's MALA part on a steady methanation data likelihood
    (the flows of a (D, N) batch in one pass, each population's Gaussian
    term against its own observations, as smc/sbc.py's methanation problem
    builds it): two populations of 16 reach gamma = 1 with finite
    particles, and each population's sigma mean lies in (0.5, 15)."""
    from smc_tpu_torch.smc.ensemble import run_ensemble_on_device
    model = TM.MethanationModel.default(
        n_conditions=2, nx=11, est_idx=(0, 8), particle_chunk=32,
        march="steady", device="cpu")
    gen = torch.Generator().manual_seed(3)
    obs = model.obs[None] + 5.0 * torch.randn((2,) + model.obs.shape,
                                              generator=gen)

    def loglik(theta, obs):
        d, n = theta.shape[0], theta.shape[1]
        flows, sigma = model._flows_and_sigma(theta.reshape(d * n, -1))
        flows = flows.reshape((d, n) + flows.shape[1:])
        return model._ll_from_flows(flows, sigma.reshape(d, n),
                                    obs[:, None]), flows

    cfg = SMCConfig(n_particles=16, mutation="mala", mh_steps=2,
                    mh_steps_final=2, max_steps=25)
    st = run_ensemble_on_device(0, model.prior, loglik, obs, 2, cfg)
    p = st.particles.numpy()
    assert (st.gamma == 1.0).all()
    assert np.isfinite(p).all()
    assert ((0.5 < p[..., 1].mean(1)) & (p[..., 1].mean(1) < 15.0)).all()

"""The plain references (``portbench/reference/``) against the program at
small sizes on the CPU. The tests import the program; the references do
not."""
import math

import numpy as np
import pytest
import torch

from portbench.reference import methanation as ref_meth
from portbench.reference import mm as ref_mm
from portbench.reference import smc as ref_smc

KNOBS = dict(ess_limit=0.5, d_gamma_max=1.0, gamma_reduction_rate=0.7,
             gamma_reduction_iters=80)


def _mm_problem(n, seed=0):
    from smc_tpu_torch.models.michaelis_menten import (
        MM_S0_LIST, generate_mm_pseudo_data)
    ts, obs, s0 = generate_mm_pseudo_data(seed=20250205 + seed)
    g = torch.Generator().manual_seed(seed)
    theta = torch.stack([1.2 + 0.05 * torch.randn(n, generator=g),
                         0.5 + 0.03 * torch.randn(n, generator=g),
                         0.02 + 0.003 * torch.rand(n, generator=g)], 1)
    assert len(MM_S0_LIST) == obs.shape[0]
    return ts, obs, s0, theta


@pytest.mark.parametrize("method", ["exact", "pallas_exact"])
def test_mm_likelihood_matches_the_port(method):
    from smc_tpu_torch.models.michaelis_menten import MichaelisMentenModel
    ts, obs, s0, theta = _mm_problem(256)
    model = MichaelisMentenModel.default(obs=obs, s0=s0, ts=ts,
                                         method=method, device="cpu")
    got = model.log_likelihood(theta.float())[0].double()
    want = ref_mm.log_likelihood(theta.double(), torch.as_tensor(obs),
                                 torch.as_tensor(s0), torch.as_tensor(ts))
    assert float((got - want).abs().max()) < 2e-3


def test_mm_likelihood_rejects_nonpositive_sigma():
    ts, obs, s0, theta = _mm_problem(4)
    theta = theta.double()
    theta[1, 2] = 0.0
    theta[2, 1] = -1.0
    ll = ref_mm.log_likelihood(theta, torch.as_tensor(obs),
                               torch.as_tensor(s0), torch.as_tensor(ts))
    assert math.isinf(ll[1]) and math.isinf(ll[2]) and ll[0].isfinite()


def test_lambertw_solves_its_equation():
    L = torch.linspace(-50, 60, 2001, dtype=torch.float64)
    w = ref_mm.lambertw_log(L)
    assert float((w + torch.log(w) - L).abs().max()) < 1e-12


def test_gamma_search_matches_the_port():
    from smc_tpu_torch.config import SMCConfig
    from smc_tpu_torch.smc.kernels import find_gamma
    g = torch.Generator().manual_seed(3)
    cfg = SMCConfig(n_particles=4096)
    for g0 in (0.0, 0.01, 0.4):
        ll = 50.0 * torch.randn(2, 4096, generator=g)
        gamma0 = torch.full((2,), g0)
        port = find_gamma(ll, gamma0, cfg)
        gam, w, ess, logz, k = ref_smc.gamma_search(ll.double(),
                                                    gamma0.double(), KNOBS)
        assert torch.equal(k.to(torch.int32), port.n_reductions)
        assert torch.allclose(gam.float(), port.gamma, rtol=1e-6)
        assert torch.allclose(ess.float(), port.ess, rtol=1e-4)
        assert torch.allclose(logz.float(), port.log_z_inc, rtol=1e-5,
                              atol=1e-3)
        assert torch.allclose(w.float(), port.weights, rtol=1e-3,
                              atol=1e-9)


def test_residual_systematic_matches_the_port():
    from smc_tpu_torch.smc.kernels import residual_systematic_counts
    g = torch.Generator().manual_seed(5)
    for n in (7, 1000):
        w = torch.rand(3, n, generator=g) ** 4
        w = w / w.sum(-1, keepdim=True)
        u = torch.rand(3, generator=g)
        port = residual_systematic_counts(u, w.float())
        anc = ref_smc.residual_systematic(w.double(), u.double())
        counts = torch.stack([torch.bincount(a, minlength=n) for a in anc])
        assert int(counts.sum()) == 3 * n
        assert int((counts - port.long()).abs().sum()) <= 2


def test_methanation_march_matches_the_port():
    """The float64 copy of the march against the port's float32 march on
    the CPU, at a small grid: the same flows to float32's rounding."""
    from smc_tpu_torch.models.methanation import (KIN_TRUE, MethanationModel,
                                                  make_condition_table,
                                                  methanation_prior)
    kw = dict(nx=11, n_steps=12, growth=1.6, jac_stride=3, dense_tail=3)
    cond = make_condition_table(3, nx=11, device="cpu")
    model = MethanationModel(cond=cond, obs=torch.zeros(5, 3),
                             prior=methanation_prior(device="cpu"), **kw)
    g = torch.Generator().manual_seed(0)
    kin = torch.tensor(KIN_TRUE, dtype=torch.float64).repeat(4, 1)
    kin[:, :4] *= 1 + 0.02 * torch.randn(4, 4, generator=g,
                                         dtype=torch.float64)
    got = model._flows_batch_bl(kin.float()).double()
    m = dict(kw, t_final=75.0, newton_iters=2, reuse_iters=1)
    want = ref_meth.outlet_flows(kin, ref_meth.condition_table(3, 11), m)
    assert got.shape == want.shape
    assert float(((got - want).abs() / want.abs().clamp_min(1.0)).max()) \
        < 1e-4
    table = ref_meth.condition_table(3, 11)
    assert np.allclose(table["u_in"], cond.u_in.numpy(), rtol=1e-6)

"""A run whose timed path is broken underneath comes out not correct:
the whole of a run (set-up, window, check) on the CPU at a small size,
with the program patched, once for each fault a cell can have: a run or
step returning its state unchanged, half the batch left out, an answer
altered where it is produced, a mutation that leaves the particles
where they are (in one posterior and in the ensemble), a resampler that
selects wrongly, and a gradient that is zero or whose backward is
wrong. (One card: no exchange between chips to leave out.)"""
import time

import pytest
import torch

from portbench.harness import cell, program, spec

from .conftest import SMALL


def _run(name, seconds=1.0, overrides=None):
    return cell.run_cell(name, 12345678901234, seconds, False, "cpu",
                         time.perf_counter(),
                         overrides=spec._merge(SMALL[name], overrides))


def _ll(name):
    """The log-likelihood number a cell compares."""
    limits = spec.cell(name)["traffic"]["check"]["limits"]
    return "ll_gap_q" if "ll_gap_q" in limits else "ll_gap"


def _limit(name):
    return spec.cell(name)["traffic"]["check"]["limits"][_ll(name)]


def _broken_loglik(fn, fault, shift):
    """``fn`` with a fault where its answer is produced: half the batch
    left out (the rest given their mean), or every answer moved."""
    def wrapped(*a, **k):
        ll, aux = fn(*a, **k)
        if fault == "half":
            h = ll.shape[-1] // 2
            ll = torch.cat([ll[..., :h], ll[..., :h].mean(-1, keepdim=True)
                            .expand_as(ll[..., h:])], -1)
        else:
            ll = ll + shift
        return ll, aux
    return wrapped


def test_the_cells_pass_unbroken():
    for name in ("mm-rwm-n1e5", "methanation-rwm-n1000"):
        out = _run(name)
        assert out["correct"], out


def test_mm_run_returning_its_state_unchanged(monkeypatch):
    from smc_tpu_torch import init_state
    monkeypatch.setattr(program, "full_run",
                        lambda model, cfg: lambda key: init_state(
                            key, model, cfg))
    out = _run("mm-rwm-n1e5")
    assert not out["correct"] and out["failed"] > 0


@pytest.mark.parametrize("fault", ["half", "altered"])
def test_mm_likelihood_faults(monkeypatch, fault):
    from smc_tpu_torch.models import michaelis_menten as mm
    orig = mm.MichaelisMentenModel.log_likelihood
    monkeypatch.setattr(mm.MichaelisMentenModel, "log_likelihood",
                        _broken_loglik(orig, fault,
                                       10 * _limit("mm-rwm-n1e5")))
    out = _run("mm-rwm-n1e5")
    assert not out["correct"]
    assert out["checks"]["ll_gap"]["value"] > _limit("mm-rwm-n1e5")


def test_methanation_step_returning_its_state_unchanged(monkeypatch):
    real = program.stepper

    def stepper(model, cfg):
        init, _ = real(model, cfg)
        return init, lambda s: s
    monkeypatch.setattr(program, "stepper", stepper)
    out = _run("methanation-rwm-n1000")
    assert not out["correct"]
    assert out["checks"]["gamma_rule"]["value"] > 0


@pytest.mark.parametrize("fault", ["half", "altered"])
def test_methanation_likelihood_faults(monkeypatch, fault):
    from smc_tpu_torch.models import methanation as meth
    orig = meth.MethanationModel.log_likelihood
    name = "methanation-rwm-n1000"
    monkeypatch.setattr(meth.MethanationModel, "log_likelihood",
                        _broken_loglik(orig, fault, 10 * _limit(name)))
    out = _run(name)
    assert not out["correct"]
    assert out["checks"][_ll(name)]["value"] > _limit(name)


MM = ["mm-rwm-n1e5", "mm-ensemble-64x2048"]


def _post_failed(name, out):
    lim = spec.cell(name)["traffic"]["check"]["limits"]["post_ll_ks"]
    assert not out["correct"]
    assert out["failed"] > 0 or out["checks"]["post_ll_ks"]["value"] > lim


@pytest.mark.parametrize("name", MM)
def test_mm_mutation_leaving_the_particles_unchanged(monkeypatch, name):
    from smc_tpu_torch.smc import ensemble, kernels
    real = kernels.make_mutation_sweeper

    def sweeper(*a, **k):
        init_fn, sweep_fn = real(*a, **k)

        def sweep(c, *rest):
            return sweep_fn(c, *rest)._replace(
                particles=c.particles, log_lik=c.log_lik,
                log_prior=c.log_prior, grad=c.grad)
        return init_fn, sweep
    monkeypatch.setattr(kernels, "make_mutation_sweeper", sweeper)
    monkeypatch.setattr(ensemble, "make_mutation_sweeper", sweeper)
    _post_failed(name, _run(name))


@pytest.mark.parametrize("name", MM)
@pytest.mark.parametrize("fault", ["identity", "biased"])
def test_mm_resampling_faults(monkeypatch, name, fault):
    """The resampler keeps every particle once, or selects by the weights'
    fourth power (biased toward the heaviest particles). Kept once, the
    particles never reach gamma = 1: a run stops at 15 steps here, not
    50, and fails all the same."""
    from smc_tpu_torch.smc import driver, ensemble
    if fault == "identity":
        def keep(g, state, cfg, psh=None):
            return state.particles, state.log_lik
        monkeypatch.setattr(driver, "_resample", keep)
        monkeypatch.setattr(ensemble, "_resample", keep)
        over = {"config": {"smc": {"max_steps": 15}}}
    else:
        real = driver.resample_apply

        def biased(u, w, parts, lk, scheme):
            w4 = w ** 4
            return real(u, w4 / w4.sum(-1, keepdim=True), parts, lk, scheme)
        monkeypatch.setattr(driver, "resample_apply", biased)
        over = None
    _post_failed(name, _run(name, overrides=over))


@pytest.mark.parametrize("fault", ["zero", "half_backward"])
def test_mala_gradient_faults(monkeypatch, fault):
    """The likelihood-and-gradient function returns a zero gradient, or
    the likelihood's backward gives half the gradient (its values
    unchanged)."""
    name = "methanation-mala-n1000"
    if fault == "zero":
        from smc_tpu_torch.smc import kernels
        real = kernels._make_ll_and_grad

        def zero(fn):
            inner = real(fn)

            def ll_and_grad(th):
                ll, g = inner(th)
                return ll, torch.zeros_like(g)
            return ll_and_grad
        monkeypatch.setattr(kernels, "_make_ll_and_grad", zero)
    else:
        from smc_tpu_torch.models import methanation as meth
        real = meth.MethanationModel.log_likelihood

        def half(self, theta):
            ll, aux = real(self, theta)
            return ll.detach() + 0.5 * (ll - ll.detach()), aux
        monkeypatch.setattr(meth.MethanationModel, "log_likelihood", half)
    out = _run(name)
    lim = spec.cell(name)["traffic"]["check"]["limits"]["grad_gap_q"]
    assert not out["correct"]
    assert out["checks"]["grad_gap_q"]["value"] > lim

"""The one general generator: a closed loop with one client, driving the
program through the entry point a traffic mix names (``"driver"``).

- ``full_run``: one posterior per request, ``make_full_run_on_device``
  from a fresh run key on the dataset made at set-up;
- ``ensemble``: ``n_populations`` posteriors per request,
  ``make_ensemble_run`` with a fresh key and fresh noisy datasets;
- ``steps``: back-to-back posteriors, one request per SMC step
  (``init_state``, then the graphed ``make_smc_step``); a posterior whose
  step reaches gamma = 1 is complete and the next one starts.

A driver builds its inputs and the program in ``__init__`` (set-up),
serves ``request(i)``, keeps what the check needs, frees the program
(``free``) and compares (``numbers``). Its ``shapes`` are the shapes of
the kernels' launches that the cost files count.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench.harness import check, inputs, program


class _Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from a
    seeded generator (reservoir sampling)."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.items, self.seen = k, rng, [], 0

    def offer(self, item):
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def _label(name):
    """A host span the traced slice attributes idle gaps to."""
    return torch.profiler.record_function(name)


def _host(state):
    """The posterior on the host: particles, log-likelihoods and the
    scalars (gamma, log-evidence, evaluations, steps)."""
    with _label("portbench.to_host"):
        scal = torch.stack([state.gamma.to(torch.float64),
                            state.log_evidence.to(torch.float64),
                            state.total_lik_evals.to(torch.float64),
                            state.step.to(torch.float64)]).cpu()
        return dict(particles=state.particles.cpu(),
                    log_lik=state.log_lik.cpu(), gamma=scal[0],
                    log_evidence=scal[1], evals=scal[2], steps=scal[3])


class _MM:
    """What the two Michaelis-Menten drivers share: the grid, the truth,
    the sample of requests kept for the check, and the check."""

    def _mm_setup(self, cell, seed, device):
        self.cfg, self.traffic = cell["config"], cell["traffic"]
        self.seed, self.device = seed, device
        self.ts, self.s0 = inputs.mm_grid(self.cfg)
        self.truth = inputs.mm_truth(self.cfg)
        self.smc_cfg = program.smc_config(self.cfg, self.traffic)
        self.n = self.traffic["n_particles"]
        self.keep = _Reservoir(self.traffic["check"]["requests"],
                               inputs.rng(seed, "sample-requests"))

    def _ref_ll(self, theta, obs):
        from portbench.reference import mm
        dt, dev = theta.dtype, theta.device
        return mm.log_likelihood(
            theta, obs.to(dev, dt),
            torch.as_tensor(self.s0, device=dev, dtype=dt),
            torch.as_tensor(self.ts, device=dev, dtype=dt))

    def _numbers(self, pairs, control=None):
        """Over the kept requests (``pairs``: (request index, host result,
        obs (P, n_ds, T))): ``ll_gap`` over a seeded sample of particles
        of each posterior, and ``post_ll_ks``, the 90th percentile (the
        nearest reading at or above it) of the KS distances of a seeded
        sample of each request's posteriors (the one of a single run).
        At 2,048 particles an ensemble's population now and then
        collapses onto a few points (about one in a hundred on the card;
        PERF.md), so the ensemble's number is a quantile over 32
        posteriors, which a fault in more than a tenth of them still
        moves. The claimed values are the program's, or with ``control``
        (a dtype) the reference's in that precision: the log-likelihoods
        at the same particles, and the posterior's distribution of the
        log-likelihood by its importance sample."""
        chk = self.traffic["check"]
        gen = inputs.rng(self.seed, "sample-particles")
        pgen = inputs.rng(self.seed, "sample-populations")
        gap, ks = 0.0, []
        for i, res, obs in pairs:
            parts = res["particles"].reshape(-1, self.n, 3)
            lls = res["log_lik"].reshape(-1, self.n)
            idx = torch.as_tensor(np.sort(gen.choice(
                self.n, min(chk["particles"], self.n), replace=False)))
            th = parts[:, idx].to(self.device, torch.float64)
            o = obs[:, None].to(self.device)
            ref = self._ref_ll(th, o)
            claim = (lls[:, idx].to(self.device) if control is None
                     else self._ref_ll(th.to(control), o))
            gap = max(gap, check.ll_gap(claim, ref))
            pops = parts.shape[0]
            for p in np.sort(pgen.choice(pops, min(chk["populations"], pops),
                                         replace=False)):
                ks.append(self._post_ks(parts[p], obs[p], control,
                                        (i, int(p))))
        return dict(ll_gap=gap, post_ll_ks=check.quantile(torch.tensor(ks)))

    def _post_ks(self, parts, obs, control, label):
        """post_ll_ks of one posterior: its particles (N, 3) and dataset
        (n_ds, T). The program's claim is the reference's log-likelihood
        at each of its particles, equally weighted; the reference's is
        the exact posterior's distribution of the log-likelihood, by
        importance sampling around the maximum-likelihood point found
        from the configuration's truth, with draws from the seed."""
        from portbench.reference import mm
        dev = self.device
        pr, tp = self.cfg["prior"], self.cfg["true_params"]
        args = (obs.to(dev), torch.as_tensor(self.s0, device=dev),
                torch.as_tensor(self.ts, device=dev), pr["low"], pr["high"],
                [tp["vmax"], tp["km"], tp["noise_std"]])

        def draws():
            return inputs.generator(self.seed, dev, "posterior", *label)
        ref, w = mm.posterior_log_lik(*args, draws())
        if control is None:
            claim = self._ref_ll(parts.to(dev, torch.float64), obs.to(dev))
            cw = torch.full_like(claim, 1.0 / claim.numel())
        else:
            claim, cw = mm.posterior_log_lik(*args, draws(), dtype=control)
        return check.ks(claim, cw, ref, w)


class FullRun(_MM):
    def __init__(self, cell, seed, device):
        self._mm_setup(cell, seed, device)
        self.obs = inputs.mm_obs(self.cfg, self.truth,
                                 inputs.generator(seed, device, "obs"),
                                 None, device)
        model = program.mm_model(self.cfg, self.obs, self.ts, self.s0,
                                 device)
        self.run = program.full_run(model, self.smc_cfg)
        self.shapes = {"mm_loglik": dict(b=1, n=self.n,
                                         n_ds=self.truth.shape[0],
                                         n_obs=self.truth.shape[1])}

    def warm(self):
        self.run(program.draws(inputs.derive(self.seed, "warm"),
                               self.device))

    def request(self, i):
        key = program.draws(inputs.derive(self.seed, "request", i),
                            self.device)
        t0 = time.perf_counter()
        with _label("portbench.request"):
            res = _host(self.run(key))
        lat = time.perf_counter() - t0
        self.keep.offer((i, res))
        ok = float(res["gamma"]) == 1.0 and bool(
            torch.isfinite(res["log_evidence"]))
        return dict(latency=lat, posteriors=1, evals=float(res["evals"]),
                    failed=0 if ok else 1)

    def free(self):
        del self.run
        gc.collect()

    def numbers(self, control=None):
        obs = self.obs[None]
        return self._numbers([(i, r, obs) for i, r in self.keep.items],
                             control)


class Ensemble(_MM):
    def __init__(self, cell, seed, device):
        self._mm_setup(cell, seed, device)
        self.pops = self.traffic["n_populations"]
        loglik = program.mm_data_loglik(self.cfg, self.ts, self.s0, device)
        self.run = program.ensemble_run(self.cfg, loglik, self.pops,
                                        self.smc_cfg, device)
        self.shapes = {"mm_loglik": dict(b=self.pops, n=self.n,
                                         n_ds=self.truth.shape[0],
                                         n_obs=self.truth.shape[1])}

    def data(self, i):
        return inputs.mm_obs(self.cfg, self.truth, inputs.generator(
            self.seed, self.device, "data", i), self.pops, self.device)

    def warm(self):
        self.run(program.draws(inputs.derive(self.seed, "warm"),
                               self.device), self.data("warm"))

    def request(self, i):
        key = program.draws(inputs.derive(self.seed, "request", i),
                            self.device)
        data = self.data(i)
        t0 = time.perf_counter()
        with _label("portbench.request"):
            res = _host(self.run(key, data))
        lat = time.perf_counter() - t0
        self.keep.offer((i, res))
        ok = bool((res["gamma"] == 1.0).all()) and bool(
            torch.isfinite(res["log_evidence"]).all())
        return dict(latency=lat, posteriors=self.pops,
                    evals=float(res["evals"].sum()), failed=0 if ok else 1)

    def free(self):
        del self.run
        gc.collect()

    def numbers(self, control=None):
        return self._numbers([(i, r, self.data(i))
                              for i, r in self.keep.items], control)


class Steps:
    def __init__(self, cell, seed, device):
        self.cfg, self.traffic = cell["config"], cell["traffic"]
        self.seed, self.device = seed, device
        self.obs = inputs.methanation_obs(self.cfg, seed)
        self.smc_cfg = program.smc_config(self.cfg, self.traffic)
        self.n = self.traffic["n_particles"]
        self.model = program.methanation_model(self.cfg, self.obs, device)
        self.init, self.step = program.stepper(self.model, self.smc_cfg)
        self.grads = self._ref_grads = None
        self.state = None
        self.records = []
        chunk = min(self.cfg["march"]["particle_chunk"], self.n)
        lanes = {"nx": self.cfg["nx"],
                 "lanes": chunk * self.cfg["n_conditions"]}
        self.shapes = {"thomas_factor": lanes, "thomas_apply": lanes}

    def warm(self):
        s = self.init(inputs.derive(self.seed, "warm"))
        self.step(s)

    def request(self, i):
        t0 = time.perf_counter()
        evals = 0.0
        if self.state is None:
            with _label("portbench.init_state"):
                self.state = self.init(inputs.derive(self.seed, "posterior",
                                                     i))
                evals += float(self.state.total_lik_evals)
        pre = self.state
        with _label("portbench.step"):
            post = self.step(pre)
            g = float(post.gamma)
        evals += float(post.total_lik_evals - pre.total_lik_evals)
        lat = time.perf_counter() - t0
        self.records.append((pre.log_lik, pre.gamma, pre.log_evidence,
                             post))
        done = g >= 1.0 or int(post.step) >= self.smc_cfg.max_steps
        self.state = None if done else post
        bad = not (g >= float(pre.gamma)
                   and bool(torch.isfinite(post.log_evidence)))
        return dict(latency=lat, posteriors=1 if g >= 1.0 else 0,
                    evals=evals, failed=1 if bad else 0)

    def free(self):
        """Frees the stepper and its graphs; a cell that checks gradients
        then reads the program's (``program_grads``) before the model
        goes."""
        del self.init, self.step
        self.state = None
        gc.collect()
        if "grad_gap_q" in self.traffic["check"]["limits"]:
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
            self.grads = self.program_grads()
        del self.model
        gc.collect()

    def program_grads(self):
        """(theta (k, d), gradient (k, d), log_lik (k,)) at a seeded
        sample of particles of a seeded sample of the window's steps.
        The step returns no gradient, so the program's own
        likelihood-and-gradient function (the one its MALA sweeps
        capture and replay) is run again on each sampled step's whole
        population: the window's batch and particle chunks. It runs
        eagerly, once the step's graphs are freed: they hold the tapes
        of the window's two chunks, and a second pair would not fit."""
        gen = inputs.rng(self.seed, "sample-grad-steps")
        chk = self.traffic["check"]
        steps = gen.choice(len(self.records),
                           min(chk["grad_steps"], len(self.records)),
                           replace=False)
        fn = program.ll_and_grad(self.model)
        th, gr, ll = [], [], []
        for s in sorted(steps):
            parts = self.records[s][3].particles
            lk, g = fn(parts)
            idx = torch.as_tensor(np.sort(gen.choice(
                self.n, chk["grad_particles"], replace=False)),
                device=parts.device)
            th.append(parts[idx])
            gr.append(g[idx])
            ll.append(lk[idx])
            del lk, g
        return torch.cat(th), torch.cat(gr), torch.cat(ll)

    def ref_ll_grad(self, theta, dtype=torch.float64, block: int = 32):
        """The reference's log-likelihood (k,) and its gradient (k, d) at
        theta, by torch.autograd through the plain march, in blocks of
        ``block`` particles so that the tape fits."""
        lls, grads = [], []
        for t in theta.split(block):
            t = t.to(self.device, dtype).detach().requires_grad_(True)
            with torch.enable_grad():
                ll = self.ref_ll(t, dtype)
                (g,) = torch.autograd.grad(
                    torch.where(torch.isfinite(ll), ll, 0.0).sum(), t)
            lls.append(ll.detach())
            grads.append(g)
        return torch.cat(lls), torch.cat(grads)

    def ref_ll(self, theta, dtype=torch.float64):
        from portbench.reference import methanation
        return methanation.log_likelihood(
            theta.to(self.device, dtype),
            torch.as_tensor(self.obs, device=self.device),
            inputs.methanation_conditions(self.cfg),
            inputs.march_settings(self.cfg))

    def sample(self):
        """(theta (k, d), stored log_lik (k,)) of a seeded sample of
        particles of a seeded sample of the window's steps."""
        gen = inputs.rng(self.seed, "sample-steps")
        chk = self.traffic["check"]
        steps = gen.choice(len(self.records),
                           min(chk["steps"], len(self.records)),
                           replace=False)
        th, ll = [], []
        for s in sorted(steps):
            post = self.records[s][3]
            idx = torch.as_tensor(np.sort(gen.choice(
                self.n, chk["particles"], replace=False)))
            th.append(post.particles[idx.to(post.particles.device)])
            ll.append(post.log_lik[idx.to(post.log_lik.device)])
        return torch.cat(th), torch.cat(ll)

    def tempering_inputs(self):
        pre_ll = torch.stack([r[0] for r in self.records])
        pre_g = torch.stack([r[1] for r in self.records])
        post = [r[3] for r in self.records]
        dlogz = torch.stack([p.log_evidence - r[2]
                             for p, r in zip(post, self.records)])
        return (pre_ll, pre_g, torch.stack([p.gamma for p in post]),
                torch.stack([p.n_gamma_reductions for p in post]),
                torch.stack([p.ess for p in post]), dlogz)

    def numbers(self, control=None):
        """With ``control`` (a dtype), the reference in that precision
        claims the log-likelihoods (and gradients) at the same particles
        and the gamma search's results from the same input
        log-likelihoods."""
        th, ll = self.sample()
        ref = self.ref_ll(th)
        temp = self.tempering_inputs()
        if control is not None:
            from portbench.reference import smc
            ll = self.ref_ll(th, control)
            g, _, ess, dz, k = smc.gamma_search(
                temp[0].to(control), temp[1].to(control), self.cfg["smc"])
            temp = (temp[0], temp[1], g, k, ess, dz)
        fb = self.cfg["failed_below"]
        out = check.lanes(ll, ref, fb)
        out.update(check.tempering(*temp, self.cfg["smc"]))
        if self.grads is not None:
            th, g, gll = self.grads
            if self._ref_grads is None:
                self._ref_grads = self.ref_ll_grad(th)
            rll, rg = self._ref_grads
            if control is not None:
                gll, g = self.ref_ll_grad(th, control)
            out.update(check.grads(g, rg, gll, rll, fb))
        return out


DRIVERS = {"full_run": FullRun, "ensemble": Ensemble, "steps": Steps}

"""Command-line interface of the PyTorch/CUDA port (port of
``smc_tpu.cli``), with the JAX command's commands, flags and defaults, and
``--device`` (default ``cuda``) on every command:

  python -m smc_tpu_torch.cli run --model mm --particles 1000
  smc-tpu-torch run --model methanation --particles 512
  smc-tpu-torch run --model banana --device-loop
  smc-tpu-torch ensemble --datasets 8 --particles 512        # hierarchical
  smc-tpu-torch sbc --replicates 64                          # calibration
  smc-tpu-torch generate-data --outdir data                  # pseudo-data
  smc-tpu-torch resume --checkpoint runs/<ts>/checkpoints/step3.smck --model mm

On a host without a card, ``--device cuda`` fails with a message and a
nonzero exit; ``--device cpu`` runs the kernels' plain PyTorch versions.

``--mesh N`` on ``run``, ``resume`` and ``ensemble`` splits the particles
over N processes, one per device, started by ``torchrun``:

  torchrun --nproc-per-node 4 -m smc_tpu_torch.cli run --mesh 4 --device cpu
  torchrun --nproc-per-node 1 -m smc_tpu_torch.cli run --mesh 1

(NCCL for CUDA, each process on ``cuda:<LOCAL_RANK>``; gloo for the CPU).
A process count other than N exits nonzero with a message. Only the first
process prints and writes.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device the run uses (cuda, cuda:1, cpu); "
                        "cpu runs the kernels' plain PyTorch versions")


def _add_common(p):
    p.add_argument("--particles", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--outdir", default="runs")
    p.add_argument("--max-steps", type=int, default=50)
    p.add_argument("--mh-steps", type=int, default=5)
    p.add_argument("--mh-steps-final", type=int, default=20)
    p.add_argument("--ess-limit", type=float, default=0.5)
    p.add_argument("--no-plots", action="store_true")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--mesh", type=int, default=0,
                   help="shard the particle axis over this many devices, "
                        "one process each, under torchrun --nproc-per-node "
                        "N (0 = single device)")
    p.add_argument("--resampling", default="residual_systematic",
                   choices=["residual_systematic", "ring", "systematic",
                            "stratified", "multinomial"],
                   help="resampling scheme; 'ring' = residual-systematic "
                        "with O(N/S)-per-device ring-exchange "
                        "redistribution on sharded runs (bitwise-identical "
                        "results)")
    p.add_argument("--mutation", default="rwm",
                   choices=["rwm", "mala", "hmc"],
                   help="mutation kernel: the reference's adaptive RW-"
                        "Metropolis, preconditioned MALA, or precondi"
                        "tioned HMC (gradient moves through autograd; not "
                        "available with the kernel likelihoods)")
    p.add_argument("--hmc-leapfrog", type=int, default=5,
                   help="leapfrog steps per HMC proposal")
    p.add_argument("--device-loop", action="store_true",
                   help="run the whole run without per-step output "
                        "(run_smc_on_device; no per-step artifacts)")
    p.add_argument("--granularity", default="step",
                   choices=["step", "sweep", "block"],
                   help="host polling granularity: 'step' polls the stop "
                        "file once a step; 'sweep' also between sweeps; "
                        "'block' additionally splits each sweep into "
                        "particles/block-particles slabs")
    p.add_argument("--block-particles", type=int, default=None,
                   help="particles per slab with --granularity block "
                        "(must divide --particles)")
    p.add_argument("--checkpoint-format", default="auto",
                   choices=["auto", "npz", "smck", "smcd"],
                   help="checkpoint container: 'auto' = native async .smck "
                        "if built else .npz; 'smcd' streams row slabs to a "
                        "memory-mapped per-field directory (O(slab) host "
                        "memory)")
    p.add_argument("--profile", default=None, metavar="LOGDIR",
                   help="write a torch.profiler trace to LOGDIR")
    p.add_argument("--max-restarts", type=int, default=0,
                   help="crash resilience: checkpoint every step to "
                        "checkpoints/latest and, on a failure, reload it "
                        "and continue; at most this many consecutive "
                        "no-progress failures are retried (0 = off)")
    p.add_argument("--stop-file", default=None, metavar="PATH",
                   help="cooperative preemption: poll PATH between device "
                        "executions and, when it appears, finalize cleanly "
                        "with the last completed step (artifacts + "
                        "checkpoint written; resume later with 'resume')")
    _add_device(p)


def _mesh(args):
    """The (N, 1) mesh of ``--mesh N`` over the processes torchrun started
    (None without ``--mesh``). Exits with a message unless exactly N
    processes are up. On CUDA each process takes ``cuda:<LOCAL_RANK>``
    (``args.device`` is rewritten)."""
    if not args.mesh:
        return None
    import os
    import torch
    import torch.distributed as dist
    from smc_tpu_torch.parallel.mesh import make_mesh
    from smc_tpu_torch.parallel.multihost import initialize_distributed
    dev = torch.device(args.device)
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
        args.device = str(dev)
    n = initialize_distributed(device=dev)
    if not dist.is_initialized() or n != args.mesh:
        raise SystemExit(
            f"--mesh {args.mesh} needs {args.mesh} processes, one per "
            f"device, and {n if dist.is_initialized() else 'no'} process "
            f"group is up: run torchrun --nproc-per-node {args.mesh} -m "
            f"smc_tpu_torch.cli ... --mesh {args.mesh}")
    return make_mesh(args.mesh, device=dev)


def _primary() -> bool:
    from smc_tpu_torch.parallel.multihost import is_primary_host
    return is_primary_host()


def _refuse_gradient(args, why: str):
    raise SystemExit(f"--mutation {args.mutation} needs a differentiable "
                     f"likelihood; {why}")


def _build_model(args):
    from smc_tpu_torch.models.michaelis_menten import (
        MichaelisMentenModel, MM_TRUE_VMAX, MM_TRUE_KM, MM_TRUE_NOISE)
    dev = args.device
    gradient = getattr(args, "mutation", "rwm") in ("mala", "hmc")
    if args.model == "mm":
        if gradient and args.mm_method.startswith("pallas"):
            _refuse_gradient(args, "use --mm-method exact/rk4/dopri5")
        m = MichaelisMentenModel.default(method=args.mm_method, device=dev)
        return m, [MM_TRUE_VMAX, MM_TRUE_KM, MM_TRUE_NOISE]
    if args.model == "methanation":
        import os
        from smc_tpu_torch.models.methanation import (MethanationModel,
                                                      KIN_TRUE, SIGMA_TRUE)
        datalist = None
        if getattr(args, "datalist", None):
            datalist = tuple(int(s) for s in args.datalist.split(","))
        kw = {"datalist": datalist, "particle_chunk": args.chunk,
              "device": dev}
        if getattr(args, "nx", None):
            kw["nx"] = args.nx
        if getattr(args, "information_csv", None):
            m = MethanationModel.from_reference_csv(args.information_csv,
                                                    **kw)
        elif getattr(args, "data_dir", None):
            m = MethanationModel.from_csv(
                os.path.join(args.data_dir, "conditions.csv"),
                os.path.join(args.data_dir, "data.csv"), **kw)
        else:
            m = MethanationModel.default(n_conditions=args.conditions, **kw)
        if getattr(args, "march", None):
            # After construction, as the reference: default()'s synthetic
            # observations come from the transient march.
            import dataclasses
            m = dataclasses.replace(m, march=args.march)
        truth = list(KIN_TRUE) + [SIGMA_TRUE]
        return m, [truth[i] for i in m.est_idx]
    if args.model == "lv":
        from smc_tpu_torch.models.generic import (LV_TRUE, LV_TRUE_NOISE,
                                                  lotka_volterra_model)
        return (lotka_volterra_model(device=dev),
                list(LV_TRUE) + [LV_TRUE_NOISE])
    if args.model in ("robertson", "robertson-dae"):
        from smc_tpu_torch.models.generic import (ROBERTSON_TRUE,
                                                  ROBERTSON_TRUE_NOISE,
                                                  robertson_model)
        form = "dae" if args.model.endswith("dae") else "ode"
        return (robertson_model(form=form, device=dev),
                list(ROBERTSON_TRUE) + [ROBERTSON_TRUE_NOISE])
    if args.model == "banana":
        from smc_tpu_torch.models.synthetic import BananaModel
        return BananaModel(device=dev), None
    if args.model == "gmm":
        from smc_tpu_torch.models.synthetic import GaussianMixtureModel
        return GaussianMixtureModel.default(device=dev), None
    raise SystemExit(f"unknown model {args.model!r}")


def _cfg(args):
    from smc_tpu_torch.config import SMCConfig
    return SMCConfig(n_particles=args.particles, max_steps=args.max_steps,
                     mh_steps=args.mh_steps,
                     mh_steps_final=args.mh_steps_final,
                     ess_limit=args.ess_limit, resampling=args.resampling,
                     mutation=args.mutation, hmc_leapfrog=args.hmc_leapfrog,
                     block_particles=args.block_particles)


def _print_run(final, rd, p, names, with_evidence: bool = True):
    line = f"gamma: {float(final.gamma)}  steps: {int(final.step)}"
    if with_evidence:
        line += f"  log evidence: {float(final.log_evidence):.4f}"
    print(line)
    if p is not None:
        for i, nm in enumerate(names or [f"p{i}" for i in range(p.shape[1])]):
            print(f"  {nm}: mean={p[:, i].mean():.6g} "
                  f"std={p[:, i].std():.4g}")
    print(f"artifacts: {rd.path}")


def cmd_run(args):
    from smc_tpu_torch.utils.metrics import profile_trace
    cfg = _cfg(args)
    mesh = _mesh(args)
    model, truth = _build_model(args)
    with profile_trace(args.profile):
        return _run_inner(args, model, truth, cfg, mesh)


def _run_inner(args, model, truth, cfg, mesh=None):
    from smc_tpu_torch.io.rundir import RunDir
    from smc_tpu_torch.runner import run_with_artifacts

    if args.device_loop or mesh is not None:
        # As the JAX command: a sharded run writes the posterior CSV only.
        from smc_tpu_torch.io.csvio import save_posterior_csv
        from smc_tpu_torch.smc.driver import (init_state, run_smc,
                                              run_smc_on_device)
        psh = None
        if mesh is not None:
            from smc_tpu_torch.parallel.mesh import particle_sharding
            psh = particle_sharding(mesh)
        state = init_state(args.seed, model, cfg, psharding=psh)
        if args.device_loop:
            final = run_smc_on_device(model, cfg, args.seed, state=state,
                                      psharding=psh)
        else:
            final = run_smc(model, cfg, args.seed, state=state,
                            verbose=not args.quiet,
                            granularity=args.granularity,
                            stop_file=args.stop_file, psharding=psh)
        if mesh is not None:
            from smc_tpu_torch.parallel.mesh import gather_state
            final = gather_state(final, mesh)
            if not _primary():
                return 0
        p = final.particles.cpu().numpy()
        rd = RunDir(root=args.outdir, tag=args.model)
        save_posterior_csv(rd.file("Posterior_Distribution.csv"), p,
                           model.param_names)
    else:
        final, rd = run_with_artifacts(
            model, cfg, args.seed,
            rundir=RunDir(root=args.outdir, tag=args.model),
            true_values=truth, plots_enabled=not args.no_plots,
            verbose=not args.quiet, granularity=args.granularity,
            checkpoint_format=args.checkpoint_format,
            max_restarts=args.max_restarts, stop_file=args.stop_file)
        p = final.particles.cpu().numpy()
    _print_run(final, rd, p, model.param_names)
    return 0


def cmd_resume(args):
    from smc_tpu_torch.io.rundir import RunDir
    from smc_tpu_torch.runner import run_with_artifacts
    cfg = _cfg(args)
    mesh = _mesh(args)
    model, truth = _build_model(args)
    # The reference's resume forwards neither --max-restarts nor
    # --stop-file (smc_tpu/cli.py:225-245); kept.
    final, rd = run_with_artifacts(
        model, cfg, args.seed,
        rundir=RunDir(root=args.outdir, tag=f"{args.model}_resume"),
        true_values=truth, resume_from=args.checkpoint,
        plots_enabled=not args.no_plots, verbose=not args.quiet,
        granularity=args.granularity,
        checkpoint_format=args.checkpoint_format, mesh=mesh)
    if rd is not None:
        _print_run(final, rd, None, None, with_evidence=False)
    return 0


def cmd_map(args):
    from smc_tpu_torch.opt import map_estimate
    model, truth = _build_model(args)
    res = map_estimate(model, args.seed, n_starts=args.starts,
                       steps=args.steps, lr=args.lr)
    th = res.theta.detach().cpu().numpy()
    names = getattr(model, "param_names", None) or [
        f"p{i}" for i in range(th.shape[0])]
    print(f"log posterior (unnormalized): {float(res.log_post):.4f}  "
          f"({args.starts} starts, {args.steps} Adam steps)")
    for i, nm in enumerate(names[:th.shape[0]]):
        line = f"  {nm}: {th[i]:.6g}"
        if truth is not None:
            line += f"   (true {truth[i]:.6g})"
        print(line)
    return 0


def cmd_ensemble(args):
    import torch
    from smc_tpu_torch.models.michaelis_menten import (generate_mm_pseudo_data,
                                                       make_mm_data_loglik)
    from smc_tpu_torch.priors import Prior
    from smc_tpu_torch.smc.ensemble import run_ensemble_on_device
    cfg = _cfg(args)
    mesh = _mesh(args)
    dev = torch.device(args.device)
    ts, obs0, s0 = generate_mm_pseudo_data()
    # D noisy copies of the pseudo-data, the noise from a CPU generator
    # seeded with seed + 1 (the JAX command draws it with jax.random, so
    # its datasets differ from these at the same seed).
    gen = torch.Generator().manual_seed(args.seed + 1)
    obs = torch.from_numpy(obs0) + 0.02 * torch.randn(
        (args.datasets,) + obs0.shape, generator=gen)
    loglik = make_mm_data_loglik(torch.from_numpy(ts).to(dev),
                                 torch.from_numpy(s0).to(dev),
                                 method=args.method)
    prior = Prior.uniform([0.0, 0.0, 0.0], [10.0, 10.0, 10.0], device=dev)
    states = run_ensemble_on_device(args.seed, prior, loglik, obs.to(dev),
                                    args.datasets, cfg, mesh=mesh)
    if mesh is not None:
        from smc_tpu_torch.parallel.mesh import gather_state
        states = gather_state(states, mesh)
        if not _primary():
            return 0
    p = states.particles.cpu().numpy()
    gamma = states.gamma.cpu().tolist()
    steps = states.step.cpu().tolist()
    log_z = states.log_evidence.cpu().tolist()
    for d in range(args.datasets):
        print(f"dataset {d}: gamma={gamma[d]:.3f} steps={steps[d]} "
              f"logZ={log_z[d]:.3f} "
              f"mean={np.round(p[d].mean(0), 4).tolist()}")
    return 0


def cmd_sbc(args):
    """Simulation-based calibration of the sampler (Talts et al. 2018):
    R replicate prior-draw -> simulate -> posterior cycles, run as one
    ensemble, then rank-uniformity statistics."""
    from smc_tpu_torch.config import SMCConfig
    from smc_tpu_torch.smc.sbc import (methanation_sbc_problem,
                                       mm_sbc_problem, rank_chi2,
                                       rank_chi2_pvalues, sbc_ranks)
    if args.model == "mm":
        prior, simulate, loglik, names = mm_sbc_problem(device=args.device)
    else:
        full = args.est == "full"
        from smc_tpu_torch.models.methanation import EST_DEFAULT
        prior, simulate, loglik, names = methanation_sbc_problem(
            n_conditions=args.conditions, nx=args.nx,
            n_steps=None if full else 6, growth=None if full else 1.6,
            particle_chunk=min(args.chunk, args.particles),
            est_idx=EST_DEFAULT if full else (0, 8),
            reference_prior=full, device=args.device)
    if args.rank_draws >= args.particles:
        raise SystemExit("--rank-draws must be < --particles")
    cfg = SMCConfig(n_particles=args.particles, mh_steps=args.mh_steps,
                    mh_steps_final=args.mh_steps_final)
    ranks, _, _ = sbc_ranks(args.seed, prior, simulate, loglik,
                            n_replicates=args.replicates, cfg=cfg,
                            n_rank_draws=args.rank_draws,
                            granularity=args.granularity,
                            verbose=not args.quiet)
    R, L = args.replicates, args.rank_draws
    stats = rank_chi2(ranks, L)
    pvals = rank_chi2_pvalues(ranks, L)
    # mean normalized rank: calibrated -> 0.5 +/- 1/sqrt(12 R); readable
    # even at replicate counts too small for the chi-square bins.
    mean_norm = ranks.mean(0) / L
    z = (mean_norm - 0.5) * np.sqrt(12.0 * R)
    print(f"SBC: {R} replicates x {args.particles} particles, "
          f"{L} rank draws ({args.model})")
    for j, nm in enumerate(names):
        print(f"  {nm}: mean rank {mean_norm[j]:.3f} (z={z[j]:+.2f})  "
              f"chi2(df7)={stats[j]:.2f}  p={pvals[j]:.3g}")
    calibrated = bool((pvals > args.alpha).all())
    if R < 40:
        print(f"  (chi-square is underpowered below ~40 replicates; "
              f"exit code uses the mean-rank |z| < {args.z_max} rule — "
              f"see --z-max; --alpha has no effect here)")
        calibrated = bool((np.abs(z) < args.z_max).all())
    print(f"calibrated: {calibrated}")
    if args.ranks_csv:
        with open(args.ranks_csv, "w") as f:
            f.write(",".join(names) + "\n")
            for row in ranks:
                f.write(",".join(str(int(v)) for v in row) + "\n")
        print(f"wrote {args.ranks_csv}")
    return 0 if calibrated else 1


def cmd_generate_data(args):
    """MM pseudo-data CSVs (Micmen_generate_data.py:31-66) or methanation
    data.csv/data_mol.csv/conditions.csv (SMC_methanation_main.py:86-107).
    The noise comes from a CPU torch.Generator, not the JAX command's
    jax.random stream: the noise-free columns agree, the noise does not."""
    import os
    from smc_tpu_torch.models.michaelis_menten import (generate_mm_pseudo_data,
                                                       MM_S0_LIST)
    os.makedirs(args.outdir, exist_ok=True)
    if args.model == "methanation":
        import torch
        from smc_tpu_torch.models.methanation import MethanationModel, KIN_TRUE
        m = MethanationModel.default(n_conditions=args.conditions,
                                     seed=args.seed, device=args.device)
        np.savetxt(os.path.join(args.outdir, "data.csv"),
                   m.obs.cpu().numpy(), delimiter=",")
        frac = m.simulate_molfractions(torch.tensor(
            KIN_TRUE, dtype=torch.float32, device=m.device))
        np.savetxt(os.path.join(args.outdir, "data_mol.csv"),
                   frac.cpu().numpy(), delimiter=",")
        m.cond.to_csv(os.path.join(args.outdir, "conditions.csv"), nx=m.nx)
        print(f"wrote data.csv, data_mol.csv, conditions.csv to {args.outdir}")
        return 0
    ts, obs, s0, S_true = generate_mm_pseudo_data(
        **({"seed": args.seed} if args.seed else {}), return_truth=True)
    for i in range(len(MM_S0_LIST)):
        P_true = s0[i] - S_true[i]
        path = os.path.join(args.outdir, f"mm_pseudo_data_{i}.csv")
        with open(path, "w") as f:
            f.write("t,S_true,P_true,P_obs\n")
            for row in zip(ts, S_true[i], P_true, obs[i]):
                f.write(",".join(repr(float(v)) for v in row) + "\n")
        print(f"wrote {path}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="smc-tpu-torch",
                                 description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="run tempered-SMC inference")
    pr.add_argument("--model", default="mm",
                    choices=["mm", "methanation", "banana", "gmm", "lv",
                             "robertson", "robertson-dae"])
    pr.add_argument("--mm-method", default="rk4",
                    choices=["rk4", "dopri5", "exact", "pallas",
                             "pallas_exact"])
    pr.add_argument("--conditions", type=int, default=30)
    pr.add_argument("--chunk", type=int, default=512)
    pr.add_argument("--data-dir", default=None,
                    help="methanation real-data mode: directory holding "
                         "conditions.csv + data.csv")
    pr.add_argument("--information-csv", default=None,
                    help="methanation: load a reference-layout "
                         "information.csv (conditions + observed flows)")
    pr.add_argument("--datalist", default=None,
                    help="methanation: comma-separated experiment indices "
                         "to subset, e.g. 0,2 (the reference's datalist)")
    pr.add_argument("--nx", type=int, default=None,
                    help="methanation: reactor grid points (default 51, "
                         "the reference's NX)")
    _add_common(pr)
    pr.set_defaults(fn=cmd_run)

    ps = sub.add_parser("resume", help="resume from a checkpoint")
    ps.add_argument("--checkpoint", required=True)
    ps.add_argument("--model", default="mm",
                    choices=["mm", "methanation", "banana", "gmm"])
    ps.add_argument("--mm-method", default="rk4", choices=["rk4", "exact"])
    ps.add_argument("--conditions", type=int, default=30)
    ps.add_argument("--chunk", type=int, default=512)
    ps.add_argument("--datalist", default=None)
    ps.add_argument("--nx", type=int, default=None)
    _add_common(ps)
    ps.set_defaults(fn=cmd_resume)

    pm = sub.add_parser("map", help="gradient MAP point estimate "
                                    "(multi-start Adam; differentiable "
                                    "models only)")
    pm.add_argument("--model", default="mm",
                    choices=["mm", "methanation", "banana", "gmm", "lv",
                             "robertson", "robertson-dae"])
    pm.add_argument("--mm-method", default="exact",
                    choices=["rk4", "dopri5", "exact"])
    pm.add_argument("--conditions", type=int, default=30)
    pm.add_argument("--chunk", type=int, default=512)
    pm.add_argument("--datalist", default=None)
    pm.add_argument("--data-dir", default=None)
    pm.add_argument("--information-csv", default=None)
    pm.add_argument("--nx", type=int, default=None)
    pm.add_argument("--march", default="steady",
                    help="methanation march (MAP needs the differentiable "
                         "'steady' path)")
    pm.add_argument("--starts", type=int, default=8)
    pm.add_argument("--steps", type=int, default=800)
    pm.add_argument("--lr", type=float, default=0.1)
    pm.add_argument("--seed", type=int, default=0)
    _add_device(pm)
    pm.set_defaults(fn=cmd_map)

    pe = sub.add_parser("ensemble",
                        help="hierarchical multi-dataset MM ensemble")
    pe.add_argument("--datasets", type=int, default=4)
    pe.add_argument("--method", default="exact",
                    help="per-population MM likelihood (exact, rk4, "
                         "pallas_exact, pallas — the last two run all "
                         "populations in one kernel launch)")
    _add_common(pe)
    pe.set_defaults(fn=cmd_ensemble)

    pb = sub.add_parser("sbc",
                        help="simulation-based calibration check of the "
                             "sampler (rank-uniformity over replicate "
                             "posteriors; exit 0 iff calibrated)")
    pb.add_argument("--model", default="mm", choices=["mm", "methanation"])
    pb.add_argument("--replicates", type=int, default=64,
                    help="SBC replicates R; below 40 the chi-square test "
                         "is underpowered and the exit code falls back to "
                         "the mean-rank |z| < --z-max rule (--alpha is "
                         "then not used)")
    pb.add_argument("--particles", type=int, default=512)
    pb.add_argument("--rank-draws", type=int, default=63,
                    help="posterior draws ranked per replicate (L); any "
                         "value works — bins with unequal integer "
                         "coverage get per-bin expected counts")
    pb.add_argument("--mh-steps", type=int, default=5)
    pb.add_argument("--mh-steps-final", type=int, default=20)
    pb.add_argument("--alpha", type=float, default=1e-3,
                    help="chi-square rejection level per dimension "
                         "(ignored when --replicates < 40; see "
                         "--replicates)")
    pb.add_argument("--z-max", type=float, default=4.0,
                    help="mean-rank |z| threshold used instead of the "
                         "chi-square when --replicates < 40")
    pb.add_argument("--seed", type=int, default=0)
    pb.add_argument("--ranks-csv", default=None,
                    help="also write the (R, d) rank table to this CSV")
    pb.add_argument("--conditions", type=int, default=2,
                    help="methanation: experimental conditions")
    pb.add_argument("--nx", type=int, default=11,
                    help="methanation: reactor grid points (51 = the "
                         "reference's full grid)")
    pb.add_argument("--est", default="af-sigma",
                    choices=["af-sigma", "full"],
                    help="methanation estimated subset: 'af-sigma' = the "
                         "cheap 2-parameter suite config; 'full' = the "
                         "default 5-parameter set (Af, Eaf, Ar, Ear, "
                         "sigma) under the reference's prior bounds")
    pb.add_argument("--chunk", type=int, default=64,
                    help="methanation: particle dispatch width")
    pb.add_argument("--granularity", default="fused",
                    choices=["fused", "sweep"],
                    help="'fused' = the whole ensemble run in one call; "
                         "'sweep' = one host-visible ensemble step at a "
                         "time (with a line per step unless --quiet)")
    pb.add_argument("--quiet", action="store_true")
    _add_device(pb)
    pb.set_defaults(fn=cmd_sbc)

    pg = sub.add_parser("generate-data",
                        help="write pseudo-data CSVs (mm or methanation)")
    pg.add_argument("--model", default="mm", choices=["mm", "methanation"])
    pg.add_argument("--conditions", type=int, default=30)
    pg.add_argument("--outdir", default="data")
    pg.add_argument("--seed", type=int, default=0)
    _add_device(pg)
    pg.set_defaults(fn=cmd_generate_data)

    args = ap.parse_args(argv)
    # The port's counterpart of JAX_PLATFORMS: a card asked for and absent
    # is an error, never a quiet run on the CPU.
    from smc_tpu_torch.config import resolve_device
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"{ap.prog}: {e}") from None
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

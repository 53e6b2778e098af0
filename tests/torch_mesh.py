"""Gloo worlds for the port's sharded tests, on the CPU.

:func:`run_world` starts ``n`` processes (the ``spawn`` start method), each
with one PyTorch thread and a gloo process group over a ``file://`` store
in the test's temporary directory (no TCP port, so parallel test workers
cannot collide), and runs ``target(rank, n, out_dir, *args)`` in each. The
world has a time limit: past it every rank is killed and the test fails,
so a collective that hangs fails one test instead of the suite. A rank
that raises writes its traceback, which the failure shows.

This module imports neither JAX nor the JAX package: spawned ranks import
it, and the JAX side of each comparison runs in the test process.
"""
from __future__ import annotations

import os
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

WORLD_TIMEOUT_S = 150.0


def _rank_main(rank, n, store, out_dir, target, args):
    torch.set_num_threads(1)
    try:
        torch.set_num_interop_threads(1)
    except RuntimeError:
        pass
    import torch.distributed as dist
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=n, rank=rank)
        target(rank, n, out_dir, *args)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"error_rank{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def run_world(tmp_dir, n: int, target, *args,
              timeout_s: float = WORLD_TIMEOUT_S) -> str:
    """Run ``target`` on ``n`` gloo ranks; returns ``tmp_dir`` (where the
    ranks write their outputs). Raises if a rank fails or the world
    outlives ``timeout_s``."""
    tmp_dir = str(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)
    store = os.path.join(tmp_dir, "gloo_store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, store, tmp_dir, target, args))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = []
    for r in range(n):
        path = os.path.join(tmp_dir, f"error_rank{r}.txt")
        if os.path.exists(path):
            errors.append(f"rank {r}:\n" + open(path).read())
    if hung:
        raise TimeoutError(f"ranks {hung} still running after {timeout_s} s "
                           f"(killed)\n" + "\n".join(errors))
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if bad or errors:
        raise RuntimeError(f"ranks failed {bad}\n" + "\n".join(errors))
    return tmp_dir


def save(out_dir, name: str, **arrays) -> None:
    """Write one case's outputs (rank 0's call is the one kept)."""
    np.savez(os.path.join(out_dir, name + ".npz"),
             **{k: np.asarray(v) for k, v in arrays.items()})


def load(out_dir, name: str) -> dict:
    with np.load(os.path.join(str(out_dir), name + ".npz")) as z:
        return {k: z[k] for k in z.files}


def state_arrays(state) -> dict:
    """An SMCState's tensor fields as NumPy arrays."""
    import dataclasses
    return {f.name: getattr(state, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(state) if f.name != "key"}


class ReplayDraws:
    """The port's ``Draws`` interface served from a fixed list of
    ("uniform" | "normal", array) entries, in order; the kind and shape of
    every request must match the next entry. (Here, not in
    tests/torch_parity.py, which imports JAX: spawned ranks use it.)"""

    def __init__(self, entries):
        self.entries = list(entries)
        self.used = 0

    def _next(self, kind, shape):
        if self.used >= len(self.entries):
            raise AssertionError(f"replay exhausted at a {kind} draw")
        k, arr = self.entries[self.used]
        self.used += 1
        if k != kind or tuple(arr.shape) != tuple(shape):
            raise AssertionError(f"replay expected {k}{arr.shape}, got "
                                 f"{kind}{tuple(shape)}")
        return torch.from_numpy(np.asarray(arr).astype(np.float32))

    def uniform(self, shape, dtype=torch.float32):
        return self._next("uniform", shape)

    def normal(self, shape, dtype=torch.float32):
        return self._next("normal", shape)


def mm_model(mm: dict, method: str = "exact"):
    """The port's MM model on the CPU from the data arrays ``mm`` (obs,
    s0, ts) under the uniform [0, 10]^3 prior."""
    from smc_tpu_torch import convert
    prior = dict(kind=[0, 0, 0], low=[0.0] * 3, high=[10.0] * 3,
                 loc=[5.0] * 3, scale=[10.0] * 3)
    return convert.mm_model_from_numpy(mm["obs"], mm["s0"], mm["ts"], prior,
                                       method=method, device="cpu")


# --------------------------------------------------------------------------
# tests/test_torch_sharding.py: every case of the file in one 4-rank world
# --------------------------------------------------------------------------
def sharding_cases(rank, n, out, mm, step_in, res_in):
    from smc_tpu_torch import SMCConfig, convert
    from smc_tpu_torch.ops import _build
    from smc_tpu_torch.parallel.mesh import (
        DATA_AXIS, PARTICLE_AXIS, gather_state, make_mesh,
        particle_sharding, run_smc_sharded, shard_state)
    from smc_tpu_torch.parallel.resample_shmap import (
        resample_sharded, resample_sharded_ring)
    from smc_tpu_torch.smc.driver import make_full_run_on_device, \
        make_smc_step

    keep = rank == 0

    def put(name, **arrays):
        if keep:
            save(out, name, **arrays)

    def whole(s):
        return state_arrays(gather_state(s, mesh))

    errors = {}
    for label, args in (("world", (n + 1,)), ("data", (n, 3))):
        try:
            make_mesh(*args)
        except ValueError as e:
            errors[label] = str(e)
    mesh = make_mesh()
    psh = particle_sharding(mesh)
    put("mesh", shape=np.array([mesh.size(0), mesh.size(1)]),
        names=np.array(mesh.mesh_dim_names),
        sizes=np.array([psh.particles.size, psh.data.size, psh.world.size]),
        axes=np.array([PARTICLE_AXIS, DATA_AXIS]),
        world_error=errors.get("world", ""), data_error=errors.get("data", ""))

    model = mm_model(mm)
    cfg = SMCConfig(n_particles=512)
    state0 = convert.state_from_numpy(step_in["arrays"], device="cpu",
                                      draws=ReplayDraws(step_in["entries"]))
    _build.reset_launch_counts()
    s1 = make_smc_step(model, cfg, psharding=psh)(shard_state(state0, mesh))
    coll = dict(_build.collective_counts)
    put("step", kinds=np.array(sorted(coll)),
        counts=np.array([coll[k] for k in sorted(coll)]), **whole(s1))

    put("run", **whole(run_smc_sharded(model, cfg, 0, mesh, on_device=True)))
    for res in ("residual_systematic", "ring"):
        s = run_smc_sharded(model, SMCConfig(n_particles=512, resampling=res),
                            9, mesh, on_device=True, verbose=False)
        put("run9_" + res, **whole(s))
    try:
        run_smc_sharded(model, SMCConfig(n_particles=510), 0, mesh)
        put("indivisible", error="")
    except ValueError as e:
        put("indivisible", error=str(e))
    put("large", **whole(run_smc_sharded(
        model, SMCConfig(n_particles=32768), 5, mesh, on_device=True)))
    full = make_full_run_on_device(model, cfg, psharding=psh)(3)
    put("full", local_rows=np.array(full.particles.shape[0]), **whole(full))

    rows = psh.rows(res_in["parts"].shape[0])
    parts = torch.from_numpy(res_in["parts"])
    lk = torch.from_numpy(res_in["lk"])
    for name, fn, w, v0 in (
            ("resample_sharded", resample_sharded, res_in["w_plain"],
             res_in["v0_plain"]),
            ("ring_2", resample_sharded_ring, res_in["w_2"],
             res_in["v0_ring"]),
            ("ring_12", resample_sharded_ring, res_in["w_12"],
             res_in["v0_ring"])):
        w = torch.from_numpy(w)
        p, l = fn(torch.tensor(float(v0)), w[rows], parts[rows], lk[rows],
                  mesh)
        put(name, local_rows=np.array(p.shape[0]),
            particles=torch.cat(list(psh.particles.gather(p).unbind(0))),
            log_lik=torch.cat(list(psh.particles.gather(l).unbind(0))))


# --------------------------------------------------------------------------
# tests/test_torch_sharding_large.py: inputs and outputs go through .npy
# files (each rank maps its rows), not through the spawn arguments
# --------------------------------------------------------------------------
def large_cases(rank, n, out, cases):
    """``cases``: (name, kind) with kind "counts", "counts_fn" (the same
    through ``resample_counts_sharded_fn``'s per-rank body) or "ring";
    the inputs are ``<name>_w.npy`` (and ``<name>_parts.npy``) plus
    ``<name>_v0`` in ``out``; each rank writes its rows to
    ``<name>_r<rank>.npy``."""
    from smc_tpu_torch.parallel.mesh import make_mesh, particle_sharding
    from smc_tpu_torch.parallel.resample_shmap import (
        resample_counts_sharded, resample_counts_sharded_fn,
        resample_sharded_ring)
    mesh = make_mesh()
    psh = particle_sharding(mesh)
    for name, kind in cases:
        w = np.load(os.path.join(out, name + "_w.npy"), mmap_mode="r")
        rows = psh.rows(w.shape[0])
        v0 = torch.tensor(float(np.load(os.path.join(out, name + "_v0.npy"))))
        w_l = torch.from_numpy(np.array(w[rows]))
        if kind == "counts":
            got = resample_counts_sharded(v0, w_l, mesh)
        elif kind == "counts_fn":
            got = resample_counts_sharded_fn(w.shape[0], mesh)(v0, w_l)
        else:
            parts = np.load(os.path.join(out, name + "_parts.npy"),
                            mmap_mode="r")
            p_l = torch.from_numpy(np.array(parts[rows]))
            got, lk = resample_sharded_ring(v0, w_l, p_l, p_l[:, 0], mesh)
            if not torch.equal(lk, got[:, 0]):
                raise AssertionError("ring log_lik is not its particle's")
        np.save(os.path.join(out, f"{name}_r{rank}.npy"), got.numpy())


# --------------------------------------------------------------------------
# tests/test_torch_sharding_methanation.py: every case in one 4-rank world
# --------------------------------------------------------------------------
METH_KW = dict(nx=11, n_steps=10, growth=1.6, particle_chunk=16)
# The steady march whose gradient is finite on the default table at nx = 11
# (tests/test_torch_methanation_grad.py's settings).
STEADY_KW = dict(nx=11, n_steps=40, growth=1.3, particle_chunk=4,
                 newton_iters=3, march="steady")
ENSEMBLE_CFG = dict(n_particles=128)


def methanation_theta() -> np.ndarray:
    """The 16 particles of tests/test_sharding_methanation.py's first case."""
    t = np.tile(np.asarray([[13.04, 52.2e3, 1.147e5, 96.7e3, 5.0]],
                           np.float32), (16, 1))
    return (t + np.linspace(0, 1, 16, dtype=np.float32)[:, None]
            * np.asarray([1.0, 100.0, 1e4, 100.0, 0.1], np.float32)
            ).astype(np.float32)


def methanation_from_arrays(meth: dict, **kw):
    """The port's methanation model on the CPU over the condition table
    and observations ``meth`` (arrays shared with the JAX model)."""
    from smc_tpu_torch.convert import methanation_model_from_numpy
    from smc_tpu_torch.models.methanation import methanation_prior
    return methanation_model_from_numpy(
        meth["cond"], meth["obs"], methanation_prior(device="cpu"),
        device="cpu", **{**METH_KW, **kw})


def ensemble_problem():
    """The MM ensemble of tests/test_sharding_methanation.py on the CPU:
    four noisy copies of the pseudo-data (NumPy noise)."""
    from smc_tpu_torch.models.michaelis_menten import (
        generate_mm_pseudo_data, make_mm_data_loglik)
    from smc_tpu_torch.priors import Prior
    ts, obs0, s0 = generate_mm_pseudo_data()
    rng = np.random.default_rng(1)
    obs = (obs0[None] + 0.02 * rng.normal(size=(4,) + obs0.shape)).astype(
        np.float32)
    loglik = make_mm_data_loglik(torch.from_numpy(ts), torch.from_numpy(s0))
    prior = Prior.uniform([0.0] * 3, [10.0] * 3, device="cpu")
    return prior, loglik, torch.from_numpy(obs)


def methanation_cases(rank, n, out, meth):
    """``meth``: the shared condition table and observations, and the
    thetas of the likelihood cases (``lik``, ``lane``)."""
    import dataclasses
    from smc_tpu_torch import SMCConfig
    from smc_tpu_torch.models.methanation import MethanationModel
    from smc_tpu_torch.parallel.mesh import (gather_state, make_mesh,
                                             particle_sharding)
    from smc_tpu_torch.smc.driver import init_state, make_smc_step
    from smc_tpu_torch.smc.ensemble import run_ensemble_on_device
    from smc_tpu_torch.smc.sbc import mm_sbc_problem, sbc_ranks

    keep = rank == 0
    mesh1 = make_mesh()
    mesh2 = make_mesh(n, n_data=2)
    psh1, psh2 = particle_sharding(mesh1), particle_sharding(mesh2)

    def rows_of(psh, t):
        return torch.cat(list(psh.particles.gather(t).unbind(0)))

    base = methanation_from_arrays(meth)
    theta = torch.from_numpy(meth["theta_lik"])
    ll, fl = base.log_likelihood(theta[psh1.rows(16)])
    ll, fl = rows_of(psh1, ll), rows_of(psh1, fl)
    if keep:
        save(out, "lik", ll=ll, flows=fl)

    lane = dataclasses.replace(base, lane_mesh=mesh2)
    for name in ("theta_lane", "theta_lik"):
        theta = torch.from_numpy(meth[name])
        ll, fl = lane.log_likelihood(theta[psh2.rows(16)])
        ll, fl = rows_of(psh2, ll), rows_of(psh2, fl)
        if keep:
            save(out, "lane_" + name, ll=ll, flows=fl,
                 local_conditions=np.array(lane._lane_share[0].cond.n_data))

    # The steady march's gradient through the lane mesh: each rank's rows,
    # from its data group's two halves of the conditions.
    steady = dataclasses.replace(
        MethanationModel.default(n_conditions=4, seed=0, device="cpu",
                                 **STEADY_KW), lane_mesh=mesh2)
    th = torch.from_numpy(methanation_theta()[psh2.rows(16)])
    th.requires_grad_(True)
    ll = steady.log_likelihood(th)[0]
    (g,) = torch.autograd.grad(ll.sum(), th)
    save(out, f"grad_r{rank}", ll=ll.detach(), grad=g,
         rows=np.array([psh2.rows(16).start, psh2.rows(16).stop]))

    prior, loglik, obs = ensemble_problem()
    states = run_ensemble_on_device(0, prior, loglik, obs, 4,
                                    SMCConfig(**ENSEMBLE_CFG), mesh=mesh2)
    local = tuple(states.particles.shape)
    whole = gather_state(states, mesh2)
    one = gather_state(run_ensemble_on_device(
        0, prior, loglik, obs, 4, SMCConfig(**ENSEMBLE_CFG, max_steps=1),
        mesh=mesh2), mesh2)
    if keep:
        save(out, "ensemble", local=np.array(local), **state_arrays(whole))
        save(out, "ensemble_step", **state_arrays(one))

    prior, simulate, loglik = mm_sbc_problem(n_datasets=3, device="cpu")[:3]
    ranks, truths, _ = sbc_ranks(0, prior, simulate, loglik, 4,
                                 SMCConfig(n_particles=64), 31, mesh=mesh2)
    if keep:
        save(out, "sbc", ranks=ranks, truths=truths)

    m = MethanationModel.default(n_conditions=2, seed=0, device="cpu",
                                 **{**METH_KW, "particle_chunk": 32})
    cfg = SMCConfig(n_particles=32, mh_steps=1, mh_steps_final=1)
    s = make_smc_step(m, cfg, psharding=psh1)(init_state(0, m, cfg,
                                                         psharding=psh1))
    whole = gather_state(s, mesh1)
    if keep:
        save(out, "step", local_rows=np.array(s.particles.shape[0]),
             **state_arrays(whole))


# --------------------------------------------------------------------------
# tests/test_torch_mesh_ops.py: checkpoints, the runner and the CLI on a
# 2-rank world
# --------------------------------------------------------------------------
def _save_format(fmt, path, state):
    from smc_tpu_torch.io import checkpoint as ck
    from smc_tpu_torch.runtime import AsyncCheckpointer
    if fmt == "npz":
        ck.save_state(path + ".npz", state)
        return path + ".npz"
    if fmt == "smck":
        with AsyncCheckpointer() as w:
            ck.save_state_async(w, path + ".smck", state)
            w.flush()
        return path + ".smck"
    return ck.save_state_chunked(path, state, max_bytes=512)


def ops_cases(rank, n, out, mm):
    import contextlib
    import io
    import torch.distributed as dist
    from smc_tpu_torch import SMCConfig, cli
    from smc_tpu_torch.io.checkpoint import load_state
    from smc_tpu_torch.io.rundir import RunDir
    from smc_tpu_torch.parallel.mesh import (gather_state, make_mesh,
                                             particle_sharding, shard_state)
    from smc_tpu_torch.runner import run_with_artifacts
    from smc_tpu_torch.smc.driver import run_smc
    from smc_tpu_torch.utils.resilient import run_resilient

    mesh = make_mesh()
    psh = particle_sharding(mesh)
    model = mm_model(mm)
    cfg = SMCConfig(n_particles=256, max_steps=3)
    state = run_smc(model, cfg, 4, verbose=False)       # the same everywhere
    mine = shard_state(state, mesh)
    same = {}
    for fmt in ("npz", "smck", "smcd"):
        path = os.path.join(out, "ck_" + fmt)
        if rank == 0:
            path = _save_format(fmt, path, state)
        paths = [path]
        dist.broadcast_object_list(paths, src=0)
        got = load_state(paths[0], sharding=mesh, device="cpu")
        same[fmt] = all(torch.equal(getattr(got, f), getattr(mine, f))
                        for f in ("particles", "log_lik", "gamma", "step",
                                  "log_evidence", "ess", "n_mh"))
        same[fmt] &= torch.equal(got.key.generator.get_state(),
                                 state.key.generator.get_state())
    save(out, f"load_r{rank}", **{k: np.array(v) for k, v in same.items()})

    cfg = SMCConfig(n_particles=256)
    final, rd = run_with_artifacts(
        model, cfg, 0, rundir=RunDir(root=os.path.join(out, "rwa"),
                                     tag="mm") if rank == 0 else None,
        plots_enabled=False, verbose=False, mesh=mesh,
        checkpoint_format="npz")
    paths = [None if rd is None else rd.file("checkpoints", "step3.npz")]
    dist.broadcast_object_list(paths, src=0)
    resumed, rd2 = run_with_artifacts(
        model, cfg, None, rundir=RunDir(root=os.path.join(out, "rwa2"),
                                        tag="mm") if rank == 0 else None,
        resume_from=paths[0], plots_enabled=False, verbose=False,
        mesh=mesh, checkpoint_format="npz")
    save(out, f"rwa_r{rank}", rundir=str(rd is not None),
         **{"final_" + k: v for k, v in state_arrays(final).items()},
         **{"resumed_" + k: v for k, v in state_arrays(resumed).items()})

    # run_resilient on the mesh, as run_with_artifacts(max_restarts=) calls
    # it: the primary names the checkpoint; a failure every rank sees at
    # step 2 reloads it on every rank.
    seen = []

    def fail_once_at_2(st):
        seen.append(int(st.step))
        if seen.count(2) == 1 and int(st.step) == 2:
            raise RuntimeError("injected failure on every rank")
    recovered = run_resilient(
        model, cfg, 0, psharding=psh, callback=fail_once_at_2,
        checkpoint=os.path.join(out, "resilient.npz") if rank == 0 else None,
        retry_delay_s=0.0, verbose=False)
    save(out, f"resilient_r{rank}", seen=np.array(seen),
         **state_arrays(gather_state(recovered, mesh)))

    for tag, extra in (("cli_default", []),
                       ("cli_ring", ["--resampling", "ring"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["run", "--model", "mm", "--mm-method", "exact",
                           "--particles", "256", "--mesh", str(n),
                           "--device", "cpu", "--quiet", "--no-plots",
                           "--outdir", os.path.join(out, tag)] + extra)
        save(out, f"{tag}_r{rank}", rc=np.array(rc), stdout=buf.getvalue())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["resume", "--checkpoint", paths[0], "--model", "mm",
                       "--mm-method", "exact", "--particles", "256",
                       "--mesh", str(n), "--device", "cpu", "--quiet",
                       "--no-plots", "--outdir",
                       os.path.join(out, "cli_resume")])
    save(out, f"cli_resume_r{rank}", rc=np.array(rc), stdout=buf.getvalue())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["ensemble", "--datasets", "2", "--particles", "128",
                       "--mesh", str(n), "--device", "cpu"])
    save(out, f"cli_ensemble_r{rank}", rc=np.array(rc),
         stdout=buf.getvalue())

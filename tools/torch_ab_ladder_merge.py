#!/usr/bin/env python3
"""A/B of the port's gamma-ladder and ancestor-merge kernels against an
earlier version of them, on one NVIDIA GPU, in turns.

    mkdir -p _probe/parent
    git show <commit>:smc_tpu_torch/csrc/ladder.cu > _probe/parent/ladder.cu
    git show <commit>:smc_tpu_torch/csrc/merge.cu > _probe/parent/merge.cu
    python3 tools/torch_ab_ladder_merge.py --parent _probe/parent

The earlier sources are built into a library of their own beside
``smc_tpu_torch/_build``; the earlier ladder is the two-kernel one
(``ladder_launch(d, dg, partial, s1, s2, b, n, k, stream)`` with
``ladder_blocks(n)``), the earlier merge has this tree's signature. Prints,
each line with the card's name and power limit:

- per shape (N = 1e5, 64 x 2048, N = 1e6, SBC's 256 x 2048; K = 81): the
  device ms of each version's kernels from torch.profiler (median of three
  turns, earlier / this tree alternating, 30 calls a turn), kernel by
  kernel (the earlier ladder's two kernels apart); ``torch.searchsorted``'s
  device ms beside the merge; the device ms of an empty kernel with each
  version's grid (the floor a one-wave launch puts under a kernel) and of
  a one-element ``add_``; whether the two versions give the same bits;
- the Michaelis-Menten path at N = 1e5 from seed 1 (``run_smc``, graphed
  pieces) once with each ladder: the gamma sequence, steps, log-evidence
  and final particles, compared bit for bit;
- the opcode counts of this tree's ``ladder_kernel`` and ``merge_kernel``
  from ``cuobjdump -sass`` of the built library, and the ladder's
  instructions per term by pipe (per MUFU.EX2, which is one per term).
"""
import argparse
import collections
import ctypes
import math
import os
import re
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from smc_tpu_torch.ops import _build  # noqa: E402
from smc_tpu_torch.ops import ladder_cuda as ld  # noqa: E402
from smc_tpu_torch.ops import resample_cuda as rs  # noqa: E402

SHAPES = ((1, 100_000), (64, 2048), (1, 1_000_000), (256, 2048))
K = 81
REPS = 30
EMPTY_CU = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(int gx, int gy, int gz, int threads, void* s) {
  empty_kernel<<<dim3(gx, gy, gz), threads, 0,
                 static_cast<cudaStream_t>(s)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""
P, I = ctypes.c_void_p, ctypes.c_int


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def nvcc_library(out_dir, name, sources):
    """Compile ``sources`` (paths) with the port's flags into
    ``lib<name>.so``; returns the loaded library."""
    so = os.path.join(out_dir, f"lib{name}.so")
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                        so, *sources], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {sources}:\n{r.stderr}")
    return ctypes.CDLL(so)


def device_rows(fn, reps=REPS):
    """{kernel name: device ms per call} of ``fn`` under torch.profiler,
    after a lead-in of spin kernels (a trace may lose its first events)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(64):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / reps
            for e in prof.key_averages()
            if e.self_device_time_total > 0 and "spin_kernel" not in e.key}


def in_turns(fns, turns=3):
    """Median device ms per name and the last turn's kernel rows; the order
    alternates from turn to turn. A turn whose trace lost its events (no
    device time) is left out of the median."""
    times = {k: [] for k in fns}
    rows = {}
    for turn in range(turns):
        for name in (list(fns) if turn % 2 == 0 else list(fns)[::-1]):
            r = device_rows(fns[name])
            if r:
                rows[name] = r
                times[name].append(sum(r.values()))
    return {k: statistics.median(v) for k, v in times.items()}, rows


def short(rows):
    return "; ".join(f"{re.sub(r'[(<].*', '', k.split('::')[-1])} "
                     f"{v:.4f}" for k, v in rows.items())


class ParentLadder:
    def __init__(self, lib):
        lib.ladder_launch.argtypes = (P, P, P, P, P, I, I, I, P)
        lib.ladder_launch.restype = I
        lib.ladder_blocks.argtypes = (I,)
        lib.ladder_blocks.restype = I
        self.lib = lib

    def __call__(self, d_ll, dg):
        b = d_ll.shape[0] if d_ll.dim() == 2 else 1
        n, k = d_ll.shape[-1], dg.shape[-1]
        partial = torch.empty((b, self.lib.ladder_blocks(n), 2, k),
                              dtype=torch.float32, device=d_ll.device)
        s1, s2 = torch.empty_like(dg), torch.empty_like(dg)
        err = self.lib.ladder_launch(
            d_ll.data_ptr(), dg.data_ptr(), partial.data_ptr(),
            s1.data_ptr(), s2.data_ptr(), b, n, k, _build.stream_ptr(d_ll))
        _build.check(err, "parent ladder")
        _build.launch_counts["ladder"] += 1
        return s1, s2


class ParentMerge:
    def __init__(self, lib):
        lib.merge_launch.argtypes = (P, P, I, I, P)
        lib.merge_launch.restype = I
        self.lib = lib

    def __call__(self, offsets):
        b = offsets.shape[0] if offsets.dim() == 2 else 1
        anc = torch.empty_like(offsets)
        err = self.lib.merge_launch(offsets.data_ptr(), anc.data_ptr(), b,
                                    offsets.shape[-1],
                                    _build.stream_ptr(offsets))
        _build.check(err, "parent merge")
        return anc


def resampler_offsets(b, n, gen):
    """Residual-systematic offsets (b, n) on gamma(1) weights."""
    from smc_tpu_torch.smc.kernels import _rs_counts_offsets
    w = -torch.log(torch.rand((b, n), generator=gen, device="cuda"))
    w = w / w.sum(1, keepdim=True)
    v0 = torch.rand((b,), generator=gen, device="cuda")
    return _rs_counts_offsets(v0, w)[1].contiguous()


def kernels_ab(parent_ladder, parent_merge, empty, smi):
    lib = _build.load()
    gen = torch.Generator(device="cuda").manual_seed(7)
    stream = torch.cuda.current_stream().cuda_stream
    one = torch.zeros(1, device="cuda")
    floor_add = sum(device_rows(lambda: one.add_(1.0)).values())
    print(f"floor: one-element add_ {floor_add:.4f} device ms | {smi}",
          flush=True)
    for b, n in SHAPES:
        o = resampler_offsets(b, n, gen)
        row = o if b > 1 else o[0]
        slots = torch.arange(n, device="cuda", dtype=torch.int32)
        if b > 1:
            slots = slots.expand(b, n).contiguous()
        same = torch.equal(rs.sorted_offsets_to_ancestors(row),
                           parent_merge(row))
        med, rows = in_turns({
            "parent": lambda: parent_merge(row),
            "this": lambda: rs.sorted_offsets_to_ancestors(row),
            "searchsorted": lambda: torch.searchsorted(
                row, slots, right=True) - 1})
        e_new = sum(device_rows(lambda: empty.empty_launch(
            lib.merge_blocks(n), b, 1, 256, stream)).values())
        e_old = sum(device_rows(lambda: empty.empty_launch(
            (n + 255) // 256, b, 1, 256, stream)).values())
        print(f"merge B={b} N={n}: device ms parent {med['parent']:.4f} "
              f"this {med['this']:.4f} searchsorted "
              f"{med['searchsorted']:.4f} ({short(rows['searchsorted'])}); "
              f"empty kernel on this grid {e_new:.4f}, on the parent's "
              f"{e_old:.4f}; same bits {same} | {smi}", flush=True)

        d = -torch.rand((b, n), generator=gen, device="cuda") * 40.0
        d[:, ::53] = -math.inf
        dg = (0.7 ** torch.arange(K, device="cuda", dtype=torch.float64)
              ).float()[None].repeat(b, 1).contiguous()
        if b == 1:
            d, dg = d[0], dg[0]
        a1, a2 = ld.ladder_stats(d, dg)
        p1, p2 = parent_ladder(d, dg)
        rel = max(float(((a1 - p1).abs() / p1).max()),
                  float(((a2 - p2).abs() / p2).max()))
        med, rows = in_turns({"parent": lambda: parent_ladder(d, dg),
                              "this": lambda: ld.ladder_stats(d, dg)})
        e_new = sum(device_rows(lambda: empty.empty_launch(
            lib.ladder_blocks(n), lib.ladder_groups(K), b, 128,
            stream)).values())
        e_old = sum(device_rows(lambda: empty.empty_launch(
            parent_ladder.lib.ladder_blocks(n), (K + 7) // 8, b, 256,
            stream)).values())
        print(f"ladder B={b} N={n} K={K}: device ms parent "
              f"{med['parent']:.4f} ({short(rows['parent'])}) this "
              f"{med['this']:.4f}; empty kernel on this grid {e_new:.4f}, "
              f"on the parent's partial grid {e_old:.4f}; same bits "
              f"{torch.equal(a1, p1) and torch.equal(a2, p2)}, max rel "
              f"diff {rel:.3e} | {smi}", flush=True)


def gamma_path(parent_ladder, smi):
    """The MM path at N = 1e5 from seed 1 with each ladder."""
    from smc_tpu_torch import SMCConfig, run_smc
    from smc_tpu_torch.models.michaelis_menten import MichaelisMentenModel
    from smc_tpu_torch.smc import kernels as sk
    model = MichaelisMentenModel.default(method="pallas_exact",
                                         device="cuda")
    cfg = SMCConfig(n_particles=100_000)
    out = {}
    for label, fn in (("this", ld.ladder_stats), ("parent", parent_ladder)):
        sk.ladder_stats = fn
        gammas = []
        s = run_smc(model, cfg, 1, verbose=False,
                    callback=lambda st: gammas.append(st.gamma.clone()))
        out[label] = (torch.stack(gammas), s)
    sk.ladder_stats = ld.ladder_stats
    (g_new, s_new), (g_old, s_old) = out["this"], out["parent"]
    same_g = g_new.shape == g_old.shape and torch.equal(g_new, g_old)
    print(f"MM path N=1e5 seed 1: steps this {int(s_new.step)} parent "
          f"{int(s_old.step)}; gamma sequence equal {same_g}; "
          f"log_evidence this {float(s_new.log_evidence):.6f} parent "
          f"{float(s_old.log_evidence):.6f} (bit-equal "
          f"{torch.equal(s_new.log_evidence, s_old.log_evidence)}); final "
          f"particles bit-equal "
          f"{torch.equal(s_new.particles, s_old.particles)} | {smi}",
          flush=True)
    print("    gammas this:   " + " ".join(f"{float(x):.9g}" for x in g_new))
    print("    gammas parent: " + " ".join(f"{float(x):.9g}" for x in g_old))


def sass_counts(smi):
    """Opcode counts of this tree's two kernels, from cuobjdump -sass."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path())],
                          capture_output=True, text=True,
                          check=True).stdout
    for func in re.split(r"\n\s+Function : ", sass):
        name = func.split("\n", 1)[0]
        if not ("ladder_kernel" in name or "merge_kernel" in name):
            continue
        ops = collections.Counter(
            op.split(".")[0] for op in re.findall(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)",
                func))
        print(f"sass {name[:60]}: {sum(ops.values())} instructions; "
              + ", ".join(f"{k} {v}" for k, v in ops.most_common(14)))
        if "ladder_kernel" in name and ops["MUFU"]:
            m = ops["MUFU"]
            print(f"    per MUFU.EX2 (one per term, over every unrolled "
                  f"body): FFMA {ops['FFMA'] / m:.2f} FADD "
                  f"{ops['FADD'] / m:.2f} FMUL {ops['FMUL'] / m:.2f} SHF "
                  f"{ops['SHF'] / m:.2f} FSEL {ops['FSEL'] / m:.2f} "
                  f"(FSEL: the ragged chunk's mask) | {smi}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="directory with the earlier ladder.cu and merge.cu")
    ap.add_argument("--no-path", action="store_true",
                    help="skip the MM path with each ladder")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = nvidia_smi()
    print(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    _build.load()
    out_dir = os.path.join(str(_build.BUILD_DIR), "ab")
    os.makedirs(out_dir, exist_ok=True)
    empty_cu = os.path.join(out_dir, "empty.cu")
    with open(empty_cu, "w") as f:
        f.write(EMPTY_CU)
    empty = nvcc_library(out_dir, "empty", [empty_cu])
    empty.empty_launch.argtypes = (I, I, I, I, P)
    empty.empty_launch.restype = I
    parent_ladder = ParentLadder(nvcc_library(
        out_dir, "parent_ladder", [os.path.join(args.parent, "ladder.cu")]))
    parent_merge = ParentMerge(nvcc_library(
        out_dir, "parent_merge", [os.path.join(args.parent, "merge.cu")]))
    kernels_ab(parent_ladder, parent_merge, empty, smi)
    if not args.no_path:
        gamma_path(parent_ladder, smi)
    sass_counts(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's CLI against the JAX package's: one run of each command
(``smc_tpu.cli.main`` and ``smc_tpu_torch.cli.main``) on ``run --model mm
--mm-method exact --particles 256`` with plots, and the files each writes.

The two packages draw different random numbers, so their runs are held
statistically; the artifact tree is held path for path, with the step
numbers and the nMH counts in per-step file names taken as patterns. The
plot functions of both packages are replaced here by stand-ins that record
each call and create the files the real function would write: rendering
~170 figures a run takes about a minute on the CPU, and the real plots are
held by ``tests/test_torch_io.py::test_plots_smoke``.
"""
import json
import os
import re

import numpy as np
import pytest

import tests.torch_parity  # noqa: F401  (one PyTorch thread per worker)
from smc_tpu import cli as jax_cli
from smc_tpu.viz import plots as jax_plots
from smc_tpu_torch import cli as torch_cli
from smc_tpu_torch.viz import plots as torch_plots

ARGS = ["run", "--model", "mm", "--mm-method", "exact", "--particles",
        "256", "--quiet"]


def _host(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else \
        np.asarray(x)


def _stub_plots(mp, module, calls):
    """Replace ``module``'s four plot functions with recorders that touch
    the files the real ones write (plot_parity: ``_<row>`` per
    observation row, box and mean)."""
    def touch(*paths):
        for p in paths:
            open(p, "w").close()
        return True

    def hist(particles, path, *a, **k):
        calls.append(("hist", path, _host(particles).shape))
        return touch(path)

    def parity(obs, predictions, box_path, mean_path, labels=None):
        rows = _host(obs).shape[0]
        calls.append(("parity", box_path, _host(predictions).shape))
        return touch(*[p.replace(".png", f"_{i}.png")
                       for p in (box_path, mean_path) for i in range(rows)])

    def pair(particles, path, *a, **k):
        calls.append(("pair", path, _host(particles).shape))
        return touch(path)

    def compare(prior, post, path, *a, **k):
        calls.append(("compare", path, _host(post).shape))
        return touch(path)

    for name, fn in (("plot_marginal_histograms", hist),
                     ("plot_parity", parity), ("plot_pairplot", pair),
                     ("plot_prior_posterior_compare", compare)):
        mp.setattr(module, name, fn)


def _files(run):
    return sorted(os.path.relpath(os.path.join(d, f), run)
                  for d, _, fs in os.walk(run) for f in fs)


def _pattern(rel):
    """A per-step file name with its step number and nMH count as
    patterns, and the async checkpoint's .smck as .npz (auto writes .npz
    where the native runtime is not built)."""
    rel = re.sub(r"^pred/\d+_", "pred/#_", rel)
    rel = re.sub(r"step\d+", "step#", rel)
    rel = re.sub(r"nMH\d+", "nMH#", rel)
    return re.sub(r"(step#)\.smck$", r"\1.npz", rel)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_parity")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for tag, cli, plots, extra in (
                ("jax", jax_cli, jax_plots, []),
                ("torch", torch_cli, torch_plots, ["--device", "cpu"])):
            calls = []
            _stub_plots(mp, plots, calls)
            rc = cli.main(ARGS + ["--outdir", str(root / tag)] + extra)
            (name,) = os.listdir(root / tag)
            run = str(root / tag / name)
            steps = [r["step"] for r in _metrics(run)]
            out[tag] = {"rc": rc, "run": run, "calls": calls,
                        "files": _files(run), "steps": steps}
    out["root"] = root
    return out


def _metrics(run):
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def _posterior(run):
    return np.loadtxt(os.path.join(run, "Posterior_Distribution.csv"),
                      delimiter=",", skiprows=1)


def test_both_runs_complete(runs):
    for tag in ("jax", "torch"):
        assert runs[tag]["rc"] == 0
        steps = runs[tag]["steps"]
        assert steps == list(range(1, len(steps) + 1)) and len(steps) >= 5


def test_same_artifact_tree(runs):
    """The same relative paths, as patterns; and in each run a per-step
    CSV, checkpoint, histogram and parity plot for every one of its
    steps."""
    pats = {tag: {_pattern(f) for f in runs[tag]["files"]}
            for tag in ("jax", "torch")}
    assert pats["jax"] == pats["torch"]
    for tag in ("jax", "torch"):
        files, steps = set(runs[tag]["files"]), runs[tag]["steps"]
        for s in steps:
            assert f"pred/{s}_p_pred.csv" in files
            assert {f"checkpoints/step{s}.smck",
                    f"checkpoints/step{s}.npz"} & files
            assert any(f.startswith(f"hist_progress/step{s:02d}_nMH")
                       for f in files)
            assert f"parity_box/step{s:02d}_0.png" in files
        for f in ("config.json", "metrics.jsonl", "checkpoints/final.npz",
                  "Posterior_Distribution.csv", "Posterior_Pairplot.png",
                  "Histgram_compare.png", "SMC_Posterior_Distribution.png",
                  "pred/first_p_pred.csv", "pred/last_p_pred.csv",
                  "hist_progress/00_PriorDistribution.png",
                  "parity_mean/parity_5.png"):
            assert f in files, (tag, f)


def test_same_plot_calls(runs):
    """Both runners ask for the same plots, at the same relative paths
    (as patterns), with inputs of the same shapes (parity predictions
    (64, 6, 40) from the plain closed form): per step a histogram and a
    parity plot, then the prior's and the posterior's histograms, the
    final parity plot, the pairplot and the comparison."""
    seen = {}
    for tag in ("jax", "torch"):
        run = runs[tag]["run"]
        seen[tag] = sorted((kind, _pattern(os.path.relpath(path, run)),
                            tuple(shape))
                           for kind, path, shape in runs[tag]["calls"])
    assert set(seen["jax"]) == set(seen["torch"])
    for tag in ("jax", "torch"):
        assert len(seen[tag]) == 2 * len(runs[tag]["steps"]) + 5, tag
    assert ("parity", "parity_box/parity.png", (64, 6, 40)) in seen["torch"]


def test_same_csvs_metrics_and_config(runs):
    for rel in ("Posterior_Distribution.csv", "pred/first_p_pred.csv",
                "pred/last_p_pred.csv", "pred/1_p_pred.csv"):
        heads, shapes = [], []
        for tag in ("jax", "torch"):
            path = os.path.join(runs[tag]["run"], rel)
            with open(path) as f:
                heads.append(f.readline().strip()
                             if rel.startswith("Posterior") else None)
            shapes.append(np.loadtxt(path, delimiter=",",
                                     skiprows=1 if heads[-1] else 0).shape)
        assert heads[0] == heads[1] and shapes[0] == shapes[1], rel
    with open(os.path.join(runs["torch"]["run"],
                           "Posterior_Distribution.csv")) as f:
        assert f.readline().strip() == "Vmax,Km,sigma"
    keys = [[list(r) for r in _metrics(runs[t]["run"])]
            for t in ("jax", "torch")]
    assert keys[0][0] == keys[1][0]
    assert all(k == keys[1][0] for k in keys[0] + keys[1])
    docs = []
    for tag in ("jax", "torch"):
        with open(os.path.join(runs[tag]["run"], "config.json")) as f:
            docs.append(json.load(f))
    assert docs[0].keys() == docs[1].keys()
    for part in ("config", "model"):
        assert docs[0][part].keys() == docs[1][part].keys(), part
    assert docs[0]["model"] == docs[1]["model"]


def test_posteriors_agree(runs):
    """Means within 4 posterior sd of each other, sds within a factor of
    2, both near the truth."""
    pj, pt = _posterior(runs["jax"]["run"]), _posterior(runs["torch"]["run"])
    sd = np.maximum(pj.std(0), pt.std(0))
    assert (np.abs(pj.mean(0) - pt.mean(0)) < 4 * sd).all()
    assert ((pt.std(0) / pj.std(0) > 0.5) & (pt.std(0) / pj.std(0) < 2)).all()
    assert (np.abs(pt.mean(0) - [1.2, 0.5, 0.02]) < 4 * pt.std(0)).all()


def test_read_metrics_reads_a_jax_file(runs):
    from smc_tpu.utils.metrics import read_metrics as jax_read
    from smc_tpu_torch.utils.metrics import MetricsLogger, read_metrics
    path = os.path.join(runs["jax"]["run"], "metrics.jsonl")
    recs = read_metrics(path)
    assert recs == jax_read(path)
    assert list(recs[0]) == list(MetricsLogger.FIELDS) + ["wall_time_s"]
    assert [r["step"] for r in recs] == runs["jax"]["steps"]


def test_resume_from_a_jax_checkpoint(runs, capsys):
    """The port's resume from the JAX run's step-2 checkpoint reaches
    gamma = 1; the JAX file's key seeds a fresh generator, so the result is
    held statistically against the port's own run."""
    ck_dir = os.path.join(runs["jax"]["run"], "checkpoints")
    (ck,) = [os.path.join(ck_dir, f) for f in os.listdir(ck_dir)
             if re.fullmatch(r"step2\.(smck|npz)", f)]
    out = runs["root"] / "resume"
    capsys.readouterr()
    rc = torch_cli.main(["resume", "--checkpoint", ck, "--model", "mm",
                         "--mm-method", "exact", "--particles", "256",
                         "--outdir", str(out), "--device", "cpu", "--quiet",
                         "--no-plots"])
    assert rc == 0
    assert "gamma: 1.0" in capsys.readouterr().out
    (name,) = os.listdir(out)
    pr = _posterior(str(out / name))
    pt = _posterior(runs["torch"]["run"])
    sd = np.maximum(pr.std(0), pt.std(0))
    assert (np.abs(pr.mean(0) - pt.mean(0)) < 4 * sd).all()
    assert _metrics(str(out / name))[0]["step"] == 3


def test_generate_data_matches_jax(tmp_path):
    """The noise-free columns agree with the JAX command's to 1e-6; the
    port's noise (a torch generator) has sd near 0.02."""
    assert jax_cli.main(["generate-data", "--outdir",
                         str(tmp_path / "j")]) == 0
    assert torch_cli.main(["generate-data", "--outdir", str(tmp_path / "t"),
                           "--device", "cpu"]) == 0
    resid = []
    for i in range(6):
        name = f"mm_pseudo_data_{i}.csv"
        j = np.loadtxt(tmp_path / "j" / name, delimiter=",", skiprows=1)
        t = np.loadtxt(tmp_path / "t" / name, delimiter=",", skiprows=1)
        assert t.shape == j.shape == (40, 4)
        assert np.abs(t[:, :3] - j[:, :3]).max() < 1e-6
        resid.append(t[:, 3] - t[:, 2])
    assert abs(np.std(np.concatenate(resid)) / 0.02 - 1) < 0.25

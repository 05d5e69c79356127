"""End-to-end experiment-script smoke runs.

Round-1 regression coverage: the flagship exp02 crashed on full runs with a
NameError in the UDE-vs-cUDE branch (``c-peptide/02-conditional.jl:716-795``)
because the smoke CI fixture lacked the exp01 artifact that triggers it, and
the committed metrics predated the refactor that broke it.  These tests

  1. place a UDE artifact so the branch is ALWAYS exercised in CI, and
  2. run exp02 twice from clean state and diff the metrics JSON —
     the "reproducing its metrics bit-for-bit across retrains" claim as an
     executable check instead of a README sentence.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

import pytest

pytestmark = pytest.mark.slow

REPO = Path(__file__).resolve().parent.parent


def _run_exp02_smoke(tmp_path: Path, tag: str) -> dict:
    art = tmp_path / f"artifacts_{tag}"
    res = tmp_path / f"results_{tag}"
    (art / "smoke").mkdir(parents=True)

    # tiny non-conditional UDE artifact (exp01's output format) so the
    # ude_vs_cude comparison branch runs
    sys.path.insert(0, str(REPO))
    import jax

    from conditional_ude_tpu.nn import chain

    ude_net = chain(4, 2, "tanh", input_dims=1)
    nn = np.asarray(ude_net.init_batch(jax.random.key(0), 2))
    np.savez(art / "smoke" / "ude_neural_parameters.npz", nn_params=nn)

    proc = subprocess.run(
        [sys.executable, str(REPO / "experiments" / "exp02_conditional.py"),
         "--smoke", "--artifacts", str(art), "--results", str(res)],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads((res / "smoke" / "exp02_metrics.json").read_text())


def test_exp02_smoke_covers_ude_branch_and_is_reproducible(tmp_path):
    m1 = _run_exp02_smoke(tmp_path, "a")
    assert m1["ude_vs_cude"] is not None, \
        "UDE artifact present but comparison branch did not run"
    assert np.isfinite(m1["ude_vs_cude"]["test_mse_cude_mean"])
    assert np.isfinite(m1["test_sse_mean"])

    m2 = _run_exp02_smoke(tmp_path, "b")
    # train_seconds / train_timings are wall-clock telemetry, not model
    # outputs — everything else must reproduce bit-for-bit across
    # identical retrains (but the code PATHS inside train_timings must
    # agree: same config ⇒ same screen/refine path)
    t1, t2 = m1.pop("train_timings", None), m2.pop("train_timings", None)
    if t1 is not None and t2 is not None:
        assert t1["screen_path"] == t2["screen_path"]
        assert t1["refine_path"] == t2["refine_path"]
    m1.pop("train_seconds", None)
    m2.pop("train_seconds", None)
    assert m1 == m2, "exp02 smoke metrics differ across identical retrains"


def test_exp_suppression_test_only_reproduces_test_stage(tmp_path):
    """--test-only must rebuild the test stage from the cached artifact and
    reproduce the sweep run's test-stage metrics exactly (the selection
    quantities are re-derived by revalidating the restart population)."""
    art, res = tmp_path / "artifacts", tmp_path / "results"

    def run(*extra):
        proc = subprocess.run(
            [sys.executable, str(REPO / "experiments" / "exp_suppression.py"),
             "--smoke", "--artifacts", str(art), "--results", str(res),
             *extra],
            cwd=REPO, capture_output=True, text=True, timeout=900)
        assert proc.returncode == 0, proc.stderr[-3000:]
        return json.loads(
            (res / "smoke" / "exp_suppression_metrics.json").read_text())

    m_sweep = run()
    assert "test_stage" in m_sweep
    m_only = run("--test-only")
    assert m_only["test_stage"] == m_sweep["test_stage"]
    # the sweep sections must survive the test-only rewrite untouched
    assert m_only == m_sweep


def test_exp_suppression_joint_sweep_driver(tmp_path):
    """--joint (one batched program over the λ×restart grid) must produce
    per-λ summaries equivalent to the serial per-λ driver path.  Library-
    level numerical parity is asserted tightly in
    test_suppression_recovery.py; this covers the CLI wiring, so the
    tolerance only needs to catch λ-axis mixups (which flip correlations
    far beyond it)."""
    art, res = tmp_path / "artifacts", tmp_path / "results"

    def run(*extra):
        proc = subprocess.run(
            [sys.executable, str(REPO / "experiments" / "exp_suppression.py"),
             "--smoke", "--no-test-stage", "--artifacts", str(art),
             "--results", str(res), *extra],
            cwd=REPO, capture_output=True, text=True, timeout=900)
        assert proc.returncode == 0, proc.stderr[-3000:]
        return json.loads(
            (res / "smoke" / "exp_suppression_metrics.json").read_text())

    m_serial = run()
    m_joint = run("--joint")
    assert set(m_joint) == set(m_serial)
    for lam, s in m_serial.items():
        j = m_joint[lam]
        for k in ("best_correlation_train", "best_correlation_valid"):
            assert abs(j[k] - s[k]) < 0.25, (lam, k, j[k], s[k])


def test_exp_suppression_merge_fine(tmp_path):
    """--merge-fine must stitch one-λ-per-process partials into the _fine
    sweep CSV + metrics, λ-sorted, with the
    shared test stage copied from the main metrics."""
    import csv

    res = tmp_path / "results"
    res.mkdir()
    sys.path.insert(0, str(REPO / "experiments"))
    try:
        from exp_suppression import fine_lambdas
    finally:
        sys.path.pop(0)
    lams = fine_lambdas()
    fields = ["lambda", "restart", "correlation_train", "loss_train",
              "correlation_valid", "loss_valid",
              "correlation_valid_nonoise", "loss_valid_nonoise"]
    for i, lam in enumerate(lams):
        (res / f"exp_suppression_metrics_{lam}.json").write_text(json.dumps(
            {str(lam): {"best_correlation_train": 0.9 - 0.01 * i,
                        "best_correlation_valid": 0.95 - 0.01 * i}}))
        with (res / f"suppression_sweep_{lam}.csv").open("w") as f:
            w = csv.DictWriter(f, fieldnames=fields)
            w.writeheader()
            for r in (1, 0):   # deliberately unsorted restarts
                w.writerow({"lambda": lam, "restart": r,
                            "correlation_train": 0.8, "loss_train": 1.0,
                            "correlation_valid": 0.9, "loss_valid": 0.5,
                            "correlation_valid_nonoise": 0.95,
                            "loss_valid_nonoise": 0.3})
    (res / "exp_suppression_metrics.json").write_text(json.dumps(
        {"0.01": {}, "test_stage": {"lambda": 0.01, "spearman": 0.89}}))

    proc = subprocess.run(
        [sys.executable, str(REPO / "experiments" / "exp_suppression.py"),
         "--merge-fine", "--results", str(res)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]

    merged = json.loads(
        (res / "exp_suppression_metrics_fine.json").read_text())
    assert set(merged) == {str(l) for l in lams} | {"test_stage"}
    assert merged["test_stage"]["spearman"] == 0.89
    with (res / "suppression_sweep_fine.csv").open() as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 2 * len(lams)
    keys = [(float(r["lambda"]), int(r["restart"])) for r in rows]
    assert keys == sorted(keys)

    # a missing per-λ partial must be a hard, named error
    (res / f"suppression_sweep_{lams[3]}.csv").unlink()
    proc = subprocess.run(
        [sys.executable, str(REPO / "experiments" / "exp_suppression.py"),
         "--merge-fine", "--results", str(res)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert str(lams[3]) in proc.stderr


def test_exp02_seeds_partial_and_merge(tmp_path):
    """The multi-seed replication driver must run a seed end-to-end (with
    the UDE-comparison branch engaged), write its partial, and --merge must
    aggregate partials into mean/sd/min/max summaries."""
    art = tmp_path / "artifacts"
    res = tmp_path / "results"
    (art / "smoke").mkdir(parents=True)

    sys.path.insert(0, str(REPO))
    import jax

    from conditional_ude_tpu.nn import chain

    ude_net = chain(4, 2, "tanh", input_dims=1)
    nn = np.asarray(ude_net.init_batch(jax.random.key(0), 2))
    np.savez(art / "smoke" / "ude_neural_parameters.npz", nn_params=nn)

    proc = subprocess.run(
        [sys.executable, str(REPO / "experiments" / "exp02_seeds.py"),
         "--smoke", "--seeds", "7",
         "--artifacts", str(art), "--results", str(res)],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    part = json.loads((res / "smoke" / "exp02_seed_7.json").read_text())
    assert part["seed"] == 7
    assert np.isfinite(part["test_sse_mean"])
    assert part["ude_vs_cude"] is not None

    # second synthetic partial so the aggregation has a spread to compute
    other = dict(part, seed=8, test_sse_mean=part["test_sse_mean"] + 1.0)
    (res / "smoke" / "exp02_seed_8.json").write_text(json.dumps(other))

    proc = subprocess.run(
        [sys.executable, str(REPO / "experiments" / "exp02_seeds.py"),
         "--smoke", "--merge", "--results", str(res)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads(
        (res / "smoke" / "exp02_seeds_metrics.json").read_text())
    assert summary["n_seeds"] == 2 and summary["seeds"] == [7, 8]
    assert abs(summary["test_sse_mean"]["max"]
               - summary["test_sse_mean"]["min"] - 1.0) < 1e-9
    assert (res / "smoke" / "exp02_seeds.csv").exists()


def test_exp_replicate_driver(tmp_path):
    """The generic multi-seed replication driver must run a script across
    seeds in isolated scratch dirs, aggregate every numeric metric leaf,
    and be crash-resumable (cached seeds skipped on re-run)."""
    out = subprocess.run(
        [sys.executable, str(REPO / "experiments" / "exp_replicate.py"),
         "--script", "exp00", "--seeds", "3", "4", "--smoke",
         "--scratch", str(tmp_path / "scratch"),
         "--results", str(tmp_path / "results")],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    rep = json.loads((tmp_path / "results" / "smoke"
                      / "replicate_exp00_prepare_data.json").read_text())
    assert rep["seeds"] == [3, 4]
    assert rep["aggregate"], "no numeric leaves aggregated"
    for stats in rep["aggregate"].values():
        assert set(stats) == {"mean", "sd", "min", "max"}

    # resumability: the second invocation must reuse the scratch metrics
    out2 = subprocess.run(
        [sys.executable, str(REPO / "experiments" / "exp_replicate.py"),
         "--script", "exp00", "--seeds", "3", "4", "--smoke",
         "--scratch", str(tmp_path / "scratch"),
         "--results", str(tmp_path / "results")],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out2.returncode == 0, out2.stderr[-2000:]
    assert out2.stderr.count("cached") == 2

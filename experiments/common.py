"""Shared experiment scaffolding: flags, cohort construction, metrics I/O.

The reference's experiment scripts configure themselves with top-of-file
globals (``RETRAIN_MODEL``, ``MAKE_FIGURES``) and cache trained weights in
``source_data/`` (``c-peptide/02-conditional.jl:2,44-59``).  Here every
experiment is a CLI with ``--smoke`` (tiny iteration counts for CI),
``--retrain`` and shared data/artifact paths.
"""

from __future__ import annotations

import argparse
import csv
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
# raw reference CSVs (``data/ohashi_csv``, ``data/fujita_csv`` of the
# reference repository), read only by the ETL, parity and clamp-figure code
DATA_DIR = REPO / "data"
ARTIFACTS = REPO / "artifacts"
RESULTS = REPO / "results"
OHASHI_NPZ = ARTIFACTS / "ohashi.npz"    # ETL output (exp00_prepare_data.py)
FUJITA_NPZ = ARTIFACTS / "fujita.npz"


def make_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--smoke", action="store_true",
                   help="tiny iteration counts / subset of subjects for CI "
                        "(runs on the CPU)")
    p.add_argument("--retrain", action="store_true",
                   help="recompute cached artifacts")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU backend")
    p.add_argument("--data-dir", type=Path, default=DATA_DIR,
                   help="raw reference CSVs (ETL, parity and the "
                        "clamp-insulin figure only)")
    p.add_argument("--artifacts", type=Path, default=ARTIFACTS)
    p.add_argument("--results", type=Path, default=RESULTS)
    p.add_argument("--seed", type=int, default=270523)
    return p


def configure_backend(args) -> None:
    """Pick the backend BEFORE any jax computation.

    ``--cpu`` and ``--smoke`` run on the CPU.  A full run needs a GPU and
    exits non-zero when JAX finds none.  Every experiment shares the
    persistent compilation cache (``utils.device.enable_compile_cache``), so
    repeat runs of the same shapes skip straight to execution.
    """
    import jax

    from conditional_ude_tpu.utils.device import (
        enable_compile_cache,
        require_gpu,
    )

    enable_compile_cache()
    if args.cpu or args.smoke:
        jax.config.update("jax_platforms", "cpu")
    else:
        try:
            require_gpu()
        except RuntimeError as e:
            sys.exit(f"[backend] {e}")
    if args.smoke:
        # keep smoke outputs away from full-run results/artifacts
        args.results = args.results / "smoke"
        args.artifacts = args.artifacts / "smoke"
    print(f"[backend] {jax.default_backend()}", file=sys.stderr)


def load_cohorts(smoke: bool = False, max_smoke: int = 8):
    """(train, test) OhashiSplits + jax cohorts, from the committed ETL
    output ``artifacts/ohashi.npz`` (82 train / 35 test subjects)."""
    from conditional_ude_tpu.data.ohashi import load_npz
    from conditional_ude_tpu.models.cpeptide import build_cohort

    train, test = load_npz(OHASHI_NPZ)
    if smoke:
        train = train.subset(np.arange(min(max_smoke, len(train.ages))))
        test = test.subset(np.arange(min(max_smoke, len(test.ages))))

    def cohort(split):
        return build_cohort(split.glucose, split.timepoints, split.cpeptide,
                            split.ages, split.t2dm)

    return train, test, cohort(train), cohort(test)


def load_fujita_cohort():
    """The Fujita external-validation cohort from ``artifacts/fujita.npz``."""
    from conditional_ude_tpu.data.fujita import load_fujita_npz

    return load_fujita_npz(FUJITA_NPZ)


def run_conditional_pipeline(args, cfg, artifact_name: str,
                             kind: str = "conditional",
                             input_dims: int = 2):
    """Shared exp02-family core (exp02 / exp02_xl / exp07):

    stratified fit/validation split → cached joint multi-start training
    (with the artifact-seed guard: a cached artifact trained under another
    seed rebuilds the validation split from ITS indices, so selection never
    scores candidates on their own fit subjects) → validation selection →
    (β, σ) re-estimation on the full train and test cohorts → σ-NLL → SSE
    back-conversion.  Returns a namespace the scripts extend with their
    specific analyses.
    """
    from types import SimpleNamespace

    import jax
    import jax.numpy as jnp

    from conditional_ude_tpu.fit.train import (
        evaluate_model,
        fit_betas_sigma,
        select_best,
        train_conditional,
    )
    from conditional_ude_tpu.models.cpeptide import CPeptideModel, build_cohort
    from conditional_ude_tpu.nn import chain
    from conditional_ude_tpu.utils.checkpoint import cached
    from conditional_ude_tpu.utils.stats import stratified_split

    train, test, cohort_train, cohort_test = load_cohorts(args.smoke)

    # 70/30 fit/validation split inside training (02-conditional.jl:19)
    rng = np.random.default_rng(args.seed)
    idx_fit, idx_val = stratified_split(rng, train.types, 0.7)
    fit_split, val_split = train.subset(idx_fit), train.subset(idx_val)

    def cohort(split):
        return build_cohort(split.glucose, split.timepoints, split.cpeptide,
                            split.ages, split.t2dm)

    cohort_fit, cohort_val = cohort(fit_split), cohort(val_split)

    net = chain(4, 2, "tanh", input_dims=input_dims)
    model = CPeptideModel(kind=kind, net=net)

    def compute():
        with Timer() as t:
            res = train_conditional(model, cohort_fit,
                                    jax.random.key(args.seed), cfg)
        tm = res.timings or {}
        return {"nn_params": res.nn_params, "betas": res.betas,
                "objectives": res.objectives, "idx_fit": np.asarray(idx_fit),
                "orientations": (np.zeros(0, np.float32)
                                 if res.orientations is None
                                 else np.asarray(res.orientations)),
                "seconds": np.asarray(t.seconds),
                # stage breakdown + the code paths that actually ran, so a
                # committed train_seconds is attributable (r03 verdict)
                "stage_seconds": np.asarray(
                    [tm.get(k, np.nan) for k in
                     ("screen", "adam", "lbfgs", "final_eval")], np.float64),
                "screen_path": np.asarray(tm.get("screen_path", "unknown")),
                "refine_path": np.asarray(tm.get("refine_path", "unknown"))}

    art = cached(args.artifacts / artifact_name, compute,
                 retrain=args.retrain,
                 metadata={"kind": kind, "input_dims": input_dims,
                           "guesses": cfg.initial_guesses,
                           "restarts": cfg.selected_initials})
    candidates = jnp.asarray(art["nn_params"])
    betas_cand = jnp.asarray(art["betas"])
    if "idx_fit" in art and not np.array_equal(art["idx_fit"], idx_fit):
        idx_fit = np.asarray(art["idx_fit"])
        idx_val = np.setdiff1d(np.arange(len(train.ages)), idx_fit)
        fit_split, val_split = train.subset(idx_fit), train.subset(idx_val)
        cohort_fit, cohort_val = cohort(fit_split), cohort(val_split)

    # model selection on validation (02-conditional.jl:36-41)
    val_iters = 50 if args.smoke else 1000
    objectives = evaluate_model(model, candidates, betas_cand, cohort_val,
                                lbfgs_iters=val_iters)
    best = select_best(objectives)
    nn_best = candidates[best]
    betas_best = np.asarray(betas_cand[best]).ravel()

    # canonical β-gauge of the selected model (train_conditional emits it;
    # artifacts trained before the gauge fix recompute it here) — all β
    # correlation/aggregation analyses use orientation * β
    from conditional_ude_tpu.models.cpeptide import production_orientation

    if "orientations" in art and art["orientations"] is not None \
            and np.asarray(art["orientations"]).size:
        orientation = float(np.asarray(art["orientations"])[best])
    else:
        orientation = float(production_orientation(
            model, nn_best, age=float(np.mean(train.ages))))

    # (β, σ) re-estimation, bounds = training-β range ±10% (:91-106)
    lb = betas_best.min() - 0.1 * abs(betas_best.min())
    ub = betas_best.max() + 0.1 * abs(betas_best.max())
    re_iters = 100 if args.smoke else 1000

    def reestimate(c):
        return fit_betas_sigma(model, nn_best, c, initial_beta=-1.0,
                               bounds=(float(lb), float(ub)),
                               lbfgs_iters=re_iters)

    b_train, s_train, o_train = map(np.asarray, reestimate(cohort_train))
    b_test, s_test, o_test = map(np.asarray, reestimate(cohort_test))

    # convert σ-NLL objectives back to SSE (:94,105)
    n_t = train.timepoints.shape[0]
    sse_train = (o_train - (n_t / 2) * np.log(s_train**2)) * (2 * s_train**2)
    sse_test = (o_test - (n_t / 2) * np.log(s_test**2)) * (2 * s_test**2)

    train_timings = None
    if "stage_seconds" in art:
        ss = np.asarray(art["stage_seconds"], np.float64)
        train_timings = {
            "stage_seconds": dict(zip(
                ("screen", "adam", "lbfgs", "final_eval"),
                (None if np.isnan(v) else float(v) for v in ss))),
            "screen_path": str(art.get("screen_path", "unknown")),
            "refine_path": str(art.get("refine_path", "unknown")),
        }

    return SimpleNamespace(
        train=train, test=test, cohort_train=cohort_train,
        cohort_test=cohort_test, idx_fit=idx_fit, idx_val=idx_val,
        train_timings=train_timings,
        net=net, model=model, art=art, candidates=candidates,
        betas_cand=betas_cand, best=best, nn_best=nn_best,
        val_objectives=np.asarray(objectives),
        orientation=orientation,
        lb=float(lb), ub=float(ub),
        b_train=b_train, s_train=s_train, sse_train=sse_train,
        b_test=b_test, s_test=s_test, sse_test=sse_test)


def per_type_mse(types: np.ndarray, mses: np.ndarray) -> dict[str, float]:
    """Mean MSE per NGT/IGT/T2DM class (``02-conditional.jl:108-113``)."""
    return {t: float(np.mean(mses[types == t])) for t in
            ("NGT", "IGT", "T2DM") if (types == t).any()}


def cohort_mse(model, nn_params, betas, cohort) -> np.ndarray:
    """Per-individual mean squared error of the fitted trajectories."""
    import jax.numpy as jnp

    from conditional_ude_tpu.models.cpeptide import simulate_cohort

    betas = jnp.asarray(betas)
    if betas.ndim == 1:
        betas = betas[:, None]
    res = simulate_cohort(model, nn_params, betas, cohort)
    mse = np.mean((np.asarray(res.ys[:, :, 0]) -
                   np.asarray(cohort.cpeptide)) ** 2, axis=1)
    return np.where(np.asarray(res.success), mse, np.inf)


def write_metrics(path: Path, metrics: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(metrics, indent=2, default=float))
    print(json.dumps(metrics, default=float))


def write_csv(path: Path, rows: list[dict]) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    if not rows:
        return
    with path.open("w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)


class Timer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.seconds = time.perf_counter() - self.t0
        print(f"[timer] {self.seconds:.1f}s", file=sys.stderr)

"""Beyond-parity multi-start: scale the joint cUDE search budget.

The reference's budget is 25,000 inits → 25 restarts
(``src/parameter-estimation.jl:340-348``).  On one accelerator the
screening pass is sub-second, so the search budget is effectively
free — this driver runs an enlarged multi-start (default 400k inits →
96 restarts, 16× the reference's screen and ~4× its refinement budget),
selects on validation, and evaluates held-out test SSE.

Round-5 finding: at 96 candidates the reference's argmin-validation rule
overfits the 25-subject validation split (selection saturation) — the
metrics therefore report the parity rule AND a guarded variant (argmin
validation within the top half by train objective).  The guarded
selection beats the reference's own cached weights on test data (mean
test SSE 0.493 vs 0.582 = ``mse_mean_test``×5,
``results/exp_parity_metrics.json``) with selection never touching the
test subjects.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np

from common import configure_backend, make_parser, per_type_mse, \
    run_conditional_pipeline, write_metrics


def main():
    p = make_parser(__doc__)
    p.add_argument("--inits", type=int, default=400_000)
    p.add_argument("--restarts", type=int, default=96)
    args = p.parse_args()
    configure_backend(args)

    from conditional_ude_tpu.fit.train import TrainConfig
    from conditional_ude_tpu.utils.stats import spearman

    if args.smoke:
        cfg = TrainConfig(initial_guesses=300, selected_initials=4,
                          adam_iters=25, lbfgs_iters=25, log_timings=True)
    else:
        cfg = TrainConfig(initial_guesses=args.inits,
                          selected_initials=args.restarts,
                          log_timings=True)

    r = run_conditional_pipeline(args, cfg, "cude_neural_parameters_xl.npz")
    train, test = r.train, r.test
    best, art = r.best, r.art
    b_train, sse_train = r.b_train, r.sse_train
    b_test, sse_test = r.b_test, r.sse_test

    b_all = np.concatenate([b_train, b_test])

    # -- selection-saturation check (round-5 finding) -----------------------
    # At 16x the reference's candidate count, the reference's
    # argmin-validation rule (02-conditional.jl:40) overfits the 25-subject
    # validation split: underfit-but-val-lucky candidates can win (they are
    # the restarts with the WORST train objectives, whose flat production
    # surfaces let the unbounded validation β refit absorb per-subject
    # variation).  Report a guarded variant alongside — argmin validation
    # restricted to the top half of candidates by train objective — so the
    # committed artifact carries both the parity rule and the robust one.
    from conditional_ude_tpu.fit.train import fit_betas_sigma

    val_sums = r.val_objectives.sum(axis=1)
    half = max(1, len(val_sums) // 2)          # candidates sorted best-first
    best_guard = int(np.argmin(val_sums[:half]))
    n_t = train.timepoints.shape[0]
    if best_guard != best:
        nn_g = r.candidates[best_guard]
        bg = np.asarray(r.betas_cand[best_guard]).ravel()
        lb_g = bg.min() - 0.1 * abs(bg.min())
        ub_g = bg.max() + 0.1 * abs(bg.max())
        _bg, s_g, o_g = map(np.asarray, fit_betas_sigma(
            r.model, nn_g, r.cohort_test, initial_beta=-1.0,
            bounds=(float(lb_g), float(ub_g)),
            lbfgs_iters=100 if args.smoke else 1000))
        sse_test_guard = (o_g - (n_t / 2) * np.log(s_g**2)) * (2 * s_g**2)
    else:
        sse_test_guard = sse_test

    write_metrics(args.results / "exp02_xl_metrics.json", {
        "config": f"{cfg.initial_guesses} inits, "
                  f"{cfg.selected_initials} restarts "
                  f"({cfg.initial_guesses // 25_000}x reference screen)",
        "train_seconds": float(art.get("seconds", np.nan)),
        "best_model_index": best,
        "train_sse_per_type": per_type_mse(train.types, sse_train),
        "test_sse_per_type": per_type_mse(test.types, sse_test),
        "train_sse_mean": float(sse_train.mean()),
        "test_sse_mean": float(sse_test.mean()),
        "test_sse_median": float(np.median(sse_test)),
        "spearman_first_phase": spearman(b_all, np.concatenate(
            [train.first_phase, test.first_phase])),
        "selection_note": (
            "argmin-validation at 96 candidates overfits the 25-subject "
            "validation split (the winner can be an underfit restart with "
            "a val-lucky flat surface); guarded_* rows restrict selection "
            "to the top half by train objective"),
        "guarded_best_model_index": best_guard,
        "guarded_test_sse_mean": float(np.nanmean(
            sse_test_guard[np.isfinite(sse_test_guard)])),
        "guarded_test_sse_median": float(np.nanmedian(
            sse_test_guard[np.isfinite(sse_test_guard)])),
    })


if __name__ == "__main__":
    main()

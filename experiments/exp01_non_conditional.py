"""Experiment 01 — non-conditional UDE baseline
(reference ``c-peptide/01-non-conditional.jl``).

Fits the NN production term on the *mean* train glucose/c-peptide curves
(multi-start 10,000 → top 10 → Adam + L-BFGS), then evaluates per-individual
MSE on every train and test subject with the shared weights.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np

from common import configure_backend,  Timer, load_cohorts, make_parser, per_type_mse, \
    write_metrics


def main():
    args = make_parser(__doc__).parse_args()
    configure_backend(args)

    import jax
    import jax.numpy as jnp

    from conditional_ude_tpu.fit.train import train_ude
    from conditional_ude_tpu.models.cpeptide import (
        CPeptideModel,
        build_individual,
        simulate_cohort,
    )
    from conditional_ude_tpu.nn import chain
    from conditional_ude_tpu.utils.checkpoint import cached

    train, test, cohort_train, cohort_test = load_cohorts(args.smoke)
    tp = jnp.asarray(train.timepoints, jnp.float32)

    # mean train curves (01-non-conditional.jl:16-26)
    mean_glucose = train.glucose.mean(axis=0)
    mean_cpeptide = train.cpeptide.mean(axis=0).astype(np.float32)
    mean_ind = build_individual(mean_glucose, train.timepoints,
                                float(train.ages.mean()),
                                float(mean_cpeptide[0]), False)

    net = chain(4, 2, "tanh", input_dims=1)
    model = CPeptideModel(kind="ude", net=net)

    guesses = 100 if args.smoke else 10_000
    selected = 3 if args.smoke else 10
    iters = 20 if args.smoke else 1000

    def compute():
        with Timer():
            nn_fit, objs, _ = train_ude(
                model, mean_ind, tp, jnp.asarray(mean_cpeptide),
                jax.random.key(args.seed),
                initial_guesses=guesses, selected_initials=selected,
                adam_iters=iters, lbfgs_iters=iters)
        return {"nn_params": nn_fit, "objectives": objs}

    art = cached(args.artifacts / "ude_neural_parameters.npz", compute,
                 retrain=args.retrain,
                 metadata={"script": "exp01", "guesses": guesses})
    nn_best = jnp.asarray(art["nn_params"][0])

    # per-individual evaluation with shared weights (:59-76)
    def mses(cohort, data):
        res = simulate_cohort(model, nn_best,
                              jnp.zeros((cohort.n, 0), jnp.float32), cohort)
        return np.mean((np.asarray(res.ys[:, :, 0]) - data) ** 2, axis=1)

    mse_train = mses(cohort_train, train.cpeptide)
    mse_test = mses(cohort_test, test.cpeptide)

    # cross-check anchor: the reference's OWN cached UDE weights
    # (ude_neural_parameters.jld2) scored at DOP853 ground truth on the
    # same cohorts (scripts/make_golden_parity.py; the reference prints
    # its MSEs at runtime only, 01-non-conditional.jl:59-76, so this
    # golden is the committed stand-in for those prints)
    import json

    golden_meta = (Path(__file__).resolve().parent.parent / "tests"
                   / "golden" / "reference_parity_ude_golden.json")
    ref_block = None
    if golden_meta.exists():
        g = json.loads(golden_meta.read_text())
        ref_block = {"mse_train_per_point": g["mse_train"],
                     "mse_test_per_point": g["mse_test"],
                     "source": g["source_weights"]}

    write_metrics(args.results / "exp01_metrics.json", {
        "objective_best": float(art["objectives"][0]),
        "train_mse_mean": float(mse_train.mean()),
        "test_mse_mean": float(mse_test.mean()),
        "train_mse_per_type": per_type_mse(train.types, mse_train),
        "test_mse_per_type": per_type_mse(test.types, mse_test),
        "reference_ude_weights_golden": ref_block,
    })


if __name__ == "__main__":
    main()

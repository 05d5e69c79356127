"""Experiment 03 — symbolic-model fits on the full Ohashi cohort
(reference ``c-peptide/03-symreg.jl``).

Fits the PySR-discovered production ``1.78·ΔG/(ΔG + k)`` per individual on
all 117 subjects ((k, σ) bounded L-BFGS), reports correlations of k with the
clamp indices and likelihood-profile confidence intervals on k.
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

    from conditional_ude_tpu.analysis import (
        Profile,
        classify_identifiability,
        find_confidence_intervals,
    )
    from conditional_ude_tpu.fit.losses import sse
    from conditional_ude_tpu.models.cpeptide import build_cohort
    from conditional_ude_tpu.models.symbolic import fit_k_sigma, symbolic_model
    from conditional_ude_tpu.utils.stats import spearman

    train, test, *_ = load_cohorts(args.smoke)

    # the reference fits all 117 subjects at once (03-symreg.jl:92-107)
    glucose = np.concatenate([train.glucose, test.glucose])
    cpeptide = np.concatenate([train.cpeptide, test.cpeptide])
    ages = np.concatenate([train.ages, test.ages])
    types = np.concatenate([train.types, test.types])
    t2dm = types == "T2DM"
    cohort = build_cohort(glucose, train.timepoints, cpeptide, ages, t2dm)

    iters = 100 if args.smoke else 1000
    with Timer():
        ks, sigmas, objs = map(np.asarray, fit_k_sigma(cohort,
                                                       lbfgs_iters=iters))
    sse_vals = (objs - (train.timepoints.shape[0] / 2)
                * np.log(sigmas**2)) * (2 * sigmas**2)

    corr = {
        "first_phase": spearman(ks, np.concatenate(
            [train.first_phase, test.first_phase])),
        "age": spearman(ks, ages),
        "insulin_sensitivity": spearman(ks, np.concatenate(
            [train.insulin_sensitivity, test.insulin_sensitivity])),
    }

    # likelihood profiles over k (CI analysis of 03-symreg.jl)
    model = symbolic_model()
    steps = 200 if args.smoke else 10_000
    grid = jnp.linspace(0.0, 1000.0, steps)

    # jit ONCE with the grid chunk as a traced operand — a jit built
    # inside the loop would close over each chunk and recompile the
    # 117×250-solve program on every iteration
    profile_chunk = jax.jit(jax.vmap(
        lambda ind, d, s, g: jax.vmap(
            lambda k: sse(model, {"k": k}, ind, cohort.timepoints, d)
            / (2.0 * s**2))(g),
        in_axes=(0, 0, 0, None)))
    chunk_vals = []
    for i in range(0, steps, 250):
        part = profile_chunk(cohort.individuals, cohort.cpeptide,
                             jnp.asarray(sigmas), grid[i:i + 250])
        chunk_vals.append(np.asarray(part))
    values = np.concatenate(chunk_vals, axis=1)
    prof = Profile(grid=np.asarray(grid), values=values,
                   minimum=values.min(axis=1))
    ci = find_confidence_intervals(prof, "cantelli95")
    census = classify_identifiability(ci)

    from conditional_ude_tpu.utils.checkpoint import save_checkpoint
    save_checkpoint(args.artifacts / "symreg_fit.npz", {
        "ks": ks, "sigmas": sigmas, "objectives": objs,
    }, metadata={"script": "exp03"})

    write_metrics(args.results / "exp03_metrics.json", {
        "k_mean": float(ks.mean()),
        "k_median": float(np.median(ks)),
        "sse_per_type": per_type_mse(types, sse_vals),
        "spearman": corr,
        "identifiability_census": {c: int((census == c).sum())
                                   for c in np.unique(census)},
    })


if __name__ == "__main__":
    main()

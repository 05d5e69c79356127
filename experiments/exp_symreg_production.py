"""Discovered-equation production fits — the complete in-repo loop.

The reference's pipeline is NN → PySR equation → per-individual mechanistic
refits (``c-peptide/03-symreg.jl`` on Ohashi, ``04-symreg-external.jl`` on
Fujita) — but its equation comes from an external PySR run.  This
experiment closes the same loop end-to-end with NO inherited pieces: the
equation is the one THIS repo's GP search discovers on its own exported
production surface (``models/symbolic.py::discovered_production``,
``results/symbolic_regression_result.csv`` c=14 row),

    production(ΔG, b) = 0.1817·ΔG / (b²·(ΔG + 5.507) + 2.99),  b = e^β scale,

fit per individual ((b, σ) bounded L-BFGS, one vmapped program) on all 117
Ohashi subjects, with β-surrogate correlations against the clamp indices,
cantelli95 profile-likelihood CIs over b, and external validation on the
Fujita cohort.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np

from common import configure_backend, Timer, load_cohorts, \
    load_fujita_cohort, make_parser, \
    per_type_mse, write_metrics


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
    from conditional_ude_tpu.models.symbolic import (
        discovered_model,
        fit_b_sigma,
    )
    from conditional_ude_tpu.utils.stats import spearman

    train, test, *_ = load_cohorts(args.smoke)

    # all 117 subjects at once, as the reference does for k (03-symreg.jl:92)
    glucose = np.concatenate([train.glucose, test.glucose])
    cpeptide = np.concatenate([train.cpeptide, test.cpeptide])
    ages = np.concatenate([train.ages, test.ages])
    types = np.concatenate([train.types, test.types])
    cohort = build_cohort(glucose, train.timepoints, cpeptide, ages,
                          types == "T2DM")

    iters = 100 if args.smoke else 1000
    with Timer():
        bs, sigmas, objs = map(np.asarray, fit_b_sigma(cohort,
                                                       lbfgs_iters=iters))
    n_t = train.timepoints.shape[0]
    sse_vals = (objs - (n_t / 2) * np.log(sigmas**2)) * (2 * sigmas**2)

    # b gates the denominator (production decreasing in b), the same role
    # as exp03's Michaelis constant k — expect correlations in the same
    # direction and magnitude class as exp03's k (first_phase ≈ −0.81)
    corr = {
        "first_phase": spearman(bs, np.concatenate(
            [train.first_phase, test.first_phase])),
        "age": spearman(bs, ages),
        "insulin_sensitivity": spearman(bs, np.concatenate(
            [train.insulin_sensitivity, test.insulin_sensitivity])),
    }

    # cantelli95 profile CIs over b (mirror of exp03's k profiles)
    model = discovered_model()
    steps = 200 if args.smoke else 10_000
    grid = jnp.linspace(1e-3, 10.0, steps)

    # jit ONCE with the grid chunk as a traced operand — a jit built
    # inside the loop would close over each chunk and recompile the
    # 117×250-solve program 40 times (same invariant as
    # analysis/profiles.py's data-polymorphic chunking)
    profile_chunk = jax.jit(jax.vmap(
        lambda ind, d, s, g: jax.vmap(
            lambda b: sse(model, {"b": b}, ind, cohort.timepoints, d)
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

    # external validation on the independent Fujita cohort (exp04 analog)

    fujita = load_fujita_cohort()
    cohort_f = build_cohort(fujita.glucose, fujita.timepoints,
                            fujita.cpeptide, fujita.ages,
                            np.zeros(len(fujita.ages), bool))
    with Timer():
        bs_f, sig_f, objs_f = map(np.asarray, fit_b_sigma(
            cohort_f, lbfgs_iters=iters, solver_max_steps=512))
    n_tf = fujita.timepoints.shape[0]
    sse_f = (objs_f - (n_tf / 2) * np.log(sig_f**2)) * (2 * sig_f**2)

    from conditional_ude_tpu.utils.checkpoint import save_checkpoint
    save_checkpoint(args.artifacts / "discovered_fit.npz", {
        "bs": bs, "sigmas": sigmas, "objectives": objs,
        "bs_fujita": bs_f, "sigmas_fujita": sig_f,
        "objectives_fujita": objs_f,
    }, metadata={"script": "exp_symreg_production"})

    write_metrics(args.results / "exp_symreg_production_metrics.json", {
        "equation": "0.1817*dG / (b^2*(dG + 5.507) + 2.99)",
        "b_mean": float(bs.mean()),
        "b_median": float(np.median(bs)),
        "mse_per_type": per_type_mse(types, sse_vals / n_t),
        "spearman": corr,
        "identifiability_census": {c: int((census == c).sum())
                                   for c in np.unique(census)},
        "fujita_external": {
            "n": int(len(bs_f)),
            "mse_mean": float((sse_f / n_tf).mean()),
            "mse_median": float(np.median(sse_f / n_tf)),
            "b_median": float(np.median(bs_f)),
        },
    })


if __name__ == "__main__":
    main()

"""Experiment 06b — SAEM on the IN-REPO discovered equation.

The reference's ``06a-saem-symreg.jl`` runs SAEM mixed-effects estimation
on its (externally PySR-derived) symbolic model.  This is the same
pipeline with zero inherited pieces: the production equation comes from
this repo's own GP search (``models/symbolic.py::discovered_production``),
b_pop initialized at the exp_symreg_production cohort median (~0.43);
η_i random effects with log-normal map b_i = b_pop·e^{η_i}; population
update by 5-iteration L-BFGS; posterior / MAP / MLE per individual on the
full cohort.  No reference analog — a beyond-parity demonstration that
every estimator tier (multi-start MLE, profile likelihood, SAEM, ADVI)
runs on the discovered equation too.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np

from common import configure_backend, Timer, load_cohorts, make_parser, \
    per_type_mse, write_metrics


def main():
    args = make_parser(__doc__).parse_args()
    configure_backend(args)

    import jax
    import jax.numpy as jnp

    from conditional_ude_tpu.fit.saem import (
        SAEMConfig,
        discovered_loglik,
        individual_maps,
        individual_mles,
        posterior_chains,
        saem_discovered,
    )
    from conditional_ude_tpu.models.cpeptide import build_cohort

    train, test, *_ = load_cohorts(args.smoke)

    glucose = np.concatenate([train.glucose, test.glucose])
    cpeptide = np.concatenate([train.cpeptide, test.cpeptide])
    ages = np.concatenate([train.ages, test.ages])
    types = np.concatenate([train.types, test.types])
    cohort = build_cohort(glucose, train.timepoints, cpeptide, ages,
                          types == "T2DM")

    cfg = SAEMConfig(iterations=6, burnin=3, n_mcmc_steps=3,
                     pop_update_lbfgs=True, update_prior_mean=False) \
        if args.smoke else \
        SAEMConfig(iterations=180, burnin=80, n_mcmc_steps=25,
                   initial_mcmc_steps=25, pop_update_lbfgs=True,
                   update_prior_mean=False)

    with Timer():
        res = saem_discovered(cohort, 0.43, jax.random.key(args.seed), cfg)

    ll = discovered_loglik(cohort.timepoints)
    init = jnp.zeros((cohort.n,))
    n_mh = 100 if args.smoke else 3000
    chains, acc = posterior_chains(
        ll, res.theta, res.sigma, cohort.individuals, cohort.cpeptide,
        jax.random.key(1), init, eta=jnp.asarray(0.0), omega=res.omega,
        n_steps=n_mh)
    map_iters = 20 if args.smoke else 100
    maps = np.asarray(individual_maps(
        ll, res.theta, res.sigma, cohort.individuals, cohort.cpeptide,
        init, eta=jnp.asarray(0.0), omega=res.omega, max_iters=map_iters))
    mles = np.asarray(individual_mles(
        ll, res.theta, res.sigma, cohort.individuals, cohort.cpeptide,
        init, max_iters=map_iters))

    b_map = float(res.theta) * np.exp(maps)

    # the MAP b's must carry the same clamp-index biology as the direct
    # per-individual fits (exp_symreg_production: spearman ≈ -0.81)
    from conditional_ude_tpu.utils.stats import spearman

    fp_all = np.concatenate([train.first_phase, test.first_phase])

    write_metrics(args.results / "exp06b_metrics.json", {
        "b_pop": float(res.theta),
        "sigma": float(abs(res.sigma)),
        "omega": float(res.omega),
        "final_nll": float(res.nll_trace[-1]),
        "b_map_median": float(np.median(b_map)),
        "map_mle_correlation": float(np.corrcoef(maps, mles)[0, 1]),
        "posterior_acceptance_mean": float(np.mean(np.asarray(acc))),
        "spearman_b_map_first_phase": spearman(b_map, fp_all),
    })


if __name__ == "__main__":
    main()

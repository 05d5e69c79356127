"""Experiment 06a — SAEM on the symbolic model
(reference ``c-peptide/06a-saem-symreg.jl``).

kM_pop initialized at 75.0; η_i random effects with log-normal map
kM_i = kM_pop·e^{η_i}; population update by 5-iteration L-BFGS; posterior /
MAP / MLE per individual on the full cohort.
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

    from conditional_ude_tpu.fit.saem import (
        SAEMConfig,
        individual_maps,
        individual_mles,
        posterior_chains,
        saem_symbolic,
        symbolic_loglik,
    )
    from conditional_ude_tpu.models.cpeptide import build_cohort

    train, test, *_ = load_cohorts(args.smoke)

    # reference fits all individuals at once (06a-saem-symreg.jl:29-45)
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
        res = saem_symbolic(cohort, 75.0, jax.random.key(args.seed), cfg)

    ll = symbolic_loglik(cohort.timepoints)
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

    km_map = float(res.theta) * np.exp(maps)

    write_metrics(args.results / "exp06a_metrics.json", {
        "km_pop": float(res.theta),
        # the SAEM fixed-effect update is unconstrained and the NLL is even
        # in sigma (every use is sigma^2), so report the magnitude
        "sigma": float(abs(res.sigma)),
        "omega": float(res.omega),
        "final_nll": float(res.nll_trace[-1]),
        "km_map_median": float(np.median(km_map)),
        "map_mle_correlation": float(np.corrcoef(maps, mles)[0, 1]),
        "posterior_acceptance_mean": float(np.mean(np.asarray(acc))),
    })


if __name__ == "__main__":
    main()

"""Experiment 04 — external validation of the symbolic model on the Fujita
cohort (reference ``c-peptide/04-symreg-external.jl``).

20 non-diabetic subjects, 14 OGTT timepoints (−10…240 min), age fixed at 29;
per-individual (k, σ) fits with the same bounded L-BFGS as experiment 03.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np

from common import configure_backend, Timer, load_fujita_cohort, make_parser, \
    write_metrics


def main():
    args = make_parser(__doc__).parse_args()
    configure_backend(args)

    from conditional_ude_tpu.models.cpeptide import build_cohort
    from conditional_ude_tpu.models.symbolic import fit_k_sigma

    fujita = load_fujita_cohort()
    n = 4 if args.smoke else fujita.glucose.shape[0]
    cohort = build_cohort(fujita.glucose[:n], fujita.timepoints,
                          fujita.cpeptide[:n], fujita.ages[:n],
                          fujita.t2dm[:n])

    iters = 100 if args.smoke else 1000
    with Timer():
        ks, sigmas, objs = map(np.asarray,
                               fit_k_sigma(cohort, lbfgs_iters=iters,
                                           solver_max_steps=512))

    n_t = fujita.timepoints.shape[0]
    sse_vals = (objs - (n_t / 2) * np.log(sigmas**2)) * (2 * sigmas**2)
    mse = sse_vals / n_t

    from conditional_ude_tpu.utils.checkpoint import save_checkpoint
    save_checkpoint(args.artifacts / "symreg_external_fit.npz", {
        "ks": ks, "sigmas": sigmas, "objectives": objs,
    }, metadata={"script": "exp04"})

    # profile-likelihood CIs at the 25/50/75% quantile subjects
    # (``04-symreg-external.jl:92-150``: profile k over [k−25, k+1000],
    # 10k points, cantelli95 crossing, simulate CI-bound trajectories)
    import jax
    import jax.numpy as jnp

    from conditional_ude_tpu.analysis import (
        find_confidence_intervals,
        likelihood_profile,
    )
    from conditional_ude_tpu.fit.losses import sse
    from conditional_ude_tpu.models.cpeptide import simulate
    from conditional_ude_tpu.models.symbolic import symbolic_model

    sym = symbolic_model()
    steps = 200 if args.smoke else 10_000
    dense_t = np.arange(fujita.timepoints[0], fujita.timepoints[-1] + 0.1,
                        2.0).astype(np.float32)

    def argquantile(x, q):
        return int(np.argmin(np.abs(x - np.quantile(x, q))))

    quantile_ci = {}
    ci_curves = {}
    for q in (0.25, 0.5, 0.75):
        i = argquantile(sse_vals, q)
        ind = jax.tree.map(lambda a: a[i], cohort.individuals)
        data_i = jnp.asarray(cohort.cpeptide[i])

        def loss_k(k):
            return sse(sym, {"k": k}, ind, cohort.timepoints, data_i,
                       solver="rk4", substeps=8, max_steps=512)

        prof = likelihood_profile(loss_k, float(ks[i]) - 25.0,
                                  float(ks[i]) + 1000.0, steps=steps,
                                  sigma=float(sigmas[i]))
        ci = find_confidence_intervals(prof, "cantelli95")
        quantile_ci[str(q)] = {
            "subject": i, "k": float(ks[i]),
            "ci_lower": float(ci.lower), "ci_upper": float(ci.upper),
        }

        def sim_at(k):
            return np.asarray(simulate(
                sym, {"k": jnp.asarray(k, jnp.float32)}, ind,
                jnp.asarray(dense_t), solver="rk4", substeps=4).ys[:, 0])

        ci_curves[q] = (
            i, sim_at(ks[i]),
            sim_at(ci.lower) if np.isfinite(ci.lower) else None,
            sim_at(ci.upper) if np.isfinite(ci.upper) else None)

    # quantile-fit figure with CI-bound trajectories (the reference's
    # manuscript external-validation figure)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from conditional_ude_tpu.utils import figures

        fig, axes = plt.subplots(1, 3, figsize=(8.4, 2.8), sharey=True)
        for ax, q in zip(axes, (0.25, 0.5, 0.75)):
            i, mid, lo, hi = ci_curves[q]
            for bound in (lo, hi):
                if bound is not None:
                    ax.plot(dense_t, bound, color=figures.COLORS["NGT"],
                            lw=1.0, ls=":", alpha=0.6)
            ax.plot(dense_t, mid, color=figures.COLORS["NGT"], lw=1.8)
            ax.scatter(fujita.timepoints, np.asarray(cohort.cpeptide[i]),
                       s=12, color="k", zorder=3)
            ax.set_title(f"{int(q * 100)}%", fontsize=9)
            ax.set_xlabel("time (min)")
        axes[0].set_ylabel("C-peptide (nM)")
        figures.save(fig, args.results / "figures" /
                     "model_fit_external_quantiles.png")
        plt.close(fig)
    except Exception as e:   # matplotlib headless quirks must not kill fits
        print(f"[figure skipped] {e}", file=sys.stderr)

    write_metrics(args.results / "exp04_metrics.json", {
        "n_subjects": int(n),
        "k_mean": float(ks.mean()),
        "k_median": float(np.median(ks)),
        "k_quantiles": {q: float(np.quantile(ks, float(q)))
                        for q in ("0.25", "0.5", "0.75")},
        "profile_ci_quantile_subjects": quantile_ci,
        "mse_mean": float(mse.mean()),
        "all_finite": bool(np.isfinite(objs).all()),
    })


if __name__ == "__main__":
    main()

"""Figure gallery — renders the reference's publication-figure set from the
cached artifacts (reference figure code lives inline in
``c-peptide/02-conditional.jl`` and friends; filenames mirrored here).

Sections are skipped (with a note) when their artifact is missing, so the
gallery can be produced incrementally.  Outputs land in
``results/figures/`` and a manifest of rendered files is written to
``results/exp_figures_manifest.json``.
"""

from __future__ import annotations

import csv
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np

from common import configure_backend, load_cohorts, load_fujita_cohort, \
    make_parser, write_metrics

RENDERED: list[str] = []


def emit(fig, outdir: Path, name: str):
    from conditional_ude_tpu.utils import figures

    figures.save(fig, outdir / name)
    RENDERED.append(name)
    print(f"[figure] {name}", file=sys.stderr)
    try:
        import matplotlib.pyplot as plt

        plt.close(fig)   # a full gallery run renders ~30 figures
    except Exception:
        pass


def skip(name: str, why: str):
    print(f"[skip] {name}: {why}", file=sys.stderr)


def median_index_per_type(types, errors):
    """Index of the median-error subject of each type
    (``02-conditional.jl`` model_fit_test_median via ``argmedian``)."""
    from conditional_ude_tpu.utils.stats import argmedian

    idx = []
    for t in ("NGT", "IGT", "T2DM"):
        sel = np.flatnonzero(types == t)
        if sel.size:
            idx.append(int(sel[argmedian(errors[sel])]))
    return np.asarray(idx)


def main():
    p = make_parser(__doc__)
    p.add_argument("--sections", nargs="*", default=None,
                   help="subset of sections to render")
    args = p.parse_args()
    configure_backend(args)

    import jax
    import jax.numpy as jnp

    from conditional_ude_tpu.models.cpeptide import (
        CPeptideModel,
        build_cohort,
        simulate_cohort,
    )
    from conditional_ude_tpu.nn import chain
    from conditional_ude_tpu.utils import figures
    from conditional_ude_tpu.utils.stats import spearman, stratified_split

    outdir = args.results / "figures"
    art = args.artifacts
    want = (lambda s: args.sections is None or s in args.sections)

    train, test, cohort_train, cohort_test = load_cohorts(args.smoke)
    dense_t = np.arange(train.timepoints[0], train.timepoints[-1] + 0.1,
                        2.0).astype(np.float32)
    re_iters = 100 if args.smoke else 1000
    prof_steps = 200 if args.smoke else 2000
    ci_steps = 200 if args.smoke else 10_000

    from conditional_ude_tpu.analysis import (
        cohort_beta_profiles,
        find_confidence_intervals,
    )
    from conditional_ude_tpu.models.cpeptide import simulate

    def ci_bound_sims(fit_model, nn_p, betas, sigmas, cohort, idx_med,
                      method="cantelli95"):
        """Profile-CI-bound trajectories around selected subjects
        (``02-conditional.jl:186-208``: profile β over [β−10, β+15],
        threshold crossing, simulate both bound β's; a ``None`` side means
        the CI is open there).  All selected subjects profile in ONE
        batched ``cohort_beta_profiles`` call (``center=β̂`` makes the grid
        a shared Δβ axis)."""
        idx = np.asarray(idx_med, int)
        sub = cohort._replace(
            individuals=jax.tree.map(lambda a: a[idx], cohort.individuals),
            cpeptide=cohort.cpeptide[idx])
        b_sel = np.asarray(betas, np.float32)[idx]
        s_sel = np.asarray(sigmas, np.float32)[idx]
        prof = cohort_beta_profiles(fit_model, nn_p, sub, sigmas=s_sel,
                                    lower=-10.0, upper=15.0, steps=ci_steps,
                                    center=b_sel, substeps=8)
        ci = find_confidence_intervals(prof, method)

        out = {}
        for pos, i in enumerate(idx):
            ind = cohort.individual(int(i))

            def sim_at(beta):
                return np.asarray(simulate(
                    fit_model,
                    {"neural": nn_p,
                     "conditional": jnp.asarray(beta, jnp.float32)},
                    ind, jnp.asarray(dense_t), solver="rk4",
                    substeps=4).ys[:, 0])

            # the profile grid is Δβ around each subject's β̂
            lo, hi = ci.lower[pos], ci.upper[pos]
            out[pos] = (
                sim_at(float(b_sel[pos]) + lo) if np.isfinite(lo) else None,
                sim_at(float(b_sel[pos]) + hi) if np.isfinite(hi) else None)
        return out

    # ------------------------------------------------------------------ data
    if want("data"):
        g_all = np.concatenate([train.glucose, test.glucose])
        c_all = np.concatenate([train.cpeptide, test.cpeptide])
        t_all = np.concatenate([train.types, test.types])
        emit(figures.data_overview(train.timepoints, g_all, c_all, t_all),
             outdir, "data_overview.png")

        from conditional_ude_tpu.data.ohashi import load_clamp_insulin

        try:
            tp_c, ins, types_c = load_clamp_insulin(
                args.data_dir / "ohashi_csv")
        except FileNotFoundError as e:
            skip("illustration_clamp_insulin.png", str(e))
        else:
            emit(figures.clamp_insulin_illustration(tp_c, ins, types_c),
                 outdir, "illustration_clamp_insulin.png")

        # per-type age distributions + Mann-Whitney tests (the reference's
        # supplementary age panel; tests at ``00-prepare-data.jl:34-36``)
        from conditional_ude_tpu.utils.stats import mann_whitney_u

        a_all = np.concatenate([train.ages, test.ages])
        pvals = {}
        for a, b in (("NGT", "IGT"), ("NGT", "T2DM"), ("IGT", "T2DM")):
            xa, xb = a_all[t_all == a], a_all[t_all == b]
            if xa.size and xb.size:
                pvals[(a, b)] = mann_whitney_u(xa, xb)
        emit(figures.age_distributions(a_all, t_all, pvals),
             outdir, "supp_age.png")

    # ------------------------------------------------------------------ cude
    cude_path = art / "cude_neural_parameters.npz"
    nn_best = b_train = b_test = None
    if want("cude") and cude_path.exists():
        net = chain(4, 2, "tanh", input_dims=2)
        model = CPeptideModel(kind="conditional", net=net)
        z = np.load(cude_path)
        candidates, betas_cand = z["nn_params"], z["betas"]
        # selection order: cude_fit metadata (written WITH the canonical
        # fits, so always consistent with them) → exp02 metrics → the
        # training-objective argmin (approximation of last resort; exp02's
        # real criterion is validation-based select_best)
        best = None
        try:
            from conditional_ude_tpu.utils.checkpoint import load_checkpoint

            _, fit_meta = load_checkpoint(art / "cude_fit.npz")
            best = fit_meta.get("best_model_index")
        except Exception:
            pass
        if best is None:
            try:
                import json

                best = json.loads(
                    (args.results / "exp02_metrics.json").read_text()
                )["best_model_index"]
            except Exception:
                best = int(np.argmin(z["objectives"]))
        best = min(int(best), candidates.shape[0] - 1)
        nn_best = jnp.asarray(candidates[best])
        betas_best = betas_cand[best].ravel()
        lb = betas_best.min() - 0.1 * abs(betas_best.min())
        ub = betas_best.max() + 0.1 * abs(betas_best.max())

        # prefer the canonical (β, σ) fits persisted by exp02 over
        # re-fitting here (identical settings, no duplicated compute)
        fit_path = art / "cude_fit.npz"
        saved_prof = None
        if fit_path.exists():
            zf = np.load(fit_path)
            b_train, s_train = zf["beta_train"], zf["sigma_train"]
            b_test, s_test = zf["beta_test"], zf["sigma_test"]
            if "profile_values" in zf and len(b_test) == cohort_test.n:
                saved_prof = (zf["profile_grid"], zf["profile_values"])
        if (b_train is None or len(b_train) != cohort_train.n
                or len(b_test) != cohort_test.n):
            from conditional_ude_tpu.fit.train import fit_betas_sigma

            def reestimate(c):
                return fit_betas_sigma(model, nn_best, c, initial_beta=-1.0,
                                       bounds=(float(lb), float(ub)),
                                       lbfgs_iters=re_iters)

            b_train, s_train, _ = map(np.asarray, reestimate(cohort_train))
            b_test, s_test, _ = map(np.asarray, reestimate(cohort_test))
            saved_prof = None

        def dense_sims(cohort, b):
            res = simulate_cohort(model, nn_best, jnp.asarray(b)[:, None],
                                  cohort, saveat=jnp.asarray(dense_t),
                                  solver="rk4", substeps=4)
            return np.asarray(res.ys[:, :, 0])

        sims_train, sims_test = dense_sims(cohort_train, b_train), \
            dense_sims(cohort_test, b_test)
        err_train = np.mean((np.asarray(simulate_cohort(
            model, nn_best, jnp.asarray(b_train)[:, None],
            cohort_train).ys[:, :, 0]) - train.cpeptide) ** 2, axis=1)
        err_test = np.mean((np.asarray(simulate_cohort(
            model, nn_best, jnp.asarray(b_test)[:, None],
            cohort_test).ys[:, :, 0]) - test.cpeptide) ** 2, axis=1)

        emit(figures.model_fit_panels(
            train.timepoints, train.cpeptide, sims_train, train.types,
            indices=median_index_per_type(train.types, err_train),
            dense_t=dense_t), outdir, "model_fit_train_median.png")

        idx_med_test = median_index_per_type(test.types, err_test)
        emit(figures.model_fit_panels(
            test.timepoints, test.cpeptide, sims_test, test.types,
            indices=idx_med_test, dense_t=dense_t,
            ci_simulations=ci_bound_sims(model, nn_best, b_test, s_test,
                                         cohort_test, idx_med_test)),
            outdir, "model_fit_test_median.png")
        emit(figures.fit_grid(test.timepoints, test.cpeptide, dense_t,
                              sims_test, test.types),
             outdir, "model_fit_test_all.png")
        emit(figures.error_violins(err_test, test.types, ylabel="test MSE"),
             outdir, "model_fit_error.png")

        b_all = np.concatenate([b_train, b_test])
        types_all = np.concatenate([train.types, test.types])
        emit(figures.beta_distribution(b_all, types_all),
             outdir, "beta_distribution.png")

        fp_all = np.concatenate([train.first_phase, test.first_phase])
        emit(figures.correlation_scatter(
            np.exp(b_all), fp_all, types_all, xlabel="exp(β)",
            ylabel="First-phase clamp",
            rho=spearman(np.exp(b_all), fp_all)),
            outdir, "correlation.png")
        for name, vals in [
            ("age", np.concatenate([train.ages, test.ages])),
            ("insulin_sensitivity", np.concatenate(
                [train.insulin_sensitivity, test.insulin_sensitivity])),
            ("second_phase", np.concatenate(
                [train.second_phase, test.second_phase])),
            ("disposition_index", np.concatenate(
                [train.disposition_indices, test.disposition_indices])),
        ]:
            emit(figures.correlation_scatter(
                np.exp(b_all), vals, types_all, xlabel="exp(β)",
                ylabel=name.replace("_", " "),
                rho=spearman(np.exp(b_all), vals)),
                outdir, f"correlation_sup_{name}.png")

        # dose-response sweep over β quantiles (figure_1/dose_response)
        beta_grid = np.quantile(b_train, np.linspace(0.05, 0.95, 20))
        dg_grid = np.linspace(0.0, np.ptp(train.glucose, axis=1).max(),
                              100).astype(np.float32)

        def prod_curve(beta):
            x1 = jnp.stack([dg_grid, jnp.full_like(dg_grid, np.exp(beta))])
            x0 = jnp.stack([jnp.zeros_like(dg_grid),
                            jnp.full_like(dg_grid, np.exp(beta))])
            return (jax.vmap(net.scalar, (None, 1))(nn_best, x1)
                    - jax.vmap(net.scalar, (None, 1))(nn_best, x0))

        nn_curves = np.asarray([prod_curve(float(b)) for b in beta_grid])
        emit(figures.dose_response(dg_grid, nn_curves, beta_grid),
             outdir, "dose_response.png")

        # likelihood-profile curves (supplementary/likelihood_curves) —
        # from exp02's canonical 10k-step scan when available
        from conditional_ude_tpu.analysis import THRESHOLDS

        # prefer exp02's train+test Δβ census profiles (the reference's
        # likelihood_curves figure IS the Δβ scan, 02-conditional.jl:360-424)
        if fit_path.exists():
            zf2 = np.load(fit_path)
            if "delta_values" in zf2.files and \
                    zf2["delta_values"].shape[0] == (cohort_train.n
                                                     + cohort_test.n):
                saved_prof = (zf2["delta_grid"], zf2["delta_values"])
        if saved_prof is not None:
            p_grid, p_values = saved_prof
        else:
            prof = cohort_beta_profiles(model, nn_best, cohort_test,
                                        sigmas=jnp.asarray(s_test),
                                        lower=float(lb) - 1.0,
                                        upper=float(ub) + 1.0,
                                        steps=prof_steps)
            p_grid, p_values = np.asarray(prof.grid), np.asarray(prof.values)
        lk_types = (np.concatenate([train.types, test.types])
                    if p_values.shape[0] == cohort_train.n + cohort_test.n
                    else test.types)
        emit(figures.likelihood_curves(p_grid, p_values,
                                       THRESHOLDS["cantelli95"],
                                       types=lk_types),
             outdir, "likelihood_curves.png")

        # per-candidate β grids (supplementary/other_betas) — training β's
        # of every restart vs the fit-split first-phase index (the split
        # indices are read from the artifact when present so a seed change
        # cannot silently misalign β's and subjects)
        if "idx_fit" in z:
            idx_fit = np.asarray(z["idx_fit"])
        else:
            rng = np.random.default_rng(args.seed)
            idx_fit, _ = stratified_split(rng, train.types, 0.7)
        bc = betas_cand[..., 0] if betas_cand.ndim == 3 else betas_cand
        if bc.shape[-1] == len(idx_fit):
            emit(figures.candidate_beta_grid(bc, train.first_phase[idx_fit]),
                 outdir, "other_betas.png")
        else:
            skip("other_betas.png", "candidate β count != fit-split size")

        # second-best-candidate β correlation (figure_s8,
        # ``02-conditional.jl:665-711``): refit train+test β's under the
        # runner-up NN and scatter them against the selected model's β's.
        # Candidate ranking uses the artifact's training objectives (the
        # reference hand-picks index 8 of its cached run at :665).
        if candidates.shape[0] > 1:
            from conditional_ude_tpu.fit.train import fit_betas

            order2 = np.argsort(np.asarray(z["objectives"]))
            second = int(order2[1]) if int(order2[0]) == best \
                else int(order2[0])
            nn_second = jnp.asarray(candidates[second])
            b2_vec = betas_cand[second].ravel()
            lb2 = b2_vec.min() - 0.1 * abs(b2_vec.min())
            ub2 = b2_vec.max() + 0.1 * abs(b2_vec.max())

            def refit2(c):
                b, _ = fit_betas(model, nn_second, c, initial_beta=-1.0,
                                 bounds=(float(lb2), float(ub2)),
                                 lbfgs_iters=re_iters)
                return np.asarray(b)

            b2_all = np.concatenate([refit2(cohort_train),
                                     refit2(cohort_test)])
            rho2 = spearman(b2_all, b_all)
            emit(figures.scatter_compare(
                np.exp(b2_all), np.exp(b_all), "exp(β) model 2",
                "exp(β) model 1", identity=False),
                outdir, "second_best_correlation.png")
            emit(figures.correlation_scatter(
                np.exp(b2_all), np.exp(b_all), types_all,
                xlabel="exp(β) model 2", ylabel="exp(β) model 1",
                rho=rho2), outdir, "second_best_correlation_comparison.png")
        else:
            skip("second_best_correlation.png", "single-candidate artifact")

        # cUDE-vs-UDE comparison of the per-type test means
        # (figure_sx/comparison, ``02-conditional.jl:716-795``)
        ude_p = art / "ude_neural_parameters.npz"
        if ude_p.exists():
            from conditional_ude_tpu.fit.train import fit_betas

            ude_net_c = chain(4, 2, "tanh", input_dims=1)
            ude_model_c = CPeptideModel(kind="ude", net=ude_net_c)
            nn_ude = jnp.asarray(np.load(ude_p)["nn_params"][0])
            type_names = [t for t in ("NGT", "IGT", "T2DM")
                          if (test.types == t).any()]
            sel_t = [test.types == t for t in type_names]
            mean_g = np.stack([test.glucose[s].mean(axis=0) for s in sel_t])
            mean_c = np.stack([test.cpeptide[s].mean(axis=0) for s in sel_t])
            ste_c = np.stack([test.cpeptide[s].std(axis=0)
                              / np.sqrt(s.sum()) for s in sel_t])
            mean_age = np.array([test.ages[s].mean() for s in sel_t])
            mean_cohort = build_cohort(
                mean_g, test.timepoints, mean_c, mean_age,
                np.array([t == "T2DM" for t in type_names]))
            b_mean, _ = map(np.asarray, fit_betas(
                model, nn_best, mean_cohort, initial_beta=-1.0,
                bounds=(float(lb), float(ub)), lbfgs_iters=re_iters))
            sims_cu = np.asarray(simulate_cohort(
                model, nn_best, jnp.asarray(b_mean)[:, None], mean_cohort,
                saveat=jnp.asarray(dense_t), solver="rk4",
                substeps=4).ys[:, :, 0])
            sims_ud = np.asarray(simulate_cohort(
                ude_model_c, nn_ude,
                jnp.zeros((len(type_names), 0), jnp.float32), mean_cohort,
                saveat=jnp.asarray(dense_t), solver="rk4",
                substeps=4).ys[:, :, 0])
            emit(figures.comparison_panels(
                dense_t, sims_cu, sims_ud, test.timepoints, mean_c, ste_c,
                type_names), outdir, "comparison.png")
        else:
            skip("comparison.png", "ude artifact missing")

        # exp02 renders sampled_simulations.png into the same gallery dir
        # (02-conditional.jl:592-658) — register it in the manifest
        if (outdir / "sampled_simulations.png").exists():
            RENDERED.append("sampled_simulations.png")
        else:
            skip("sampled_simulations.png", "rendered by exp02; run it first")
    elif want("cude"):
        skip("cude section", f"{cude_path} missing")

    # ------------------------------------------------------------- covariate
    cov_fit = art / "cude_covariate_fit.npz"
    cov_art = art / "cude_covariate_neural_parameters.npz"
    if want("covariate") and cov_fit.exists() and cov_art.exists():
        zc = np.load(cov_fit)
        bc_train, bc_test = zc["beta_train"], zc["beta_test"]
        if len(bc_train) == cohort_train.n and len(bc_test) == cohort_test.n:
            bc_all = np.concatenate([bc_train, bc_test])
            types_all = np.concatenate([train.types, test.types])
            fp_all = np.concatenate([train.first_phase, test.first_phase])
            emit(figures.correlation_scatter(
                np.exp(bc_all), fp_all, types_all, xlabel="exp(β) (covariate)",
                ylabel="First-phase clamp",
                rho=spearman(np.exp(bc_all), fp_all)),
                outdir, "covariate_correlation.png")

            from conditional_ude_tpu.utils.checkpoint import load_checkpoint

            _, meta = load_checkpoint(cov_fit)
            best_c = int(meta.get("best_model_index", 0))
            zca = np.load(cov_art)
            best_c = min(best_c, zca["nn_params"].shape[0] - 1)
            cov_net = chain(4, 2, "tanh", input_dims=3)
            cov_model = CPeptideModel(kind="conditional_covariate",
                                      net=cov_net)
            nn_cov = jnp.asarray(zca["nn_params"][best_c])
            sims_c = np.asarray(simulate_cohort(
                cov_model, nn_cov, jnp.asarray(bc_test)[:, None],
                cohort_test, saveat=jnp.asarray(dense_t),
                solver="rk4", substeps=4).ys[:, :, 0])
            err_c = np.asarray(zc["sse_test"]) / len(test.timepoints)
            emit(figures.model_fit_panels(
                test.timepoints, test.cpeptide, sims_c, test.types,
                indices=median_index_per_type(test.types, err_c),
                dense_t=dense_t), outdir,
                "model_fit_test_covariate_median.png")

            # supplementary covariate panel: same median fits with raue95
            # profile-CI trajectories (``07-covariate-inclusion.jl:160-167``
            # uses the :raue95 threshold for the covariate model)
            sc_test = zc["sigma_test"] if "sigma_test" in zc.files else \
                np.ones_like(bc_test)
            idx_med_c = median_index_per_type(test.types, err_c)
            emit(figures.model_fit_panels(
                test.timepoints, test.cpeptide, sims_c, test.types,
                indices=idx_med_c, dense_t=dense_t,
                ci_simulations=ci_bound_sims(
                    cov_model, nn_cov, bc_test, sc_test, cohort_test,
                    idx_med_c, method="raue95")),
                outdir, "supplementary_covariate.png")

            # covariate-β vs the remaining clamp indices
            # (``07-covariate-inclusion.jl:378-451`` correlations_other_cude)
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            others = [
                ("age", np.concatenate([train.ages, test.ages])),
                ("insulin sensitivity", np.concatenate(
                    [train.insulin_sensitivity, test.insulin_sensitivity])),
                ("disposition index", np.concatenate(
                    [train.disposition_indices, test.disposition_indices])),
            ]
            figc, axesc = plt.subplots(1, 3, figsize=(8.4, 2.8))
            for ax, (name, vals) in zip(axesc, others):
                for t in ("NGT", "IGT", "T2DM"):
                    sel = types_all == t
                    if sel.any():
                        ax.scatter(np.exp(bc_all[sel]), vals[sel], s=14,
                                   color=figures.COLORS[t],
                                   marker=figures.MARKERS[t], label=t)
                ax.set_xlabel("exp(β) (covariate)")
                ax.set_ylabel(name)
                ax.set_title(f"ρ = {spearman(np.exp(bc_all), vals):.2f}",
                             fontsize=9)
            axesc[0].legend(fontsize=7)
            figc.tight_layout()
            emit(figc, outdir, "correlations_other_cude.png")
        else:
            skip("covariate section", "fit sizes do not match the cohorts")
    elif want("covariate"):
        skip("covariate section", f"{cov_fit} missing (rerun exp07)")

    # ------------------------------------------------------------------- ude
    ude_path = art / "ude_neural_parameters.npz"
    if want("ude") and ude_path.exists():
        ude_net = chain(4, 2, "tanh", input_dims=1)
        ude_model = CPeptideModel(kind="ude", net=ude_net)
        ude_nn = jnp.asarray(np.load(ude_path)["nn_params"][0])
        res = simulate_cohort(ude_model, ude_nn,
                              jnp.zeros((cohort_test.n, 0), jnp.float32),
                              cohort_test, saveat=jnp.asarray(dense_t),
                              solver="rk4", substeps=4)
        sims = np.asarray(res.ys[:, :, 0])
        emit(figures.fit_grid(test.timepoints, test.cpeptide, dense_t, sims,
                              test.types),
             outdir, "model_fit_ude_test.png")
        ngt = np.flatnonzero(test.types == "NGT")
        if ngt.size:
            emit(figures.fit_grid(test.timepoints, test.cpeptide[ngt],
                                  dense_t, sims[ngt], test.types[ngt],
                                  ncols=min(6, ngt.size)),
                 outdir, "model_fit_ude_test_ngt.png")
    elif want("ude"):
        skip("ude section", f"{ude_path} missing")

    # -------------------------------------------------------------- symbolic
    if want("symbolic"):
        from conditional_ude_tpu.models.symbolic import (
            beta_to_k,
            fit_k_sigma,
            symbolic_model,
            symbolic_production,
        )

        sym = symbolic_model()

        # NN-vs-symbolic dose-response overlay
        if nn_best is not None:
            beta_grid = np.quantile(b_train, [0.1, 0.5, 0.9])
            dg_grid = np.linspace(0.0, np.ptp(train.glucose, axis=1).max(),
                                  100).astype(np.float32)
            nn_curves = np.asarray([prod_curve(float(b)) for b in beta_grid])
            sym_curves = np.asarray([
                symbolic_production(jnp.asarray(dg_grid),
                                    beta_to_k(jnp.exp(jnp.asarray(b))))
                for b in beta_grid])
            emit(figures.dose_response_compare(dg_grid, nn_curves,
                                               sym_curves, beta_grid),
                 outdir, "dose_response_neural_symbolic.png")

        # internal symbolic fits: per-subject k on the combined cohort
        g_all = np.concatenate([train.glucose, test.glucose])
        c_all = np.concatenate([train.cpeptide, test.cpeptide])
        a_all = np.concatenate([train.ages, test.ages])
        t2_all = np.concatenate([train.t2dm, test.t2dm])
        types_all = np.concatenate([train.types, test.types])
        cohort_all = build_cohort(g_all, train.timepoints, c_all, a_all,
                                  t2_all)
        from conditional_ude_tpu.models.cpeptide import simulate

        sym_fit = art / "symreg_fit.npz"
        zs = np.load(sym_fit) if sym_fit.exists() else None
        if zs is not None and zs["ks"].shape[0] == len(t2_all):
            ks = zs["ks"]
        else:
            ks, _, _ = map(np.asarray, fit_k_sigma(
                cohort_all, lbfgs_iters=re_iters))

        def sym_sims(saveat):
            def one(k, ind):
                return simulate(sym, {"k": k}, ind,
                                jnp.asarray(saveat, jnp.float32),
                                solver="rk4", substeps=4).ys[:, 0]

            return np.asarray(jax.vmap(one)(jnp.asarray(ks, jnp.float32),
                                            cohort_all.individuals))

        sims = sym_sims(dense_t)
        err = np.mean((sym_sims(train.timepoints) - c_all) ** 2, axis=1)
        emit(figures.model_fit_panels(
            train.timepoints, c_all, sims, types_all,
            indices=median_index_per_type(types_all, err), dense_t=dense_t),
            outdir, "symbolic_regression_internal.png")
        fp_all = np.concatenate([train.first_phase, test.first_phase])
        emit(figures.correlation_scatter(
            ks, fp_all, types_all, xlabel="k", ylabel="First-phase clamp",
            rho=spearman(ks, fp_all)),
            outdir, "symbolic_correlation.png")

        # Pareto front of the GP symbolic-regression search
        front_csv = args.results / "symbolic_regression_result.csv"
        if front_csv.exists():
            with front_csv.open() as f:
                rows = list(csv.DictReader(f))
            emit(figures.pareto_front([int(r["complexity"]) for r in rows],
                                      [float(r["loss"]) for r in rows]),
                 outdir, "symbolic_regression_pareto.png")
        else:
            skip("symbolic_regression_pareto.png", f"{front_csv} missing")

        # the IN-REPO discovered equation: dose-response vs the NN, and
        # its per-subject gate b against the first-phase clamp index
        # (exp_symreg_production; no reference analog — the reference's
        # equation comes from an external PySR run)
        from conditional_ude_tpu.models.symbolic import discovered_production

        if nn_best is not None:
            disc_curves = np.asarray([
                discovered_production(jnp.asarray(dg_grid),
                                      jnp.exp(jnp.asarray(b)))
                for b in beta_grid])
            emit(figures.dose_response_compare(dg_grid, nn_curves,
                                               disc_curves, beta_grid),
                 outdir, "dose_response_neural_discovered.png")
        disc_fit = art / "discovered_fit.npz"
        if disc_fit.exists():
            zb = np.load(disc_fit)
            if zb["bs"].shape[0] == len(t2_all):
                emit(figures.correlation_scatter(
                    zb["bs"], fp_all, types_all, xlabel="b (discovered)",
                    ylabel="First-phase clamp",
                    rho=spearman(zb["bs"], fp_all)),
                    outdir, "discovered_correlation.png")
            else:
                skip("discovered_correlation.png",
                     f"artifact has {zb['bs'].shape[0]} subjects, "
                     f"cohort has {len(t2_all)} (stale/smoke artifact)")
        else:
            skip("discovered_correlation.png", f"{disc_fit} missing")

    # -------------------------------------------------------------- external
    if want("external"):
        from conditional_ude_tpu.models.symbolic import (
            fit_k_sigma,
            symbolic_model,
        )

        fuj = load_fujita_cohort()
        cohort_f = build_cohort(fuj.glucose, fuj.timepoints, fuj.cpeptide,
                                fuj.ages, np.zeros(len(fuj.ages), bool))
        from conditional_ude_tpu.models.cpeptide import simulate

        ext_fit = art / "symreg_external_fit.npz"
        ze = np.load(ext_fit) if ext_fit.exists() else None
        if ze is not None and ze["ks"].shape[0] == len(fuj.ages):
            ks_f = ze["ks"]
        else:
            ks_f, _, _ = map(np.asarray, fit_k_sigma(cohort_f,
                                                     lbfgs_iters=re_iters))
        dense_f = np.arange(fuj.timepoints[0], fuj.timepoints[-1] + 0.1,
                            2.0).astype(np.float32)
        sym = symbolic_model()

        def one(k, ind):
            return simulate(sym, {"k": k}, ind,
                            jnp.asarray(dense_f, jnp.float32),
                            solver="rk4", substeps=4).ys[:, 0]

        sims_f = np.asarray(jax.vmap(one)(jnp.asarray(ks_f, jnp.float32),
                                          cohort_f.individuals))
        emit(figures.quantile_fit_band(dense_f, sims_f,
                                       fuj.timepoints, fuj.cpeptide,
                                       title="Fujita external cohort"),
             outdir, "model_fit_external.png")

    # -------------------------------------------------------------- ablation
    abl_csv = args.results / "exp05_ablation.csv"
    if want("ablation") and abl_csv.exists():
        with abl_csv.open() as f:
            rows = list(csv.DictReader(f))
        # multi-seed CSVs carry several rows per fraction: draw the
        # across-seed median with an IQR band (single-seed CSVs reduce to
        # the plain curve, the band collapsing onto it)
        by_frac = {}
        for r in rows:
            by_frac.setdefault(float(r["fraction"]), []).append(
                float(r["test_sse_median"]))
        fracs = sorted(by_frac)
        med = [float(np.median(by_frac[f])) for f in fracs]
        lo = [float(np.percentile(by_frac[f], 25)) for f in fracs]
        hi = [float(np.percentile(by_frac[f], 75)) for f in fracs]
        emit(figures.ablation_curve(fracs, med, band=(lo, hi)),
             outdir, "performance_less_data.png")
    elif want("ablation"):
        skip("performance_less_data.png", f"{abl_csv} missing")

    # ----------------------------------------------------------- suppression
    sup_path = art / "suppression_lambda=0.1.npz"
    if want("suppression") and sup_path.exists():
        from conditional_ude_tpu.models.suppression import (
            generate_data,
            simulate_population,
            suppression_net,
        )

        from conditional_ude_tpu.utils.checkpoint import load_checkpoint

        z, sup_meta = load_checkpoint(sup_path)
        best_r = int(np.argmin(z["objectives"]))
        nn_sup = jnp.asarray(z["nn_params"][best_r])
        thetas = np.asarray(z["thetas"][best_r])
        gt = np.asarray(z["gt_train"])
        # regenerate the training data with the sweep's seed chain and its
        # RECORDED noise level (experiments/exp_suppression.py:47-57);
        # a smoke artifact (different population sizes) fails the shape
        # guard and only skips the fit figure
        rng = np.random.default_rng(27052023)
        tp = np.linspace(0.0, 30.0, 8)
        data_train, gt_regen = generate_data(
            [0.5, 2.5, 5.0, 7.5, 10.0, 12.5], [15, 3, 3, 3, 3, 10], tp,
            noise_multiplicative=float(sup_meta.get("noise", 0.1)), rng=rng)
        net_sup = suppression_net(depth=5, width=3)
        emit(figures.scatter_compare(gt, thetas, "ground-truth p₄",
                                     "fitted θ", identity=False),
             outdir, "suppression_correlation.png")
        if gt.shape == gt_regen.shape and np.allclose(gt, gt_regen):
            dense_s = np.linspace(0.0, 30.0, 61).astype(np.float32)
            u0s = jnp.asarray(data_train[:, :, 0], jnp.float32)  # [N, 3] @ t0
            ys = np.asarray(simulate_population(
                net_sup, nn_sup, jnp.asarray(thetas, jnp.float32), u0s,
                jnp.asarray(dense_s)).ys)
            idx = np.argsort(gt)[[0, len(gt) // 2, len(gt) - 1]]
            plt_types = np.asarray(["NGT"] * len(gt))
            fig = figures.model_fit_panels(
                tp, data_train[:, 2, :], ys[:, :, 2], plt_types,
                indices=idx, dense_t=dense_s)
            for ax in fig.axes:
                ax.set_ylabel("state u₃")
            emit(fig, outdir, "suppression_model_fit.png")
        else:
            skip("suppression_model_fit.png",
                 "artifact ground truth does not match regenerated data")

        # restart-selection robustness map (exp_suppression
        # --selection-sensitivity): the by-loss rule's gauge flips at
        # mid-λ vs the ρ-aware rules' stability
        sens_csv = args.results / "suppression_selection_sensitivity.csv"
        if sens_csv.exists():
            with sens_csv.open() as f:
                sens = list(csv.DictReader(f))
            lams = sorted({float(r["lambda"]) for r in sens})
            by_rule = {}
            for rule in ("valid_loss", "valid_rho", "combined_rank"):
                rho = {float(r["lambda"]): float(r["test_rho"])
                       for r in sens if r["rule"] == rule}
                by_rule[rule] = [rho.get(l, float("nan")) for l in lams]
            emit(figures.selection_sensitivity(lams, by_rule),
                 outdir, "suppression_selection_sensitivity.png")
        else:
            skip("suppression_selection_sensitivity.png",
                 f"{sens_csv} missing")
    elif want("suppression"):
        skip("suppression section", f"{sup_path} missing")

    # ------------------------------------------------------------------ saem
    saem_path = art / "saem_fit.npz"
    if want("saem") and saem_path.exists():
        z = np.load(saem_path)
        emit(figures.scatter_compare(z["beta_mle"], z["beta_map"],
                                     "MLE β", "MAP β",
                                     types=np.concatenate(
                                         [train.types, test.types])),
             outdir, "saem_map_vs_mle.png")

        # SAEM β-vs-first-phase correlation (``06-saem.jl:189-205``
        # SAEM_correation.png: exp(MAP η_i) against the clamp index)
        fp_all_s = np.concatenate([train.first_phase, test.first_phase])
        types_s = np.concatenate([train.types, test.types])
        if z["beta_map"].shape[0] == fp_all_s.shape[0]:
            emit(figures.correlation_scatter(
                np.exp(z["beta_map"]), fp_all_s, types_s,
                xlabel="exp(β) (SAEM MAP)", ylabel="First-phase clamp",
                rho=spearman(np.exp(z["beta_map"]), fp_all_s)),
                outdir, "saem_correlation.png")
        if "nll_trace" in z:
            emit(figures.loss_trace(z["nll_trace"], ylabel="population NLL"),
                 outdir, "saem_nll_trace.png")
        if "acceptance_trace" in z:
            fig = figures.loss_trace(z["acceptance_trace"],
                                     ylabel="MCMC acceptance")
            fig.axes[0].set_yscale("linear")
            emit(fig, outdir, "saem_acceptance_trace.png")

        # posterior-predictive bands for the median-MAP subject per type
        # (06-saem.jl posterior-predictive figures): simulate the subject
        # under sampled posterior β's, draw the 5-95% band + observations
        types_all = np.concatenate([train.types, test.types])
        if "beta_chains" in z and z["beta_chains"].shape[0] == len(types_all):
            g_all2 = np.concatenate([train.glucose, test.glucose])
            c_all2 = np.concatenate([train.cpeptide, test.cpeptide])
            a_all2 = np.concatenate([train.ages, test.ages])
            cohort_all2 = build_cohort(g_all2, train.timepoints, c_all2,
                                       a_all2, types_all == "T2DM")
            saem_net = chain(4, 2, "tanh", input_dims=2)
            saem_model = CPeptideModel(kind="conditional", net=saem_net)
            nn_saem = jnp.asarray(z["nn_params"])
            chains_b = z["beta_chains"]
            maps_b = z["beta_map"]

            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            from conditional_ude_tpu.models.cpeptide import simulate

            fig, axes = plt.subplots(1, 3, figsize=(7.5, 2.6), sharey=True)
            for ax, t in zip(axes, ("NGT", "IGT", "T2DM")):
                sel = np.flatnonzero(types_all == t)
                if not sel.size:
                    ax.axis("off")
                    continue
                i = int(sel[np.argsort(maps_b[sel])[len(sel) // 2]])
                ind = jax.tree.map(lambda a: a[i], cohort_all2.individuals)

                def sim_one(beta):
                    return simulate(saem_model,
                                    {"neural": nn_saem,
                                     "conditional": beta}, ind,
                                    jnp.asarray(dense_t, jnp.float32),
                                    solver="rk4", substeps=4).ys[:, 0]

                sols = np.asarray(jax.vmap(sim_one)(
                    jnp.asarray(chains_b[i], jnp.float32)))
                ax.fill_between(dense_t, np.quantile(sols, 0.05, axis=0),
                                np.quantile(sols, 0.95, axis=0),
                                color=figures.COLORS[t], alpha=0.3)
                ax.plot(dense_t, np.median(sols, axis=0),
                        color=figures.COLORS[t], lw=1.4)
                ax.scatter(train.timepoints, c_all2[i], s=14, color="k",
                           zorder=3)
                ax.set_title(t, fontsize=9)
                ax.set_xlabel("time (min)")
            axes[0].set_ylabel("C-peptide (nmol/L)")
            emit(fig, outdir, "saem_posterior_predictive.png")
    elif want("saem"):
        skip("saem section", f"{saem_path} missing (rerun exp06)")

    # ----------------------------------------------------- replication
    # beyond-parity: across-seed spread of the flagship pipeline
    # (experiments/exp02_seeds.py; no reference counterpart)
    seeds_csv = args.results / "exp02_seeds.csv"
    if want("replication") and seeds_csv.exists():
        import csv as _csv
        import json as _json

        with seeds_csv.open() as f:
            srows = list(_csv.DictReader(f))
        # gauge-align like the merge step: flip each seed to the
        # reference convention (first-phase ρ < 0)
        sgn = [-1.0 if float(r["spearman_first_phase"]) > 0 else 1.0
               for r in srows]
        canon = None
        try:
            m = _json.loads(
                (args.results / "exp02_metrics.json").read_text())
            canon_rho = {
                "β vs first-phase ρ": m["spearman"]["first_phase"],
                "β vs age ρ": m["spearman"]["age"],
                "β vs ISI ρ": m["spearman"]["insulin_sensitivity"],
            }
            canon = {"test SSE (mean)": m["test_sse_mean"]}
        except Exception:
            canon_rho = None
        emit(figures.replication_strip(
            {"β vs first-phase ρ": [s * float(r["spearman_first_phase"])
                                    for s, r in zip(sgn, srows)],
             "β vs age ρ": [s * float(r["spearman_age"])
                            for s, r in zip(sgn, srows)],
             "β vs ISI ρ": [s * float(r["spearman_isi"])
                            for s, r in zip(sgn, srows)]},
            canonical=canon_rho, xlabel="Spearman ρ (gauge-aligned)",
            xlim=(-1, 1), refline=0.0),
            outdir, "replication_spearman.png")
        emit(figures.replication_strip(
            {"test SSE (mean)": [float(r["test_sse_mean"]) for r in srows],
             "test SSE (median)": [float(r["test_sse_median"])
                                   for r in srows]},
            canonical=canon, xlabel="held-out error"),
            outdir, "replication_sse.png")
    elif want("replication"):
        skip("replication section", f"{seeds_csv} missing (run exp02_seeds)")

    # merge with any previous manifest so partial --sections runs add to
    # the gallery record instead of replacing it
    manifest_path = args.results / "exp_figures_manifest.json"
    rendered = set(RENDERED)
    try:
        import json

        prev = json.loads(manifest_path.read_text())["rendered"]
        rendered |= {f for f in prev if (outdir / f).exists()}
    except Exception:
        pass
    rendered = sorted(rendered)
    write_metrics(manifest_path,
                  {"rendered": rendered, "count": len(rendered)})


if __name__ == "__main__":
    main()

"""Suppression-model simulated cUDE example with λ-regularization sweep
(reference ``suppression/suppression.jl``).

Generates synthetic populations from the known 3-state suppression ODE
(group means p4 ∈ {0.5, 2.5, 5, 7.5, 10, 12.5}), jointly fits NN + per-
individual θ for each λ ∈ {0, 1e-3, 1e-2, 0.1, 1}, re-fits θ on noisy and
noise-free validation populations with the NN frozen, and records Spearman
correlations between θ̂ and the ground-truth p4 per restart — the method's
synthetic-recovery benchmark.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np

from common import configure_backend,  Timer, make_parser, write_csv, write_metrics


def fine_lambdas():
    """The reference's init_run fine λ grid plus the test_run extremes
    (13 points; suppression/results/{init_run,test_run}/ — log-spaced
    values rounded so 10^-1.0 lands exactly on the main sweep's 0.1,
    and the test_run tail λ ∈ {10, 100, 1000})."""
    return sorted({0.0, 0.01, 1.0, 10.0, 100.0, 1000.0}
                  | {round(float(10.0 ** e), 12)
                     for e in np.linspace(-1.8, -0.6, 7)})


def merge_fine_outputs(args):
    """Merge per-λ partial outputs into the ``_fine`` sweep CSV + metrics.

    The fine sweep can run as one ``--lambdas <v> --no-test-stage``
    process per λ, each writing ``_<λ>``-tagged partials, merged here.
    The test stage is shared with the main sweep (same
    λ=0.01 artifact), so it is copied from the main metrics when present.
    """
    import csv
    import json

    rows, summary = [], {}
    missing = []
    for lam in fine_lambdas():
        mpath = args.results / f"exp_suppression_metrics_{lam}.json"
        cpath = args.results / f"suppression_sweep_{lam}.csv"
        if not (mpath.exists() and cpath.exists()):
            missing.append(lam)
            continue
        part = json.loads(mpath.read_text())
        summary[str(lam)] = part[str(lam)]
        with cpath.open() as f:
            for r in csv.DictReader(f):
                rows.append({k: float(v) if k != "restart" else int(v)
                             for k, v in r.items()})
    if missing:
        sys.exit(f"--merge-fine: missing per-λ partials for {missing}; "
                 f"run `--lambdas <λ> --no-test-stage` for each first")

    main_metrics = args.results / "exp_suppression_metrics.json"
    if main_metrics.exists():
        test_stage = json.loads(main_metrics.read_text()).get("test_stage")
        if test_stage is not None:
            summary["test_stage"] = test_stage

    rows.sort(key=lambda r: (r["lambda"], r["restart"]))
    write_csv(args.results / "suppression_sweep_fine.csv", rows)
    write_metrics(args.results / "exp_suppression_metrics_fine.json",
                  summary)


def main():
    p = make_parser(__doc__)
    p.add_argument("--noise", type=float, default=0.1)
    p.add_argument("--lambdas", type=float, nargs="*", default=None,
                   help="subset of regularization levels")
    p.add_argument("--no-test-stage", action="store_true")
    p.add_argument("--test-only", action="store_true",
                   help="skip the λ sweep; revalidate the cached test-λ "
                        "artifact and run only the 60-subject test stage")
    p.add_argument("--joint", action="store_true",
                   help="run the whole λ sweep as one batched program "
                        "(λ × restart lanes; shared screening pass)")
    p.add_argument("--fine", action="store_true",
                   help="the reference's init_run fine λ grid: "
                        "{0, 0.01} ∪ 10^[-1.8:0.2:-0.6] ∪ {1, 10, 100} "
                        "(suppression/results/init_run/, 12 points)")
    p.add_argument("--merge-fine", action="store_true",
                   help="no fitting: merge the per-λ partial outputs of "
                        "the fine grid (written by one-λ-per-process runs) "
                        "into the _fine sweep CSV and metrics")
    p.add_argument("--selection-sensitivity", action="store_true",
                   help="no sweep: map the restart-selection-rule × λ "
                        "interaction over the committed fine-grid artifacts "
                        "— for each λ, select a restart by validation loss "
                        "/ validation ρ / combined rank and report the "
                        "60-subject test-stage ρ for each rule")
    args = p.parse_args()

    if args.merge_fine:
        # no backend needed; mirror configure_backend's smoke path split
        if args.smoke:
            args.results = args.results / "smoke"
        return merge_fine_outputs(args)

    configure_backend(args)

    import jax
    import jax.numpy as jnp

    from conditional_ude_tpu.models.suppression import (
        SuppressionFitConfig,
        fit_suppression,
        generate_data,
        suppression_net,
        validate_suppression,
    )
    from conditional_ude_tpu.utils.checkpoint import save_checkpoint
    from conditional_ude_tpu.utils.stats import spearman

    rng = np.random.default_rng(27052023)
    tp = np.linspace(0.0, 30.0, 8)
    group_means = [0.5, 2.5, 5.0, 7.5, 10.0, 12.5]
    train_sizes = [15, 3, 3, 3, 3, 10]
    valid_sizes = [2, 2, 2, 2, 2, 2] if args.smoke else [5, 5, 5, 5, 5, 5]
    if args.smoke:
        train_sizes = [3, 1, 1, 1, 1, 2]

    data_train, gt_train = generate_data(group_means, train_sizes, tp,
                                         noise_multiplicative=args.noise,
                                         rng=rng)
    data_valid, gt_valid = generate_data(group_means, valid_sizes, tp,
                                         noise_multiplicative=args.noise,
                                         rng=rng)
    data_nonoise, gt_nonoise = generate_data(group_means, valid_sizes, tp,
                                             noise_multiplicative=0.0,
                                             rng=rng)

    net = suppression_net(depth=5, width=3)
    lambdas = [0.0, 0.1] if args.smoke else [0.0, 0.001, 0.01, 0.1, 1.0]
    if args.fine:
        lambdas = fine_lambdas()
    if args.lambdas is not None:
        lambdas = list(args.lambdas)
    cfg = SuppressionFitConfig(initial_space=50, select_best_n=3,
                               adam_iters=30, lbfgs_iters=30) \
        if args.smoke else SuppressionFitConfig()

    # the reference screens the SAME 10k-size init pool for validation
    # refits as for training (suppression.jl:37 — initial_space candidates)
    n_valid_inits = 50 if args.smoke else 10_000
    theta_inits_valid = jnp.asarray(
        rng.uniform(size=(n_valid_inits, data_valid.shape[0])), jnp.float32)

    rows, summary = [], {}
    if args.test_only or args.selection_sensitivity:
        lambdas = []
        try:
            summary = __import__("json").loads(
                (args.results / "exp_suppression_metrics.json").read_text())
        except FileNotFoundError:
            pass
    joint_fits = None
    if args.joint and lambdas:
        # the whole λ-sweep as ONE batched program (the λ axis is a batch
        # axis; screening runs once and factors λ analytically)
        from conditional_ude_tpu.models.suppression import (
            SuppressionFit,
            fit_suppression_sweep,
        )

        with Timer():
            sweep = fit_suppression_sweep(net, data_train, tp,
                                          jax.random.key(args.seed),
                                          lambdas, config=cfg)
        joint_fits = {
            lam: SuppressionFit(*(jnp.asarray(a[i]) for a in sweep))
            for i, lam in enumerate(lambdas)
        }

    for lam in lambdas:
        if joint_fits is not None:
            fit = joint_fits[lam]
        else:
            with Timer():
                fit = fit_suppression(net, data_train, tp,
                                      jax.random.key(args.seed), lam=lam,
                                      config=cfg)

        # validate the whole restart population at once (batched over the
        # leading axis; the reference loops restarts serially)
        theta_v, obj_v = validate_suppression(
            net, fit.nn_params, data_valid, tp, theta_inits_valid,
            lbfgs_iters=cfg.lbfgs_iters)
        theta_nn, obj_nn = validate_suppression(
            net, fit.nn_params, data_nonoise, tp, theta_inits_valid,
            lbfgs_iters=cfg.lbfgs_iters)
        for r in range(cfg.select_best_n):
            rows.append({
                "lambda": lam, "restart": r,
                "correlation_train": spearman(gt_train, fit.thetas[r]),
                "loss_train": float(fit.objectives[r]),
                "correlation_valid": spearman(gt_valid, theta_v[r]),
                "loss_valid": float(obj_v[r]),
                "correlation_valid_nonoise": spearman(gt_nonoise,
                                                      theta_nn[r]),
                "loss_valid_nonoise": float(obj_nn[r]),
            })
            print(rows[-1], file=sys.stderr)

        save_checkpoint(args.artifacts / f"suppression_lambda={lam}.npz", {
            "nn_params": fit.nn_params, "thetas": fit.thetas,
            "objectives": fit.objectives, "gt_train": gt_train,
        }, metadata={"lambda": lam, "noise": args.noise})
        lam_rows = [r for r in rows if r["lambda"] == lam]
        summary[str(lam)] = {
            "best_correlation_train": max(r["correlation_train"]
                                          for r in lam_rows),
            "best_correlation_valid": max(r["correlation_valid"]
                                          for r in lam_rows),
        }

    # per-λ partial outputs so a λ-subset process contributes incrementally
    tag = ("_fine" if args.fine else
           "" if args.lambdas is None
           else "_" + "_".join(str(l) for l in lambdas))
    write_csv(args.results / f"suppression_sweep{tag}.csv", rows)
    if args.no_test_stage:
        write_metrics(args.results / f"exp_suppression_metrics{tag}.json",
                      summary)
        return

    # -- test stage (reference suppression/figures.jl:27-97): pick the best
    # λ=0.01 restart by validation loss, fit fresh test subjects with the
    # per-individual (θ, σ) estimator, report θ-recovery correlation --------
    from conditional_ude_tpu.models.suppression import (
        validate_suppression_sigma_batch,
    )
    from conditional_ude_tpu.utils.checkpoint import load_checkpoint

    test_lambda = 0.1 if args.smoke else 0.01
    if lambdas and test_lambda not in lambdas:
        test_lambda = lambdas[-1]
    ck, _ = load_checkpoint(
        args.artifacts / f"suppression_lambda={test_lambda}.npz")
    lam_rows = [r for r in rows if r["lambda"] == test_lambda]
    if not lam_rows and not args.selection_sensitivity:
        # --test-only: reconstruct the selection quantities by revalidating
        # the cached restart population (deterministic given the artifact)
        theta_v, obj_v = validate_suppression(
            net, jnp.asarray(ck["nn_params"]), data_valid, tp,
            theta_inits_valid, lbfgs_iters=cfg.lbfgs_iters)
        lam_rows = [{"loss_valid": float(obj_v[r]),
                     "correlation_valid": spearman(gt_valid, theta_v[r])}
                    for r in range(len(obj_v))]
    # the reference selects the restart with the best VALIDATION LOSS
    # (suppression/figures.jl:27-41); that criterion can pick a restart
    # whose θ-ordering is worse than its fit (loss and Spearman ρ are not
    # monotonically related), so the best-validation-ρ restart is reported
    # alongside as a robustness line.  (In --selection-sensitivity mode
    # lam_rows is empty — per-restart stats come from the fine-grid CSV
    # inside that branch instead.)
    if lam_rows:
        best_r = int(np.argmin([r["loss_valid"] for r in lam_rows]))
        best_r_rho = int(np.argmax([r["correlation_valid"]
                                    for r in lam_rows]))

    n_test = 12 if args.smoke else 60
    per_group = max(1, n_test // len(group_means))
    data_test, gt_test = generate_data(group_means,
                                       [per_group] * len(group_means), tp,
                                       noise_multiplicative=args.noise,
                                       rng=rng)
    # reference figures.jl:44 screens 1000 scalar θ inits per test subject
    n_test_inits = 64 if args.smoke else 1000
    theta_grid = jnp.asarray(rng.uniform(size=n_test_inits), jnp.float32)

    def test_rho_nn(nn_restart):
        xs, _ = validate_suppression_sigma_batch(
            net, jnp.asarray(nn_restart),
            jnp.asarray(data_test), jnp.asarray(tp, jnp.float32),
            theta_grid, cfg.lbfgs_iters)
        return spearman(gt_test, np.asarray(xs[:, 0]))

    if args.selection_sensitivity:
        # -- selection-rule × λ sensitivity map over the committed fine-grid
        # artifacts (r02 verdict weak #7): the reference's
        # best-validation-loss rule (suppression/figures.jl:27-41) vs the
        # best-validation-ρ rule vs a combined rank — each evaluated on the
        # SAME fresh 60-subject test stage.  Per-restart validation stats
        # come from suppression_sweep_fine.csv (committed), so only the
        # test-stage fits are computed here.
        import csv as _csv
        import json as _json

        fine_csv = args.results / "suppression_sweep_fine.csv"
        with fine_csv.open() as f:
            fine_rows = [{k: (int(v) if k == "restart" else float(v))
                          for k, v in r.items()}
                         for r in _csv.DictReader(f)]
        lams = sorted({r["lambda"] for r in fine_rows})
        cache: dict = {}

        def rho_for(lam, restart):
            if (lam, restart) not in cache:
                ckl, _ = load_checkpoint(
                    args.artifacts / f"suppression_lambda={lam}.npz")
                with Timer():
                    cache[(lam, restart)] = test_rho_nn(
                        ckl["nn_params"][restart])
            return cache[(lam, restart)]

        sens_rows = []
        for lam in lams:
            lrows = sorted((r for r in fine_rows if r["lambda"] == lam),
                           key=lambda r: r["restart"])
            loss_v = np.asarray([r["loss_valid"] for r in lrows])
            rho_v = np.asarray([r["correlation_valid"] for r in lrows])
            rank_sum = (np.argsort(np.argsort(loss_v))
                        + np.argsort(np.argsort(-rho_v)))
            for rule, sel in (("valid_loss", int(np.argmin(loss_v))),
                              ("valid_rho", int(np.argmax(rho_v))),
                              ("combined_rank", int(np.argmin(rank_sum)))):
                sens_rows.append({
                    "lambda": lam, "rule": rule, "restart": sel,
                    "valid_loss": float(loss_v[sel]),
                    "valid_rho": float(rho_v[sel]),
                    "test_rho": float(rho_for(lam, sel)),
                })
                print(sens_rows[-1], file=sys.stderr)

        write_csv(args.results / "suppression_selection_sensitivity.csv",
                  sens_rows)
        # NaN test_rho = degenerate λ (λ ≥ 1 collapses the NN to a
        # constant, every restart ties, θ fits are flat and Spearman is
        # undefined) — summarize NaN-robustly over the non-degenerate λ.
        # signed vs |ρ|: θ orientation is a GAUGE (like β, see README);
        # the by-loss rule is gauge-blind and can select an inverted
        # restart, so the signed mean is the honest robustness measure
        # for a user who follows the reference's selection verbatim.
        by_rule = {rule: np.asarray([r["test_rho"] for r in sens_rows
                                     if r["rule"] == rule])
                   for rule in ("valid_loss", "valid_rho", "combined_rank")}
        block = {
            "lambdas": lams,
            "rules": {rule: {
                "test_rho_mean": float(np.nanmean(v)),
                "test_rho_min": float(np.nanmin(v)),
                "test_rho_max": float(np.nanmax(v)),
                "test_abs_rho_mean": float(np.nanmean(np.abs(v))),
                "n_gauge_inverted": int(np.nansum(v < 0)),
                "n_degenerate_lambda": int(np.isnan(v).sum()),
                "best_lambda": float(lams[int(np.nanargmax(v))])}
                for rule, v in by_rule.items()},
            "note": ("best-validation-loss selection "
                     "(suppression/figures.jl:27-41) is gauge-blind: at "
                     "mid-λ it picks θ-inverted restarts (test ρ ≈ -0.8); "
                     "ρ-aware rules are robust across λ"),
            "rows": sens_rows,
        }
        mpath = args.results / "exp_suppression_metrics.json"
        summary = _json.loads(mpath.read_text()) if mpath.exists() else {}
        summary["selection_sensitivity"] = block
        write_metrics(mpath, summary)
        return

    rho_test = test_rho_nn(ck["nn_params"][best_r])
    rho_test_by_rho = (rho_test if best_r_rho == best_r
                       else test_rho_nn(ck["nn_params"][best_r_rho]))
    print(f"test-stage θ-recovery (λ={test_lambda}): by-loss restart "
          f"{best_r} ρ={rho_test:.3f}; by-valid-ρ restart {best_r_rho} "
          f"ρ={rho_test_by_rho:.3f}", file=sys.stderr)
    summary["test_stage"] = {
        "lambda": test_lambda, "n_test": int(len(gt_test)),
        "spearman": rho_test,
        "selected_restart": best_r,
        "spearman_best_valid_rho_restart": rho_test_by_rho,
        "best_valid_rho_restart": best_r_rho,
    }

    if rows:
        write_csv(args.results / "suppression_sweep.csv", rows)
    write_metrics(args.results / "exp_suppression_metrics.json", summary)


if __name__ == "__main__":
    main()

"""ADVI experiment — variational posteriors for the cUDE.

Reconstructs the capability behind the reference's orphaned
``source_data/advi/cude_result_*.jld2`` artifacts (25 files, one per
training restart, each ``betas[N]`` + ``parameters[P]``; the producing
Turing.jl script no longer exists — SURVEY.md §2.12):

1. joint mean-field ADVI over (NN weights, per-individual β, log σ) for
   every cached training restart — the whole restart axis is one ``vmap``,
2. per-individual β posteriors on the test cohort with the selected NN
   frozen (the variational analogue of the (β, σ) re-estimation), and a
   cross-check of the posterior sd against the profile-likelihood CIs.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np

from common import configure_backend, Timer, load_cohorts, make_parser, \
    write_metrics


def main():
    p = make_parser(__doc__)
    p.add_argument("--restarts", type=int, default=None,
                   help="limit the number of restarts (default: all cached)")
    args = p.parse_args()
    configure_backend(args)

    import jax
    import jax.numpy as jnp

    from conditional_ude_tpu.fit.advi import advi_betas, advi_joint
    from conditional_ude_tpu.models.cpeptide import CPeptideModel, build_cohort
    from conditional_ude_tpu.nn import chain
    from conditional_ude_tpu.utils.checkpoint import save_checkpoint
    from conditional_ude_tpu.utils.stats import spearman, stratified_split

    train, test, cohort_train, cohort_test = load_cohorts(args.smoke)

    net = chain(4, 2, "tanh", input_dims=2)
    model = CPeptideModel(kind="conditional", net=net)

    cude_path = args.artifacts / "cude_neural_parameters.npz"
    if not cude_path.exists():
        print(f"[exp_advi] {cude_path} missing — run exp02 first",
              file=sys.stderr)
        if not args.smoke:
            raise SystemExit(1)
        candidates = np.asarray(net.init_batch(jax.random.key(0), 2))
        betas_cand = np.full((2, cohort_train.n, 1), -1.0, np.float32)
        idx_fit = np.arange(cohort_train.n)
    else:
        z = np.load(cude_path)
        candidates, betas_cand = z["nn_params"], z["betas"]
        if "idx_fit" in z:
            # the exact split the restart β's were fit on (seed-proof)
            idx_fit = np.asarray(z["idx_fit"])
        else:
            rng = np.random.default_rng(args.seed)
            idx_fit, _ = stratified_split(rng, train.types, 0.7)
        if betas_cand.shape[1] != len(idx_fit):  # smoke artifacts
            idx_fit = np.arange(betas_cand.shape[1])

    n_restarts = candidates.shape[0]
    if args.restarts is not None:
        n_restarts = min(args.restarts, n_restarts)
    if args.smoke:
        n_restarts = min(2, n_restarts)

    fit_split = train.subset(np.asarray(idx_fit))
    cohort_fit = build_cohort(fit_split.glucose, fit_split.timepoints,
                              fit_split.cpeptide, fit_split.ages,
                              fit_split.t2dm)

    steps_joint = 50 if args.smoke else 2000
    steps_beta = 50 if args.smoke else 1500

    # -- 1. joint posterior per training restart (vmapped restart axis) ----
    nn0 = jnp.asarray(candidates[:n_restarts], jnp.float32)
    b0 = jnp.asarray(betas_cand[:n_restarts, :cohort_fit.n, 0]
                     if betas_cand.ndim == 3
                     else betas_cand[:n_restarts, :cohort_fit.n], jnp.float32)
    keys = jax.random.split(jax.random.key(args.seed), n_restarts)

    def one(nn_init, beta_init, k):
        return advi_joint(model, cohort_fit, nn_init, k,
                          init_betas=beta_init, steps=steps_joint,
                          n_samples=4, solver="rk4", substeps=4)

    with Timer() as t_joint:
        joint = jax.vmap(one)(nn0, b0, keys)
        jax.block_until_ready(joint.beta_mean)

    save_checkpoint(args.artifacts / "advi_cude_results.npz", {
        "nn_mean": joint.nn_mean, "nn_std": joint.nn_std,
        "beta_mean": joint.beta_mean, "beta_std": joint.beta_std,
        "log_sigma_mean": joint.log_sigma_mean,
        "elbo_final": joint.elbo_trace[:, -1],
    }, metadata={"script": "exp_advi", "restarts": int(n_restarts),
                 "steps": steps_joint})

    # agreement with the cached point fits (per-restart β correlation)
    corr_point = [float(np.corrcoef(np.asarray(joint.beta_mean[r]),
                                    np.asarray(b0[r]))[0, 1])
                  for r in range(n_restarts)]

    # -- 2. test-cohort β posteriors with the best NN ------------------------
    try:
        best = json.loads((args.results / "exp02_metrics.json").read_text()
                          )["best_model_index"]
    except Exception:
        best = 0
    # --restarts only limits the joint-ADVI stage; the full candidate array
    # is loaded, so the validation-selected NN stays available here
    best = min(best, candidates.shape[0] - 1)
    nn_best = jnp.asarray(candidates[best], jnp.float32)

    with Timer() as t_beta:
        post = advi_betas(model, nn_best, cohort_test, jax.random.key(7),
                          initial_beta=-1.0, steps=steps_beta,
                          solver="rk4", substeps=4)
        jax.block_until_ready(post.beta_mean)

    b_mean = np.asarray(post.beta_mean)
    b_std = np.asarray(post.beta_std)
    rho_fp = spearman(b_mean, test.first_phase)

    # profile-CI cross-check: ADVI sd should correlate with the
    # profile-likelihood CI half-width on identifiable subjects
    from conditional_ude_tpu.analysis import (
        cohort_beta_profiles,
        find_confidence_intervals,
    )

    prof = cohort_beta_profiles(model, nn_best, cohort_test,
                                sigmas=jnp.exp(post.log_sigma_mean),
                                lower=-6.0, upper=2.0,
                                steps=200 if args.smoke else 2000)
    ci = find_confidence_intervals(prof, "cantelli95")
    half_width = 0.5 * (np.asarray(ci.upper) - np.asarray(ci.lower))
    ok = np.isfinite(half_width)
    sd_ci_corr = (float(np.corrcoef(b_std[ok], half_width[ok])[0, 1])
                  if ok.sum() > 2 else None)

    save_checkpoint(args.artifacts / "advi_test_posteriors.npz", {
        "beta_mean": b_mean, "beta_std": b_std,
        "log_sigma_mean": np.asarray(post.log_sigma_mean),
        "elbo_final": np.asarray(post.elbo_trace)[:, -1],
    }, metadata={"script": "exp_advi", "model_index": int(best)})

    metrics = {
        "n_restarts": int(n_restarts),
        "joint_seconds": t_joint.seconds,
        "joint_elbo_final_best": float(np.max(np.asarray(
            joint.elbo_trace[:, -1]))),
        "joint_beta_pointfit_corr_mean": float(np.mean(corr_point)),
        "test_beta_seconds": t_beta.seconds,
        "test_spearman_first_phase": rho_fp,
        "test_beta_std_median": float(np.median(b_std)),
        "advi_sd_vs_profile_ci_corr": sd_ci_corr,
        "identifiable_fraction": float(ok.mean()),
    }

    # -- 3. golden round-trip of the reference's committed ADVI artifacts --
    # (r04 verdict missing #1: the one cached artifact family never READ).
    # Each of the 25 files is an independent joint ADVI run over its own
    # 57-subject stratified subset (c-peptide/02-conditional.jl:19); the
    # Julia RNG subset draw is unrecoverable, so per-subject pairing is
    # impossible — instead re-estimate OUR β's at each file's posterior-mean
    # weights on the full 82-subject train cohort and compare the
    # per-restart β gauge (mean/std across restarts) and the per-restart
    # β DISTRIBUTION (quantile-matched correlation/RMSE: their 57 subjects
    # are a stratified subsample of our 82, so matching quantiles must
    # agree if both stacks estimate the same posterior means).
    advi_dir = args.data_dir.parent / "source_data" / "advi"
    if advi_dir.exists() and not args.smoke:
        from conditional_ude_tpu.data.jld2 import load_reference_advi

        ref = load_reference_advi(advi_dir)
        assert (ref["width"], ref["depth"]) == (4, 2), \
            "reference ADVI architecture drifted"
        # estimator-matched: OUR ADVI posterior means at their weights (a
        # bounded-MAP refit instead lets practically-unidentifiable
        # subjects run to the box bound, stretching the quantile tails the
        # reference's prior-shrunken variational means do not have)
        with Timer() as t_ref:
            ours = []
            for r in range(ref["parameters"].shape[0]):
                post_r = advi_betas(
                    model, jnp.asarray(ref["parameters"][r], jnp.float32),
                    cohort_train, jax.random.key(100 + r),
                    initial_beta=-1.0, steps=800,
                    solver="rk4", substeps=4)
                ours.append(np.asarray(post_r.beta_mean))
        ours = np.stack(ours)                       # [25, 82]
        theirs = ref["betas"]                       # [25, 57]

        qs = (np.arange(theirs.shape[1]) + 0.5) / theirs.shape[1]
        qcorr, qoff, qrmse_c = [], [], []
        for r in range(theirs.shape[0]):
            our_q = np.quantile(ours[r], qs)
            ref_q = np.sort(theirs[r])
            qcorr.append(float(np.corrcoef(our_q, ref_q)[0, 1]))
            off = float(np.mean(our_q - ref_q))
            qoff.append(off)
            qrmse_c.append(float(np.sqrt(np.mean(
                (our_q - ref_q - off) ** 2))))
        metrics["reference_advi_crosscheck"] = {
            "n_files": int(theirs.shape[0]),
            "seconds": t_ref.seconds,
            # per-restart quantile-matched comparison of the β posterior
            # means.  At these (ADVI-estimated) weights β is weakly
            # identified, so each stack's variational means sit near its
            # OWN prior center (ours N(-2,2), fit/advi.py:120; theirs
            # evidently ~-0.7) — a constant per-restart offset — while the
            # SHAPE of the distribution is driven by the shared
            # likelihood ordering.  Pearson is translation-invariant, so
            # quantile_corr measures exactly that shared shape; the offset
            # and the offset-removed RMSE are reported separately.
            "quantile_corr_per_restart_median": float(np.median(qcorr)),
            "quantile_corr_per_restart_min": float(np.min(qcorr)),
            "quantile_offset_median": float(np.median(qoff)),
            "quantile_rmse_centered_median": float(np.median(qrmse_c)),
            "beta_mean_range_ref": [float(theirs.mean(1).min()),
                                    float(theirs.mean(1).max())],
            "beta_mean_range_ours": [float(ours.mean(1).min()),
                                     float(ours.mean(1).max())],
            "note": (
                "weak per-subject likelihood at the reference's ADVI "
                "weights => each stack's variational means center on its "
                "own prior; shape agreement (quantile corr) is the "
                "meaningful round-trip statistic"),
        }
        print(f"[exp_advi] reference ADVI cross-check: median "
              f"quantile-corr {float(np.median(qcorr)):.3f}, offset "
              f"{float(np.median(qoff)):.3f}", file=sys.stderr)
    else:
        why = "smoke run" if args.smoke else f"not found at {advi_dir}"
        print(f"[exp_advi] reference ADVI cross-check skipped ({why})",
              file=sys.stderr)

    write_metrics(args.results / "exp_advi_metrics.json", metrics)


if __name__ == "__main__":
    main()

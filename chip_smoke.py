"""Smoke test of the cUDE fitting pipeline on a GPU, checked against the
plain reference on the CPU.

    python chip_smoke.py               # one GPU: flagship, re-estimation,
                                       # census
    python chip_smoke.py --four-cards  # the sharded path on four GPUs vs
                                       # card 0 alone

Every phase runs at the published widths — ``chain(4, 2, "tanh")`` (37
parameters), 5 OGTT time points, RK4 with 8 substeps — on the committed
Ohashi cohort (``artifacts/ohashi.npz``), through the entry points a user
calls:

1. flagship — ``train_conditional`` at the ``TrainConfig`` defaults (25,000
   screened designs -> 25 restarts x (1000 Adam + 1000 L-BFGS) -> adaptive
   Tsit5 ranking) on exp02's fit cohort, twice (cold, then warm);
2. re-estimation — ``fit_betas_sigma`` of the best restart on the 35 test
   subjects (bounds and 1000 L-BFGS iterations as in exp02);
3. census — ``cohort_beta_profiles`` of the best restart over the test
   subjects, 10,000 grid points.

The reference is the same code on the CPU device of this process, at
``jax.default_matmul_precision("highest")``.  Each comparison states its
tolerance and the reason for it.  A failed check raises; the last line of
stdout, ``{"ok": true, "device": {...}}``, is printed only when every phase
passed.  Without a GPU the script exits non-zero before any phase.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from conditional_ude_tpu.analysis.profiles import cohort_beta_profiles
from conditional_ude_tpu.data.ohashi import load_npz
from conditional_ude_tpu.fit.losses import population_sse, sse, sse_sigma
from conditional_ude_tpu.fit.train import (
    TrainConfig,
    fit_betas_sigma,
    initial_designs,
    train_conditional,
)
from conditional_ude_tpu.models.cpeptide import CPeptideModel, build_cohort
from conditional_ude_tpu.nn import chain
from conditional_ude_tpu.parallel import make_mesh, sharded_fit_betas
from conditional_ude_tpu.utils.device import (
    describe_devices,
    enable_compile_cache,
    gpu_name_and_power_limit,
    keep_cpu_platform,
    require_gpu,
)
from conditional_ude_tpu.utils.stats import stratified_split

REPO = Path(__file__).resolve().parent
OHASHI_NPZ = REPO / "artifacts" / "ohashi.npz"
EXP02_METRICS = REPO / "results" / "exp02_metrics.json"
SPLIT_SEED = 270523       # exp02's fit/validation split and training key


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Budgets of the phases (the defaults are the full run; the tests
    shrink them)."""

    train: TrainConfig = TrainConfig()
    reestimate_iters: int = 1000
    census_steps: int = 10_000
    screen_samples: int = 256         # screen losses re-evaluated on the CPU
    census_samples: int = 100         # census grid points re-evaluated
    mesh_iters: int = 100             # Adam, L-BFGS and re-estimation
                                      # budget of the four-card check


def log(msg: str) -> None:
    print(msg, flush=True)


def on_cpu(fn, *args):
    """``fn(*args)`` on the CPU device at full float32 matmul precision —
    the plain reference — with the arguments copied to the host first."""
    cpu = jax.devices("cpu")[0]
    args = jax.device_put(jax.tree.map(np.asarray, args), cpu)
    with jax.default_device(cpu), jax.default_matmul_precision("highest"):
        return jax.tree.map(np.asarray, fn(*args))


def require(ok, msg: str) -> None:
    """A check that holds under ``python -O`` too."""
    if not ok:
        raise AssertionError(msg)


def check(name: str, got, want, rtol: float, why: str) -> None:
    """Elementwise ``|got - want| <= rtol * |want|``; inf/nan must match."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    fin = np.isfinite(want) & np.isfinite(got)
    err = float(np.max(np.abs(got[fin] - want[fin]) / np.abs(want[fin]),
                       initial=0.0))
    log(f"  check {name}: max rel err {err:.3e} (rtol {rtol:g}: {why})")
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0.0,
                               err_msg=name)


def check_normwise(name: str, got, want, rtol: float, atol: float,
                   why: str) -> None:
    """``max|got - want| <= atol + rtol * max|want|``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.max(np.abs(got - want)))
    scale = float(np.max(np.abs(want)))
    log(f"  check {name}: max abs err {err:.3e}, max |ref| {scale:.3e} "
        f"(rtol {rtol:g}, atol {atol:g}: {why})")
    require(err <= atol + rtol * scale,
            f"{name}: max abs err {err:.3e} > {atol:g} + {rtol:g} * "
            f"{scale:.3e}")


def load_cohorts():
    """exp02's fit cohort (the 70/30 stratified split of the 82 training
    subjects, seed 270523) and the 35 test subjects, as numpy splits."""
    train, test = load_npz(OHASHI_NPZ)
    idx_fit, _ = stratified_split(np.random.default_rng(SPLIT_SEED),
                                  train.types, 0.7)
    return train.subset(idx_fit), test


def to_cohort(split):
    return build_cohort(split.glucose, split.timepoints, split.cpeptide,
                        split.ages, split.t2dm)


def flagship_model():
    return CPeptideModel(kind="conditional",
                         net=chain(4, 2, "tanh", input_dims=2))


def _timed(fn):
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def _fmt_timings(t: dict) -> str:
    return " ".join(f"{k}={v:.2f}s" if isinstance(v, float) else f"{k}={v}"
                    for k, v in t.items())


def phase_flagship(model, fit_split, sizes: Sizes):
    """Joint multi-start training, cold then warm; checks the screen, the
    final Tsit5 objectives and one value+grad against the CPU."""
    cfg = sizes.train
    cohort = to_cohort(fit_split)
    key = jax.random.key(SPLIT_SEED)
    log(f"phase flagship: {cohort.n} subjects, {cfg.initial_guesses} designs "
        f"-> {cfg.selected_initials} x ({cfg.adam_iters} Adam + "
        f"{cfg.lbfgs_iters} L-BFGS)")
    cold, t_cold = _timed(lambda: train_conditional(model, cohort, key, cfg))
    log(f"  cold (compile + run) {t_cold:.2f}s: {_fmt_timings(cold.timings)}")
    res, t_warm = _timed(lambda: train_conditional(model, cohort, key, cfg))
    log(f"  warm (run) {t_warm:.2f}s: {_fmt_timings(res.timings)}")

    best = float(res.objectives[0])
    log(f"  best training objective {best:.6g}")
    require(np.isfinite(best), "best training objective is not finite")
    if EXP02_METRICS.exists():
        committed = json.loads(EXP02_METRICS.read_text())["objective_best"]
        log(f"  committed exp02 objective_best {committed:.6g} "
            "(results/exp02_metrics.json: an earlier run, validation-"
            "selected restart; not this run)")

    loss_kw = dict(solver=cfg.solver, substeps=cfg.substeps,
                   max_steps=cfg.max_steps)
    n_samp = min(sizes.screen_samples, cfg.initial_guesses)
    idx = np.sort(np.random.default_rng(0).choice(
        cfg.initial_guesses, n_samp, replace=False))

    def screen_ref(c):
        nn, b = initial_designs(model.net, c.n, jax.random.key(SPLIT_SEED),
                                cfg)
        return jax.vmap(lambda nn_, b_: population_sse(
            model, nn_, b_, c, **loss_kw))(nn[idx], b[idx])

    check(f"screen losses ({n_samp} designs)",
          np.asarray(res.screen_losses)[idx], on_cpu(screen_ref, cohort),
          1e-4, "float32 RK4 over 40 steps; transcendentals differ by an "
          "ulp between backends (a 1-ulp input change moves a screen loss "
          "by <3e-6 on the CPU)")

    def tsit5_ref(nn, b, c):
        return jax.vmap(lambda nn_, b_: population_sse(
            model, nn_, b_, c, solver="tsit5",
            max_steps=cfg.max_steps))(nn, b)

    if cfg.final_eval_tsit5:
        # adaptive Tsit5 at the reference's rtol 1e-3 accepts different
        # steps on the two backends, and the two solutions then differ by
        # up to the solver's own error (1.6e-2 nmol/L on this model
        # class): single objectives moved by up to 2.0e-2 (my chip runs),
        # while a systematic error would move the median
        ref = on_cpu(tsit5_ref, res.nn_params, res.betas, cohort)
        check("final Tsit5 objectives", res.objectives, ref, 5e-2,
              "solver error, see above")
        med = float(np.median(np.abs(np.asarray(res.objectives) - ref)
                              / np.abs(ref)))
        log(f"  check final Tsit5 objectives, median rel err {med:.3e} "
            "(<= 1e-2)")
        require(med <= 1e-2, f"median Tsit5 rel err {med:.3e} > 1e-2")

    def vg(nn, b, c):
        return jax.value_and_grad(lambda nn_, b_: population_sse(
            model, nn_, b_, c, **loss_kw), argnums=(0, 1))(nn, b)

    vg_jit = jax.jit(vg)
    # at a well-conditioned point (the best screened design, Glorot
    # weights) a 1-ulp input change moves the gradient by <5e-5 relative;
    # at trained weights the NN gradient is ill-conditioned: across 25
    # trained restarts a 1-ulp input change moved it by up to 6.4e-3
    # absolute (β gradient 2.8e-5) on the CPU, so there the check allows
    # five times that
    top = int(np.argmin(np.where(np.isfinite(res.screen_losses),
                                 res.screen_losses, np.inf)))
    nn_all, b_all = initial_designs(model.net, cohort.n,
                                    jax.random.key(SPLIT_SEED), cfg)
    points = {"best screened design": (nn_all[top], b_all[top], 0.0, 0.0),
              "best restart": (res.nn_params[0], res.betas[0], 3e-2, 1.5e-4)}
    for label, (nn, b, nn_atol, b_atol) in points.items():
        (v_g, (gn_g, gb_g)) = vg_jit(nn, b, cohort)
        (v_c, (gn_c, gb_c)) = on_cpu(vg, nn, b, cohort)
        check(f"value at {label}", v_g, v_c, 1e-4,
              "a 1-ulp input change moves it by <1e-6")
        check_normwise(f"NN gradient at {label}", gn_g, gn_c, 1e-3, nn_atol,
                       "1-ulp sensitivity, see above")
        check_normwise(f"beta gradient at {label}", gb_g, gb_c, 1e-3, b_atol,
                       "1-ulp sensitivity, see above")
    return res


def reestimation_bounds(betas_best) -> tuple[float, float]:
    """exp02's re-estimation bounds: the training β range ±10%."""
    b = np.asarray(betas_best).ravel()
    return (float(b.min() - 0.1 * abs(b.min())),
            float(b.max() + 0.1 * abs(b.max())))


def phase_reestimate(model, nn_best, betas_best, test_split, sizes: Sizes):
    """(β, σ) re-estimation on the test subjects with the NN frozen."""
    cohort = to_cohort(test_split)
    lb, ub = reestimation_bounds(betas_best)
    log(f"phase re-estimation: {cohort.n} subjects, bounds ({lb:.4g}, "
        f"{ub:.4g}), {sizes.reestimate_iters} L-BFGS iterations")

    args = (model, nn_best, cohort, -1.0, (lb, ub), sizes.reestimate_iters)
    _, t_compile = _timed(lambda: fit_betas_sigma.lower(*args).compile())
    # the call finds the program in the persistent compile cache
    (b, s, o), t_run = _timed(lambda: fit_betas_sigma(*args))
    log(f"  compile {t_compile:.2f}s, run {t_run:.2f}s")
    require(np.isfinite(np.asarray(o)).all(), "non-finite re-estimation")

    def ref(nn, b_, s_, c):
        return jax.vmap(lambda bi, si, ind, d: sse_sigma(
            model, {"neural": nn, "conditional": bi}, si, ind,
            c.timepoints, d, solver="rk4", substeps=8))(
                b_, s_, c.individuals, c.cpeptide)

    check("re-estimated objectives", o, on_cpu(ref, nn_best, b, s, cohort),
          1e-3, "the NLL of the GPU's (β, σ) re-evaluated in float32 RK4; "
          "log σ² and SSE/2σ² partly cancel")
    return b, s, (lb, ub)


def phase_census(model, nn_best, sigmas, bounds, test_split, sizes: Sizes):
    """Likelihood-profile scan of every test subject over the β grid."""
    cohort = to_cohort(test_split)
    lower, upper = bounds[0] - 1.0, bounds[1] + 1.0
    steps = sizes.census_steps
    log(f"phase census: {cohort.n} subjects x {steps} grid points")

    def run():
        return cohort_beta_profiles(model, nn_best, cohort, sigmas=sigmas,
                                    lower=lower, upper=upper, steps=steps)

    _, t_cold = _timed(run)
    prof, t_warm = _timed(run)
    log(f"  cold (compile + run) {t_cold:.2f}s, warm (run) {t_warm:.2f}s")

    cols = np.unique(np.linspace(0, steps - 1, min(sizes.census_samples,
                                                   steps)).astype(int))

    def ref(nn, grid, sig, c):
        def at(beta, ind, d, s_):
            return sse(model, {"neural": nn, "conditional": beta}, ind,
                       c.timepoints, d, solver="rk4", substeps=8) / (
                           2.0 * s_**2)

        return jax.vmap(jax.vmap(at, in_axes=(0, None, None, None)),
                        in_axes=(None, 0, 0, 0))(
                            grid, c.individuals, c.cpeptide, sig)

    check(f"census ({len(cols)} grid points x {cohort.n} subjects)",
          np.asarray(prof.values)[:, cols],
          on_cpu(ref, nn_best, np.asarray(prof.grid)[cols],
                 jnp.broadcast_to(jnp.asarray(sigmas, jnp.float32),
                                  (cohort.n,)), cohort),
          1e-3, "near each subject's optimum the residuals are ~1e-3 of "
          "the state, so one float32 ulp of the state is ~1e-4 of the NLL "
          "(measured max 6.8e-5 on the card)")
    return prof


def phase_four_cards(model, fit_split, test_split, sizes: Sizes):
    """The restart and individual meshes on four cards against card 0
    alone: the flagship screen (25,000 designs sharded 4 ways) and a
    ``mesh_iters`` refinement (25 restarts padded to 28), then the sharded
    (β, σ) re-estimation (35 subjects padded to 36)."""
    devices = jax.devices()[:4]
    it = sizes.mesh_iters
    # the compared objectives are the L-BFGS (RK4) ones: with the adaptive
    # Tsit5 re-ranking they differed by up to 2.8e-3 (four H100s), which
    # mixes solver error into the comparison
    cfg = dataclasses.replace(sizes.train, adam_iters=it, lbfgs_iters=it,
                              final_eval_tsit5=False)
    cohort = to_cohort(fit_split)
    key = jax.random.key(SPLIT_SEED)
    mesh_r = make_mesh(("restarts",), (4,), devices)
    log(f"phase four-cards: restart mesh over {len(devices)} devices, "
        f"{cfg.initial_guesses} designs -> {cfg.selected_initials} x "
        f"({it} Adam + {it} L-BFGS), refinement padded to a multiple of 4")
    mesh, t_mesh = _timed(lambda: train_conditional(model, cohort, key, cfg,
                                                    mesh=mesh_r))
    log(f"  mesh (compile + run) {t_mesh:.2f}s: {_fmt_timings(mesh.timings)}")
    one, t_one = _timed(lambda: train_conditional(model, cohort, key, cfg))
    log(f"  card 0 (compile + run) {t_one:.2f}s: {_fmt_timings(one.timings)}")
    require(mesh.objectives.shape == (cfg.selected_initials,),
            f"mesh run returned {mesh.objectives.shape[0]} restarts")
    check("mesh vs card-0 screen losses", mesh.screen_losses,
          one.screen_losses, 1e-5, "the same per-lane arithmetic")
    check(f"mesh vs card-0 objectives after {it} + {it} iterations",
          np.sort(np.asarray(mesh.objectives)),
          np.sort(np.asarray(one.objectives)), 1e-2,
          "float reassociation between the sharded and the single-card "
          "programs, amplified by the optimizer's iterations")

    test = to_cohort(test_split)
    mesh_i = make_mesh(("individuals",), (4,), devices)
    lb, ub = reestimation_bounds(one.betas[0])
    kw = dict(initial_beta=-1.0, bounds=(lb, ub), lbfgs_iters=it)
    nn_best = np.asarray(one.nn_params[0])
    sharded, t_sh = _timed(lambda: sharded_fit_betas(
        model, nn_best, test, mesh_i, sigma=True, **kw))
    plain, t_pl = _timed(lambda: fit_betas_sigma(model, nn_best, test, **kw))
    log(f"  re-estimation, {it} L-BFGS iterations: {test.n} subjects padded "
        f"to a multiple of 4, sharded {t_sh:.2f}s, card 0 {t_pl:.2f}s "
        "(both compile + run)")
    check("mesh vs card-0 re-estimated objectives", sharded[2], plain[2],
          1e-4, "the same per-subject arithmetic")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the sharded path on four GPUs and its "
                        "comparison with card 0 alone")
    args = p.parse_args(argv)

    cache = enable_compile_cache()
    keep_cpu_platform()
    try:
        require_gpu()
    except RuntimeError as e:
        sys.exit(f"chip_smoke: {e}")
    n_need = 4 if args.four_cards else 1
    if len(jax.devices()) < n_need:
        sys.exit(f"chip_smoke: need {n_need} GPUs, have "
                 f"{len(jax.devices())}")
    device = describe_devices()
    log(f"card: {gpu_name_and_power_limit()}")
    log(f"device: {device}; jax {jax.__version__}; compile cache {cache}")

    model = flagship_model()
    fit_split, test_split = load_cohorts()
    sizes = Sizes()
    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards(model, fit_split, test_split, sizes)
        device["count"] = 4
    else:
        res = phase_flagship(model, fit_split, sizes)
        nn_best, betas_best = res.nn_params[0], res.betas[0]
        _, sigmas, bounds = phase_reestimate(model, nn_best, betas_best,
                                             test_split, sizes)
        phase_census(model, nn_best, sigmas, bounds, test_split, sizes)
        device["count"] = 1
    stats = jax.devices()[0].memory_stats() or {}
    log(f"all phases passed in {time.perf_counter() - t0:.1f}s; peak device "
        f"memory {stats.get('peak_bytes_in_use', 'not reported')} bytes")
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()

"""Headline benchmark: batched conditional-UDE cohort ODE solves per second.

The reference's hot loop is a serial per-individual, per-restart chain of
adaptive Tsit5 solves of the 2-state c-peptide ODE with the MLP production
term inside the RHS (``src/parameter-estimation.jl:126-140,362-366``).  This
benchmark measures the batched equivalent on the GPU: one jitted program
evaluating the population loss over a [restarts × individuals] grid — i.e.
the screening pass of joint cUDE training — and reports trajectory solves
per second, beside the refinement (value+grad), covariate-screen and
census throughputs.

``vs_baseline`` is the speedup over a *measured serial baseline*: the same
solve executed one-trajectory-at-a-time on one host CPU core via a host loop,
which is the faithful stand-in for the reference's serial Julia execution
model (the reference publishes no wall-clock numbers, BASELINE.md).

Runs on a GPU only (exits non-zero otherwise).  Diagnostics, the device and
the card's name and power limit go to stderr; stdout is ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N, ...}
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
OHASHI_NPZ = REPO / "artifacts" / "ohashi.npz"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def best_throughput(fn, args, reps: int, work: int, label: str) -> float:
    """Best of 3 trials of ``reps`` back-to-back calls (one sync per trial);
    returns ``work`` units per second.  The first call compiles."""
    import jax

    jax.block_until_ready(fn(*args))
    best = 0.0
    for trial in range(3):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        best = max(best, reps * work / dt)
        log(f"{label} trial {trial}: {reps * work} in {dt:.3f}s -> "
            f"{reps * work / dt:,.0f}/s")
    return best


def main():
    import jax
    import jax.numpy as jnp

    from conditional_ude_tpu.data.ohashi import load_npz
    from conditional_ude_tpu.fit.losses import population_sse, sse
    from conditional_ude_tpu.fit.train import TrainConfig
    from conditional_ude_tpu.models.cpeptide import CPeptideModel, build_cohort
    from conditional_ude_tpu.nn import chain
    from conditional_ude_tpu.utils.device import (
        describe_devices,
        enable_compile_cache,
        gpu_name_and_power_limit,
        keep_cpu_platform,
        require_gpu,
    )

    enable_compile_cache()
    keep_cpu_platform()   # the serial baseline runs on the host CPU
    require_gpu()
    device = describe_devices()
    card = gpu_name_and_power_limit()
    log(f"device: {device}; card: {card}")

    train, _ = load_npz(OHASHI_NPZ)
    cohort = build_cohort(train.glucose, train.timepoints, train.cpeptide,
                          train.ages, train.t2dm)
    n_ind = cohort.n
    log(f"ohashi train cohort: {n_ind} subjects")
    net = chain(4, 2, "tanh", input_dims=2)
    model = CPeptideModel(kind="conditional", net=net)
    rk4 = dict(solver="rk4", substeps=8)

    G = 8192  # restart lanes per batched evaluation
    nn_inits = net.init_batch(jax.random.key(0), G)
    betas = jnp.asarray(
        np.random.default_rng(1).uniform(-2, 0, (G, n_ind)), jnp.float32)

    # -- screening path: the population loss over [G restarts × N] ----------
    reps = 60
    screen = jax.jit(jax.vmap(
        lambda nn, b: population_sse(model, nn, b[:, None], cohort, **rk4)))
    finite = int(np.isfinite(np.asarray(screen(nn_inits, betas))).sum())
    log(f"screen: {finite}/{G} finite lanes")
    screen_rate = best_throughput(screen, (nn_inits, betas), reps,
                                  G * n_ind, "screen solves")

    # -- refinement path: (value, ∇nn, ∇β) at the production restart count
    R = TrainConfig.selected_initials

    def _loss(nn, b):
        return population_sse(model, nn, b[:, None], cohort, **rk4)

    vg = jax.jit(jax.vmap(jax.value_and_grad(_loss, argnums=(0, 1))))
    vg_rate = best_throughput(vg, (nn_inits[:R], betas[:R]), 300, R,
                              "refine value+grad evals")

    # -- covariate screening path (3-input net, exp07's workload) ------------
    net_cov = chain(4, 2, "tanh", input_dims=3)
    model_cov = CPeptideModel(kind="conditional_covariate", net=net_cov)
    cov = jax.jit(jax.vmap(
        lambda nn, b: population_sse(model_cov, nn, b[:, None], cohort,
                                     **rk4)))
    cov_rate = best_throughput(
        cov, (net_cov.init_batch(jax.random.key(2), G), betas), reps,
        G * n_ind, "covariate screen solves")

    # -- census path: one 500-point chunk of the likelihood-profile scan -----
    s_chunk = 500
    census = jax.jit(jax.vmap(
        lambda b: population_sse(model, nn_inits[0], b[:, None], cohort,
                                 **rk4)))
    grid = jnp.linspace(-4.0, 1.0, s_chunk)[:, None] * jnp.ones((1, n_ind))
    census_rate = best_throughput(census, (grid,), 60, s_chunk * n_ind,
                                  "census profile points")

    # -- serial baseline: one trajectory at a time on one host CPU core -----
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        single = jax.jit(lambda nn, b, ind, data: sse(
            model, {"neural": nn, "conditional": b}, ind,
            cohort.timepoints, data, mode="while"))
        ind0 = jax.tree.map(lambda a: jax.device_put(np.asarray(a), cpu),
                            cohort.individual(0))
        data0 = jax.device_put(np.asarray(cohort.cpeptide[0]), cpu)
        nn0 = jax.device_put(np.asarray(nn_inits[0]), cpu)
        b0 = jax.device_put(np.asarray(betas[0, 0]), cpu)
        single(nn0, b0, ind0, data0).block_until_ready()  # compile
        m = 200
        t0 = time.perf_counter()
        for _ in range(m):
            single(nn0, b0, ind0, data0).block_until_ready()
        serial_dt = time.perf_counter() - t0
    serial_rate = m / serial_dt
    log(f"serial CPU: {m} solves in {serial_dt:.3f}s -> "
        f"{serial_rate:,.1f} solves/s")

    print(json.dumps({
        "metric": "cude_cohort_ode_solves_per_sec",
        "value": screen_rate,
        "unit": "solves/s",
        "vs_baseline": screen_rate / serial_rate,
        "device": device,
        "card": card,
        # (value, ∇nn, ∇β) population evaluations/s at R=25 restarts, the
        # per-iteration unit of the Adam/L-BFGS refinement; each eval is
        # n_individuals forward+reverse trajectory passes
        "refine_vg_evals_per_sec": vg_rate,
        "refine_vg_solves_per_sec": vg_rate * n_ind,
        # likelihood-profile points (one trajectory solve each) per second
        "census_profile_points_per_sec": census_rate,
        # the 3-input (age) screening variant at the same 8192 x N workload
        "covariate_screen_solves_per_sec": cov_rate,
        "serial_cpu_solves_per_sec": serial_rate,
    }))


if __name__ == "__main__":
    main()

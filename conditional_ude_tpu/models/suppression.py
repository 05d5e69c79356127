"""Simulated suppression-model cUDE example (synthetic ground truth).

Capability parity with ``suppression/src/suppression_model.jl``: a 3-state
ODE whose suppression flux ``p2·u2/(1 + p4·u3)`` is replaced by a neural
network receiving the state plus a learnable per-individual conditional
parameter exp(θᵢ); training jointly fits NN weights + θ over a synthetic
population with known per-individual p4, so rank correlation between θ̂ and
the ground truth measures method recovery — the reference's (and our) main
end-to-end test (SURVEY.md §4).

Batched: the reference's ``EnsembleProblem`` + ``EnsembleThreads`` batched
solves become a ``vmap`` over the population axis inside one compiled loss.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from conditional_ude_tpu.nn import MLP, chain
from conditional_ude_tpu.fit.optim import adam_minimize
from conditional_ude_tpu.ops.lbfgs import lbfgs_minimize
from conditional_ude_tpu.ops.tsit5 import solve_tsit5

P_TRUE = (0.4, 0.9, 0.3)    # group-mean kinetic parameters (p1, p2, p3)
U0 = (10.0, 0.0, 0.0)


def suppression_net(depth: int = 5, width: int = 3) -> MLP:
    """The reference's network: ``depth`` tanh layers of ``width``, softplus
    head, 4 inputs = 3 states + conditional
    (``suppression/suppression.jl:13-18``)."""
    return chain(width, depth, "tanh", input_dims=4)


def lsup_rhs(t, u, p):
    """Ground-truth 3-state suppression ODE
    (``suppression/src/suppression_model.jl:16-20``)."""
    p1, p2, p3, p4 = p
    flux = p2 * u[1] / (1.0 + p4 * u[2])
    return jnp.stack([-p1 * u[0], p1 * u[0] - flux, flux - p3 * u[2]])


def sample_group_parameters(mu_sup: float, n: int,
                            rng: np.random.Generator) -> np.ndarray:
    """N(μ, σ) individual parameters clipped ≥ 0.05, σ_sup = μ_sup/8
    (reference :33-37). Shape [n, 4]."""
    mu = np.array([*P_TRUE, mu_sup])
    std = np.array([0.1, 0.1, 0.1, mu_sup / 8.0])
    return np.maximum(mu + std * rng.standard_normal((n, 4)), 0.05)


def generate_data(
    group_means,
    group_sizes,
    timepoints,
    noise_multiplicative: float = 0.0,
    noise_additive: float = 0.0,
    rng: np.random.Generator | None = None,
):
    """Simulate a synthetic population; returns (data[N, 3, T], gt_p4[N]).

    Mirrors reference :39-63 (Tsit5 simulation + multiplicative noise,
    clipped ≥ 0).
    """
    rng = rng or np.random.default_rng(232705)
    timepoints = np.asarray(timepoints, dtype=np.float32)
    params = np.concatenate([
        sample_group_parameters(gm, gs, rng)
        for gm, gs in zip(group_means, group_sizes)
    ])  # [N, 4]

    u0 = jnp.asarray(U0, jnp.float32)
    tp = jnp.asarray(timepoints)

    def simulate_one(p):
        return solve_tsit5(lsup_rhs, u0, tp[0], tp[-1], p, tp,
                           rtol=1e-6, atol=1e-8, max_steps=1024).ys

    sols = np.array(jax.jit(jax.vmap(simulate_one))(
        jnp.asarray(params, jnp.float32)))          # [N, T, 3]
    sols = np.swapaxes(sols, 1, 2)                  # [N, 3, T]
    noise = (noise_additive * rng.standard_normal(sols.shape)
             + noise_multiplicative * sols * rng.standard_normal(sols.shape))
    data = np.maximum(sols + noise, 0.0)
    return data.astype(np.float32), params[:, 3].astype(np.float32)


def make_ude_rhs(net: MLP):
    """UDE: NN([u; exp(θ)]) replaces the suppression flux (reference :88-95)."""

    def rhs(t, u, args):
        nn, theta = args
        x = jnp.concatenate([u, jnp.exp(jnp.atleast_1d(theta))])
        flux = net.scalar(nn, x)
        p1, _, p3 = P_TRUE
        return jnp.stack([-p1 * u[0], p1 * u[0] - flux, flux - p3 * u[2]])

    return rhs


def simulate_population(net, nn_params, thetas, u0s, timepoints,
                        max_steps: int = 512, solver: str = "rk4",
                        substeps: int = 8):
    """Batched UDE solve from per-individual initial states (the reference's
    EnsembleProblem, :97-115). Returns ys[N, T, 3] and success[N].

    Defaults to fixed-step RK4 (substeps=8: max trajectory error ~1e-3 on
    states of magnitude 10, comparable to the adaptive default tolerance)
    — the throughput/training path; pass ``solver="tsit5"`` for the
    adaptive parity path.
    """
    rhs = make_ude_rhs(net)
    tp = jnp.asarray(timepoints, jnp.float32)

    if solver == "rk4":
        from conditional_ude_tpu.ops.rk4 import solve_rk4

        def one(theta, u0):
            return solve_rk4(rhs, u0, (nn_params, theta), tp, t0=tp[0],
                             substeps=substeps)
    else:
        def one(theta, u0):
            return solve_tsit5(rhs, u0, tp[0], tp[-1], (nn_params, theta),
                               tp, max_steps=max_steps)

    return jax.vmap(one)(thetas, u0s)


def suppression_loss(net, nn_params, thetas, data, timepoints,
                     lam: float = 0.0, max_steps: int = 512,
                     solver: str = "rk4", substeps: int = 8):
    """Scale-normalized population SSE / N + λ‖NN‖² (reference :117-130).

    ``data[N, 3, T]``; initial conditions are the first sample of each
    trajectory; a diverged individual makes the loss ``inf``.
    """
    u0s = data[:, :, 0]
    res = simulate_population(net, nn_params, thetas, u0s, timepoints,
                              max_steps=max_steps, solver=solver,
                              substeps=substeps)
    sims = jnp.swapaxes(res.ys, 1, 2)               # [N, 3, T]
    # scale[3]: mean over individuals of per-state max over time (ref :126)
    scale = jnp.mean(jnp.max(data, axis=2), axis=0)
    err = jnp.sum(((sims - data) / scale[None, :, None]) ** 2)
    err = jnp.where(res.success.all(), err, jnp.inf)
    n = data.shape[0]
    return err / n + lam * jnp.sum(nn_params**2)


@dataclasses.dataclass(frozen=True)
class SuppressionFitConfig:
    """Reference defaults: 10,000 joint inits → best 25 → Adam×2000 +
    L-BFGS×2000 (``suppression/suppression.jl:10-11``, model file :160-168)."""

    initial_space: int = 10_000
    select_best_n: int = 25
    adam_iters: int = 2000
    lbfgs_iters: int = 2000
    adam_lr: float = 1e-3   # Optimisers.Adam() default
    max_steps: int = 512
    screen_chunk: int = 512
    # the refinement runs as a sequence of bounded-runtime
    # dispatches (both Adam state and the L-BFGS curvature history thread
    # through the chunks, so chunking never changes the result)
    dispatch_chunk: int = 250


class SuppressionFit(NamedTuple):
    nn_params: jax.Array    # [R, P] best-first
    thetas: jax.Array       # [R, N]
    objectives: jax.Array   # [R]
    loss_traces: jax.Array  # [R, adam_iters]


def fit_suppression(
    net: MLP,
    data: jax.Array,
    timepoints: jax.Array,
    key: jax.Array,
    lam: float = 0.0,
    config: SuppressionFitConfig = SuppressionFitConfig(),
    mesh=None,
) -> SuppressionFit:
    """Joint (NN, θ) multi-start fit (reference ``fit_suppression_model``).

    Thin wrapper over the batched λ-sweep with a single λ — the sweep with
    one lane runs exactly the screen → top-k → Adam → L-BFGS pipeline the
    reference performs per λ (``tests/test_suppression_recovery.py``
    asserts the equivalence), so there is only ONE refinement pipeline to
    maintain."""
    res = fit_suppression_sweep(net, data, timepoints, key,
                                jnp.asarray([lam], jnp.float32), config,
                                mesh=mesh)
    return SuppressionFit(*(a[0] for a in res))


def fit_suppression_sweep(
    net: MLP,
    data: jax.Array,
    timepoints: jax.Array,
    key: jax.Array,
    lambdas,
    config: SuppressionFitConfig = SuppressionFitConfig(),
    mesh=None,
) -> SuppressionFit:
    """The whole λ-sweep as ONE batched program (batched replacement for
    the reference's one-process-per-λ driver, ``suppression/suppression.jl:39``).

    Two structural facts make the sweep collapse:

    * the loss is ``err(nn, θ) + λ‖nn‖²``, so the 10k-init screening pass
      is λ-independent up to a rank-1 correction — ONE screen of
      ``(err_i, ‖nn_i‖²)`` serves every λ's top-k selection;
    * refinement is already a ``vmap`` over restart lanes, and λ is just a
      per-lane scalar — the (λ × restart) grid flattens into a single lane
      axis of one compiled optimizer.

    With the driver's convention of reusing the same PRNG key per λ
    (shared initial space), each λ's result is numerically the same
    computation a single-λ run performs: the screen decomposition is
    exact, λ rides as a per-lane scalar, and the L-BFGS history threads
    through the dispatch chunks so the lane count never alters the
    per-λ trajectory.  Returns a
    ``SuppressionFit`` with a leading λ axis on every field
    (``nn_params[L, R, P]`` …), each λ's restarts sorted best-first.

    With ``mesh`` (a ``jax.sharding.Mesh`` with a ``"restarts"`` axis) the
    screening inits and the flattened (λ × restart) refinement lanes shard
    over that axis — lanes are independent, so the sweep scales
    near-linearly across chips with no collective but the host-side top-k.
    Lane padding (repeating the last lane up to the axis size) is sliced
    away before results assemble, so the mesh never changes the numbers.
    """
    cfg = config
    lambdas = jnp.asarray(lambdas, jnp.float32)          # [L]
    n_lam = lambdas.shape[0]
    n = data.shape[0]
    data = jnp.asarray(data, jnp.float32)
    tp = jnp.asarray(timepoints, jnp.float32)

    from conditional_ude_tpu.parallel.mesh import pad_to_multiple

    r_size = None
    if mesh is not None and "restarts" in mesh.shape:
        from conditional_ude_tpu.parallel.mesh import shard_leading

        r_size = mesh.shape["restarts"]

    k_nn, k_th = jax.random.split(key)
    nn_inits = net.init_batch(k_nn, cfg.initial_space)
    theta_inits = jax.random.normal(k_th, (cfg.initial_space, n))
    g_orig = cfg.initial_space
    if r_size:
        nn_inits = shard_leading(pad_to_multiple(nn_inits, r_size), mesh)
        theta_inits = shard_leading(pad_to_multiple(theta_inits, r_size),
                                    mesh)

    # the observation arrays ride through every jit boundary as traced
    # operands — a closure-captured dataset is baked into the HLO as
    # constants, so each replication seed's synthetic data would repay
    # the full compile instead of hitting the persistent cache (tp is the
    # static measurement grid and stays closure-side by design)
    def err_pen(nn, th, d):
        e = suppression_loss(net, nn, th, d, tp, 0.0,
                             max_steps=cfg.max_steps)
        return e, jnp.sum(nn**2)

    # in-process program cache (fit.train._PROGRAMS): the sweep closures
    # capture only (net, cfg, tp) statics — data/λ ride as operands — so
    # repeat sweeps (sensitivity maps, replications) skip the re-trace
    from conditional_ude_tpu.fit.train import _program, _times_key

    _key = (net, cfg, _times_key(tp), mesh)
    screen = _program(("sup_screen", _key, err_pen.__code__),
                      lambda: jax.jit(jax.vmap(err_pen,
                                               in_axes=(0, 0, None))))
    errs, pens = [], []
    for i in range(0, nn_inits.shape[0], cfg.screen_chunk):
        nn_c = nn_inits[i:i + cfg.screen_chunk]
        th_c = theta_inits[i:i + cfg.screen_chunk]
        m = nn_c.shape[0]
        if m < cfg.screen_chunk and i > 0:
            # pad the tail chunk to the compiled shape — a remainder-shaped
            # dispatch would repay a full XLA compile (see train._chunked_map)
            nn_c = pad_to_multiple(nn_c, cfg.screen_chunk)
            th_c = pad_to_multiple(th_c, cfg.screen_chunk)
        e, p = screen(nn_c, th_c, data)
        errs.append(e[:m])
        pens.append(p[:m])
    errs, pens = jnp.concatenate(errs), jnp.concatenate(pens)
    if errs.shape[0] != g_orig:
        # mesh-padded lanes replicate the last real init — mask them out
        # so duplicates cannot occupy several top-k refinement slots
        errs = errs.at[g_orig:].set(jnp.inf)

    # per-λ top-k on err + λ·pen (the screen ran once)
    losses = errs[None, :] + lambdas[:, None] * pens[None, :]   # [L, G]
    losses = jnp.where(jnp.isfinite(losses), losses, jnp.inf)
    top = jnp.argsort(losses, axis=1)[:, : cfg.select_best_n]   # [L, R]

    flat = top.reshape(-1)                                      # [L*R]
    nn_c, th_c = nn_inits[flat], theta_inits[flat]
    lam_lane = jnp.repeat(lambdas, cfg.select_best_n)           # [L*R]
    lanes_orig = flat.shape[0]
    if r_size:
        nn_c = shard_leading(pad_to_multiple(nn_c, r_size), mesh)
        th_c = shard_leading(pad_to_multiple(th_c, r_size), mesh)
        lam_lane = shard_leading(pad_to_multiple(lam_lane, r_size), mesh)
    lanes = nn_c.shape[0]
    p_nn = nn_inits.shape[-1]

    def loss(nn, th, lam, d):
        return suppression_loss(net, nn, th, d, tp, lam,
                                max_steps=cfg.max_steps)

    # keep per-dispatch work at the single-λ level: scale the iteration
    # chunk down by the lane blow-up
    chunk = max(1, cfg.dispatch_chunk * cfg.select_best_n // lanes)

    def adam_chunk(nn, th, lam, state, d, iters):
        res = adam_minimize(lambda p: loss(p["nn"], p["th"], lam, d),
                            {"nn": nn, "th": th},
                            iters=iters, lr=cfg.adam_lr, opt_state=state)
        return res.x["nn"], res.x["th"], res.opt_state, res.loss_trace

    run_adam = _program(
        ("sup_adam", _key, adam_chunk.__code__),
        lambda: jax.jit(jax.vmap(adam_chunk,
                                 in_axes=(0, 0, 0, 0, None, None)),
                        static_argnums=5))
    state = jax.vmap(
        lambda nn, th: optax.adam(cfg.adam_lr).init({"nn": nn, "th": th})
    )(nn_c, th_c)
    traces = [jnp.zeros((lanes, 0), jnp.float32)]
    done = 0
    while done < cfg.adam_iters:
        step = min(chunk, cfg.adam_iters - done)
        nn_c, th_c, state, tr = run_adam(nn_c, th_c, lam_lane, state,
                                         data, step)
        jax.block_until_ready(th_c)
        traces.append(tr)
        done += step
    traces = jnp.concatenate(traces, axis=1)

    # the curvature history threads through the chunks (``init_state``),
    # so the dispatch-chunk size — scaled down here to bound per-dispatch
    # runtime — never changes the optimization trajectory
    def lbfgs_chunk(nn, th, lam, state, d, iters):
        x0 = jnp.concatenate([nn, th])
        res = lbfgs_minimize(lambda x: loss(x[:p_nn], x[p_nn:], lam, d),
                             x0, max_iters=iters, init_state=state)
        return res.x[:p_nn], res.x[p_nn:], res.fval, res.state

    run_lbfgs = _program(
        ("sup_lbfgs", _key, p_nn, lbfgs_chunk.__code__),
        lambda: jax.jit(jax.vmap(lbfgs_chunk,
                                 in_axes=(0, 0, 0, 0, None, None)),
                        static_argnums=5))
    objs = None
    lb_state = None
    done = 0
    while done < cfg.lbfgs_iters:
        step = min(chunk, cfg.lbfgs_iters - done)
        nn_c, th_c, objs, lb_state = run_lbfgs(nn_c, th_c, lam_lane,
                                               lb_state, data, step)
        jax.block_until_ready(objs)
        done += step
    if objs is None:
        objs = jax.jit(jax.vmap(loss, in_axes=(0, 0, 0, None)))(
            nn_c, th_c, lam_lane, data)

    def unflat(a):
        # drop mesh-padded lanes before the (λ, restart) axes re-form
        return a[:lanes_orig].reshape(n_lam, cfg.select_best_n,
                                      *a.shape[1:])

    objs_l = unflat(objs)
    order = jnp.argsort(
        jnp.where(jnp.isfinite(objs_l), objs_l, jnp.inf), axis=1)
    take = jax.vmap(lambda a, o: a[o])
    return SuppressionFit(nn_params=take(unflat(nn_c), order),
                          thetas=take(unflat(th_c), order),
                          objectives=take(objs_l, order),
                          loss_traces=take(unflat(traces), order))


from functools import partial


@partial(jax.jit, static_argnums=(0,))
def _validate_best_init(net, nn_params, data, tp, theta_inits):
    def loss(th):
        return suppression_loss(net, nn_params, th, data, tp, 0.0)

    losses = jax.vmap(loss)(theta_inits)
    best = jnp.argmin(jnp.where(jnp.isfinite(losses), losses, jnp.inf))
    return theta_inits[best]


@partial(jax.jit, static_argnums=(0, 5))
def _validate_lbfgs_chunk(net, nn_params, theta, data, tp, iters,
                          state=None):
    def loss(th):
        return suppression_loss(net, nn_params, th, data, tp, 0.0)

    res = lbfgs_minimize(loss, theta, max_iters=iters, init_state=state)
    return res.x, res.fval, res.state


def validate_suppression(
    net: MLP,
    nn_params: jax.Array,
    data: jax.Array,
    timepoints: jax.Array,
    theta_inits: jax.Array,      # [n_init, N] candidate θ vectors
    lbfgs_iters: int = 2000,
    chunk: int = 250,
):
    """θ-only re-fit with frozen NN from the best of random inits
    (reference ``validate_suppression_model``, :179-222).

    Returns (theta[N], objective).  The L-BFGS runs as bounded-runtime
    chunks (curvature history threaded through, so chunking never changes
    the result); the chunk bounds each dispatch's runtime.  ``nn_params``
    may carry a leading restart axis ([R, P]):
    the whole restart population validates in one batched pass.
    """
    data = jnp.asarray(data, jnp.float32)
    tp = jnp.asarray(timepoints, jnp.float32)
    chunk = max(1, min(chunk, lbfgs_iters))

    # data / theta_inits ride as jit operands in the batched wrappers too
    # (closure-captured arrays become HLO constants and defeat the compile
    # caches across replication seeds); tp is the static measurement grid
    batched = nn_params.ndim == 2
    if batched:
        best = jax.jit(jax.vmap(
            lambda nn, d, th_i: _validate_best_init(net, nn, d, tp, th_i),
            in_axes=(0, None, None)))(nn_params, data, theta_inits)

        def make_step(iters):
            return jax.jit(jax.vmap(
                lambda nn, th, st, d: _validate_lbfgs_chunk(
                    net, nn, th, d, tp, iters, st),
                in_axes=(0, 0, 0, None)))
    else:
        best = _validate_best_init(net, nn_params, data, tp, theta_inits)

        def make_step(iters):
            return lambda nn, th, st, d: _validate_lbfgs_chunk(
                net, nn, th, d, tp, iters, st)

    theta, obj, st = best, None, None
    done = 0
    # memoize the jitted step per iters value: a fresh jit(vmap(...))
    # wrapper per loop iteration would re-trace every dispatch (in-memory
    # jit caches are per wrapper object) — at most 2 distinct sizes live
    # here (full chunk + tail)
    steps: dict[int, Any] = {}
    while done < lbfgs_iters:
        # size the LAST dispatch to the remaining budget — a fixed-size
        # tail would overrun lbfgs_iters and change the result whenever
        # chunk does not divide it (at most 2 distinct compiled sizes)
        step_iters = min(chunk, lbfgs_iters - done)
        if step_iters not in steps:
            steps[step_iters] = make_step(step_iters)
        theta, obj, st = steps[step_iters](nn_params, theta, st, data)
        jax.block_until_ready(obj)
        done += step_iters
    return theta, obj


def _sigma_nll(net: MLP, nn_params, data_one, tp):
    """Per-state Gaussian NLL for one individual as a function of
    x = [θ, σ₁..σ₃] (reference ``validate_suppression_model_sigma``,
    :224-275)."""
    rhs = make_ude_rhs(net)
    n_t = data_one.shape[1]

    from conditional_ude_tpu.ops.rk4 import solve_rk4

    def nll(x):
        theta, sigmas = x[0], x[1:]
        res = solve_rk4(rhs, data_one[:, 0], (nn_params, theta), tp,
                        t0=tp[0], substeps=8)
        sims = res.ys.T                                  # [3, T]
        err = jnp.sum((sims - data_one) ** 2, axis=1)    # per state
        val = jnp.sum((n_t / 2.0) * jnp.log(sigmas**2)
                      + err / (2.0 * sigmas**2))
        return jnp.where(res.success, val, jnp.inf)

    return nll


@partial(jax.jit, static_argnums=(0, 5))
def validate_suppression_sigma(
    net: MLP,
    nn_params: jax.Array,
    data_one: jax.Array,        # [3, T] a single individual
    timepoints: jax.Array,
    theta_inits: jax.Array,     # [n_init] scalar θ candidates
    lbfgs_iters: int = 2000,
):
    """Per-individual (θ, σ₁..σ₃) fit; returns (x[4], nll)."""
    data_one = jnp.asarray(data_one, jnp.float32)
    tp = jnp.asarray(timepoints, jnp.float32)
    nll = _sigma_nll(net, nn_params, data_one, tp)

    def init_loss(th):
        return nll(jnp.concatenate([th[None], jnp.ones(3)]))

    losses = jax.vmap(init_loss)(theta_inits)
    best = jnp.argmin(jnp.where(jnp.isfinite(losses), losses, jnp.inf))
    x0 = jnp.concatenate([theta_inits[best][None], jnp.ones(3)])
    res = lbfgs_minimize(nll, x0, max_iters=lbfgs_iters)
    return res.x, res.fval


def validate_suppression_sigma_batch(
    net: MLP,
    nn_params: jax.Array,
    data: jax.Array,            # [N, 3, T] whole test population
    timepoints: jax.Array,
    theta_inits: jax.Array,     # [n_init] shared scalar θ candidates
    lbfgs_iters: int = 2000,
    dispatch_chunk: int = 250,
):
    """Batched per-individual (θ, σ) fits: the reference's serial loop over
    60 fresh test subjects (``suppression/figures.jl:42-58``) as one vmap,
    the L-BFGS run split into ``dispatch_chunk``-iteration dispatches that
    bound each dispatch's runtime (as in ``fit_suppression``).

    Returns (x[N, 4], nll[N])."""
    data = jnp.asarray(data, jnp.float32)
    tp = jnp.asarray(timepoints, jnp.float32)

    # nn_params / data / theta_inits are jit OPERANDS so each replication
    # seed's fit and fresh test data reuse the compiled programs (a
    # closure-captured array is an HLO constant and defeats both the
    # in-process and persistent caches); tp is the static measurement grid
    @jax.jit
    def screen(d, nn_p, th_inits):
        def one(d_one):
            nll = _sigma_nll(net, nn_p, d_one, tp)

            def init_loss(th):
                return nll(jnp.concatenate([th[None], jnp.ones(3)]))

            losses = jax.vmap(init_loss)(th_inits)
            best = jnp.argmin(jnp.where(jnp.isfinite(losses), losses,
                                        jnp.inf))
            return jnp.concatenate([th_inits[best][None], jnp.ones(3)])

        return jax.vmap(one)(d)

    @partial(jax.jit, static_argnums=2)
    def refine(x0s, d, iters, state, nn_p):
        def one(x0, d_one, st):
            res = lbfgs_minimize(_sigma_nll(net, nn_p, d_one, tp), x0,
                                 max_iters=iters, init_state=st)
            return res.x, res.fval, res.state

        return jax.vmap(one)(x0s, d, state)

    xs = screen(data, nn_params, theta_inits)
    nlls = None
    st = None
    done = 0
    while done < lbfgs_iters:
        step = min(max(1, dispatch_chunk), lbfgs_iters - done)
        xs, nlls, st = refine(xs, data, step, st, nn_params)
        jax.block_until_ready(nlls)
        done += step
    if nlls is None:
        nlls = jax.jit(jax.vmap(
            lambda x, d, nn_p: _sigma_nll(net, nn_p, d, tp)(x),
            in_axes=(0, 0, None)))(xs, data, nn_params)
    return xs, nlls

"""Multi-start training engine: conditional pipeline on a synthetic cohort
with known ground truth."""

import jax
import jax.numpy as jnp
import numpy as np

from conditional_ude_tpu.fit.train import (
    TrainConfig,
    evaluate_model,
    fit_betas,
    fit_betas_sigma,
    select_best,
    train_conditional,
)
from conditional_ude_tpu.models.cpeptide import (
    CPeptideModel,
    build_cohort,
    simulate_cohort,
)
from conditional_ude_tpu.nn import chain

import pytest

pytestmark = pytest.mark.slow


def _synthetic_conditional_cohort(rng, n=10):
    """Simulate data from a cUDE with known NN + betas, then return the
    cohort and ground truth."""
    tp = np.array([0.0, 30.0, 60.0, 90.0, 120.0])
    net = chain(4, 2, "tanh", input_dims=2)
    model = CPeptideModel(kind="conditional", net=net)
    nn_true = net.init(jax.random.key(42)) * 1.5
    betas_true = np.linspace(-1.8, -0.2, n).astype(np.float32)

    glucose = 5.0 + np.abs(rng.uniform(0, 5, (n, 5)))
    ages = rng.uniform(30, 70, n)
    placeholder = np.full((n, 5), 0.8, np.float32)
    c0 = build_cohort(glucose, tp, placeholder, ages, np.zeros(n, bool))
    res = simulate_cohort(model, nn_true, jnp.asarray(betas_true)[:, None],
                          c0)
    assert bool(res.success.all())
    data = np.asarray(res.ys[:, :, 0])
    cohort = build_cohort(glucose, tp, data, ages, np.zeros(n, bool))
    return model, net, cohort, nn_true, betas_true


def test_train_conditional_recovers_fit(rng):
    model, net, cohort, nn_true, betas_true = \
        _synthetic_conditional_cohort(rng)
    cfg = TrainConfig(initial_guesses=256, selected_initials=3,
                      adam_iters=300, lbfgs_iters=300, screen_chunk=256)
    res = train_conditional(model, cohort, jax.random.key(0), cfg)

    # a small multi-start budget won't recover the exact NN (many weight
    # settings fit equally); require a good fit of the noise-free data
    # relative to its variance
    var = float(np.var(np.asarray(cohort.cpeptide)))
    assert float(res.objectives[0]) < 0.1 * var * 5, \
        (float(res.objectives[0]), var)
    # NOTE: no β-vs-ground-truth assertion here — a freely trained NN can
    # encode individuals differently when the generating NN is only weakly
    # β-sensitive; β recovery is asserted exactly in
    # test_fit_betas_recovers_conditionals (true NN) and end-to-end in
    # test_suppression_recovery.py (strongly β-sensitive dynamics)
    assert np.isfinite(np.asarray(res.betas[0])).all()
    assert res.loss_traces.shape == (3, 300)


def test_gauge_orientation_emitted_and_invariant(rng):
    """train_conditional must emit a ±1 orientation per restart, and the
    ORIENTED β index must be gauge-invariant ACROSS RESTARTS: independently
    trained (NN, β) solutions of the same data can converge to either
    monotone gauge, but s_r · β̂_r must rank the individuals consistently
    (r02 verdict weak #5: across-seed correlation sign flips; β̂ vs β_true
    is deliberately not asserted — see the NOTE in
    test_train_conditional_recovers_fit)."""
    from scipy.stats import spearmanr

    from conditional_ude_tpu.models.cpeptide import production_orientation

    # a STRONGLY β-sensitive generating model (amplified layer-1 β-column):
    # the default synthetic's β signal is too weak for restarts to agree on
    # an ordering at all, gauge or no gauge (see the NOTE in
    # test_train_conditional_recovers_fit)
    n = 10
    tp = np.array([0.0, 30.0, 60.0, 90.0, 120.0])
    net = chain(4, 2, "tanh", input_dims=2)
    model = CPeptideModel(kind="conditional", net=net)
    nn_true = net.init(jax.random.key(42)) * 1.5
    nn_true = nn_true.at[jnp.array([1, 3, 5, 7])].multiply(3.0)
    betas_true = np.linspace(-2.2, 0.3, n).astype(np.float32)
    glucose = 5.0 + np.abs(rng.uniform(0, 5, (n, 5)))
    ages = rng.uniform(30, 70, n)
    c0 = build_cohort(glucose, tp, np.full((n, 5), 0.8, np.float32), ages,
                      np.zeros(n, bool))
    res0 = simulate_cohort(model, nn_true, jnp.asarray(betas_true)[:, None],
                           c0)
    assert bool(res0.success.all())
    cohort = build_cohort(glucose, tp, np.asarray(res0.ys[:, :, 0]), ages,
                          np.zeros(n, bool))

    cfg = TrainConfig(initial_guesses=256, selected_initials=4,
                      adam_iters=300, lbfgs_iters=300, screen_chunk=256)
    res = train_conditional(model, cohort, jax.random.key(0), cfg)

    assert res.orientations is not None
    o = np.asarray(res.orientations)
    assert o.shape == (4,) and set(np.unique(o)) <= {-1.0, 1.0}

    # gauge invariance: the best restart's ORIENTED index must rank the
    # individuals like the ORIENTED ground truth, whichever gauge training
    # converged to (measured here: ρ ≈ 0.99 with orientation −1)
    s_true = float(production_orientation(model, nn_true))
    rho = spearmanr(o[0] * np.asarray(res.betas[0, :, 0]),
                    s_true * betas_true).statistic
    assert rho > 0.9, (rho, o, np.asarray(res.objectives))


def test_fit_betas_recovers_conditionals(rng):
    model, net, cohort, nn_true, betas_true = \
        _synthetic_conditional_cohort(rng)
    betas, objs = fit_betas(model, nn_true, cohort, initial_beta=-1.0,
                            bounds=(-4.0, 1.0), lbfgs_iters=300)
    # with the true NN every subject fits to the solver-tolerance floor
    # (data generated with Tsit5 @ rtol 1e-3, refit with RK4: ~4e-3 SSE)
    assert np.all(np.asarray(objs) < 5e-3), np.asarray(objs)
    np.testing.assert_allclose(np.asarray(betas), betas_true, atol=0.05)

    b2, s2, o2 = fit_betas_sigma(model, nn_true, cohort, initial_beta=-1.0,
                                 bounds=(-4.0, 1.0), lbfgs_iters=300)
    np.testing.assert_allclose(np.asarray(b2), betas_true, atol=0.1)


def test_train_conditional_budget_edges(rng):
    """Non-divisible Adam budgets produce exact-length traces and
    lbfgs_iters=0 still returns finite objectives."""
    model, net, cohort, *_ = _synthetic_conditional_cohort(rng, n=4)
    cfg = TrainConfig(initial_guesses=16, selected_initials=2,
                      adam_iters=7, lbfgs_iters=0, dispatch_chunk=3,
                      screen_chunk=16, final_eval_tsit5=False)
    res = train_conditional(model, cohort, jax.random.key(0), cfg)
    assert res.loss_traces.shape == (2, 7)
    assert np.isfinite(np.asarray(res.objectives)).all()
    assert res.screen_losses.shape == (16,)


def test_train_conditional_two_parameters(rng):
    """The reference supports n_conditional_parameters > 1
    (``src/parameter-estimation.jl:315,356``): joint training with c = 2
    must produce [R, N, 2] betas and finite objectives."""
    n = 6
    tp = np.array([0.0, 30.0, 60.0, 90.0, 120.0])
    net = chain(4, 2, "tanh", input_dims=3)   # [ΔG, β1, β2]
    model = CPeptideModel(kind="conditional", net=net)
    glucose = 5.0 + np.abs(rng.uniform(0, 5, (n, 5)))
    ages = rng.uniform(30, 70, n)
    nn_true = net.init(jax.random.key(5)) * 1.5
    betas_true = jnp.asarray(
        rng.uniform(-1.5, -0.5, (n, 2)).astype(np.float32))
    c0 = build_cohort(glucose, tp, np.full((n, 5), 0.8, np.float32), ages,
                      np.zeros(n, bool))
    res0 = simulate_cohort(model, nn_true, betas_true, c0)
    assert bool(res0.success.all())
    cohort = build_cohort(glucose, tp, np.asarray(res0.ys[:, :, 0]), ages,
                          np.zeros(n, bool))

    cfg = TrainConfig(initial_guesses=64, selected_initials=2,
                      adam_iters=120, lbfgs_iters=120, n_conditional=2,
                      screen_chunk=64)
    res = train_conditional(model, cohort, jax.random.key(1), cfg)
    assert res.betas.shape == (2, n, 2)
    assert np.isfinite(float(res.objectives[0]))
    var = float(np.var(np.asarray(cohort.cpeptide)))
    assert float(res.objectives[0]) < var * 5


def test_initial_designs_per_dimension_lhs(rng):
    """Multi-conditional initial designs must sample every
    (individual, conditional-dim) pair independently — a repeated single
    draw (the round-1 regression) collapses the design space
    (``src/parameter-estimation.jl:36-38``)."""
    from conditional_ude_tpu.fit.train import initial_designs

    net = chain(4, 2, "tanh", input_dims=3)
    cfg = TrainConfig(initial_guesses=64, n_conditional=2,
                      lhs_lower=-2.0, lhs_upper=0.0)
    _, betas = initial_designs(net, 5, jax.random.key(3), cfg, seed=11)
    b = np.asarray(betas)
    assert b.shape == (64, 5, 2)
    # the two conditional dims of the same individual must differ
    assert np.abs(b[:, :, 0] - b[:, :, 1]).max() > 0.1
    # LHS stratification: each scalar dimension's variance matches the
    # uniform variance (range²/12) within a loose factor
    var = b.reshape(64, -1).var(axis=0)
    uni = (2.0**2) / 12.0
    assert np.all(var > 0.5 * uni) and np.all(var < 1.5 * uni), var
    # and its marginals cover the range (LHS guarantees one point/stratum)
    assert b.min() >= -2.0 and b.max() <= 0.0
    assert np.all(b.reshape(64, -1).min(axis=0) < -1.8)
    assert np.all(b.reshape(64, -1).max(axis=0) > -0.2)


def test_evaluate_model_prefers_true_weights(rng):
    model, net, cohort, nn_true, betas_true = \
        _synthetic_conditional_cohort(rng)
    # candidate 0 = true weights, candidate 1 = random weights
    candidates = jnp.stack([nn_true, net.init(jax.random.key(7))])
    betas_train = jnp.tile(jnp.asarray(betas_true)[None, :, None], (2, 1, 1))
    objs = evaluate_model(model, candidates, betas_train, cohort,
                          lbfgs_iters=200)
    assert select_best(np.asarray(objs)) == 0


def test_train_conditional_dispatch_chunking_is_invisible(rng):
    """N bounded-runtime dispatches must equal one uninterrupted run
    bit-for-bit: the Adam optimizer state and the L-BFGS curvature history
    (ops/lbfgs.py::LBFGSState) both thread through the chunks, so
    dispatch_chunk — a per-dispatch runtime bound — can never change the
    trained model."""
    model, net, cohort, _, _ = _synthetic_conditional_cohort(rng)
    base = dict(initial_guesses=32, selected_initials=2,
                adam_iters=60, lbfgs_iters=60, screen_chunk=32)
    one = train_conditional(model, cohort, jax.random.key(3),
                            TrainConfig(**base, dispatch_chunk=60))
    chunked = train_conditional(model, cohort, jax.random.key(3),
                                TrainConfig(**base, dispatch_chunk=25))
    np.testing.assert_array_equal(np.asarray(one.nn_params),
                                  np.asarray(chunked.nn_params))
    np.testing.assert_array_equal(np.asarray(one.betas),
                                  np.asarray(chunked.betas))
    np.testing.assert_array_equal(np.asarray(one.objectives),
                                  np.asarray(chunked.objectives))


def test_train_program_cache_reuses_across_calls(rng):
    """Round 5: train_conditional's jitted stage programs join an
    in-process cache keyed on every captured static (model/cfg/times/mesh),
    because re-tracing — not compute — dominated repeat-call wall-clock
    (multi-seed sweeps re-traced identical programs every call).  A repeat
    call with the same statics must add ZERO new programs and reproduce
    the first call bit-for-bit; a same-shape different-data call must also
    reuse the programs (data rides through as traced operands) while
    producing different numbers."""
    import conditional_ude_tpu.fit.train as T

    tp = np.array([0.0, 60.0, 120.0])

    def mk(seed):
        r = np.random.default_rng(seed)
        m = 6
        return build_cohort(5 + r.uniform(0, 5, (m, 3)), tp,
                            0.5 + r.uniform(0, 1.5, (m, 3)),
                            r.uniform(30, 70, m), np.zeros(m, bool))

    net = chain(4, 2, "tanh", input_dims=2)
    model = CPeptideModel(kind="conditional", net=net)
    cfg = T.TrainConfig(initial_guesses=16, selected_initials=2,
                        adam_iters=5, lbfgs_iters=5, screen_chunk=16)
    c1, c2 = mk(1), mk(2)

    r1 = T.train_conditional(model, c1, jax.random.key(0), cfg)
    jax.block_until_ready(r1.objectives)
    n_programs = len(T._PROGRAMS)

    r1b = T.train_conditional(model, c1, jax.random.key(0), cfg)
    r2 = T.train_conditional(model, c2, jax.random.key(0), cfg)
    jax.block_until_ready(r2.objectives)
    assert len(T._PROGRAMS) == n_programs, "repeat call re-built programs"
    np.testing.assert_array_equal(np.asarray(r1.objectives),
                                  np.asarray(r1b.objectives))
    assert not np.array_equal(np.asarray(r1.objectives),
                              np.asarray(r2.objectives))

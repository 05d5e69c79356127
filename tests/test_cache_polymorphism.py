"""Data-polymorphic compile-cache invariant, checked at the API level.

Every fit/analysis program must take its data arrays as traced jit
operands — never closure captures — so the compiled HLO (and the
persistent-compile-cache key) is independent of the data bytes and a new
same-shape cohort/seed reuses every compiled program.  These tests point
the persistent cache at a fresh directory, run each surface twice with
different data of identical shape, and assert the second run adds ZERO
cache entries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conditional_ude_tpu.models.cpeptide import CPeptideModel, build_cohort
from conditional_ude_tpu.nn import chain


def _entries(path):
    return sorted(p.name for p in path.iterdir())


@pytest.fixture
def cache_dir(tmp_path):
    """Fresh persistent compile cache for the duration of one test.

    The cache backend initializes lazily ONCE per process, so changing the
    directory config alone is ignored after first use — ``reset_cache()``
    forces re-initialization against this test's directory."""
    from jax.experimental.compilation_cache import compilation_cache as cc

    cc.reset_cache()
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    try:
        yield tmp_path
    finally:
        cc.reset_cache()
        jax.config.update("jax_compilation_cache_dir", None)


def _cohort(seed: int, n: int = 3):
    rng = np.random.default_rng(seed)
    tp = np.array([0.0, 30.0, 60.0, 90.0, 120.0], np.float32)
    glucose = (5.0 + rng.uniform(0, 5, (n, 5))).astype(np.float32)
    cpeptide = (0.5 + rng.uniform(0, 1.5, (n, 5))).astype(np.float32)
    ages = rng.uniform(30, 70, n).astype(np.float32)
    return build_cohort(glucose, tp, cpeptide, ages, np.zeros(n, bool))


def _assert_second_run_hits_cache(run, cache_dir):
    run(0)
    first = _entries(cache_dir)
    assert first, "first run wrote no cache entries (test is vacuous)"
    run(1)
    second = _entries(cache_dir)
    assert second == first, (
        "a second same-shape run added persistent-cache entries — data "
        f"leaked into a compiled program as constants: "
        f"{sorted(set(second) - set(first))}")


def test_train_conditional_is_data_polymorphic(cache_dir):
    from conditional_ude_tpu.fit.train import TrainConfig, train_conditional

    net = chain(3, 2, "tanh", input_dims=2)
    model = CPeptideModel(kind="conditional", net=net)
    cfg = TrainConfig(initial_guesses=8, selected_initials=2,
                      adam_iters=4, lbfgs_iters=4, max_steps=64,
                      screen_chunk=8, final_eval_tsit5=False)

    def run(seed):
        res = train_conditional(model, _cohort(seed), jax.random.key(0),
                                cfg)
        jax.block_until_ready(res.objectives)

    _assert_second_run_hits_cache(run, cache_dir)


def test_train_ude_is_data_polymorphic(cache_dir):
    from conditional_ude_tpu.fit.train import train_ude

    net = chain(3, 2, "tanh", input_dims=1)
    model = CPeptideModel(kind="ude", net=net)

    def run(seed):
        cohort = _cohort(seed, n=1)
        nn_fit, objs, _ = train_ude(
            model, cohort.individual(0), cohort.timepoints,
            cohort.cpeptide[0], jax.random.key(0), initial_guesses=8,
            selected_initials=2, adam_iters=4, lbfgs_iters=4,
            max_steps=64, screen_chunk=8)
        jax.block_until_ready(objs)

    _assert_second_run_hits_cache(run, cache_dir)


def test_profiles_are_data_polymorphic(cache_dir):
    from conditional_ude_tpu.analysis.profiles import cohort_beta_profiles

    net = chain(3, 2, "tanh", input_dims=2)
    model = CPeptideModel(kind="conditional", net=net)

    def run(seed):
        nn = net.init_batch(jax.random.key(seed), 2)[seed % 2]
        prof = cohort_beta_profiles(model, nn, _cohort(seed),
                                    steps=64, chunk=32)
        jax.block_until_ready(prof.values)

    _assert_second_run_hits_cache(run, cache_dir)


def test_evaluate_model_is_data_polymorphic(cache_dir):
    from conditional_ude_tpu.fit.train import evaluate_model

    net = chain(3, 2, "tanh", input_dims=2)
    model = CPeptideModel(kind="conditional", net=net)

    def run(seed):
        cands = net.init_batch(jax.random.key(seed), 2)
        b_train = jnp.full((2, 3, 1), -1.0 - 0.1 * seed, jnp.float32)
        objs = evaluate_model(model, cands, b_train, _cohort(seed),
                              lbfgs_iters=4, max_steps=64)
        jax.block_until_ready(objs)

    _assert_second_run_hits_cache(run, cache_dir)


def test_suppression_fit_and_validate_are_data_polymorphic(cache_dir):
    from conditional_ude_tpu.models.suppression import (
        SuppressionFitConfig,
        fit_suppression,
        generate_data,
        suppression_net,
        validate_suppression,
    )

    net = suppression_net(depth=3, width=3)
    tp = np.linspace(0.0, 30.0, 6)
    cfg = SuppressionFitConfig(initial_space=8, select_best_n=2,
                               adam_iters=4, lbfgs_iters=4,
                               max_steps=64, screen_chunk=8,
                               dispatch_chunk=2)

    def run(seed):
        rng = np.random.default_rng(seed)
        data, _ = generate_data([0.5, 5.0], [2, 2], tp,
                                noise_multiplicative=0.05, rng=rng)
        fit = fit_suppression(net, data, tp, jax.random.key(0), lam=0.01,
                              config=cfg)
        theta_inits = jnp.asarray(
            rng.uniform(size=(4, data.shape[0])), jnp.float32)
        theta, obj = validate_suppression(net, fit.nn_params, data, tp,
                                          theta_inits, lbfgs_iters=4,
                                          chunk=2)
        jax.block_until_ready(obj)

    _assert_second_run_hits_cache(run, cache_dir)


def test_fit_k_sigma_is_data_polymorphic(cache_dir):
    from conditional_ude_tpu.models.symbolic import fit_k_sigma

    def run(seed):
        ks, sigmas, objs = fit_k_sigma(_cohort(seed), lbfgs_iters=4,
                                       solver_max_steps=64,
                                       dispatch_chunk=2)
        jax.block_until_ready(objs)

    _assert_second_run_hits_cache(run, cache_dir)


def test_mesh_train_conditional_is_data_polymorphic(cache_dir):
    """The sharded training path (2-device virtual ``("restarts",)`` mesh,
    restart count padded to the axis) keeps its data out of the compiled
    programs too."""
    from conditional_ude_tpu.fit.train import TrainConfig, train_conditional
    from conditional_ude_tpu.parallel import make_mesh

    net = chain(4, 2, "tanh", input_dims=2)
    model = CPeptideModel(kind="conditional", net=net)
    mesh = make_mesh(("restarts",), (2,), jax.devices()[:2])
    cfg = TrainConfig(initial_guesses=8, selected_initials=3,
                      adam_iters=2, lbfgs_iters=2, substeps=2,
                      max_steps=64, screen_chunk=8, final_eval_tsit5=False)

    def run(seed):
        res = train_conditional(model, _cohort(seed, n=4),
                                jax.random.key(0), cfg, mesh=mesh)
        jax.block_until_ready(res.objectives)

    _assert_second_run_hits_cache(run, cache_dir)

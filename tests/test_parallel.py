"""Mesh sharding: construction, padding, sharded training parity."""

import jax
import jax.numpy as jnp
import numpy as np

from conditional_ude_tpu.parallel import (
    make_mesh,
    pad_to_multiple,
    shard_cohort,
    shard_leading,
)

import pytest

pytestmark = pytest.mark.slow


def test_make_mesh_shapes():
    mesh = make_mesh(("restarts",))
    assert mesh.shape["restarts"] == 8
    mesh2 = make_mesh(("restarts", "individuals"), (4, 2))
    assert mesh2.shape == {"restarts": 4, "individuals": 2}


def test_pad_to_multiple():
    x = jnp.arange(10.0).reshape(5, 2)
    p = pad_to_multiple(x, 4)
    assert p.shape == (8, 2)
    np.testing.assert_allclose(p[5:], np.tile(np.asarray(x[4]), (3, 1)))
    q = pad_to_multiple(x, 5)
    assert q.shape == (5, 2)


def test_sharded_loss_matches_unsharded(rng):
    from conditional_ude_tpu.fit.losses import population_sse
    from conditional_ude_tpu.models.cpeptide import CPeptideModel, build_cohort
    from conditional_ude_tpu.nn import chain

    n = 8
    tp = np.array([0.0, 30.0, 60.0, 90.0, 120.0])
    glucose = 5.0 + rng.uniform(0, 5, (n, 5))
    cpeptide = 0.5 + rng.uniform(0, 1.5, (n, 5))
    cohort = build_cohort(glucose, tp, cpeptide, rng.uniform(30, 70, n),
                          np.zeros(n, bool))
    net = chain(4, 2, "tanh", input_dims=2)
    model = CPeptideModel(kind="conditional", net=net)
    nn = net.init(jax.random.key(0))
    betas = jnp.full((n,), -1.0)

    plain = population_sse(model, nn, betas, cohort)

    mesh = make_mesh(("individuals",))
    sharded_cohort = shard_cohort(cohort, mesh, "individuals")
    sharded_betas = shard_leading(betas, mesh, "individuals")
    sharded = jax.jit(
        lambda b, c: population_sse(model, nn, b, c))(sharded_betas,
                                                      sharded_cohort)
    np.testing.assert_allclose(float(plain), float(sharded), rtol=5e-3)


def test_saem_sharded_matches_unsharded(rng):
    """SAEM over an individuals-sharded cohort: XLA partitions the vmapped
    MCMC kernel and inserts the collectives for the population-NLL sums;
    results must match the single-device run to float noise."""
    from conditional_ude_tpu.fit.saem import SAEMConfig, saem_cude
    from conditional_ude_tpu.models.cpeptide import CPeptideModel, build_cohort
    from conditional_ude_tpu.nn import chain

    n = 8
    tp = np.array([0.0, 30.0, 60.0, 90.0, 120.0])
    cohort = build_cohort(5 + rng.uniform(0, 5, (n, 5)), tp,
                          0.5 + rng.uniform(0, 1.5, (n, 5)),
                          rng.uniform(30, 70, n), np.zeros(n, bool))
    net = chain(4, 2, "tanh", input_dims=2)
    model = CPeptideModel(kind="conditional", net=net)
    nn0 = net.init(jax.random.key(0))
    cfg = SAEMConfig(iterations=4, burnin=2, n_mcmc_steps=2)

    plain = saem_cude(model, cohort, nn0, jax.random.key(1), cfg)
    mesh = make_mesh(("individuals",))
    sharded = saem_cude(model, shard_cohort(cohort, mesh, "individuals"),
                        nn0, jax.random.key(1), cfg)
    np.testing.assert_allclose(np.asarray(sharded.nll_trace),
                               np.asarray(plain.nll_trace), atol=1e-4)
    np.testing.assert_allclose(np.asarray(sharded.theta),
                               np.asarray(plain.theta), atol=1e-5)


def _synthetic_cohort(rng, n):
    from conditional_ude_tpu.models.cpeptide import CPeptideModel, build_cohort
    from conditional_ude_tpu.nn import chain

    tp = np.array([0.0, 30.0, 60.0, 90.0, 120.0])
    cohort = build_cohort(5 + rng.uniform(0, 5, (n, 5)), tp,
                          0.5 + rng.uniform(0, 1.5, (n, 5)),
                          rng.uniform(30, 70, n), np.zeros(n, bool))
    net = chain(4, 2, "tanh", input_dims=2)
    model = CPeptideModel(kind="conditional", net=net)
    return model, net, cohort


def test_train_conditional_mesh_parity_realistic_shape(rng):
    """``train_conditional`` on a 2D (restarts × individuals) mesh at the
    production cohort shape (82 fit individuals, 32 restarts screened from
    256 designs) must reproduce the single-device objectives.  Round-1 only
    smoke-validated 8 individuals / 2-iteration refinement."""
    from conditional_ude_tpu.fit.train import TrainConfig, train_conditional

    model, net, cohort = _synthetic_cohort(rng, 82)
    cfg = TrainConfig(initial_guesses=256, selected_initials=8,
                      adam_iters=5, lbfgs_iters=5, screen_chunk=256,
                      final_eval_tsit5=False)
    plain = train_conditional(model, cohort, jax.random.key(3), cfg)

    mesh = make_mesh(("restarts", "individuals"), (4, 2))
    sharded = train_conditional(model, cohort, jax.random.key(3), cfg,
                                mesh=mesh)
    np.testing.assert_allclose(np.asarray(sharded.screen_losses),
                               np.asarray(plain.screen_losses), rtol=2e-3)
    np.testing.assert_allclose(np.sort(np.asarray(sharded.objectives)),
                               np.sort(np.asarray(plain.objectives)),
                               rtol=5e-3)


def test_sharded_fit_betas_parity(rng):
    """β (and β+σ) re-estimation sharded over the population axis matches
    the single-device fit — including a cohort size that does NOT divide
    the mesh axis (padding path)."""
    from conditional_ude_tpu.fit.train import fit_betas, fit_betas_sigma
    from conditional_ude_tpu.parallel import sharded_fit_betas

    model, net, cohort = _synthetic_cohort(rng, 11)   # 11 % 8 != 0
    nn = net.init(jax.random.key(5))
    mesh = make_mesh(("individuals",))

    b0, o0 = map(np.asarray, fit_betas(model, nn, cohort,
                                       lbfgs_iters=60))
    b1, o1 = map(np.asarray, sharded_fit_betas(model, nn, cohort, mesh,
                                               lbfgs_iters=60))
    assert b1.shape == (11,)
    # partitioned execution reorders float reductions inside the L-BFGS
    # iterations, so parity is tight but not bitwise
    np.testing.assert_allclose(b1, b0, atol=2e-3)
    np.testing.assert_allclose(o1, o0, rtol=2e-3, atol=1e-5)

    bs0, ss0, os0 = map(np.asarray, fit_betas_sigma(model, nn, cohort,
                                                    lbfgs_iters=60))
    bs1, ss1, os1 = map(np.asarray, sharded_fit_betas(
        model, nn, cohort, mesh, sigma=True, lbfgs_iters=60))
    np.testing.assert_allclose(bs1, bs0, atol=2e-3)
    np.testing.assert_allclose(ss1, ss0, atol=2e-3)


def test_sharded_beta_profiles_parity(rng):
    """Cohort profile scans sharded over individuals (with per-subject Δβ
    centers) match the single-device scan."""
    from conditional_ude_tpu.analysis import cohort_beta_profiles
    from conditional_ude_tpu.parallel import sharded_beta_profiles

    model, net, cohort = _synthetic_cohort(rng, 6)    # 6 % 8 != 0
    nn = net.init(jax.random.key(6))
    centers = jnp.linspace(-1.5, -0.5, 6)
    mesh = make_mesh(("individuals",))

    p0 = cohort_beta_profiles(model, nn, cohort, lower=-2.0, upper=2.0,
                              steps=64, center=centers)
    p1 = sharded_beta_profiles(model, nn, cohort, mesh, lower=-2.0,
                               upper=2.0, steps=64, center=centers)
    assert p1.values.shape == (6, 64)
    np.testing.assert_allclose(np.asarray(p1.values),
                               np.asarray(p0.values), rtol=1e-4)


def test_checkpoint_roundtrip(tmp_path):
    from conditional_ude_tpu.utils.checkpoint import (
        cached,
        load_checkpoint,
        save_checkpoint,
    )

    arrays = {"a": np.arange(6.0).reshape(2, 3), "b": np.float32(3.5)}
    save_checkpoint(tmp_path / "ck.npz", arrays, {"note": "x"})
    loaded, meta = load_checkpoint(tmp_path / "ck.npz")
    np.testing.assert_allclose(loaded["a"], arrays["a"])
    assert meta["note"] == "x"

    calls = []

    def compute():
        calls.append(1)
        return {"v": np.ones(3)}

    r1 = cached(tmp_path / "c.npz", compute)
    r2 = cached(tmp_path / "c.npz", compute)
    assert len(calls) == 1
    np.testing.assert_allclose(r1["v"], r2["v"])
    cached(tmp_path / "c.npz", compute, retrain=True)
    assert len(calls) == 2

    # bare paths (no .npz suffix): np.savez appends one — the cache must
    # still hit on the second call instead of recomputing forever
    calls.clear()
    cached(tmp_path / "bare", compute)
    cached(tmp_path / "bare", compute)
    assert len(calls) == 1
    loaded, _ = load_checkpoint(tmp_path / "bare")
    np.testing.assert_allclose(loaded["v"], np.ones(3))


def test_suppression_sweep_mesh_parity():
    """The λ-sweep sharded over a "restarts" mesh axis must reproduce the
    single-device sweep — including lane counts (initial space AND the
    flattened λ×restart refinement lanes) that do NOT divide the mesh
    axis, exercising the pad-and-slice path."""
    from conditional_ude_tpu.models.suppression import (
        SuppressionFitConfig,
        fit_suppression_sweep,
        generate_data,
        suppression_net,
    )

    rng = np.random.default_rng(11)
    tp = np.linspace(0.0, 30.0, 6)
    data, _ = generate_data([0.5, 5.0, 12.5], [2] * 3, tp,
                            noise_multiplicative=0.05, rng=rng)
    net = suppression_net(depth=3, width=3)
    lambdas = np.asarray([0.0, 0.1], np.float32)
    cfg = SuppressionFitConfig(initial_space=36,   # 36 % 8 != 0
                               select_best_n=3,    # 2*3=6 lanes, 6 % 8 != 0
                               adam_iters=20, lbfgs_iters=20,
                               max_steps=128, screen_chunk=36,
                               dispatch_chunk=10)

    plain = fit_suppression_sweep(net, data, tp, jax.random.key(2),
                                  lambdas, cfg)
    mesh = make_mesh(("restarts",))
    sharded = fit_suppression_sweep(net, data, tp, jax.random.key(2),
                                    lambdas, cfg, mesh=mesh)

    assert sharded.objectives.shape == plain.objectives.shape
    # partitioned lane extents change XLA's vectorization grouping, and 40
    # optimizer iterations amplify those last-ulp differences — parity here
    # is structural (no lane mixing / padding leaks), a few % numerically
    np.testing.assert_allclose(np.asarray(sharded.objectives),
                               np.asarray(plain.objectives),
                               rtol=5e-2, atol=1e-4)
    np.testing.assert_allclose(np.asarray(sharded.thetas),
                               np.asarray(plain.thetas),
                               rtol=1e-1, atol=1.5e-1)


def test_train_conditional_mesh_pads_restarts_parity(rng):
    """Refinement on a restart mesh whose axis does not divide the selected
    restart count: the k restarts pad to a multiple of the axis, refine
    sharded, and the padding is sliced off — reproducing the single-device
    run.  selected_initials=3 on the 8-device axis pads 3 -> 8."""
    from conditional_ude_tpu.fit.train import TrainConfig, train_conditional

    model, net, cohort = _synthetic_cohort(rng, 5)
    cfg = TrainConfig(initial_guesses=16, selected_initials=3,
                      adam_iters=4, lbfgs_iters=4, substeps=2,
                      screen_chunk=16, max_steps=64)
    plain = train_conditional(model, cohort, jax.random.key(7), cfg)
    mesh = make_mesh(("restarts",))
    sharded = train_conditional(model, cohort, jax.random.key(7), cfg,
                                mesh=mesh)
    assert sharded.objectives.shape == (3,)
    np.testing.assert_allclose(np.asarray(sharded.screen_losses),
                               np.asarray(plain.screen_losses), rtol=2e-3)
    np.testing.assert_allclose(np.sort(np.asarray(sharded.objectives)),
                               np.sort(np.asarray(plain.objectives)),
                               rtol=5e-3)
    np.testing.assert_allclose(np.sort(np.asarray(sharded.betas), axis=None),
                               np.sort(np.asarray(plain.betas), axis=None),
                               atol=5e-3)


def test_train_conditional_mesh_nondivisible_individuals(rng):
    """A cohort whose size does not divide the mesh 'individuals' axis must
    degrade to a replicated individuals axis (padding it would re-weight
    the population mean) and still reproduce single-device objectives."""
    from conditional_ude_tpu.fit.train import TrainConfig, train_conditional

    model, net, cohort = _synthetic_cohort(rng, 5)      # 5 % 2 != 0
    cfg = TrainConfig(initial_guesses=16, selected_initials=4,
                      adam_iters=3, lbfgs_iters=3, screen_chunk=16,
                      max_steps=64, final_eval_tsit5=False)
    plain = train_conditional(model, cohort, jax.random.key(5), cfg)
    mesh = make_mesh(("restarts", "individuals"), (4, 2))
    sharded = train_conditional(model, cohort, jax.random.key(5), cfg,
                                mesh=mesh)
    np.testing.assert_allclose(np.sort(np.asarray(sharded.objectives)),
                               np.sort(np.asarray(plain.objectives)),
                               rtol=5e-3)

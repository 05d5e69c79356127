"""Process set-up and numerics that the GPU path depends on: the compile
cache location, float32 precision of every contraction, the committed
cohort, an import without pandas, and the restart mesh's pad-and-slice."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent


def _run_python(code: str, **env) -> subprocess.CompletedProcess:
    base = {k: v for k, v in os.environ.items()
            if k != "JAX_COMPILATION_CACHE_DIR"}
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={**base, "JAX_PLATFORMS": "cpu", **env},
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("env_dir", [True, False], ids=["env_set", "unset"])
def test_compile_cache_dir(tmp_path, env_dir):
    """``JAX_COMPILATION_CACHE_DIR`` wins where it is set (and a compiled
    program lands there); otherwise the cache is ``<repo>/.jax_cache``."""
    code = ("import jax, jax.numpy as jnp\n"
            "from conditional_ude_tpu.utils.device import "
            "enable_compile_cache\n"
            "print(enable_compile_cache())\n"
            "print(jax.config.jax_persistent_cache_min_compile_time_secs)\n")
    env = {}
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "x")
        code += ("jax.jit(lambda a: a * 3 + 1)(jnp.ones(7))"
                 ".block_until_ready()\n")
    r = _run_python(code, **env)
    assert r.returncode == 0, r.stderr[-2000:]
    where, min_secs = r.stdout.split()[-2:]
    assert float(min_secs) == 0.0
    if env_dir:
        assert where == str(tmp_path / "x")
        assert any((tmp_path / "x").iterdir())
    else:
        assert Path(where) == REPO / ".jax_cache"


def _dot_precisions(jaxpr) -> list:
    """``precision`` of every dot_general in a closed jaxpr, sub-jaxprs
    (loops, conds, scans) included."""
    out = []

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params["precision"])
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jaxpr.jaxpr)
    return out


def _lbfgs_iteration():
    from conditional_ude_tpu.ops.lbfgs import lbfgs_minimize

    w = jnp.linspace(0.5, 2.0, 6)
    return jax.make_jaxpr(lambda x: lbfgs_minimize(
        lambda z: jnp.sum(w * (z - 1.0) ** 2), x, max_iters=1))(jnp.zeros(6))


def _mlp_apply_and_grad():
    from conditional_ude_tpu.nn import chain

    net = chain(4, 2, "tanh", input_dims=2)
    flat = net.init(jax.random.key(0))
    return jax.make_jaxpr(jax.value_and_grad(
        lambda p, x: jnp.sum(net.apply(p, x))))(flat, jnp.ones((3, 2)))


def _advi_step():
    from conditional_ude_tpu.fit.advi import advi

    return jax.make_jaxpr(lambda m: advi(
        lambda z: -jnp.sum(z ** 2), m, jax.random.key(0), steps=1,
        n_samples=4))(jnp.zeros(3))


@pytest.mark.parametrize("build", [_lbfgs_iteration, _mlp_apply_and_grad,
                                   _advi_step],
                         ids=["lbfgs_iteration", "mlp_apply", "advi_step"])
def test_every_contraction_is_highest_precision(build):
    precisions = _dot_precisions(build())
    assert precisions, "no dot_general found (test is vacuous)"
    highest = jax.lax.Precision.HIGHEST
    for p in precisions:
        assert p in (highest, (highest, highest)), p


def test_load_cohorts_reads_committed_npz():
    sys.path.insert(0, str(REPO / "experiments"))
    try:
        from common import load_cohorts
    finally:
        sys.path.remove(str(REPO / "experiments"))
    train, test, c_train, c_test = load_cohorts()
    assert (len(train.ages), len(test.ages)) == (82, 35)
    assert c_train.cpeptide.shape == (82, 5)
    assert c_test.cpeptide.shape == (35, 5)


def test_package_imports_without_pandas():
    r = _run_python("import sys\nsys.modules['pandas'] = None\n"
                    "import conditional_ude_tpu\n"
                    "from conditional_ude_tpu.data import load_npz\n"
                    "print('ok')")
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "ok"


def test_restart_mesh_pads_and_slices(rng):
    """5 selected restarts on a 4-device restart mesh: refinement pads to 8
    lanes sharded over the mesh and returns the 5 real restarts, matching
    the single-device run."""
    from conditional_ude_tpu.fit.train import TrainConfig, train_conditional
    from conditional_ude_tpu.models.cpeptide import CPeptideModel, build_cohort
    from conditional_ude_tpu.nn import chain
    from conditional_ude_tpu.parallel import make_mesh

    n = 3
    tp = np.array([0.0, 30.0, 60.0, 90.0, 120.0], np.float32)
    cohort = build_cohort(5.0 + rng.uniform(0, 5, (n, 5)), tp,
                          0.5 + rng.uniform(0, 1.5, (n, 5)),
                          rng.uniform(30, 70, n), np.zeros(n, bool))
    model = CPeptideModel(kind="conditional",
                          net=chain(4, 2, "tanh", input_dims=2))
    cfg = TrainConfig(initial_guesses=16, selected_initials=5,
                      adam_iters=3, lbfgs_iters=3, substeps=2, max_steps=64,
                      screen_chunk=16, final_eval_tsit5=False)
    mesh = make_mesh(("restarts",), (4,), jax.devices()[:4])
    sharded = train_conditional(model, cohort, jax.random.key(2), cfg,
                                mesh=mesh)
    plain = train_conditional(model, cohort, jax.random.key(2), cfg)
    assert sharded.objectives.shape == (5,)
    assert sharded.nn_params.shape[0] == 5
    assert sharded.timings["refine_path"] == "xla_reverse_ad+mesh"
    assert len(sharded.nn_params.sharding.device_set) == 4
    np.testing.assert_allclose(np.asarray(sharded.objectives),
                               np.asarray(plain.objectives), rtol=1e-4)

"""Batched L-BFGS: quadratics, Rosenbrock, box constraints, inf-robustness."""

import jax
import jax.numpy as jnp
import numpy as np

from conditional_ude_tpu.ops import lbfgs_minimize


def test_quadratic():
    A = jnp.diag(jnp.array([1.0, 10.0, 100.0]))
    b = jnp.array([1.0, -2.0, 3.0])

    def f(x):
        return 0.5 * x @ A @ x - b @ x

    res = lbfgs_minimize(f, jnp.zeros(3), max_iters=100)
    expected = np.linalg.solve(np.array(A), np.array(b))
    assert bool(res.converged)
    np.testing.assert_allclose(res.x, expected, rtol=1e-4, atol=1e-5)


def test_rosenbrock():
    def f(x):
        return (1 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2

    res = lbfgs_minimize(f, jnp.array([-1.2, 1.0]), max_iters=300, gtol=1e-6)
    np.testing.assert_allclose(res.x, [1.0, 1.0], atol=1e-3)


def test_box_constraints():
    # unconstrained min at (2, 2); box forces x <= 1
    def f(x):
        return jnp.sum((x - 2.0) ** 2)

    res = lbfgs_minimize(f, jnp.zeros(2), lower=jnp.array([-1.0, -1.0]),
                         upper=jnp.array([1.0, 1.0]), max_iters=100)
    np.testing.assert_allclose(res.x, [1.0, 1.0], atol=1e-5)
    assert bool(res.converged)


def test_vmapped_lanes():
    # batch of shifted quadratics, one lane per shift
    shifts = jnp.linspace(-2.0, 2.0, 8)

    def solve_one(c):
        return lbfgs_minimize(lambda x: jnp.sum((x - c) ** 2),
                              jnp.zeros(2), max_iters=50).x

    xs = jax.vmap(solve_one)(shifts)
    np.testing.assert_allclose(xs, np.array(shifts)[:, None].repeat(2, 1),
                               atol=1e-5)


def test_inf_objective_region():
    # objective returns inf outside x < 1.5; optimizer must stay in-domain
    def f(x):
        val = (x[0] - 1.0) ** 2
        return jnp.where(x[0] < 1.5, val, jnp.inf)

    res = lbfgs_minimize(f, jnp.array([0.0]), max_iters=100)
    np.testing.assert_allclose(res.x, [1.0], atol=1e-4)


def test_inf_at_start_is_safe():
    def f(x):
        return jnp.where(x[0] > 0, x[0] ** 2, jnp.inf)

    res = lbfgs_minimize(f, jnp.array([-1.0]), max_iters=50)
    assert not bool(res.converged)
    assert np.isfinite(np.array(res.x)).all()


def test_nan_gradient_is_not_spurious_convergence():
    """A finite objective whose gradient is NaN must not report converged:
    the zeroed gradient would otherwise read as a zero projected gradient."""

    @jax.custom_vjp
    def flat_nan_grad(x):
        return jnp.sum(x**2) * 0.0

    def fwd(x):
        return flat_nan_grad(x), x

    def bwd(x, g):
        return (jnp.full_like(x, jnp.nan),)

    flat_nan_grad.defvjp(fwd, bwd)

    res = lbfgs_minimize(flat_nan_grad, jnp.array([1.0, -2.0]), max_iters=20)
    assert not bool(res.converged)
    assert np.isfinite(np.array(res.x)).all()


def test_chunked_resume_matches_single_run():
    """N chunked calls threading `state` must equal one uninterrupted run
    bit-for-bit (the suppression paths rely on this to keep dispatch
    runtimes bounded without restarting the curvature history)."""
    def f(x):
        # non-trivial coupling so the history actually matters
        return ((1 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2
                + 0.5 * jnp.sum(x**2))

    x0 = jnp.array([-1.2, 1.0])
    ref = lbfgs_minimize(f, x0, max_iters=60, gtol=0.0)

    res = lbfgs_minimize(f, x0, max_iters=20, gtol=0.0)
    for _ in range(2):
        res = lbfgs_minimize(f, x0, max_iters=20, gtol=0.0,
                             init_state=res.state)
    np.testing.assert_array_equal(np.asarray(res.x), np.asarray(ref.x))
    np.testing.assert_array_equal(np.asarray(res.fval), np.asarray(ref.fval))


def test_chunked_resume_keeps_converged_lane_frozen():
    def f(x):
        return jnp.sum((x - 3.0) ** 2)

    res = lbfgs_minimize(f, jnp.zeros(2), max_iters=100)
    assert bool(res.converged)
    x_done = np.asarray(res.x)
    res2 = lbfgs_minimize(f, jnp.zeros(2), max_iters=100,
                          init_state=res.state)
    np.testing.assert_array_equal(np.asarray(res2.x), x_done)
    assert bool(res2.converged)
    assert int(res2.num_iters) == 0


def test_chunked_resume_vmapped():
    shifts = jnp.linspace(-2.0, 2.0, 4)

    def one_shot(c):
        return lbfgs_minimize(lambda x: jnp.sum((x - c) ** 4),
                              jnp.zeros(2), max_iters=40, gtol=0.0).x

    def chunked(c):
        f = lambda x: jnp.sum((x - c) ** 4)  # noqa: E731
        r = lbfgs_minimize(f, jnp.zeros(2), max_iters=10, gtol=0.0)
        for _ in range(3):
            r = lbfgs_minimize(f, jnp.zeros(2), max_iters=10, gtol=0.0,
                               init_state=r.state)
        return r.x

    np.testing.assert_array_equal(np.asarray(jax.vmap(chunked)(shifts)),
                                  np.asarray(jax.vmap(one_shot)(shifts)))


def test_wolfe_patience_counts_from_armijo_point():
    """A lane whose first Armijo step needs many halvings must still get
    its curvature bisections (the cap counts from the Armijo discovery,
    not from the start of the line search) — so convergence on a badly
    scaled objective is not degraded by a small patience."""
    def f(x):
        return 0.5 * 1e6 * x[0] ** 2 + 0.5 * x[1] ** 2

    res = lbfgs_minimize(f, jnp.array([1.0, 1.0]), max_iters=200,
                         wolfe_patience=2, gtol=1e-8)
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.x), [0.0, 0.0], atol=1e-6)

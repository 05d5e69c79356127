"""Batched L-BFGS with backtracking line search and box constraints.

The reference leans on Optim.jl's ``LBFGS(linesearch=BackTracking())`` for
every refinement stage (``src/parameter-estimation.jl:144-183``) and on its
box-constrained variant for per-individual β re-estimation (:159-168).  This
is a fixed-shape JAX re-design: the whole optimizer is a ``lax.while_loop``
over a static iteration budget with circular history buffers, so it can be
``vmap``-ed across restarts and individuals and compiled once — per-lane
convergence is handled with done-masks instead of early returns.

Box constraints use gradient projection (clip iterates into ``[lb, ub]`` and
measure convergence with the projected gradient) — a deliberate redesign of
Optim.jl's Fminbox barrier that is fixed-shape and batch-friendly; for the
scalar-β problems it reaches the same constrained minima.

Objectives may return ``inf``/``nan`` (e.g. a diverged ODE solve): such trial
points are rejected by the line search and a lane that cannot make progress
freezes rather than crashing the batch (mirrors the reference's
``try/catch``-skip at ``src/parameter-estimation.jl:234-241``).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


class LBFGSState(NamedTuple):
    """Resumable optimizer state (curvature history + current iterate).

    Returned on every ``lbfgs_minimize`` call and accepted back via
    ``init_state`` so a long run can be split into bounded-runtime
    dispatches WITHOUT restarting the inverse-Hessian history:
    chunked-with-state resumption is bit-identical to one uninterrupted run of the same
    total iteration budget.
    """

    x: jax.Array
    f: jax.Array
    g: jax.Array
    gfin: jax.Array
    S: jax.Array        # [m, p] s-history (circular)
    Y: jax.Array        # [m, p] y-history
    rho: jax.Array      # [m]
    valid: jax.Array    # [m]
    head: jax.Array
    done: jax.Array     # lane finished (converged / frozen) — stays frozen


class LBFGSResult(NamedTuple):
    x: jax.Array
    fval: jax.Array
    converged: jax.Array
    num_iters: jax.Array
    state: LBFGSState | None = None


def _dot(a, b):
    """Inner product at full float32 precision: at default precision a GPU
    may take float32 dots in TF32 (about three decimal digits), which
    corrupts the two-loop recursion, the Wolfe tests and the curvature
    pair ``s·y``."""
    return jnp.dot(a, b, precision=lax.Precision.HIGHEST)


def _project(x, lower, upper):
    if lower is not None:
        x = jnp.maximum(x, lower)
    if upper is not None:
        x = jnp.minimum(x, upper)
    return x


@partial(jax.jit, static_argnums=(0, 4, 5, 8, 9))
def lbfgs_minimize(
    fun: Callable[[jax.Array], jax.Array],
    x0: jax.Array,
    lower: jax.Array | None = None,
    upper: jax.Array | None = None,
    max_iters: int = 1000,
    history: int = 10,
    gtol: float = 1e-6,
    ftol: float = 0.0,
    max_backtracks: int = 30,
    wolfe_patience: int = 6,
    init_state: LBFGSState | None = None,
) -> LBFGSResult:
    """Minimize ``fun(x)`` starting from ``x0`` (flat vector).

    Batch by ``jax.vmap``-ing this function with per-lane closures/initials.

    ``wolfe_patience`` caps the curvature-chasing half of the line search:
    once an Armijo-satisfying point exists, at most that many further
    bisection evaluations (counted from the evaluation that found it, so a
    lane that needed many halvings still gets its curvature bisections) —
    and never past ``2·wolfe_patience`` total evaluations — hunt for the
    weak-Wolfe curvature condition before the best Armijo point is
    accepted (the pair-storage guard keeps the history sane either way).
    Under ``vmap`` every lane pays for the slowest lane's line search, and
    objectives whose curvature condition is hard to satisfy otherwise burn
    the full ``max_backtracks`` ODE-solve evaluations on every outer
    iteration.

    ``init_state`` resumes a previous call's ``result.state``: the iterate,
    gradient, and curvature history carry over, so N chunked calls of
    ``max_iters=k`` equal one call of ``max_iters=N·k`` bit-for-bit
    (``x0`` is only used for its shape/dtype in that case).  Lanes that
    already converged or froze stay put.
    """
    dtype = x0.dtype
    p = x0.shape[0]
    m = history

    vg = jax.value_and_grad(fun)

    class _S(NamedTuple):
        x: jax.Array
        f: jax.Array
        g: jax.Array
        gfin: jax.Array     # gradient at x was fully finite (pre-zeroing)
        S: jax.Array        # [m, p] s-history (circular)
        Y: jax.Array        # [m, p] y-history
        rho: jax.Array      # [m]
        valid: jax.Array    # [m] bool, slot holds a usable pair
        head: jax.Array     # next write slot
        it: jax.Array
        done: jax.Array

    if init_state is None:
        x0 = _project(x0, lower, upper)
        f0, g0 = vg(x0)
        g0_fin = jnp.isfinite(g0).all()
        g0 = jnp.where(jnp.isfinite(g0), g0, 0.0)
        bad_start = ~jnp.isfinite(f0)
        init = _S(
            x=x0, f=f0, g=g0, gfin=g0_fin,
            S=jnp.zeros((m, p), dtype), Y=jnp.zeros((m, p), dtype),
            rho=jnp.zeros((m,), dtype), valid=jnp.zeros((m,), bool),
            head=jnp.asarray(0, jnp.int32), it=jnp.asarray(0, jnp.int32),
            done=bad_start,
        )
    else:
        st = init_state
        if st.S.shape != (m, p):
            raise ValueError(
                f"init_state history shape {st.S.shape} does not match "
                f"(history={m}, p={p}); pass the same `history` as the "
                "call that produced the state")
        bad_start = ~jnp.isfinite(st.f)
        init = _S(x=st.x, f=st.f, g=st.g, gfin=st.gfin, S=st.S, Y=st.Y,
                  rho=st.rho, valid=st.valid, head=st.head,
                  it=jnp.asarray(0, jnp.int32), done=st.done)

    def two_loop(s: _S) -> jax.Array:
        """H·g via the two-loop recursion over valid history slots."""
        q = s.g
        # iterate newest→oldest: slots head-1, head-2, ...
        idxs = (s.head - 1 - jnp.arange(m)) % m

        def bwd(q, i):
            use = s.valid[i]
            alpha = jnp.where(use, s.rho[i] * _dot(s.S[i], q), 0.0)
            q = q - alpha * s.Y[i]
            return q, alpha

        q, alphas = lax.scan(bwd, q, idxs)

        # H0 scaling from the most recent pair
        last = (s.head - 1) % m
        have = s.valid[last]
        yy = _dot(s.Y[last], s.Y[last])
        sy = jnp.where(s.rho[last] == 0, 1.0, 1.0 / s.rho[last])
        gamma = jnp.where(have & (yy > 0), sy / jnp.maximum(yy, 1e-30), 1.0)
        r = gamma * q

        def fwd(r, ia):
            i, alpha = ia
            use = s.valid[i]
            beta = jnp.where(use, s.rho[i] * _dot(s.Y[i], r), 0.0)
            r = r + (alpha - beta) * s.S[i]
            return r, None

        r, _ = lax.scan(fwd, r, (idxs[::-1], alphas[::-1]))
        return r

    def body(s: _S) -> _S:
        d = -two_loop(s)
        # safeguard: fall back to steepest descent if not a descent direction
        gd = _dot(s.g, d)
        descent = gd < 0
        d = jnp.where(descent, d, -s.g)
        gd = jnp.where(descent, gd, -_dot(s.g, s.g))

        # first iteration (no curvature history): scale the steepest-descent
        # step to unit sup-norm so a steep gradient cannot overshoot across
        # the whole feasible region in one jump (Nocedal-Wright's 1/||g||
        # initial scaling; Optim.jl's alphaguess serves the same purpose)
        have_hist = s.valid.any()
        scale0 = 1.0 / jnp.maximum(1.0, jnp.max(jnp.abs(d)))
        d = jnp.where(have_hist, d, d * scale0)
        gd = jnp.where(have_hist, gd, gd * scale0)

        # weak-Wolfe line search by Lewis-Overton bisection: Armijo on f plus
        # the curvature condition g(x+αd)ᵀd ≥ c2·gᵀd, which guarantees the
        # stored pair has sᵀy > 0 (plain backtracking does not, and skipped
        # pairs let the inverse-Hessian estimate go stale and stall)
        c1 = jnp.asarray(1e-4, dtype)
        c2 = jnp.asarray(0.9, dtype)
        inf = jnp.asarray(jnp.inf, dtype)

        class _LS(NamedTuple):
            lo: jax.Array
            hi: jax.Array
            alpha: jax.Array
            x: jax.Array
            f: jax.Array
            g: jax.Array
            gfin: jax.Array
            # best Armijo-satisfying point seen (fallback if Wolfe not met)
            bx: jax.Array
            bf: jax.Array
            bg: jax.Array
            bgfin: jax.Array
            b_ok: jax.Array
            k_armijo: jax.Array   # evaluation index of the FIRST Armijo point
            k: jax.Array
            ok: jax.Array

        def ls_cond(c: _LS):
            # stop early once an Armijo point exists and the curvature hunt
            # has exceeded its patience (counted from the evaluation that
            # found the Armijo point, so a lane that needed many halvings
            # still gets its curvature bisections — but never past the
            # 2x-patience hard cap, which bounds the slowest vmap lane) —
            # the fallback accepts c.bx
            give_up_wolfe = c.b_ok & ((c.k - c.k_armijo > wolfe_patience)
                                      | (c.k >= 2 * wolfe_patience))
            return (~c.ok) & (c.k < max_backtracks) & ~give_up_wolfe

        def ls_body(c: _LS) -> _LS:
            xt = _project(s.x + c.alpha * d, lower, upper)
            ft, gt = vg(xt)
            # record finiteness BEFORE zeroing: a zeroed-out NaN gradient
            # must not later read as a zero projected gradient (spurious
            # convergence)
            gt_fin = jnp.isfinite(gt).all()
            gt = jnp.where(jnp.isfinite(gt), gt, 0.0)
            # Armijo on the ACTUAL (projected) displacement — with box
            # clipping the nominal step α·d overstates the move, and the
            # unprojected model can "accept" a jump across a valley onto
            # the far bound
            decrease_model = jnp.minimum(_dot(s.g, xt - s.x),
                                         -jnp.asarray(1e-30, dtype))
            armijo = jnp.isfinite(ft) & (ft <= s.f + c1 * decrease_model)
            curv = _dot(gt, d) >= c2 * gd
            ok = armijo & curv
            hi = jnp.where(armijo, c.hi, c.alpha)
            lo = jnp.where(armijo & ~curv, c.alpha, c.lo)
            alpha_next = jnp.where(
                ok, c.alpha,
                jnp.where(~armijo, 0.5 * (lo + jnp.minimum(hi, c.alpha)),
                          jnp.where(jnp.isinf(hi), 2.0 * c.alpha,
                                    0.5 * (lo + hi))))
            better = armijo & (ft < c.bf)
            return _LS(
                lo=lo, hi=hi, alpha=alpha_next,
                x=xt, f=ft, g=gt, gfin=gt_fin,
                bx=jnp.where(better, xt, c.bx),
                bf=jnp.where(better, ft, c.bf),
                bg=jnp.where(better, gt, c.bg),
                bgfin=jnp.where(better, gt_fin, c.bgfin),
                b_ok=c.b_ok | armijo,
                k_armijo=jnp.where(c.b_ok, c.k_armijo,
                                   jnp.where(armijo, c.k, c.k_armijo)),
                k=c.k + 1, ok=ok)

        ls0 = _LS(lo=jnp.asarray(0.0, dtype), hi=inf,
                  alpha=jnp.asarray(1.0, dtype),
                  x=s.x, f=s.f, g=s.g, gfin=s.gfin,
                  bx=s.x, bf=s.f, bg=s.g, bgfin=s.gfin,
                  b_ok=jnp.asarray(False),
                  k_armijo=jnp.asarray(0, jnp.int32),
                  k=jnp.asarray(0, jnp.int32), ok=jnp.asarray(False))
        ls = lax.while_loop(ls_cond, ls_body, ls0)

        ls_ok = ls.ok | ls.b_ok
        x_new = jnp.where(ls.ok, ls.x, jnp.where(ls.b_ok, ls.bx, s.x))
        f_new = jnp.where(ls.ok, ls.f, jnp.where(ls.b_ok, ls.bf, s.f))
        g_new = jnp.where(ls.ok, ls.g, jnp.where(ls.b_ok, ls.bg, s.g))
        gfin_new = jnp.where(ls.ok, ls.gfin,
                             jnp.where(ls.b_ok, ls.bgfin, s.gfin))

        # curvature pair — only from genuinely finite gradients at BOTH
        # endpoints: yk built from a zeroed-out NaN/Inf gradient would
        # poison the inverse-Hessian estimate for up to `history` iterations
        sk = x_new - s.x
        yk = g_new - s.g
        sy = _dot(sk, yk)
        store = ls_ok & gfin_new & s.gfin & (sy > 1e-10 * jnp.maximum(
            _dot(sk, sk) * _dot(yk, yk), 1e-30) ** 0.5)
        slot = s.head % m
        S = jnp.where(store, s.S.at[slot].set(sk), s.S)
        Y = jnp.where(store, s.Y.at[slot].set(yk), s.Y)
        rho = jnp.where(store, s.rho.at[slot].set(1.0 / jnp.where(sy == 0, 1.0, sy)),
                        s.rho)
        valid = jnp.where(store, s.valid.at[slot].set(True), s.valid)
        head = jnp.where(store, (s.head + 1) % m, s.head)

        # convergence: projected-gradient sup-norm / f stagnation / stuck;
        # a point whose raw gradient had NaN/inf components can never pass
        # the small-gradient test (its zeroed pg would be meaningless)
        pg = x_new - _project(x_new - g_new, lower, upper)
        small_g = (jnp.max(jnp.abs(pg)) < gtol) & gfin_new
        stalled = ls_ok & (jnp.abs(s.f - f_new) <=
                           ftol * jnp.maximum(jnp.abs(s.f), 1.0))
        stuck = ~ls_ok
        done = small_g | stuck | (jnp.asarray(ftol, dtype) > 0) & stalled

        return _S(x=x_new, f=f_new, g=g_new, gfin=gfin_new, S=S, Y=Y,
                  rho=rho, valid=valid, head=head, it=s.it + 1, done=done)

    def cond(s: _S):
        return (~s.done) & (s.it < max_iters)

    final = lax.while_loop(cond, lambda s: body(s), init)
    pg = final.x - _project(final.x - final.g, lower, upper)
    converged = (jnp.max(jnp.abs(pg)) < gtol) & final.gfin & ~bad_start
    out_state = LBFGSState(x=final.x, f=final.f, g=final.g, gfin=final.gfin,
                           S=final.S, Y=final.Y, rho=final.rho,
                           valid=final.valid, head=final.head,
                           done=final.done)
    return LBFGSResult(x=final.x, fval=final.f, converged=converged,
                       num_iters=final.it, state=out_state)

"""Adaptive Tsit5 (Tsitouras 5(4)) explicit Runge-Kutta integrator.

A from-scratch, batch-first integrator equivalent in capability to the bare
``OrdinaryDiffEq.solve(problem, p=θ, saveat=timepoints, save_idxs=1)`` calls
that dominate the reference's hot loops (``src/parameter-estimation.jl:59``,
``src/saem.jl:52``, ``suppression/src/suppression_model.jl:123``):

* **bounded ``lax.scan``** over a static ``max_steps`` with per-trajectory
  done/failure masks, so the solve is fixed-shape, ``vmap``-able across whole
  cohorts × restarts, and reverse-mode differentiable (discrete adjoint);
* **FSAL** (first-same-as-last) stage reuse;
* **PI step-size controller** (Hairer beta1=0.7/5, beta2=0.4/5) with Hairer's
  automatic initial-step selection, matching OrdinaryDiffEq's default
  tolerances ``rtol=1e-3, atol=1e-6``;
* **saveat dense output** via the Tsit5 free 4th-order interpolant, filled
  incrementally as steps are accepted;
* **failure masking** instead of exceptions: divergence (non-finite state) or
  step-size underflow marks the trajectory failed; loss layers map failure to
  ``inf`` exactly like the reference's retcode check
  (``src/parameter-estimation.jl:61-64``).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

# -- Tsit5 tableau (Tsitouras 2011) -----------------------------------------

_C = (0.0, 0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0)

_A = (
    (),
    (0.161,),
    (-0.008480655492356989, 0.335480655492357),
    (2.8971530571054935, -6.359448489975075, 4.3622954328695815),
    (5.325864828439257, -11.748883564062828, 7.4955393428898365,
     -0.09249506636175525),
    (5.86145544294642, -12.92096931784711, 8.159367898576159,
     -0.071584973281401, -0.028269050394068383),
    (0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
     -3.290069515436081, 2.324710524099774),
)

# 5th-order solution weights (identical to the last A row: FSAL)
_B = (0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
      -3.290069515436081, 2.324710524099774, 0.0)

# embedded error weights (b - bhat)
_BTILDE = (-0.00178001105222577714, -0.0008164344596567469,
           0.007880878010261995, -0.1447110071732629, 0.5823571654525552,
           -0.45808210592918697, 0.015151515151515152)

_ORDER = 5.0
_BETA1 = 0.7 / _ORDER   # PI controller proportional coefficient
_BETA2 = 0.4 / _ORDER   # PI controller integral coefficient
_SAFETY = 0.9
_FACTOR_MIN = 0.2
_FACTOR_MAX = 10.0


def _interp_coeffs(theta: jax.Array) -> tuple[jax.Array, ...]:
    """Tsit5 free interpolant weights b_i(theta), 4th-order accurate.

    Verified identities (covered by tests): b_i(0)=0, b_i(1)=B_i,
    sum_i b_i'(0) k_i = k1 (i.e. the interpolant's slope at the left end is
    the stage-1 derivative).
    """
    t = theta
    t2 = t * t
    b1 = -1.0530884977290216 * t * (t - 1.3299890189751412) * (
        t2 - 1.4364028541716351 * t + 0.7139816917074209)
    b2 = 0.1017 * t2 * (t2 - 2.1966568338249754 * t + 1.2949852507374631)
    b3 = 2.490627285651252793 * t2 * (
        t2 - 2.38535645472061657 * t + 1.57803468208092486)
    b4 = -16.54810288924490272 * (t - 1.21712927295533244) * (
        t - 0.61620406037800089) * t2
    b5 = 47.37952196281928122 * (t - 1.203071208372362603) * (
        t - 0.658047292653547382) * t2
    b6 = -34.87065786149660974 * (t - 1.2) * (t - 0.666666666666666667) * t2
    b7 = 2.5 * (t - 1.0) * (t - 0.6) * t2
    return b1, b2, b3, b4, b5, b6, b7


class SolveResult(NamedTuple):
    """Result of one trajectory solve (leading batch dims when vmapped)."""

    ys: jax.Array          # [T_save, dim] solution at the requested times
    success: jax.Array     # bool, False on divergence/underflow/step budget
    num_steps: jax.Array   # int32, total attempted steps
    num_accepted: jax.Array  # int32, accepted steps


def _error_norm(err, y0, y1, rtol, atol):
    scale = atol + rtol * jnp.maximum(jnp.abs(y0), jnp.abs(y1))
    r = err / scale
    # the epsilon keeps the sqrt gradient finite at r == 0 (done-masked lanes
    # step with dt clamped to 0; without it the zero cotangent times the
    # infinite local sqrt derivative poisons the whole backward pass)
    return jnp.sqrt(jnp.mean(r * r) + jnp.asarray(1e-30, err.dtype))


def _rms(x):
    """sqrt(mean(x²)) with a finite gradient at x == 0 (a steady-state u0
    makes f0 exactly zero, and the bare sqrt would emit NaN cotangents)."""
    return jnp.sqrt(jnp.mean(x * x) + jnp.asarray(1e-30, x.dtype))


def _initial_dt(f, t0, y0, args, f0, rtol, atol, t_span):
    """Hairer-style automatic initial step size (order 5)."""
    scale = atol + rtol * jnp.abs(y0)
    d0 = _rms(y0 / scale)
    d1 = _rms(f0 / scale)
    small = (d0 < 1e-5) | (d1 < 1e-5)
    h0 = jnp.where(small, 1e-6, 0.01 * d0 / jnp.where(d1 == 0, 1.0, d1))
    h0 = jnp.minimum(h0, 0.1 * t_span)
    y1 = y0 + h0 * f0
    f1 = f(t0 + h0, y1, args)
    d2 = _rms((f1 - f0) / scale) / h0
    dmax = jnp.maximum(d1, d2)
    # Hairer II.4 step (d): exponent 1/(p+1) for a method of order p
    # (OrdinaryDiffEq's ode_determine_initdt uses 1/(alg_order+1) likewise)
    h1 = jnp.where(dmax <= 1e-15,
                   jnp.maximum(1e-6, h0 * 1e-3),
                   (0.01 / dmax) ** (1.0 / (_ORDER + 1.0)))
    dt = jnp.minimum(100.0 * h0, jnp.minimum(h1, t_span))
    # guard against non-finite RHS at the initial point
    return jnp.where(jnp.isfinite(dt) & (dt > 0), dt, 1e-6 * t_span)


@partial(jax.jit, static_argnums=(0, 6, 10, 11))
def solve_tsit5(
    f: Callable[[jax.Array, jax.Array, Any], jax.Array],
    y0: jax.Array,
    t0: jax.Array,
    t1: jax.Array,
    args: Any,
    saveat: jax.Array,
    max_steps: int = 256,
    rtol: float = 1e-3,
    atol: float = 1e-6,
    dt0: jax.Array | None = None,
    mode: str = "scan",
    remat: bool = False,
) -> SolveResult:
    """Integrate ``dy/dt = f(t, y, args)`` from ``t0`` to ``t1``.

    ``saveat`` is a static-shape vector of output times in ``[t0, t1]``
    (ascending).  Returns the dense-output solution at those times.  All
    inputs may carry leading batch dims via ``jax.vmap`` of this function.

    ``mode="scan"`` (default) runs a fixed ``max_steps`` bounded scan —
    reverse-mode differentiable (the training path).  ``mode="while"`` runs
    a ``lax.while_loop`` that exits as soon as every (vmapped) lane is done
    — typically 4-8× fewer steps executed for gradient-free workloads
    (screening, likelihood profiles, MCMC); not reverse-differentiable.
    """
    dtype = y0.dtype
    t0 = jnp.asarray(t0, dtype)
    t1 = jnp.asarray(t1, dtype)
    saveat = jnp.asarray(saveat, dtype)
    t_span = t1 - t0

    f0 = f(t0, y0, args)
    dt_init = _initial_dt(f, t0, y0, args, f0, rtol, atol, t_span) if dt0 is None \
        else jnp.asarray(dt0, dtype)
    dt_min = jnp.asarray(1e-10, dtype) * t_span

    # output buffer; save points exactly at t0 are filled immediately
    ys0 = jnp.where((saveat <= t0)[:, None], y0[None, :],
                    jnp.zeros((saveat.shape[0], y0.shape[0]), dtype))

    class _S(NamedTuple):
        t: jax.Array
        y: jax.Array
        dt: jax.Array
        k1: jax.Array           # FSAL stage
        err_prev: jax.Array     # previous accepted scaled error (PI memory)
        done: jax.Array
        failed: jax.Array
        ys: jax.Array
        n_acc: jax.Array
        n_tot: jax.Array

    init = _S(t=t0, y=y0, dt=dt_init, k1=f0,
              err_prev=jnp.asarray(1.0, dtype),
              done=t_span <= 0, failed=jnp.asarray(False),
              ys=ys0, n_acc=jnp.asarray(0, jnp.int32),
              n_tot=jnp.asarray(0, jnp.int32))

    def step(s: _S, _) -> tuple[_S, None]:
        active = ~(s.done | s.failed)
        # clamp the step to land exactly on t1; keep it strictly positive so
        # done-masked lanes cannot generate 0/0 gradients
        dt = jnp.maximum(jnp.minimum(s.dt, t1 - s.t),
                         jnp.asarray(1e-12, dtype) * t_span)
        t, y = s.t, s.y

        k1 = s.k1
        k2 = f(t + _C[1] * dt, y + dt * (_A[1][0] * k1), args)
        k3 = f(t + _C[2] * dt, y + dt * (_A[2][0] * k1 + _A[2][1] * k2), args)
        k4 = f(t + _C[3] * dt,
               y + dt * (_A[3][0] * k1 + _A[3][1] * k2 + _A[3][2] * k3), args)
        k5 = f(t + _C[4] * dt,
               y + dt * (_A[4][0] * k1 + _A[4][1] * k2 + _A[4][2] * k3
                         + _A[4][3] * k4), args)
        k6 = f(t + dt,
               y + dt * (_A[5][0] * k1 + _A[5][1] * k2 + _A[5][2] * k3
                         + _A[5][3] * k4 + _A[5][4] * k5), args)
        y_new = y + dt * (_A[6][0] * k1 + _A[6][1] * k2 + _A[6][2] * k3
                          + _A[6][3] * k4 + _A[6][4] * k5 + _A[6][5] * k6)
        k7 = f(t + dt, y_new, args)

        err = dt * (_BTILDE[0] * k1 + _BTILDE[1] * k2 + _BTILDE[2] * k3
                    + _BTILDE[3] * k4 + _BTILDE[4] * k5 + _BTILDE[5] * k6
                    + _BTILDE[6] * k7)
        err_norm = _error_norm(err, y, y_new, rtol, atol)

        finite = jnp.isfinite(y_new).all() & jnp.isfinite(err_norm)
        accept = finite & (err_norm <= 1.0)

        # --- PI controller -------------------------------------------------
        err_c = jnp.maximum(err_norm, jnp.asarray(1e-10, dtype))
        factor_acc = jnp.clip(
            _SAFETY * err_c ** (-_BETA1) * s.err_prev ** (_BETA2),
            _FACTOR_MIN, _FACTOR_MAX)
        factor_rej = jnp.clip(_SAFETY * err_c ** (-1.0 / _ORDER),
                              _FACTOR_MIN, 1.0)
        factor = jnp.where(accept, factor_acc,
                           jnp.where(finite, factor_rej, 0.5))
        dt_next = dt * factor

        # --- saveat dense output (Tsit5 interpolant) -----------------------
        t_new = t + dt
        reached_end = t_new >= t1 - jnp.asarray(1e-8, dtype) * t_span
        # mask save times inside (t, t_new]; at the final step absorb any
        # points beyond t_new caused by rounding
        upper = jnp.where(reached_end, jnp.inf, t_new)
        save_mask = active & accept & (saveat > t) & (saveat <= upper)
        theta = jnp.clip((saveat - t) / jnp.where(dt == 0, 1.0, dt), 0.0, 1.0)
        b1, b2, b3, b4, b5, b6, b7 = _interp_coeffs(theta)
        y_interp = y[None, :] + dt * (
            b1[:, None] * k1[None, :] + b2[:, None] * k2[None, :]
            + b3[:, None] * k3[None, :] + b4[:, None] * k4[None, :]
            + b5[:, None] * k5[None, :] + b6[:, None] * k6[None, :]
            + b7[:, None] * k7[None, :])
        ys = jnp.where(save_mask[:, None], y_interp, s.ys)

        # --- state update with masking -------------------------------------
        upd = active & accept
        new_failed = s.failed | (active & ~accept & (dt_next < dt_min))
        new_done = s.done | (upd & reached_end)

        return _S(
            t=jnp.where(upd, t_new, s.t),
            y=jnp.where(upd, y_new, s.y),
            dt=jnp.where(active, dt_next, s.dt),
            k1=jnp.where(upd, k7, s.k1),
            err_prev=jnp.where(upd, err_c, s.err_prev),
            done=new_done,
            failed=new_failed,
            ys=ys,
            n_acc=s.n_acc + upd.astype(jnp.int32),
            n_tot=s.n_tot + active.astype(jnp.int32),
        ), None

    if mode == "scan":
        # remat=True gives the checkpointed discrete adjoint: the backward
        # pass recomputes per-step stage values instead of storing
        # max_steps × 7 stages of activations
        body = jax.checkpoint(step) if remat else step
        final, _ = lax.scan(body, init, None, length=max_steps)
    elif mode == "while":
        final = lax.while_loop(
            lambda s: ~(s.done | s.failed) & (s.n_tot < max_steps),
            lambda s: step(s, None)[0], init)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    success = final.done & ~final.failed
    return SolveResult(ys=final.ys, success=success,
                       num_steps=final.n_tot, num_accepted=final.n_acc)

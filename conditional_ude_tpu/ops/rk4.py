"""Fixed-step classical RK4 integrator with exact landing on save points.

The cUDE ODEs are small, smooth, and non-stiff (2-3 states, 120-240 min
spans), so a fixed-step RK4 with a handful of sub-steps per save interval
sits far below the reference's default tolerances while compiling to a
single unrolled-free ``lax.scan`` with no control-flow divergence — the
fastest shape for batched execution.  Used as the throughput path for
screening; the adaptive Tsit5 path provides tolerance parity.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable

import jax
import jax.numpy as jnp
from jax import lax

from conditional_ude_tpu.ops.tsit5 import SolveResult


@partial(jax.jit, static_argnums=(0, 5, 6))
def solve_rk4(
    f: Callable[[jax.Array, jax.Array, Any], jax.Array],
    y0: jax.Array,
    args: Any,
    saveat: jax.Array,
    t0: jax.Array | None = None,
    substeps: int = 16,
    remat: bool = False,
) -> SolveResult:
    """Integrate with ``substeps`` RK4 steps between consecutive save times.

    ``saveat[0]`` may equal ``t0``; integration starts at ``t0`` (defaults to
    ``saveat[0]``).  Returns the state at each save time.  Failure is flagged
    when the state goes non-finite.

    ``remat=True`` wraps each save segment in ``jax.checkpoint``: the
    reverse pass rematerializes stage intermediates instead of storing them
    — the checkpointed discrete adjoint, worth it when lanes × steps ×
    stages no longer fits comfortably in HBM.
    """
    dtype = y0.dtype
    saveat = jnp.asarray(saveat, dtype)
    t_start = saveat[0] if t0 is None else jnp.asarray(t0, dtype)

    # per-save-interval start times and step sizes (static T_save)
    seg_t0 = jnp.concatenate([t_start[None], saveat[:-1]])
    seg_dt = (saveat - seg_t0) / substeps

    def rk4_step(y, t, dt):
        k1 = f(t, y, args)
        k2 = f(t + 0.5 * dt, y + 0.5 * dt * k1, args)
        k3 = f(t + 0.5 * dt, y + 0.5 * dt * k2, args)
        k4 = f(t + dt, y + dt * k3, args)
        return y + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)

    def segment(y, seg):
        t0_s, dt_s = seg

        def sub(i, y):
            return rk4_step(y, t0_s + i * dt_s, dt_s)

        y = lax.fori_loop(0, substeps, sub, y)
        return y, y

    if remat:
        segment = jax.checkpoint(segment)

    y_final, ys = lax.scan(segment, y0, (seg_t0, seg_dt))
    success = jnp.isfinite(ys).all()
    n = jnp.asarray(substeps * saveat.shape[0], jnp.int32)
    return SolveResult(ys=ys, success=success, num_steps=n, num_accepted=n)

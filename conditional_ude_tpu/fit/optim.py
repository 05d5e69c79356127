"""Generic fixed-iteration optimizers over pytrees (Adam via optax).

The reference's two-stage refinement is Adam(lr) for ``maxiters`` followed by
L-BFGS (``src/parameter-estimation.jl:144-183``); this module provides the
Adam stage as a ``lax.scan`` over a static iteration count so it can be
``vmap``-ed over the multi-start restart axis.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
import optax


class AdamResult(NamedTuple):
    x: Any
    fval: jax.Array
    loss_trace: jax.Array  # [iters]
    opt_state: Any = None  # pass back in to resume (chunked dispatch)


@partial(jax.jit, static_argnums=(0, 2, 4))
def adam_minimize(
    fun: Callable[[Any], jax.Array],
    x0: Any,
    iters: int = 1000,
    lr: float = 1e-2,
    log_every: int = 0,
    opt_state: Any = None,
) -> AdamResult:
    """Run ``iters`` Adam steps on ``fun`` starting from pytree ``x0``.

    Non-finite gradients (diverged ODE solves) are zeroed so a bad step
    cannot poison the whole run; the final iterate is returned together with
    the loss trace (the reference records loss-trace callbacks,
    ``suppression/src/suppression_model.jl:22-31``).  ``log_every > 0``
    prints a live loss every that many steps (the reference's ProgressMeter
    display, ``src/parameter-estimation.jl:223-232``).
    """
    opt = optax.adam(lr)
    state0 = opt.init(x0) if opt_state is None else opt_state
    vg = jax.value_and_grad(fun)

    def step(carry, i):
        x, state = carry
        f, g = vg(x)
        g = jax.tree.map(lambda a: jnp.where(jnp.isfinite(a), a, 0.0), g)
        updates, state = opt.update(g, state, x)
        x = optax.apply_updates(x, updates)
        if log_every > 0:
            lax.cond(i % log_every == 0,
                     lambda: jax.debug.print("adam it={i} loss={f:.6f}",
                                             i=i, f=f),
                     lambda: None)
        return (x, state), f

    (x, state), trace = lax.scan(step, (x0, state0), jnp.arange(iters))
    return AdamResult(x=x, fval=fun(x), loss_trace=trace, opt_state=state)

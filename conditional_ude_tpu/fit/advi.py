"""Automatic-Differentiation Variational Inference (ADVI) for the cUDE.

The reference repo carries 25 ADVI result files with no surviving script —
``source_data/advi/cude_result_*.jld2`` (one per training restart, each a
``betas[N]`` + ``parameters[P]`` posterior point estimate; Turing/Bijectors
are residue in ``Project.toml:3,34``, see SURVEY.md §2.12).  This module is
the batched reconstruction of that capability: mean-field Gaussian ADVI
with the reparameterization trick, the ELBO maximized by Adam, and every
individual / Monte-Carlo sample / restart a ``vmap`` axis instead of a
serial Turing chain.

Two entry points:

* :func:`advi` — generic mean-field ADVI on a flat parameter vector.
* :func:`advi_betas` — per-individual posterior q(β, log σ) with the NN
  frozen (the variational analogue of ``train_with_sigma``,
  ``src/parameter-estimation.jl:290-307``).
* :func:`advi_joint` — joint posterior over (NN weights, all β, log σ)
  (the variational analogue of the joint ``train``,
  ``src/parameter-estimation.jl:340-386``, and the likely producer of the
  reference's ``cude_result_*`` artifacts).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp

from conditional_ude_tpu.fit.losses import sse
from conditional_ude_tpu.models.cpeptide import Cohort, CPeptideModel

_LOG2PI = jnp.log(2.0 * jnp.pi)


class ADVIResult(NamedTuple):
    mean: jax.Array      # posterior mean, same shape as the init vector
    log_std: jax.Array   # posterior log-std (mean-field diagonal)
    elbo_trace: jax.Array  # [steps] ELBO estimate per Adam step


def advi(
    log_joint: Callable[[jax.Array], jax.Array],
    init_mean: jax.Array,
    key: jax.Array,
    steps: int = 1000,
    n_samples: int = 8,
    lr: float = 1e-2,
    init_log_std: float = -2.0,
) -> ADVIResult:
    """Mean-field Gaussian ADVI on a flat vector.

    Maximizes ``E_q[log_joint(z)] + H[q]`` with q = N(μ, diag e^{2ρ}) via
    the reparameterization trick (``z = μ + e^ρ ε``) and Adam; the whole
    optimization is one ``lax.scan`` (fixed shapes, jit/vmap-friendly).

    Divergence robustness (the reference's retcode ⇒ ``Inf`` semantics,
    ``src/parameter-estimation.jl:61-64``): per-sample values AND per-sample
    gradients are computed with ``vmap(value_and_grad)`` and non-finite
    samples are dropped from the Monte-Carlo average — one diverged ODE
    solve cannot poison the step for the finite samples (a ``where`` on the
    averaged loss alone would still backpropagate NaN through the diverged
    trajectory).  The ELBO gradient is assembled explicitly:
    ``∂/∂μ = E[∂logp/∂z]``, ``∂/∂ρ = E[∂logp/∂z · ε]·e^ρ + 1``.
    """
    import optax

    mu0 = jnp.asarray(init_mean, jnp.float32)
    rho0 = jnp.full_like(mu0, init_log_std)
    # cosine-decayed step size: large early moves to escape the prior
    # basin, small late steps so the MC noise doesn't rattle the optimum
    opt = optax.adam(optax.cosine_decay_schedule(lr, steps, alpha=0.02))

    def step(carry, k):
        (mu, rho), opt_state = carry
        eps = jax.random.normal(k, (n_samples,) + mu.shape, mu.dtype)
        zs = mu + jnp.exp(rho) * eps
        lp, gz = jax.vmap(jax.value_and_grad(log_joint))(zs)
        ok = jnp.isfinite(lp) & jnp.isfinite(gz).all(axis=-1)
        w = ok.astype(mu.dtype)
        w = w / jnp.maximum(w.sum(), 1.0)
        gz = jnp.where(ok[:, None], gz, 0.0)
        # HIGHEST: a GPU may take default-precision float32 contractions
        # in TF32, which would bias the Monte-Carlo gradient average
        hi = jax.lax.Precision.HIGHEST
        g_mu = -jnp.einsum("s,sp->p", w, gz, precision=hi)
        g_rho = -jnp.einsum("s,sp->p", w, gz * eps,
                            precision=hi) * jnp.exp(rho) - 1.0
        updates, opt_state = opt.update((g_mu, g_rho), opt_state, (mu, rho))
        mu, rho = optax.apply_updates((mu, rho), updates)
        entropy = jnp.sum(rho + 0.5 * (_LOG2PI + 1.0))
        elbo = jnp.sum(w * jnp.where(ok, lp, 0.0)) + entropy
        return ((mu, rho), opt_state), elbo

    keys = jax.random.split(key, steps)
    ((mu, rho), _), elbos = jax.lax.scan(
        step, ((mu0, rho0), opt.init((mu0, rho0))), keys)
    return ADVIResult(mean=mu, log_std=rho, elbo_trace=elbos)


def _gaussian_loglik(err_sse: jax.Array, sigma: jax.Array,
                     n_obs: int) -> jax.Array:
    """Full Gaussian log-likelihood from an SSE (the reference's
    ``loss_sigma`` drops the 2π constant; ADVI keeps it so ELBO values are
    proper log-evidence bounds)."""
    return -0.5 * n_obs * (_LOG2PI + jnp.log(sigma**2)) \
        - err_sse / (2.0 * sigma**2)


class BetaPosterior(NamedTuple):
    beta_mean: jax.Array       # [N]
    beta_std: jax.Array        # [N]
    log_sigma_mean: jax.Array  # [N]
    log_sigma_std: jax.Array   # [N]
    elbo_trace: jax.Array      # [N, steps]


def advi_betas(
    model: CPeptideModel,
    nn_params: jax.Array,
    cohort: Cohort,
    key: jax.Array,
    prior_beta: tuple[float, float] = (-2.0, 2.0),
    prior_log_sigma: tuple[float, float] = (0.0, 2.0),
    initial_beta: float = -2.0,
    steps: int = 1000,
    n_samples: int = 8,
    lr: float = 1e-2,
    **solver_kwargs,
) -> BetaPosterior:
    """Per-individual mean-field posterior q(β, log σ) with the NN frozen.

    The variational counterpart of the test-time (β, σ) re-estimation
    (``train_with_sigma``): instead of a bounded L-BFGS point estimate,
    each subject gets a Gaussian posterior, all subjects in one ``vmap``.
    Priors default to the reference's β initialization scale (init −2,
    bounds [−4, 1], ``src/parameter-estimation.jl:274-276``).
    """
    n_obs = cohort.timepoints.shape[0]

    def one(ind, data, k):
        def log_joint(z):
            beta, log_sigma = z[0], z[1]
            err = sse(model, {"neural": nn_params, "conditional": beta},
                      ind, cohort.timepoints, data, **solver_kwargs)
            ll = _gaussian_loglik(err, jnp.exp(log_sigma), n_obs)
            lp_b = -0.5 * ((beta - prior_beta[0]) / prior_beta[1]) ** 2
            lp_s = -0.5 * ((log_sigma - prior_log_sigma[0])
                           / prior_log_sigma[1]) ** 2
            return ll + lp_b + lp_s

        z0 = jnp.array([initial_beta, 0.0], jnp.float32)
        return advi(log_joint, z0, k, steps=steps, n_samples=n_samples,
                    lr=lr)

    keys = jax.random.split(key, cohort.n)
    res = jax.vmap(one)(cohort.individuals, cohort.cpeptide, keys)
    std = jnp.exp(res.log_std)
    return BetaPosterior(beta_mean=res.mean[:, 0], beta_std=std[:, 0],
                         log_sigma_mean=res.mean[:, 1],
                         log_sigma_std=std[:, 1],
                         elbo_trace=res.elbo_trace)


class JointPosterior(NamedTuple):
    nn_mean: jax.Array         # [P]
    nn_std: jax.Array          # [P]
    beta_mean: jax.Array       # [N]
    beta_std: jax.Array        # [N]
    log_sigma_mean: jax.Array  # scalar
    log_sigma_std: jax.Array   # scalar
    elbo_trace: jax.Array      # [steps]


def advi_joint(
    model: CPeptideModel,
    cohort: Cohort,
    init_nn: jax.Array,
    key: jax.Array,
    init_betas: jax.Array | None = None,
    prior_nn_std: float = 10.0,
    prior_beta: tuple[float, float] = (-2.0, 2.0),
    prior_log_sigma: tuple[float, float] = (0.0, 2.0),
    steps: int = 2000,
    n_samples: int = 4,
    lr: float = 1e-2,
    **solver_kwargs,
) -> JointPosterior:
    """Joint mean-field posterior over (NN weights, all β, log σ).

    One call per restart reproduces the shape of the reference's
    ``cude_result_*`` artifacts (``betas[N]`` + ``parameters[P]``); fan the
    restart axis out with ``jax.vmap`` over ``init_nn`` / ``key`` batches.
    """
    n_params = init_nn.shape[-1]
    n_obs = cohort.timepoints.shape[0]
    if init_betas is None:
        init_betas = jnp.full((cohort.n,), -2.0, jnp.float32)

    def unpack(z):
        return (z[:n_params], z[n_params:n_params + cohort.n], z[-1])

    def log_joint(z):
        nn, betas, log_sigma = unpack(z)
        sigma = jnp.exp(log_sigma)

        def one(beta, ind, data):
            err = sse(model, {"neural": nn, "conditional": beta}, ind,
                      cohort.timepoints, data, **solver_kwargs)
            return _gaussian_loglik(err, sigma, n_obs)

        ll = jnp.sum(jax.vmap(one)(betas, cohort.individuals,
                                   cohort.cpeptide))
        lp_nn = -0.5 * jnp.sum((nn / prior_nn_std) ** 2)
        lp_b = -0.5 * jnp.sum(((betas - prior_beta[0]) / prior_beta[1]) ** 2)
        lp_s = -0.5 * ((log_sigma - prior_log_sigma[0])
                       / prior_log_sigma[1]) ** 2
        return ll + lp_nn + lp_b + lp_s

    z0 = jnp.concatenate([jnp.asarray(init_nn, jnp.float32),
                          jnp.asarray(init_betas, jnp.float32),
                          jnp.zeros((1,), jnp.float32)])
    res = advi(log_joint, z0, key, steps=steps, n_samples=n_samples, lr=lr)
    std = jnp.exp(res.log_std)
    return JointPosterior(
        nn_mean=res.mean[:n_params], nn_std=std[:n_params],
        beta_mean=res.mean[n_params:n_params + cohort.n],
        beta_std=std[n_params:n_params + cohort.n],
        log_sigma_mean=res.mean[-1], log_sigma_std=std[-1],
        elbo_trace=res.elbo_trace)

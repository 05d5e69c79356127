"""SAEM mixed-effects estimator (Stochastic Approximation EM).

Capability parity with ``src/saem.jl`` (cUDE random effects β_i ~ N(η, Ω),
fixed effects = NN weights + σ) and ``src/saem-symreg.jl`` (symbolic model,
log-normal individual map kM_i = kM_pop·e^{η_i}, prior mean fixed at 0).

Batched redesign: the reference runs, per iteration, a serial Python-style
loop over individuals each doing ``n_mcmc_steps`` Metropolis steps (2 ODE
solves per step), then a 5-step population update.  Here the **entire SAEM
run is one ``lax.scan``** over iterations whose body vmaps the MCMC kernel
over the population axis — every individual's chain advances in parallel on
chip, and the diagnostics (NLL / acceptance / proposal-std traces) come back
as scan outputs.

Reference quirks preserved deliberately (bit-for-bit semantics, not RNG):
  * Ω enters the N(η, Ω) prior as the *scale* parameter but is updated by
    blending the *variance* of the random effects (``src/saem.jl:204``) —
    a reference quirk we keep for parity;
  * σ is overwritten by the population update while the fixed effect is
    γ-blended (``src/saem.jl:193-201``);
  * the proposal std only adapts after burn-in (``src/saem.jl:215-216``);
  * solver failure ⇒ log-likelihood −inf ⇒ the proposal is rejected
    (``src/saem.jl:59-62``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import jax
import jax.flatten_util
import jax.numpy as jnp
import optax
from jax import lax

from conditional_ude_tpu.models.cpeptide import Cohort, CPeptideModel
from conditional_ude_tpu.ops.lbfgs import lbfgs_minimize
from conditional_ude_tpu.fit.losses import sse

# loglik(theta, sigma, random_i, individual, data) -> scalar log-likelihood
LogLikFn = Callable[[Any, jax.Array, jax.Array, Any, jax.Array], jax.Array]


@dataclasses.dataclass(frozen=True)
class SAEMConfig:
    """Defaults mirror ``src/saem.jl:134-152`` / ``saem-symreg.jl:134-151``."""

    sigma: float = 1.0
    prior_eta: float = 0.0
    prior_omega: float = 1.0
    iterations: int = 500
    burnin: int = 100
    proposal_std: float = 0.1
    proposal_bounds: tuple[float, float] = (1e-3, 1.0)
    alpha: float = 0.7
    n_mcmc_steps: int = 1
    initial_mcmc_steps: int | None = None   # defaults to n_mcmc_steps
    target_acceptance: float = 0.25
    initial_temperature: float = 10.0
    temperature_decay: float = 0.05
    omega_lr: float = 0.04
    pop_update_lbfgs: bool = False          # cUDE: Adam(1e-2); symbolic: LBFGS
    pop_update_iters: int = 5
    pop_adam_lr: float = 1e-2
    update_prior_mean: bool = True          # cUDE yes (:205), symbolic no
    omega_as_variance: bool = False         # False = reference parity: blend
                                            # var(rand) into Ω but use Ω as a
                                            # *standard deviation* in the
                                            # prior (src/saem.jl:70,91 vs
                                            # :204 — a units mismatch that
                                            # makes Ω collapse or blow up
                                            # depending on the draw).  True =
                                            # dimensionally consistent SA
                                            # update Ω² ← (1-lr)·Ω² +
                                            # lr·var(rand), which settles Ω
                                            # at the population std.
    log_every: int = 0                      # >0: live NLL/acceptance prints
                                            # (the reference's ProgressMeter
                                            # display, src/saem.jl:219-224)

    @property
    def mcmc_steps_max(self) -> int:
        init = (self.initial_mcmc_steps if self.initial_mcmc_steps is not None
                else self.n_mcmc_steps)
        return max(init, self.n_mcmc_steps)


class SAEMResult(NamedTuple):
    theta: Any              # fixed effects (NN params pytree / scalar kM_pop)
    random_effects: jax.Array   # [N] final β_i / η_i
    omega: jax.Array
    sigma: jax.Array
    eta: jax.Array          # prior mean (stays prior_eta when not updated)
    nll_trace: jax.Array        # [iterations]
    acceptance_trace: jax.Array  # [iterations]
    proposal_std_trace: jax.Array  # [iterations]


def _normal_logpdf(x, mean, scale):
    scale2 = scale**2
    return -0.5 * (jnp.log(2.0 * jnp.pi * scale2) + (x - mean) ** 2 / scale2)


def run_saem(
    loglik: LogLikFn,
    theta0: Any,
    individuals: Any,        # pytree with leading N (cohort.individuals)
    data: jax.Array,         # [N, T]
    key: jax.Array,
    config: SAEMConfig = SAEMConfig(),
) -> SAEMResult:
    """Run SAEM; the whole loop compiles to a single program.

    ``loglik(theta, sigma, random_i, individual_i, data_i)`` must be pure
    and return −inf on solver failure.
    """
    cfg = config
    n = data.shape[0]
    f32 = jnp.float32

    v_ll = jax.vmap(loglik, in_axes=(None, None, 0, 0, 0))

    def population_ll(theta, sigma, rand):
        return v_ll(theta, sigma, rand, individuals, data)

    # -- population update: 5 optimizer steps on total NLL -------------------
    def total_nll(theta, sigma, rand):
        ll = population_ll(theta, sigma, rand)
        return -jnp.sum(ll)

    if cfg.pop_update_lbfgs:
        flat0, unravel = jax.flatten_util.ravel_pytree(theta0)
        p_theta = flat0.shape[0]

        def pop_update(theta, sigma, rand):
            x0 = jnp.concatenate([
                jax.flatten_util.ravel_pytree(theta)[0],
                jnp.asarray(sigma, f32)[None]])
            res = lbfgs_minimize(
                lambda x: total_nll(unravel(x[:p_theta]), x[p_theta], rand),
                x0, max_iters=cfg.pop_update_iters)
            return unravel(res.x[:p_theta]), res.x[p_theta]
    else:
        opt = optax.adam(cfg.pop_adam_lr)

        def pop_update(theta, sigma, rand):
            params = {"theta": theta, "sigma": jnp.asarray(sigma, f32)}
            state = opt.init(params)

            def step(carry, _):
                p, s = carry
                g = jax.grad(
                    lambda q: total_nll(q["theta"], q["sigma"], rand))(p)
                g = jax.tree.map(
                    lambda a: jnp.where(jnp.isfinite(a), a, 0.0), g)
                upd, s = opt.update(g, s, p)
                return (optax.apply_updates(p, upd), s), None

            (params, _), _ = lax.scan(step, (params, state), None,
                                      length=cfg.pop_update_iters)
            return params["theta"], params["sigma"]

    mcmc_max = cfg.mcmc_steps_max
    init_steps = (cfg.initial_mcmc_steps if cfg.initial_mcmc_steps is not None
                  else cfg.n_mcmc_steps)

    class _S(NamedTuple):
        rand: jax.Array
        theta: Any
        sigma: jax.Array
        omega: jax.Array
        eta: jax.Array
        proposal_std: jax.Array
        key: jax.Array

    def iteration(s: _S, it: jax.Array):
        """One SAEM iteration; ``it`` is 1-based (``src/saem.jl:168-226``)."""
        gamma = jnp.where(it <= cfg.burnin, 1.0,
                          1.0 / jnp.maximum(it - cfg.burnin, 1) ** cfg.alpha)
        temperature = jnp.maximum(
            1.0, cfg.initial_temperature
            * jnp.exp(-cfg.temperature_decay * it))
        n_steps_iter = jnp.where(it <= cfg.burnin, init_steps,
                                 cfg.n_mcmc_steps)

        key, k_iter = jax.random.split(s.key)

        # -- MCMC: scan over steps, each vmapped over individuals -----------
        def mcmc_step(carry, inp):
            rand, acc = carry
            k_step, step_idx = inp
            active = step_idx < n_steps_iter
            k_prop, k_u = jax.random.split(k_step)
            prop = rand + (jax.random.normal(k_prop, (n,), f32)
                           * s.proposal_std)
            prior_ratio = (_normal_logpdf(prop, s.eta, s.omega)
                           - _normal_logpdf(rand, s.eta, s.omega))
            ll_new = population_ll(s.theta, s.sigma, prop)
            ll_cur = population_ll(s.theta, s.sigma, rand)
            log_ratio = prior_ratio + (ll_new - ll_cur) / temperature
            u = jnp.log(jax.random.uniform(k_u, (n,), f32))
            accept = active & (u < log_ratio)          # NaN ratio ⇒ reject
            new = jnp.where(accept, prop, rand)
            # stochastic-approximation blending every step (:184)
            rand = jnp.where(active, (1 - gamma) * rand + gamma * new, rand)
            return (rand, acc + accept.sum()), None

        step_keys = jax.random.split(k_iter, mcmc_max)
        (rand, acc_count), _ = lax.scan(
            mcmc_step, (s.rand, jnp.asarray(0, jnp.int32)),
            (step_keys, jnp.arange(mcmc_max)))

        ll_total = jnp.sum(population_ll(s.theta, s.sigma, rand))

        # -- population (fixed-effect + σ) update ----------------------------
        theta_new, sigma_new = pop_update(s.theta, s.sigma, rand)
        theta = jax.tree.map(lambda a, b: (1 - gamma) * a + gamma * b,
                             s.theta, theta_new)
        sigma = sigma_new                                   # σ not blended

        # -- Ω / η stochastic updates (:204-205) -----------------------------
        var_r = jnp.var(rand, ddof=1)
        if cfg.omega_as_variance:
            omega = jnp.sqrt((1 - cfg.omega_lr) * s.omega**2
                             + cfg.omega_lr * var_r)
        else:
            omega = (1 - cfg.omega_lr) * s.omega + cfg.omega_lr * var_r
        eta = ((1 - cfg.omega_lr) * s.eta + cfg.omega_lr * jnp.mean(rand)
               if cfg.update_prior_mean else s.eta)

        # -- proposal-std adaptation (:215-216) -------------------------------
        acc_rate = acc_count / (n * n_steps_iter)
        log_std = jnp.log(s.proposal_std) + gamma * (
            acc_rate - cfg.target_acceptance)
        proposal_std = jnp.where(
            it <= cfg.burnin, s.proposal_std,
            jnp.clip(jnp.exp(log_std), *cfg.proposal_bounds))

        if cfg.log_every > 0:
            jax.lax.cond(
                it % cfg.log_every == 0,
                lambda: jax.debug.print(
                    "SAEM it={it}  nll={nll:.4f}  acc={acc:.3f}  "
                    "sigma={sig:.4f}  omega={om:.4f}",
                    it=it, nll=-ll_total, acc=acc_rate, sig=sigma,
                    om=omega),
                lambda: None)

        out = (-ll_total, acc_rate, proposal_std)
        return _S(rand=rand, theta=theta, sigma=sigma, omega=omega,
                  eta=eta, proposal_std=proposal_std, key=key), out

    init = _S(
        rand=jnp.full((n,), cfg.prior_eta, f32),
        theta=jax.tree.map(lambda a: jnp.asarray(a, f32), theta0),
        sigma=jnp.asarray(cfg.sigma, f32),
        omega=jnp.asarray(cfg.prior_omega, f32),
        eta=jnp.asarray(cfg.prior_eta, f32),
        proposal_std=jnp.asarray(cfg.proposal_std, f32),
        key=key,
    )

    final, (nll, acc, pstd) = lax.scan(
        iteration, init, jnp.arange(1, cfg.iterations + 1))
    return SAEMResult(theta=final.theta, random_effects=final.rand,
                      omega=final.omega, sigma=final.sigma, eta=final.eta,
                      nll_trace=nll, acceptance_trace=acc,
                      proposal_std_trace=pstd)


# -- cUDE specialization -------------------------------------------------------

def cude_loglik(model: CPeptideModel, timepoints: jax.Array,
                solver: str = "rk4", substeps: int = 8,
                max_steps: int = 256) -> LogLikFn:
    """Gaussian log-likelihood of one individual under the conditional UDE
    (``src/saem.jl:55-66``); −inf on solver failure.  Defaults to the
    fixed-step RK4 throughput path (accuracy ≥ the reference's default
    adaptive tolerance on this model class)."""

    def ll(theta, sigma, rand_i, ind, data):
        err = sse(model, {"neural": theta, "conditional": rand_i}, ind,
                  timepoints, data, solver=solver, substeps=substeps,
                  max_steps=max_steps)
        n_i = timepoints.shape[0]
        val = (-(n_i / 2.0) * jnp.log(sigma**2)
               - err / (2.0 * sigma**2))
        return jnp.where(jnp.isfinite(err), val, -jnp.inf)

    return ll


def saem_cude(
    model: CPeptideModel,
    cohort: Cohort,
    initial_nn_params: jax.Array,
    key: jax.Array,
    config: SAEMConfig | None = None,
) -> SAEMResult:
    """SAEM on the conditional UDE: β_i random effects, NN + σ fixed effects
    (``src/saem.jl:134-237``; driver defaults ``c-peptide/06-saem.jl:76-94``)."""
    cfg = config or SAEMConfig()
    ll = cude_loglik(model, cohort.timepoints)
    return run_saem(ll, initial_nn_params, cohort.individuals,
                    cohort.cpeptide, key, cfg)


# -- symbolic-model specialization ---------------------------------------------

def _lognormal_scalar_loglik(model, param_key: str, timepoints: jax.Array,
                             solver: str, substeps: int,
                             max_steps: int) -> LogLikFn:
    """Gaussian log-likelihood of a model with ONE scalar population
    parameter and the log-normal individual map
    ``param_i = param_pop·e^{η_i}`` (``src/saem-symreg.jl:51-66``);
    −inf on solver failure.  Shared by the symbolic and discovered
    productions."""

    def ll(theta, sigma, eta_i, ind, data):
        p_i = theta * jnp.exp(eta_i)
        err = sse(model, {param_key: p_i}, ind, timepoints, data,
                  solver=solver, substeps=substeps, max_steps=max_steps)
        n_i = timepoints.shape[0]
        val = (-(n_i / 2.0) * jnp.log(sigma**2)
               - err / (2.0 * sigma**2))
        return jnp.where(jnp.isfinite(err), val, -jnp.inf)

    return ll


def symbolic_loglik(timepoints: jax.Array, solver: str = "rk4",
                    substeps: int = 8, max_steps: int = 256) -> LogLikFn:
    """Log-likelihood with the log-normal individual map
    kM_i = kM_pop·e^{η_i} (``src/saem-symreg.jl:51-66``)."""
    # deferred import: models.symbolic itself imports fit.losses
    from conditional_ude_tpu.models.symbolic import symbolic_model

    return _lognormal_scalar_loglik(symbolic_model(), "k", timepoints,
                                    solver, substeps, max_steps)


def saem_symbolic(
    cohort: Cohort,
    initial_km: float,
    key: jax.Array,
    config: SAEMConfig | None = None,
) -> SAEMResult:
    """SAEM on the symbolic model (``src/saem-symreg.jl:134-229``): η_i
    random effects with fixed 0 prior mean, (kM_pop, σ) fixed effects
    updated by 5-iteration L-BFGS."""
    cfg = config or SAEMConfig(pop_update_lbfgs=True, update_prior_mean=False)
    ll = symbolic_loglik(cohort.timepoints)
    return run_saem(ll, jnp.asarray(initial_km, jnp.float32),
                    cohort.individuals, cohort.cpeptide, key, cfg)


def discovered_loglik(timepoints: jax.Array, solver: str = "rk4",
                      substeps: int = 8, max_steps: int = 256) -> LogLikFn:
    """Log-likelihood of the IN-REPO discovered rational production
    (``models.symbolic.discovered_production``) with the same log-normal
    individual map as the reference's symbolic SAEM:
    b_i = b_pop·e^{η_i} (``src/saem-symreg.jl:51-66`` pattern applied to
    this repo's own equation)."""
    from conditional_ude_tpu.models.symbolic import discovered_model

    return _lognormal_scalar_loglik(discovered_model(), "b", timepoints,
                                    solver, substeps, max_steps)


def saem_discovered(
    cohort: Cohort,
    initial_b: float,
    key: jax.Array,
    config: SAEMConfig | None = None,
) -> SAEMResult:
    """SAEM mixed-effects estimation of the discovered rational model:
    η_i random effects (fixed 0 prior mean), (b_pop, σ) fixed effects by
    5-iteration L-BFGS — the ``saem_symbolic`` pipeline with zero
    inherited pieces (the equation comes from this repo's GP search)."""
    cfg = config or SAEMConfig(pop_update_lbfgs=True, update_prior_mean=False)
    ll = discovered_loglik(cohort.timepoints)
    return run_saem(ll, jnp.asarray(initial_b, jnp.float32),
                    cohort.individuals, cohort.cpeptide, key, cfg)


# -- post-hoc per-individual estimators (06-saem.jl:102-135) --------------------

def posterior_chains(
    loglik: LogLikFn,
    theta: Any,
    sigma: jax.Array,
    individuals: Any,
    data: jax.Array,
    key: jax.Array,
    init: jax.Array,            # [N] chain initial states
    eta: jax.Array,
    omega: jax.Array,
    n_steps: int = 3000,
    proposal_std: float | None = None,
    target_acceptance: float = 0.3,
    warmup: int | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Per-individual Metropolis chains at temperature 1 with frozen fixed
    effects; returns (samples[N, n_steps], acceptance_rate[N]).

    The proposal scale adapts **per individual** toward ``target_acceptance``
    (Robbins–Monro on the log-scale) during the first ``warmup`` steps
    (default ``n_steps // 3``) and then freezes, so the post-warmup segment
    is a valid Markov chain.  ``proposal_std=None`` starts the scale at the
    prior scale Ω — a fixed small scale against a wide prior leaves the
    chains essentially unmixed (the reference's fixed 3000-step pass at
    ``c-peptide/06-saem.jl:102-135`` relies on a hand-tuned scale instead).
    The returned acceptance rate is measured over the post-warmup segment.
    """
    n = data.shape[0]
    f32 = jnp.float32
    if warmup is None:
        warmup = n_steps // 3
    scale0 = (jnp.maximum(jnp.asarray(omega, f32), 1e-3)
              if proposal_std is None else jnp.asarray(proposal_std, f32))
    v_ll = jax.vmap(loglik, in_axes=(None, None, 0, 0, 0))

    # carry the current state's log-likelihood: fixed effects are frozen
    # here, so it only changes on acceptance — re-solving the ODEs for the
    # unchanged state every step would double the chain's cost
    def step(carry, inp):
        rand, ll_cur, log_std, acc = carry
        k_step, t = inp
        k_prop, k_u = jax.random.split(k_step)
        prop = rand + jax.random.normal(k_prop, (n,), f32) * jnp.exp(log_std)
        ll_prop = v_ll(theta, sigma, prop, individuals, data)
        log_ratio = (_normal_logpdf(prop, eta, omega)
                     - _normal_logpdf(rand, eta, omega)
                     + ll_prop - ll_cur)
        accept = jnp.log(jax.random.uniform(k_u, (n,))) < log_ratio
        rand = jnp.where(accept, prop, rand)
        ll_cur = jnp.where(accept, ll_prop, ll_cur)
        lr = 1.0 / (1.0 + t.astype(f32)) ** 0.6
        log_std = jnp.where(
            t < warmup,
            log_std + lr * (accept.astype(f32) - target_acceptance),
            log_std)
        acc = acc + jnp.where(t >= warmup, accept.astype(jnp.int32), 0)
        return (rand, ll_cur, log_std, acc), rand

    ll0 = v_ll(theta, sigma, init, individuals, data)
    (_, _, _, acc), samples = lax.scan(
        step,
        (init.astype(f32), ll0, jnp.full((n,), jnp.log(scale0), f32),
         jnp.zeros((n,), jnp.int32)),
        (jax.random.split(key, n_steps), jnp.arange(n_steps)))
    return jnp.swapaxes(samples, 0, 1), acc / max(n_steps - warmup, 1)


def individual_maps(
    loglik: LogLikFn,
    theta: Any,
    sigma: jax.Array,
    individuals: Any,
    data: jax.Array,
    init: jax.Array,
    eta: jax.Array,
    omega: jax.Array,
    max_iters: int = 100,
) -> jax.Array:
    """Per-individual MAP estimates: argmin −(LL + log N(η, Ω))
    (``src/saem.jl:68-84``), batched L-BFGS instead of a serial loop."""

    def one(r0, ind, d):
        def obj(x):
            ll = loglik(theta, sigma, x[0], ind, d)
            return -(ll + _normal_logpdf(x[0], eta, omega))

        return lbfgs_minimize(obj, r0[None], max_iters=max_iters).x[0]

    return jax.vmap(one)(init, individuals, data)


def individual_mles(
    loglik: LogLikFn,
    theta: Any,
    sigma: jax.Array,
    individuals: Any,
    data: jax.Array,
    init: jax.Array,
    max_iters: int = 100,
) -> jax.Array:
    """Per-individual maximum-likelihood estimates (no prior), batched."""

    def one(r0, ind, d):
        def obj(x):
            return -loglik(theta, sigma, x[0], ind, d)

        return lbfgs_minimize(obj, r0[None], max_iters=max_iters).x[0]

    return jax.vmap(one)(init, individuals, data)

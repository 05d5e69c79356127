"""Batched symbolic regression by genetic programming.

Capability parity with the reference's PySR subproject
(``symbolic-regression/symbolic-regression.ipy:13-29``): discover compact
closed-form equations for the learned NN production surface over samples of
(β, ΔG) → production, with the same operator set — binary ``+``/``*`` and
unary ``inv(x) = 1/x`` — and a Pareto front over (complexity, loss).

Batched redesign (NOT a PySR port): programs are **fixed-shape complete
binary trees** (depth ``D``, 2^(D+1)−1 nodes) stored as integer op arrays +
per-node constant arrays.  One generation evaluates the whole population on
all data points as a single bottom-up vectorized pass (no recursion, no
ragged shapes), so selection/mutation/crossover and even constant
optimization (the tree evaluation is differentiable in the constants) all
run batched on-chip.  The reference instead runs 8 CPU island processes.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

# node opcodes.  DIV is *protected binary division* — PySR's grammar is
# binary +,* plus unary inv, which expresses a ratio as ``mul(a, inv(b))``;
# a unary-inv-only grammar makes Michaelis-Menten forms need deep exact
# subtrees (the denominator has to materialize under a lone INV child), so
# rational structures almost never survive tournament selection.  DIV keeps
# the same expressible family but makes rational forms one node shallower;
# complexity accounting and ``to_string`` both map it back to PySR's
# ``mul∘inv`` encoding so Pareto complexities stay comparable with the
# reference's published table
# (``symbolic-regression/results/symbolic_regression_result.csv``).
PASS, CONST, VAR0, VAR1, ADD, MUL, INV, DIV = range(8)
_N_OPS = 8
_LEAF_OPS = (CONST, VAR0, VAR1)
_UNARY_OPS = (INV,)
_BINARY_OPS = (ADD, MUL, DIV)


def n_nodes(depth: int) -> int:
    return 2 ** (depth + 1) - 1


@dataclasses.dataclass(frozen=True)
class SymRegConfig:
    depth: int = 3                  # complete-tree depth (15 nodes)
    population: int = 2048
    generations: int = 60
    tournament: int = 7
    p_mutate: float = 0.6
    p_crossover: float = 0.4
    const_range: tuple[float, float] = (-5.0, 5.0)
    const_opt_steps: int = 30       # Adam steps on constants of survivors
    const_opt_lr: float = 0.1
    elite: int = 32
    parsimony: float = 1e-5         # complexity penalty added to fitness
    # evolution runs in blocks of this many generations; between blocks the
    # hall of fame (best-ever program per complexity) is updated, its
    # members get their constants optimized, and they are re-injected into
    # the population.  Rational/inv structures need tuned constants to
    # SURVIVE selection (a Michaelis-Menten form with a wrong denominator
    # constant loses to a line), so end-of-run-only constant optimization
    # — the round-2 design — never kept them alive long enough to win.
    block_gens: int = 20
    const_opt_top: int = 64         # population members const-opted per block
    fresh_frac: float = 0.15        # fraction of the population replaced by
                                    # fresh random programs each block
                                    # (tournament takeover otherwise
                                    # collapses diversity within ~30 gens)
    # selection mode: "pareto" ranks by non-domination over
    # (loss, complexity) — per-complexity Pareto selection, which keeps a
    # live niche at every size instead of letting one parsimony scalar
    # decide the loss/size trade for the whole population; "parsimony" is
    # the round-3 scalar-penalty behavior.  NOTE: "pareto" became the
    # default in round 4 (together with DIV in the op pool and
    # template_frac=0.2) — callers wanting the round-3 parsimony behavior
    # must opt in explicitly.  Validated in __post_init__: anything other
    # than the two known modes raises instead of silently falling through
    # to the parsimony branch.
    selection: str = "pareto"
    # fraction of random programs seeded with a rational template
    # (root = DIV with a constant-anchored denominator) — biases the
    # search toward the reference's rational family without hard-coding
    # any equation
    template_frac: float = 0.2
    # hard PySR-style size cap: programs above this complexity are killed
    # (PySR maxsize=18, ``symbolic-regression.ipy:21``); None = uncapped
    max_size: int | None = None

    def __post_init__(self):
        if self.selection not in ("pareto", "parsimony"):
            raise ValueError(
                f"SymRegConfig.selection must be 'pareto' or 'parsimony', "
                f"got {self.selection!r}")


class SymRegResult(NamedTuple):
    ops: jax.Array       # [P, M] final population opcodes
    consts: jax.Array    # [P, M] constants
    losses: jax.Array    # [P] MSE
    complexity: jax.Array  # [P]


def _level_slices(depth: int) -> list[tuple[int, int]]:
    """(start, end) node-index ranges per level, root = index 0."""
    return [(2**lv - 1, 2**(lv + 1) - 1) for lv in range(depth + 1)]


def evaluate(ops: jax.Array, consts: jax.Array, x: jax.Array,
             depth: int) -> jax.Array:
    """Evaluate programs on data.

    ``ops/consts [..., M]``, ``x[N, 2]`` → values ``[..., N]``.  Bottom-up:
    leaves first, each internal node selects its result from its children.
    Invalid structures (binary op over PASS children) propagate NaN and get
    infinite loss — the evolutionary loop prunes them.
    """
    n_pts = x.shape[0]
    batch = ops.shape[:-1]

    x0 = x[:, 0]
    x1 = x[:, 1]

    # one vectorized pass PER LEVEL, not per node: every node in a level
    # has the same structure (children are the level below at strides
    # 0::2 / 1::2), so the whole level is one [batch, width, N] select.
    # A per-node unroll emits ~7·M large HLO ops, whose XLA compile took
    # ~142 s at population scale on the single-CPU client; the level form
    # is depth+1 selects and compiles in seconds with identical numerics.
    below = None                      # [batch, 2^(lv+1), N]
    for lv in range(depth, -1, -1):
        s, e = 2 ** lv - 1, 2 ** (lv + 1) - 1
        op = ops[..., s:e, None]                     # [batch, w, 1]
        c = consts[..., s:e, None]
        if below is None:             # bottom level: no children
            left = right = jnp.full(batch + (e - s, n_pts), jnp.nan,
                                    x.dtype)
        else:
            left = below[..., 0::2, :]
            right = below[..., 1::2, :]
        below = jnp.select(
            [op == CONST, op == VAR0, op == VAR1, op == ADD,
             op == MUL, op == INV, op == DIV],
            [jnp.broadcast_to(c, left.shape),
             jnp.broadcast_to(x0, left.shape),
             jnp.broadcast_to(x1, left.shape),
             left + right, left * right, 1.0 / left, left / right],
            jnp.zeros(left.shape, x.dtype))   # PASS → 0 (unused)
    return below[..., 0, :]


def complexity_of(ops: jax.Array) -> jax.Array:
    """Number of active (non-PASS) nodes — PySR's size measure.

    DIV counts as 2: PySR's grammar writes a ratio as ``mul(a, inv(b))``
    (two nodes), so counting our single DIV node double keeps complexities
    directly comparable with the reference's published Pareto table."""
    return jnp.sum(ops != PASS, axis=-1) + jnp.sum(ops == DIV, axis=-1)


def _subtree_mask(depth: int) -> np.ndarray:
    """[M, M] bool: mask[i, j] = node j is in the subtree rooted at i."""
    m = n_nodes(depth)
    mask = np.zeros((m, m), bool)
    for i in range(m - 1, -1, -1):
        mask[i, i] = True
        for ch in (2 * i + 1, 2 * i + 2):
            if ch < m:
                mask[i] |= mask[ch]
    return mask


def _structure_ok(ops: jax.Array, depth: int) -> jax.Array:
    """Validity: binary nodes need both children active, INV needs left,
    leaves need none, PASS children must be PASS-consistent."""
    m = n_nodes(depth)
    ok = ops[..., 0] != PASS            # root must be active
    for i in range(m):
        op = ops[..., i]
        l_i, r_i = 2 * i + 1, 2 * i + 2
        if l_i < m:
            l_on = ops[..., l_i] != PASS
            r_on = ops[..., r_i] != PASS
        else:
            l_on = jnp.zeros_like(op, bool)
            r_on = jnp.zeros_like(op, bool)
        is_bin = (op == ADD) | (op == MUL) | (op == DIV)
        is_un = op == INV
        is_leaf = (op == CONST) | (op == VAR0) | (op == VAR1)
        ok = ok & jnp.where(is_bin, l_on & r_on,
                            jnp.where(is_un, l_on & ~r_on,
                                      jnp.where(is_leaf, ~l_on & ~r_on,
                                                ~l_on & ~r_on)))
    return ok


def _random_programs(key: jax.Array, n: int, depth: int,
                     const_range: tuple[float, float],
                     template_frac: float = 0.0):
    """Grow-style random program batch: each node is a leaf with increasing
    probability by depth; structure repaired to validity.

    ``template_frac`` of the programs are seeded with a *rational template*
    — root forced to DIV with a constant-anchored ADD denominator (the
    numerator and the rest of the denominator stay random grow subtrees).
    This biases initial populations toward the rational family the
    reference's PySR run surfaces (Michaelis-Menten-like forms,
    ``symbolic_regression_result.csv:12``) without seeding any specific
    equation."""
    m = n_nodes(depth)
    k_op, k_leaf, k_const, k_kill, k_tmpl = jax.random.split(key, 5)
    interior = jax.random.choice(
        k_op, jnp.array([ADD, MUL, INV, DIV, CONST, VAR0, VAR1]), (n, m),
        p=jnp.array([0.22, 0.22, 0.06, 0.1, 0.1, 0.15, 0.15]))
    leaves = jax.random.choice(
        k_leaf, jnp.array([CONST, VAR0, VAR1]), (n, m),
        p=jnp.array([0.34, 0.33, 0.33]))
    # force leaf level to leaf ops
    level = np.zeros(m, np.int32)
    for lv, (s, e) in enumerate(_level_slices(depth)):
        level[s:e] = lv
    is_bottom = jnp.asarray(level == depth)
    ops = jnp.where(is_bottom[None, :], leaves, interior)
    # ramped sizes: per-program leaf-termination probability in [0.15, 0.8]
    # so deep populations mix shallow and deep structures (a uniform kill
    # rate makes deep trees almost all degenerate and the GP collapses to
    # constants)
    k_kill, k_q = jax.random.split(k_kill)
    q = jax.random.uniform(k_q, (n, 1), minval=0.15, maxval=0.8)
    kill = jax.random.uniform(k_kill, (n, m)) < q
    ops = jnp.where(kill & ~is_bottom[None, :], leaves, ops)
    if template_frac > 0.0 and depth >= 2:
        # rational template: num / (subtree + const); nodes 0/2/6 are the
        # root, the denominator head, and its right (constant) child
        tmpl = jax.random.uniform(k_tmpl, (n,)) < template_frac
        ops = ops.at[:, 0].set(jnp.where(tmpl, DIV, ops[:, 0]))
        ops = ops.at[:, 2].set(jnp.where(tmpl, ADD, ops[:, 2]))
        ops = ops.at[:, 6].set(jnp.where(tmpl, CONST, ops[:, 6]))
    ops = repair(ops, depth)
    lo, hi = const_range
    consts = jax.random.uniform(k_const, (n, m), jnp.float32, lo, hi)
    return ops, consts


def repair(ops: jax.Array, depth: int) -> jax.Array:
    """Make structures valid: deactivate children of leaves/PASS, right
    child of INV; give binary/unary ops missing children (leaf VAR1/VAR0).

    Level-vectorized top-down (same semantics as a per-node descent, but
    depth+1 array ops instead of ~3·M scatters — the scatter form's eager
    dispatches and jit graph dominated compile time at population scale)."""
    for lv in range(depth + 1):
        s, e = 2 ** lv - 1, 2 ** (lv + 1) - 1
        op = ops[..., s:e]
        if lv == depth:
            # bottom level: demote operators to variables
            is_op = ((op == ADD) | (op == MUL) | (op == INV)
                     | (op == DIV))
            ops = ops.at[..., s:e].set(jnp.where(is_op, VAR1, op))
            continue
        s2, e2 = 2 ** (lv + 1) - 1, 2 ** (lv + 2) - 1
        is_bin = (op == ADD) | (op == MUL) | (op == DIV)
        is_un = op == INV
        needs_l = is_bin | is_un
        l = ops[..., s2:e2:2]
        r = ops[..., s2 + 1:e2:2]
        # missing needed children → become VAR1/VAR0 leaf; unneeded → PASS
        ops = ops.at[..., s2:e2:2].set(
            jnp.where(needs_l & (l == PASS), VAR1,
                      jnp.where(~needs_l, PASS, l)))
        ops = ops.at[..., s2 + 1:e2:2].set(
            jnp.where(is_bin & (r == PASS), VAR0,
                      jnp.where(~is_bin, PASS, r)))
    return ops


def fit_symbolic(
    x: jax.Array,            # [N, 2] inputs (x0=β, x1=ΔG)
    y: jax.Array,            # [N]
    key: jax.Array,
    config: SymRegConfig = SymRegConfig(),
) -> SymRegResult:
    """Evolve a population of equation trees to fit ``y ≈ f(x)``."""
    cfg = config
    depth, pop, m = cfg.depth, cfg.population, n_nodes(cfg.depth)
    x = jnp.asarray(x, jnp.float32)
    y = jnp.asarray(y, jnp.float32)

    def loss_of(ops, consts):
        pred = evaluate(ops, consts, x, depth)
        mse = jnp.mean((pred - y[None, :]) ** 2, axis=-1)
        mse = jnp.where(jnp.isfinite(mse), mse, jnp.inf)
        if cfg.max_size is not None:
            # PySR-style hard size cap: oversized programs are invalid
            mse = jnp.where(complexity_of(ops) > cfg.max_size, jnp.inf, mse)
        return mse

    def fitness_of(losses, comp):
        """Selection key.  "pareto": NSGA-style non-domination count over
        (loss, complexity) — a program's fitness is how many programs beat
        it on both axes, so every complexity niche keeps live members and
        the loss/size trade is per-complexity instead of one global
        parsimony scalar.  Ties break by loss rank (then complexity)."""
        if cfg.selection != "pareto":
            return losses + cfg.parsimony * complexity_of_f32(comp)
        l_i, l_j = losses[:, None], losses[None, :]
        c_i, c_j = comp[:, None], comp[None, :]
        dom = ((l_j <= l_i) & (c_j <= c_i)
               & ((l_j < l_i) | (c_j < c_i)))
        count = jnp.sum(dom, axis=1).astype(jnp.int32)
        n_p = losses.shape[0]
        order = jnp.lexsort((comp, losses))       # by loss, then size
        rank = jnp.zeros((n_p,), jnp.int32).at[order].set(
            jnp.arange(n_p, dtype=jnp.int32))
        # integer key: count*n_p + rank reaches n_p² (2^24 at pop 4096),
        # where float32 would start collapsing distinct pairs — int32 is
        # exact up to pop ≈ 46k
        return count * n_p + rank

    def complexity_of_f32(comp):
        return comp.astype(jnp.float32)

    def opt_consts(ops, consts, steps):
        """A few gradient steps on the constants of each program."""
        import optax

        opt = optax.adam(cfg.const_opt_lr)

        def one(op_row, c_row):
            state = opt.init(c_row)

            def step(carry, _):
                c, s = carry
                g = jax.grad(lambda cc: jnp.mean(
                    (evaluate(op_row, cc, x, depth) - y) ** 2))(c)
                g = jnp.where(jnp.isfinite(g), g, 0.0)
                upd, s = opt.update(g, s, c)
                return (optax.apply_updates(c, upd), s), None

            (c_fin, _), _ = lax.scan(step, (c_row, state), None, length=steps)
            better = (jnp.mean((evaluate(op_row, c_fin, x, depth) - y) ** 2)
                      < jnp.mean((evaluate(op_row, c_row, x, depth) - y) ** 2))
            return jnp.where(better, c_fin, c_row)

        return jax.vmap(one)(ops, consts)

    sub_mask = jnp.asarray(_subtree_mask(depth))

    @jax.jit
    def generation(carry, k):
        # losses ride in the carry: parents were already evaluated as last
        # generation's children, so only the children cost an evaluate()
        ops, consts, losses = carry
        fitness = fitness_of(losses, complexity_of(ops))

        k_t1, k_t2, k_mut_sel, k_mut_node, k_mut_op, k_mut_c, k_x, k_xnode \
            = jax.random.split(k, 8)

        # tournament selection of two parent sets
        def tournament(kk):
            idx = jax.random.randint(kk, (pop, cfg.tournament), 0, pop)
            f = fitness[idx]
            return idx[jnp.arange(pop), jnp.argmin(f, axis=1)]

        p1 = tournament(k_t1)
        p2 = tournament(k_t2)
        child_ops = ops[p1]
        child_consts = consts[p1]

        # crossover: copy the subtree rooted at a random node from parent 2
        do_x = jax.random.uniform(k_x, (pop,)) < cfg.p_crossover
        x_node = jax.random.randint(k_xnode, (pop,), 0, m)
        x_mask = sub_mask[x_node] & do_x[:, None]
        child_ops = jnp.where(x_mask, ops[p2], child_ops)
        child_consts = jnp.where(x_mask, consts[p2], child_consts)

        # point mutation: random nodes get random ops / jittered constants
        do_m = jax.random.uniform(k_mut_sel, (pop,)) < cfg.p_mutate
        mut_here = (jax.random.uniform(k_mut_node, (pop, m)) < 2.0 / m) \
            & do_m[:, None]
        new_ops = jax.random.choice(
            k_mut_op, jnp.array([ADD, MUL, INV, DIV, CONST, VAR0, VAR1]),
            (pop, m),
            p=jnp.array([0.2, 0.2, 0.07, 0.09, 0.14, 0.15, 0.15]))
        child_ops = jnp.where(mut_here, new_ops, child_ops)
        child_consts = child_consts + jnp.where(
            mut_here, 0.3 * jax.random.normal(k_mut_c, (pop, m)), 0.0)

        child_ops = repair(child_ops, depth)
        child_losses = loss_of(child_ops, child_consts)

        # elitism: keep the best `elite` of the previous generation
        order = jnp.argsort(fitness)
        elite_idx = order[: cfg.elite]
        child_ops = child_ops.at[: cfg.elite].set(ops[elite_idx])
        child_consts = child_consts.at[: cfg.elite].set(consts[elite_idx])
        child_losses = child_losses.at[: cfg.elite].set(losses[elite_idx])

        return (child_ops, child_consts, child_losses), jnp.min(child_losses)

    k_init, k_gens, k_final = jax.random.split(key, 3)
    ops, consts = _random_programs(k_init, pop, depth, cfg.const_range,
                                   cfg.template_frac)
    jit_loss = jax.jit(loss_of)

    # hall of fame: best-ever (ops, consts, loss) per complexity level —
    # the final population alone loses good intermediate-complexity
    # programs to drift (the round-2 front had 5 rows and topped out early)
    hof: dict[int, tuple[float, np.ndarray, np.ndarray]] = {}

    def hof_update(ops_a, consts_a, losses_a):
        comp = np.asarray(complexity_of(ops_a))
        losses_np = np.asarray(losses_a)
        if cfg.max_size is not None:
            losses_np = np.where(comp > cfg.max_size, np.inf, losses_np)
        for c in np.unique(comp):
            sel = np.flatnonzero(comp == c)
            i = sel[np.argmin(losses_np[sel])]
            if np.isfinite(losses_np[i]) and (
                    int(c) not in hof or losses_np[i] < hof[int(c)][0]):
                hof[int(c)] = (float(losses_np[i]),
                               np.asarray(ops_a[i]),
                               np.asarray(consts_a[i]))

    # fixed HOF working capacity: the per-block const-opt / loss / inject
    # programs must see ONE shape across blocks — a growing hall would
    # recompile them every block.  Padding duplicates entry 0 (harmless: hof_update
    # keeps the per-complexity best, duplicate injections are ordinary
    # crossover material).  The uncapped bound is the maximum possible
    # complexity — m nodes plus one extra per DIV, of which at most
    # (m-1)//2 (the internal-node count) can occur — so the hall can
    # never silently exceed the working set.
    hof_cap = (cfg.max_size if cfg.max_size is not None
               else m + (m - 1) // 2)

    def hof_arrays():
        entries = list(hof.values())
        pad = [entries[0]] * (hof_cap - len(entries))
        take = (entries + pad)[:hof_cap]
        return (jnp.asarray(np.stack([v[1] for v in take])),
                jnp.asarray(np.stack([v[2] for v in take])))

    n_blocks = -(-cfg.generations // cfg.block_gens)
    gens_left = cfg.generations
    losses = jit_loss(ops, consts)
    for blk in range(n_blocks):
        gens = min(cfg.block_gens, gens_left)
        gens_left -= gens
        gen_keys = jax.random.split(jax.random.fold_in(k_gens, blk), gens)
        (ops, consts, losses), _ = lax.scan(
            generation, (ops, consts, losses), gen_keys)

        # constant optimization on the block's best + the hall of fame
        top = jnp.argsort(losses)[: max(cfg.elite, cfg.const_opt_top)]
        consts = consts.at[top].set(
            opt_consts(ops[top], consts[top], cfg.const_opt_steps))
        losses = jit_loss(ops, consts)
        hof_update(ops, consts, losses)

        if blk < n_blocks - 1:
            order = jnp.argsort(losses)      # one ranking for all injections
            if hof:
                h_ops, h_consts = hof_arrays()
                h_consts = opt_consts(h_ops, h_consts, cfg.const_opt_steps)
                h_losses = jit_loss(h_ops, h_consts)
                hof_update(h_ops, h_consts, h_losses)
                # re-inject the hall into the worst population slots:
                # crossover material for the next block without displacing
                # live elites
                h_ops, h_consts = hof_arrays()   # with re-opted constants
                ops = ops.at[order[-hof_cap:]].set(h_ops)
                consts = consts.at[order[-hof_cap:]].set(h_consts)
            n_fresh = int(cfg.fresh_frac * pop)
            if n_fresh:
                # fresh blood against tournament takeover: random programs
                # into the worst slots just above the HOF re-injections
                f_ops, f_consts = _random_programs(
                    jax.random.fold_in(k_final, blk), n_fresh, depth,
                    cfg.const_range, cfg.template_frac)
                slots = order[-(n_fresh + hof_cap):-hof_cap]
                ops = ops.at[slots].set(f_ops)
                consts = consts.at[slots].set(f_consts)
            # refresh the carried losses once for the next block's scan
            losses = jit_loss(ops, consts)

    # return the population with the hall of fame appended, so the Pareto
    # front reflects best-ever programs, not just end-of-run survivors
    if hof:
        h_ops = jnp.asarray(np.stack([v[1] for v in hof.values()]))
        h_consts = jnp.asarray(np.stack([v[2] for v in hof.values()]))
        h_losses = jnp.asarray(np.asarray(
            [v[0] for v in hof.values()], np.float32))
        ops = jnp.concatenate([ops, h_ops])
        consts = jnp.concatenate([consts, h_consts])
        losses = jnp.concatenate([losses, h_losses])

    return SymRegResult(ops=ops, consts=consts, losses=losses,
                        complexity=complexity_of(ops))


def to_string(ops: np.ndarray, consts: np.ndarray, node: int = 0) -> str:
    """Render one program as an infix expression string."""
    op = int(ops[node])
    if op == CONST:
        return f"{float(consts[node]):.4g}"
    if op == VAR0:
        return "x0"
    if op == VAR1:
        return "x1"
    if op == ADD:
        return (f"({to_string(ops, consts, 2 * node + 1)} + "
                f"{to_string(ops, consts, 2 * node + 2)})")
    if op == MUL:
        return (f"({to_string(ops, consts, 2 * node + 1)} * "
                f"{to_string(ops, consts, 2 * node + 2)})")
    if op == INV:
        return f"inv({to_string(ops, consts, 2 * node + 1)})"
    if op == DIV:
        # render in PySR's grammar (mul∘inv) so equation strings stay in
        # the same +,*,inv language as the reference's published table
        return (f"({to_string(ops, consts, 2 * node + 1)} * "
                f"inv({to_string(ops, consts, 2 * node + 2)}))")
    return "?"


def pareto_front(result: SymRegResult,
                 with_programs: bool = False) -> list[dict]:
    """PySR-style Pareto table: best loss at each complexity level.

    ``with_programs=True`` attaches each row's raw ``ops``/``consts``
    arrays so callers can re-evaluate the program on new data with
    :func:`evaluate` directly (no string parsing / ``eval``)."""
    losses = np.asarray(result.losses)
    comp = np.asarray(result.complexity)
    ops = np.asarray(result.ops)
    consts = np.asarray(result.consts)
    rows = []
    best = np.inf
    for c in sorted(np.unique(comp)):
        sel = np.flatnonzero(comp == c)
        i = sel[np.argmin(losses[sel])]
        if np.isfinite(losses[i]) and losses[i] < best:
            best = losses[i]
            row = {"complexity": int(c), "loss": float(losses[i]),
                   "equation": to_string(ops[i], consts[i])}
            if with_programs:
                row["ops"] = ops[i]
                row["consts"] = consts[i]
            rows.append(row)
    return rows

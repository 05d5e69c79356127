"""Tiny MLP with flat parameter vectors.

The production-term networks in the cUDE framework are minuscule (tens of
parameters), and the fitting engine treats parameters as flat vectors so the
multi-start axis is just a leading array dimension (``params[R, P]``).  This
module provides a functional MLP whose parameters live in a single flat
``jnp`` vector, with a softplus output head by default.

Capability parity: reference ``src/neural-network.jl:42-107`` (SimpleChains
``chain(widths, fns; input_dims, output_dims, output_activation=softplus)``)
and its init distribution (Glorot-uniform weights, zero biases).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import jax
import jax.numpy as jnp

Activation = Callable[[jax.Array], jax.Array]

_ACTIVATIONS: dict[str, Activation] = {
    "tanh": jnp.tanh,
    "relu": jax.nn.relu,
    "softplus": jax.nn.softplus,
    "identity": lambda x: x,
    "gelu": jax.nn.gelu,
    "sigmoid": jax.nn.sigmoid,
}


def resolve_activation(act: str | Activation) -> Activation:
    if callable(act):
        return act
    try:
        return _ACTIVATIONS[act]
    except KeyError:
        raise ValueError(
            f"Unknown activation {act!r}; known: {sorted(_ACTIVATIONS)}"
        ) from None


@dataclasses.dataclass(frozen=True)
class MLP:
    """A dense feed-forward network with flat-vector parameters.

    ``widths`` are the hidden-layer widths; the output layer is appended
    automatically with ``output_activation`` (softplus by default, matching
    the reference's positive production head).
    """

    input_dims: int
    widths: tuple[int, ...]
    activations: tuple[str, ...]
    output_dims: int = 1
    output_activation: str = "softplus"

    def __post_init__(self):
        if len(self.widths) == 0:
            raise ValueError("widths must be non-empty")
        if len(self.widths) != len(self.activations):
            raise ValueError(
                "number of widths must match number of activation functions"
            )

    @property
    def layer_dims(self) -> tuple[tuple[int, int], ...]:
        """Sequence of (fan_in, fan_out) per dense layer, output included."""
        dims = []
        fan_in = self.input_dims
        for w in self.widths:
            dims.append((fan_in, w))
            fan_in = w
        dims.append((fan_in, self.output_dims))
        return tuple(dims)

    @property
    def num_params(self) -> int:
        return sum(fi * fo + fo for fi, fo in self.layer_dims)

    # -- parameter handling -------------------------------------------------

    def init(self, key: jax.Array, dtype=jnp.float32) -> jax.Array:
        """Glorot-uniform weights, zero biases, returned as one flat vector."""
        parts = []
        for fi, fo in self.layer_dims:
            key, sub = jax.random.split(key)
            bound = math.sqrt(6.0 / (fi + fo))
            w = jax.random.uniform(sub, (fo, fi), dtype, -bound, bound)
            parts.append(w.reshape(-1))
            parts.append(jnp.zeros((fo,), dtype))
        return jnp.concatenate(parts)

    def init_batch(self, key: jax.Array, n: int, dtype=jnp.float32) -> jax.Array:
        """``n`` independent initial parameter vectors, shape ``[n, P]``."""
        keys = jax.random.split(key, n)
        return jax.vmap(lambda k: self.init(k, dtype))(keys)

    def unflatten(self, flat: jax.Array) -> list[tuple[jax.Array, jax.Array]]:
        """Split a flat vector into per-layer (W[fo,fi], b[fo]) pairs."""
        layers = []
        i = 0
        for fi, fo in self.layer_dims:
            w = flat[..., i : i + fi * fo].reshape(*flat.shape[:-1], fo, fi)
            i += fi * fo
            b = flat[..., i : i + fo]
            i += fo
            layers.append((w, b))
        return layers

    # -- forward -------------------------------------------------------------

    def apply(self, flat: jax.Array, x: jax.Array) -> jax.Array:
        """Evaluate the network.

        ``flat`` has shape ``[..., P]`` and ``x`` shape ``[..., input_dims]``
        with broadcast-compatible batch dims; returns ``[..., output_dims]``.
        """
        layers = self.unflatten(flat)
        acts = [resolve_activation(a) for a in self.activations] + [
            resolve_activation(self.output_activation)
        ]
        h = x
        for (w, b), act in zip(layers, acts):
            # HIGHEST: at default precision a GPU may take float32
            # contractions in TF32 (about three decimal digits), which
            # injects ~1e-3 relative error into the ODE right-hand side;
            # these matrices are tiny so full float32 costs nothing
            h = jnp.einsum("...oi,...i->...o", w, h,
                           precision=jax.lax.Precision.HIGHEST) + b
            h = act(h)
        return h

    def scalar(self, flat: jax.Array, x: jax.Array) -> jax.Array:
        """Scalar output convenience: squeeze the trailing output dim."""
        return self.apply(flat, x)[..., 0]


def chain(
    width: int | Sequence[int],
    depth: int | None = None,
    activation: str | Activation = "tanh",
    *,
    input_dims: int = 2,
    output_dims: int = 1,
    output_activation: str = "softplus",
) -> MLP:
    """Factory mirroring the reference's ``chain`` overloads.

    ``chain(4, 2, "tanh")`` → two hidden tanh layers of width 4 with a
    softplus scalar head (reference ``src/neural-network.jl:105-107``);
    ``chain([4, 8], "tanh")`` mirrors the widths-vector overload (:85-87).
    """
    if isinstance(width, int):
        if depth is None:
            raise ValueError("depth required when width is an int")
        widths = (width,) * depth
    else:
        widths = tuple(width)
    act_name = activation if isinstance(activation, str) else activation.__name__
    return MLP(
        input_dims=input_dims,
        widths=widths,
        activations=(act_name,) * len(widths),
        output_dims=output_dims,
        output_activation=output_activation,
    )

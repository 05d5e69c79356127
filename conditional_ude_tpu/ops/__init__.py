"""Numerical compute ops: integrators, interpolation, batched optimizers."""

from conditional_ude_tpu.ops.interp import LinearInterp
from conditional_ude_tpu.ops.tsit5 import solve_tsit5, SolveResult
from conditional_ude_tpu.ops.rk4 import solve_rk4
from conditional_ude_tpu.ops.lbfgs import (
    lbfgs_minimize,
    LBFGSResult,
    LBFGSState,
)

__all__ = [
    "LinearInterp",
    "solve_tsit5",
    "solve_rk4",
    "SolveResult",
    "lbfgs_minimize",
    "LBFGSResult",
    "LBFGSState",
]

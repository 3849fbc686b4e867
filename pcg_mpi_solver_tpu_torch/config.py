"""Typed configuration of the PyTorch port.

The fields and defaults of ``pcg_mpi_solver_tpu/config.py`` that the
structured-cube solve reads.  Options the JAX package offers beyond this
slice keep their names here so a config that asks for one fails loudly
(``Solver`` raises ``NotImplementedError`` naming the ROADMAP queue item
that brings it) instead of being silently ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

# Canonical name sets, copied from the JAX package so an unknown name is a
# ValueError at construction while a known-but-unported one reaches the
# solver's NotImplementedError.
PCG_VARIANTS = ("classic", "fused", "pipelined")
PRECONDS = ("jacobi", "block3", "mg")
PRECISION_MODES = ("direct", "mixed")


@dataclasses.dataclass
class SolverConfig:
    """PCG solver parameters."""

    tol: float = 1e-7
    max_iter: int = 10000
    # "direct": one PCG in ``dtype``; "mixed": f32 Krylov iterations inside
    # f64 iterative-refinement restarts (solver/pcg.pcg_mixed).
    precision_mode: str = "direct"
    dtype: str = "float64"        # storage dtype: "float32" | "float64"
    dot_dtype: str = "float64"    # accumulation dtype for reductions
    inner_tol: float = 1e-5       # per-refinement-cycle residual reduction (mixed)
    max_stag_steps: int = 3
    pcg_variant: str = "classic"
    nrhs: int = 1
    precond: str = "jacobi"
    # Accepted for config compatibility and ignored: the port always runs
    # a solve as one host-driven loop (the JAX package's chunked dispatch
    # is bit-identical to its one-shot solve by contract, so the math is
    # the same either way).
    iters_per_dispatch: int = -1

    def __post_init__(self):
        if self.pcg_variant not in PCG_VARIANTS:
            raise ValueError(f"SolverConfig.pcg_variant must be one of "
                             f"{PCG_VARIANTS}, got {self.pcg_variant!r}")
        if self.precond not in PRECONDS:
            raise ValueError(f"SolverConfig.precond must be one of "
                             f"{PRECONDS}, got {self.precond!r}")
        if self.precision_mode not in PRECISION_MODES:
            raise ValueError(f"SolverConfig.precision_mode must be one of "
                             f"{PRECISION_MODES}, got {self.precision_mode!r}")
        for name in ("dtype", "dot_dtype"):
            if getattr(self, name) not in ("float32", "float64"):
                raise ValueError(f"SolverConfig.{name} must be 'float32' or "
                                 f"'float64', got {getattr(self, name)!r}")


@dataclasses.dataclass
class TimeHistoryConfig:
    """Quasi-static time stepping: ``time_step_delta[t]`` scales both the
    prescribed displacement ``Ud`` and the reference load ``F`` at step t
    (Dirichlet lifting); step 0 is skipped."""

    time_step_delta: Sequence[float] = (0.0, 1.0)


@dataclasses.dataclass
class RunConfig:
    """Top-level run description: partitioning + solver + schedule."""

    n_parts: int = 1
    # Resumable state (checkpoints every N steps, mid-solve snapshots every
    # N dispatches) is not ported yet; nonzero values raise.
    checkpoint_every: int = 0
    snapshot_every: int = 0
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    time_history: TimeHistoryConfig = dataclasses.field(
        default_factory=TimeHistoryConfig)

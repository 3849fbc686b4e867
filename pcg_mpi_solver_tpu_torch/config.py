"""Typed configuration of the PyTorch port.

Every field of ``pcg_mpi_solver_tpu/config.py``, with the JAX package's
default, so a config written for the JAX package builds here too.  One
value is refused rather than ignored: ``SolverConfig.pallas`` "off" or
"interpret", for which ``solver/driver.py::check_slice`` raises
``NotImplementedError`` (the port has no XLA path and no interpreter; its
CUDA kernels run on the card and their plain versions on the CPU).  Names
that do not change the solve are accepted as they are;
``RunConfig.checkpoint_path`` (under ``scratch_path``) is where step
checkpoints and mid-solve snapshots go.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

# Canonical name sets, copied from the JAX package, so an unknown name is a
# ValueError at construction.
PCG_VARIANTS = ("classic", "fused", "pipelined")
PRECONDS = ("jacobi", "block3", "mg")
PRECISION_MODES = ("direct", "mixed")
PALLAS_MODES = ("auto", "on", "off", "interpret")


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
    # early exits of the mixed shell's f32 cycles (0 = off)
    mixed_plateau_window: int = 0
    mixed_progress_window: int = 0
    mixed_progress_ratio: float = 0.7
    mixed_progress_min_gain: float = 30.0
    max_stag_steps: int = 3
    pcg_variant: str = "classic"
    # block width metadata, as in the JAX package: the width of the block
    # passed to Solver.solve_many decides the run
    nrhs: int = 1
    precond: str = "jacobi"
    # MG V-cycle shape (precond="mg")
    mg_levels: int = 0
    mg_smooth_degree: int = 2
    mg_max_replicated_dofs: int = 32_000_000
    # Krylov iterations per dispatch of the chunked path
    # (solver/chunked.py): -1 engages it at 4 M dofs and above with an
    # automatic cap, 0 keeps the one-shot solve, N > 0 caps dispatches at
    # N iterations at any size
    iters_per_dispatch: int = -1
    trace_resid: int = 0          # in-solve residual trace ring (0 = off)
    # Accepted and ignored: carry donation is numerically a no-op in the
    # JAX package (bit-identical on and off), and torch updates in place.
    donate_carry: bool = True
    # chunked path only: recovery-ladder attempts a step (0 reports a
    # breakdown as it is) and device-loss re-dispatches from a snapshot
    max_recoveries: int = 2
    dispatch_retries: int = 2
    # The JAX package's Pallas switch.  "auto" and "on" both mean the
    # port's CUDA kernels on the card; there is no other path to switch to.
    pallas: str = "auto"

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
        if self.pallas not in PALLAS_MODES:
            raise ValueError(f"SolverConfig.pallas must be one of "
                             f"{PALLAS_MODES}, got {self.pallas!r}")
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
    # Result export (Solver.solve(store=...)): frames every
    # export_frame_rate steps and at export_frames, of export_vars (U D ES
    # PS PE NS or PS1..PS3 PE1..PE3), timestamped t * dt; plot_flag keeps
    # the probe_dofs' displacement history
    export_flag: bool = True
    export_frame_rate: int = 1
    export_frames: Sequence[int] = ()
    plot_flag: bool = False
    export_vars: str = "U"
    dt: float = 1.0
    probe_dofs: Sequence[int] = ()


@dataclasses.dataclass
class RunConfig:
    """Top-level run description: paths + partitioning + solver +
    schedule."""

    scratch_path: str = "./scratch"
    model_name: str = "model"
    run_id: str = "1"
    n_parts: int = 1
    # "rcb" and "auto" give the structured slabs; "graph" needs the general
    # backend
    partition_method: str = "rcb"
    # names the result directory "..._SpeedTest" (result_path); the port
    # writes no result exports, checkpoints and snapshots either way
    speed_test: bool = False
    # step checkpoints every N completed steps (Solver.solve) and mid-solve
    # snapshots every N chunks of the chunked path, under checkpoint_path
    checkpoint_every: int = 0
    snapshot_every: int = 0
    setup_shard: str = "auto"
    preflight: str = ""
    cache_dir: str = ""
    telemetry_path: str = ""
    flight_path: str = ""
    telemetry_profile: bool = False
    profile_dir: str = ""
    comm_probe_iters: int = 30
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    time_history: TimeHistoryConfig = dataclasses.field(
        default_factory=TimeHistoryConfig)

    @property
    def result_path(self) -> str:
        suffix = "_SpeedTest" if self.speed_test else ""
        return f"{self.scratch_path}/Results_Run{self.run_id}{suffix}"

    @property
    def checkpoint_path(self) -> str:
        return f"{self.result_path}/Checkpoints"

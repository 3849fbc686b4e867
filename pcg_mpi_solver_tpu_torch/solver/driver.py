"""Quasi-static solve driver on the structured slab and general backends.

Port of the core of ``pcg_mpi_solver_tpu/solver/driver.py`` (``Solver``
in direct and mixed precision, its backend selection, ``StepResult``,
``displacement_global``; ``solve_many``, ``ManySolveResult``,
``normalize_rhs_block`` and ``displacement_global_many`` for blocks of
load cases).  A model the structured slab cannot take (octree meshes with
reflected pattern types, cohesive interface springs, a grid not divisible
by the part count, ``partition_method="slab2"`` or an explicit
``elem_part``) runs on the general backend (``parallel/partition.py`` +
the general operator of ``ops/matvec.py``), as in the JAX package.  An
octree model with brick metadata runs on the hybrid level-grid backend
(``parallel/hybrid.py``: the brick cells of each refinement level through
the slab kernels, the transition cells on the general operator) when
asked for (``backend="hybrid"``), or under auto with
``PCG_TPU_ENABLE_HYBRID=1``; it always takes the chunked path, and in
mixed precision its float64 matvecs there run on the refresh operator of
``PCG_TPU_HYBRID_F64_REFRESH`` (the bucketed general blocks by default).
For each time step: Dirichlet lifting ->
preconditioner rebuild (scalar Jacobi, 3x3 block Jacobi or the mg
V-cycle's operand) -> PCG (``SolverConfig.pcg_variant``: classic, fused
or pipelined; direct, or the mixed f32/f64 refinement shell) -> u = x +
Ud * delta.
Under ``precond="mg"`` the constructor also builds the level hierarchy
(``ops/mg.py``) into ``data["mg"]`` and estimates the fine level's
Chebyshev bound on the uploaded operator.  ``solve_many`` solves a block
of load cases against the one operator in one lockstep loop
(``pcg_many``, or ``pcg_mixed_many`` in mixed precision): homogeneous
Dirichlet, x0 = 0; one-shot below the dispatch cap and in mixed
precision (breakdown columns quarantined), else chunked with one
recovery ladder a column (``resilience/engine.run_many_with_recovery``),
``many_*.npz`` snapshots and ``solve_many(resume=True)``.

Above 4 M dofs (``solver/chunked.auto_dispatch_cap``), or at any size
when ``SolverConfig.iters_per_dispatch`` names a cap, ``step`` runs the
chunked path as the JAX package does: the start step (lifting, r0, the
preconditioner built once), then capped dispatches of the resumable
``pcg`` (``solver/chunked.ChunkedEngine``) inside the recovery ladder
(``resilience/engine.run_with_recovery``: restart from the min-residual
iterate, the scalar-Jacobi fallback preconditioner, f64 escalation),
with mid-solve snapshots (``RunConfig.snapshot_every``), step
checkpoints (``checkpoint_every``, ``solve(resume=True)``) and
deterministic fault injection (``fault_plan``, ``PCG_TPU_FAULTS``).  The
one-shot path returns a breakdown flag (2, 4, 6) as it is.

``solve(store=...)`` runs the schedule with the JAX package's exports
(``driver.py:2246-2628``): the owner-masked displacement and nodal field
frames (D, ES, PS1-3, PE1-3 on the solver's device from the storage-dtype
solution, ``ops/stress.py``; NS on the host), the maps, the time list,
the probe history and the timing data, into a ``utils.io.RunStore``.
The mixed shell's plateau and progress windows (``SolverConfig.mixed_*``)
run in every inner f32 cycle, one-shot and chunked.

With ``RunConfig.cache_dir`` set, the partitions (structured, general,
hybrid and the hybrid's float64 refresh), the mg hierarchy and the mg
fine bound come from the content-addressed partition cache (``cache/``)
under the JAX package's monolithic keys; ``setup_cache`` says whether
they came "cold" or "warm" ("off" without a cache).

Across processes (``mesh=`` a ``parallel.mesh.Mesh`` of a
``torch.distributed`` gloo group, by default the group's own,
``parallel/distributed.py``) each rank holds its contiguous block of the
parts on its own device: the host partition stays global (built whole,
or, under ``RunConfig.setup_shard``, only the rank's parts, with the
export glue exchanged), and the device tree is the rank's ``local_view``
of it.  The interface assembly, the scalar reductions and the mg
restriction sum over ranks (``Ops._psum``), the structured halo crosses
rank boundaries as a plane exchange, the recovery ladder's verdicts are
group-agreed (``parallel/consensus.py``), the host collectives of the
dispatch path run under ``resilience/distributed.GuardedComm`` (a dead
peer raises ``DeadPeerError``), mid-solve snapshots are group-consistent
epochs (``GroupSnapshotStore``), and ``resume_elastic`` restores a
committed N-rank epoch onto any process count.

The solver runs on ``cuda`` (``cuda:(rank % device_count)`` across
processes) unless the caller passes ``device="cpu"``; without a card,
the default raises instead of quietly running on the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Callable, List, Optional

import numpy as np
import torch

from pcg_mpi_solver_tpu_torch import native
from pcg_mpi_solver_tpu_torch.cache.keys import (
    array_hash as cache_array_hash, model_fingerprint, partition_cache_key,
    partition_glue_key, partition_shard_key)
from pcg_mpi_solver_tpu_torch.cache.partition_cache import (
    cached_partition, cached_partition_shards)
from pcg_mpi_solver_tpu_torch.cache.shards import (
    join_mg, join_partition, split_mg, split_partition)
from pcg_mpi_solver_tpu_torch.config import (
    RunConfig, SolverConfig, TimeHistoryConfig)
from pcg_mpi_solver_tpu_torch.models.model_data import ModelData
from pcg_mpi_solver_tpu_torch.obs import perf as _perf
from pcg_mpi_solver_tpu_torch.obs.flight import attach_flight
from pcg_mpi_solver_tpu_torch.obs.metrics import MetricsRecorder
from pcg_mpi_solver_tpu_torch.obs.profview import (
    start_capture, stop_capture)
from pcg_mpi_solver_tpu_torch.obs.trace import (
    ConvergenceTrace, clamp_trace_len, empty_trace, trace_init,
    unpack_trace)
from pcg_mpi_solver_tpu_torch.ops import mg as mgmod
from pcg_mpi_solver_tpu_torch.ops.matvec import (
    Ops, bucketed_matvec, build_bucketed_blocks, device_data)
from pcg_mpi_solver_tpu_torch.ops.nonlocal_stress import (
    build_nonlocal_weights, elem_stress_host, nodal_average_host,
    von_mises_stress)
from pcg_mpi_solver_tpu_torch.ops.precond import fallback_kind, make_prec
from pcg_mpi_solver_tpu_torch.ops.stress import nodal_export_fields
from pcg_mpi_solver_tpu_torch.ops.structured_matvec import (
    VARIANTS, pallas_planes, selected_variant)
from pcg_mpi_solver_tpu_torch.parallel.consensus import agree_flag
from pcg_mpi_solver_tpu_torch.parallel.distributed import (
    HostComm, fetch_addressable, fetch_global, gather_owned_global,
    local_view, make_global_mesh, process_count, process_index)
from pcg_mpi_solver_tpu_torch.parallel.hybrid import (
    HybridOps, can_hybrid, device_data_hybrid, partition_env_knobs,
    partition_hybrid)
from pcg_mpi_solver_tpu_torch.parallel.partition import partition_model
from pcg_mpi_solver_tpu_torch.parallel.structured import (
    StructuredOps, device_data_structured, partition_structured)
from pcg_mpi_solver_tpu_torch.resilience import (
    DispatchGuard, FaultPlan, ManyRecoveryHooks, RecoveryHooks,
    ResilienceContext, retry_deadline_s, run_many_with_recovery,
    run_with_recovery)
from pcg_mpi_solver_tpu_torch.solver.backends import HYBRID_GATE_NOTE
from pcg_mpi_solver_tpu_torch.solver.chunked import (
    ChunkedEngine, auto_dispatch_cap)
from pcg_mpi_solver_tpu_torch.solver.pcg import (
    BREAKDOWN_FLAGS, LAGGED_VARIANTS, QUARANTINE_FLAG, _np_type, _read,
    cold_carry, cold_carry_many, mixed_windows, pcg, pcg_many, pcg_mixed,
    pcg_mixed_many, restart_carry_many, select_best_many)
from pcg_mpi_solver_tpu_torch.utils.checkpoint import (
    CheckpointManager, SnapshotStore, array_hash)
from pcg_mpi_solver_tpu_torch.validate import (
    PreflightError, check_rhs_block, run_preflight)

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _dtype_name(dtype: torch.dtype) -> str:
    """'float64' for torch.float64: the dtype as the JAX package's cache
    keys spell it."""
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass
class StepResult:
    flag: int
    relres: float
    iters: int
    wall_s: float


def normalize_rhs_block(fexts, n_dof: int, dtype=None) -> np.ndarray:
    """A ``solve_many`` request as the (n_dof, nrhs) column block: a single
    (n_dof,) vector is one column, a stacked (nrhs, n_dof) array
    transposes when unambiguous.  ``dtype=None`` keeps the input dtype."""
    fb = np.asarray(fexts) if dtype is None \
        else np.asarray(fexts, dtype=dtype)
    if fb.ndim == 1:
        fb = fb[:, None]
    elif fb.ndim == 2 and fb.shape[0] != n_dof and fb.shape[1] == n_dof:
        fb = fb.T
    return fb


@dataclasses.dataclass
class ManySolveResult:
    """Per-column outcome of :meth:`Solver.solve_many`: flags, relres and
    iters are (nrhs,) arrays (MATLAB's flag taxonomy per column, plus
    ``QUARANTINE_FLAG`` 5), ``x`` the blocked solution (n_parts, n_loc,
    nrhs) on effective dofs on the solver's device (a permuted view of
    the port's (nrhs, n_parts, n_loc) block); fetch global columns with
    :meth:`Solver.displacement_global_many`.  ``solve_wall_s`` is the
    Krylov work alone (validation and upload excluded), ``trips`` the
    lockstep trips (one blocked matvec each), ``quarantined`` the
    quarantined columns.  ``recoveries`` (ladder attempts over every
    column) and ``drift`` (drifted checks of a recurrence variant) are
    the counts of the chunked blocked path, 0 on the one-shot path."""
    flags: np.ndarray
    relres: np.ndarray
    iters: np.ndarray
    wall_s: float
    x: object = None
    solve_wall_s: float = 0.0
    quarantined: tuple = ()
    recoveries: int = 0
    drift: int = 0
    trips: int = 0

    @property
    def nrhs(self) -> int:
        return int(len(self.flags))


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; a CUDA device without CUDA raises.  The
    one device rule of ``Solver``, ``DynamicsSolver`` and
    ``NewmarkSolver``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    return dev


# The JAX package's calc vs comm-wait split (``measure_comm_split``) of a
# one-process run, which the time data records when
# ``RunConfig.comm_probe_iters`` > 0: every part lives on the one device,
# no collective runs, all is calc (``Solver.measure_comm_split`` measures
# the split of a multi-process run)
ONE_DEVICE_COMM = {"comm_frac": 0.0, "full_s_per_iter": 0.0,
                   "calc_s_per_iter": 0.0}
SETUP_SHARD = ("auto", "on", "off")


def check_slice(config: RunConfig) -> None:
    """Raise for a config the port cannot honour: the one check of
    ``Solver``, ``DynamicsSolver`` and ``NewmarkSolver``."""
    if config.setup_shard not in SETUP_SHARD:
        raise ValueError(f"RunConfig.setup_shard must be 'auto'|'on'|'off', "
                         f"got {config.setup_shard!r}")
    sc = config.solver
    if sc.pallas in ("off", "interpret"):
        raise NotImplementedError(
            f"pallas={sc.pallas!r}: the port has no XLA path and no "
            f"interpreter; it always runs its CUDA kernels on the card and "
            f"their plain version on the CPU ('auto' or 'on')")


BACKENDS = ("auto", "structured", "hybrid", "general")
# the float64 refresh operators of a mixed hybrid solve
F64_REFRESH = ("bucketed", "general", "stencil")


def can_structured(model: ModelData, config: RunConfig, n_parts: int,
                   elem_part=None) -> bool:
    """The JAX package's structured-slab eligibility: grid metadata, no
    reflected elements or interfaces, nx divisible by the part count, and
    no explicitly requested non-default partition (``partition_method``
    other than rcb/auto, or an ``elem_part``)."""
    return (model.grid is not None
            and not np.asarray(model.elem_sign_flat).any()
            and not model.intfc_elems
            and config.partition_method in ("rcb", "auto")
            and elem_part is None
            and model.grid[0] % n_parts == 0)


def select_backend(model: ModelData, config: RunConfig, n_parts: int,
                   backend: str = "auto", elem_part=None) -> str:
    """The JAX package's backend choice: the structured slab when the
    model allows it; else the hybrid level-grid backend when asked for, or
    under auto with ``PCG_TPU_ENABLE_HYBRID=1`` on a model that can take
    it; else the general backend."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be 'auto'|'structured'|'hybrid'|"
                         f"'general', got {backend!r}")
    structured = can_structured(model, config, n_parts, elem_part)
    if backend == "structured" and not structured:
        raise ValueError("structured backend requested but model/partition "
                         "layout does not allow it")
    if backend == "hybrid" and not can_hybrid(model):
        raise ValueError("hybrid backend requested but model has no "
                         "octree/brick metadata")
    if backend in ("auto", "structured") and structured:
        return "structured"
    if backend == "hybrid" or (
            backend == "auto" and can_hybrid(model)
            and os.environ.get("PCG_TPU_ENABLE_HYBRID") == "1"):
        return "hybrid"
    return "general"


def hybrid_f64_refresh() -> str:
    """``PCG_TPU_HYBRID_F64_REFRESH``, validated: the operator of a mixed
    hybrid solve's float64 matvecs on the chunked path (lifting, r0, the
    refinement residuals): ``bucketed`` (default), ``general`` or
    ``stencil`` (the level grids themselves)."""
    knob = os.environ.get("PCG_TPU_HYBRID_F64_REFRESH", "bucketed")
    if knob not in F64_REFRESH:
        raise ValueError(f"PCG_TPU_HYBRID_F64_REFRESH={knob!r}: expected "
                         f"'bucketed' (default), 'stencil' or 'general'")
    return knob


class LadderPieces:
    """The preconditioner and the recovery ladder's rungs of a solver
    that holds ``config``, ``ops``/``data`` (and ``ops32``/``data32`` when
    ``mixed``), ``pm``, ``_dispatch_cap``, ``dispatch_log``, ``_rec`` and
    ``_esc_engine``: ``Solver`` on K, ``NewmarkSolver`` on A = K + c M."""

    def _make_prec(self, kind: str):
        """The preconditioner operand: f32 for the mixed inner solves,
        else in the storage dtype."""
        if self.mixed:
            return make_prec(self.ops32, self.data32, kind)
        return make_prec(self.ops, self.data, kind)

    def _fallback_prec(self):
        """The ladder's scalar-Jacobi fallback (rung 2): under mg the mg
        operand with its ``fb`` switch set (``ops/mg.fallback_operand``),
        so the apply demotes to scalar Jacobi."""
        with self._rec.dispatch("fallback_prec"):
            inv = self._make_prec("jacobi")
            if self.config.solver.precond == "mg":
                return mgmod.fallback_operand(inv)
            return inv

    def _escalation(self):
        """The ladder's f64 escalation (rung 3, mixed mode): a direct-f64
        ``ChunkedEngine`` on the solver's float64 operator under scalar
        Jacobi, built on first use.  Returns (engine, data, prec)."""
        if self._esc_engine is None:
            self._esc_engine = ChunkedEngine(
                ops=self.ops, scfg=self.config.solver,
                glob_n_dof_eff=self.pm.glob_n_dof_eff,
                cap=self._dispatch_cap, mixed=False, recorder=self._rec,
                log=self.dispatch_log)
        with self._rec.dispatch("esc_prec"):
            prec = make_prec(self.ops, self.data, "jacobi")
        return self._esc_engine, self.data, prec


class Solver(LadderPieces):
    """Owns the partitioned model on one device (each rank its block of
    the parts across processes) and runs time steps."""

    def __init__(self, model: ModelData, config: Optional[RunConfig] = None,
                 n_parts: Optional[int] = None, device=None,
                 backend: str = "auto",
                 elem_part: Optional[np.ndarray] = None,
                 recorder: Optional[MetricsRecorder] = None,
                 mesh=None):
        t0 = self._t_init0 = time.perf_counter()
        self.config = config or RunConfig()
        # telemetry: an injected recorder wins; else the default one
        # (stderr under PCG_TPU_VERBOSE=1, a JSONL sink at telemetry_path)
        self.recorder = recorder if recorder is not None \
            else MetricsRecorder.default(
                jsonl_path=self.config.telemetry_path or None,
                profile=True if self.config.telemetry_profile else None)
        self._rec = self.recorder
        # the flight recorder's brackets around every dispatch
        attach_flight(self._rec, self.config.flight_path, "solver",
                      pcg_variant=self.config.solver.pcg_variant,
                      precond=self.config.solver.precond)
        self._model = model              # the checkpoint fingerprint's
        # the process group's parts mesh (one process without a group);
        # a rank computes on its own card unless the caller says cpu
        self.mesh = mesh if mesh is not None else make_global_mesh()
        self.device = resolve_device(device if device is not None
                                     else self.mesh.device)
        n_parts = self.config.n_parts if n_parts is None else n_parts
        if n_parts < 1:
            raise ValueError(f"n_parts must be >= 1, got {n_parts}")
        if n_parts % self.mesh.world != 0:
            raise ValueError(f"n_parts={n_parts} must be a multiple of the "
                             f"process count {self.mesh.world}")
        self._part_range = self.mesh.part_range(n_parts)
        self._group = self.mesh.group
        if self._group is not None:
            self._group.recorder = self._rec
        check_slice(self.config)
        # the preflight gate, before any partition is built (on this path
        # snapshot_every counts chunks, so no n_steps in the context)
        run_preflight(model, self.config, recorder=self._rec,
                      context={"kind": "quasi_static"})
        self.backend = select_backend(model, self.config, n_parts, backend,
                                      elem_part)
        if (backend == "auto" and self.backend == "general"
                and can_hybrid(model)):
            self._rec.note(HYBRID_GATE_NOTE)
        sc = self.config.solver
        general = self.backend == "general"
        hybrid = self.backend == "hybrid"
        if hybrid and sc.precond == "mg":
            raise ValueError(
                "precond='mg' is not supported on the hybrid level-grid "
                "backend; use backend='general' or 'structured' (or "
                "precond='jacobi'|'block3')")
        self.mixed = sc.precision_mode == "mixed"
        self.dtype = torch.float64 if self.mixed else _DTYPES[sc.dtype]
        dot_dtype = _DTYPES[sc.dot_dtype]
        # The float32 matvec kernel, read once (PCG_TPU_PALLAS_V and, for
        # the chunked variants, PCG_TPU_PALLAS_PLANES) as the JAX Solver
        # records pallas_variant: build a new Solver to switch.
        self.kernel_variant = selected_variant()
        self.kernel_planes = (pallas_planes()
                              if VARIANTS[self.kernel_variant][1] else None)
        kernel = dict(variant=self.kernel_variant, planes=self.kernel_planes)

        # the float64 refresh of a mixed hybrid solve (the JAX package
        # records "stencil" everywhere else)
        self.f64_refresh = "stencil"
        if hybrid:
            knob = hybrid_f64_refresh()
            if self.mixed and knob != "stencil":
                self.f64_refresh = knob
        # ---- the partition cache (cache/): with RunConfig.cache_dir set,
        # the partitions, the mg hierarchy and the mg fine bound come from
        # the content-addressed on-disk cache; the model fingerprint is
        # the content half of every key.  The counters' baseline is this
        # construction's: a recorder may carry earlier solvers' hits.
        self._cache_dir = (self.config.cache_dir or "").strip() or None
        self._model_fp = None
        self._partition_cache_id = None
        self._cache_hm0 = (self._rec.counters.get("cache.partition.hit", 0),
                           self._rec.counters.get("cache.partition.miss", 0))
        if self._cache_dir:
            with self._rec.span("cache_fingerprint"):
                self._model_fp = model_fingerprint(model)
            self._rec.gauge("cache.dir", self._cache_dir)
        # seconds spent building partitions (cold builds only, as the JAX
        # package counts them: the main partition and the refresh's)
        self.partition_build_s = 0.0
        # the guarded host collectives of the dispatch path (None with one
        # process); the group's own collectives classify a dead peer too
        self._group_comm = None
        self._elastic_dir = None        # resume_elastic() arms it
        self._setup_shard_engage(model, n_parts)
        if self._group is not None:
            self._group.guard = self._collective_comm()
        mg_degree = int(sc.mg_smooth_degree)
        method = self.config.partition_method
        if general:
            # the two-level split's slab count is one slab a process, a
            # function of the process topology alone (toggling
            # setup_shard must not change the element partition)
            slabs = process_count()
            self.pm = self._partition_cached(
                "general",
                lambda part_range=None: partition_model(
                    model, n_parts, elem_part=elem_part, method=method,
                    part_range=part_range, comm=self._setup_comm,
                    slab2_slabs=slabs if method == "slab2" else 1),
                n_parts=n_parts, method=method, elem_part=elem_part,
                extra={"slab2_slabs": slabs} if method == "slab2" else None,
                shard=True)
        elif hybrid:
            self.pm = self._partition_cached(
                "hybrid",
                lambda: partition_hybrid(model, n_parts, elem_part=elem_part,
                                         method=method),
                n_parts=n_parts, method=method, elem_part=elem_part,
                extra=partition_env_knobs())
        else:
            self.pm = self._partition_cached(
                "structured",
                lambda part_range=None: partition_structured(
                    model, n_parts, part_range=part_range),
                n_parts=n_parts, shard=True)
        if self._setup_range is not None:
            # the export glue (owner masks and global id maps) of every
            # rank's parts: the global views read all rows
            self._exchange_export_glue(self.pm)
        # the rank's block of parts: the host data its device tree is
        # built from (the partition itself with one process)
        self._pm_dev = local_view(self.pm, *self._part_range)
        grp = self._group
        # the refresh's full general partition (hybrid, mixed)
        self.refresh_partition_s = 0.0
        pm_full = None
        if self.f64_refresh != "stencil":
            t_full = time.perf_counter()
            pm_full = local_view(self._refresh_partition(model, n_parts),
                                 *self._part_range)
            self.refresh_partition_s = time.perf_counter() - t_full
        t_up = time.perf_counter()
        self._refresh64 = None
        pmd = self._pm_dev
        if general:
            self.ops = Ops.from_model(pmd, dot_dtype=dot_dtype,
                                      mg_degree=mg_degree, group=grp)
            self.data = device_data(pmd, self.dtype, self.device)
        elif hybrid:
            self.ops = HybridOps.from_hybrid(
                pmd, dot_dtype=dot_dtype, mg_degree=mg_degree, group=grp,
                **(kernel if self.dtype == torch.float32 else {}))
            self.data = device_data_hybrid(pmd, self.dtype, self.device)
            if pm_full is not None:
                self._refresh64 = self._refresh_operator(pm_full)
        else:
            self.ops = StructuredOps.from_partition(
                pmd, dot_dtype=dot_dtype, mg_degree=mg_degree, group=grp,
                **(kernel if self.dtype == torch.float32 else {}))
            self.data = device_data_structured(pmd, self.dtype,
                                               self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        # host layout + upload of the device tree (the general backend's
        # bucket and ELL maps are built here)
        self.upload_s = time.perf_counter() - t_up
        # MG hierarchy (precond="mg"): host-built levels and transfers into
        # the device tree, float leaves at the storage dtype
        self.mg_setup = None
        if sc.precond == "mg":
            t_mg = time.perf_counter()
            self.mg_setup = self._build_mg_cached(model, sc)
            self.data["mg"] = mgmod.tree_from_numpy(
                mgmod.local_tree(self.mg_setup.tree, *self._part_range),
                self.dtype, self.device)
            self.mg_setup_s = time.perf_counter() - t_mg
        if self.mixed:
            # f32 shadow of the float leaves (the f32 inner cycles' data);
            # their dots accumulate in f32
            self.data32 = mgmod.cast_tree(self.data, torch.float32)
            if general:
                self.ops32 = dataclasses.replace(self.ops,
                                                 dot_dtype=torch.float32)
            elif hybrid:
                self.ops32 = dataclasses.replace(
                    self.ops, dot_dtype=torch.float32, **kernel)
            else:
                self.ops32 = StructuredOps.from_partition(
                    pmd, dot_dtype=torch.float32, mg_degree=mg_degree,
                    group=grp, **kernel)
        if self.mg_setup is not None:
            # the fine level's Chebyshev bound: power-iteration matvecs on
            # the uploaded storage-dtype operator, installed with the
            # coarse bounds into every tree; the mg_setup event and the
            # interval check (the JAX package's _finish_mg_setup)
            t_lam = time.perf_counter()
            hit0 = self._rec.counters.get("cache.partition.hit", 0)
            lam_fine = self._fine_lam_cached()
            self.mg_lam_s = time.perf_counter() - t_lam
            self.mg_lam = mgmod.install_lam_and_report(
                self.mg_setup, lam_fine,
                trees=[self.data] + ([self.data32] if self.mixed else []),
                recorder=self._rec, wall_s=self.mg_setup_s + self.mg_lam_s,
                cached=self._rec.counters.get("cache.partition.hit", 0)
                > hit0)

        # Initial state: deterministic zeros.
        self.reset_state()
        self._many_data = None          # (width, f64-or-storage tree, f32)

        # ---- the chunked path (solver/chunked.py) and the resilience
        # subsystem (resilience/): the JAX package's auto cap engages at
        # 4 M dofs over the whole model (the same cap on every rank)
        self._dispatch_cap = auto_dispatch_cap(
            sc, self.pm.glob_n_dof, self.pm.n_loc * self.pm.n_parts,
            force_engage=hybrid)

        # the convergence ring (obs/trace.py; 0 = off) and the dtype its
        # norms unpack in: the dot dtype of the Krylov iterations (float32
        # in the mixed inner cycles, rescaled to absolute residuals)
        self.trace_len = (clamp_trace_len(sc.trace_resid, sc.max_iter)
                          if sc.trace_resid > 0 else 0)
        self._trace_dtype = torch.float32 if self.mixed else dot_dtype
        self.last_trace: Optional[ConvergenceTrace] = None
        self._ring = None               # the step's ring, until unpacked
        # settable: tests inject programmatically, PCG_TPU_FAULTS drives
        # drills
        self.fault_plan = FaultPlan.from_env(recorder=self._rec)
        self._resume_pending = False     # solve(resume=True) arms the
        #                                  mid-step snapshot resume
        self._snap_store = None          # lazy: fingerprints the model once
        self._esc_engine = None          # lazy: the f64 escalation engine
        # one entry per capped call and refinement cycle of the last step
        # (ChunkedEngine.log), over every engine the ladder ran
        self.dispatch_log: List[tuple] = []
        self._engine = None
        if self._dispatch_cap > 0:
            self._engine = ChunkedEngine(
                ops=self.ops, scfg=sc, glob_n_dof_eff=self.pm.glob_n_dof_eff,
                cap=self._dispatch_cap, mixed=self.mixed,
                ops32=self.ops32 if self.mixed else None,
                recorder=self._rec, log=self.dispatch_log,
                kmul64=(lambda _d, v: self._k64(v))
                if self._refresh64 is not None else None,
                trace_len=self.trace_len, trace_dtype=self._trace_dtype)
        self.flags: List[int] = []
        self.relres: List[float] = []
        self.iters: List[int] = []
        self.step_times: List[float] = []
        # the steps this process ran (a restored checkpoint's are not)
        self._proc_step_times: List[float] = []
        # the export path (solve(store=...)): Poisson's ratio of the
        # stress fields, the nonlocal operator (built at the first NS
        # frame), frame count, frame times, seconds spent exporting
        self._nu = float(model.mat_prop[0]["Pos"]) if model.mat_prop \
            else 0.2
        self._nonlocal = None
        self._export_count = 0
        self._export_times: List[float] = []
        self._export_wall = 0.0
        self._probe_u: List[np.ndarray] = []
        # setup attribution: wall from construction to ready-to-step, and
        # whether the cached entries came warm (every one a hit) or cold
        self.setup_s = time.perf_counter() - t0
        hits = self._rec.counters.get("cache.partition.hit", 0) \
            - self._cache_hm0[0]
        miss = self._rec.counters.get("cache.partition.miss", 0) \
            - self._cache_hm0[1]
        self.setup_cache = ("off" if not self._cache_dir
                            else "warm" if hits and not miss else "cold")
        self._rec.gauge("setup_s", round(self.setup_s, 3))
        self._rec.gauge("setup.cache", self.setup_cache)
        self._rec.gauge("setup.partition_build_s",
                        round(self.partition_build_s, 3))
        if self._setup_range is not None:
            # which parts this process built or loaded, and whether warm
            self._rec.event(
                "setup_shard", parts=list(self._setup_range),
                n_parts=int(self.pm.n_parts),
                cold=self.setup_cache != "warm",
                partition_build_s=round(self.partition_build_s, 6),
                setup_s=round(self.setup_s, 6))
        # the per-iteration collective estimate from the ops shapes (the
        # JAX package's comm.* gauges): the Krylov iterations' ops, the
        # float32 ones in mixed, and the mg restriction's payload
        est_ops = self.ops32 if self.mixed else self.ops
        if self.mg_setup is not None:
            est_ops = dataclasses.replace(
                est_ops, mg_coarse_dofs=mgmod.coarse_dofs(self.mg_setup.meta))
        for k, v in est_ops.comm_estimate(
                storage_dtype=torch.float32 if self.mixed else self.dtype,
                variant=sc.pcg_variant, precond=sc.precond).items():
            self._rec.gauge(f"comm.{k}", v)
        self._init_cost_model()

    def _init_cost_model(self) -> None:
        """The analytic cost model of this solve (``obs/perf.py``, the
        profile of this solver's device) as a ``cost_model`` event and
        ``perf.*`` gauges; an unknown variant or preconditioner is a loud
        KeyError."""
        self._perf_shape = _perf.shape_from_solver(self)
        self._perf_profile = _perf.resolve_profile(self.device.type)
        self._cost_models_by_width = {}
        self._cost_model = self._cost_model_at(self.config.solver.nrhs)
        _perf.emit_cost_model(self._rec, self._cost_model)

    def _cost_model_at(self, nrhs: int) -> dict:
        """The cost model at block width ``nrhs`` (one table walk a width,
        kept)."""
        nrhs = max(1, int(nrhs))
        if nrhs not in self._cost_models_by_width:
            sc = self.config.solver
            self._cost_models_by_width[nrhs] = _perf.cost_model(
                self._perf_shape, sc.pcg_variant, sc.precond, nrhs,
                self._perf_profile)
        return self._cost_models_by_width[nrhs]

    def predicted_ms_per_iter(self, nrhs: int = 1) -> float:
        """The cost model's ms/iter at block width ``nrhs``."""
        return float(self._cost_model_at(nrhs)["predicted_ms_per_iter"])

    def warmup(self) -> None:
        """Pay the engaged path's first-use work without running a solve
        (the JAX package's ``Solver.warmup``, which compiles the step
        programs; the port has no compile step).  On the card it builds,
        or loads from ``build/torch_kernels/``, every CUDA library the
        path launches (the selected float32 variant and v6's double
        kernel on the slab and hybrid backends); it builds the native
        library when the partition method needs it; and it applies each
        operator the path uses (the storage-dtype one, and the float32
        one of a mixed solve) to a zero vector, so the first solve pays
        no lazy module load or allocator growth.  ``un``, the
        convergence ring and the solve history are untouched.  CLI:
        ``warmup``."""
        from pcg_mpi_solver_tpu_torch.ops.kernels import load_kernel

        with self._rec.span("warmup", emit=True):
            if (self.config.partition_method in ("graph", "auto")
                    and not native.disabled()):
                native.load()
            if self.device.type == "cuda" and self.backend != "general":
                for lib in (VARIANTS[self.kernel_variant][0],
                            "structured_matvec"):
                    load_kernel(lib)
            zero = torch.zeros_like(self.un)
            self._k64(zero)
            if self.mixed:
                self.ops32.matvec(self.data32, zero.to(torch.float32))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self._rec.note("warmup complete (kernels loaded, operators "
                       "applied once)")

    def _setup_shard_engage(self, model: ModelData, n_parts: int) -> None:
        """The sharded setup (JAX ``driver.py:288-391``): with several
        processes and ``setup_shard`` not "off", the structured and
        general backends build (or load) only this rank's parts, the
        layout merged through ``HostComm`` reductions.  The engage
        decision gates collective code paths, so it is group-agreed.  The
        hybrid backend keeps the whole build, as in the JAX package."""
        self._setup_range = None
        self._setup_comm = None
        if (self.config.setup_shard == "off" or self.mesh.world <= 1
                or self.backend not in ("general", "structured")):
            return
        comm = HostComm()
        if agree_flag(comm, True):
            self._setup_range = self._part_range
            self._setup_comm = comm

    def _exchange_export_glue(self, pm) -> None:
        """Sharded setup: gather every rank's rows of the export glue
        (owner weights and global id maps), so the host-side global views
        (``gather_owned_global``, ``owner_mask``, the ``solve_many``
        staging, the export maps) keep their all-parts contract while the
        heavy per-part structures stay local.  Two collectives: one int64
        buffer (ranges and id maps), one float64 (the weights)."""
        # consensus-exempt: unconditional data movement: every rank gets
        # here once _setup_shard_engage's agree_flag engaged the sharded
        # setup, and nothing branches on what it gathers
        lo, hi = self._setup_range
        comm = self._setup_comm
        names = ("dof_gid", "node_gid", "weight", "node_weight")
        arrs = {n: np.asarray(getattr(pm, n)) for n in names
                if getattr(pm, n, None) is not None}
        ints = np.concatenate(
            [np.asarray([lo, hi], dtype=np.int64)]
            + [arrs[n][lo:hi].ravel().astype(np.int64)
               for n in ("dof_gid", "node_gid") if n in arrs])
        flts = np.concatenate(
            [arrs[n][lo:hi].ravel().astype(np.float64)
             for n in ("weight", "node_weight") if n in arrs]
            or [np.zeros(0)])
        g_int, g_flt = comm.allgather(ints), comm.allgather(flts)
        for proc in range(g_int.shape[0]):
            a, b = int(g_int[proc, 0]), int(g_int[proc, 1])
            pos_i, pos_f = 2, 0
            for n in names:
                if n not in arrs:
                    continue
                full = arrs[n]
                rows = (b - a,) + full.shape[1:]
                cnt = int(np.prod(rows))
                if n in ("dof_gid", "node_gid"):
                    blk = g_int[proc, pos_i:pos_i + cnt]
                    pos_i += cnt
                else:
                    blk = g_flt[proc, pos_f:pos_f + cnt]
                    pos_f += cnt
                full[a:b] = blk.reshape(rows).astype(full.dtype)
        for n, full in arrs.items():
            setattr(pm, n, full)

    def _partition_cached(self, label: str, build: Callable, *,
                          n_parts: int, method: str = "n/a",
                          elem_part=None, extra=None, shard: bool = False):
        """A partition from the cache, else ``build()``, timed into
        ``partition_build_s``.  The key covers the model's content,
        n_parts, backend, dtype, the method ('auto' resolved to whether
        the native partitioner is on), an explicit elem_part's hash and
        the backend's layout knobs.  The entry's key is the partition's
        identity for entries derived from it (the mg hierarchy).

        ``shard=True`` (the structured and general backends) passes the
        sharded setup's part range to ``build(part_range=...)`` and,
        across processes with a cache, goes through the shard-addressed
        store (a glue entry and one entry a part, ``cache/shards.py``), so
        a warm rank reads only its own parts; an entry under the
        monolithic key (the JAX package's ``driver.py:1019-1066``) still
        loads.  One process keeps the monolithic entry."""
        part_range = self._setup_range if shard else None

        def timed_build():
            t0 = time.perf_counter()
            with self._rec.span("partition_build"):
                pm = build(part_range=part_range) if shard else build()
            self.partition_build_s += time.perf_counter() - t0
            return pm

        if not self._cache_dir:
            return timed_build()
        extra = dict(extra or {})
        if method == "auto" and elem_part is None:
            # the resolved choice keys the entry, not the knob
            extra["native"] = bool(native.available())
        key_kw = dict(
            n_parts=int(n_parts), backend=label,
            dtype=_dtype_name(self.dtype), method=method,
            elem_part_hash=(cache_array_hash(elem_part)
                            if elem_part is not None else None),
            extra=extra)
        key = partition_cache_key(self._model_fp, **key_kw)
        self._partition_cache_id = key
        if not shard or self.mesh.world == 1:
            return cached_partition(self._cache_dir, key, timed_build,
                                    recorder=self._rec, label=label)
        lo, hi = part_range if part_range is not None else (0, n_parts)
        part_keys = {p: partition_shard_key(self._model_fp, part_idx=p,
                                            **key_kw)
                     for p in range(lo, hi)}
        return cached_partition_shards(
            self._cache_dir,
            glue_key=partition_glue_key(self._model_fp, **key_kw),
            part_keys=part_keys, builder=timed_build,
            split=split_partition, join=join_partition, legacy_key=key,
            comm=self._setup_comm, recorder=self._rec, label=label)

    def _build_mg_cached(self, model: ModelData, sc: SolverConfig):
        """The host mg hierarchy, from the cache when a cache dir is set
        (the JAX package's ``_build_mg_cached``, under one monolithic
        key): the levels, degree and replication cutoff key it, and so
        does the partition's identity (the fine transfers are laid out in
        its node order)."""
        def build():
            return mgmod.build_mg_host(
                model, self.pm, n_levels=int(sc.mg_levels),
                degree=int(sc.mg_smooth_degree),
                max_replicated_dofs=int(sc.mg_max_replicated_dofs))

        if not self._cache_dir:
            return build()
        key_kw = dict(
            n_parts=int(self.pm.n_parts),
            backend=f"mg-{self.backend}", dtype=_dtype_name(self.dtype),
            extra={"levels": int(sc.mg_levels),
                   "degree": int(sc.mg_smooth_degree),
                   "max_replicated_dofs": int(sc.mg_max_replicated_dofs),
                   "partition": self._partition_cache_id})
        key = partition_cache_key(self._model_fp, **key_kw)
        if self.mesh.world == 1:
            return cached_partition(self._cache_dir, key, build,
                                    recorder=self._rec, label="mg")
        # across processes: the fine transfers a part, each rank its own
        lo, hi = self._part_range
        part_keys = {p: partition_shard_key(self._model_fp, part_idx=p,
                                            **key_kw)
                     for p in range(lo, hi)}
        return cached_partition_shards(
            self._cache_dir,
            glue_key=partition_glue_key(self._model_fp, **key_kw),
            part_keys=part_keys, builder=build,
            split=lambda st: split_mg(st, (lo, hi)), join=join_mg,
            legacy_key=key, comm=self._collective_comm(),
            recorder=self._rec, label="mg")

    def _fine_lam_cached(self) -> float:
        """The fine level's Chebyshev bound (power-iteration matvecs on
        the uploaded operator), from the cache when a cache dir is set:
        keyed by the hierarchy's meta and the iteration count, as the JAX
        package keys it."""
        if not self._cache_dir:
            return mgmod.estimate_fine_lam(self.ops, self.data)
        key = partition_cache_key(
            self._model_fp, n_parts=int(self.pm.n_parts),
            backend=f"mglam-{self.backend}", dtype=_dtype_name(self.dtype),
            extra=dict(self.mg_setup.meta, iters=mgmod.MG_POWER_ITERS))
        entry = cached_partition(
            self._cache_dir, key,
            lambda: {"lam": mgmod.estimate_fine_lam(self.ops, self.data)},
            recorder=self._rec, label="mg_lam")
        return float(entry["lam"])

    def reset_state(self) -> None:
        """Zero the solution (the state before the first step): this
        rank's rows."""
        self.un = torch.zeros((self._pm_dev.n_parts, self.pm.n_loc),
                              dtype=self.dtype, device=self.device)

    def _refresh_partition(self, model: ModelData, n_parts: int):
        """The full general partition a hybrid solve's float64 refresh
        runs on, on the hybrid partition's element map (so the same local
        numbering, checked)."""
        ep = np.asarray(self.pm.elem_part)
        pm_full = self._partition_cached(
            "general", lambda: partition_model(model, n_parts, elem_part=ep),
            n_parts=n_parts, method="explicit", elem_part=ep)
        if not (pm_full.n_loc == self.pm.n_loc
                and np.array_equal(pm_full.node_gid, self.pm.node_gid)):
            raise RuntimeError(
                "general-refresh partition numbering diverged from the "
                "hybrid partition (same elem_part must yield identical "
                "local dof layouts)")
        if self.f64_refresh == "bucketed" and pm_full.ell is None:
            # bucketing moves node rows; a model without the node layout
            # takes the unbucketed general form
            warnings.warn("PCG_TPU_HYBRID_F64_REFRESH=bucketed needs the "
                          "node layout; using 'general' for this model")
            self.f64_refresh = "general"
        return pm_full

    def _refresh_operator(self, pm_full) -> Callable:
        """v -> K.v in float64 on ``pm_full``: the bucketed blocks or the
        general operator."""
        if self.f64_refresh == "bucketed":
            rops = Ops(n_loc=pm_full.n_loc, n_iface=pm_full.n_iface,
                       n_node_loc=pm_full.n_node_loc,
                       n_node_iface=pm_full.n_node_iface,
                       n_parts=pm_full.n_parts, group=self._group)
            rdata = build_bucketed_blocks(pm_full, torch.float64,
                                          self.device)
            return lambda v: bucketed_matvec(rops, rdata, v)
        rops = Ops.from_model(pm_full, group=self._group)
        rdata = device_data(pm_full, torch.float64, self.device)
        return lambda v: rops.matvec(rdata, v)

    def _k64(self, v: torch.Tensor) -> torch.Tensor:
        """Assembled K.v in the storage dtype (float64 in mixed): through
        the hybrid refresh operator when one is set, else the solver's."""
        if self._refresh64 is not None:
            return self._refresh64(v)
        return self.ops.matvec(self.data, v)

    def _lift(self, delta: float):
        """Dirichlet lifting of a step: (u_d = Ud * delta, Fext = eff *
        (F * delta - K.u_d), x0 = eff * u_prev), K.u_d by :meth:`_k64`."""
        data64 = self.data
        eff = data64["eff"]
        udi = data64["Ud"] * delta
        fext = eff * (data64["F"] * delta - self._k64(udi))
        return udi, fext, eff * self.un

    def _amul64(self, v: torch.Tensor) -> torch.Tensor:
        """eff * K.v on the storage-dtype (float64 in mixed) operator, the
        hybrid refresh's when one is set."""
        return self.data["eff"] * self._k64(v)

    def step(self, delta: float) -> StepResult:
        """One quasi-static step at load factor ``delta``: the chunked
        path when the dispatch cap is set (module docstring), else one
        ``pcg`` / ``pcg_mixed`` call."""
        t0 = time.perf_counter()
        delta = float(delta)
        self._ring = None
        if self._dispatch_cap > 0:
            flag, relres, iters = self._step_chunked(delta)
        else:
            # recovery-exempt: the one-shot path (below the dispatch cap)
            # has no chunk boundary and no snapshot to re-dispatch from;
            # its flag reports a breakdown, as the JAX package's one-shot
            # step does, and the chunked path (iters_per_dispatch > 0, or
            # 4 M dofs and more) carries the recovery ladder
            with self._rec.dispatch("step"):
                flag, relres, iters = self._step_oneshot(delta)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        out = StepResult(int(flag), float(relres), int(iters), wall)
        self.flags.append(out.flag)
        self.relres.append(out.relres)
        self.iters.append(out.iters)
        self.step_times.append(wall)
        self._proc_step_times.append(wall)
        step_i = len(self.flags)
        # time_to_tol_s: wall to a converged step, null on any other flag
        self._rec.event("step", step=step_i, flag=out.flag,
                        relres=out.relres, iters=out.iters,
                        wall_s=round(wall, 6),
                        time_to_tol_s=(round(wall, 6) if out.flag == 0
                                       else None))
        if self.trace_len:
            self.last_trace = (unpack_trace(self._ring)
                               if self._ring is not None else empty_trace())
            self._ring = None
            self._rec.event("resid_trace",
                            **self.last_trace.to_event_fields(step_i))
        return out

    def _step_oneshot(self, delta: float):
        sc = self.config.solver
        udi, fext, x0 = self._lift(delta)
        glob_n_eff = self.pm.glob_n_dof_eff
        prec = self._make_prec(sc.precond)
        ring = (trace_init(self.trace_len, self._trace_dtype)
                if self.trace_len else None)
        self._ring = ring
        if self.mixed:
            res = pcg_mixed(
                self.ops32, self.data32, self.ops, self.data,
                fext, x0, prec,
                tol=sc.tol, max_iter=sc.max_iter,
                glob_n_dof_eff=glob_n_eff,
                max_stag_steps=sc.max_stag_steps,
                inner_tol=sc.inner_tol,
                variant=sc.pcg_variant,
                trace_in=ring,
                **mixed_windows(sc),
            )
        else:
            res = pcg(
                self.ops, self.data, fext, x0, prec,
                tol=sc.tol, max_iter=sc.max_iter,
                glob_n_dof_eff=glob_n_eff,
                max_stag_steps=sc.max_stag_steps,
                variant=sc.pcg_variant,
                trace_in=ring,
            )
        self.un = res.x + udi
        return res.flag, res.relres, res.iters

    def _step_chunked(self, delta: float):
        """The chunked step (JAX ``driver.py:1295-1367``): the start step
        (lifting, r0, ||b||, the preconditioner built once), then
        ``run_with_recovery`` over the engine with this solver's recovery
        pieces as ``RecoveryHooks``."""
        rec = self._rec
        sc = self.config.solver
        data64 = self.data
        w = data64["weight"] * data64["eff"]
        f = _np_type(self.ops.dot_dtype)
        del self.dispatch_log[:]
        with rec.dispatch("start"):
            udi, fext, x0 = self._lift(delta)
            r0 = fext - self._amul64(x0)
            v = _read(self.ops.wdot(w, fext, fext), self.ops.wdot(w, r0, r0))
            n2b, normr0 = np.sqrt(f(v[0])), np.sqrt(f(v[1]))
            carry = cold_carry(x0, r0, normr0, self.ops.dot_dtype,
                               variant=sc.pcg_variant)
            prec = self._make_prec(sc.precond)
        if n2b == 0:
            self.un = torch.zeros_like(x0) + udi
            return 0, 0.0, 0
        ctx = self._make_resilience()

        def restart(x):
            # a cold Krylov carry at the best iterate seen
            with rec.dispatch("restart"):
                r = fext - self._amul64(x)
                nr = np.sqrt(f(_read(self.ops.wdot(w, r, r))[0]))
            return cold_carry(x, r, nr, self.ops.dot_dtype,
                              variant=sc.pcg_variant), nr

        def cold_restart():
            # device loss: the step's cold start state (fext, x0 and r0
            # are intact) and a rebuilt preconditioner
            with rec.dispatch("start"):
                c = cold_carry(x0, r0, normr0, self.ops.dot_dtype,
                               variant=sc.pcg_variant)
                return c, normr0, self._make_prec(sc.precond)

        data = {"f64": self.data, "f32": self.data32} if self.mixed \
            else self.data
        engine, x_fin, flag, relres, total = run_with_recovery(
            self._engine, data, fext, carry, normr0, n2b, prec,
            scfg=sc, mixed=self.mixed, recorder=rec,
            hooks=RecoveryHooks(restart=restart, cold_restart=cold_restart,
                                fallback_prec=self._fallback_prec,
                                escalation=self._escalation),
            resilience=ctx)
        # the ring of the engine that ran the final attempt (none after
        # an escalation, as in the JAX package)
        self._ring = engine.last_trace
        if ctx is not None:
            ctx.discard()       # the step is complete: its snapshot goes
        self.un = x_fin + udi
        return flag, relres, total

    # ------------------------------------------------------------------
    # Resilience (resilience/): the context and the recovery pieces
    # ------------------------------------------------------------------
    def _collective_comm(self):
        """The guarded host-collective group of the dispatch path
        (``resilience/distributed.GuardedComm``), built once; None with
        one process.  Every multi-process run gets one: the consensus
        agreements it carries are correctness-critical.  Only the
        deadline watchdog is opt-in (``PCG_TPU_COLLECTIVE_DEADLINE_S``);
        without it collectives run inline, and a dead peer's transport
        error still becomes ``DeadPeerError``."""
        if self.mesh.world <= 1:
            return None
        if self._group_comm is None:
            from pcg_mpi_solver_tpu_torch.resilience.distributed import (
                GuardedComm, collective_deadline_s)

            self._group_comm = GuardedComm(
                self._setup_comm or HostComm(),
                deadline_s=collective_deadline_s(), recorder=self._rec,
                index=self.mesh.rank)
        return self._group_comm

    def _elastic_point(self, store):
        """A group store pointed at an armed elastic resume's directory
        (the dead group's): its continuation epochs number past the ones
        committed there."""
        if self._elastic_dir is not None:
            store.path = self._elastic_dir
            store._epoch = store._scan_next_epoch()
        return store

    def _snapshot_store(self) -> SnapshotStore:
        """The step's mid-solve snapshot store, built once: across
        processes (or under an armed elastic resume) the group-consistent
        epoch store, else the per-file one."""
        if self._snap_store is None:
            if self.mesh.world > 1 or self._elastic_dir is not None:
                from pcg_mpi_solver_tpu_torch.resilience.distributed import (
                    GroupSnapshotStore)

                self._snap_store = self._elastic_point(
                    GroupSnapshotStore.for_solver(
                        self, comm=self._collective_comm(),
                        recorder=self._rec,
                        elastic=self._elastic_dir is not None))
            else:
                self._snap_store = SnapshotStore.for_solver(self)
        return self._snap_store

    def _make_resilience(self) -> Optional[ResilienceContext]:
        """The step's resilience context (its snapshots ``snap_*.npz`` at
        the step's index)."""
        store = (self._snapshot_store()
                 if self.config.snapshot_every > 0 else None)
        return self._resilience(store, len(self.flags) + 1,
                                self._resume_pending)

    def _resilience(self, store, step: int,
                    resume: bool) -> Optional[ResilienceContext]:
        """A resilience context over ``store`` at ``step``, or None when
        the subsystem is off (no store, no ladder budget, no fault
        plan)."""
        sc = self.config.solver
        comm = self._collective_comm()
        if store is None and sc.max_recoveries <= 0 \
                and self.fault_plan is None and comm is None:
            return None
        return ResilienceContext(
            store=store, step=step,
            snapshot_every=int(self.config.snapshot_every),
            fetch_state=self._fetch_state, put_state=self._put_state,
            guard=DispatchGuard(retries=sc.dispatch_retries,
                                deadline_s=retry_deadline_s(),
                                recorder=self._rec),
            faults=self.fault_plan, recorder=self._rec, resume=resume,
            ladder_armed=sc.max_recoveries > 0, comm=comm)

    def _fetch_state(self, state):
        """Device state tree -> host numpy (tensors copied off the
        device; numbers and tags as they are).  Across processes each
        vector is gathered whole to every rank (a collective): the parts
        axis of (P, n_loc) and of a blocked (R, P, n_loc)."""
        if isinstance(state, dict):
            return {k: self._fetch_state(v) for k, v in state.items()}
        if isinstance(state, torch.Tensor):
            t = state.detach()
            if self.mesh.world > 1 and t.dim() >= 2:
                if t.dim() == 3:
                    return np.ascontiguousarray(np.moveaxis(fetch_global(
                        t.transpose(0, 1).contiguous(), self.mesh), 1, 0))
                return fetch_global(t, self.mesh)
            return t.to("cpu", copy=True).numpy()
        if isinstance(state, (int, float, bool, str)):
            return state
        return np.asarray(state)

    def _put_state(self, state):
        """Host numpy state tree -> the solver's device: the vectors ((P,
        n_loc), or (R, P, n_loc) in a blocked carry) become tensors in
        their own dtype, bitwise, each rank its rows of the parts axis;
        scalars and (R,) leaves stay on the host, tags pass through."""
        if isinstance(state, dict):
            return {k: self._put_state(v) for k, v in state.items()}
        a = np.asarray(state)
        if a.ndim >= 2:
            lo, hi = self._part_range
            a = a[lo:hi] if a.ndim == 2 else a[:, lo:hi]
            return torch.as_tensor(np.array(a), device=self.device)
        return state

    def measure_comm_split(self, n_iters: Optional[int] = None) -> dict:
        """The calc vs comm-wait split of a PCG iteration (the JAX
        package's ``measure_comm_split``; the reference brackets every MPI
        call with host timers, pcg_solver.py:631-641): ``n_iters`` of the
        iteration body (one assembled matvec and the classic loop's three
        scalar reductions) timed once with the group's collectives and
        once on a copy of the operator without them (the same local
        work); the difference is collective time.  One process:
        ``ONE_DEVICE_COMM``.  Returns {"comm_frac", "full_s_per_iter",
        "calc_s_per_iter"}."""
        if n_iters is None:
            n_iters = max(int(self.config.comm_probe_iters), 1)
        if self.mesh.world <= 1:
            return dict(ONE_DEVICE_COMM)
        ops, d = (self.ops32, self.data32) if self.mixed \
            else (self.ops, self.data)
        eff = d["eff"]
        w = d["weight"] * eff

        def run(o) -> float:
            x = eff.clone()
            if o.multi:
                # consensus-exempt: the barrier carries no verdict; every
                # rank runs the probe (mesh.world and comm_probe_iters are
                # the same on every rank)
                self._group.barrier()
            t0 = time.perf_counter()
            for _ in range(n_iters):
                q = eff * o.matvec(d, x)
                o.wdot(w, x, q)
                pq = o.wdot(w, q, q)
                o.wdots(w, [(x, x), (q, q), (x, q)])
                x = (q / torch.sqrt(torch.clamp(pq, min=1e-30))).to(x.dtype)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return time.perf_counter() - t0

        local = dataclasses.replace(ops, group=None)
        run(ops)                                  # the first use's setup
        full, calc = run(ops), run(local)
        frac = max(0.0, 1.0 - calc / full) if full > 0 else 0.0
        return {"comm_frac": float(frac),
                "full_s_per_iter": full / n_iters,
                "calc_s_per_iter": calc / n_iters}

    def resume_elastic(self, snapshot_dir: Optional[str] = None,
                       **solve_kw) -> List[StepResult]:
        """Resume a multi-process run's persisted state on another
        (typically smaller) process count (JAX ``driver.py:2215``).  The
        group snapshot epochs carry each rank's part rows and the step
        checkpoints the globally fetched state, so a committed N-rank
        epoch joins into the full state on any process count; the
        fingerprint mismatch confined to ``n_procs`` becomes an
        ``elastic_resume`` event instead of a refusal.  ``snapshot_dir``
        is the dead group's checkpoint directory (None: this config's
        ``checkpoint_path``); other keywords pass to :meth:`solve`."""
        self._elastic_dir = snapshot_dir or self.config.checkpoint_path
        self._snap_store = None
        try:
            return self.solve(resume=True, **solve_kw)
        finally:
            self._elastic_dir = None
            self._snap_store = None

    def solve(self, on_step: Optional[Callable[[int, StepResult], None]]
              = None, store=None, resume: bool = False) -> List[StepResult]:
        """Run the quasi-static schedule ``time_step_delta``, skipping
        step 0 (the reference's ``range(1, RefMaxTimeStepCount)``,
        pcg_solver.py:1002), exporting contour frames, the probe history
        and the timing data into ``store`` (``utils.io.RunStore``) when
        exports are enabled, in the JAX package's layout on disk.

        With ``resume=True``, restore the latest step checkpoint under
        ``config.checkpoint_path`` (if any), continue from the step after
        it, and let that step resume its mid-solve snapshot (only then: a
        fresh solve never continues a stale snapshot); with
        ``config.checkpoint_every > 0``, checkpoint every N completed
        steps and after the last.  Returns the results of the steps this
        call ran."""
        th = self.config.time_history
        deltas = th.time_step_delta
        speed = self.config.speed_test
        do_export = store is not None and th.export_flag and not speed
        do_plot = store is not None and th.plot_flag and not speed
        if do_export and self._model.n_dof == self._model.n_node:
            bad = self._nodal_vars()            # includes NS
            if bad:
                # the strain/stress/nonlocal fields need 6 Voigt
                # components: refuse up front, not mid-solve
                raise ValueError(
                    f"export vars {bad} (strain/stress nodal fields) are "
                    "not available for the scalar problem class; export 'U'")
        every = self.config.checkpoint_every
        ckpt = None
        t_start = 1
        if every > 0 or resume:
            ckpt = CheckpointManager(self.config.checkpoint_path)
        if resume:
            if self._elastic_dir is not None:
                ckpt = CheckpointManager(self._elastic_dir)
            t_done = ckpt.restore(self, elastic=self._elastic_dir is not None,
                                  recorder=self._rec)
            if t_done is not None:
                t_start = t_done + 1
        self._resume_pending = bool(resume)

        t_prep = time.perf_counter() - self._t_init0
        if do_export and t_start == 1:
            # on resume the run dir (maps and frames so far) must survive;
            # prepare() would rotate it away
            store.prepare()
            if self.mesh.world > 1:
                # prepare() rotates an old run dir on the primary: no
                # rank's shard write may race it.
                # consensus-exempt: no verdict: every rank reaches it, as
                # do_export is the configuration's and t_start the step of
                # the checkpoint directory every rank reads before any
                # rank writes to it
                self._group.barrier()
            store.write_map("Dof", self.export_dof_map())
            if self._nodal_vars():
                store.write_map("NodeId", self.export_node_map())
            self._export_count = 0
            self._export_times = []
            self._maybe_export(store, 0)
        if t_start == 1:
            self._probe_u = []
        # profile_dir: a torch.profiler capture around the steps
        prof_dir = self.config.profile_dir
        if prof_dir and speed:
            warnings.warn("profile_dir is ignored in speed-test mode "
                          "(speed_test disables all I/O)")
        if prof_dir and self.mesh.world > 1:
            # one capture directory a rank (the p<N>/ naming of
            # obs/fleet.py)
            prof_dir = os.path.join(prof_dir, f"p{self.mesh.rank}")
        prof = start_capture(self.device) if prof_dir and not speed \
            else None
        results = []
        try:
            for t in range(t_start, len(deltas)):
                res = self.step(deltas[t])
                results.append(res)
                if do_export:
                    self._maybe_export(store, t)
                if do_plot and len(th.probe_dofs) > 0:
                    u = self.displacement_global()
                    self._probe_u.append(u[np.asarray(th.probe_dofs)])
                if every > 0 and (t % every == 0 or t == len(deltas) - 1):
                    ckpt.save(self, t)
                if on_step is not None:
                    on_step(t, res)
        finally:
            self._resume_pending = False
            if prof is not None:
                # the pointer post-mortems follow to the artifact
                art = stop_capture(prof, prof_dir)
                self._rec.event("profile_capture", path=art, source="solve",
                                steps=len(results))
        if do_export:
            store.write_time_list(self._export_times)
        if do_plot and self._probe_u:
            times = [i * th.dt for i in range(1, len(deltas))]
            store.write_plot_data(times, np.stack(self._probe_u, axis=1),
                                  th.probe_dofs)
        if store is not None and not speed:
            comm = (self.measure_comm_split()
                    if self.config.comm_probe_iters > 0 else None)
            store.write_time_data(self.pm.n_parts,
                                  self.time_data(t_prep, comm))
        # the end-of-run counters, gauges and dispatch attribution
        self._rec.emit_run_summary()
        return results

    def _maybe_export(self, store, t: int) -> None:
        """Key-frame contour export (reference exportContourData,
        pcg_solver.py:841-896): U as the owner-masked dofs, the nodal
        fields as the owner-masked nodes, NS from the host build."""
        th = self.config.time_history
        due = th.export_frame_rate > 0 and t % th.export_frame_rate == 0
        if t in tuple(th.export_frames):
            due = True
        if not due:
            return
        t0 = time.perf_counter()
        k = self._export_count
        P = int(self.pm.n_parts)
        multi = self.mesh.world > 1
        if "U" in self._export_vars():
            if multi:
                # each rank writes its own block of parts (the
                # reference's writeMPIFile_parallel, pcg_solver.py:869)
                vals, p0, p1 = self.displacement_owned_local()
                store.write_frame_shard("U", k, vals, p0, p1, P)
            else:
                store.write_frame("U", k, self.displacement_owned())
        if [v for v in self._nodal_vars() if v != "NS"]:
            mask = self.node_owner_mask()
            for var, arr in self._nodal_fields().items():
                rows, p0, p1 = fetch_addressable(arr, self.mesh)
                if multi:
                    store.write_frame_shard(var, k, rows[mask[p0:p1]],
                                            p0, p1, P)
                else:
                    store.write_frame(var, k, rows[mask])
        if "NS" in self._export_vars():
            store.write_frame("NS", k,
                              self._nonlocal_field()[self.export_node_map()])
        self._export_times.append(t * th.dt)
        self._export_count = k + 1
        self._export_wall += time.perf_counter() - t0

    def _export_vars(self) -> List[str]:
        ev = self.config.time_history.export_vars
        return ev.split() if " " in ev else [
            v for v in ("U", "D", "ES", "PS", "PE", "NS") if v in ev]

    def _nodal_vars(self) -> List[str]:
        return [v for v in self._export_vars() if v != "U"]

    def _nonlocal_field(self) -> np.ndarray:
        """Nonlocal von Mises stress, node-averaged, as a global (n_node,)
        host field: element stresses of the global solution smoothed by
        the Gaussian neighbourhood operator (reference
        config_NonlocalNeighbours, partition_mesh.py:1000-1299), as the
        JAX package computes it on the host."""
        if self._nonlocal is None:
            self._nonlocal = build_nonlocal_weights(self._model)
        sig = elem_stress_host(self._model, self.displacement_global())
        ns = self._nonlocal.apply(von_mises_stress(sig, axis=1))
        return nodal_average_host(self._model, ns)

    def _nodal_fields(self) -> dict:
        """The nodal export fields of the current solution, {var: (P,
        n_node_loc) tensor} on the solver's device: computed from the
        storage-dtype solution (float64 in mixed precision) on the
        storage-dtype tree, never from an f32 inner iterate."""
        nodal = tuple(v for v in self._nodal_vars() if v != "NS")
        if self._model.n_dof == self._model.n_node:
            raise ValueError(
                f"export vars {nodal} (strain/stress nodal fields) are "
                "not available for the scalar problem class; export 'U'")
        return nodal_export_fields(self.ops, self.data, self.un, nodal,
                                   self._nu)

    def time_data(self, t_prep: float = 0.0,
                  comm_split: Optional[dict] = None) -> dict:
        """Solve metadata in the reference's TimeData schema
        (file_operations.py:72-172, pcg_solver.py:943-961) with the JAX
        package's extensions: a first-step overhead estimate, the export
        seconds and per-part load-unbalance stats."""
        steps = np.asarray(self.step_times)
        proc = np.asarray(self._proc_step_times)
        compile_est = (float(proc[0] - np.median(proc[1:]))
                       if len(proc) > 1 else 0.0)
        type_blocks = getattr(self.pm, "type_blocks", None)
        if type_blocks:
            elems_pp = np.sum([tb.n_elem for tb in type_blocks], axis=0)
        else:   # structured slab partition: the same cell count a part
            elems_pp = np.full(self.pm.n_parts,
                               self.pm.nxc * self.pm.ny * self.pm.nz)
        dofs_pp = np.asarray(self.pm.ndof_p)
        unbalance = {
            "ElemsPerPart": elems_pp,
            "DofsPerPart": dofs_pp,
            "MaxByMeanElems": float(elems_pp.max() / max(elems_pp.mean(), 1))
            if elems_pp.size else 1.0,
            "MaxByMeanDofs": float(dofs_pp.max() / max(dofs_pp.mean(), 1)),
            "IfaceDofFrac": float(self.pm.n_iface
                                  / max(self.pm.glob_n_dof, 1)),
        }
        total = float(np.sum(self.step_times))
        comm_frac = comm_split["comm_frac"] if comm_split else 0.0
        return {
            "Mean_FileReadTime": t_prep,
            "Mean_CalcTime": total * (1.0 - comm_frac),
            "Mean_CommWaitTime": total * comm_frac,
            "CommProbe": comm_split or {},
            "Compile_Time_Est": max(compile_est, 0.0),
            "Export_Time": float(self._export_wall),
            "TotalTime": t_prep + total,
            "Flag": np.asarray(self.flags),
            "Iter": np.asarray(self.iters),
            "RelRes": np.asarray(self.relres),
            "StepTimes": steps,
            "LoadUnbalanceData": unbalance,
            "MP_NDOF": self.pm.n_loc,
            "N_Parts": self.pm.n_parts,
        }

    # -- host-side views for export -------------------------------------
    def owner_mask(self) -> np.ndarray:
        """(P, n_loc) bool: the dofs each part owns (reference
        DofWeightVector_Export, pcg_solver.py:198)."""
        return (self.pm.weight > 0) & (self.pm.dof_gid >= 0)

    def node_owner_mask(self) -> np.ndarray:
        """(P, n_node_loc) bool: the nodes each part owns."""
        return (self.pm.node_weight > 0) & (self.pm.node_gid >= 0)

    def export_node_map(self) -> np.ndarray:
        """Global node ids in export order (reference 'NodeId' map,
        pcg_solver.py:202)."""
        return self.pm.node_gid[self.node_owner_mask()]

    def export_dof_map(self) -> np.ndarray:
        """Global dof ids in export order (the reference's 'Dof' map,
        pcg_solver.py:201)."""
        return self.pm.dof_gid[self.owner_mask()]

    def displacement_owned(self) -> np.ndarray:
        """Owner-masked local solution values, in part order (the frame's
        'U_i' payload, pcg_solver.py:869); across processes every rank's
        rows are gathered first."""
        return fetch_global(self.un, self.mesh)[self.owner_mask()]

    def displacement_owned_local(self):
        """This rank's slice of :meth:`displacement_owned`, without a
        collective: ``(values, p0, p1)`` for parts [p0, p1).  The slices
        of all ranks in part order are ``displacement_owned()``."""
        rows, p0, p1 = fetch_addressable(self.un, self.mesh)
        return rows[self.owner_mask()[p0:p1]], p0, p1

    def max_block_width(self) -> int:
        """The widest block ``solve_many`` takes for this model: a blocked
        matvec's node grid (R * n_parts * n_loc entries, this rank's
        parts) must stay below 2^31, the kernels' 32-bit indexing."""
        return (2**31 - 1) // (self._pm_dev.n_parts * self.pm.n_loc)

    def _block_trees(self, R: int):
        """The device trees of blocks of width ``R`` (cell scales repeated
        per column, ``block_data``), built once per width and kept for the
        last width only."""
        if self._many_data is None or self._many_data[0] != R:
            self._many_data = None
            trees = (self.ops.block_data(self.data, R),
                     self.ops.block_data(self.data32, R) if self.mixed
                     else None)
            self._many_data = (R,) + trees
        return self._many_data[1:]

    def solve_many(self, fexts, resume: bool = False) -> ManySolveResult:
        """Solve K.x_j = fext_j for a block of load cases against the one
        operator, in one lockstep loop with a per-column convergence mask.

        ``fexts``: global loads as (n_dof, nrhs) (a single (n_dof,) vector
        or an (nrhs, n_dof) stack also works).  Homogeneous Dirichlet: the
        loads act on the effective dofs and x0 = 0 (no lifting; lift
        prescribed displacements into the columns yourself).  Each column
        is validated first (``validate.check_rhs_block``: a NaN column
        raises ``PreflightError`` naming it).  Mixed precision runs
        ``pcg_mixed_many``, direct ``pcg_many``, under the configured
        variant and preconditioner.

        A direct block at or above the dispatch cap (the cap of ``step``:
        4 M dofs, or ``iters_per_dispatch`` > 0) runs the chunked path
        (``_solve_many_chunked``): capped resumable calls with one
        recovery ladder a column, mid-solve ``many_*.npz`` snapshots every
        ``config.snapshot_every`` chunks, ``resume=True`` continuing a
        killed block bit for bit, and column faults (``mode@col:k``).
        Every other block runs one-shot, inside the dispatch guard: a
        breakdown (flags 2, 4, 6), a non-finite residual or
        ``QUARANTINE_FLAG`` reports the column quarantined (flag 5) with
        its min-residual iterate, and a snapshot or resume request is
        noted, as the JAX package does, since no chunk boundary exists."""
        t0 = time.perf_counter()
        sc = self.config.solver
        pm = self.pm
        n_dof = pm.glob_n_dof
        rdt = np.float64 if self.mixed else _np_type(self.dtype)
        fb = normalize_rhs_block(fexts, n_dof, rdt)
        bad = [c for c in check_rhs_block(fb, n_dof) if c.status == "fail"]
        if bad:
            raise PreflightError(
                "solve_many rejected the rhs block: " + "; ".join(
                    f"[{c.name}] {c.detail}" for c in bad))
        R = fb.shape[1]
        if R > self.max_block_width():
            raise ValueError(
                f"a block of {R} right-hand sides needs a {R} x "
                f"{pm.n_parts} x {pm.n_loc} node grid, past the kernels' "
                f"32-bit indexing; this model takes at most "
                f"{self.max_block_width()} columns a block")
        # global columns -> the port's (R, P, n_loc) block; shared slab
        # planes carry their value on both parts, padded slots read 0
        gid = pm.dof_gid[slice(*self._part_range)]
        loc = fb[np.clip(gid, 0, None), :] * (gid >= 0)[..., None]
        fb_dev = torch.as_tensor(np.ascontiguousarray(np.moveaxis(loc, -1, 0)),
                                 dtype=self.dtype, device=self.device)
        data, data32 = self._block_trees(R)
        t_solve0 = time.perf_counter()
        every = int(self.config.snapshot_every)
        if self._dispatch_cap > 0 and not self.mixed:
            # the hash fingerprints snapshots only: never scan the block
            # when neither snapshots nor a resume can use it
            rhs_hash = array_hash(fb) if (resume or every > 0) else ""
            (x, flags, relres, iters, quarantined, recoveries, drift,
             trips) = self._solve_many_chunked(fb_dev, data, R, resume,
                                               rhs_hash)
        else:
            if resume or every > 0:
                self._rec.note(
                    "solve_many: snapshot/resume requested but this "
                    "blocked solve runs as ONE dispatch (mixed precision, "
                    "or below the dispatch cap) — no mid-solve snapshots "
                    "exist on this path")
            res = self._dispatch_with_retry(
                "solve_many", lambda: self._solve_many_oneshot(
                    fb_dev, data, data32))
            flags = np.asarray(res.flag, np.int64)
            relres = np.asarray(res.relres, np.float64)
            iters = np.asarray(res.iters, np.int64)
            x, trips, recoveries, drift = res.x, int(res.trips), 0, 0
            # one-shot quarantine: breakdowns, poisoned columns and
            # non-finite residuals report flag 5 (their min-residual
            # iterate is already in x)
            quar = (np.isin(flags, BREAKDOWN_FLAGS + (QUARANTINE_FLAG,))
                    | ~np.isfinite(relres))
            for j in np.flatnonzero(quar):
                trig = ("nan_carry" if not np.isfinite(relres[j])
                        or int(flags[j]) == QUARANTINE_FLAG
                        else f"flag{int(flags[j])}")
                self._rec.event("rhs_quarantine", rhs=int(j), trigger=trig,
                                flag=QUARANTINE_FLAG, attempts=0)
                self._rec.inc("resilience.rhs_quarantine")
            flags = np.where(quar, QUARANTINE_FLAG, flags)
            quarantined = tuple(int(j) for j in np.flatnonzero(quar))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        out = ManySolveResult(
            flags=flags, relres=relres, iters=iters, wall_s=t1 - t0,
            x=x.permute(1, 2, 0), solve_wall_s=t1 - t_solve0,
            quarantined=tuple(quarantined), recoveries=int(recoveries),
            drift=int(drift), trips=int(trips))
        self._rec.event("solve_many", nrhs=R, wall_s=round(out.wall_s, 6),
                        flags=[int(v) for v in flags],
                        iters_max=int(iters.max()) if R else 0,
                        quarantined=list(out.quarantined),
                        recoveries=out.recoveries)
        for j in range(R):
            self._rec.event("rhs_solve", rhs=j, flag=int(flags[j]),
                            relres=float(relres[j]), iters=int(iters[j]),
                            quarantined=bool(j in out.quarantined))
        return out

    def _solve_many_oneshot(self, fb_dev, data, data32):
        """The one-shot blocked solve: one ``pcg_many`` or
        ``pcg_mixed_many`` call from x0 = 0."""
        sc = self.config.solver
        fext = self.data["eff"] * fb_dev
        x0 = torch.zeros_like(fext)
        glob_n_eff = self.pm.glob_n_dof_eff
        if self.mixed:
            return pcg_mixed_many(
                self.ops32, data32, self.ops, data, fext, x0,
                make_prec(self.ops32, self.data32, sc.precond),
                tol=sc.tol, max_iter=sc.max_iter,
                glob_n_dof_eff=glob_n_eff,
                max_stag_steps=sc.max_stag_steps,
                inner_tol=sc.inner_tol, variant=sc.pcg_variant,
                **mixed_windows(sc))
        return pcg_many(
            self.ops, data, fext, x0,
            make_prec(self.ops, self.data, sc.precond),
            tol=sc.tol, max_iter=sc.max_iter,
            glob_n_dof_eff=glob_n_eff,
            max_stag_steps=sc.max_stag_steps, x0_zero=True,
            variant=sc.pcg_variant)

    def _dispatch_with_retry(self, name: str, fn):
        """Run a stateless dispatch inside the fault plan's dispatch hooks
        and the retry guard (JAX ``driver.py:1764-1802``): a device-loss
        failure runs ``fn`` again after backoff, within
        ``solver.dispatch_retries`` and ``PCG_TPU_RETRY_DEADLINE_S``."""
        plan = self.fault_plan
        guard = None
        while True:
            try:
                if plan is not None:
                    plan.on_dispatch()
                with self._rec.dispatch(name):
                    out = fn()
                if plan is not None:
                    plan.on_dispatch_done()
                return out
            except Exception as e:      # noqa: BLE001 — classified below
                if guard is None:
                    guard = DispatchGuard(
                        retries=self.config.solver.dispatch_retries,
                        deadline_s=retry_deadline_s(), recorder=self._rec)
                if not guard.redispatch(e):
                    raise

    def _many_use_fb(self) -> bool:
        """Whether the blocked cycle carries the scalar-Jacobi fallback
        operand (the per-column ladder's rung 2): the ladder is armed and
        the configured preconditioner has a weaker one.  Shared by the
        chunked path and its snapshot fingerprint."""
        sc = self.config.solver
        return bool(sc.max_recoveries > 0
                    and fallback_kind(sc.precond) is not None)

    def _many_store(self, R: int, rhs_hash: str) -> SnapshotStore:
        """The blocked solve's snapshot store: the group-consistent epoch
        store across processes (or under an armed elastic resume), else
        the per-file one."""
        if self.mesh.world > 1 or self._elastic_dir is not None:
            from pcg_mpi_solver_tpu_torch.resilience.distributed import (
                GroupSnapshotStore)

            return self._elastic_point(GroupSnapshotStore.for_many_solver(
                self, R, rhs_hash=rhs_hash, comm=self._collective_comm(),
                recorder=self._rec, elastic=self._elastic_dir is not None))
        return SnapshotStore.for_many_solver(self, R, rhs_hash=rhs_hash)

    def _solve_many_chunked(self, fb_dev, data, R: int, resume: bool,
                            rhs_hash: str = ""):
        """The chunked blocked solve (JAX ``driver.py:1816-1970``,
        ``:2086-2149``): the start (fext, ||b||, the cold carry, the
        preconditioner and, when the ladder can use it, the scalar-Jacobi
        fallback, built once), then ``run_many_with_recovery`` over capped
        ``pcg_many`` calls and the masked ``restart_carry_many``, then the
        terminal per-column selection (``select_best_many``).  The
        snapshot is discarded only when the block completes.  Returns
        (x, flags, relres, iters, quarantined, recoveries, drift,
        trips)."""
        sc = self.config.solver
        rec = self._rec
        variant = sc.pcg_variant
        lagged = variant in LAGGED_VARIANTS
        cap = self._dispatch_cap
        use_fb = self._many_use_fb()
        every = int(self.config.snapshot_every)
        store = (self._many_store(R, rhs_hash) if (every > 0 or resume)
                 else None)
        f = _np_type(self.ops.dot_dtype)
        trips = [0]
        with rec.dispatch("many_start"):
            eff = self.data["eff"]
            fext = eff * fb_dev
            w = data["weight"] * data["eff"]
            normr0 = np.sqrt(_read(self.ops.wdot_many(w, fext, fext))
                             .astype(f))
            carry = cold_carry_many(torch.zeros_like(fext), fext, normr0,
                                    self.ops.dot_dtype, variant=variant)
            prec = make_prec(self.ops, self.data, sc.precond)
            prec_fb = (make_prec(self.ops, self.data, "jacobi") if use_fb
                       else None)
        # kind="many" states at the fixed pseudo-step 1
        ctx = self._resilience(store, 1, resume)

        def cycle(carry, budget):
            with rec.dispatch("many_cycle"):
                res, c2 = pcg_many(
                    self.ops, data, fext, carry["x"], prec, tol=sc.tol,
                    max_iter=min(cap, budget),
                    glob_n_dof_eff=self.pm.glob_n_dof_eff,
                    max_stag_steps=sc.max_stag_steps,
                    max_iter_nominal=sc.max_iter, carry_in=carry,
                    return_carry=True, variant=variant,
                    inv_diag_fb=prec_fb)
            trips[0] += int(res.trips)
            self.dispatch_log.append(("many", int(c2["exec"].max()),
                                      tuple(int(v) for v in c2["flag"])))
            return res.x, c2

        def recover(carry, restart_m, fb_m, quar_m):
            with rec.dispatch("many_recover"):
                return restart_carry_many(self.ops, data, fext, carry,
                                          restart_m, fb_m, quar_m,
                                          variant=variant)

        del self.dispatch_log[:]
        (_x, carry, flags, _total, iters, quarantined, recoveries,
         drift_cols) = run_many_with_recovery(
            carry, scfg=sc, nrhs=R, recorder=rec,
            hooks=ManyRecoveryHooks(cycle=cycle, recover=recover,
                                    has_fallback=use_fb),
            resilience=ctx, resume=resume, lagged=lagged)
        with rec.dispatch("many_final"):
            x, relres = select_best_many(self.ops, data, fext, carry,
                                         always_min=lagged)
        if ctx is not None:
            ctx.discard()       # the block completed: its snapshot goes
        return (x, np.asarray(flags, np.int64), relres, iters,
                quarantined, recoveries, int(drift_cols.sum()), trips[0])

    def displacement_global_many(self, x) -> np.ndarray:
        """A blocked solution (n_parts, n_loc, nrhs) (``ManySolveResult.x``)
        as global host columns (n_dof, nrhs): one fetch, owner-masked."""
        xn = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)
        return gather_owned_global(self.pm, xn, self.mesh)

    def displacement_global(self) -> np.ndarray:
        """Full global solution vector (n_dof,), assembled on the host from
        the owner-weighted local rows (of every rank: a collective across
        processes)."""
        return gather_owned_global(self.pm, self.un, self.mesh)

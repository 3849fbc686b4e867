"""Quasi-static solve driver on the structured slab backend.

Port of the structured core of ``pcg_mpi_solver_tpu/solver/driver.py``
(``Solver`` in direct and mixed precision, ``StepResult``,
``displacement_global``).  For each time step: Dirichlet lifting ->
preconditioner rebuild (scalar Jacobi, 3x3 block Jacobi or the mg
V-cycle's operand) -> PCG (direct, or the mixed f32/f64 refinement
shell) -> u = x + Ud * delta.  Under ``precond="mg"`` the constructor
also builds the level hierarchy (``ops/mg.py``) into ``data["mg"]`` and
estimates the fine level's Chebyshev bound on the uploaded operator.

The solver runs on ``cuda`` unless the caller passes ``device="cpu"``;
without a card, the default raises instead of quietly running on the CPU.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from pcg_mpi_solver_tpu_torch.config import (
    RunConfig, SolverConfig, TimeHistoryConfig)
from pcg_mpi_solver_tpu_torch.models.model_data import ModelData
from pcg_mpi_solver_tpu_torch.ops import mg as mgmod
from pcg_mpi_solver_tpu_torch.ops.precond import make_prec
from pcg_mpi_solver_tpu_torch.ops.structured_matvec import (
    VARIANTS, pallas_planes, selected_variant)
from pcg_mpi_solver_tpu_torch.parallel.structured import (
    StructuredOps, device_data_structured, partition_structured)
from pcg_mpi_solver_tpu_torch.solver.pcg import pcg, pcg_mixed

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass
class StepResult:
    flag: int
    relres: float
    iters: int
    wall_s: float


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; a CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    return dev


# Config fields whose option is not ported yet: (section, field) -> the
# ROADMAP queue 1 item that brings it.  A value other than the JAX
# package's default raises NotImplementedError naming the item.
UNPORTED = {
    **{("solver", f): 3 for f in (
        "mixed_plateau_window", "mixed_progress_window",
        "mixed_progress_ratio", "mixed_progress_min_gain")},
    **{("solver", f): 9 for f in ("max_recoveries", "dispatch_retries")},
    ("solver", "trace_resid"): 14,
    ("time_history", "dt"): 10,
    **{("time_history", f): 11 for f in (
        "export_frame_rate", "export_frames", "plot_flag", "export_vars",
        "probe_dofs")},
    ("run", "setup_shard"): 12,
    **{("run", f): 14 for f in (
        "preflight", "cache_dir", "telemetry_path", "flight_path",
        "telemetry_profile", "profile_dir", "comm_probe_iters")},
}
_DEFAULTS = {"run": RunConfig(), "solver": SolverConfig(),
             "time_history": TimeHistoryConfig()}


def _check_slice(model: ModelData, config: RunConfig, n_parts: int) -> None:
    """Raise NotImplementedError for anything outside the ported slice,
    naming the ROADMAP queue 1 item that brings it."""
    sections = {"run": config, "solver": config.solver,
                "time_history": config.time_history}
    for (section, field), item in UNPORTED.items():
        value = getattr(sections[section], field)
        if value != getattr(_DEFAULTS[section], field):
            raise NotImplementedError(
                f"{section}.{field}={value!r} is not ported yet (ROADMAP "
                f"queue 1 item {item}); only the default "
                f"{getattr(_DEFAULTS[section], field)!r} is")
    sc = config.solver
    if sc.pallas in ("off", "interpret"):
        raise NotImplementedError(
            f"pallas={sc.pallas!r}: the port has no XLA path and no "
            f"interpreter; it always runs its CUDA kernels on the card and "
            f"their plain version on the CPU ('auto' or 'on')")
    if sc.pcg_variant != "classic":
        raise NotImplementedError(
            f"pcg_variant={sc.pcg_variant!r} is not ported yet (ROADMAP "
            f"queue 1 item 6: PCG variants)")
    if sc.nrhs > 1:
        raise NotImplementedError(
            "nrhs > 1 is not ported yet (ROADMAP queue 1 item 7: blocked "
            "right-hand sides)")
    if config.checkpoint_every or config.snapshot_every:
        raise NotImplementedError(
            "checkpoints and snapshots are not ported yet (ROADMAP queue 1 "
            "item 9: chunked dispatch and resilience)")
    if config.partition_method not in ("rcb", "auto"):
        raise NotImplementedError(
            f"partition_method={config.partition_method!r} needs the "
            f"general backend (ROADMAP queue 1 item 8)")
    structured = (model.grid is not None
                  and not np.asarray(model.elem_sign_flat).any()
                  and not model.intfc_elems
                  and model.grid[0] % n_parts == 0)
    if not structured:
        raise NotImplementedError(
            "only the structured slab backend is ported (a model with "
            "grid metadata, no reflected elements or interfaces, and "
            "nx divisible by n_parts); the general backend is ROADMAP "
            "queue 1 item 8 and the hybrid backend item 13")


class Solver:
    """Owns the partitioned model on one device and runs time steps."""

    def __init__(self, model: ModelData, config: Optional[RunConfig] = None,
                 n_parts: Optional[int] = None, device=None):
        t0 = time.perf_counter()
        self.config = config or RunConfig()
        self.device = resolve_device(device)
        n_parts = self.config.n_parts if n_parts is None else n_parts
        if n_parts < 1:
            raise ValueError(f"n_parts must be >= 1, got {n_parts}")
        _check_slice(model, self.config, n_parts)
        sc = self.config.solver
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

        t_part = time.perf_counter()
        self.pm = partition_structured(model, n_parts)
        self.partition_build_s = time.perf_counter() - t_part
        mg_degree = int(sc.mg_smooth_degree)
        self.ops = StructuredOps.from_partition(
            self.pm, dot_dtype=dot_dtype, mg_degree=mg_degree,
            **(kernel if self.dtype == torch.float32 else {}))
        self.data = device_data_structured(self.pm, self.dtype, self.device)
        # MG hierarchy (precond="mg"): host-built levels and transfers into
        # the device tree, float leaves at the storage dtype
        self.mg_setup = None
        if sc.precond == "mg":
            t_mg = time.perf_counter()
            self.mg_setup = mgmod.build_mg_host(
                model, self.pm, n_levels=int(sc.mg_levels),
                degree=mg_degree,
                max_replicated_dofs=int(sc.mg_max_replicated_dofs))
            self.data["mg"] = mgmod.tree_from_numpy(
                self.mg_setup.tree, self.dtype, self.device)
            self.mg_setup_s = time.perf_counter() - t_mg
        if self.mixed:
            # f32 shadow of the float leaves (the f32 inner cycles' data);
            # their dots accumulate in f32
            self.data32 = mgmod.cast_tree(self.data, torch.float32)
            self.ops32 = StructuredOps.from_partition(
                self.pm, dot_dtype=torch.float32, mg_degree=mg_degree,
                **kernel)
        if self.mg_setup is not None:
            # the fine level's Chebyshev bound: power-iteration matvecs on
            # the uploaded storage-dtype operator, installed with the
            # coarse bounds into every tree
            t_lam = time.perf_counter()
            lam_fine = mgmod.estimate_fine_lam(self.ops, self.data)
            self.mg_lam = mgmod.install_lam(
                self.mg_setup, lam_fine,
                [self.data] + ([self.data32] if self.mixed else []))
            self.mg_lam_s = time.perf_counter() - t_lam

        # Initial state: deterministic zeros.
        self.un = torch.zeros((self.pm.n_parts, self.pm.n_loc),
                              dtype=self.dtype, device=self.device)
        self.flags: List[int] = []
        self.relres: List[float] = []
        self.iters: List[int] = []
        self.step_times: List[float] = []
        self.setup_s = time.perf_counter() - t0

    def step(self, delta: float) -> StepResult:
        """One quasi-static step at load factor ``delta``."""
        t0 = time.perf_counter()
        sc = self.config.solver
        data64 = self.data
        eff = data64["eff"]
        # Dirichlet lifting: Fext = F*delta - K.(Ud*delta)
        delta = float(delta)
        udi = data64["Ud"] * delta
        fdi = self.ops.matvec(data64, udi)
        fext = eff * (data64["F"] * delta - fdi)
        x0 = eff * self.un
        glob_n_eff = self.pm.glob_n_dof_eff
        if self.mixed:
            inv_diag32 = make_prec(self.ops32, self.data32, sc.precond)
            res = pcg_mixed(
                self.ops32, self.data32, self.ops, data64,
                fext, x0, inv_diag32,
                tol=sc.tol, max_iter=sc.max_iter,
                glob_n_dof_eff=glob_n_eff,
                max_stag_steps=sc.max_stag_steps,
                inner_tol=sc.inner_tol,
                variant=sc.pcg_variant,
            )
        else:
            inv_diag = make_prec(self.ops, data64, sc.precond)
            res = pcg(
                self.ops, data64, fext, x0, inv_diag,
                tol=sc.tol, max_iter=sc.max_iter,
                glob_n_dof_eff=glob_n_eff,
                max_stag_steps=sc.max_stag_steps,
                variant=sc.pcg_variant,
            )
        self.un = res.x + udi
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        out = StepResult(int(res.flag), float(res.relres), int(res.iters),
                         wall)
        self.flags.append(out.flag)
        self.relres.append(out.relres)
        self.iters.append(out.iters)
        self.step_times.append(wall)
        return out

    def solve(self, on_step: Optional[Callable[[int, StepResult], None]]
              = None) -> List[StepResult]:
        """Run the quasi-static schedule ``time_step_delta``, skipping
        step 0."""
        deltas = self.config.time_history.time_step_delta
        results = []
        for t in range(1, len(deltas)):
            res = self.step(deltas[t])
            results.append(res)
            if on_step is not None:
                on_step(t, res)
        return results

    def displacement_global(self) -> np.ndarray:
        """Full global solution vector (n_dof,), assembled on the host from
        the owner-weighted local rows."""
        pm = self.pm
        un = self.un.cpu().numpy()
        out = np.zeros(pm.glob_n_dof, dtype=un.dtype)
        m = (pm.weight > 0) & (pm.dof_gid >= 0)
        out[pm.dof_gid[m]] = un[m]
        return out

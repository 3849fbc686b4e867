"""Backend selection of the time-integration drivers.

Port of ``pcg_mpi_solver_tpu/solver/backends.py``: ``DynamicsSolver``
(explicit) and ``NewmarkSolver`` (implicit) run on the hybrid level-grid
backend for octree models with brick metadata and on the general backend
for everything else; the structured slab has no mass data.  The
quasi-static ``Solver`` adds the slab on top (``solver/driver.py``).

On the hybrid backend every refinement level's brick cells go through
the slab kernel, one launch a level (``parallel/hybrid.py::HybridOps``):
float32 matvecs through the kernel ``PCG_TPU_PALLAS_V`` selects, float64
ones through v6's double kernel.  On a CUDA tensor the kernel runs or the
run fails (the JAX package's ``hybrid_pallas_enabled`` probe has no
counterpart: there is no XLA path to fall back to).
"""

from __future__ import annotations

import os
import warnings

import torch

from pcg_mpi_solver_tpu_torch.models.model_data import ModelData
from pcg_mpi_solver_tpu_torch.ops.matvec import Ops, device_data
from pcg_mpi_solver_tpu_torch.parallel.hybrid import (
    HybridOps, can_hybrid, device_data_hybrid, partition_hybrid)
from pcg_mpi_solver_tpu_torch.parallel.partition import partition_model

TIME_BACKENDS = ("auto", "hybrid", "general")
HYBRID_GATE_NOTE = (
    "model is hybrid-backend eligible but auto-selection is gated (set "
    "PCG_TPU_ENABLE_HYBRID=1 or pass backend='hybrid'); using the general "
    "backend")


def select_time_backend(model: ModelData, n_parts: int, *,
                        partition_method: str, device: torch.device,
                        backend: str = "auto", kernel=None,
                        mg_degree: int = 2):
    """Resolve ``backend`` ("auto" | "hybrid" | "general") for ``model``:
    auto takes the general backend unless ``PCG_TPU_ENABLE_HYBRID=1``
    (and warns when the model could run on the hybrid one).

    ``kernel`` is ``dict(variant=, planes=)``, the float32 slab kernel of
    the hybrid level batches (``selected_variant``, ``pallas_planes``).
    Returns ``(name, pm, mk_ops, mk_data)``: ``mk_ops(dot_dtype)`` builds
    the operator, ``mk_data(dtype)`` uploads the device tree to
    ``device``."""
    if backend not in TIME_BACKENDS:
        raise ValueError(f"backend must be 'auto'|'hybrid'|'general', "
                         f"got {backend!r}")
    if backend == "hybrid" and not can_hybrid(model):
        raise ValueError("hybrid backend requested but model has no "
                         "octree/brick metadata")
    if backend == "auto" and can_hybrid(model) \
            and os.environ.get("PCG_TPU_ENABLE_HYBRID") != "1":
        warnings.warn(HYBRID_GATE_NOTE)
        backend = "general"
    if backend in ("auto", "hybrid") and can_hybrid(model):
        pm = partition_hybrid(model, n_parts, method=partition_method)

        def mk_ops(dd):
            return HybridOps.from_hybrid(pm, dot_dtype=dd,
                                         mg_degree=mg_degree,
                                         **(kernel or {}))

        return ("hybrid", pm, mk_ops,
                lambda dt: device_data_hybrid(pm, dt, device))
    pm = partition_model(model, n_parts, method=partition_method)
    return ("general", pm,
            lambda dd: Ops.from_model(pm, dot_dtype=dd, mg_degree=mg_degree),
            lambda dt: device_data(pm, dt, device))

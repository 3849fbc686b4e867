"""Analytic per-iteration cost model: a roofline prediction of every
ms/iter, phase by phase, before the solve runs.

Port of ``pcg_mpi_solver_tpu/obs/perf.py``.  For a ``(pcg_variant,
precond, nrhs, backend)`` combination the model counts FLOPs, memory
bytes and collectives for the four phases of one PCG iteration —
``matvec`` / ``precond`` / ``reduction`` / ``axpy`` — from the tables
below, and converts them to predicted ms/iter through a hardware
profile (:data:`HW_PROFILES`).  An unknown variant or preconditioner is
a loud ``KeyError``, never a silent default row.

The model is emitted as a ``cost_model`` telemetry event and ``perf.*``
gauges when a ``Solver`` is built, and ``perf-report`` sets it beside
the measured phases of ``obs/phases.py``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple

from pcg_mpi_solver_tpu_torch.config import PCG_VARIANTS, PRECONDS

#: the four attribution phases of one PCG iteration — the rows of the
#: measured-vs-model table (obs/phases.py measures the same four).
PHASES = ("matvec", "precond", "reduction", "axpy")

#: reduced scalars per iteration (rho, the p.Ap denominator, ||r||, the
#: two stagnation norms, the inf-prec flag) — every variant reduces the
#: same six, the variants differ only in how many psums carry them.
REDUCED_SCALARS = 6

# The JAX package's operation tables (``ops/matvec.py:68-140``,
# ``parallel/structured.py:208``), which its model reads, copied here:
# scalar psums an iteration of each loop body (classic's three
# reductions, the recurrence variants' one), full-length vector updates
# an iteration (classic p, x, r; fused p, q, x, r; pipelined p, s, q, z,
# x, r, u, w: solver/pcg.py's trips), the mg V-cycle's assembled matvecs
# and restriction psum an apply, and one halo exchange's ppermutes.
PCG_SCALAR_PSUMS = {"classic": 3, "fused": 1, "pipelined": 1}
PCG_VECTOR_AXPYS = {"classic": 3, "fused": 4, "pipelined": 8}
MG_RESTRICT_PSUMS = 1
PRECOND_CYCLE_MATVECS = {"jacobi": 0, "block3": 0}
STENCIL_HALO_PPERMUTES = 2
if tuple(PCG_SCALAR_PSUMS) != PCG_VARIANTS \
        or tuple(PCG_VECTOR_AXPYS) != PCG_VARIANTS:
    raise ImportError("the cost tables' variants must be "
                      f"config.PCG_VARIANTS {PCG_VARIANTS}")


def precond_cycle_cost(precond: str, mg_degree: int = 2):
    """(extra assembled matvecs, extra standalone psums) a preconditioner
    apply.  Unknown precond = loud KeyError."""
    if precond == "mg":
        return 2 * int(mg_degree), MG_RESTRICT_PSUMS
    return PRECOND_CYCLE_MATVECS[precond], 0


@dataclasses.dataclass(frozen=True)
class ProblemShape:
    """The pure-python geometry the cost model consumes — derivable from
    a live Solver (:func:`shape_from_solver`) or constructed synthetically
    (tests)."""

    n_dof: int                       # global effective-ish dof count
    n_parts: int = 1
    n_iface: int = 0                 # global interface dof count (psum payload)
    #: per pattern-type group: (element dof count d, total element count)
    elem_groups: Tuple[Tuple[int, int], ...] = ()
    backend: str = "general"         # general | structured | hybrid
    itemsize: int = 8                # iteration storage dtype bytes
    dot_itemsize: int = 8            # reduction accumulation dtype bytes
    mg_degree: int = 2
    mg_coarse_dofs: int = 0

    def matvec_flops(self) -> float:
        """One assembled matvec, nrhs=1: the per-type dense
        ``Ke @ (ck*u)`` einsums (2*d*d*N each).  Structured/hybrid
        backends report an equivalent-stencil group."""
        if self.elem_groups:
            return float(sum(2.0 * d * d * n for d, n in self.elem_groups))
        # fallback: brick elasticity, ~1 element per 3 dofs, d=24
        return 2.0 * 24 * 24 * (self.n_dof / 3.0)

    def matvec_bytes(self) -> float:
        """One assembled matvec, nrhs=1: element gather + scatter traffic
        (d values in, d values out per element) plus the in/out nodal
        vectors."""
        if self.elem_groups:
            elem = sum(2.0 * d * n for d, n in self.elem_groups)
        else:
            elem = 2.0 * 24 * (self.n_dof / 3.0)
        return (elem + 2.0 * self.n_dof) * self.itemsize


@dataclasses.dataclass(frozen=True)
class PhaseCost:
    """Resource cost of one phase of one iteration (already nrhs-wide)."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_count: int = 0
    coll_bytes: float = 0.0

    def to_dict(self) -> dict:
        return {"flops": round(self.flops, 1),
                "hbm_bytes": round(self.hbm_bytes, 1),
                "coll_count": int(self.coll_count),
                "coll_bytes": round(self.coll_bytes, 1)}


@dataclasses.dataclass(frozen=True)
class HwProfile:
    """Roofline constants of the execution platform, overridable a run
    through PCG_TPU_ROOFLINE_{FLOPS,HBM_GBS,ICI_GBS,COLL_LAT_US}."""

    name: str
    flops_per_s: float
    hbm_bytes_per_s: float
    ici_bytes_per_s: float
    coll_latency_s: float


#: baked-in profiles.  "cuda": NVIDIA's data-sheet rates of the H100 SXM
#: (dense, at its full 700 W power limit; the card the port is measured
#: on reports "NVIDIA H100 80GB HBM3, 700.00 W" through nvidia-smi):
#: 67 TFLOP/s float32 on the CUDA cores, 3.35 TB/s HBM3, 900 GB/s NVLink;
#: the data sheet gives no collective latency, and the port on one card
#: runs no collective, so none is charged.  "cpu" is the JAX package's,
#: so both packages predict the same on the CPU.
HW_PROFILES: Dict[str, HwProfile] = {
    "cuda": HwProfile("cuda", flops_per_s=67e12, hbm_bytes_per_s=3.35e12,
                      ici_bytes_per_s=9.0e11, coll_latency_s=0.0),
    "cpu": HwProfile("cpu", flops_per_s=6.0e9, hbm_bytes_per_s=1.5e10,
                     ici_bytes_per_s=1.5e10, coll_latency_s=2e-6),
}


def resolve_profile(platform: str) -> HwProfile:
    """The HwProfile of a platform string ("cpu", "cuda", a card's name
    — anything not starting with "cpu" is the card), with the
    PCG_TPU_ROOFLINE_* overrides applied."""
    key = "cpu" if str(platform).lower().startswith("cpu") else "cuda"
    p = HW_PROFILES[key]

    def env(name, default, scale=1.0):
        raw = os.environ.get(name)
        return default if raw is None else float(raw) * scale

    return HwProfile(
        name=p.name,
        flops_per_s=env("PCG_TPU_ROOFLINE_FLOPS", p.flops_per_s),
        hbm_bytes_per_s=env("PCG_TPU_ROOFLINE_HBM_GBS",
                            p.hbm_bytes_per_s, 1e9),
        ici_bytes_per_s=env("PCG_TPU_ROOFLINE_ICI_GBS",
                            p.ici_bytes_per_s, 1e9),
        coll_latency_s=env("PCG_TPU_ROOFLINE_COLL_LAT_US",
                           p.coll_latency_s, 1e-6),
    )


def _iface_collective(shape: ProblemShape, nrhs: int) -> Tuple[int, float]:
    """(count, payload bytes) of ONE assembled matvec's cross-part
    collective: the interface psum (general/hybrid) or the
    STENCIL_HALO_PPERMUTES halo exchange (structured)."""
    if shape.n_parts <= 1:
        return 0, 0.0
    if shape.backend == "structured":
        # halo payload: one boundary plane each way ~ n_dof^(2/3) rows
        plane = max(1.0, float(shape.n_dof) ** (2.0 / 3.0))
        return STENCIL_HALO_PPERMUTES, (STENCIL_HALO_PPERMUTES * plane
                                        * shape.itemsize * nrhs)
    if shape.n_iface <= 0:
        return 0, 0.0
    return 1, float(shape.n_iface) * shape.itemsize * nrhs


def phase_costs(shape: ProblemShape, variant: str, precond: str,
                nrhs: int = 1) -> Dict[str, PhaseCost]:
    """The per-phase resource model of ONE iteration of the
    ``(variant, precond)`` loop at block width ``nrhs``.

    Derived from the operation tables above — an unknown variant or
    preconditioner raises the same loud ``KeyError`` the tables
    themselves raise, never a silent default row."""
    R = max(1, int(nrhs))
    scalar_psums = PCG_SCALAR_PSUMS[variant]    # KeyError = the contract
    axpys = PCG_VECTOR_AXPYS[variant]
    mv_extra, ps_extra = precond_cycle_cost(precond, shape.mg_degree)

    mv_coll, mv_coll_bytes = _iface_collective(shape, R)
    matvec = PhaseCost(
        flops=shape.matvec_flops() * R,
        hbm_bytes=shape.matvec_bytes() * R,
        coll_count=mv_coll, coll_bytes=mv_coll_bytes)

    # -- preconditioner apply ------------------------------------------
    n = float(shape.n_dof)
    if precond == "jacobi":
        prec = PhaseCost(flops=n * R,
                         hbm_bytes=3.0 * n * shape.itemsize * R)
    elif precond == "block3":
        # batched (n/3) 3x3 block multiplies: 2*9 flops per node, block
        # operand ~3x the vector traffic
        prec = PhaseCost(flops=6.0 * n * R,
                         hbm_bytes=6.0 * n * shape.itemsize * R)
    elif precond == "mg":
        # 2*degree assembled FINE matvecs (each with its own interface
        # collective) + the replicated coarse cycle (geometric series of
        # 8x-coarser levels ~ 1/7 of one fine sweep, collective-free) +
        # the one restriction psum into the replicated coarse vector.
        fine = PhaseCost(flops=shape.matvec_flops() * R,
                         hbm_bytes=shape.matvec_bytes() * R)
        coarse_factor = 1.0 / 7.0
        smooth_bytes = (2 * shape.mg_degree + 2) * 3.0 * n \
            * shape.itemsize * R
        prec = PhaseCost(
            flops=fine.flops * mv_extra * (1.0 + coarse_factor),
            hbm_bytes=(fine.hbm_bytes * mv_extra * (1.0 + coarse_factor)
                       + smooth_bytes),
            coll_count=mv_coll * mv_extra
            + (ps_extra if shape.n_parts > 1 else 0),
            coll_bytes=mv_coll_bytes * mv_extra
            + (float(shape.mg_coarse_dofs) * shape.itemsize * R
               if shape.n_parts > 1 else 0.0))
    else:
        # same loudness as the source tables: a precond no table row
        # covers must never silently model as free
        raise KeyError(precond)

    reduction = PhaseCost(
        flops=2.0 * n * REDUCED_SCALARS * R,
        hbm_bytes=REDUCED_SCALARS * n * shape.itemsize * R,
        coll_count=scalar_psums if shape.n_parts > 1 else 0,
        # the SAME six scalars cross the wire whether one fused psum or
        # classic's three carry them — the variants differ in coll_count
        # (latency), not payload
        coll_bytes=(REDUCED_SCALARS * shape.dot_itemsize * R
                    if shape.n_parts > 1 else 0.0))

    axpy = PhaseCost(
        flops=2.0 * n * axpys * R,
        hbm_bytes=3.0 * n * shape.itemsize * axpys * R)

    return {"matvec": matvec, "precond": prec,
            "reduction": reduction, "axpy": axpy}


def predict_phase_ms(cost: PhaseCost, profile: HwProfile) -> float:
    """Roofline time of one phase: max(compute, HBM) + collective
    latency + collective payload wire time, in milliseconds."""
    t = max(cost.flops / profile.flops_per_s,
            cost.hbm_bytes / profile.hbm_bytes_per_s)
    t += cost.coll_count * profile.coll_latency_s
    t += cost.coll_bytes / profile.ici_bytes_per_s
    return t * 1e3


def cost_model(shape: ProblemShape, variant: str, precond: str,
               nrhs: int = 1,
               profile: Optional[HwProfile] = None) -> Dict[str, Any]:
    """The full model of one combination: per-phase resources + per-phase
    predicted ms + their total — the payload of the ``cost_model``
    telemetry event and the model column of ``perf-report``."""
    profile = profile or resolve_profile("cpu")
    costs = phase_costs(shape, variant, precond, nrhs)
    phases = {}
    total = 0.0
    for ph in PHASES:
        ms = predict_phase_ms(costs[ph], profile)
        total += ms
        d = costs[ph].to_dict()
        d["model_ms"] = round(ms, 6)
        phases[ph] = d
    return {
        "pcg_variant": variant,
        "precond": precond,
        "nrhs": int(nrhs),
        "backend": shape.backend,
        "n_dof": int(shape.n_dof),
        "n_parts": int(shape.n_parts),
        "profile": profile.name,
        "phases": phases,
        "predicted_ms_per_iter": round(total, 6),
    }


def cost_model_table(shape: ProblemShape, nrhs_set=(1, 8),
                     profile: Optional[HwProfile] = None,
                     variants=PCG_VARIANTS,
                     preconds=PRECONDS) -> Dict[tuple, Dict[str, Any]]:
    """Models for EVERY ``variant x precond x nrhs`` combination of the
    canonical name tables."""
    return {(v, p, int(r)): cost_model(shape, v, p, r, profile)
            for v in variants for p in preconds for r in nrhs_set}


def shape_from_detail(detail) -> Optional[ProblemShape]:
    """The cost-model geometry from a ``detail``-shaped dict (a profile
    capture's sidecar): self-describing without a live solver in hand.
    None when the dict carries no dof count."""
    n_dof = int(detail.get("n_dof", 0) or 0)
    if n_dof <= 0:
        return None
    mode = str(detail.get("mode", "direct"))
    dtype = str(detail.get("dtype", "float64"))
    return ProblemShape(
        n_dof=n_dof,
        n_parts=int(detail.get("n_parts", 1) or 1),
        # interface payload estimate: one boundary plane ~ n_dof^(2/3)
        # rows — the same heuristic _iface_collective's structured-halo
        # payload model uses (the general iface psum is comparable)
        n_iface=int(max(0.0, float(n_dof) ** (2.0 / 3.0))),
        backend=str(detail.get("backend", "general")),
        itemsize=4 if (mode == "mixed" or dtype == "float32") else 8,
        dot_itemsize=8)


def shape_from_solver(solver) -> ProblemShape:
    """Derive the cost-model geometry from a live Solver (any backend).
    Reads only host-side partition metadata — no device traffic."""
    from pcg_mpi_solver_tpu_torch.ops.mg import coarse_dofs

    pm = solver.pm
    scfg = solver.config.solver
    mixed = getattr(solver, "mixed", False)
    itemsize = 4 if (mixed or str(scfg.dtype) == "float32") else 8
    dot_itemsize = 4 if str(scfg.dot_dtype) == "float32" else 8
    groups = []
    for tb in getattr(pm, "type_blocks", None) or ():
        d = int(getattr(tb, "d", 0) or 0)
        node = getattr(tb, "node", None)
        if d and node is not None and getattr(node, "ndim", 0) >= 2:
            # (P, nn, N): total element slots across parts (padding
            # included — it is computed and moved like real elements)
            n_elem = int(node.shape[0]) * int(node.shape[-1])
        elif d:
            n_elem = int(getattr(pm, "glob_n_dof", 0)) // max(1, d // 8)
        else:
            continue
        if d and n_elem:
            groups.append((d, n_elem))
    ops = solver.ops
    return ProblemShape(
        n_dof=int(pm.glob_n_dof),
        n_parts=int(pm.n_parts),
        n_iface=int(getattr(ops, "n_iface", getattr(pm, "n_iface", 0))
                    or 0),
        elem_groups=tuple(groups),
        backend=str(solver.backend),
        itemsize=itemsize,
        dot_itemsize=dot_itemsize,
        mg_degree=int(getattr(ops, "mg_degree", scfg.mg_smooth_degree)),
        # the JAX package pins the first coarse level's length on its ops
        mg_coarse_dofs=(coarse_dofs(solver.mg_setup.meta)
                        if getattr(solver, "mg_setup", None) else 0),
    )


def emit_cost_model(recorder, model: Dict[str, Any]) -> None:
    """Emit one model as the schema-versioned ``cost_model`` event plus
    the ``perf.*`` gauges the run_summary snapshot carries."""
    recorder.event("cost_model", **model)
    recorder.gauge("perf.predicted_ms_per_iter",
                   model["predicted_ms_per_iter"])
    recorder.gauge("perf.model_profile", model["profile"])
    for ph in PHASES:
        recorder.gauge(f"perf.model.{ph}_ms",
                       model["phases"][ph]["model_ms"])

"""Phase-attribution probes: MEASURE where each ms/iter goes.

Port of ``pcg_mpi_solver_tpu/obs/phases.py``.  The analytic cost model
(``obs/perf.py``) predicts per-phase ms/iter; this module times the same
four phases — ``matvec`` / ``precond`` / ``reduction`` / ``axpy`` — on
the live solver's own operator and data, each alone, ``inner``
applications in a row: on the card between two CUDA events, on the CPU
on the host clock.  The reduction phase carries the variant's reduction
set (``PCG_SCALAR_PSUMS``: classic's three, the recurrence variants'
one) and the trip's one host read of its scalars; the axpy phase the
variant's ``PCG_VECTOR_AXPYS`` vector updates.  The whole-iteration
anchor is a real solve: a step divided by its iterations.  Best of
``reps`` interleaved rounds (host jitter only ever adds).

A mixed-precision solver is probed on its float32 inner operator, the
loop its iterations run (the JAX package probes direct solvers only).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict

import torch

from pcg_mpi_solver_tpu_torch.obs.perf import (
    PCG_SCALAR_PSUMS, PCG_VECTOR_AXPYS, PHASES)

#: applications per timed phase (amortizes the host's launch overhead)
DEFAULT_INNER = 16


class PhaseProbe:
    """Timing of the four phases on a live Solver; the programs are the
    solver's own ops, run on its data."""

    def __init__(self, solver, nrhs: int = 1, inner: int = DEFAULT_INNER):
        self.solver = solver
        self.nrhs = max(1, int(nrhs))
        self.inner = max(1, int(inner))
        mixed = getattr(solver, "mixed", False)
        self.ops = solver.ops32 if mixed else solver.ops
        self.base = solver.data32 if mixed else solver.data
        self.data = (self.ops.block_data(self.base, self.nrhs)
                     if self.nrhs > 1 else self.base)
        self._progs = None

    def _build(self) -> Dict[str, Callable[[], Any]]:
        from pcg_mpi_solver_tpu_torch.solver.pcg import _read

        ops, data = self.ops, self.data
        scfg = self.solver.config.solver
        n_psums = PCG_SCALAR_PSUMS[scfg.pcg_variant]   # KeyError = contract
        n_axpys = PCG_VECTOR_AXPYS[scfg.pcg_variant]
        # the solver's own operand (float32 in mixed), shared by columns
        prec = self.solver._make_prec(scfg.precond)
        # a bounded, fully populated operand: |F| + eff, normalised
        x = self.base["F"].abs() + self.base["eff"] + 1e-3
        x = x / x.max()
        if self.nrhs > 1:
            x = x.unsqueeze(0).expand(self.nrhs, *x.shape).contiguous()
        w = data["weight"] * data["eff"]
        z, p, q = x * 0.5, x * 2.0, x * 0.25
        many = self.nrhs > 1
        one_dot = ops.wdot_many if many else ops.wdot
        dots = ops.wdots_many if many else ops.wdots
        zero = torch.zeros((self.nrhs,) if many else (),
                           dtype=ops.dot_dtype, device=x.device)

        def reduction():
            if n_psums >= 3:        # classic: three reductions
                red = [one_dot(w, x, z), one_dot(w, p, q),
                       dots(w, [(p, p), (x, x), (z, z)], extra=[zero])]
            else:                   # fused / pipelined: one
                red = [dots(w, [(x, z), (z, q), (x, x), (p, p), (q, q)],
                            extra=[zero])]
            return _read(*red)      # the trip's one host read

        bufs = [x.clone(), z.clone(), q.clone()]

        def axpy():
            for k in range(n_axpys):
                dst, src = k % 3, (k + 1) % 3
                bufs[dst] = bufs[src] + 0.5 * bufs[dst]

        return {"matvec": lambda: ops.matvec(data, x),
                "precond": lambda: ops.apply_prec(prec, x, data),
                "reduction": reduction,
                "axpy": axpy}

    def _time(self, fn) -> float:
        """Seconds of one application, over ``inner`` in a row."""
        dev = self.solver.device
        if dev.type == "cuda":
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(self.inner):
                fn()
            t1.record()
            t1.synchronize()
            return t0.elapsed_time(t1) / 1e3 / self.inner
        t0 = time.perf_counter()
        for _ in range(self.inner):
            fn()
        return (time.perf_counter() - t0) / self.inner

    def warm(self) -> None:
        """Build the operands and run every phase once."""
        if self._progs is None:
            self._progs = self._build()
        for ph in PHASES:
            self._progs[ph]()
        if self.solver.device.type == "cuda":
            torch.cuda.synchronize(self.solver.device)

    def measure_phases_once(self) -> Dict[str, float]:
        """One timed round: per-phase seconds an iteration-equivalent
        (one matvec, one preconditioner apply, the variant's reductions
        and its host read, the variant's vector updates)."""
        return {ph: self._time(self._progs[ph]) for ph in PHASES}

    def measure_whole_once(self) -> Dict[str, float]:
        """One whole-iteration anchor from a real solve: a step (or a
        block of F repeated at ``nrhs`` > 1), wall over iterations; the
        solver's state is reset after it."""
        s = self.solver
        if self.nrhs > 1:
            import numpy as np

            F = np.repeat(np.asarray(s._model.F)[:, None], self.nrhs,
                          axis=1)
            res = s.solve_many(F)
            iters = int(max(1, int(res.iters.max(initial=1))))
            wall = float(res.solve_wall_s)
        else:
            r = s.step(1.0)
            s.reset_state()
            iters = max(1, int(r.iters))
            wall = float(r.wall_s)
        return {"wall_s": wall, "iters": iters, "s_per_iter": wall / iters}

    def measure(self, reps: int = 3, whole: bool = False) -> Dict[str, Any]:
        """``reps`` interleaved rounds; the per-phase minima, and with
        ``whole=True`` the best anchor under ``"whole"`` and the median of
        the rounds' sum/whole ratios under ``"attribution"`` (each
        round's two sides taken in the same second of machine
        weather)."""
        self.warm()
        if whole:
            self.measure_whole_once()
        best: Dict[str, float] = {}
        best_whole = None
        ratios = []
        for _ in range(max(1, reps)):
            round_a = self.measure_phases_once()
            for ph, v in round_a.items():
                best[ph] = min(best.get(ph, float("inf")), v)
            if whole:
                w = self.measure_whole_once()
                if best_whole is None or \
                        w["s_per_iter"] < best_whole["s_per_iter"]:
                    best_whole = w
                round_b = self.measure_phases_once()
                for ph, v in round_b.items():
                    best[ph] = min(best[ph], v)
                if w["s_per_iter"] > 0:
                    ratios.append(0.5 * (sum(round_a.values())
                                         + sum(round_b.values()))
                                  / w["s_per_iter"])
        out: Dict[str, Any] = dict(best)
        if whole:
            out["whole"] = best_whole
            ratios.sort()
            m = len(ratios) // 2
            out["attribution"] = ((ratios[m] if len(ratios) % 2 else
                                   0.5 * (ratios[m - 1] + ratios[m]))
                                  if ratios else None)
        return out


def run_phase_probe(solver, recorder=None, reps: int = 3, nrhs: int = 1,
                    inner: int = DEFAULT_INNER,
                    whole: bool = True) -> Dict[str, Any]:
    """Measure the phases (and the whole-iteration anchor) on a live
    solver, emit the ``phase_probe`` event and ``perf.measured.*``
    gauges, and return the payload: per-phase ms, their sum, the
    whole-iteration ms and the sum/whole attribution ratio."""
    probe = PhaseProbe(solver, nrhs=nrhs, inner=inner)
    measured = probe.measure(reps=reps, whole=whole)
    w = measured.pop("whole", None)
    attribution = measured.pop("attribution", None)
    phases_ms = {ph: round(v * 1e3, 6) for ph, v in measured.items()}
    total_ms = round(sum(phases_ms.values()), 6)
    payload: Dict[str, Any] = {
        "pcg_variant": solver.config.solver.pcg_variant,
        "precond": solver.config.solver.precond,
        "nrhs": int(nrhs),
        "backend": solver.backend,
        "inner": int(inner),
        "device": solver.device.type,
        "phases": phases_ms,
        "sum_ms_per_iter": total_ms,
        "whole_ms_per_iter": None,
        "attribution": None,
    }
    if w is not None:
        payload["whole_ms_per_iter"] = round(w["s_per_iter"] * 1e3, 6)
        payload["whole_iters"] = w["iters"]
        if attribution is not None:
            payload["attribution"] = round(attribution, 4)
    rec = recorder if recorder is not None else getattr(
        solver, "recorder", None)
    if rec is not None:
        rec.event("phase_probe", **payload)
        for ph, v in phases_ms.items():
            rec.gauge(f"perf.measured.{ph}_ms", v)
        if payload["whole_ms_per_iter"] is not None:
            rec.gauge("perf.measured.whole_ms", payload["whole_ms_per_iter"])
    return payload

"""Convergence tracing: a fixed-size ring of per-iteration ``normr`` /
``rho`` / ``stag`` / ``flag`` records.

Port of ``pcg_mpi_solver_tpu/obs/trace.py``.  The JAX package's ring
lives in the ``lax.while_loop`` carry on the device, four dynamic-index
stores a committed iteration, because its loop runs there.  The port's
loop is driven from the host, which already holds every recorded value
as a host scalar of the trip's one read and knows each record's slot, so
the ring is a host (length, 4) float64 array and a record is one row
write: no device work, no device-to-host read, no synchronisation.

When a solve runs longer than the ring, the oldest records are
overwritten and :func:`unpack_trace` returns the last ``length`` in
order, flagged ``truncated``.  ``normr`` and ``rho`` unpack in the
ring's dtype (the solve's dot dtype; float32 for mixed inner cycles,
whose records are rescaled to absolute residuals by ``scale``), so the
values are the JAX ring's: float64 holds every float32 exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

TRACE_FIELDS = ("normr", "rho", "stag", "flag")

_NP = {torch.float32: np.float32, torch.float64: np.float64}


def clamp_trace_len(length: int, max_iter: int) -> int:
    """Ring sizes are clamped to [1, max_iter]: a ring longer than the
    iteration budget only wastes memory, and zero or negative lengths are
    the caller's 'off' (callers gate on > 0 before :func:`trace_init`)."""
    return max(1, min(int(length), max(int(max_iter), 1)))


class TraceRing:
    """The ring: ``rows`` (length, 4) float64 host rows of (normr, rho,
    stag, flag), ``n`` the records written (the slot of record k is
    k mod length), ``dtype`` the float dtype ``normr`` and ``rho``
    unpack in."""

    def __init__(self, length: int, dtype: torch.dtype = torch.float32):
        self.dtype = dtype
        self.rows = np.zeros((max(1, int(length)), 4), np.float64)
        self.n = 0

    @property
    def length(self) -> int:
        return int(self.rows.shape[0])

    def record(self, normr, rho, stag, flag, scale=None) -> None:
        """Append one record.  ``scale`` rescales ``normr`` (a mixed inner
        cycle iterates on r / ||r||; scale = ||r|| gives the absolute
        residual), the product taken in float64 as the JAX package takes
        it before its cast to the ring's dtype."""
        v = np.float64(normr)
        if scale is not None:
            v = v * np.float64(scale)
        self.rows[self.n % self.length] = (v, np.float64(rho), stag, flag)
        self.n += 1

    def state(self) -> dict:
        """The ring in a snapshot state tree."""
        return {"buf": self.rows.copy(), "n": np.int64(self.n)}

    def load_state(self, st: dict) -> None:
        """Restore :meth:`state`'s tree."""
        self.rows[...] = np.asarray(st["buf"], np.float64)
        self.n = int(np.asarray(st["n"]))


def trace_init(length: int, dtype: torch.dtype = torch.float32
               ) -> TraceRing:
    """An empty ring.  ``dtype`` is the float dtype of normr/rho: the
    solve's dot dtype, float32 for mixed inner iterations."""
    return TraceRing(length, dtype)


def trace_record(tr: TraceRing, *, normr, rho, stag, flag,
                 scale=None) -> TraceRing:
    """Append one record to ``tr`` in place (one slot a committed
    iteration); returns ``tr``."""
    tr.record(normr, rho, stag, flag, scale)
    return tr


class ConvergenceTrace(NamedTuple):
    """Host-side unpacked trace, oldest -> newest."""

    normr: np.ndarray          # per-iteration residual norm (absolute)
    rho: np.ndarray            # per-iteration z.r inner product
    stag: np.ndarray           # stagnation counter
    flag: np.ndarray           # flag decided AT that iteration (1 = running)
    n_recorded: int            # total iterations recorded (>= len(normr)
    #                            when the ring wrapped)
    truncated: bool            # True when older entries were overwritten

    def to_event_fields(self, step: int) -> dict:
        """The ``resid_trace`` telemetry event payload for this trace."""
        return dict(step=step, n_recorded=int(self.n_recorded),
                    truncated=bool(self.truncated),
                    normr=[float(v) for v in self.normr],
                    rho=[float(v) for v in self.rho],
                    stag=[int(v) for v in self.stag],
                    flag=[int(v) for v in self.flag])


def empty_trace() -> ConvergenceTrace:
    z = np.zeros((0,))
    zi = np.zeros((0,), np.int32)
    return ConvergenceTrace(z, z.copy(), zi, zi.copy(), 0, False)


def unpack_trace(tr: TraceRing) -> ConvergenceTrace:
    """Ring -> ordered :class:`ConvergenceTrace`."""
    rows = tr.rows
    n, length = tr.n, rows.shape[0]
    sel = np.arange(n) if n <= length else (np.arange(length) + n) % length
    f = _NP[tr.dtype]
    return ConvergenceTrace(
        normr=rows[sel, 0].astype(f), rho=rows[sel, 1].astype(f),
        stag=rows[sel, 2].astype(np.int32),
        flag=rows[sel, 3].astype(np.int32),
        n_recorded=n, truncated=n > length)

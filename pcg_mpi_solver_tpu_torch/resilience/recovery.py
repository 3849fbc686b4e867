"""Recovery policy: dispatch guard, breakdown ladder, and the per-step
resilience context threaded through the chunked budget loop.

Port of ``pcg_mpi_solver_tpu/resilience/recovery.py:41-325``.  One
failure taxonomy, three handlers:

* **Device loss** (``is_device_loss``: an injected ``exc`` fault, or an
  exception the JAX package classifies so by name or message): the
  :class:`DispatchGuard` retries the dispatch with backoff from the last
  mid-solve snapshot.  Without a snapshot (or with the retry budget
  spent) the exception reaches the ladder, which restarts the step from
  its start state (trigger ``device_loss``).  A CUDA error is NOT in the
  set: a sticky CUDA error, an ``nvcc`` build failure or a launch error
  propagates, and a new process with ``solve(resume=True)`` is what
  continues after one.
* **Breakdown** (flags 2, 4, 6) and **NaN/Inf carry**: the driver-level
  :class:`RecoveryLadder` restarts from the tracked min-residual iterate
  through a bounded escalation (plain restart -> scalar-Jacobi fallback
  preconditioner -> f64 escalation in mixed mode), each attempt a
  ``recovery`` event.
* **Process death** (``kill`` faults, a real kill): nothing in-process;
  the next run's ``solve(resume=True)`` restores the last snapshot.
"""

from __future__ import annotations

import math
import os
import time
import warnings
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from pcg_mpi_solver_tpu_torch.ops.precond import fallback_kind
from pcg_mpi_solver_tpu_torch.resilience.faultinject import (
    FaultPlan, InjectedDispatchError)

# exception type names and message markers that mean the device (not the
# math) failed, as the JAX package lists them
_DEVICE_ERROR_NAMES = frozenset({
    "XlaRuntimeError", "JaxRuntimeError", "InternalError",
    "UnavailableError", "FailedPreconditionError", "AbortedError",
})
_DEVICE_ERROR_MARKERS = ("UNAVAILABLE", "DEADLINE_EXCEEDED", "INTERNAL:",
                         "ABORTED", "device loss", "Device loss")


def is_device_loss(exc: BaseException) -> bool:
    """Does this exception mean the device/dispatch died (retryable),
    rather than the computation being wrong (not retryable)?"""
    if isinstance(exc, InjectedDispatchError):
        return True
    if type(exc).__name__ in _DEVICE_ERROR_NAMES:
        return True
    msg = str(exc)
    return any(m in msg for m in _DEVICE_ERROR_MARKERS)


def breakdown_trigger(flag: int, relres: float) -> Optional[str]:
    """Classify a terminal chunked-solve outcome into a ladder trigger
    (None = no recovery warranted: converged, budget, or stagnation)."""
    from pcg_mpi_solver_tpu_torch.solver.pcg import BREAKDOWN_FLAGS

    if not math.isfinite(relres):
        return "nan_carry"
    if flag in BREAKDOWN_FLAGS:
        return f"flag{flag}"
    return None


def column_trigger(flag: int, normr: float) -> Optional[str]:
    """Per-column ladder trigger of a blocked carry: a breakdown flag, or
    a still-running column (flag 1) whose norm is not finite."""
    from pcg_mpi_solver_tpu_torch.solver.pcg import BREAKDOWN_FLAGS

    if flag in BREAKDOWN_FLAGS:
        return f"flag{flag}"
    if flag == 1 and not math.isfinite(normr):
        return "nan_carry"
    return None


def retry_deadline_s() -> Optional[float]:
    """Optional wall clamp on retry storms (``PCG_TPU_RETRY_DEADLINE_S``
    seconds); a malformed value disables it with a warning."""
    raw = os.environ.get("PCG_TPU_RETRY_DEADLINE_S", "")
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        warnings.warn(f"PCG_TPU_RETRY_DEADLINE_S={raw!r} is not a "
                      "number; retry deadline disabled")
        return None


class DispatchGuard:
    """Retry-with-backoff + deadline budget for device dispatches.

    One instance per solve step: the retry budget is a per-step total,
    the deadline an absolute wall clamp.  Backoff is exponential from
    ``PCG_TPU_RETRY_BACKOFF_S`` (default 0.5 s)."""

    def __init__(self, retries: int = 2, deadline_s: Optional[float] = None,
                 recorder=None):
        self.retries = int(retries)
        self.failures = 0
        self.recorder = recorder
        self._deadline = (time.monotonic() + deadline_s
                          if deadline_s else None)
        self._backoff0 = float(os.environ.get("PCG_TPU_RETRY_BACKOFF_S",
                                              "0.5"))

    def should_retry(self, exc: BaseException) -> bool:
        """Account one dispatch failure; True when a retry is allowed
        (device-loss shaped, budget left, deadline not passed)."""
        if not is_device_loss(exc):
            return False
        self.failures += 1
        if self.failures > self.retries:
            return False
        if self._deadline is not None and time.monotonic() > self._deadline:
            return False
        return True

    def backoff(self) -> None:
        time.sleep(min(self._backoff0 * (2 ** (self.failures - 1)), 30.0))

    def redispatch(self, exc: BaseException) -> bool:
        """The guard's whole answer to a failed dispatch: False to
        propagate, else the ``recovery``/``redispatch`` event and count on
        the recorder, the backoff, and True (dispatch again)."""
        if not self.should_retry(exc):
            return False
        if self.recorder is not None:
            self.recorder.event(
                "recovery", action="redispatch", attempt=self.failures,
                trigger="device_loss", error=f"{type(exc).__name__}: {exc}")
            self.recorder.inc("resilience.recovery.redispatch")
        self.backoff()
        return True


class RecoveryLadder:
    """Bounded escalation ladder for breakdown/NaN/device-loss triggers:
    restart from the min-residual iterate -> the same restart under the
    scalar-Jacobi fallback preconditioner (when the configured one is
    stronger, ``ops/precond.fallback_kind``) -> f64 escalation (mixed
    mode).  Attempts past the last applicable rung repeat it;
    ``max_recoveries`` bounds the total."""

    def __init__(self, *, precond: str, mixed: bool, max_recoveries: int,
                 recorder=None, extra: Optional[Dict[str, Any]] = None):
        self.max_recoveries = int(max_recoveries)
        self.attempt = 0
        self.recorder = recorder
        # fields stamped on every `recovery` event of this ladder
        self.extra = dict(extra or {})
        self.actions_taken: List[str] = []
        rungs = ["restart_minres"]
        if fallback_kind(precond) is not None:
            rungs.append("fallback_prec")
        if mixed:
            rungs.append("escalate_f64")
        self._rungs = rungs

    @property
    def exhausted(self) -> bool:
        return self.attempt >= self.max_recoveries

    def next_action(self, trigger: str) -> Optional[str]:
        """Consume one attempt; returns the rung (None when the budget is
        spent) and records the ``recovery`` event."""
        if self.exhausted:
            return None
        self.attempt += 1
        action = self._rungs[min(self.attempt - 1, len(self._rungs) - 1)]
        self.actions_taken.append(action)
        if self.recorder is not None:
            self.recorder.event("recovery", action=action,
                                attempt=self.attempt, trigger=trigger,
                                **self.extra)
            self.recorder.inc(f"resilience.recovery.{action}")
        return action


class ResilienceContext:
    """Everything the chunked budget loop needs per solve step: the
    mid-solve snapshot cadence (disk via ``utils/checkpoint.SnapshotStore``
    + the in-memory restore point the dispatch guard re-dispatches from),
    the guard itself, and the optional fault plan.

    ``fetch_state`` / ``put_state`` are driver-supplied closures mapping a
    device state dict to host numpy and back.  ``comm`` is the host
    collective group of a multi-process run: None in the port's one
    process (ROADMAP queue 1 item 12), so :meth:`sync_boundary` does
    nothing."""

    def __init__(self, *, store=None, step: int = 0, snapshot_every: int = 0,
                 fetch_state: Callable[[Any], Any] = None,
                 put_state: Callable[[Any], Any] = None,
                 guard: Optional[DispatchGuard] = None,
                 faults: Optional[FaultPlan] = None,
                 recorder=None, resume: bool = False,
                 ladder_armed: bool = False, comm=None):
        self.store = store
        self.step = int(step)
        self.snapshot_every = int(snapshot_every)
        self.fetch_state = fetch_state
        self.put_state = put_state
        self.guard = guard
        self.faults = faults
        self.recorder = recorder
        self.comm = comm
        # whether the driver will consume engine.restart_x: the engine
        # skips the per-cycle restart-iterate copy otherwise
        self.ladder_armed = bool(ladder_armed)
        self._allow_resume = bool(resume)
        self._mem: Optional[Dict[str, Any]] = None   # last good host state
        self._since_snapshot = 0

    def sync_boundary(self) -> None:
        """Chunk-boundary liveness probe of a multi-process run; nothing
        without a comm."""
        if self.comm is not None and getattr(self.comm, "n_procs", 1) > 1:
            self.comm.barrier("chunk_boundary")

    # -- snapshots ------------------------------------------------------
    def load_resume_state(self) -> Optional[Dict[str, Any]]:
        """The persisted mid-step state to resume from, or None.  Only
        honored when the caller asked for ``resume`` (a fresh solve must
        never continue a stale snapshot of an earlier run)."""
        if not (self._allow_resume and self.store is not None):
            return None
        self._allow_resume = False
        state = self.store.load(self.step)
        if state is None:
            return None
        self._mem = state           # also the guard's restore point
        if self.recorder is not None:
            self.recorder.event("snapshot", op="restore", step=self.step,
                                chunk=int(state.get("chunk", -1)))
        return state

    def after_chunk(self, state_fn: Callable[[], Dict[str, Any]]) -> None:
        """Chunk-boundary hook: every ``snapshot_every`` completed chunks,
        fetch the resumable state to the host (``state_fn`` builds it
        lazily: with snapshots off this costs nothing), keep it as the
        guard's restore point, and persist it atomically."""
        if self.snapshot_every <= 0:
            return
        self._since_snapshot += 1
        if self._since_snapshot < self.snapshot_every:
            return
        self._since_snapshot = 0
        state = state_fn()
        state = self.fetch_state(state) if self.fetch_state else state
        self._mem = state
        if self.store is not None:
            self.store.save(self.step, state)
            if self.recorder is not None:
                self.recorder.event("snapshot", op="save", step=self.step,
                                    chunk=int(state.get("chunk", -1)))

    def discard(self) -> None:
        """Drop the step's snapshot (the step completed)."""
        self._mem = None
        if self.store is not None:
            self.store.discard(self.step)

    # -- dispatch guard -------------------------------------------------
    def handle_dispatch_failure(self, exc: BaseException,
                                kind: Optional[str] = None) \
            -> Optional[Dict[str, Any]]:
        """Guard decision for a failed dispatch: the host state to
        re-dispatch from (after backoff), or None to propagate.  Needs
        BOTH a retry budget and an in-memory restore point; ``kind``
        (``"direct"``/``"mixed"``) rejects a restore point of the other
        schema (one from before an escalation) without using a retry."""
        if self.guard is None or self._mem is None:
            return None
        if kind is not None and str(
                np.asarray(self._mem.get("kind", ""))) != kind:
            return None
        if not self.guard.redispatch(exc):
            return None
        return self._mem

    def restore_device(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """Host snapshot state -> device state."""
        return self.put_state(state) if self.put_state else state

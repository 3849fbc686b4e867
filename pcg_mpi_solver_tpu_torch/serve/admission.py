"""Admission control and bounded-queue backpressure of the solve
service.

Port of ``pcg_mpi_solver_tpu/serve/admission.py``, with its pricing
formula and its named reasons.  Every admission is priced with the
analytic cost model (``obs/perf.py``): the solver's predicted ms/iter at
the service's widest standard block width times the expected iteration
count is the wall a job is predicted to take, judged against its
deadline; a job that cannot make it is rejected at the door with
``deadline_infeasible``.  A model that cannot price (``None``) admits:
pricing never gates a solve.  The port's cost model is the H100 data
sheet's roofline with no host time, so on the card it under-predicts a
served block's wall and admits jobs that may miss their deadlines;
``chip_smoke.py`` phase 4m prints each block's price beside its wall.

The queue is bounded (``queue_max``).  An arrival that finds it full
sheds the queued jobs already past their deadline first, oldest first
(a ``job_shed`` event, a journal record and a result file); when nothing
can be shed the arrival is rejected ``queue_full``.  Every decision emits
a schema-versioned event (``obs/schema.py``: ``job_admit``,
``job_reject``, ``job_shed``).

Imports neither torch nor numpy.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

#: The named rejection and shed reasons.
REJECT_DEADLINE = "deadline_infeasible"
REJECT_QUEUE_FULL = "queue_full"
REJECT_DRAINING = "draining"
SHED_PAST_DEADLINE = "past_deadline_backpressure"


def price_admission(predicted_ms_per_iter: Optional[float],
                    expected_iters: int) -> Optional[float]:
    """Predicted seconds to serve one block: the cost model's ms/iter
    times the expected iteration count.  None (no model) cannot reject:
    admission opens."""
    if predicted_ms_per_iter is None:
        return None
    return float(predicted_ms_per_iter) * max(1, int(expected_iters)) \
        / 1e3


class AdmissionController:
    """Bounded admission queue with cost-model pricing and shedding.

    ``pricer(nrhs) -> ms_per_iter | None`` is the cost model (the daemon
    passes ``Solver.predicted_ms_per_iter``); ``journal`` and ``recorder``
    take the durable record and the event of every decision.  The
    controller owns the ordinals (continuing the journal's numbering from
    ``ordinal0``) and the queue; the daemon owns dispatch.
    """

    def __init__(self, queue_max: int, *, pricer: Callable, journal,
                 recorder, expected_iters: int, price_width: int = 1,
                 ordinal0: int = 0,
                 on_shed: Optional[Callable] = None):
        self.queue_max = max(1, int(queue_max))
        self._pricer = pricer
        self._journal = journal
        self._rec = recorder
        self.expected_iters = max(1, int(expected_iters))
        self.price_width = max(1, int(price_width))
        self._next_ordinal = int(ordinal0)
        self._on_shed = on_shed      # the daemon's result file a shed job
        self.queue: List[Dict[str, Any]] = []
        self.depth_max = 0
        self.shed_count = 0
        self.draining = False

    def admit(self, spec: Dict[str, Any],
              now: Optional[float] = None) -> Tuple[str, Any]:
        """One decision on a validated spec: ``("admitted", entry)`` or
        ``("rejected", reason)``, each journaled and evented."""
        now = time.time() if now is None else now
        job = spec["job"]
        if self.draining:
            return self._reject(job, REJECT_DRAINING)
        deadline_s = float(spec.get("deadline_s", 0.0))
        predicted_s = price_admission(self._pricer(self.price_width),
                                      self.expected_iters)
        if predicted_s is not None and predicted_s > deadline_s:
            return self._reject(
                job, REJECT_DEADLINE,
                predicted_s=round(predicted_s, 6), deadline_s=deadline_s)
        if len(self.queue) >= self.queue_max:
            self.shed_past_deadline(now)
            if len(self.queue) >= self.queue_max:
                return self._reject(job, REJECT_QUEUE_FULL,
                                    queue_depth=len(self.queue))
        entry = {"job": job, "spec": dict(spec),
                 "ordinal": self._next_ordinal,
                 "deadline_t": now + deadline_s, "admit_t": now}
        self._next_ordinal += 1
        self.queue.append(entry)
        self.depth_max = max(self.depth_max, len(self.queue))
        self._journal.record("admitted", job, spec=entry["spec"],
                             ordinal=entry["ordinal"],
                             deadline_t=entry["deadline_t"])
        self._rec.event("job_admit", job=job, ordinal=entry["ordinal"],
                        predicted_s=predicted_s, deadline_s=deadline_s)
        return "admitted", entry

    def requeue(self, entry: Dict[str, Any]) -> None:
        """Journal replay: queue an already admitted job again with its
        original ordinal and deadline (no second ``admitted`` record, no
        second pricing)."""
        self.queue.append(dict(entry))
        self.queue.sort(key=lambda e: e["ordinal"])
        self.depth_max = max(self.depth_max, len(self.queue))
        self._next_ordinal = max(self._next_ordinal,
                                 int(entry["ordinal"]) + 1)

    def shed_past_deadline(self, now: Optional[float] = None
                           ) -> List[Dict[str, Any]]:
        """Backpressure: drop the queued jobs already past their deadline,
        oldest first, each with ``job_shed`` and a journal record (the
        daemon writes their result files).  Returns the shed entries."""
        now = time.time() if now is None else now
        keep, shed = [], []
        for e in sorted(self.queue, key=lambda e: e["ordinal"]):
            (shed if e["deadline_t"] < now else keep).append(e)
        if shed:
            self.queue = keep
            self.shed_count += len(shed)
            for e in shed:
                self._journal.record("shed", e["job"],
                                     reason=SHED_PAST_DEADLINE,
                                     ordinal=e["ordinal"])
                self._rec.event("job_shed", job=e["job"],
                                reason=SHED_PAST_DEADLINE)
                if self._on_shed is not None:
                    self._on_shed(e, SHED_PAST_DEADLINE)
        return shed

    def _reject(self, job: str, reason: str, **fields) -> Tuple[str, str]:
        self._journal.record("rejected", job, reason=reason, **fields)
        self._rec.event("job_reject", job=job, reason=reason, **fields)
        return "rejected", reason

"""Multi-process fault tolerance: deadline-guarded collectives and
group-consistent snapshot epochs.

Port of ``pcg_mpi_solver_tpu/resilience/distributed.py``.  Across
processes the dominant failure mode is "a process dies or wedges
mid-collective": every surviving peer blocks inside the next gloo round,
and per-process ``snap_*.npz`` files carry no cross-process consistency
guarantee — a crash between two ranks' writes leaves a torn, unresumable
mix.  This module supplies the two missing pieces (detect cheaply,
recover from the last consistent state, arXiv:2501.03743):

* :class:`GuardedComm` — a deadline watchdog around every host-side
  collective on the dispatch path (``PCG_TPU_COLLECTIVE_DEADLINE_S``).
  A wedged round becomes a named :class:`DeadPeerError` in bounded
  time, carrying the most heartbeat-silent peer rank read from the
  per-rank flight shards, plus a ``collective_timeout`` telemetry/flight
  event for post-mortem triage.
* :class:`GroupSnapshotStore` — a two-phase epoch protocol over the
  existing :class:`~pcg_mpi_solver_tpu_torch.utils.checkpoint.SnapshotStore`
  layout: every rank atomically writes its own
  ``<prefix>_e<E>.p<idx>.npz`` shard, an allreduce confirms all shards
  landed, and only then does rank 0 publish the ``COMMIT_e<E>`` marker.
  Readers resolve the newest *committed* epoch (group-agreed), so a
  crash mid-epoch falls back cleanly to epoch E-1, never a torn mix —
  and retention is routed through the commit markers so pruning can
  never split the group.  Because shards are written as axis-0 slices
  of the globally-fetched part arrays, a committed N-process epoch can
  be re-joined and restored onto M != N processes (elastic resume).

Import-light like the rest of ``resilience/``: torch and the obs readers
are imported lazily inside the functions that need them.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
import warnings
import glob as _glob
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from pcg_mpi_solver_tpu_torch.utils.checkpoint import (
    SnapshotStore, _flatten, _unflatten)
from pcg_mpi_solver_tpu_torch.utils.io import write_atomic

__all__ = ["DeadPeerError", "GuardedComm", "GroupSnapshotStore",
           "collective_deadline_s", "suspect_dead_rank"]


class DeadPeerError(RuntimeError):
    """A host-side collective got no reply within the configured
    deadline — some peer process is dead or wedged.

    Deliberately NOT device-loss shaped (the message avoids every
    ``resilience.recovery._DEVICE_ERROR_MARKERS`` substring and the
    type name is not in ``_DEVICE_ERROR_NAMES``): a dead peer does not
    come back on redispatch, so the dispatch guard must propagate this
    instead of burning its retry budget re-entering the same stuck
    round.  Recovery is a relaunch with ``--resume`` (same process
    count) or :meth:`Solver.resume_elastic` (fewer processes)."""


def collective_deadline_s() -> Optional[float]:
    """The host-collective watchdog deadline
    (``PCG_TPU_COLLECTIVE_DEADLINE_S`` seconds, env-only; unset or
    non-positive disables the guard).  A malformed value must not kill
    the solve the knob protects — it disables the guard with a
    warning."""
    raw = os.environ.get("PCG_TPU_COLLECTIVE_DEADLINE_S", "").strip()
    if not raw:
        return None
    try:
        v = float(raw)
    except ValueError:
        warnings.warn(f"PCG_TPU_COLLECTIVE_DEADLINE_S={raw!r} is not a "
                      "number; collective deadline guard disabled")
        return None
    return v if v > 0 else None


# ---------------------------------------------------------------------------
# Dead-peer attribution via the per-process flight shards.
# ---------------------------------------------------------------------------

_RANK_RE = re.compile(r"\.p(\d+)$")


def _shard_rank(path: str) -> Optional[int]:
    """Process index encoded in a flight-shard filename
    (``run.p3.jsonl`` -> 3), or None for the unsharded base file."""
    root, _ = os.path.splitext(path)
    m = _RANK_RE.search(root)
    return int(m.group(1)) if m else None


def flight_base_path(shard_path: str) -> str:
    """Invert ``obs.flight.shard_jsonl_path``: this process's shard
    path back to the base telemetry path every process shards from."""
    root, ext = os.path.splitext(shard_path)
    m = _RANK_RE.search(root)
    return (root[:m.start()] + (ext or ".jsonl")) if m else shard_path


def suspect_dead_rank(flight_base: Optional[str],
                      self_index: Optional[int] = None
                      ) -> Tuple[Optional[int], Optional[float]]:
    """The most heartbeat-silent PEER rank of a flight-shard set:
    ``(rank, silent_s)``, or ``(None, None)`` when no peer shard can be
    read.  This is the shard-tail liveness read the CLI's ``watch`` does
    fleet-wide, pointed at the single question a stuck collective
    poses: which peer stopped writing first?"""
    if not flight_base:
        return None, None
    from pcg_mpi_solver_tpu_torch.obs.flight import find_shards
    from pcg_mpi_solver_tpu_torch.obs.watch import _shard_status

    now = time.time()
    best: Tuple[Optional[int], Optional[float]] = (None, None)
    for p in find_shards(flight_base):
        rank = _shard_rank(p)
        if rank is None or (self_index is not None and rank == self_index):
            continue
        st = _shard_status(p, now)
        silent = st.get("silent_s")
        if silent is None or st.get("done"):
            continue        # no timestamps / finished cleanly: not stuck
        if best[1] is None or silent > best[1]:
            best = (rank, float(silent))
    return best


#: Substrings marking a collective failure as TRANSPORT death (a peer's
#: sockets closed under the collective) rather than a wrong computation.
#: gloo surfaces a killed peer as a fast connection error, not a hang —
#: the verdict is the same as a deadline expiry and must be named the
#: same way (matched case-insensitively).
_TRANSPORT_MARKERS = (
    "gloo", "connection reset", "connection closed", "connection refused",
    "socket closed", "heartbeat timeout", "coordination service",
    "peer closed",
)


def is_transport_failure(exc: BaseException) -> bool:
    """Does this collective error mean a peer's transport died (same
    dead-peer verdict as a deadline expiry)?"""
    msg = str(exc).lower()
    return any(m in msg for m in _TRANSPORT_MARKERS)


class GuardedComm:
    """Deadline watchdog around a HostComm-shaped collective group.

    Each collective runs on a worker thread while the caller waits at
    most ``deadline_s`` (monotonic).  On expiry the caller raises
    :class:`DeadPeerError` naming the most flight-silent peer — the
    worker thread itself stays parked inside gloo (there is no portable
    way to cancel it), which is why it is a daemon: the process is
    expected to exit/relaunch after a dead-peer verdict, not to retry.

    With no deadline configured every call runs inline (no watchdog
    thread, no flight span), but on a multi-process group the
    transport-failure classification still applies — a killed gloo
    peer's fast connection-reset error becomes the same named
    :class:`DeadPeerError` verdict with or without the knob.  The
    wrapper is therefore installed unconditionally on the multi-process
    dispatch path (``Solver._collective_comm``): the consensus
    agreements it carries are correctness-critical; only the watchdog
    is opt-in.
    """

    def __init__(self, comm, *, deadline_s: Optional[float] = None,
                 recorder=None, flight_base: Optional[str] = None,
                 index: int = 0):
        self.comm = comm
        self.n_procs = int(getattr(comm, "n_procs", 1))
        self.deadline_s = deadline_s
        self.recorder = recorder
        self.index = int(index)
        self._flight_base = flight_base

    def flight_base(self) -> Optional[str]:
        """The base flight path (for peer-shard reads), from the
        constructor or derived from the recorder's attached shard."""
        if self._flight_base:
            return self._flight_base
        fl = getattr(self.recorder, "flight", None)
        path = getattr(fl, "path", None)
        return flight_base_path(path) if path else None

    # -- guarded collectives -------------------------------------------
    def allreduce(self, arr, op: str):
        return self._guarded("allreduce",
                             lambda: self.comm.allreduce(arr, op))

    def allreduce_many(self, arrs, op: str):
        return self._guarded("allreduce_many",
                             lambda: self.comm.allreduce_many(arrs, op))

    def allreduce_groups(self, groups):
        return self._guarded("allreduce_groups",
                             lambda: self.comm.allreduce_groups(groups))

    def barrier(self, label: str = "barrier") -> None:
        """A named group sync (the chunk-boundary liveness probe): one
        tiny guarded allreduce — the cheapest round that still proves
        every peer reached this point within the deadline."""
        self._guarded(label, lambda: self.comm.allreduce(
            np.ones(1, dtype=np.int64), "min"))

    def _suspect(self) -> Tuple[Optional[int], str]:
        """``(rank, description)`` of the most flight-silent peer."""
        rank, silent = suspect_dead_rank(self.flight_base(), self.index)
        if rank is not None:
            return rank, f"process {rank} (flight-silent {silent:.1f}s)"
        if self.n_procs == 2:
            # one peer: it is the suspect whatever the shards say
            rank = 1 - self.index
            return rank, f"process {rank} (the only peer)"
        return None, "unknown (no peer flight shard readable)"

    def _raise_transport_death(self, label: str, err: BaseException,
                               waited: float, flight, seq) -> None:
        """Record + raise the dead-peer transport verdict: a killed peer
        usually surfaces as a FAST gloo connection error, not a hang —
        same verdict as a deadline expiry, same named error (the
        original rides along as ``__cause__`` — it would otherwise read
        as a retryable device loss and burn the dispatch-guard budget
        re-entering the same dead group).
        Shared by the watchdog path and the no-deadline inline path."""
        rank, who = self._suspect()
        if self.recorder is not None:
            self.recorder.event(
                "collective_timeout", label=label,
                deadline_s=float(self.deadline_s or 0.0),
                suspect=(-1 if rank is None else int(rank)))
            self.recorder.inc("resilience.collective_timeout")
        if flight is not None:
            flight.end(seq, f"collective:{label}", ok=False,
                       error="collective transport failure",
                       waited_s=round(waited, 3),
                       suspect=(-1 if rank is None else int(rank)))
        raise DeadPeerError(
            f"collective '{label}' failed on the transport after "
            f"{waited:.1f}s ({type(err).__name__}: a peer's "
            f"connection dropped mid-round, {self.n_procs} "
            f"processes); suspected dead peer: {who}") from err

    def _guarded(self, label: str, fn):
        deadline = self.deadline_s
        if self.n_procs <= 1:
            return fn()
        if deadline is None:
            # no watchdog armed: run inline (no thread, no flight span)
            # — but the transport classification is a correctness
            # concern, not a watchdog concern, so it applies to every
            # multi-process group regardless of the deadline knob
            t0 = time.monotonic()
            try:
                return fn()
            except DeadPeerError:
                raise
            except BaseException as err:    # noqa: BLE001 — classified below
                if is_transport_failure(err):
                    self._raise_transport_death(
                        label, err, time.monotonic() - t0, None, None)
                raise
        box: Dict[str, Any] = {}
        done = threading.Event()

        def work():
            try:
                box["out"] = fn()
            except BaseException as e:      # noqa: BLE001 — re-raised on the caller thread below
                box["err"] = e
            finally:
                done.set()

        flight = getattr(self.recorder, "flight", None) \
            if self.recorder is not None else None
        seq = (flight.begin(f"collective:{label}")
               if flight is not None else None)
        t0 = time.monotonic()
        threading.Thread(target=work, daemon=True,
                         name=f"collective:{label}").start()
        done.wait(deadline)
        if not done.is_set():
            waited = time.monotonic() - t0
            rank, who = self._suspect()
            if self.recorder is not None:
                self.recorder.event(
                    "collective_timeout", label=label,
                    deadline_s=float(deadline),
                    suspect=(-1 if rank is None else int(rank)))
                self.recorder.inc("resilience.collective_timeout")
            if flight is not None:
                flight.end(seq, f"collective:{label}", ok=False,
                           error="collective stalled",
                           waited_s=round(waited, 3),
                           suspect=(-1 if rank is None else int(rank)))
            # NB: phrased to stay outside is_device_loss()'s marker set —
            # a dead peer must propagate, not burn dispatch retries.
            raise DeadPeerError(
                f"collective '{label}' got no reply from the group within "
                f"{deadline:.1f}s (waited {waited:.1f}s, "
                f"{self.n_procs} processes); suspected dead peer: {who}")
        err = box.get("err")
        if err is not None and is_transport_failure(err):
            self._raise_transport_death(label, err,
                                        time.monotonic() - t0, flight, seq)
        if flight is not None:
            flight.end(seq, f"collective:{label}",
                       ok=err is None,
                       **({} if err is None
                          else {"error": type(err).__name__}))
        if err is not None:
            raise err
        return box.get("out")


# ---------------------------------------------------------------------------
# Two-phase group-consistent snapshot epochs.
# ---------------------------------------------------------------------------

class GroupSnapshotStore(SnapshotStore):
    """Group-consistent snapshot epochs over the SnapshotStore layout.

    Two-phase protocol per :meth:`save`:

    1. every rank atomically writes its shard
       ``<prefix>_e<E:06d>.p<idx>.npz`` — the axis-0 slice
       ``[part_lo:part_hi]`` of each part-sharded array in the state
       pytree (replicated leaves are written whole by every rank; the
       joiner takes rank 0's copy);
    2. a min-allreduce confirms every shard landed, and only then does
       rank 0 publish the ``<prefix>_COMMIT_e<E:06d>.json`` marker
       (epoch, step, shard count).

    Readers (:meth:`load`, :meth:`latest`) resolve the newest committed
    epoch — group-agreed with a min-reduce, so a rank whose directory
    view lags (NFS) pulls the whole group back to an epoch everyone can
    see — and re-join the shards by concatenation.  An uncommitted
    (torn) epoch is invisible: a crash between two ranks' writes costs
    one snapshot interval, never a mixed resume.  Retention
    (``PCG_TPU_SNAP_KEEP``) keeps the newest K *committed* epochs plus
    any newer in-flight epoch; each rank prunes only its own shards
    (rank 0 also sweeps markers and leftover shards of dropped epochs),
    so pruning can never make two ranks resolve different newest
    snapshots.

    Elastic resume: shards carry their part ranges, so :meth:`load`
    re-joins a committed N-process epoch into the full global state on
    ANY process count; with ``elastic=True`` a fingerprint mismatch
    confined to ``n_procs`` becomes a named ``elastic_resume`` event
    instead of an error.
    """

    def __init__(self, path: str, fingerprint: Optional[dict] = None,
                 prefix: str = "snap", *, comm=None, index: int = 0,
                 n_shards: int = 1,
                 part_range: Optional[Tuple[int, int]] = None,
                 n_parts: Optional[int] = None, recorder=None,
                 elastic: bool = False):
        super().__init__(path, fingerprint, prefix)
        self.comm = comm
        self.index = int(index)
        self.n_shards = int(n_shards)
        self.part_range = part_range
        self.n_parts = n_parts
        self.recorder = recorder
        self.elastic = bool(elastic)
        # next epoch number, scanned once at construction (every rank
        # builds its store before the first collective save, so the
        # scans see the same directory generation; save() max-agrees
        # the result anyway)
        self._epoch = self._scan_next_epoch()

    # -- construction ---------------------------------------------------
    @classmethod
    def for_solver(cls, solver, *, comm=None, recorder=None,
                   elastic: bool = False) -> "GroupSnapshotStore":
        base = SnapshotStore.for_solver(solver)
        return cls._from_base(base, solver, comm, recorder, elastic)

    @classmethod
    def for_many_solver(cls, solver, nrhs: int, rhs_hash: str = "", *,
                        comm=None, recorder=None,
                        elastic: bool = False) -> "GroupSnapshotStore":
        base = SnapshotStore.for_many_solver(solver, nrhs, rhs_hash)
        return cls._from_base(base, solver, comm, recorder, elastic)

    @classmethod
    def _from_base(cls, base: SnapshotStore, solver, comm, recorder,
                   elastic: bool) -> "GroupSnapshotStore":
        from pcg_mpi_solver_tpu_torch.parallel.distributed import (
            local_part_range, process_count, process_index)

        n_parts = int(solver.pm.n_parts)
        return cls(base.path, base.fingerprint, base.prefix, comm=comm,
                   index=int(process_index()),
                   n_shards=int(process_count()),
                   part_range=local_part_range(
                       getattr(solver, "mesh", None), n_parts),
                   n_parts=n_parts, recorder=recorder, elastic=elastic)

    # -- naming ---------------------------------------------------------
    def _shard_file(self, epoch: int, idx: int) -> str:
        return os.path.join(self.path,
                            f"{self.prefix}_e{epoch:06d}.p{idx}.npz")

    def _marker_file(self, epoch: int) -> str:
        return os.path.join(self.path,
                            f"{self.prefix}_COMMIT_e{epoch:06d}.json")

    _EPOCH_SHARD_RE = re.compile(r"_e(\d{6})\.p(\d+)\.npz$")
    _EPOCH_MARKER_RE = re.compile(r"_COMMIT_e(\d{6})\.json$")

    def _scan_next_epoch(self) -> int:
        """First unused epoch number in the directory (fresh store) —
        every rank scans the same files, and :meth:`save` max-agrees the
        result so a racing first scan cannot diverge the group."""
        newest = -1
        for p in _glob.glob(os.path.join(self.path, f"{self.prefix}_*")):
            name = os.path.basename(p)
            m = self._EPOCH_SHARD_RE.search(name) \
                or self._EPOCH_MARKER_RE.search(name)
            if m and name.startswith(self.prefix + "_"):
                newest = max(newest, int(m.group(1)))
        return newest + 1

    def committed_epochs(self) -> List[Tuple[int, Dict[str, Any]]]:
        """``(epoch, marker)`` of every readable commit marker,
        ascending.  Unreadable markers read as absent (same tolerant
        posture as the snapshot reads): the epoch is simply not
        committed from this rank's view, and the group min-agreement
        handles the divergence."""
        out = []
        for p in _glob.glob(os.path.join(
                self.path, f"{self.prefix}_COMMIT_e*.json")):
            m = self._EPOCH_MARKER_RE.search(os.path.basename(p))
            if not m:
                continue
            try:
                with open(p, encoding="utf-8") as f:
                    meta = json.load(f)
            except (OSError, ValueError):
                continue
            out.append((int(m.group(1)), meta))
        return sorted(out)

    # -- write path -----------------------------------------------------
    def _sharded_keys(self, flat: Dict[str, Any]) -> List[str]:
        """The flattened keys this store splits by part rows: the same
        heuristic driver._put_state reshards by — axis 0 of an ndim>=2
        numeric array equals n_parts."""
        if self.part_range is None or not self.n_parts:
            return []
        return sorted(
            k for k, v in flat.items()
            if v.ndim >= 2 and v.shape[0] == self.n_parts
            and v.dtype.kind not in "OUS")

    def save(self, t: int, state: Dict[str, Any]) -> str:
        """Two-phase epoch write (see class docstring).  Every rank
        calls this collectively — unlike the base store there is no
        primary gate: each rank persists its own slice."""
        from pcg_mpi_solver_tpu_torch.parallel.consensus import agree

        os.makedirs(self.path, exist_ok=True)
        # phase 0: agree the epoch number (max — ranks are lockstep, but
        # a first-save directory scan racing a peer's publish must not
        # split the numbering)
        epoch = int(agree(self.comm, [self._epoch], "max")[0])
        flat = _flatten(state)
        sharded = self._sharded_keys(flat)
        lo, hi = self.part_range if self.part_range is not None else (-1, -1)
        for k in sharded:
            flat[k] = flat[k][lo:hi]
        flat["__t"] = np.int64(t)
        flat["__epoch"] = np.int64(epoch)
        flat["__shard"] = np.asarray([self.index, self.n_shards], np.int64)
        flat["__part_range"] = np.asarray([lo, hi], np.int64)
        flat["__sharded"] = np.asarray(sharded)
        flat["__fingerprint"] = np.frombuffer(
            json.dumps(self.fingerprint or {}, sort_keys=True).encode(),
            dtype=np.uint8).copy()
        out = self._shard_file(epoch, self.index)
        ok = 1
        try:
            write_atomic(out, lambda f: np.savez_compressed(f, **flat))
        except OSError as e:
            warnings.warn(f"snapshot shard {out} failed to write "
                          f"({type(e).__name__}: {e}); epoch {epoch} "
                          "will not commit")
            ok = 0
        # phase 1 -> 2: the marker is published only after every rank
        # confirms its shard landed
        committed = bool(int(agree(self.comm, [ok], "min")[0]))
        if committed and self.index == 0:
            marker = {"epoch": int(epoch), "step": int(t),
                      "n_shards": int(self.n_shards),
                      "n_parts": int(self.n_parts or 0)}
            blob = json.dumps(marker, sort_keys=True).encode()
            try:
                write_atomic(self._marker_file(epoch), blob)
            except OSError as e:
                warnings.warn(f"commit marker for epoch {epoch} failed "
                              f"({type(e).__name__}: {e}); the epoch "
                              "stays uncommitted")
                committed = False
        if self.recorder is not None:
            self.recorder.event("snapshot_epoch", epoch=int(epoch),
                                step=int(t), shards=int(self.n_shards),
                                committed=bool(committed))
        self._epoch = epoch + 1
        self._prune()
        return out

    # -- read path ------------------------------------------------------
    def _newest_committed(self, step: Optional[int] = None,
                          below: Optional[int] = None) -> int:
        """Newest locally-visible committed epoch (optionally for one
        step, optionally strictly below an epoch), or -1."""
        newest = -1
        for epoch, meta in self.committed_epochs():
            if step is not None and int(meta.get("step", -1)) != int(step):
                continue
            if below is not None and epoch >= below:
                continue
            newest = max(newest, epoch)
        return newest

    def _read_shard(self, epoch: int, idx: int
                    ) -> Optional[Dict[str, Any]]:
        path = self._shard_file(epoch, idx)
        try:
            with np.load(path) as z:
                return {k: z[k] for k in z.files}
        except Exception as e:                          # noqa: BLE001
            warnings.warn(f"snapshot shard {path} unreadable "
                          f"({type(e).__name__}: {e}); falling back to "
                          "an older committed epoch")
            return None

    def _join_epoch(self, epoch: int, t: int
                    ) -> Optional[Dict[str, Any]]:
        """Re-join one committed epoch's shards into the full state
        pytree, or None when any shard is missing/corrupt/torn."""
        meta = dict(next((m for e, m in self.committed_epochs()
                          if e == epoch), {}))
        n_shards = int(meta.get("n_shards", 0))
        if n_shards <= 0:
            return None
        shards = []
        for idx in range(n_shards):
            flat = self._read_shard(epoch, idx)
            if flat is None or int(flat.get("__t", -1)) != int(t):
                return None
            shards.append(flat)
        try:
            saved = json.loads(
                bytes(shards[0]["__fingerprint"]).decode())
        except (KeyError, ValueError):
            return None
        self._reconcile_fingerprint(saved)
        sharded = [str(k) for k in shards[0].get(
            "__sharded", np.asarray([], dtype=str))]
        ranged = sorted(
            ((tuple(int(v) for v in flat["__part_range"]), flat)
             for flat in shards), key=lambda pair: pair[0])
        n_parts = int(meta.get("n_parts", 0)) or int(self.n_parts or 0)
        joined: Dict[str, Any] = {}
        for k in shards[0]:
            if k.startswith("__"):
                continue
            if k in sharded:
                pos, pieces = 0, []
                for (p0, p1), flat in ranged:
                    if p0 != pos:       # stale/mixed-generation shards
                        warnings.warn(
                            f"epoch {epoch} shards do not tile part "
                            f"rows contiguously at part {pos}; falling "
                            "back to an older committed epoch")
                        return None
                    pieces.append(flat[k])
                    pos = p1
                if n_parts and pos != n_parts:
                    # contiguous but short: e.g. leftover shards of a
                    # shrunk fleet matching an old marker's n_shards —
                    # a truncated global array must not restore
                    warnings.warn(
                        f"epoch {epoch} shards tile only {pos} of "
                        f"{n_parts} part rows; falling back to an "
                        "older committed epoch")
                    return None
                joined[k] = np.concatenate(pieces, axis=0)
            else:
                joined[k] = shards[0][k]
        return _unflatten(joined)

    def load(self, t: int) -> Optional[Dict[str, Any]]:
        """The newest committed epoch of in-flight step ``t``, joined —
        group-agreed: every rank restores the SAME epoch or none.  A
        locally-unreadable epoch pulls the whole group back to the next
        older committed one (bounded retries: one agreement round per
        candidate epoch)."""
        from pcg_mpi_solver_tpu_torch.parallel.consensus import agree, agree_flag

        below: Optional[int] = None
        while True:
            local = self._newest_committed(step=t, below=below)
            epoch = int(agree(self.comm, [local], "min")[0])
            if epoch < 0:
                return None
            state = self._join_epoch(epoch, t)
            if agree_flag(self.comm, state is not None):
                if self.recorder is not None:
                    self.recorder.event(
                        "snapshot_epoch", epoch=int(epoch), step=int(t),
                        shards=int(self.n_shards), committed=True,
                        op="restore")
                return state
            below = epoch       # someone failed the join: fall back

    def latest(self) -> Optional[int]:
        """Step index of the newest committed epoch (group-agreed), or
        None — the committed-epoch twin of the base store's newest
        readable file."""
        from pcg_mpi_solver_tpu_torch.parallel.consensus import agree

        epoch = int(agree(self.comm, [self._newest_committed()], "min")[0])
        if epoch < 0:
            return None
        meta = next((m for e, m in self.committed_epochs()
                     if e == epoch), None)
        return int(meta["step"]) if meta and "step" in meta else None

    def _fingerprint_mismatch(self, saved: dict, diffs: dict) -> None:
        if self.elastic and set(diffs) == {"n_procs"}:
            # the NAMED elastic path: restoring an N-process epoch onto
            # M processes is exact for the dof-indexed CG carry — record
            # it loudly instead of refusing
            if self.recorder is not None:
                self.recorder.event(
                    "elastic_resume",
                    from_procs=int(saved.get("n_procs", -1)),
                    to_procs=int((self.fingerprint or {}).get(
                        "n_procs", -1)),
                    prefix=self.prefix)
                self.recorder.inc("resilience.elastic_resume")
            return
        super()._fingerprint_mismatch(saved, diffs)

    # -- retention ------------------------------------------------------
    def _prune(self) -> None:
        """Committed-epoch retention: keep the newest K committed epochs
        (``PCG_TPU_SNAP_KEEP``) plus anything newer than the newest
        committed epoch (it may still commit).  Each rank removes only
        its own shards; rank 0 additionally sweeps dropped markers and
        any leftover shards (e.g. of a rank count that shrank).  Races
        with a peer's prune are benign — the loser's remove is a no-op
        and readers fall back by construction."""
        committed = [e for e, _ in self.committed_epochs()]
        keep = set(committed[-self.retention():])
        newest = committed[-1] if committed else -1

        def droppable(epoch: int) -> bool:
            return epoch not in keep and epoch <= newest

        own = _glob.glob(os.path.join(
            self.path, f"{self.prefix}_e*.p{self.index}.npz"))
        sweep = list(own)
        if self.index == 0:
            sweep = _glob.glob(os.path.join(
                self.path, f"{self.prefix}_e*.p*.npz"))
        for p in sweep:
            m = self._EPOCH_SHARD_RE.search(os.path.basename(p))
            if m and droppable(int(m.group(1))):
                try:
                    os.remove(p)
                except OSError:
                    pass        # a racing peer's prune already has it
        if self.index == 0:
            for epoch in committed:
                if droppable(epoch):
                    try:
                        os.remove(self._marker_file(epoch))
                    except OSError:
                        pass
        # the base-store files of this prefix (snap_000001.npz style)
        # are a different namespace — never touched here

    def discard(self, t: int) -> None:
        """Drop every committed epoch of completed step ``t`` (markers
        first, so a reader racing the removal sees a consistent
        absent-epoch view, then each rank's own shards)."""
        for epoch, meta in self.committed_epochs():
            if int(meta.get("step", -1)) != int(t):
                continue
            if self.index == 0:
                try:
                    os.remove(self._marker_file(epoch))
                except OSError:
                    pass
            for idx in ([self.index] if self.index != 0
                        else range(max(self.n_shards,
                                       int(meta.get("n_shards", 1))))):
                try:
                    os.remove(self._shard_file(epoch, idx))
                except OSError:
                    pass

"""Crash-durable flight recorder and tolerant JSONL ingest.

Port of ``pcg_mpi_solver_tpu/obs/flight.py``.

* **Writing** (:class:`FlightRecorder`): an append-only JSONL stream
  whose every record is flushed and ``os.fsync``'d as it is written, so a
  SIGKILL or a lost machine loses at most the record being written.
  Records bracket work (``begin`` / ``end`` / ``fail``), and a daemon
  thread writes ``heartbeat`` records, with the monotonic and the wall
  clock, while a bracket is open.  Unlike the JAX package's, which
  starts a heartbeat thread when a bracket opens and stops it when the
  last one closes, the port keeps one thread from the first bracket to
  :meth:`FlightRecorder.close` that ticks every ``heartbeat_s`` and
  writes a heartbeat only while a bracket is open: a solve opens and
  closes ~14 brackets, and starting and waking a thread at each cost the
  150^3 flagship 2-3 % of its wall on an H100, against ~0.2 % for the
  fsyncs (``tools/telemetry_overhead.py``).
* **Reading** (:func:`read_jsonl_tolerant`, :func:`flight_verdict`): a
  killed run's file may end in a line cut mid-object; the reader skips
  and counts unparseable lines, and the verdict says ``clean`` (every
  bracket closed), ``failed`` (one closed with an error) or ``died`` (one
  never closed), with the brackets in flight and the last timestamps.
* **Shards** (:func:`shard_jsonl_path`, :func:`merge_shards`,
  :func:`find_shards`): the per-process file naming of a multi-process
  run and their merge into one time-ordered stream.  The port runs one
  process (index 0 of 1), whose path is the base path itself.

Flight records are ordinary telemetry events (``kind="flight"``,
``obs/schema.py``), so every JSONL consumer reads them.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
import weakref
from contextlib import contextmanager
from typing import Any, Dict, List, Mapping, Optional, Tuple

from pcg_mpi_solver_tpu_torch.obs.metrics import _jsonable
from pcg_mpi_solver_tpu_torch.obs.schema import TELEMETRY_SCHEMA

#: default seconds between heartbeat records while a bracket is open
#: (env override: PCG_TPU_FLIGHT_HEARTBEAT_S).
DEFAULT_HEARTBEAT_S = 5.0


class FlightRecorder:
    """fsync-per-event JSONL flight recorder.

    Thread-safe; cheap when idle (one heartbeat thread from the first
    bracket to :meth:`close`, waking once every ``heartbeat_s``).
    ``fsync=False`` (or PCG_TPU_FLIGHT_FSYNC=0) downgrades to
    flush-only for tests/hot paths where durability
    against OS crash is not needed — a SIGKILL still loses nothing,
    only a kernel panic could.
    """

    def __init__(self, path: str, meta: Optional[Dict[str, Any]] = None,
                 heartbeat_s: Optional[float] = None,
                 fsync: Optional[bool] = None):
        self.path = path
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        if heartbeat_s is None:
            try:
                heartbeat_s = float(os.environ.get(
                    "PCG_TPU_FLIGHT_HEARTBEAT_S", DEFAULT_HEARTBEAT_S))
            except ValueError:      # a typo'd knob must not cost the run
                heartbeat_s = DEFAULT_HEARTBEAT_S
        if fsync is None:
            fsync = os.environ.get("PCG_TPU_FLIGHT_FSYNC", "1") != "0"
        self.heartbeat_s = max(0.05, float(heartbeat_s))
        self._fsync = bool(fsync)
        self._f = open(path, "a", encoding="utf-8")
        self._lock = threading.Lock()
        self._seq = 0
        self._open: Dict[int, str] = {}     # seq -> record name
        self._hb_stop: Optional[threading.Event] = None
        self._closed = False
        if meta:
            self.emit("meta", **meta)

    # -- low-level ------------------------------------------------------
    def emit(self, op: str, **fields) -> Dict[str, Any]:
        """Write ONE durable flight record: a telemetry event of
        ``kind="flight"`` carrying the op, a monotonic timestamp (crash
        forensics must survive wall-clock jumps) and the caller's
        fields."""
        ev = {"schema": TELEMETRY_SCHEMA, "t": time.time(),
              "kind": "flight", "op": op,
              "mono": round(time.monotonic(), 6)}
        ev.update(fields)
        with self._lock:
            if self._closed:
                return ev
            try:
                self._f.write(json.dumps(ev, default=_jsonable) + "\n")
                self._f.flush()
                if self._fsync:
                    try:
                        os.fsync(self._f.fileno())
                    except OSError:
                        pass    # fs without fsync (pipes): flush stands
            except (OSError, ValueError):
                # disk full / handle gone mid-run: observability must
                # never cost the run itself — the record is lost, the
                # solve (and every other bracket) continues
                pass
        return ev

    # -- brackets -------------------------------------------------------
    def begin(self, name: str, **fields) -> int:
        """Open a bracket; returns the sequence token ``end`` needs.
        Heartbeats are written while at least one bracket is open (the
        first bracket starts the heartbeat thread)."""
        with self._lock:
            self._seq += 1
            seq = self._seq
            self._open[seq] = name
            start_hb = self._hb_stop is None and not self._closed
            if start_hb:
                self._hb_stop = threading.Event()
                stop = self._hb_stop
        if start_hb:
            threading.Thread(
                target=_heartbeat_loop,
                args=(weakref.ref(self), stop, self.heartbeat_s),
                name=f"flight-heartbeat {self.path}", daemon=True).start()
        self.emit("begin", name=name, seq=seq, **fields)
        return seq

    def end(self, seq: int, name: str, ok: bool = True, **fields) -> None:
        """Close a bracket (op = ``end`` or ``fail``)."""
        with self._lock:
            self._open.pop(seq, None)
        self.emit("end" if ok else "fail", name=name, seq=seq, **fields)

    @contextmanager
    def record(self, name: str, **fields):
        """Bracket a block of work: ``begin`` on entry, ``end`` on clean
        exit, ``fail`` (with the exception named) when it raises — and
        nothing at all if the process is killed, which is exactly the
        parseable absence :func:`flight_verdict` classifies as
        ``died``."""
        seq = self.begin(name, **fields)
        t0 = time.monotonic()
        try:
            yield self
        except BaseException as e:
            self.end(seq, name, ok=False,
                     error=f"{type(e).__name__}: {e}",
                     wall_s=round(time.monotonic() - t0, 6))
            raise
        self.end(seq, name, ok=True,
                 wall_s=round(time.monotonic() - t0, 6))

    def _heartbeat(self) -> None:
        """One tick: a heartbeat naming the open brackets, none when no
        bracket is open."""
        with self._lock:
            names = list(self._open.values())
        if names:
            self.emit("heartbeat", in_flight=names)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._hb_stop is not None:
                self._hb_stop.set()
                self._hb_stop = None
            try:
                self._f.close()
            except ValueError:
                pass


def _heartbeat_loop(ref, stop: threading.Event, period: float) -> None:
    """The heartbeat thread: a tick every ``period`` until the recorder is
    closed (``stop``) or collected (it holds the recorder only weakly, so
    an unclosed recorder's thread ends with it)."""
    while not stop.wait(period):
        fr = ref()
        if fr is None:
            return
        fr._heartbeat()
        del fr


# ---------------------------------------------------------------------------
# Tolerant ingest — the read side every killed run's artifact needs.
# ---------------------------------------------------------------------------

def read_jsonl_tolerant(path: str) -> Tuple[List[Dict[str, Any]], int]:
    """Parse a JSONL file, skipping unparseable lines instead of raising.

    Returns ``(events, truncated_lines)``.  A process killed mid-write
    leaves exactly one cut line (usually the last); any JSONL consumer of
    crash artifacts must survive it — this is the ONE reader the CLI
    summary and the telemetry-merge aggregator share.  Blank lines are ignored (not counted)."""
    events: List[Dict[str, Any]] = []
    truncated = 0
    with open(path, encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                truncated += 1
                continue
            if isinstance(ev, dict):
                events.append(ev)
            else:
                truncated += 1
    return events, truncated


def flight_verdict(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Classify a flight-record event stream mechanically.

    verdict: ``clean``  — every begin has a matching end;
             ``failed`` — at least one bracket closed with op=fail;
             ``died``   — at least one bracket never closed (the process
             was killed in flight);
             ``empty``  — no flight records at all.
    ``in_flight`` names the unclosed brackets, ``last_wall`` /
    ``last_mono`` the newest timestamp of ANY flight record (the
    heartbeat cadence bounds how stale they can be), and ``fails`` the
    collected failure messages.  A fail record carrying
    ``expected=True`` (a caller descending to a smaller case BY DESIGN)
    is collected separately in ``expected_fails`` and does NOT make the
    verdict ``failed`` — and neither do fails whose bracket is NESTED
    inside an expected one (the Solver's dispatch bracket closes op=fail
    when the case's solve raises, before the caller closes its bracket
    expected): the verdict must keep pointing operators at work to
    re-queue, not at descents that already succeeded."""
    open_recs: Dict[Any, str] = {}
    fails: List[str] = []
    expected_fails: List[str] = []
    begin_at: Dict[Any, int] = {}       # key -> flight-record index
    # (shard, begin_i, close_i, expected, msg) per op=fail bracket
    fail_spans: List[Tuple[Any, int, int, bool, str]] = []
    last_wall = last_mono = None
    n = 0
    for ev in events:
        if ev.get("kind") != "flight":
            continue
        n += 1
        if isinstance(ev.get("t"), (int, float)):
            last_wall = ev["t"] if last_wall is None \
                else max(last_wall, ev["t"])
        if isinstance(ev.get("mono"), (int, float)):
            last_mono = ev["mono"] if last_mono is None \
                else max(last_mono, ev["mono"])
        op = ev.get("op")
        # brackets pair per SOURCE STREAM: a telemetry-merge'd stream
        # carries per-shard seq counters that all start at 1, and one
        # process's end must never close another's begin (a died shard
        # would read clean).  Unmerged files have no shard field — the
        # key degrades to the plain seq.
        key = (ev.get("shard"), ev.get("seq"))
        if op == "begin":
            open_recs[key] = str(ev.get("name"))
            begin_at[key] = n
        elif op in ("end", "fail"):
            open_recs.pop(key, None)
            b = begin_at.pop(key, n)
            if op == "fail":
                why = ev.get("error") or ev.get("status") or "?"
                fail_spans.append((ev.get("shard"), b, n,
                                   bool(ev.get("expected")),
                                   f"{ev.get('name')}: {why}"))
    exp_spans = [(sh, b, c) for sh, b, c, exp, _ in fail_spans if exp]
    for sh, b, c, exp, msg in fail_spans:
        covered = exp or any(s == sh and eb < b and c < ec
                             for s, eb, ec in exp_spans)
        (expected_fails if covered else fails).append(msg)
    if n == 0:
        verdict = "empty"
    elif open_recs:
        verdict = "died"
    elif fails:
        verdict = "failed"
    else:
        verdict = "clean"
    return {"verdict": verdict, "records": n,
            "in_flight": sorted(open_recs.values()),
            "fails": fails, "expected_fails": expected_fails,
            "last_wall": last_wall, "last_mono": last_mono}


_SALVAGE_NUM_RE = {
    k: re.compile(r'"%s"\s*:\s*(-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)' % k)
    for k in ("t", "mono")}
_SALVAGE_STR_RE = {
    k: re.compile(r'"%s"\s*:\s*"([^"]*)"' % k) for k in ("kind", "op")}


def salvage_truncated_tail(path: str) -> Optional[Dict[str, Any]]:
    """Best-effort fields of a FINAL line that was cut mid-write.

    A process killed mid-``write()`` leaves one truncated trailing line;
    :func:`read_jsonl_tolerant` rightly skips it as unparseable — but
    when that line is the stream's last heartbeat, dropping it makes the
    shard look dead ``(write interval + heartbeat cadence)`` earlier
    than it really was, and a stall monitor would flag a live run.  The
    JSONL writers emit ``schema``/``t``/``kind`` first (metrics.event,
    FlightRecorder.emit), so even a badly cut line usually still carries
    the timestamp.  Returns ``{"t", "mono", "kind", "op", "salvaged":
    True}`` (fields present only when recovered) for a trailing line
    that starts like a record but does not parse; None when the file
    ends with a complete line (or cannot be read)."""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - 65536))
            tail = f.read().decode("utf-8", errors="replace")
    except OSError:
        return None
    lines = tail.splitlines()
    if not lines:
        return None
    last = lines[-1].strip()
    if not last or not last.startswith("{"):
        return None
    try:
        json.loads(last)
        return None                     # complete final line: nothing cut
    except ValueError:
        pass
    out: Dict[str, Any] = {"salvaged": True}
    for k, rx in _SALVAGE_NUM_RE.items():
        m = rx.search(last)
        if m:
            out[k] = float(m.group(1))
    for k, rx in _SALVAGE_STR_RE.items():
        m = rx.search(last)
        if m:
            out[k] = m.group(1)
    return out if len(out) > 1 else None


def flight_verdict_path(path: str) -> Dict[str, Any]:
    """:func:`flight_verdict` of a file, tolerant of truncation; the
    skipped-line count rides along as ``truncated_lines``.

    A final heartbeat cut mid-write still counts as the stream's last
    breath: its salvaged ``t``/``mono`` advance ``last_wall`` /
    ``last_mono`` (flagged ``salvaged_tail``) so a shard killed while
    writing its newest heartbeat is not read as having died a heartbeat
    interval earlier than it did."""
    events, truncated = read_jsonl_tolerant(path)
    out = flight_verdict(events)
    out["truncated_lines"] = truncated
    tail = salvage_truncated_tail(path)
    if tail and tail.get("kind") == "flight":
        t, mono = tail.get("t"), tail.get("mono")
        if t is not None and (out["last_wall"] is None
                              or t > out["last_wall"]):
            out["last_wall"] = t
            out["salvaged_tail"] = True
        if mono is not None and (out["last_mono"] is None
                                 or mono > out["last_mono"]):
            out["last_mono"] = mono
            out["salvaged_tail"] = True
    return out


def ingest_and_rotate(path: str, log_fn,
                      label: str = "previous flight record") -> str:
    """Mechanically ingest a LEFTOVER flight artifact before starting a
    fresh stream at the same path: log its verdict (in-flight names +
    truncated-line count included) and rotate it to ``path + ".prev"``.

    The startup discipline every flight writer shares: a new run's
    verdict must not inherit a dead
    run's unclosed brackets, and a dead run's verdict must not be closed
    by the new run's reused seq numbers reading as matching end records.
    Returns the path the new stream must write to: ``path`` itself when
    it was rotated away (or never existed), or a unique ``path.<pid>``
    sibling when the leftover artifact could not be read/rotated —
    appending to the old stream would silently close the dead run's
    brackets, so a fallback path is the only safe degrade.  Ingest
    trouble never raises: it must not cost the run itself."""
    if not os.path.exists(path):
        return path
    try:
        v = flight_verdict_path(path)
        os.replace(path, path + ".prev")
        log_fn(f"{label} ({path}): verdict={v['verdict']}, "
               f"{v['records']} record(s)"
               + (", in flight at death: " + ", ".join(v["in_flight"])
                  if v["in_flight"] else "")
               + (f", {v['truncated_lines']} truncated line(s) skipped"
                  if v.get("truncated_lines") else "")
               + "; rotated to .prev")
        return path
    except OSError as e:
        fallback = f"{path}.{os.getpid()}"
        log_fn(f"{label} ({path}) could not be read/rotated ({e}); "
               f"new flight records go to {fallback}")
        return fallback


def attach_flight(recorder, path: Optional[str], component: str,
                  **meta) -> Optional[FlightRecorder]:
    """Attach a crash-durable FlightRecorder to a ``MetricsRecorder`` —
    the ONE wiring every solve driver shares (Solver, DynamicsSolver,
    NewmarkSolver): resolve the path (config value, else the
    ``PCG_TPU_FLIGHT`` env default), ingest + rotate a dead previous
    run's artifact, and hang the recorder on ``recorder.flight`` so the
    dispatch spans bracket themselves.

    Best-effort on the file only: an unwritable path degrades to a
    ``recorder.note`` — the artifact must never cost the run itself.
    Returns the attached FlightRecorder (an already-attached one is
    returned untouched) or None."""
    existing = getattr(recorder, "flight", None)
    if existing is not None:
        return existing
    fp = (path or os.environ.get("PCG_TPU_FLIGHT", "")).strip()
    if not fp:
        return None
    try:
        shard = ingest_and_rotate(fp, recorder.note)
        fl = FlightRecorder(shard, meta={"component": component, **meta})
        recorder.flight = fl
        return fl
    except (OSError, ValueError) as e:
        recorder.note(f"flight recorder unavailable ({e}); "
                      "continuing without")
        return None


# ---------------------------------------------------------------------------
# Per-process telemetry shards + the merge aggregator.
# ---------------------------------------------------------------------------

def shard_jsonl_path(path: str, process_index: int = 0,
                     process_count: int = 1) -> str:
    """Per-process shard name of a JSONL path in a multi-process run:
    ``run.jsonl`` -> ``run.p3.jsonl`` on process 3; unchanged in a
    one-process run (the port's), so single-process workflows keep their
    exact file names."""
    if int(process_count) <= 1:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}.p{int(process_index)}{ext or '.jsonl'}"


def dispatch_anchors(events: List[Dict[str, Any]]
                     ) -> Dict[Tuple[str, int], float]:
    """Matched-anchor completion times of one telemetry/flight shard for
    clock alignment: every dispatch of a multi-process run is one
    program all processes block on together, so the k-th completion of
    dispatch ``name`` is the telemetry-granularity analogue of a
    collective end event.  Keys are
    ``(name, occurrence)`` over telemetry ``dispatch`` events and flight
    ``end`` records of ``dispatch:*`` brackets; values are the wall
    ``t``."""
    anchors: Dict[Tuple[str, int], float] = {}
    counts: Dict[str, int] = {}
    for ev in events:
        t = ev.get("t")
        if not isinstance(t, (int, float)):
            continue
        kind = ev.get("kind")
        name = None
        if kind == "dispatch":
            name = str(ev.get("name"))
        elif kind == "flight" and ev.get("op") == "end" \
                and str(ev.get("name", "")).startswith("dispatch:"):
            name = str(ev.get("name"))
        if name is None:
            continue
        k = counts.get(name, 0)
        counts[name] = k + 1
        anchors[(name, k)] = float(t)
    return anchors


def align_offsets(anchors: Mapping[Any, Mapping[Any, float]]
                  ) -> Tuple[Dict[Any, float], int]:
    """Per-stream clock offsets from matched synchronization anchors
    (the JAX package's ``obs/fleet.py:59``): ``anchors`` maps stream id
    -> {anchor key: completion time}.  Returns ``(offsets, n_matched)``,
    ``offsets[s]`` the median of ``t_s - t_ref`` over every anchor
    present in ALL streams (ref = the lowest stream id, offset 0.0); a
    stream keeps 0.0 when no anchor matches."""
    ids = sorted(anchors)
    offsets: Dict[Any, float] = {s: 0.0 for s in ids}
    if len(ids) < 2:
        return offsets, 0
    ref = ids[0]
    shared = set(anchors[ref])
    for s in ids[1:]:
        shared &= set(anchors[s])
    for s in ids[1:]:
        deltas = sorted(anchors[s][k] - anchors[ref][k] for k in shared)
        if deltas:
            m = len(deltas) // 2
            offsets[s] = (deltas[m] if len(deltas) % 2
                          else 0.5 * (deltas[m - 1] + deltas[m]))
    return offsets, len(shared)


def merge_shards(paths: List[str], out_path: str,
                 align: Optional[str] = None) -> Dict[str, Any]:
    """Aggregate per-process telemetry/flight shards into ONE
    time-ordered JSONL stream.

    Every event gains a ``shard`` field (the source basename; the full
    given path when two inputs share a basename — e.g. per-host
    collection dirs both holding ``run.p0.jsonl`` — so stats can't
    silently collapse and :func:`flight_verdict`'s per-``(shard, seq)``
    bracket pairing can't close one stream's death with another's end)
    so per-process attribution survives the merge; ordering is by the
    wall timestamp ``t`` with the per-shard order as the stable tiebreak
    (events without a numeric ``t`` sort to the front of their shard's
    position).  Truncated lines — a killed writer's signature — are
    SKIPPED and counted per shard, never raised on.

    ``align="collectives"`` aligns the clocks (:func:`align_offsets`)
    over matched dispatch completions (:func:`dispatch_anchors`): hosts
    with skewed wall clocks would otherwise interleave out of true
    order.  Each shard's median offset against shard 0 is subtracted
    from its ordering key and stamped on its events as ``t_aligned``
    (``t`` itself is never rewritten — provenance keeps the raw clock);
    the offsets and matched-anchor count ride along in the returned
    stats under ``align``.  With no matched anchors the mode degrades to
    the plain ``t`` ordering (offsets 0) and says so.

    Returns ``{"events", "shards": {name: {"events", "truncated"}},
    "truncated_lines"[, "align"]}``."""
    base_counts: Dict[str, int] = {}
    for p in paths:
        b = os.path.basename(p)
        base_counts[b] = base_counts.get(b, 0) + 1
    names: List[str] = []
    name_counts: Dict[str, int] = {}
    for p in paths:
        name = p if base_counts[os.path.basename(p)] > 1 \
            else os.path.basename(p)
        n = name_counts.get(name, 0)
        name_counts[name] = n + 1
        names.append(f"{name}#{n}" if n else name)
    per_shard: List[List[Dict[str, Any]]] = []
    stats: Dict[str, Dict[str, int]] = {}
    total_trunc = 0
    for si, p in enumerate(paths):
        events, truncated = read_jsonl_tolerant(p)
        per_shard.append(events)
        stats[names[si]] = {"events": len(events), "truncated": truncated}
        total_trunc += truncated
    offsets = {si: 0.0 for si in range(len(paths))}
    align_stats = None
    if align == "collectives":
        offsets, matched = align_offsets(
            {si: dispatch_anchors(evs)
             for si, evs in enumerate(per_shard)})
        align_stats = {"mode": align, "matched_anchors": matched,
                       "offsets_s": {names[si]: round(offsets[si], 6)
                                     for si in range(len(paths))}}
    merged: List[Tuple[float, int, int, Dict[str, Any]]] = []
    for si, events in enumerate(per_shard):
        name = names[si]
        for ei, ev in enumerate(events):
            t = ev.get("t")
            key = float(t) - offsets[si] \
                if isinstance(t, (int, float)) else float("-inf")
            ev = dict(ev)
            ev.setdefault("shard", name)
            if align_stats is not None and key != float("-inf"):
                ev["t_aligned"] = round(key, 6)
            merged.append((key, si, ei, ev))
    merged.sort(key=lambda r: (r[0], r[1], r[2]))
    d = os.path.dirname(os.path.abspath(out_path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{out_path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        for _, _, _, ev in merged:
            f.write(json.dumps(ev, default=_jsonable) + "\n")
    os.replace(tmp, out_path)
    out = {"events": len(merged), "shards": stats,
           "truncated_lines": total_trunc}
    if align_stats is not None:
        out["align"] = align_stats
    return out


def find_shards(path: str) -> List[str]:
    """Every on-disk shard of a telemetry path: the base file (if
    written — single-process runs) plus any ``.pN`` siblings, sorted by
    process index."""
    out = []
    if os.path.exists(path):
        out.append(path)
    root, ext = os.path.splitext(path)
    ext = ext or ".jsonl"       # the same fallback shard_jsonl_path uses
    d = os.path.dirname(os.path.abspath(path)) or "."
    base = os.path.basename(root)
    try:
        names = os.listdir(d)
    except OSError:
        return out
    shards = []
    for n in names:
        r, e = os.path.splitext(n)
        if e == ext and r.startswith(base + ".p") \
                and r[len(base) + 2:].isdigit():
            shards.append((int(r[len(base) + 2:]), os.path.join(d, n)))
    out.extend(p for _, p in sorted(shards))
    return out

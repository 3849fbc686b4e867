"""Job spool IO: the filesystem submission protocol of the solve service.

Port of ``pcg_mpi_solver_tpu/serve/jobs.py``; a spool written by either
package is read by the other.  A spool directory holds::

    spool/incoming/<job>.json    submitted specs (atomic tmp + rename)
    spool/results/<job>.json     outcomes, always with a named verdict
    spool/results/<job>.npy      the solution column (solved jobs)
    spool/journal.jsonl          the crash-durable job journal

Submission is ``write tmp -> os.replace``, so the daemon's scan never
sees a half-written spec.  Results are written the same way, and always
before the journal's terminal record: a crash between the two replays as
"complete from the result", never as a second solve.

A job spec is a plain dict::

    {"job": "a1b2c3", "scale": 0.5, "deadline_s": 60.0}
    {"job": "a1b2c3", "rhs": "/path/loads.npy", "deadline_s": 60.0}

``scale`` scales the model's reference load vector F (``solve-many
--scales``); ``rhs`` names an (n_dof,) ``.npy`` column instead.
``deadline_s`` is relative at submission; admission turns it into the
absolute wall-clock deadline it prices against.

Imports neither torch nor numpy: ``submit`` and ``jobs`` work on a
machine without the accelerator environment.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

INCOMING_DIR = "incoming"
RESULTS_DIR = "results"
JOURNAL_FILE = "journal.jsonl"

#: The only keys a spec may carry (a typo'd key is rejected, not
#: smuggled past admission).
SPEC_KEYS = ("job", "scale", "rhs", "deadline_s", "submit_t")

DEFAULT_DEADLINE_S = 3600.0


def journal_path(spool: str) -> str:
    return os.path.join(spool, JOURNAL_FILE)


def incoming_dir(spool: str) -> str:
    return os.path.join(spool, INCOMING_DIR)


def results_dir(spool: str) -> str:
    return os.path.join(spool, RESULTS_DIR)


def ensure_spool(spool: str) -> None:
    os.makedirs(incoming_dir(spool), exist_ok=True)
    os.makedirs(results_dir(spool), exist_ok=True)


def new_job_id() -> str:
    return uuid.uuid4().hex[:12]


def write_json_atomic(path: str, obj: Any) -> None:
    """tmp + ``os.replace`` (atomic within a directory on POSIX): a reader
    never sees a torn file."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def check_spec(spec: Dict[str, Any]) -> Optional[str]:
    """The named ``bad_spec`` reason of a spec, or None when admissible:
    a reason the submitter can act on, never a daemon crash."""
    if not isinstance(spec, dict):
        return f"bad_spec: not an object ({type(spec).__name__})"
    unknown = sorted(set(spec) - set(SPEC_KEYS))
    if unknown:
        return f"bad_spec: unknown key(s) {', '.join(unknown)}"
    has_scale = isinstance(spec.get("scale"), (int, float))
    has_rhs = isinstance(spec.get("rhs"), str) and spec["rhs"]
    if has_scale == bool(has_rhs):
        return "bad_spec: exactly one of scale / rhs required"
    dl = spec.get("deadline_s", DEFAULT_DEADLINE_S)
    if not isinstance(dl, (int, float)) or dl <= 0:
        return f"bad_spec: deadline_s must be > 0 (got {dl!r})"
    return None


def submit(spool: str, spec: Dict[str, Any],
           submit_t: Optional[float] = None) -> str:
    """Drop one job spec into ``spool/incoming`` atomically; returns the
    job id (generated when the spec has none).  A spec admission would
    reject as ``bad_spec`` raises ValueError here, at submit time."""
    spec = dict(spec)
    spec.setdefault("job", new_job_id())
    spec.setdefault("deadline_s", DEFAULT_DEADLINE_S)
    spec["submit_t"] = float(time.time() if submit_t is None
                             else submit_t)
    err = check_spec(spec)
    if err:
        raise ValueError(f"submit: {err}")
    ensure_spool(spool)
    write_json_atomic(os.path.join(incoming_dir(spool),
                                   f"{spec['job']}.json"), spec)
    return spec["job"]


def list_incoming(spool: str) -> List[Tuple[str, Dict[str, Any]]]:
    """``(path, spec)`` for every incoming spec, oldest submission first,
    ties broken by job id (so the admission order, and with it the
    ``@job:`` fault ordinals, is deterministic).  An unreadable file comes
    back with ``spec=None``, for the daemon to reject by name."""
    d = incoming_dir(spool)
    try:
        names = sorted(n for n in os.listdir(d) if n.endswith(".json"))
    except OSError:
        return []
    out = []
    for name in names:
        path = os.path.join(d, name)
        try:
            with open(path, encoding="utf-8") as f:
                spec = json.load(f)
        except (OSError, ValueError):
            spec = None
        out.append((path, spec))
    out.sort(key=lambda ps: ((ps[1] or {}).get("submit_t", 0.0),
                             (ps[1] or {}).get("job", ps[0])))
    return out


def result_path(spool: str, job_id: str) -> str:
    return os.path.join(results_dir(spool), f"{job_id}.json")


def solution_path(spool: str, job_id: str) -> str:
    return os.path.join(results_dir(spool), f"{job_id}.npy")


def write_result(spool: str, job_id: str, result: Dict[str, Any]) -> None:
    """Atomic result drop.  Called before the journal's terminal record
    of the job: replay completes a dispatched job whose terminal record
    was lost from this file instead of solving it again."""
    ensure_spool(spool)
    write_json_atomic(result_path(spool, job_id), dict(result, job=job_id))


def read_result(spool: str, job_id: str) -> Optional[Dict[str, Any]]:
    try:
        with open(result_path(spool, job_id), encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None

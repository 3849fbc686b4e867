"""Group-agreed verdicts for multi-process control flow.

Port of ``pcg_mpi_solver_tpu/parallel/consensus.py``.  Every host-side
branch that sits next to a collective is a divergence hazard across
processes: if rank 0 decides "retry" while rank 1 decides "give up", the
next collective pairs a live rank against a missing one and the group
wedges.  The engage agreement of the sharded setup (``solver/driver.py``),
the warm/cold agreement of the partition cache
(``cache/partition_cache.py``) and the recovery ladder
(``resilience/engine.py``) route through this module, so no rank takes a
divergent branch across a collective.

The mechanics are deliberately tiny: each rank encodes its local
verdict as a small int64 vector, one packed allreduce (HostComm packs
into a single int32 gather buffer) reduces it with ``min`` or ``max``,
and every rank decodes the SAME agreed vector.  ``min`` expresses
"all ranks must be able" (warm cache, shard write landed); ``max``
expresses "any rank's alarm wins" (breakdown triggers, where the
highest-priority local trigger must drive every rank's ladder).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

__all__ = ["agree", "agree_flag", "agree_trigger", "agree_triggers",
           "encode_trigger", "decode_trigger"]

# Trigger encoding for ladder consensus: 0 = no trigger; breakdown
# flags outrank the carry/device classes under a max-reduce because a
# flagged breakdown carries more diagnostic information than the
# generic classes — every rank recovers, and the agreed event names
# the most specific cause any rank observed.
_TRIGGER_CODES = {"device_loss": 1, "nan_carry": 2}
_FLAG_BASE = 10


def _has_group(comm) -> bool:
    return comm is not None and getattr(comm, "n_procs", 1) > 1


def agree(comm, local, op: str = "min") -> np.ndarray:
    """Reduce each rank's local int verdict vector into the group-agreed
    vector (every rank returns the identical array).  ``comm`` is any
    HostComm-shaped object (``allreduce_groups`` + ``n_procs``); a None
    comm or a single-process group is the identity — callers never need
    a serial special case."""
    arr = np.asarray(local, dtype=np.int64).reshape(-1)
    if not _has_group(comm):
        return arr.copy()
    (agreed,), = comm.allreduce_groups([([arr], op)])
    return np.asarray(agreed, dtype=np.int64).reshape(arr.shape)


def agree_flag(comm, ok) -> bool:
    """All-ranks-agree boolean (min-reduce): True only when EVERY rank's
    local verdict is True — the engage/warm-cache agreement shape."""
    return bool(int(agree(comm, [1 if ok else 0], "min")[0]))


def encode_trigger(trigger: Optional[str]) -> int:
    """Ladder trigger -> consensus code (None = 0 = no recovery)."""
    if trigger is None:
        return 0
    if trigger in _TRIGGER_CODES:
        return _TRIGGER_CODES[trigger]
    if trigger.startswith("flag"):
        return _FLAG_BASE + int(trigger[len("flag"):])
    raise ValueError(f"unknown ladder trigger {trigger!r}")


def decode_trigger(code) -> Optional[str]:
    """Consensus code -> ladder trigger (inverse of encode_trigger)."""
    code = int(code)
    if code == 0:
        return None
    for name, c in _TRIGGER_CODES.items():
        if c == code:
            return name
    if code >= _FLAG_BASE:
        return f"flag{code - _FLAG_BASE}"
    raise ValueError(f"unknown trigger code {code}")


def agree_trigger(comm, trigger: Optional[str]) -> Optional[str]:
    """Group-agreed scalar ladder trigger: max-reduce of the encoded
    local triggers, so one rank's breakdown drives every rank's ladder
    in lockstep (and the agreed trigger is the most specific one any
    rank observed)."""
    return decode_trigger(agree(comm, [encode_trigger(trigger)], "max")[0])


def agree_triggers(comm, triggers: Dict[int, Optional[str]],
                   width: int) -> Dict[int, str]:
    """Group-agreed per-column triggers of a blocked multi-RHS solve:
    one packed max-reduce over all ``width`` columns, returning only the
    columns with an agreed trigger (the shape
    ``run_many_with_recovery`` consumes)."""
    vec = np.zeros(int(width), dtype=np.int64)
    for k, trig in triggers.items():
        vec[int(k)] = encode_trigger(trig)
    agreed = agree(comm, vec, "max")
    return {k: decode_trigger(c) for k, c in enumerate(agreed) if c}

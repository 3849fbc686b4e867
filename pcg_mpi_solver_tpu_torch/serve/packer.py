"""nrhs block packer: co-batch queued jobs into standard block widths.

Port of ``pcg_mpi_solver_tpu/serve/packer.py``.  The service packs from a
small set of standard widths: in the JAX package each width is one
compiled program; in the port each width is one set of blocked device
trees (``parallel/structured.py::block_data``, ck repeated a column),
so a few widths keep the set small.

Packing is FIFO by admission ordinal: admission already priced every
admitted job's deadline as feasible, and arrival order cannot starve a
job.  Imports neither torch nor numpy.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

#: Default standard block widths.  1 is always a member: a lone pending
#: job must be packable.
STANDARD_WIDTHS = (1, 2, 4, 8)


def normalize_widths(widths: Sequence[int]) -> tuple:
    """Sorted, deduplicated widths >= 1, with 1 forced in (a width set
    without it would strand a single pending job)."""
    return tuple(sorted({int(w) for w in widths if int(w) >= 1} | {1}))


def pick_width(n_pending: int, widths: Sequence[int] = STANDARD_WIDTHS
               ) -> int:
    """The largest standard width <= the pending count (0 when idle)."""
    if n_pending <= 0:
        return 0
    return max(w for w in normalize_widths(widths) if w <= n_pending)


def pack_block(queue: List[Dict[str, Any]],
               widths: Sequence[int] = STANDARD_WIDTHS
               ) -> List[Dict[str, Any]]:
    """Pop the next block off the admission queue: the ``pick_width``
    oldest entries by admission ordinal.  Mutates ``queue`` (the daemon
    journals the popped entries as ``packed``)."""
    w = pick_width(len(queue), widths)
    if w == 0:
        return []
    queue.sort(key=lambda e: e["ordinal"])
    block = queue[:w]
    del queue[:w]
    return block

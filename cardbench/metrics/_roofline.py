"""The least time one K·p can take on a card.

The count belongs to the mesh, not to the implementation: x is read once
and y written once (n_dof values each), each element's stiffness scale
once a call (a block of R columns reads it once, not R times), each
pattern type's unit matrix once, and no connectivity; the operations are
2 * 24 * 24 multiply-adds' worth per element per column.  The time is the
larger of the bytes over the card's memory bandwidth and the operations
over the rate that keeps the dtype's accuracy: float32 as 3xTF32 on the
tensor cores (three TF32 products a product), float64 on the FP64 tensor
cores.  No kernel can beat it, so a share of it cannot pass 100 %.

Peaks: NVIDIA's H100 SXM data sheet (dense, 700 W), by the name
``torch.cuda.get_device_name()`` gives; an unknown card has no bound.
"""

from __future__ import annotations

from typing import Optional

#: card name -> bytes/s of HBM, TF32 and FP64 tensor-core operations/s
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bw": 3.35e12, "tf32_tc": 495e12,
                              "fp64_tc": 67e12},
}


def matvec_counts(n_dof: int, n_elem: int, ke_entries: int,
                  itemsize: int, R: int = 1) -> dict:
    """Bytes and operations of one K·p over R columns."""
    nbytes = itemsize * (2 * n_dof * R + n_elem + ke_entries)
    return {"bytes": nbytes, "ops": 2 * 24 * 24 * n_elem * R}


def bound_s(counts: dict, itemsize: int, device_kind: str) -> Optional[dict]:
    """{"s": least seconds, "by": "bytes"|"operations", "bytes_s",
    "ops_s"}, or None for a card without peaks."""
    peak = PEAKS.get(device_kind)
    if peak is None:
        return None
    t_bytes = counts["bytes"] / peak["bw"]
    rate = peak["tf32_tc"] / 3 if itemsize == 4 else peak["fp64_tc"]
    t_ops = counts["ops"] / rate
    return {"s": max(t_bytes, t_ops),
            "by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_s": t_bytes, "ops_s": t_ops}

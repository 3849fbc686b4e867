"""The parts "mesh" of the port: which process holds which parts.

Port of ``pcg_mpi_solver_tpu/parallel/mesh.py``.  The JAX package's mesh
is a 1-D ``jax.sharding.Mesh`` over devices, with ``(P, ...)`` arrays
split along their leading parts axis.  In the port every part of one
process lives on that process's one device, so the mesh is a small
descriptor of the ``torch.distributed`` group: its world size, this
process's rank, the device the rank computes on, and the group's
collectives (``parallel/distributed.Group``).  Rank ``r`` of ``W`` holds
the contiguous block of parts ``[r * P / W, (r + 1) * P / W)``.  With one
process it is the identity: every part on the one device and no
collective.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

PARTS_AXIS = "parts"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``world`` processes, this one ``rank``; ``device`` the device the
    rank computes on (None: the solver's default); ``group`` the
    collectives (None with one process)."""

    world: int = 1
    rank: int = 0
    device: Optional[str] = None
    group: Optional[object] = dataclasses.field(default=None, compare=False,
                                                repr=False)

    def part_range(self, n_parts: int):
        """This rank's contiguous ``[lo, hi)`` block of ``n_parts`` parts.
        A part count the world size does not divide raises."""
        if n_parts % self.world != 0:
            raise ValueError(f"n_parts={n_parts} must be a multiple of the "
                             f"process count {self.world}")
        ppr = n_parts // self.world
        return self.rank * ppr, (self.rank + 1) * ppr


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The mesh of this process group (``make_global_mesh``): one process
    without ``torch.distributed``.  ``n_devices``, when given, must be the
    group's size."""
    from pcg_mpi_solver_tpu_torch.parallel.distributed import (
        make_global_mesh)

    mesh = make_global_mesh()
    if n_devices is not None and n_devices != mesh.world:
        raise ValueError(f"requested {n_devices} devices, the process "
                         f"group has {mesh.world}")
    return mesh


def part_spec() -> str:
    """Leading-axis split: arrays are ``(P, ...)``, each rank holding its
    block of the parts."""
    return PARTS_AXIS

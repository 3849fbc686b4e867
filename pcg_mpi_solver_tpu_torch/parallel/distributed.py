"""Multi-process support over ``torch.distributed``.

Port of ``pcg_mpi_solver_tpu/parallel/distributed.py``.  The reference
scales across nodes with mpi4py: tagged point-to-point halo messages and
allreduces (pcg_solver.py:317-334, 622-628).  The JAX package runs one
multi-controller program over a mesh that spans every process.  The port
runs one process a rank, joined by ``torch.distributed`` with the gloo
backend over TCP, each rank computing its contiguous block of parts on
``cuda:(rank % device_count)`` (or on the CPU when the caller asks):

- :func:`init_distributed` — the bootstrap, from explicit arguments or
  ``PCG_TPU_COORDINATOR`` / ``PCG_TPU_NUM_PROCS`` / ``PCG_TPU_PROC_ID``;
  without either it is a single-process no-op;
- :func:`make_global_mesh` — the ``parallel.mesh.Mesh`` of the group;
- :class:`Group` — the collectives of the solve: the sum of the scalar
  reductions and of the interface vector (:meth:`Group.psum`), the
  slab-boundary plane exchange of the structured halo
  (:meth:`Group.exchange_planes`) and the row gathers of the global views,
  each counted in :attr:`Group.counts`;
- :func:`local_view` — a partition cut to one rank's parts, the host data
  its device tree is built from;
- :func:`put_sharded` / :func:`put_tree` — each rank uploads only its rows;
  :func:`fetch_global` / :func:`gather_owned_global` gather every rank's
  rows to every rank; :func:`fetch_addressable` returns the rank's own
  rows without a collective;
- :class:`HostComm` — the host-side reduction group of the sharded setup
  (the packed int32 exchange of ``parallel/partition.py``).

Every collective runs on host tensors: a device tensor is copied to the
host (the halo planes through pinned buffers), reduced or exchanged by
gloo, and copied back, the same code on the CPU and on the card.  A sum
over ranks is an all-gather followed by a sum in rank order, so every
rank holds the same bits.  A collective that fails raises.
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import os
import time
from typing import Optional

import numpy as np
import torch

from pcg_mpi_solver_tpu_torch.parallel.mesh import Mesh

_group: Optional["Group"] = None


def _dist():
    import torch.distributed as dist

    return dist


def process_count() -> int:
    """The size of the initialised group (1 without one)."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    """This process's rank (0 without a group)."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> int:
    """Join the gloo process group of a multi-process run; returns this
    process's rank.

    Resolution order: explicit arguments > ``PCG_TPU_COORDINATOR``
    (``host:port`` of rank 0) / ``PCG_TPU_NUM_PROCS`` / ``PCG_TPU_PROC_ID``
    > single-process no-op.  Safe to call repeatedly.  Every gloo operation
    is bounded by ``PCG_TPU_COLLECTIVE_DEADLINE_S`` (else 600 s), so a
    wedged peer raises instead of blocking forever.  The group is
    destroyed at interpreter exit, before the C++ teardown: left to that
    teardown, gloo's threads can abort a rank that finished cleanly."""
    coordinator_address = (coordinator_address
                           or os.environ.get("PCG_TPU_COORDINATOR"))
    if num_processes is None and os.environ.get("PCG_TPU_NUM_PROCS"):
        num_processes = int(os.environ["PCG_TPU_NUM_PROCS"])
    if process_id is None and os.environ.get("PCG_TPU_PROC_ID"):
        process_id = int(os.environ["PCG_TPU_PROC_ID"])
    dist = _dist()
    if dist.is_initialized():
        return dist.get_rank()
    if coordinator_address is None and num_processes is None:
        return 0
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "init_distributed needs the coordinator address, the process "
            "count and this process's id (arguments or PCG_TPU_COORDINATOR"
            " / PCG_TPU_NUM_PROCS / PCG_TPU_PROC_ID)")
    env = os.environ.get("PCG_TPU_COLLECTIVE_DEADLINE_S", "").strip()
    timeout_s = float(env) if env else 600.0
    addr = coordinator_address
    if not addr.startswith("tcp://"):
        addr = "tcp://" + addr
    dist.init_process_group(
        "gloo", init_method=addr, world_size=int(num_processes),
        rank=int(process_id),
        timeout=datetime.timedelta(seconds=max(float(timeout_s), 1.0)))
    atexit.register(_destroy_at_exit)
    return dist.get_rank()


def _destroy_at_exit() -> None:
    global _group
    dist = _dist()
    if dist.is_initialized():
        _group = None
        dist.destroy_process_group()


def group() -> Optional["Group"]:
    """The collectives of the initialised group, or None with one
    process."""
    global _group
    if process_count() <= 1:
        return None
    if _group is None:
        _group = Group()
    return _group


def make_global_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The 1-D parts mesh over every process of the group: rank ``r``
    computes on ``cuda:(r % device_count)``.  ``n_devices`` (the JAX
    package's cut of the device list) must be the group's size."""
    W, r = process_count(), process_index()
    if n_devices is not None and n_devices != W:
        raise ValueError(f"n_devices={n_devices}: the process group has {W}")
    if W == 1:
        return Mesh()
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return Mesh(world=W, rank=r, device=f"cuda:{r % max(n, 1)}",
                group=group())


def local_part_range(mesh: Optional[Mesh], n_parts: int):
    """The contiguous ``[lo, hi)`` block of parts this process holds, or
    None when the world size does not divide ``n_parts``.  One process:
    the full range."""
    if mesh is None or mesh.world == 1:
        return (0, n_parts)
    if n_parts % mesh.world != 0:
        return None
    return mesh.part_range(n_parts)


@dataclasses.dataclass
class Group:
    """The collectives of one solve over the default process group.

    ``counts`` tallies what ran: ``all_reduce`` (sums over ranks, scalar
    or interface), ``halo`` (plane exchanges), ``halo_msgs`` and
    ``halo_bytes`` (their messages and the bytes this rank sent),
    ``all_gather`` (row gathers of the global views); ``wait_s`` the host
    seconds spent inside them.  ``recorder``, when set, receives the same
    counts as ``comm.*`` counters.  ``guard``, when set (a
    ``resilience/distributed.GuardedComm``), runs each collective under
    its deadline watchdog and names a dead peer (``DeadPeerError``)."""

    world: int = 0
    rank: int = 0
    counts: dict = dataclasses.field(default_factory=dict)
    wait_s: float = 0.0
    recorder: Optional[object] = None
    guard: Optional[object] = None

    def __post_init__(self):
        dist = _dist()
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()
        self._pinned = {}
        self.reset_counts()

    def reset_counts(self) -> None:
        self.counts = {"all_reduce": 0, "halo": 0, "halo_msgs": 0,
                       "halo_bytes": 0, "all_gather": 0}
        self.wait_s = 0.0

    def _run(self, label: str, fn):
        """``fn()`` timed into ``wait_s``, under the guard when set."""
        t0 = time.perf_counter()
        try:
            if self.guard is not None:
                return self.guard._guarded(label, fn)
            return fn()
        finally:
            self.wait_s += time.perf_counter() - t0

    def _count(self, name: str, n: int = 1) -> None:
        self.counts[name] += n
        if self.recorder is not None:
            self.recorder.inc(f"comm.{name}", n)

    def _host(self, t: torch.Tensor, slot: Optional[str] = None
              ) -> torch.Tensor:
        """``t`` as a contiguous host tensor: a copy into a pinned buffer
        (kept per ``slot``) for a device tensor, else ``t`` itself."""
        if t.device.type == "cpu":
            return t.contiguous()
        if slot is None:
            return t.to("cpu")
        key = (slot, tuple(t.shape), t.dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._pinned[key] = buf
        buf.copy_(t)
        return buf

    def _buffer(self, like: torch.Tensor, slot: str) -> torch.Tensor:
        """A host receive buffer shaped as ``like``, pinned for a device
        tensor."""
        if like.device.type == "cpu":
            return torch.empty(like.shape, dtype=like.dtype)
        key = (slot, tuple(like.shape), like.dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            self._pinned[key] = buf
        return buf

    def gather(self, t: torch.Tensor) -> list:
        """Every rank's ``t`` (same shape on all), as host tensors in rank
        order."""
        dist = _dist()
        h = self._host(t)
        out = [torch.empty_like(h) for _ in range(self.world)]
        self._run("all_gather", lambda: dist.all_gather(out, h))
        return out

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over ranks, the same bits on every rank (an
        all-gather, then a sum in rank order), on ``t``'s device."""
        self._count("all_reduce")
        parts = self.gather(t)
        acc = parts[0].clone()
        for p in parts[1:]:
            acc += p
        return acc.to(t.device)

    def exchange_planes(self, to_left: torch.Tensor, to_right: torch.Tensor):
        """The slab-boundary exchange of one halo: ``to_left`` goes to rank
        - 1 and ``to_right`` to rank + 1; returns ``(from_left,
        from_right)``, what those neighbours sent (None past either end).
        Two messages a rank boundary, staged through pinned host buffers
        on the card."""
        dist = _dist()
        self._count("halo")
        r, W = self.rank, self.world
        reqs, got = [], {}
        if r > 0:
            h = self._host(to_left, "send_l")
            reqs.append(dist.isend(h, r - 1, tag=1))
            got["l"] = self._buffer(to_left, "recv_l")
            reqs.append(dist.irecv(got["l"], r - 1, tag=2))
            self._count("halo_msgs")
            self._count("halo_bytes", h.numel() * h.element_size())
        if r < W - 1:
            h = self._host(to_right, "send_r")
            reqs.append(dist.isend(h, r + 1, tag=2))
            got["r"] = self._buffer(to_right, "recv_r")
            reqs.append(dist.irecv(got["r"], r + 1, tag=1))
            self._count("halo_msgs")
            self._count("halo_bytes", h.numel() * h.element_size())
        def wait():
            for q in reqs:
                q.wait()

        self._run("halo", wait)
        dev = to_left.device
        return (got["l"].to(dev) if "l" in got else None,
                got["r"].to(dev) if "r" in got else None)

    def gather_rows(self, t: torch.Tensor) -> np.ndarray:
        """Every rank's rows of a ``(P_loc, ...)`` tensor stacked in rank
        order: the global ``(P, ...)`` host array."""
        self._count("all_gather")
        return torch.cat(self.gather(t), dim=0).numpy()

    def allgather_np(self, arr: np.ndarray) -> np.ndarray:
        """``(world, *arr.shape)``: every rank's host array (same shape and
        dtype on all)."""
        a = np.ascontiguousarray(arr)
        if a.dtype == np.bool_:
            return self.allgather_np(a.astype(np.uint8)).astype(np.bool_)
        return torch.stack(self.gather(torch.from_numpy(a))).numpy()

    def barrier(self) -> None:
        self._run("barrier", _dist().barrier)


# ----------------------------------------------------------------------
# A partition cut to one rank's parts
# ----------------------------------------------------------------------

# per-part fields whose leading axis is not the parts axis
_SHARED_FIELDS = frozenset({"elem_part", "Ke", "diag_Ke", "Se", "Me",
                            "brick_Ke", "brick_diag", "brick_Se", "type_N",
                            "layout"})


def _slice_obj(obj, P: int, lo: int, hi: int):
    """Copy of a dataclass with every ``(P, ...)`` array cut to rows
    ``[lo, hi)``, recursing into lists and dataclasses."""
    if isinstance(obj, np.ndarray):
        return obj[lo:hi] if obj.ndim and obj.shape[0] == P else obj
    if isinstance(obj, list):
        return [_slice_obj(v, P, lo, hi) for v in obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        kw = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            kw[f.name] = v if f.name in _SHARED_FIELDS \
                else _slice_obj(v, P, lo, hi)
        if "n_parts" in kw:
            kw["n_parts"] = hi - lo
        return type(obj)(**kw)
    return obj


def local_view(part, lo: int, hi: int):
    """``part`` (a ``PartitionedModel``, ``StructuredPartition`` or
    ``HybridPartition``) with its parts axis cut to ``[lo, hi)``:
    ``n_parts = hi - lo``, every per-part array (type blocks, level grids
    and combine maps included) its rows ``[lo, hi)``; the global sizes and
    ids (``n_iface``, ``glob_n_dof``, interface slots) are unchanged, so
    the interface sums run over global ids.  The full range returns
    ``part`` itself."""
    from pcg_mpi_solver_tpu_torch.parallel.hybrid import HybridPartition

    P = int(part.n_parts)
    if (lo, hi) == (0, P):
        return part
    if not (0 <= lo < hi <= P):
        raise ValueError(f"part range ({lo}, {hi}) outside [0, {P})")
    if isinstance(part, HybridPartition):   # its pm, levels and combine
        return dataclasses.replace(
            part, pm=local_view(part.pm, lo, hi),
            levels=_slice_obj(part.levels, P, lo, hi),
            combine=_slice_obj(part.combine, P, lo, hi))
    out = _slice_obj(part, P, lo, hi)
    if hasattr(out, "part_range"):
        out.part_range = (0, hi - lo)
    return out


# ----------------------------------------------------------------------
# Uploads and global views
# ----------------------------------------------------------------------

def _rows(mesh: Optional[Mesh], n_parts: int):
    lo_hi = local_part_range(mesh, n_parts)
    if lo_hi is None:
        raise ValueError(f"n_parts={n_parts} must be a multiple of the "
                         f"process count {mesh.world}")
    return lo_hi


def put_sharded(x: np.ndarray, mesh: Optional[Mesh], spec=None,
                device=None, dtype=None) -> torch.Tensor:
    """Host ``(P, ...)`` array -> this rank's rows ``[lo, hi)`` as a tensor
    on ``device``: the mesh's when None, else the card (``resolve_device``:
    no card raises; the CPU only when the caller passes ``"cpu"``).
    ``spec`` None or the parts axis splits the leading axis; any other
    spec (``()``: replicated) uploads the whole array."""
    from pcg_mpi_solver_tpu_torch.solver.driver import resolve_device

    a = np.asarray(x)
    if spec in (None, "parts") and a.ndim:
        lo, hi = _rows(mesh, a.shape[0])
        a = a[lo:hi]
    if device is None and mesh is not None:
        device = mesh.device
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                           device=resolve_device(device))


def put_tree(tree, mesh: Optional[Mesh], specs=None, device=None):
    """:func:`put_sharded` over nested dicts / lists of arrays with a
    matching tree of specs (None leaves pass through)."""
    def rec(t, s):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: rec(v, None if s is None else s[k])
                    for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(rec(v, None if s is None else s[i])
                           for i, v in enumerate(t))
        return put_sharded(t, mesh, s, device=device)

    return rec(tree, specs)


def fetch_global(x, mesh: Optional[Mesh] = None) -> np.ndarray:
    """This rank's ``(P_loc, ...)`` rows -> the global ``(P, ...)`` host
    array, gathered to every rank (the reference's gather-to-rank-0
    exports, pcg_solver.py:910-911).  One process: a plain copy."""
    if isinstance(x, torch.Tensor):
        if mesh is None or mesh.world == 1:
            return x.detach().cpu().numpy()
        return mesh.group.gather_rows(x.detach())
    a = np.asarray(x)
    if mesh is None or mesh.world == 1:
        return a
    return mesh.group.gather_rows(torch.from_numpy(np.ascontiguousarray(a)))


def fetch_addressable(x, mesh: Optional[Mesh] = None) -> tuple:
    """This rank's rows of a parts-split tensor with their global part
    range: ``(rows, p0, p1)``.  No collective (each rank writes its own
    block of a result, the reference's MPI-IO writes at computed offsets,
    file_operations.py:348-396)."""
    rows = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)
    n = rows.shape[0]
    if mesh is None or mesh.world == 1:
        return rows, 0, n
    return rows, mesh.rank * n, (mesh.rank + 1) * n


def gather_owned_global(pm, x, mesh: Optional[Mesh] = None,
                        dtype=None) -> np.ndarray:
    """``(P_loc, n_loc[, R])`` part-local rows (a trailing block axis
    rides through) -> the global ``(glob_n_dof[, R])`` host array through
    the owner mask of ``pm`` (the full partition, whose export rows cover
    every part), gathered to every rank: one fetch, one masked
    scatter."""
    full = fetch_global(x, mesh)
    out = np.zeros((pm.glob_n_dof,) + full.shape[2:],
                   dtype=dtype or full.dtype)
    m = (pm.weight > 0) & (pm.dof_gid >= 0)
    out[pm.dof_gid[m]] = full[m]
    return out


# ----------------------------------------------------------------------
# The host reduction group of the sharded setup
# ----------------------------------------------------------------------

class HostComm:
    """Host-side reduction group over the processes of the run: the
    multi-process twin of ``parallel/partition.SerialComm``, built on an
    all-gather and a numpy reduce, so arbitrary host arrays (the layout's
    count and owner vectors) ride the same fabric.  Every process must
    call in the same order with same-shaped arrays."""

    _OPS = {"sum": np.sum, "min": np.min, "max": np.max}

    #: chunk length (int32 entries) of the chunked gather-reduce path:
    #: 4M entries = 16 MB a process-copy a chunk
    CHUNK = 1 << 22

    def __init__(self):
        self.n_procs = process_count()
        self.index = process_index()

    def _allgather(self, arr: np.ndarray) -> np.ndarray:
        return group().allgather_np(arr)

    def allreduce(self, arr: np.ndarray, op: str) -> np.ndarray:
        arr = np.asarray(arr)
        if self.n_procs == 1:
            return arr
        return self._OPS[op](self._allgather(arr), axis=0).astype(arr.dtype)

    def allreduce_many(self, arrs, op: str):
        """Several same-op reductions in ONE collective."""
        return self.allreduce_groups([(arrs, op)])[0]

    def allreduce_groups(self, groups):
        """Differently-reduced array groups in ONE collective, packed as
        int32 (every layout-exchange value fits by design; the dtype must
        be the same on every process, so an out-of-range value raises
        ``OverflowError`` instead of widening on one process).  Above
        :attr:`CHUNK` entries the gather-reduce runs chunk by chunk, so
        the transient stays ``n_procs * CHUNK``."""
        groups = [([np.asarray(a) for a in arrs], op)
                  for arrs, op in groups]
        if self.n_procs == 1:
            return [arrs for arrs, _ in groups]
        flats = [a.astype(np.int64).ravel()
                 for arrs, _ in groups for a in arrs]
        flat = (np.concatenate(flats) if flats
                else np.zeros(0, np.int64))
        if flat.size and (int(flat.max()) > 2 ** 31 - 1
                          or int(flat.min()) < -(2 ** 31)):
            raise OverflowError(
                "HostComm.allreduce_groups: a layout-exchange value "
                "exceeds int32 — the packed exchange protocol assumes "
                "counts/owners/per-part sizes below 2^31; widen the "
                "protocol deliberately rather than per-process")
        flat = flat.astype(np.int32)
        red_flat = None
        if flat.size <= self.CHUNK:
            gathered = self._allgather(flat).astype(np.int64)
        else:
            red_flat = np.empty(flat.size, np.int64)
            pos_c = 0
            while pos_c < flat.size:
                n = min(self.CHUNK, flat.size - pos_c)
                buf = np.zeros(self.CHUNK, np.int32)
                buf[:n] = flat[pos_c:pos_c + n]
                g = self._allgather(buf)
                for seg_pos, seg_n, op in self._segments(groups):
                    lo = max(seg_pos, pos_c)
                    hi = min(seg_pos + seg_n, pos_c + n)
                    if lo < hi:
                        red_flat[lo:hi] = self._OPS[op](
                            g[:, lo - pos_c:hi - pos_c], axis=0)
                pos_c += n
        out, pos = [], 0
        for arrs, op in groups:
            red_arrs = []
            for a in arrs:
                n = int(a.size)
                if red_flat is not None:
                    red = red_flat[pos:pos + n]
                else:
                    red = self._OPS[op](gathered[:, pos:pos + n], axis=0)
                red_arrs.append(red.reshape(a.shape).astype(a.dtype))
                pos += n
            out.append(red_arrs)
        return out

    def allgather(self, arr: np.ndarray) -> np.ndarray:
        """``(n_procs, *arr.shape)``: every process's array."""
        arr = np.asarray(arr)
        if self.n_procs == 1:
            return arr[None]
        return self._allgather(arr)

    @staticmethod
    def _segments(groups):
        """(pos, size, op) spans of the packed buffer, one per array."""
        pos = 0
        for arrs, op in groups:
            for a in arrs:
                n = int(np.asarray(a).size)
                yield pos, n, op
                pos += n

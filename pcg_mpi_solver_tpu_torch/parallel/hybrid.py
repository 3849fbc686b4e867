"""Hybrid level-grid backend: octree meshes as sparse unions of structured
grids.

Port of ``pcg_mpi_solver_tpu/parallel/hybrid.py``.  In a graded octree
most cells are pure 8-node "bricks" of some refinement level; only the
level-interface transition cells carry hanging nodes.  This backend:

- places each level's brick cells on dense 8^3-cell blocks (or one dense
  bounding-box block where that is no larger), with ``ck = 0`` holes
  where the level has no brick (a zero-stiffness cell adds nothing);
- gathers each level's node lattice once a matvec, component-major, as a
  batch of (3, bx+1, by+1, bz+1) slabs, and runs the port's hand-written
  slab kernel on it (``ops/structured_matvec.py::structured_matvec``):
  float32 on the Solver's selected variant, float64 on v6's double
  kernel, the plain version on the CPU;
- adds the levels' node-grid outputs into the local rows through the
  partition-built slot -> node maps (:class:`CombineMaps`): KD row gathers
  for every node, then the few heavy nodes' remaining slots, written with
  one ``index_copy`` over distinct rows, so no float atomics and the same
  bits on every run (``PCG_TPU_HYBRID_COMBINE=scatter`` is the JAX
  package's A/B arm: an ``index_add_`` per level, whose float atomics do
  not repeat bitwise on the card, as JAX's ``at[].add`` is unordered);
- keeps only the transition cells on the general operator
  (``partition_model(block_filter=...)`` drops the bricks from its type
  blocks).

The JAX package sends a level to Pallas only while parts x blocks stay
within ``PALLAS_BATCH_CAP`` = 16, because its wrapper launches once per
batch entry; the port's wrapper launches once over the whole leading
axis, so every level is ONE launch over its P * nb blocks (R * P * nb for
a block of R right-hand sides), at any nb.  ``hybrid_pallas_enabled``,
``pallas_levels``, ``pallas_interpret`` and the XLA stencil forms
(``gse``, ``gsplit``, ``corner``) have no counterpart: the port has no
probe, no XLA stencil and no fallback.  The export half (``elem_strain``,
``elem_scale``, ``nodal_average``) runs the transition buckets as the
general backend does and each level as a slab (``brick_Se`` on the
gathered node lattices; node sums as the eight corner translates, holes
masked out), the levels' sums added through the same combine.

A lattice point of a level grid that is not a local mesh node maps to the
pad row: its gathered value (0) multiplies only cells with ck = 0, and
its output is dropped, because every corner of a brick is a local node.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pcg_mpi_solver_tpu_torch.models.model_data import ModelData
from pcg_mpi_solver_tpu_torch.ops.matvec import Ops, device_data
from pcg_mpi_solver_tpu_torch.ops.precond import corner_block_field
from pcg_mpi_solver_tpu_torch.ops.structured_matvec import (
    CORNERS, gather_cells, scatter_cells, structured_matvec)
from pcg_mpi_solver_tpu_torch.parallel.partition import (
    PartitionedModel, make_elem_part, partition_model)

# corner offsets in the brick type's node order (models/element.py
# HEX_CORNERS, the slab stencil's corner order)
_CORNERS = np.asarray(CORNERS, dtype=np.int64)


@dataclasses.dataclass
class LevelGrid:
    """One refinement level's brick cells as a batch of dense blocks: the
    level's bbox tiled into bs^3-cell blocks of which only those holding a
    brick are kept, or one dense-bbox block (nb == 1) where that is no
    larger.  Parts are padded to a common block count nb; padding blocks
    have ck = 0 and nidx = pad."""

    size: int                   # cell edge in finest-lattice units (0 =
                                # merged multi-size batch, PCG_TPU_HYBRID_MERGE)
    nb: int                     # blocks per part (common, padded)
    bx: int                     # per-block cell dims
    by: int
    bz: int
    origin: np.ndarray          # (P, nb, 3) block origin in level units
    ck: np.ndarray              # (P, nb, bx, by, bz); 0 = hole
    ce: np.ndarray              # (P, nb, bx, by, bz)
    nidx: np.ndarray            # (P, nb, (bx+1)*(by+1)*(bz+1)) int32 local
                                # node ids, n_node_loc = pad
    n_cells: np.ndarray         # (P,) brick count per part


@dataclasses.dataclass
class CombineMaps:
    """Slot -> node gather-combine maps: every level's lattice slots sorted
    by target node at partition time.  Slots are numbered per part, levels
    in list order, each level flat over (block, lattice position) as its
    ``nidx``; ``n_slots`` is the pad slot (a zero row)."""

    n_slots: int                # slots a part, over all levels
    gidx: np.ndarray            # (P, n_node_loc, KD) int32 slot ids
    hnode: np.ndarray           # (P, H) int32 heavy node ids (pad n_node_loc)
    hgidx: np.ndarray           # (P, H, KE) int32 slot ids


@dataclasses.dataclass
class HybridPartition:
    """The general partition (transition cells only in its type blocks)
    plus the per-level brick grids; attribute reads fall through to
    ``pm``."""

    pm: PartitionedModel
    levels: List[LevelGrid]
    brick_Ke: np.ndarray        # (24, 24) unit brick stiffness
    brick_diag: np.ndarray      # (24,)
    brick_Se: Optional[np.ndarray]  # (6, 24)
    combine: Optional[CombineMaps] = None

    def __getattr__(self, name):
        # 'pm' and dunders: during unpickling or a deep copy the object
        # exists before its __dict__, and delegating would recurse
        if name == "pm" or name.startswith("__"):
            raise AttributeError(name)
        return getattr(self.pm, name)


def can_hybrid(model: ModelData) -> bool:
    """Hybrid-backend eligibility: octree lattice metadata with a brick
    type."""
    return (model.octree is not None
            and model.octree.get("brick_type") is not None)


def partition_hybrid(model: ModelData, n_parts: int,
                     elem_part: Optional[np.ndarray] = None,
                     method: str = "rcb") -> HybridPartition:
    """The JAX package's ``partition_hybrid``, array for array: the
    block-filtered general partition, then each brick level's grids
    (tiled or dense bbox, ``PCG_TPU_HYBRID_BLOCK``; merged into one batch
    under ``PCG_TPU_HYBRID_MERGE=1``) and the combine maps."""
    if not can_hybrid(model):
        raise ValueError("model has no octree/brick metadata for the "
                         "hybrid backend")
    meta = model.octree
    bt = meta["brick_type"]
    leaves = np.asarray(meta["leaves"])
    # node_keys[i] is node i's lattice key; sort once and keep the id
    # permutation (a model need not number its nodes in key order)
    raw_keys = np.asarray(meta["node_keys"])
    key_order = np.argsort(raw_keys)
    node_keys = raw_keys[key_order]
    sy, sz = meta["strides"]
    corners = np.asarray(meta["brick_corners"], dtype=np.int64)
    if not np.array_equal(corners, _CORNERS):
        raise ValueError("brick corner order does not match the level-grid "
                         "stencil's corner order")

    brick = model.elem_type == bt
    if elem_part is None:
        elem_part = make_elem_part(model, n_parts, method=method)
    pm = partition_model(model, n_parts, elem_part=elem_part,
                         block_filter=~brick)

    P = n_parts
    knobs = partition_env_knobs()
    bs_knob = knobs["block"]
    merge = knobs["merge"]
    sizes = sorted(int(v) for v in np.unique(leaves[brick, 3]))
    level_sel = []
    for s in sizes:
        sel_lvl = brick & (leaves[:, 3] == s)
        per_part = [np.where(sel_lvl & (elem_part == p))[0]
                    for p in range(P)]
        # level-unit cell coords (cells of size s are s-aligned)
        lat = [leaves[e, :3] // s for e in per_part]
        level_sel.append((s, per_part, lat))
    bs_eff = bs_knob
    if merge:
        # one tile edge for every level, capped by the largest per-part
        # level extent (a force-dense knob must not size a huge tile)
        max_ext = 1
        for s, per_part, lat in level_sel:
            for p in range(P):
                if len(per_part[p]):
                    e = lat[p].max(axis=0) - lat[p].min(axis=0) + 1
                    max_ext = max(max_ext, int(e.max()))
        bs_eff = min(bs_knob, max_ext)
    levels: List[LevelGrid] = []
    for s, per_part, lat in level_sel:
        # a single dense bbox block when that is no larger than the bs^3
        # tiling would be, else bs^3 tiles of the occupied blocks only
        # (absolute bs-aligned ids, so dims stay common across parts)
        bs_lvl = bs_eff if merge else bs_knob
        ext = np.zeros(3, dtype=np.int64)
        bmax = 1
        blocks = [None] * P      # (uniq_block_keys, binv) per part
        for p in range(P):
            if not len(per_part[p]):
                continue
            lo_p = lat[p].min(axis=0)
            ext = np.maximum(ext, lat[p].max(axis=0) + 1 - lo_p)
            bid = lat[p] // bs_lvl
            uniq, binv = np.unique(
                (bid[:, 0] << 42) + (bid[:, 1] << 21) + bid[:, 2],
                return_inverse=True)
            blocks[p] = (uniq, binv)
            bmax = max(bmax, len(uniq))
        if not ext.any():
            continue
        # the dense layout allocates prod(ext) of the common extents for
        # every part: that is what tiling competes against
        if not merge and int(np.prod(ext)) <= bmax * bs_knob ** 3:
            nb, (bx, by, bz) = 1, (int(ext[0]), int(ext[1]), int(ext[2]))
            tiled = False
        else:
            nb, (bx, by, bz) = bmax, (bs_lvl,) * 3
            tiled = True

        ck = np.zeros((P, nb, bx, by, bz))
        ce = np.zeros((P, nb, bx, by, bz))
        nn = (bx + 1) * (by + 1) * (bz + 1)
        nidx = np.full((P, nb, nn), pm.n_node_loc, dtype=np.int32)
        origin = np.zeros((P, nb, 3), dtype=np.int64)
        n_cells = np.zeros(P, dtype=np.int64)
        II, JJ, KK = np.meshgrid(np.arange(bx + 1), np.arange(by + 1),
                                 np.arange(bz + 1), indexing="ij")
        lat_nodes = np.stack([II, JJ, KK], axis=-1).reshape(-1, 3)
        for p in range(P):
            e = per_part[p]
            n_cells[p] = len(e)
            if not len(e):
                continue
            if tiled:
                uniq, binv = blocks[p]
                blk_origin = np.stack(
                    [uniq >> 42, (uniq >> 21) & ((1 << 21) - 1),
                     uniq & ((1 << 21) - 1)], axis=-1) * bs_lvl
                c = lat[p] - blk_origin[binv]
            else:
                blk_origin = lat[p].min(axis=0)[None]
                binv = np.zeros(len(e), dtype=np.int64)
                c = lat[p] - blk_origin[0]
            B_p = len(blk_origin)
            origin[p, :B_p] = blk_origin
            ck[p, binv, c[:, 0], c[:, 1], c[:, 2]] = model.ck[e]
            ce[p, binv, c[:, 0], c[:, 1], c[:, 2]] = model.ce[e]
            # node lattice -> local node ids (missing or not local -> pad)
            g = (blk_origin[:, None, :] + lat_nodes[None]) * s
            keys = (g[..., 0] + sy * g[..., 1] + sz * g[..., 2]).reshape(-1)
            kpos = np.searchsorted(node_keys, keys)
            kpos_c = np.minimum(kpos, len(node_keys) - 1)
            is_node = node_keys[kpos_c] == keys
            gnid = np.where(is_node, key_order[kpos_c], -1)
            loc_gids = pm.node_gid[p, : pm.nnode_p[p]]  # sorted
            lpos = np.searchsorted(loc_gids, np.where(gnid < 0, 0, gnid))
            lpos_c = np.minimum(lpos, len(loc_gids) - 1)
            is_loc = is_node & (loc_gids[lpos_c] == gnid)
            nidx[p, :B_p] = np.where(is_loc, lpos_c, pm.n_node_loc) \
                .astype(np.int32).reshape(B_p, nn)
        levels.append(LevelGrid(size=s, nb=nb, bx=bx, by=by, bz=bz,
                                origin=origin, ck=ck, ce=ce,
                                nidx=nidx, n_cells=n_cells))

    if merge and len(levels) > 1:
        # one block batch for the whole octree (size 0); the slot order of
        # the concatenation is the level-order flattening of CombineMaps
        def cat(attr):
            return np.concatenate([getattr(lv, attr) for lv in levels],
                                  axis=1)

        levels = [LevelGrid(
            size=0, nb=sum(lv.nb for lv in levels),
            bx=levels[0].bx, by=levels[0].by, bz=levels[0].bz,
            origin=cat("origin"), ck=cat("ck"), ce=cat("ce"),
            nidx=cat("nidx"),
            n_cells=np.sum([lv.n_cells for lv in levels], axis=0))]

    lib = model.elem_lib[bt]
    return HybridPartition(
        pm=pm,
        levels=levels,
        brick_Ke=np.asarray(lib["Ke"], np.float64),
        brick_diag=np.asarray(lib["diagKe"], np.float64),
        brick_Se=(np.asarray(lib["Se"], np.float64)
                  if lib.get("Se") is not None else None),
        combine=build_combine_maps(levels, pm.n_node_loc, P),
    )


def partition_env_knobs() -> Dict[str, object]:
    """Every environment knob :func:`partition_hybrid` reads, with the JAX
    package's defaults."""
    return {
        "block": int(os.environ.get("PCG_TPU_HYBRID_BLOCK", "8")),
        "merge": os.environ.get("PCG_TPU_HYBRID_MERGE", "0") == "1",
        "kd": combine_kd(),
        "combine": hybrid_combine_mode(),
    }


def combine_kd() -> int:
    """Slots gathered for every node before the heavy-node residual
    (``PCG_TPU_HYBRID_KD``, default 2)."""
    kd = int(os.environ.get("PCG_TPU_HYBRID_KD", "2"))
    if kd < 1:
        raise ValueError(f"PCG_TPU_HYBRID_KD must be >= 1, got {kd}")
    return kd


def hybrid_combine_mode() -> str:
    """``PCG_TPU_HYBRID_COMBINE``, validated: ``gather`` (default: the
    partition-built per-node slot maps) or ``scatter`` (a row scatter-add
    per level)."""
    mode = os.environ.get("PCG_TPU_HYBRID_COMBINE", "gather")
    if mode not in ("gather", "scatter"):
        raise ValueError("PCG_TPU_HYBRID_COMBINE must be gather|scatter, "
                         f"got {mode!r}")
    return mode


def build_combine_maps(levels: List[LevelGrid], n_node_loc: int,
                       P: int) -> Optional[CombineMaps]:
    """Sort every level's lattice slots by target node and compose direct
    per-node source slots (:class:`CombineMaps`): one stable argsort of
    the concatenated slots per part."""
    if not levels:
        return None
    KD = combine_kd()
    nslot = [lv.nb * (lv.bx + 1) * (lv.by + 1) * (lv.bz + 1)
             for lv in levels]
    Ns = int(np.sum(nslot))
    slots_all = np.arange(Ns, dtype=np.int64)
    gidx = np.full((P, n_node_loc, KD), Ns, dtype=np.int64)
    starts_l, lens_l, ss_l = [], [], []
    ke_max = 0
    h_max = 0
    for p in range(P):
        tgt = np.concatenate([lv.nidx[p].reshape(-1) for lv in levels]) \
            .astype(np.int64)
        real = tgt < n_node_loc
        order = np.argsort(tgt[real], kind="stable")
        t_s = tgt[real][order]
        s_s = slots_all[real][order]
        starts = np.searchsorted(t_s, np.arange(n_node_loc, dtype=np.int64))
        lens = np.diff(np.append(starts, len(t_s)))
        for k in range(KD):
            sel = lens > k
            gidx[p, sel, k] = s_s[starts[sel] + k]
        starts_l.append(starts)
        lens_l.append(lens)
        ss_l.append(s_s)
        ke_max = max(ke_max, int(lens.max(initial=0)) - KD)
        h_max = max(h_max, int((lens > KD).sum()))
    KE = max(ke_max, 0)
    hnode = np.full((P, h_max), n_node_loc, dtype=np.int64)
    hgidx = np.full((P, h_max, KE), Ns, dtype=np.int64)
    for p in range(P):
        heavy = np.where(lens_l[p] > KD)[0]
        hnode[p, :len(heavy)] = heavy
        for k in range(KE):
            sel = lens_l[p][heavy] > KD + k
            hgidx[p, :len(heavy), k][sel] = \
                ss_l[p][starts_l[p][heavy[sel]] + KD + k]
    return CombineMaps(n_slots=Ns, gidx=gidx.astype(np.int32),
                       hnode=hnode.astype(np.int32),
                       hgidx=hgidx.astype(np.int32))


# ---------------------------------------------------------------------------
# Device tree and operator
# ---------------------------------------------------------------------------

def _level_bases(hp: HybridPartition) -> Tuple[np.ndarray, np.ndarray]:
    """Per level, its first slot within a part's slots and its first row
    in the device's slot rows (every part's slots of one level
    together, levels in order)."""
    P = hp.pm.n_parts
    sizes = np.array([lv.nb * (lv.bx + 1) * (lv.by + 1) * (lv.bz + 1)
                      for lv in hp.levels], dtype=np.int64)
    part_base = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    return part_base, P * part_base


def _device_slots(hp: HybridPartition, slots: np.ndarray,
                  p: int) -> np.ndarray:
    """Part ``p``'s slot ids (its pad = ``combine.n_slots``) -> rows of the
    device's slot rows (pad: the trailing zero row, ``P * n_slots``)."""
    P, Ns = hp.pm.n_parts, hp.combine.n_slots
    part_base, dev_base = _level_bases(hp)
    slots = np.asarray(slots, dtype=np.int64)
    out = np.full(slots.shape, P * Ns, dtype=np.int64)
    real = slots < Ns
    s = slots[real]
    lvl = np.searchsorted(part_base, s, side="right") - 1
    per_part = np.array([lv.nb * (lv.bx + 1) * (lv.by + 1) * (lv.bz + 1)
                         for lv in hp.levels], dtype=np.int64)
    out[real] = dev_base[lvl] + p * per_part[lvl] + (s - part_base[lvl])
    return out


def device_data_hybrid(hp: HybridPartition, dtype: torch.dtype,
                       device) -> dict:
    """The general device tree of the transition blocks plus, per level,
    the cell scales ``ck`` and strain scales ``ce`` (P * nb, bx, by, bz)
    and the component-major
    node-lattice gather ``gx`` (P * nb * 3 * nodes, int32: flat dof
    3 * (p * n_node_loc + node) + c, the pad node P * n_node_loc reading
    an appended zero); ``brick_Ke``, ``brick_diag``, ``brick_Se``; and the
    combine maps over the device's slot rows: ``gslot`` (P * n_node_loc *
    KD), the heavy nodes' flat rows ``hnode`` (int64, real entries only)
    and their slots ``hslot`` (H * KE)."""
    pm = hp.pm
    P, nnl = pm.n_parts, pm.n_node_loc
    d = device_data(pm, dtype, device)

    def put(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    parts = np.arange(P, dtype=np.int64)[:, None, None]
    levels = []
    for lv in hp.levels:
        rows = np.where(lv.nidx < nnl, lv.nidx + parts * nnl, P * nnl)
        gx = rows[:, :, None, :] * 3 + np.arange(3)[None, None, :, None]
        levels.append({
            "ck": put(lv.ck.reshape((P * lv.nb,) + lv.ck.shape[2:]), dtype),
            "ce": put(lv.ce.reshape((P * lv.nb,) + lv.ce.shape[2:]), dtype),
            "gx": put(gx.reshape(-1), torch.int32)})
    d["levels"] = levels
    d["brick_Ke"] = put(hp.brick_Ke, dtype)
    d["brick_diag"] = put(hp.brick_diag, dtype)
    if hp.brick_Se is not None:
        d["brick_Se"] = put(hp.brick_Se, dtype)
    cm = hp.combine
    if cm is not None:
        gslot = np.stack([_device_slots(hp, cm.gidx[p], p)
                          for p in range(P)])
        real = cm.hnode < nnl
        hnode = (cm.hnode.astype(np.int64) + parts[:, :, 0] * nnl)[real]
        hslot = np.stack([_device_slots(hp, cm.hgidx[p], p)
                          for p in range(P)]) if cm.hnode.shape[1] \
            else np.zeros((P, 0, 0), np.int64)
        d["combine"] = {"gslot": put(gslot.reshape(-1), torch.int32),
                        "hnode": put(hnode, torch.int64),
                        "hslot": put(hslot[real].reshape(-1), torch.int32)}
    return d


def block_data(data: dict, R: int) -> dict:
    """The device tree for blocks of ``R`` right-hand sides: each level's
    cell scales repeated once per column (``ck_rows``, (R * P * nb, bx,
    by, bz), column-major over the parts' blocks), so a blocked matvec is
    one launch a level over R * P * nb blocks; every other leaf is shared
    with ``data``."""
    return dict(data, levels=[
        dict(lv, ck_rows=lv["ck"] if R == 1 else lv["ck"].repeat(R, 1, 1, 1))
        for lv in data["levels"]])


@dataclasses.dataclass(frozen=True)
class HybridOps(Ops):
    """The general operator over the transition blocks plus one slab
    kernel launch a brick level.  ``variant`` and ``planes`` name the
    float32 kernel (as ``StructuredOps``); ``combine`` is the level
    combine, pinned at construction."""

    # (nb, bx, by, bz) per level
    level_dims: Tuple[Tuple[int, int, int, int], ...] = ()
    combine: str = "gather"
    combine_k: Tuple[int, int] = (0, 0)     # (KD, KE)
    variant: str = "v6"
    planes: Optional[int] = None

    @classmethod
    def from_hybrid(cls, hp: HybridPartition,
                    dot_dtype: torch.dtype = torch.float64,
                    mg_degree: int = 2, variant: str = "v6",
                    planes: Optional[int] = None,
                    combine: Optional[str] = None):
        if combine is None:
            combine = hybrid_combine_mode()
        if combine not in ("gather", "scatter"):
            raise ValueError(f"combine must be gather|scatter, got "
                             f"{combine!r}")
        cm = hp.combine
        if cm is None:
            combine = "scatter"     # no maps built (no levels)
        base = Ops.from_model(hp.pm, dot_dtype=dot_dtype,
                              mg_degree=mg_degree)
        return cls(**{f.name: getattr(base, f.name)
                      for f in dataclasses.fields(Ops)},
                   level_dims=tuple((lv.nb, lv.bx, lv.by, lv.bz)
                                    for lv in hp.levels),
                   combine=combine,
                   combine_k=((cm.gidx.shape[-1], cm.hgidx.shape[-1])
                              if cm is not None else (0, 0)),
                   variant=variant, planes=planes)

    @property
    def n_slot_rows(self) -> int:
        """Slot rows of one column over every part and level."""
        return self.n_parts * sum(nb * (bx + 1) * (by + 1) * (bz + 1)
                                  for nb, bx, by, bz in self.level_dims)

    def block_data(self, data: dict, R: int) -> dict:
        return block_data(data, R)

    def _use_gather(self, data: dict) -> bool:
        return (self.combine == "gather" and "combine" in data
                and bool(data["levels"]))

    def _combine(self, data: dict, y3: torch.Tensor, grids) -> torch.Tensor:
        """Add the levels' node grids ((R * P * nb, w, bx+1, by+1, bz+1)
        each) into the node rows ``y3`` (R, P * n_node_loc, w)."""
        R, _, w = y3.shape
        P = self.n_parts
        if not self._use_gather(data):
            # the A/B arm: a row scatter-add per level, dropping the pad
            y3p = torch.cat([y3, y3.new_zeros((R, 1, w))], dim=1)
            for g, lv, (nb, *_b) in zip(grids, data["levels"],
                                        self.level_dims):
                nrow = torch.div(lv["gx"].view(P * nb, 3, -1)[:, 0],
                                 3, rounding_mode="floor").reshape(-1)
                y3p.index_add_(1, nrow.long(), g.view(R, P * nb, w, -1)
                               .transpose(2, 3).reshape(R, -1, w))
            return y3p[:, :-1]
        cm = data["combine"]
        KD, KE = self.combine_k
        rows = torch.empty((R, self.n_slot_rows + 1, w), dtype=y3.dtype,
                           device=y3.device)
        rows[:, -1].zero_()
        base = 0
        for g, (nb, *_b) in zip(grids, self.level_dims):
            nn = g[0, 0].numel()
            n = P * nb * nn
            rows[:, base:base + n].view(R, P * nb, nn, w).copy_(
                g.view(R, P * nb, w, nn).transpose(2, 3))
            base += n
        t = rows.index_select(1, cm["gslot"]).view(R, -1, KD, w)
        acc = t[:, :, 0]
        for k in range(1, KD):
            acc = acc + t[:, :, k]
        y3 = y3 + acc
        if cm["hnode"].numel():
            h = rows.index_select(1, cm["hslot"]).view(R, -1, KE, w)
            hacc = h[:, :, 0]
            for k in range(1, KE):
                hacc = hacc + h[:, :, k]
            # distinct heavy rows: an exact, repeatable index put
            y3 = y3.index_copy(1, cm["hnode"],
                               y3.index_select(1, cm["hnode"]) + hacc)
        return y3

    def matvec_local(self, data: dict, x: torch.Tensor) -> torch.Tensor:
        """Part-local K.x: the transition blocks' general product, then one
        slab kernel launch a level on its gathered node lattices.  A block
        (R, P, n_loc) folds its columns into each level's batch, on the
        cell scales :func:`block_data` repeated for that width."""
        R = x.shape[0] if x.dim() == 3 else 1
        if self.buckets:
            y = Ops.matvec_local(self, data, x)
        else:
            y = self._apply_springs(data, x, torch.zeros_like(x))
        if not data["levels"]:
            return y
        xf = torch.cat([x.reshape(R, -1), x.new_zeros((R, 3))], dim=1)
        grids = []
        for lv, (nb, bx, by, bz) in zip(data["levels"], self.level_dims):
            ck = lv["ck"] if R == 1 else lv.get("ck_rows", lv["ck"])
            if ck.shape[0] != R * self.n_parts * nb:
                raise ValueError(
                    f"a block of {R} right-hand sides needs the device "
                    f"tree of block_data(data, {R})")
            xg = xf.index_select(1, lv["gx"]).view(
                R * self.n_parts * nb, 3, bx + 1, by + 1, bz + 1)
            grids.append(structured_matvec(xg, ck, data["brick_Ke"],
                                           variant=self.variant,
                                           planes=self.planes))
        y3 = self._combine(data, y.reshape(R, -1, 3), grids)
        return y3.reshape(x.shape)

    def diag_local(self, data: dict) -> torch.Tensor:
        ref = data["weight"]
        if self.buckets:
            y = Ops.diag_local(self, data)
        else:
            y = self._apply_springs_diag(data, torch.zeros_like(ref))
        if not data["levels"]:
            return y
        dk = data["brick_diag"][None, :, None, None, None]
        grids = [scatter_cells(dk * lv["ck"][:, None])
                 for lv in data["levels"]]
        return self._combine(data, y.reshape(1, -1, 3),
                             grids).reshape(ref.shape)

    def _node_block_local(self, data: dict) -> torch.Tensor:
        """Transition blocks' node blocks (general path) plus each brick
        level's corner blocks on its node grid (``corner_block_field``),
        (P * n_node_loc, 9)."""
        if self.buckets:
            y = Ops._node_block_local(self, data)
        else:
            ref = data["weight"]
            y = self._springs_into_blocks(data, ref.new_zeros(
                (self.n_parts * self.n_node_loc, 9)))
        if not data["levels"]:
            return y
        grids = [corner_block_field(data["brick_Ke"], lv["ck"], CORNERS)
                 for lv in data["levels"]]
        return self._combine(data, y[None], grids)[0]

    # -- export path (strain + nodal averaging over buckets + levels) ----
    def _level_grids(self, data: dict, x: torch.Tensor):
        """Each level's gathered node lattices (P * nb, 3, bx+1, by+1,
        bz+1) of ``x`` (P, n_loc)."""
        xf = torch.cat([x.reshape(1, -1), x.new_zeros((1, 3))], dim=1)
        for lv, (nb, bx, by, bz) in zip(data["levels"], self.level_dims):
            yield lv, xf.index_select(1, lv["gx"]).view(
                self.n_parts * nb, 3, bx + 1, by + 1, bz + 1)

    def elem_strain(self, data: dict, x: torch.Tensor) -> list:
        """The transition buckets' strains (:meth:`Ops.elem_strain`), then
        one (P * nb, 6, cells) tensor a level: ``brick_Se`` on the level's
        cells (holes give 0)."""
        out = Ops.elem_strain(self, data, x) if self.buckets else []
        if data["levels"] and "brick_Se" not in data:
            raise ValueError("strain export unavailable: the brick element "
                             "library has no Se strain mode")
        for lv, xg in self._level_grids(data, x):
            eps = torch.einsum("sd,bdxyz->bsxyz", data["brick_Se"],
                               lv["ce"][:, None] * gather_cells(xg))
            out.append(eps.reshape(eps.shape[0], 6, -1))
        return out

    def elem_scale(self, data: dict) -> list:
        out = Ops.elem_scale(self, data) if self.buckets else []
        return out + [(lv["ck"] * lv["ce"]).reshape(lv["ck"].shape[0], -1)
                      for lv in data["levels"]]

    def nodal_average(self, data: dict, vals_list) -> torch.Tensor:
        """Buckets then levels (:meth:`elem_strain`'s order) -> averaged
        nodal field (P, k, n_node_loc): the buckets' node sums over the
        node ELL, each level's sums and valid-cell counts (holes, ck = 0,
        count nothing) as its eight corner translates, added into the node
        rows by the level combine; no float atomics on the gather
        combine."""
        nbk = len(self.buckets)
        k = vals_list[0].shape[1]
        ref = data["weight"]
        if nbk:
            sums = self._node_sums(data, vals_list[:nbk])
        else:
            sums = ref.new_zeros((1, self.n_parts * self.n_node_loc, k + 1))
        grids = []
        for lv, (nb, bx, by, bz), vals in zip(data["levels"],
                                              self.level_dims,
                                              vals_list[nbk:]):
            valid = (lv["ck"] != 0).to(vals.dtype)[:, None]
            vg = vals.reshape(-1, k, bx, by, bz) * valid
            both = torch.cat([vg, valid], dim=1)
            g = None
            for dx, dy, dz in CORNERS:
                t = torch.nn.functional.pad(both, (dz, 1 - dz, dy, 1 - dy,
                                                   dx, 1 - dx))
                g = t if g is None else g + t
            grids.append(g)
        if grids:
            sums = self._combine(data, sums, grids)
        return self._node_average(data, sums, k)

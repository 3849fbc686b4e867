"""Shard-addressed partition serialization.

Port of ``pcg_mpi_solver_tpu/cache/shards.py``.  Splits a built
partition into one small GLUE entry (global scalars, the
:class:`~pcg_mpi_solver_tpu_torch.parallel.partition.PartitionLayout`,
the shared per-type element matrices) plus one entry PER PART holding
only that part's rows of every ``(P, ...)`` array — so the N processes
of a multi-process run each read ONLY their own parts' entries (plus the
glue) on a warm start, instead of every process deserializing one
monolithic blob.  ``join_partition`` reassembles a
partition object from the glue + any subset of part entries; rows of
absent parts are reconstructed at their padding values (weight 0,
dof_gid -1, index maps at their out-of-range sentinels) — exactly what
``partition_model(part_range=...)`` leaves there, so a warm shard load
is bit-identical to a cold shard build.

The classification below is EXPLICIT (not shape-sniffed): an array field
whose leading dim happens to equal ``n_parts`` (e.g. ``elem_part`` on a
tiny model) must not silently become per-part.  A new array field on
``PartitionedModel``/``TypeBlock``/``StructuredPartition`` that is
neither listed per-part nor global fails loudly in ``split_partition``
— the forcing function that keeps the cache layout complete.

Import contract: numpy only at module load (like the rest of cache/).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

#: schema tag embedded in every glue/shard entry payload; bump on any
#: layout change here (CACHE_SCHEMA in cache/keys.py already re-keys all
#: entries on serialization changes — this tag is the belt to that
#: suspenders for hand-inspected entries); the port's tag, so its entries
#: never pass for the JAX package's
SHARD_LAYOUT = "pcg-tpu-torch-partition-shard/1"

# ---- PartitionedModel classification ---------------------------------
_PM_PER_PART = (
    "scat_perm", "scat_ids", "ell", "iface_local", "iface_slot",
    "niface_local", "niface_slot", "weight", "node_weight", "eff", "F",
    "Ud", "inv_diag_M", "dof_gid", "node_gid", "spr_a", "spr_b", "spr_k",
)
_PM_GLOBAL = (
    "n_parts", "n_loc", "n_node_loc", "n_iface", "n_node_iface",
    "glob_n_dof", "glob_n_dof_eff", "glob_n_node", "node_layout",
    "ndof_p", "nnode_p", "layout",
)
#: fields deliberately NOT persisted in the shard layout: ``elem_part``
#: is O(n_elem) (the glue must stay surface-scale — at 1B dofs a
#: model-sized map would make every host's warm read O(model) again)
#: AND process-dependent under the slab2 refine-local fast path (other
#: slabs keep coarse labels), so concurrent glue writers would race on
#: different content.  Its identity already keys every entry
#: (elem_part_hash / method / slab2_slabs); consumers needing the map
#: (only the hybrid backend's refresh path, which uses the monolithic
#: store) never read shard entries.  Joined partitions carry None.
#: ``part_range`` is process-dependent under a sharded cold build for
#: the same reason (each writer's glue would race on ITS range) —
#: ``join_partition`` re-derives it from the loaded shard set instead.
_PM_DROPPED = ("elem_part", "part_range")
#: the structured partition's process-dependent range, likewise
_TB_PER_PART = ("dof", "sign", "node", "ck", "ce", "e_mod", "valid",
                "n_elem")
_TB_GLOBAL = ("type_id", "d", "n_nodes", "Ke", "diag_Ke", "Se", "Me")

# ---- StructuredPartition classification ------------------------------
_SP_PER_PART = ("ck", "ce", "weight", "node_weight", "eff", "F", "Ud",
                "dof_gid", "node_gid")
_SP_GLOBAL = (
    "n_parts", "n_loc", "n_iface", "n_node_loc", "glob_n_dof",
    "glob_n_dof_eff", "glob_n_node", "nxc", "ny", "nz", "Ke", "diag_Ke",
    "Se", "ndof_p",
)


def _check_classified(obj, per_part, global_, label: str,
                      special=("type_blocks",) + _PM_DROPPED) -> None:
    names = {f.name for f in dataclasses.fields(obj)}
    missing = names - set(per_part) - set(global_) - set(special)
    if missing:
        raise TypeError(
            f"cache/shards.py: unclassified {label} field(s) {sorted(missing)}"
            " — add them to the per-part or global table so the shard "
            "cache layout stays complete")


def _is_structured(pm) -> bool:
    return hasattr(pm, "nxc") and not hasattr(pm, "type_blocks")


def split_partition(pm, part_range: Optional[Tuple[int, int]] = None):
    """Split a built partition into ``(glue, {part_idx: shard})``.

    ``part_range`` limits which parts get shard entries (a sharded cold
    build only has its own rows populated); default = the partition's
    own ``part_range`` (full build: every part)."""
    if part_range is None:
        part_range = getattr(pm, "part_range", None) or (0, pm.n_parts)
    lo, hi = part_range
    if _is_structured(pm):
        per_part, global_, blocks = _SP_PER_PART, _SP_GLOBAL, None
        _check_classified(pm, per_part, global_, "StructuredPartition")
    else:
        per_part, global_, blocks = _PM_PER_PART, _PM_GLOBAL, pm.type_blocks
        _check_classified(pm, per_part, global_, "PartitionedModel")
        for tb in blocks:
            _check_classified(tb, _TB_PER_PART, _TB_GLOBAL, "TypeBlock")

    glue = {"schema": SHARD_LAYOUT,
            "kind": "structured" if blocks is None else "general",
            "fields": {n: getattr(pm, n) for n in global_}}
    if blocks is not None:
        glue["blocks"] = [{n: getattr(tb, n) for n in _TB_GLOBAL}
                         for tb in blocks]
        # ROW shapes (shape[1:]): join re-adds the parts axis
        glue["block_shapes"] = [
            {n: (getattr(tb, n).shape[1:], str(getattr(tb, n).dtype))
             for n in _TB_PER_PART} for tb in blocks]
    glue["shapes"] = {n: (None if getattr(pm, n) is None
                          else (getattr(pm, n).shape[1:],
                                str(getattr(pm, n).dtype)))
                      for n in per_part}
    shards: Dict[int, dict] = {}
    for p in range(lo, hi):
        sh = {"schema": SHARD_LAYOUT, "part_idx": p,
              "fields": {n: (None if getattr(pm, n) is None
                             else np.ascontiguousarray(getattr(pm, n)[p]))
                         for n in per_part}}
        if blocks is not None:
            sh["blocks"] = [{n: np.ascontiguousarray(getattr(tb, n)[p])
                             for n in _TB_PER_PART} for tb in blocks]
        shards[p] = sh
    return glue, shards


def _row_fill(name: str, shape, dtype, glue_fields) -> np.ndarray:
    """Padding row for a part whose shard entry was not loaded — must
    match what ``partition_model(part_range=...)`` leaves in unbuilt
    rows (the bit-identity contract of warm vs cold sharded setup)."""
    n_loc = glue_fields["n_loc"]
    fills = {"dof_gid": -1, "node_gid": -1, "spr_a": n_loc, "spr_b": n_loc,
             "iface_local": n_loc, "iface_slot": glue_fields["n_iface"],
             "niface_local": glue_fields["n_node_loc"],
             "niface_slot": glue_fields.get("n_node_iface", 0),
             "ell": glue_fields.get("_ell_fill", 0)}
    return np.full(shape, fills.get(name, 0), dtype=np.dtype(dtype))


def join_partition(glue: dict, shards: Dict[int, dict]):
    """Reassemble a partition object from the glue entry + any subset of
    part entries (absent parts' rows take their padding values).  The
    result is bit-identical to a ``partition_model(part_range=...)``
    build covering the same parts."""
    fields = dict(glue["fields"])
    P = int(fields["n_parts"])
    out = dict(fields)
    # the loaded shard set defines the populated range (part_range is
    # deliberately NOT in the glue — see _PM_DROPPED)
    ps = sorted(shards)
    out["part_range"] = (ps[0], ps[-1] + 1) if ps else None
    structured = glue.get("kind") == "structured"
    per_part = _SP_PER_PART if structured else _PM_PER_PART
    if not structured:
        # ell's padding value is the out-of-range slot id n_slots (the
        # total element-node slot count across type blocks)
        fields["_ell_fill"] = sum(
            int(np.prod(bs["node"][0]))
            for bs in glue.get("block_shapes", ()))
    for n in per_part:
        spec = glue["shapes"][n]
        if spec is None:
            out[n] = None
            continue
        shape, dtype = spec
        full = _row_fill(n, (P,) + tuple(shape), dtype, fields)
        for p, sh in shards.items():
            row = sh["fields"][n]
            if row is not None:
                full[p] = row
        out[n] = full
    if structured:
        from pcg_mpi_solver_tpu_torch.parallel.structured import (
            StructuredPartition)

        return StructuredPartition(**out)
    from pcg_mpi_solver_tpu_torch.parallel.partition import (
        PartitionedModel, TypeBlock)

    out.setdefault("elem_part", None)     # _PM_DROPPED — see above
    type_blocks = []
    for bi, bglob in enumerate(glue["blocks"]):
        tb = dict(bglob)
        for n, (shape, dtype) in glue["block_shapes"][bi].items():
            if n == "n_elem":
                full = np.zeros((P,), dtype=np.dtype(dtype))
            elif n in ("dof",):
                full = np.full((P,) + tuple(shape), fields["n_loc"],
                               dtype=np.dtype(dtype))
            elif n in ("node",):
                full = np.full((P,) + tuple(shape), fields["n_node_loc"],
                               dtype=np.dtype(dtype))
            else:
                full = np.zeros((P,) + tuple(shape), dtype=np.dtype(dtype))
            for p, sh in shards.items():
                # ascontiguousarray promoted scalar rows to (1,)
                full[p] = np.asarray(sh["blocks"][bi][n]).reshape(
                    np.shape(full[p]))
            tb[n] = full
        type_blocks.append(TypeBlock(**tb))
    out["type_blocks"] = type_blocks
    return PartitionedModel(**out)


# ----------------------------------------------------------------------
# MG hierarchy (ops/mg.py MGSetup): the ``fine`` transfer arrays are the
# only parts-sharded leaves — everything else (the replicated coarse
# hierarchy, Ke, lam, meta) is global by design and lives in the glue.
# ----------------------------------------------------------------------

def split_mg(setup, part_range: Tuple[int, int]):
    """``MGSetup`` -> (glue, {part_idx: shard}) for the shard cache."""
    lo, hi = part_range
    fine = setup.tree["fine"]
    glue = {"schema": SHARD_LAYOUT, "kind": "mg",
            "tree": {k: v for k, v in setup.tree.items() if k != "fine"},
            "fine_shapes": {k: (v.shape, str(v.dtype))
                            for k, v in fine.items()},
            "meta": setup.meta, "coarse_lams": setup.coarse_lams,
            "lam_min_coarse": setup.lam_min_coarse}
    shards = {p: {"schema": SHARD_LAYOUT, "part_idx": p,
                  "fine": {k: np.ascontiguousarray(v[p])
                           for k, v in fine.items()}}
              for p in range(lo, hi)}
    return glue, shards


def join_mg(glue: dict, shards: Dict[int, dict]):
    """Reassemble an ``MGSetup`` from glue + any subset of part entries
    (absent parts' fine-transfer rows are zero-weight — never read by a
    process that does not own them)."""
    from pcg_mpi_solver_tpu_torch.ops.mg import MGSetup

    fine = {}
    for k, (shape, dtype) in glue["fine_shapes"].items():
        P = shape[0]
        full = np.zeros(shape, dtype=np.dtype(dtype))
        for p, sh in shards.items():
            full[p] = sh["fine"][k]
        fine[k] = full
    tree = dict(glue["tree"])
    tree["fine"] = fine
    return MGSetup(tree=tree, meta=dict(glue["meta"]),
                   coarse_lams=list(glue["coarse_lams"]),
                   lam_min_coarse=float(glue["lam_min_coarse"]))

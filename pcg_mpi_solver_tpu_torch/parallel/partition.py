"""Host-side partitioner: global ModelData -> padded per-part arrays.

A numpy copy of ``pcg_mpi_solver_tpu/parallel/partition.py`` (its full
build, array for array: tests/test_torch_partition.py).  Every per-part
structure is a dense array with a leading parts axis ``P``, padded to
common shapes:

- element -> part assignment by recursive coordinate bisection over
  element centroids (``rcb``), its two-level form (``slab2``), or the
  native dual-graph partitioner (``graph``, and ``auto``, which takes it
  unless ``PCG_TPU_NO_NATIVE`` is set; ``native.py``);
- local renumbering with np.unique/searchsorted over whole parts;
- a dof is "interface" iff it lives in >= 2 parts; each part gets
  gather/scatter maps into one global interface vector;
- owner = lowest part id containing the dof (weight 1 there, 0
  elsewhere), so global dots count every dof once;
- one ``TypeBlock`` per pattern type, and the node-ELL map (each local
  node's <= K element-node contribution slots) the general matvec sums.

The prep loops go through the port's native library as the JAX
package's do (``_unique``, ``_csr_take``, the stable sort of the flat
scatter map, above ``native._PREP_THRESHOLD`` items), and take their
numpy forms (the same values) below it or without the library.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np

from pcg_mpi_solver_tpu_torch import native
from pcg_mpi_solver_tpu_torch.models.model_data import ModelData


# ----------------------------------------------------------------------
# Element -> part assignment
# ----------------------------------------------------------------------

def graph_partition(model: ModelData, n_parts: int, ncommon: int = 1,
                    seed: int = 0, strict: bool = True) -> np.ndarray:
    """Dual-graph element partition by the native multilevel partitioner
    (the reference's ``metis.part_mesh_dual``, run_metis.py:84-88).  A
    library that is off (``PCG_TPU_NO_NATIVE``) or did not build raises.
    A partition with an empty part raises under ``strict``; without it
    (``"auto"``) it warns and takes RCB, the JAX package's rule for the
    solver's need of non-empty parts."""
    part = native.part_mesh_dual(
        np.asarray(model.elem_nodes_offset, dtype=np.int64),
        np.asarray(model.elem_nodes_flat, dtype=np.int64),
        model.n_node, n_parts, ncommon=ncommon, seed=seed)
    if len(np.unique(part)) != n_parts:
        if strict:
            raise RuntimeError(
                f"partition method 'graph' produced an empty part "
                f"(n_parts={n_parts}); the explicitly requested graph "
                "partition cannot be honored — use method='auto' or 'rcb'")
        warnings.warn(
            f"graph partition produced an empty part (n_parts={n_parts}); "
            "falling back to RCB")
        return rcb_partition(model.sctrs, n_parts)
    return part


def make_elem_part(model: ModelData, n_parts: int, method: str = "rcb",
                   seed: int = 0, n_slabs: int = 1) -> np.ndarray:
    """Element->part map by method: 'rcb' (coordinate bisection), 'graph'
    (the native dual-graph partition, :func:`graph_partition`), 'auto'
    (the graph unless ``PCG_TPU_NO_NATIVE`` turns the library off, then
    RCB; a library that fails to build raises, as 'graph' does), or
    'slab2' (the two-level split, :func:`two_level_partition`;
    ``n_slabs`` is the coarse slab count, 1 == plain RCB)."""
    if n_parts <= 1:
        return np.zeros(model.n_elem, dtype=np.int32)
    if method == "rcb":
        return rcb_partition(model.sctrs, n_parts)
    if method == "slab2":
        return two_level_partition(model.sctrs, n_parts, n_slabs)
    if method == "graph":
        return graph_partition(model, n_parts, seed=seed, strict=True)
    if method == "auto":
        if native.available():
            return graph_partition(model, n_parts, seed=seed, strict=False)
        return rcb_partition(model.sctrs, n_parts)
    raise ValueError(f"unknown partition method {method!r}")


def coarse_slab_cut(centroids: np.ndarray, n_slabs: int) -> np.ndarray:
    """The CHEAP coarse cut of the two-level split: one stable argsort of
    ONE coordinate axis (the longest global extent), cut into ``n_slabs``
    balanced contiguous chunks.  Returns the (n_elem,) slab id map.
    Deterministic — every process of a sharded build computes the same
    cut from the same centroids (or each process computes only its own
    slab membership from the global axis order during slab ingest)."""
    n = len(centroids)
    slab = np.zeros(n, dtype=np.int32)
    if n_slabs <= 1:
        return slab
    axis = int(np.argmax(centroids.max(axis=0) - centroids.min(axis=0)))
    order = np.argsort(centroids[:, axis], kind="stable")
    bounds = [int(round(n * s / n_slabs)) for s in range(n_slabs + 1)]
    for s in range(n_slabs):
        slab[order[bounds[s]:bounds[s + 1]]] = s
    return slab


def two_level_partition(centroids: np.ndarray, n_parts: int,
                        n_slabs: int = 1) -> np.ndarray:
    """Two-level METIS-style element partition (the sharded-setup path):
    a cheap coarse slab cut (:func:`coarse_slab_cut`) into
    ``n_slabs`` contiguous slabs along the dominant axis, then an
    INDEPENDENT per-slab RCB refinement into ``n_parts // n_slabs``
    parts each — so under a multi-process build each process only has to
    refine (and renumber, and block-build) its own slab.  ``n_slabs=1``
    degenerates to plain RCB.  Deterministic for fixed inputs; the slab
    count is a cache-key component (the resulting partition differs
    between slab counts).  (The JAX package's ``refine`` argument, which
    leaves other processes' slabs unrefined, belongs to the sharded build,
    ROADMAP queue 1 item 12.)"""
    if n_parts % max(n_slabs, 1) != 0:
        raise ValueError(
            f"two_level_partition: n_parts={n_parts} must be divisible "
            f"by n_slabs={n_slabs}")
    n_slabs = max(n_slabs, 1)
    pps = n_parts // n_slabs
    slab = coarse_slab_cut(centroids, n_slabs)
    part = np.zeros(len(centroids), dtype=np.int32)
    for s in range(n_slabs):
        idx = np.where(slab == s)[0]
        part[idx] = s * pps + rcb_partition(centroids[idx], pps)
    return part


def slab_local_parts(slab_centroids: np.ndarray, n_parts: int,
                     n_slabs: int, slab_idx: int):
    """Per-slab refinement half of the two-level split, for a process
    that holds ONLY its slab (an MDF slab read): returns the
    slab-positional element->part map and this slab's ``part_range``.
    Identical assignment to :func:`two_level_partition` run on the full
    model (the slab's elements arrive in ascending global id order from
    ``slab_elem_ids``, matching ``np.where(slab == s)`` order)."""
    if n_parts % max(n_slabs, 1) != 0:
        raise ValueError(
            f"slab_local_parts: n_parts={n_parts} not divisible by "
            f"n_slabs={n_slabs}")
    pps = n_parts // max(n_slabs, 1)
    part = slab_idx * pps + rcb_partition(slab_centroids, pps)
    return part.astype(np.int32), (slab_idx * pps, (slab_idx + 1) * pps)


def rcb_partition(centroids: np.ndarray, n_parts: int) -> np.ndarray:
    """Recursive coordinate bisection on element centroids.

    Supports any n_parts >= 1 (splits proportionally when odd).  Produces
    contiguous, balanced spatial blocks — the same surface-minimizing goal the
    reference gets from METIS dual-graph partitioning (run_metis.py:84-88).
    """
    n = len(centroids)
    part = np.zeros(n, dtype=np.int32)

    def split(idx: np.ndarray, p0: int, np_: int):
        if np_ == 1:
            part[idx] = p0
            return
        n_left = np_ // 2
        frac = n_left / np_
        c = centroids[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = np.argsort(c[:, axis], kind="stable")
        k = int(round(len(idx) * frac))
        split(idx[order[:k]], p0, n_left)
        split(idx[order[k:]], p0 + n_left, np_ - n_left)

    split(np.arange(n), 0, n_parts)
    return part


# ----------------------------------------------------------------------
# Partitioned model container
# ----------------------------------------------------------------------

@dataclasses.dataclass
class TypeBlock:
    """One pattern-type group, padded across parts.

    The matvec for this block is (reference pcg_solver.py:271-280):
        u  = x[dof]            gather (P, d, N)
        u  = where(sign, -u, u)
        v  = Ke @ (ck * u)     one batched product per part
        v  = where(sign, -v, v)
    Padded element slots have ck == 0 and dof == n_loc (out-of-bounds, so
    gathers fill 0 and scatters drop).
    """

    type_id: int
    d: int                 # dofs per element
    n_nodes: int
    Ke: np.ndarray         # (d, d) unit stiffness
    diag_Ke: np.ndarray    # (d,)
    Se: Optional[np.ndarray]  # (6, d) strain mode, if available
    Me: Optional[np.ndarray]
    dof: np.ndarray        # (P, d, N) int32 local dof ids
    sign: np.ndarray       # (P, d, N) bool
    node: np.ndarray       # (P, n_nodes, N) int32 local node ids
    ck: np.ndarray         # (P, N) stiffness scale, 0 for padding
    ce: np.ndarray         # (P, N) strain scale, 0 for padding
    e_mod: np.ndarray      # (P, N) elastic modulus (for stress export)
    valid: np.ndarray      # (P, N) bool
    n_elem: np.ndarray     # (P,) true element counts


@dataclasses.dataclass
class PartitionedModel:
    """Everything the SPMD solver needs, as (P, ...) padded numpy arrays."""

    n_parts: int
    n_loc: int                   # padded local dof count
    n_node_loc: int              # padded local node count
    n_iface: int                 # global interface dof count
    n_node_iface: int            # global interface node count
    glob_n_dof: int
    glob_n_dof_eff: int
    glob_n_node: int

    type_blocks: List[TypeBlock]

    # Scatter maps (per part): flat element-dof values (concatenated over type
    # blocks in order, each ravel'd (d*N)) -> local dof vector.  ``perm``
    # pre-sorts values so segment_sum sees sorted indices.
    scat_perm: np.ndarray        # (P, NC) int32
    scat_ids: np.ndarray         # (P, NC) int32 sorted local dof ids (n_loc for padding)

    # Node-ELL scatter map: every local node receives <= K element-node
    # contributions, each a contiguous 3-vector.  ``ell`` indexes rows of
    # the flattened (NC/3, 3) element-node value array (slot = block_base +
    # node_slot*N_blk + elem), NC/3 = out-of-range fill, so the scatter-add
    # becomes a row gather + row sum in a fixed order.  None when the model
    # is not 3-dof-per-node (then the sorted flat map above is used).
    ell: Optional[np.ndarray]    # (P, n_node_loc, K) int32
    node_layout: bool            # dof_gid == 3*node_gid+c everywhere

    # Interface assembly maps (dof space)
    iface_local: np.ndarray      # (P, NI) int32 local dof id, n_loc padded
    iface_slot: np.ndarray       # (P, NI) int32 slot in global iface vector, n_iface padded

    # Interface assembly maps (node space, for nodal averaging exports)
    niface_local: np.ndarray     # (P, NNI) int32
    niface_slot: np.ndarray      # (P, NNI) int32

    # Per-part nodal vectors, padded to n_loc
    weight: np.ndarray           # (P, n_loc) owner weights (0/1), 0 on padding
    node_weight: np.ndarray      # (P, n_node_loc)
    eff: np.ndarray              # (P, n_loc) 1.0 on effective (free) dofs
    F: np.ndarray                # (P, n_loc) reference load
    Ud: np.ndarray               # (P, n_loc) prescribed displacement
    inv_diag_M: np.ndarray       # (P, n_loc) — for the dynamics (Newmark) path;
                                 # unused by the quasi-static solve

    # Global id maps (for export); -1 padding
    dof_gid: np.ndarray          # (P, n_loc) int64
    node_gid: np.ndarray         # (P, n_node_loc) int64
    ndof_p: np.ndarray           # (P,) true local dof counts
    nnode_p: np.ndarray          # (P,) true local node counts

    elem_part: np.ndarray        # (n_elem,) the element->part map used

    # Cohesive interface springs (model.interface_springs), padded per part:
    # local dof ids (n_loc padding) + stiffness (0 padding); None if the
    # model has no interface elements.
    spr_a: Optional[np.ndarray] = None   # (P, NS) int32
    spr_b: Optional[np.ndarray] = None   # (P, NS) int32
    spr_k: Optional[np.ndarray] = None   # (P, NS) float

    # The global layout glue this partition was built against, and the
    # part range whose rows are populated — (0, n_parts) for a full build.
    layout: Optional["PartitionLayout"] = None
    part_range: Optional[Tuple[int, int]] = None


class SerialComm:
    """No-op reduction group: the single-process degenerate of the
    sharded-build exchange protocol (every reduction input already IS
    the global value).  A multi-process twin comes with sharding
    (ROADMAP queue 1 item 12)."""

    n_procs = 1

    def allreduce(self, arr: np.ndarray, op: str) -> np.ndarray:
        return np.asarray(arr)

    def allreduce_many(self, arrs, op: str):
        """Reduce several same-op arrays in ONE exchange round (the
        multi-process impl packs them into a single collective — each
        round-trip costs a dispatch, so the layout exchange batches its
        sums/mins into one call each)."""
        return [self.allreduce(a, op) for a in arrs]

    def allreduce_groups(self, groups):
        """Several (arrays, op) groups in ONE exchange round: an
        allreduce is an allgather + a local reduce, so differently-
        reduced groups can still share a single collective payload (the
        multi-process impl packs everything into one int32 buffer).
        ``groups``: list of ``(list_of_arrays, op)``; returns the
        reduced array lists in order."""
        return [self.allreduce_many(arrs, op) for arrs, op in groups]


@dataclasses.dataclass
class PartitionLayout:
    """Global layout 'glue' of a partition build: everything a per-part
    build phase needs beyond its own parts — padded local sizes, the
    interface (shared-dof) set + owners, per-type padding, spring/ELL
    pad widths.  Under a sharded build this is the ONLY globally
    assembled state (counts/owners exchanged via ``SetupComm``
    reductions); the heavy per-part structures never leave their
    process."""

    n_parts: int
    n_loc: int
    n_node_loc: int
    node_layout: bool
    ndof_p: np.ndarray             # (P,) true local dof counts
    nnode_p: np.ndarray            # (P,)
    iface_gid: np.ndarray          # global dof ids present in >= 2 parts
    iface_owner: np.ndarray
    niface_gid: np.ndarray
    niface_owner: np.ndarray
    type_N: Dict[int, int]         # type id -> padded per-part width (0=skip)
    NS: int                        # padded spring width (0 = no springs)
    have_springs: bool
    NI: Optional[int] = None       # padded iface map width (resolved lazily)
    NNI: Optional[int] = None
    K: Optional[int] = None        # ELL width (resolved lazily)


def _node_layout_local(model, dof_gids: dict, node_gids: dict,
                       elems_ok: bool) -> bool:
    """The node-interleaved-dof condition evaluated on THIS process's
    parts (see the comment at the n_loc computation); AND-reduced across
    processes under a sharded build.  ``elems_ok`` is the per-element
    interleave check, evaluated on the local parts' CSR slices during
    the renumbering loop (the parts of all processes tile every element,
    so the AND-reduction covers the model without any process paying an
    O(total-connectivity) pass)."""
    return bool(
        elems_ok
        and len(model.elem_dofs_flat) == 3 * len(model.elem_nodes_flat)
        and np.array_equal(np.asarray(model.elem_dofs_offset),
                           3 * np.asarray(model.elem_nodes_offset))
        and all(
            len(dof_gids[p]) == 3 * len(node_gids[p])
            and np.array_equal(
                dof_gids[p],
                (3 * node_gids[p][:, None] + np.arange(3)).ravel())
            for p in dof_gids)
    )


def _compute_layout(model, P: int, local, type_elems, dof_gids, node_gids,
                    type_ids, spr_part, n_springs: int,
                    pad_multiple: int, comm,
                    nl_elems_ok: bool = True) -> PartitionLayout:
    """Phase-A merge: per-part counts + shared-dof counts/owners from the
    local parts, reduced across the group into the global layout."""
    I32MAX = np.iinfo(np.int32).max
    ndof_p = np.zeros(P, dtype=np.int64)
    nnode_p = np.zeros(P, dtype=np.int64)
    dof_count = np.zeros(model.n_dof, dtype=np.int32)
    dof_owner = np.full(model.n_dof, I32MAX, dtype=np.int32)
    node_count = np.zeros(model.n_node, dtype=np.int32)
    node_owner = np.full(model.n_node, I32MAX, dtype=np.int32)
    type_counts = np.zeros((len(type_ids), P), dtype=np.int64)
    spring_counts = np.zeros(P, dtype=np.int64)
    for p in local:
        g, gn = dof_gids[p], node_gids[p]
        ndof_p[p] = len(g)
        nnode_p[p] = len(gn)
        dof_count[g] += 1
        dof_owner[g] = np.minimum(dof_owner[g], p)
        node_count[gn] += 1
        node_owner[gn] = np.minimum(node_owner[gn], p)
        for ti, t in enumerate(type_ids):
            type_counts[ti, p] = len(type_elems[p][t])
        if spr_part is not None:
            spring_counts[p] = int(np.count_nonzero(spr_part == p))
    nl_local = _node_layout_local(model, dof_gids, node_gids, nl_elems_ok)

    sums, mins = comm.allreduce_groups([
        ([ndof_p, nnode_p, dof_count, node_count, type_counts,
          spring_counts], "sum"),
        ([np.asarray([int(nl_local)], dtype=np.int64)], "min"),
    ])
    (ndof_p, nnode_p, dof_count, node_count, type_counts,
     spring_counts) = sums
    node_layout = bool(int(mins[0][0]))
    # springs need no exchange: every process of a sharded FULL-model
    # build derives the identical spring list from the identical model,
    # and slab-ingested views reject interface elements outright
    have_springs = n_springs > 0

    n_node_loc = int(-(-int(nnode_p.max()) // pad_multiple) * pad_multiple)
    # Keep n_loc = 3*n_node_loc so the dof vector reshapes to (n_node, 3)
    # rows for the node-wise gather/scatter fast path.  The ELL path assumes
    # node-interleaved dofs at BOTH levels: per element
    # (elem_dofs[e][3a+c] == 3*elem_nodes[e][a]+c, which Ke4/sign_nc rely
    # on) and per part (dof_gid == 3*node_gid+c, which the x3 reshape
    # relies on — springs can break it by pulling in node-less dofs).
    if node_layout:
        n_loc = 3 * n_node_loc
    else:
        n_loc = int(-(-int(ndof_p.max()) // pad_multiple) * pad_multiple)

    iface_gid = np.where(dof_count >= 2)[0]
    niface_gid = np.where(node_count >= 2)[0]
    # Owners only matter on the SHARED (interface) ids — exchange them
    # sparsely (surface-scale, not O(n_dof)): every process derives the
    # identical iface sets from the reduced counts, so the min-reduce of
    # the restricted owner slices lines up position-for-position.
    # Padded to a power-of-two length so the data-dependent payload
    # shape reuses a handful of compiled exchange programs.
    n_if, n_nif = len(iface_gid), len(niface_gid)
    pad = max(1 << (max(n_if + n_nif, 1) - 1).bit_length(), 16)
    own = np.full(pad, np.iinfo(np.int32).max, dtype=np.int32)
    own[:n_if] = dof_owner[iface_gid]
    own[n_if:n_if + n_nif] = node_owner[niface_gid]
    (own,), = comm.allreduce_groups([([own], "min")])
    iface_owner = own[:n_if].copy()
    niface_owner = own[n_if:n_if + n_nif].copy()
    type_N = {}
    for ti, t in enumerate(type_ids):
        N_t = int(type_counts[ti].max()) if P else 0
        type_N[t] = (int(-(-N_t // pad_multiple) * pad_multiple)
                     if N_t > 0 else 0)
    NS = 0
    if have_springs:
        NS = int(spring_counts.max())
        NS = max(int(-(-NS // pad_multiple) * pad_multiple), 1)
    return PartitionLayout(
        n_parts=P, n_loc=n_loc, n_node_loc=n_node_loc,
        node_layout=node_layout, ndof_p=ndof_p, nnode_p=nnode_p,
        iface_gid=iface_gid, iface_owner=iface_owner,
        niface_gid=niface_gid, niface_owner=niface_owner,
        type_N=type_N, NS=NS, have_springs=have_springs)


def partition_model(
    model: ModelData,
    n_parts: int,
    elem_part: Optional[np.ndarray] = None,
    pad_multiple: int = 8,
    method: str = "rcb",
    block_filter: Optional[np.ndarray] = None,
    part_range: Optional[Tuple[int, int]] = None,
    comm=None,
    layout: Optional["PartitionLayout"] = None,
    slab2_slabs: int = 1,
) -> PartitionedModel:
    """Partition ``model`` into ``n_parts`` padded shards (the JAX
    package's full build, array for array).

    ``elem_part`` is an explicit element -> part map; without it the map
    comes from ``make_elem_part(model, n_parts, method)`` with ``n_slabs =
    slab2_slabs``.  ``pad_multiple`` pads the local node/dof counts and
    each type's per-part element count.  ``block_filter`` (bool, n_elem):
    elements with False still belong to their part (their nodes, dofs,
    weights and interface maps are local) but leave the type blocks and
    the ELL; the hybrid backend (``parallel/hybrid.py``) applies their
    stiffness through its level grids.  A filter that leaves no type block
    gives ``ell`` None and empty ``type_blocks``, as in the JAX package.
    The JAX package's sharded-setup arguments are refused: ``part_range``,
    ``comm`` and ``layout`` belong to multi-process sharding (ROADMAP
    queue 1 item 12)."""
    for name, value, item in (("part_range", part_range, 12),
                              ("comm", comm, 12), ("layout", layout, 12)):
        if value is not None:
            raise NotImplementedError(
                f"partition_model({name}=...) is not ported yet (ROADMAP "
                f"queue 1 item {item})")
    if elem_part is None:
        if getattr(model, "elem_ids", None) is not None:
            raise ValueError(
                "partition_model: a slab-ingested model view needs an "
                "explicit slab-positional elem_part")
        elem_part = make_elem_part(model, n_parts, method=method,
                                   n_slabs=slab2_slabs)
    elem_part = np.asarray(elem_part)
    if elem_part.shape != (model.n_elem,):
        raise ValueError(f"elem_part must be ({model.n_elem},), got "
                         f"{elem_part.shape}")
    if model.n_elem and (elem_part.min() < 0
                         or elem_part.max() >= n_parts):
        raise ValueError(f"elem_part values must lie in [0, {n_parts})")

    P = n_parts
    lo, hi = 0, P
    local = range(lo, hi)
    comm = SerialComm()
    type_ids = sorted(model.elem_lib.keys())
    # Per-part element id lists (LOCAL parts only — under a sharded build
    # the other parts' elements are never touched; ids are positional in
    # the model's element arrays, which for a slab model cover only the
    # slab)
    part_elems = {p: np.where(elem_part == p)[0] for p in local}

    # ---- interface springs: assigned to the part of their anchor element --
    spr_ga, spr_gb, spr_gk, spr_adj = model.interface_springs()
    spr_part = elem_part[spr_adj] if len(spr_ga) > 0 else None

    # ---- local dof/node renumbering per part ------------------------------
    dof_gids: Dict[int, np.ndarray] = {}
    node_gids: Dict[int, np.ndarray] = {}
    nl_elems_ok = True
    r3 = np.arange(3)
    for p in local:
        e = part_elems[p]
        # All models here have constant dofs-per-elem within a type; gather
        # ragged CSR slices via offsets.
        dof_idx = _csr_take(model.elem_dofs_flat, model.elem_dofs_offset, e)
        node_idx = _csr_take(model.elem_nodes_flat, model.elem_nodes_offset, e)
        if nl_elems_ok:
            # per-element node-interleave condition, checked on the
            # local CSR slices (every process's parts together tile all
            # elements — _node_layout_local)
            nl_elems_ok = (
                len(dof_idx) == 3 * len(node_idx)
                and np.array_equal(
                    dof_idx, (3 * node_idx[:, None] + r3).ravel()))
        if spr_part is not None:
            # both sides of a part's springs must be locally addressable;
            # any cross-part sharing this creates is resolved by the normal
            # interface-dof assembly (a dof in >= 2 parts is summed across
            # them)
            m = spr_part == p
            dof_idx = np.concatenate([dof_idx, spr_ga[m], spr_gb[m]])
        dof_gids[p] = _unique(dof_idx)
        node_gids[p] = _unique(node_idx)

    # per-(part, type) element lists, computed ONCE and shared by the
    # layout counts and the type-block build (the elem_type gather per
    # part is O(local elements) — doing it twice would double-pay on
    # the timed cold path)
    type_elems: Dict[int, Dict[int, np.ndarray]] = {}
    for p in local:
        et = model.elem_type[part_elems[p]]
        per_t = {}
        for t in type_ids:
            e = part_elems[p][et == t]
            if block_filter is not None:
                e = e[block_filter[e]]
            per_t[t] = e
        type_elems[p] = per_t

    layout = _compute_layout(
        model, P, local, type_elems, dof_gids, node_gids, type_ids,
        spr_part, len(spr_ga), pad_multiple, comm,
        nl_elems_ok=nl_elems_ok)
    n_loc, n_node_loc = layout.n_loc, layout.n_node_loc
    node_layout = layout.node_layout
    ndof_p, nnode_p = layout.ndof_p, layout.nnode_p
    have_springs = layout.have_springs

    iface_gid, iface_owner = layout.iface_gid, layout.iface_owner
    niface_gid, niface_owner = layout.niface_gid, layout.niface_owner
    n_iface = len(iface_gid)
    n_node_iface = len(niface_gid)

    # ---- per-part padded nodal arrays -------------------------------------
    weight = np.zeros((P, n_loc))
    node_weight = np.zeros((P, n_node_loc))
    eff = np.zeros((P, n_loc))
    F = np.zeros((P, n_loc))
    Ud = np.zeros((P, n_loc))
    inv_diag_M = np.zeros((P, n_loc))
    dof_gid_arr = np.full((P, n_loc), -1, dtype=np.int64)
    node_gid_arr = np.full((P, n_node_loc), -1, dtype=np.int64)

    iface_local_l, iface_slot_l = {}, {}
    niface_local_l, niface_slot_l = {}, {}

    eff_mask_glob = np.zeros(model.n_dof, dtype=bool)
    eff_mask_glob[np.asarray(model.dof_eff)] = True

    for p in local:
        g = dof_gids[p]
        n = len(g)
        dof_gid_arr[p, :n] = g
        node_gid_arr[p, : nnode_p[p]] = node_gids[p]
        F[p, :n] = model.F[g]
        Ud[p, :n] = model.Ud[g]
        with np.errstate(divide="ignore"):
            inv_diag_M[p, :n] = np.where(model.diag_M[g] > 0, 1.0 / model.diag_M[g], 0.0)
        eff[p, :n] = eff_mask_glob[g].astype(float)

        # weights: 1 iff this part owns the dof (owner = lowest part id).
        w = np.ones(n)
        if n_iface > 0:
            pos = np.searchsorted(iface_gid, g)
            is_if = (pos < n_iface) & (iface_gid[np.minimum(pos, n_iface - 1)] == g)
            w[is_if] = (iface_owner[pos[is_if]] == p).astype(float)
        else:
            pos = np.zeros(n, dtype=np.int64)
            is_if = np.zeros(n, dtype=bool)
        weight[p, :n] = w

        nw = np.ones(nnode_p[p])
        gn = node_gids[p]
        if n_node_iface > 0:
            npos = np.searchsorted(niface_gid, gn)
            nis_if = (npos < n_node_iface) & (niface_gid[np.minimum(npos, n_node_iface - 1)] == gn)
            nw[nis_if] = (niface_owner[npos[nis_if]] == p).astype(float)
        else:
            npos = np.zeros(len(gn), dtype=np.int64)
            nis_if = np.zeros(len(gn), dtype=bool)
        node_weight[p, : nnode_p[p]] = nw

        # interface maps for this part
        iface_local_l[p] = np.where(is_if)[0].astype(np.int32)
        iface_slot_l[p] = pos[is_if].astype(np.int32)
        niface_local_l[p] = np.where(nis_if)[0].astype(np.int32)
        niface_slot_l[p] = npos[nis_if].astype(np.int32)

    # (iface maps padded below — the NI/NNI/K pad widths resolve in ONE
    # exchange round after the ELL multiplicities are known)

    # ---- type blocks ------------------------------------------------------
    type_blocks: List[TypeBlock] = []
    E_by_mat = np.array([m["E"] for m in model.mat_prop])
    for t in type_ids:
        lib = model.elem_lib[t]
        d = lib["Ke"].shape[0]
        nn = lib["n_nodes"]
        per_part = {p: type_elems[p][t] for p in local}
        N_t = layout.type_N[t]
        if N_t == 0:
            continue

        dof = np.full((P, d, N_t), n_loc, dtype=np.int32)
        sign = np.zeros((P, d, N_t), dtype=bool)
        node = np.full((P, nn, N_t), n_node_loc, dtype=np.int32)
        ck = np.zeros((P, N_t))
        ce = np.zeros((P, N_t))
        e_mod = np.zeros((P, N_t))
        valid = np.zeros((P, N_t), dtype=bool)
        n_elem_t = np.zeros(P, dtype=np.int64)

        for p in local:
            e = per_part[p]
            ne = len(e)
            n_elem_t[p] = ne
            if ne == 0:
                continue
            gd = _csr_take(model.elem_dofs_flat, model.elem_dofs_offset, e).reshape(ne, d)
            gs = _csr_take(model.elem_sign_flat, model.elem_dofs_offset, e).reshape(ne, d)
            gn_ = _csr_take(model.elem_nodes_flat, model.elem_nodes_offset, e).reshape(ne, nn)
            dof[p, :, :ne] = np.searchsorted(dof_gids[p], gd).T
            sign[p, :, :ne] = gs.T
            node[p, :, :ne] = np.searchsorted(node_gids[p], gn_).T
            ck[p, :ne] = model.ck[e]
            ce[p, :ne] = model.ce[e]
            e_mod[p, :ne] = E_by_mat[model.poly_mat[e]]
            valid[p, :ne] = True

        type_blocks.append(
            TypeBlock(
                type_id=t, d=d, n_nodes=nn,
                Ke=np.asarray(lib["Ke"], dtype=np.float64),
                diag_Ke=np.asarray(lib["diagKe"], dtype=np.float64),
                Se=np.asarray(lib["Se"], dtype=np.float64) if lib.get("Se") is not None else None,
                Me=np.asarray(lib.get("Me"), dtype=np.float64) if lib.get("Me") is not None else None,
                dof=dof, sign=sign, node=node, ck=ck, ce=ce, e_mod=e_mod,
                valid=valid, n_elem=n_elem_t,
            )
        )

    # ---- flat scatter maps (concatenated type blocks, pre-sorted) ---------
    NC = sum(tb.d * tb.dof.shape[2] for tb in type_blocks)
    scat_perm = np.zeros((P, NC), dtype=np.int32)
    scat_ids = np.zeros((P, NC), dtype=np.int32)
    for p in (local if type_blocks else ()):
        flat = np.concatenate([tb.dof[p].ravel() for tb in type_blocks])
        nat = native.sort_i32(flat.astype(np.int32))
        if nat is not None:
            scat_perm[p], scat_ids[p] = nat
        else:
            perm = np.argsort(flat, kind="stable")
            scat_perm[p] = perm
            scat_ids[p] = flat[perm]

    # ---- node-ELL multiplicities (fill deferred) ---------------------------
    want_ell = node_layout and bool(type_blocks)
    seg_data = {}
    K_loc = 1
    if want_ell:
        n_slots = sum(tb.n_nodes * tb.node.shape[2] for tb in type_blocks)
        for p in local:
            # slot id = block_base + node_slot*N_blk + elem  (ravel of (nn, N))
            ids_n = np.concatenate([tb.node[p].reshape(-1) for tb in type_blocks])
            valid = ids_n < n_node_loc        # padded slots point out of range
            slots = np.where(valid)[0].astype(np.int64)
            ids_v = ids_n[valid].astype(np.int64)
            order = np.argsort(ids_v, kind="stable")
            ids_s, slots_s = ids_v[order], slots[order]
            counts = np.bincount(ids_s, minlength=n_node_loc)
            K_loc = max(K_loc, int(counts.max()) if len(counts) else 0)
            seg_data[p] = (ids_s, slots_s, counts)

    # ---- the ONE pad-width exchange round (NI/NNI/K) ----------------------
    if layout.NI is None or (want_ell and layout.K is None):
        (dims,), = comm.allreduce_groups([([np.asarray(
            [max((len(a) for a in iface_local_l.values()), default=0),
             max((len(a) for a in niface_local_l.values()), default=0),
             K_loc], dtype=np.int64)], "max")])
        layout.NI = max(int(dims[0]), 1)
        layout.NNI = max(int(dims[1]), 1)
        layout.K = int(dims[2])
    NI, NNI = int(layout.NI), int(layout.NNI)
    iface_local = np.stack(
        [_pad_to(iface_local_l.get(p, np.zeros(0, np.int32)), NI,
                 n_loc) for p in range(P)])
    iface_slot = np.stack(
        [_pad_to(iface_slot_l.get(p, np.zeros(0, np.int32)), NI,
                 n_iface) for p in range(P)])
    niface_local = np.stack(
        [_pad_to(niface_local_l.get(p, np.zeros(0, np.int32)), NNI,
                 n_node_loc) for p in range(P)])
    niface_slot = np.stack(
        [_pad_to(niface_slot_l.get(p, np.zeros(0, np.int32)), NNI,
                 n_node_iface) for p in range(P)])

    # ---- node-ELL scatter map fill ----------------------------------------
    ell = None
    if want_ell:
        K = int(layout.K)
        ell = np.full((P, n_node_loc, K), n_slots, dtype=np.int32)
        for p in local:
            ids_s, slots_s, counts = seg_data[p]
            off = np.concatenate([[0], np.cumsum(counts)])
            rank = np.arange(len(ids_s)) - off[ids_s]
            ell[p][ids_s, rank] = slots_s

    # ---- padded interface-spring arrays -----------------------------------
    spr_a = spr_b = spr_k = None
    if have_springs:
        NS = layout.NS
        spr_a = np.full((P, NS), n_loc, dtype=np.int32)
        spr_b = np.full((P, NS), n_loc, dtype=np.int32)
        spr_k = np.zeros((P, NS))
        for p in local:
            s = np.where(spr_part == p)[0]
            ns = len(s)
            if ns == 0:
                continue
            spr_a[p, :ns] = np.searchsorted(dof_gids[p], spr_ga[s])
            spr_b[p, :ns] = np.searchsorted(dof_gids[p], spr_gb[s])
            spr_k[p, :ns] = spr_gk[s]

    return PartitionedModel(
        n_parts=P,
        n_loc=n_loc,
        n_node_loc=n_node_loc,
        n_iface=n_iface,
        n_node_iface=n_node_iface,
        glob_n_dof=model.n_dof,
        glob_n_dof_eff=len(model.dof_eff),
        glob_n_node=model.n_node,
        type_blocks=type_blocks,
        scat_perm=scat_perm,
        scat_ids=scat_ids,
        ell=ell,
        node_layout=node_layout,
        iface_local=iface_local,
        iface_slot=iface_slot,
        niface_local=niface_local,
        niface_slot=niface_slot,
        weight=weight,
        node_weight=node_weight,
        eff=eff,
        F=F,
        Ud=Ud,
        inv_diag_M=inv_diag_M,
        dof_gid=dof_gid_arr,
        node_gid=node_gid_arr,
        ndof_p=ndof_p,
        nnode_p=nnode_p,
        elem_part=elem_part,
        spr_a=spr_a,
        spr_b=spr_b,
        spr_k=spr_k,
        layout=layout,
        part_range=(lo, hi),
    )


def _pad_to(x: np.ndarray, n: int, fill) -> np.ndarray:
    out = np.full((n,) + x.shape[1:], fill, dtype=x.dtype)
    out[: len(x)] = x
    return out


def _unique(ids: np.ndarray) -> np.ndarray:
    """Sorted unique ids as int64, by the native prep kernel when it
    applies (the np.unique half of config_ElemVectors,
    partition_mesh.py:272-286); the numpy form casts to int64 too, as the
    native kernel returns."""
    nat = native.unique_renumber(ids, renumber=False)
    if nat is not None:
        return nat[0]
    return np.unique(np.asarray(ids, dtype=np.int64))


def _csr_take(flat: np.ndarray, offset: np.ndarray, elems: np.ndarray) -> np.ndarray:
    """Concatenate flat[offset[e]:offset[e+1]] for e in elems (the native
    kernel when it applies, else vectorized numpy; the loop the reference
    marked TODO-Cython, partition_mesh.py:244-255)."""
    if len(elems) == 0:
        return flat[:0]
    nat = native.csr_take(flat, offset, elems)
    if nat is not None:
        return nat
    starts = offset[elems]
    ends = offset[elems + 1]
    lens = ends - starts
    # Vectorized ragged-range: cumsum of a step vector walks each CSR slice.
    total = int(lens.sum())
    out_idx = np.ones(total, dtype=np.int64)
    cum = np.cumsum(lens)[:-1]
    out_idx[0] = starts[0]
    if len(elems) > 1:
        out_idx[cum] = starts[1:] - (starts[:-1] + lens[:-1]) + 1
    return flat[np.cumsum(out_idx)]


def _fields_of(obj) -> dict:
    if dataclasses.is_dataclass(obj):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    return dict(obj)


def _converted(cls, arrays: dict, ints=(), flags=(), keep=()) -> dict:
    """``cls``'s fields from ``arrays``: ints, bools, values kept as they
    are, and numpy arrays (None stays None)."""
    names = [f.name for f in dataclasses.fields(cls)]
    missing = [n for n in names if n not in arrays]
    if missing:
        raise ValueError(f"{cls.__name__} arrays missing fields {missing}")
    conv = {}
    for n in names:
        v = arrays[n]
        conv[n] = (v if v is None or n in keep else int(v) if n in ints
                   else bool(v) if n in flags else np.asarray(v))
    return conv


def partition_from_numpy(arrays) -> PartitionedModel:
    """A ``PartitionedModel`` from the fields of one built elsewhere —
    e.g. by the JAX package — given as a dict (or any dataclass with the
    same field names), its ``type_blocks`` as dicts or dataclasses with
    ``TypeBlock``'s fields and its ``layout`` likewise (or None), so both
    packages run on bit-identical inputs.  The arrays are taken as they
    are; their shapes are checked against the sizes they claim."""
    a = _fields_of(arrays)
    a["type_blocks"] = [TypeBlock(**_converted(
        TypeBlock, _fields_of(tb), ints=("type_id", "d", "n_nodes")))
        for tb in a.get("type_blocks", ())]
    if a.get("layout") is not None:
        lay = _converted(
            PartitionLayout, _fields_of(a["layout"]),
            ints=("n_parts", "n_loc", "n_node_loc", "NS", "NI", "NNI", "K"),
            flags=("node_layout", "have_springs"), keep=("type_N",))
        lay["type_N"] = {int(k): int(v) for k, v in lay["type_N"].items()}
        a["layout"] = PartitionLayout(**lay)
    pr = a.get("part_range")
    pm = PartitionedModel(**_converted(
        PartitionedModel, a, flags=("node_layout",),
        keep=("type_blocks", "layout", "part_range"),
        ints=("n_parts", "n_loc", "n_node_loc", "n_iface", "n_node_iface",
              "glob_n_dof", "glob_n_dof_eff", "glob_n_node")))
    pm.part_range = (0, pm.n_parts) if pr is None else tuple(
        int(v) for v in pr)
    P, n_loc, nnl = pm.n_parts, pm.n_loc, pm.n_node_loc
    for n in ("weight", "eff", "F", "Ud", "inv_diag_M", "dof_gid"):
        if getattr(pm, n).shape != (P, n_loc):
            raise ValueError(f"{n} must be {(P, n_loc)}, got "
                             f"{getattr(pm, n).shape}")
    for n in ("node_weight", "node_gid"):
        if getattr(pm, n).shape != (P, nnl):
            raise ValueError(f"{n} must be {(P, nnl)}, got "
                             f"{getattr(pm, n).shape}")
    if pm.ell is not None and (pm.ell.ndim != 3
                               or pm.ell.shape[:2] != (P, nnl)):
        raise ValueError(f"ell must be ({P}, {nnl}, K), got {pm.ell.shape}")
    for tb in pm.type_blocks:
        N = tb.ck.shape[1]
        if (tb.Ke.shape != (tb.d, tb.d) or tb.dof.shape != (P, tb.d, N)
                or tb.node.shape != (P, tb.n_nodes, N)
                or tb.sign.shape != (P, tb.d, N) or tb.ck.shape != (P, N)):
            raise ValueError(f"type block {tb.type_id}: arrays do not match "
                             f"d={tb.d}, n_nodes={tb.n_nodes}, P={P}")
    return pm

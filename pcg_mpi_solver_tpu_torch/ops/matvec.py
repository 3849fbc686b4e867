"""The operator protocol of the PCG stack, and the general backend.

Port of ``pcg_mpi_solver_tpu/ops/matvec.py``: ``Ops`` with the
static-shape fields (with ``mg_degree``, the V-cycle's Chebyshev
degree), the owner-weighted dots (``_local_dot`` / ``wdot`` / ``wdots``)
and their per-column twins for a block of right-hand sides
(``wdot_many`` / ``wdots_many``), the node-row views ``_as_node3`` /
``_from_node3``, ``block_precond`` and ``apply_prec`` (scalar Jacobi,
3x3 block Jacobi, and the mg V-cycle of ``ops/mg.py``), and the general
(pattern-type) operator on a ``PartitionedModel``: ``device_data``,
``Ops.from_model``, ``matvec_local`` / ``matvec`` / ``diag`` /
``node_block_diag`` and the interface assembly.  The structured slab
backend (``parallel/structured.py::StructuredOps``) overrides the
operator.  Vectors are ``(P, n_loc)`` tensors with one row per part; a
block of R right-hand sides is ``(R, P, n_loc)``, the column axis leading
(the JAX package carries it trailing, ``(P, n_loc, R)``), so a column is
one contiguous vector.  The parts of one process are all on one device,
so the cross-process reduction (``_psum``) is the identity.

The general matvec computes what the JAX package's per-type loop does:
per element ``v = S Ke (ck S u)`` with u gathered from the element's node
rows (or dof rows when the model is not 3 dofs a node), and each local
row the sum of its element contributions over the partition's ELL map, in
the JAX package's order.  The JAX package emits one gather/einsum/sign
structure per pattern type (227 at the 22^3 octree), which XLA fuses into
one program; eager PyTorch would pay ~6 launches a type.  So, once on the
host, each type is split by its elements' sign rows (a mirrored instance
flips whole components, so the signs fold exactly into ``S Ke S``) and
the resulting sub-types are stacked into a few buckets
(:func:`plan_buckets`) whose element slots and arity are zero-padded to
the bucket's largest: one gather, one scale and one batched product per
bucket, then one ELL gather and one row sum.  The ELL's slot ids are
remapped into the stacked layout, so each row sums its contributions in
the JAX package's order and padded slots are never read.  Nothing on the
path is a float atomic: the ELL sums, the interface assembly and the
cohesive springs all gather through fixed-order contributor maps built
on the host, so two matvecs on the card give the same bits.  Index
tensors are int32 (the 22^3 octree gathers ~13 M rows a matvec); the few
maps that write through ``index_copy`` are int64, as it requires.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from pcg_mpi_solver_tpu_torch.ops.mg import mg_apply
from pcg_mpi_solver_tpu_torch.ops.precond import invert_node_blocks
from pcg_mpi_solver_tpu_torch.parallel.partition import PartitionedModel

# row stride (elements) of the per-column dot buffer on the card: 256
# bytes in float32, 512 in float64
_ROW_ALIGN = 64


@dataclasses.dataclass(frozen=True)
class Ops:
    """Static-shape metadata + the operator methods."""

    n_loc: int
    n_iface: int
    n_node_loc: int = 0
    n_node_iface: int = 0
    dot_dtype: torch.dtype = torch.float64
    # Chebyshev degree of the mg V-cycle's smoother (precond="mg"), set by
    # Solver from SolverConfig.mg_smooth_degree
    mg_degree: int = 2
    # General backend layout (Ops.from_model): parts, row width (3 = node
    # rows on the node-ELL path, 1 = dof rows on the flat path), one
    # (T, M, nr, d, base_row) per bucket of the stacked value rows, their
    # total, and the ELL width
    n_parts: int = 1
    row_width: int = 3
    buckets: Tuple[Tuple[int, int, int, int, int], ...] = ()
    n_vrows: int = 0
    ell_k: int = 0

    @classmethod
    def from_model(cls, pm: PartitionedModel,
                   dot_dtype: torch.dtype = torch.float64,
                   mg_degree: int = 2, bucket_values: float = None):
        """The general operator's static layout for ``pm`` (the same
        :func:`plan_buckets` grouping :func:`device_data` uploads)."""
        lay = _layout(pm, bucket_values)
        return cls(n_loc=pm.n_loc, n_iface=pm.n_iface,
                   n_node_loc=pm.n_node_loc, n_node_iface=pm.n_node_iface,
                   dot_dtype=dot_dtype, mg_degree=mg_degree,
                   n_parts=pm.n_parts, row_width=lay.width,
                   buckets=tuple(lay.shapes), n_vrows=lay.n_vrows,
                   ell_k=lay.K)

    @property
    def use_node_ell(self) -> bool:
        return self.row_width == 3

    def _psum(self, x: torch.Tensor) -> torch.Tensor:
        """Cross-process sum: the identity while the port runs in one
        process (multi-process sharding is ROADMAP queue 1 item 12)."""
        return x

    def _as_node3(self, v: torch.Tensor) -> torch.Tensor:
        """([R,] P, n_loc) dof vector -> ([R,] P, n_node_loc, 3) node rows
        (the node-contiguous layout; StructuredOps overrides it for its
        component-major grid layout)."""
        return v.reshape(*v.shape[:-1], self.n_node_loc, 3)

    def _from_node3(self, z3: torch.Tensor) -> torch.Tensor:
        """Inverse of :meth:`_as_node3`."""
        return z3.reshape(*z3.shape[:-2], self.n_loc)

    def block_precond(self, data: dict) -> torch.Tensor:
        """Inverted eff-masked node blocks (P, n_node_loc, 3, 3), ready
        for ``apply_prec``."""
        return invert_node_blocks(self.node_block_diag(data),
                                  self._as_node3(data["eff"]))

    def apply_prec(self, m, r: torch.Tensor, data: dict = None
                   ) -> torch.Tensor:
        """z = M^-1 r: elementwise for the scalar Jacobi inverse (P,
        n_loc), a 3x3 product per node for the block-Jacobi inverse (P,
        n_node_loc, 3, 3), or one V-cycle when ``m`` is the mg prec dict
        (``data`` is then the device tree the hierarchy rides).  ``r``
        may be a block (R, P, n_loc): the operand broadcasts over its
        leading column axis."""
        if isinstance(m, dict):
            return mg_apply(self, data, m, r)
        if m.dim() == 2:
            return m * r
        z3 = (m * self._as_node3(r)[..., None, :]).sum(dim=-1)
        return self._from_node3(z3)

    def block_data(self, data: dict, R: int) -> dict:
        """The device tree a block of ``R`` right-hand sides runs on: the
        general operator's tree serves every width (its maps broadcast
        over the leading column axis), so this is ``data`` itself.  The
        structured backend overrides it (cell scales repeated per
        column)."""
        return data

    # -- interface assembly --------------------------------------------
    def _assemble_shared(self, y: torch.Tensor, amap: dict,
                         n_glob: int) -> torch.Tensor:
        """Sum the partial values of ids shared by several parts.  ``y``
        is (R, P * n, c): the shared entries are gathered (``src``), each
        global id sums its contributors over ``ell`` (part order, padded
        slots read an appended zero), and the sums are written back to
        every copy (``index_copy_``, distinct positions).  No float
        atomics: the same bits on every run."""
        R, _, c = y.shape
        vals = y.index_select(1, amap["src"])
        ext = torch.cat([vals, vals.new_zeros((R, 1, c))], dim=1)
        glob = ext.index_select(1, amap["ell"].reshape(-1)).reshape(
            R, n_glob, -1, c).sum(dim=2)
        return y.index_copy(1, amap["dst"], glob.index_select(1,
                                                              amap["slot"]))

    def iface_assemble(self, data: dict, y: torch.Tensor) -> torch.Tensor:
        """Dof-space assembly: ([R,] P, n_loc) partial sums -> fully
        assembled."""
        if self.n_iface == 0:
            return y
        out = self._assemble_shared(y.reshape(-1, self.n_parts * self.n_loc,
                                              1),
                                    data["iface"], self.n_iface)
        return out.reshape(y.shape)

    def niface_assemble(self, data: dict, y: torch.Tensor) -> torch.Tensor:
        """Node-space assembly of (P, n_node_loc, c) stacked channels."""
        if self.n_node_iface == 0:
            return y
        out = self._assemble_shared(
            y.reshape(1, self.n_parts * self.n_node_loc, -1),
            data["niface"], self.n_node_iface)
        return out.reshape(y.shape)

    # -- gather/scatter primitives -------------------------------------
    def _gather_u(self, xr: torch.Tensor, bkt: dict, shape) -> torch.Tensor:
        """Element values of one bucket, (R, T, M, d): the element rows
        of ``xr`` (R, P * rows, w), node rows (the JAX package's
        ``_gather_u3``) or dof rows (its flat ``_gather_u``)."""
        T, M, _nr, d, _base = shape
        return xr.index_select(1, bkt["gidx"]).view(xr.shape[0], T, M, d)

    def _value_rows(self, R: int, width: int, dtype, device) -> torch.Tensor:
        """The stacked element-value rows (R, n_vrows + 1, width), the last
        row zero (every padded ELL slot reads it)."""
        vbuf = torch.empty((R, self.n_vrows + 1, width), dtype=dtype,
                           device=device)
        vbuf[:, -1].zero_()
        return vbuf

    def _bucket_rows(self, vbuf: torch.Tensor, shape) -> torch.Tensor:
        """Bucket ``shape``'s slice of ``vbuf`` as (R, T, M, nr * width)."""
        T, M, nr, _d, base = shape
        return vbuf[:, base:base + T * M * nr].view(vbuf.shape[0], T, M, -1)

    def _scatter_rows(self, data: dict, vbuf: torch.Tensor) -> torch.Tensor:
        """Stacked value rows (R, n_vrows + 1, c) -> local row sums (R,
        P * rows, c): one gather over the ELL map and one sum over its K
        slots (the JAX package's ``_scatter_rows``, and its flat
        ``_scatter`` when rows are dofs); no scatter-add."""
        R, _, c = vbuf.shape
        g = vbuf.index_select(1, data["ell"].reshape(-1))
        return g.view(R, -1, self.ell_k, c).sum(dim=2)

    def _scatter_blocks(self, data: dict, vbuf: torch.Tensor,
                        shape) -> torch.Tensor:
        """Stacked element values -> local dof sums of ``shape`` ((P,
        n_loc) or (R, P, n_loc))."""
        return self._scatter_rows(data, vbuf).reshape(shape)

    # -- the matvec -----------------------------------------------------
    def matvec_local(self, data: dict, x: torch.Tensor) -> torch.Tensor:
        """Part-local K.x (no cross-part assembly).  x: (P, n_loc), or a
        block (R, P, n_loc) whose columns ride the leading axis of every
        gather and product."""
        R = x.shape[0] if x.dim() == 3 else 1
        w = self.row_width
        xr = x.reshape(R, -1, w)
        vbuf = self._value_rows(R, w, x.dtype, x.device)
        for bkt, shape in zip(data["buckets"], self.buckets):
            u = self._gather_u(xr, bkt, shape)
            u.mul_(bkt["ck"])
            # (S Ke S)(ck u), one element a row
            torch.matmul(u, bkt["KeT"], out=self._bucket_rows(vbuf, shape))
        y = self._scatter_blocks(data, vbuf, x.shape)
        return self._apply_springs(data, x, y)

    def matvec(self, data: dict, x: torch.Tensor) -> torch.Tensor:
        """Full assembled K.x across all parts; ``x`` may be a block (R,
        P, n_loc)."""
        return self.iface_assemble(data, self.matvec_local(data, x))

    def _spring_sums(self, spr: dict, first: torch.Tensor,
                     second: torch.Tensor) -> torch.Tensor:
        """Per spring dof, the sum of its contributions: ``first`` (R,
        P * NS) at its a-side springs, then ``second`` at its b-side ones,
        in the JAX package's order, over the fixed-order map ``ell``."""
        R = first.shape[0]
        vals = torch.cat([first, second, first.new_zeros((R, 1))], dim=1)
        return vals.index_select(1, spr["ell"].reshape(-1)).view(
            R, spr["ell"].shape[0], -1).sum(dim=2)

    def _apply_springs(self, data: dict, x: torch.Tensor,
                       y: torch.Tensor) -> torch.Tensor:
        """Cohesive interface springs: f_a += k*(x_a - x_b), f_b -= the
        same."""
        spr = data.get("springs")
        if spr is None:
            return y
        R = x.shape[0] if x.dim() == 3 else 1
        xf = x.reshape(R, -1)
        f = spr["k"] * (xf.index_select(1, spr["a"])
                        - xf.index_select(1, spr["b"]))
        yf = y.reshape(R, -1)
        add = yf.index_select(1, spr["dof"]) + self._spring_sums(spr, f, -f)
        return yf.index_copy(1, spr["dof"], add).reshape(y.shape)

    def diag_local(self, data: dict) -> torch.Tensor:
        """Part-local diag(K) through the same ELL sums (the diagonal of
        S Ke S is Ke's)."""
        ref = data["weight"]
        vbuf = self._value_rows(1, self.row_width, ref.dtype, ref.device)
        for bkt, shape in zip(data["buckets"], self.buckets):
            out = self._bucket_rows(vbuf, shape)[0]
            torch.mul(bkt["ck"], bkt["dKe"], out=out)
        y = self._scatter_blocks(data, vbuf, ref.shape)
        return self._apply_springs_diag(data, y)

    def _apply_springs_diag(self, data: dict, y: torch.Tensor
                            ) -> torch.Tensor:
        spr = data.get("springs")
        if spr is None:
            return y
        k = spr["k"][None]
        yf = y.reshape(1, -1)
        add = yf.index_select(1, spr["dof"]) + self._spring_sums(spr, k, k)
        return yf.index_copy(1, spr["dof"], add).reshape(y.shape)

    def diag(self, data: dict) -> torch.Tensor:
        return self.iface_assemble(data, self.diag_local(data))

    # -- element strain + nodal averaging (export path) -----------------
    def elem_strain(self, data: dict, x: torch.Tensor) -> list:
        """Per-bucket center-point strain eps = Se.(ce * S.u_e) in each
        pattern's local frame (reference updateElemStrain,
        pcg_solver.py:601-618): one (T, 6, M) tensor a bucket, element
        slot (t, m) as the matvec's (padded slots give 0).  Each element
        takes its sub-type's Se with the sign row folded in (``SeT``), so
        the signs flip no gathered value."""
        if not all("SeT" in b for b in data["buckets"]):
            raise ValueError("strain export unavailable: an element type "
                             "has no strain-mode matrix Se")
        xr = x.reshape(1, -1, self.row_width)
        out = []
        for bkt, shape in zip(data["buckets"], self.buckets):
            u = self._gather_u(xr, bkt, shape)[0]
            out.append(torch.matmul(u * bkt["ce"], bkt["SeT"])
                       .transpose(1, 2))
        return out

    def elem_scale(self, data: dict) -> list:
        """Per-bucket elastic modulus E = ck * ce (ck = E*h, ce = 1/h),
        (T, M)."""
        return [(b["ck"] * b["ce"])[..., 0] for b in data["buckets"]]

    def _node_sums(self, data: dict, vals_list) -> torch.Tensor:
        """Element values (a (T, k, M) tensor a bucket) -> per local node
        the sums of its elements' values and their count, (1, P *
        n_node_loc, k + 1): every element node row of the stacked layout
        holds its element's values and a 1, and each node sums its rows
        over the node ELL in the matvec's fixed order (padded slots are
        in no ELL row, so they count nothing)."""
        if not self.use_node_ell:
            raise ValueError(
                "nodal averaging needs the node-contiguous dof layout "
                "(PartitionedModel.ell); this model/partition lacks it")
        k = vals_list[0].shape[1] if vals_list else 1
        ref = data["weight"]
        vbuf = self._value_rows(1, k + 1, ref.dtype, ref.device)
        for vals, shape in zip(vals_list, self.buckets):
            T, M, nr, _d, _base = shape
            rows = self._bucket_rows(vbuf, shape)[0].view(T, M, nr, k + 1)
            rows[..., :k] = vals.transpose(1, 2)[:, :, None, :]
            rows[..., k] = 1
        return self._scatter_rows(data, vbuf)

    def _node_average(self, data: dict, sums: torch.Tensor,
                      k: int) -> torch.Tensor:
        """(1, P * n_node_loc, k + 1) local sums and counts -> the
        averaged nodal field (P, k, n_node_loc), shared nodes' sums and
        counts assembled across parts first (the reference's +1e-15
        guard, pcg_solver.py:724)."""
        both = self.niface_assemble(
            data, sums.reshape(self.n_parts, self.n_node_loc, k + 1))
        return (both[..., :k] / (both[..., k:] + 1e-15)).transpose(1, 2)

    def nodal_average(self, data: dict, vals_list) -> torch.Tensor:
        """Element values -> averaged nodal field (P, k, n_node_loc).

        ``vals_list``: per bucket (T, k, M) element-constant values
        (:meth:`elem_strain`'s layout).  Sums and counts over each node's
        elements, assembled across the parts sharing the node, divided
        (reference getNodalScalarVar/getNodalPS, pcg_solver.py:655-814)."""
        k = vals_list[0].shape[1]
        return self._node_average(data, self._node_sums(data, vals_list), k)

    # -- node-block (3x3) diagonal for block-Jacobi ---------------------
    def _node_block_local(self, data: dict) -> torch.Tensor:
        """Part-local per-node 3x3 diagonal blocks of K, (P * n_node_loc,
        9) row-major: every element adds ck * (S Ke S)[3a+i, 3a+j] to its
        node a's block, summed over the node ELL."""
        if not self.use_node_ell:
            raise ValueError(
                "block-Jacobi needs the node-contiguous dof layout "
                "(PartitionedModel.ell); this model/partition lacks it — "
                "use precond='jacobi'")
        ref = data["weight"]
        vbuf = self._value_rows(1, 9, ref.dtype, ref.device)
        for bkt, shape in zip(data["buckets"], self.buckets):
            T, M, nr, _d, _base = shape
            out = self._bucket_rows(vbuf, shape)[0].view(T, M, nr, 9)
            torch.mul(bkt["ck"][..., None], bkt["D9"], out=out)
        y = self._scatter_rows(data, vbuf)[0]
        return self._springs_into_blocks(data, y)

    def _springs_into_blocks(self, data: dict, out: torch.Tensor
                             ) -> torch.Tensor:
        """Cohesive-spring diagonal terms into the (i, i) entries of the
        endpoint nodes' blocks (off-node coupling is dropped, as scalar
        Jacobi drops it)."""
        spr = data.get("springs")
        if spr is None:
            return out
        k = spr["k"][None]
        flat = out.reshape(1, -1)
        add = (flat.index_select(1, spr["bpos"])
               + self._spring_sums(spr, k, k))
        return flat.index_copy(1, spr["bpos"], add).reshape(out.shape)

    def node_block_diag(self, data: dict) -> torch.Tensor:
        """Fully assembled per-node 3x3 diagonal blocks (P, n_node_loc, 3,
        3): local blocks summed across the parts sharing the node."""
        y = self._node_block_local(data).reshape(
            self.n_parts, self.n_node_loc, 9)
        y = self.niface_assemble(data, y)
        return y.reshape(self.n_parts, self.n_node_loc, 3, 3)

    # -- reductions -----------------------------------------------------
    def _local_dot(self, w, a, b) -> torch.Tensor:
        # Cast operands BEFORE multiplying: products of two f32 values are
        # exact in f64, so f32-storage runs get true f64-accumulated dots.
        dd = self.dot_dtype
        return torch.sum(a.to(dd) * b.to(dd) * w.to(dd))

    def wdot(self, w: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor) -> torch.Tensor:
        """Global weighted dot <a, b>_w: dofs duplicated across parts
        counted once via the 0/1 owner weights."""
        return self._psum(self._local_dot(w, a, b))

    def wdots(self, w: torch.Tensor, pairs, extra=()) -> torch.Tensor:
        """Several dots in one reduction, optionally carrying extra
        pre-reduced local scalars in the same vector."""
        loc = torch.stack([self._local_dot(w, a, b) for a, b in pairs]
                          + [torch.as_tensor(e, dtype=self.dot_dtype,
                                             device=w.device)
                             for e in extra])
        return self._psum(loc)

    # -- per-column reductions of a right-hand-side block ----------------
    def _local_dots_many(self, w, pairs) -> torch.Tensor:
        """(len(pairs), R) local weighted dots of blocks (R, P, n_loc),
        cast to the dot dtype before multiplying as :meth:`_local_dot`
        does, summed over the rows of one buffer of products.  On the
        card its row stride is padded with zeros to a multiple of
        ``_ROW_ALIGN`` elements: a CUDA sum starts its vectorised loads
        where a row's alignment lets it, so rows at other offsets would be
        summed in other orders; padded, every column is summed in the same
        order (a column 2F gives exactly twice F's dots).  And on the card
        each column's rows take a sum of their own: a CUDA sum shares a
        row among thread blocks by the number of rows it is given, so one
        sum over every column would sum a column in another order at
        another width; per column, each column of a block gets the bits
        of its width-1 block.  The CPU's sum does not depend on alignment,
        and its rows are neither padded nor summed apart."""
        dd = self.dot_dtype
        a0 = pairs[0][0]
        R, n = a0.shape[0], a0[0].numel()
        npad = -(-n // _ROW_ALIGN) * _ROW_ALIGN if a0.is_cuda else n
        buf = torch.empty((len(pairs), R, npad), dtype=dd, device=a0.device)
        if npad > n:
            buf[..., n:] = 0
        wd = w.to(dd)
        for i, (a, b) in enumerate(pairs):
            torch.mul(a.to(dd) * b.to(dd), wd,
                      out=buf[i, :, :n].view(a.shape))
        if not a0.is_cuda:
            return buf.sum(dim=-1)
        return torch.stack([buf[:, j].sum(dim=-1) for j in range(R)], dim=1)

    def wdot_many(self, w: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
        """Per-column global weighted dots <a_j, b_j>_w: (R,)."""
        return self._psum(self._local_dots_many(w, [(a, b)])[0])

    def wdots_many(self, w: torch.Tensor, pairs, extra=()) -> torch.Tensor:
        """Several per-column dots in ONE reduction, optionally carrying
        extra pre-reduced (R,) rows: (k + len(extra), R)."""
        loc = self._local_dots_many(w, pairs)
        if extra:
            loc = torch.cat([loc] + [
                torch.as_tensor(e, dtype=self.dot_dtype,
                                device=w.device)[None] for e in extra])
        return self._psum(loc)


# ---------------------------------------------------------------------------
# The general backend's stacked layout and device tree
# ---------------------------------------------------------------------------

# The cost of one more bucket, in element values (an element slot times
# its dofs) a matvec gathers, scales, multiplies and writes: a bucket's
# three launches cost about what the card moves for this many values
# (chip_smoke.py phase 4e times the groupings of ``BUCKET_VALUES`` on the
# 22^3 octree's operator; PERF.md).
BUCKET_VALUES = 2_000_000


def plan_buckets(sizes, bucket_values: float = BUCKET_VALUES
                 ) -> List[List[int]]:
    """Group pattern (sub-)types into buckets for the stacked product.

    ``sizes``: one (N_t, d_t) per type (per-part element slots, dofs an
    element).  A bucket of T types costs ``bucket_values`` plus the values
    it moves, T * Nmax * dmax (every member padded to the largest element
    count and arity).  Types sorted by N_t descending (ties: d_t
    descending, then position) are cut into contiguous buckets of least
    total cost, by dynamic programming over the cut points: types of
    similar size share a bucket where the padding costs less than a
    bucket's launches, and the largest type (the octree's brick) stays
    alone.  Returns buckets as lists of type positions, each in that
    order."""
    order = sorted(range(len(sizes)),
                   key=lambda t: (-sizes[t][0], -sizes[t][1], t))
    n = len(order)
    N = [sizes[t][0] for t in order]
    d = [sizes[t][1] for t in order]
    best = [0.0] + [float("inf")] * n
    cut = [0] * (n + 1)
    for i in range(n):                       # a bucket opening at i
        dmax = 0
        for j in range(i, n):                # ... and holding i..j
            dmax = max(dmax, d[j])
            c = best[i] + bucket_values + (j - i + 1) * N[i] * dmax
            if c < best[j + 1]:
                best[j + 1], cut[j + 1] = c, i
    buckets, j = [], n
    while j > 0:
        buckets.append(order[cut[j]:j])
        j = cut[j]
    return buckets[::-1]


@dataclasses.dataclass
class _SubType:
    """The elements of one pattern type that share one sign row (their
    product runs with S Ke S, exact), and per part the positions of those
    elements in the type block, in block order."""
    t: int                           # type-block position
    sign: np.ndarray                 # (d,) bool
    sel: List[np.ndarray]            # per part: element positions
    N: int                           # most elements in one part


@dataclasses.dataclass
class _Layout:
    width: int                       # 3: node rows, 1: dof rows
    subs: List[_SubType]
    groups: List[List[int]]          # sub-type positions per bucket
    shapes: List[Tuple[int, int, int, int, int]]   # (T, M, nr, d, base)
    n_vrows: int
    K: int


def _sub_types(pm: PartitionedModel) -> List[_SubType]:
    """Each type block split by the sign rows of its elements: a mirrored
    pattern instance flips whole components (the octree's reflections),
    so a type has at most 8 distinct rows there, and the product runs
    with S Ke S and no sign passes.  Padded element slots are in none."""
    subs = []
    for t, tb in enumerate(pm.type_blocks):
        rows, owner = [], []
        for p in range(pm.n_parts):
            ne = int(tb.n_elem[p])
            rows.append(tb.sign[p, :, :ne].T)
            owner.append(np.full(ne, p))
        rows = np.concatenate(rows)
        owner = np.concatenate(owner)
        if not len(rows):
            continue
        if rows.any():
            # one byte string a row: a 1-D unique, not a row-wise sort
            keys = np.ascontiguousarray(np.packbits(rows, axis=1))
            keys = keys.view(np.dtype((np.void, keys.shape[1]))).ravel()
            _k, first, inv = np.unique(keys, return_index=True,
                                       return_inverse=True)
            pats = rows[first]
        else:
            pats = rows[:1]
            inv = np.zeros(len(rows), dtype=np.int64)
        inv = inv.reshape(-1)
        pos = np.concatenate([np.arange(int(n)) for n in tb.n_elem])
        for q, pat in enumerate(pats):
            m = inv == q
            sel = [pos[m & (owner == p)] for p in range(pm.n_parts)]
            subs.append(_SubType(t, pat, sel, max(len(e) for e in sel)))
    return subs


def _layout(pm: PartitionedModel,
            bucket_values: Optional[float] = None) -> _Layout:
    """The stacked layout of ``pm``'s type blocks: bucket i holds T
    sub-types (:func:`_sub_types`) as (T, M = P * Nmax, d) element values,
    value row (t, p, n, a) at base + ((t * P + p) * Nmax + n) * nr + a."""
    tbs = pm.type_blocks
    width = 3 if pm.ell is not None else 1
    subs = _sub_types(pm)
    nrs = [tbs[st.t].n_nodes if width == 3 else tbs[st.t].d for st in subs]
    groups = plan_buckets([(st.N, tbs[st.t].d) for st in subs],
                          BUCKET_VALUES if bucket_values is None
                          else bucket_values)
    shapes, base = [], 0
    for g in groups:
        T = len(g)
        M = pm.n_parts * max(subs[i].N for i in g)
        nr = max(nrs[i] for i in g)
        shapes.append((T, M, nr, nr * width, base))
        base += T * M * nr
    if width == 3:
        K = pm.ell.shape[2]
    else:
        ids = pm.scat_ids
        K = max((int(np.bincount(ids[p][ids[p] < pm.n_loc]).max())
                 if (ids[p] < pm.n_loc).any() else 0)
                for p in range(pm.n_parts))
    return _Layout(width, subs, groups, shapes, base, max(K, 1))


def _slot_rows(pm: PartitionedModel, lay: _Layout):
    """What maps a JAX flat slot of part p (block base + row * N_t + elem,
    the node-ELL's or the flat scatter's) to a stacked value row: per
    type block (JAX slot base, N_t, element base), and per element slot of
    every block and part (type-major, then part, then position) its
    stacked row of row 0.  Returns (jax bases, N_t, element bases, row0,
    JAX slot count)."""
    P = pm.n_parts
    tbs = pm.type_blocks
    jb, Ns, eb = [], [], []
    j = e = 0
    for tb in tbs:
        N = tb.dof.shape[2]
        jb.append(j)
        Ns.append(N)
        eb.append(e)
        j += (tb.n_nodes if lay.width == 3 else tb.d) * N
        e += P * N
    row0 = np.full(e, -1, dtype=np.int64)
    for (_T, M, nr, _d, base), g in zip(lay.shapes, lay.groups):
        nmax = M // P
        for tpos, i in enumerate(g):
            st = lay.subs[i]
            for p in range(P):
                n_new = np.arange(len(st.sel[p]))
                row0[eb[st.t] + p * Ns[st.t] + st.sel[p]] = (
                    base + ((tpos * P + p) * nmax + n_new) * nr)
    return (np.asarray(jb, np.int64), np.asarray(Ns, np.int64),
            np.asarray(eb, np.int64), row0, j)


def _remap_slots(slots: np.ndarray, p: int, rowmap, pad: int) -> np.ndarray:
    """JAX flat slots of part ``p`` (its padding = the JAX slot count) ->
    stacked value rows (``pad`` = the zero row)."""
    jb, Ns, eb, row0, n_jax = rowmap
    slots = np.asarray(slots, dtype=np.int64)
    out = np.full(slots.shape, pad, dtype=np.int64)
    real = slots < n_jax
    s = slots[real]
    t = np.searchsorted(jb, s, side="right") - 1
    off = s - jb[t]
    a, n = off // Ns[t], off % Ns[t]
    r0 = row0[eb[t] + p * Ns[t] + n]
    if (r0 < 0).any():
        raise AssertionError("an ELL slot points at a padded element")
    out[real] = r0 + a
    return out


def _ell_map(pm: PartitionedModel, lay: _Layout) -> np.ndarray:
    """The ELL (P * rows, K) over stacked value rows: node rows from
    ``pm.ell``, or dof rows from the sorted flat map (``scat_perm`` /
    ``scat_ids``: each dof's slots in sorted order, as segment_sum adds
    them)."""
    rowmap = _slot_rows(pm, lay)
    P, pad = pm.n_parts, lay.n_vrows
    if lay.width == 3:
        return np.concatenate([
            _remap_slots(pm.ell[p], p, rowmap, pad)
            for p in range(P)]).astype(np.int32)
    ell = np.full((P, pm.n_loc, lay.K), pad, dtype=np.int64)
    for p in range(P):
        ids = pm.scat_ids[p].astype(np.int64)
        keep = ids < pm.n_loc
        ids, slots = ids[keep], pm.scat_perm[p][keep]
        counts = np.bincount(ids, minlength=pm.n_loc)
        off = np.concatenate([[0], np.cumsum(counts)])
        rank = np.arange(len(ids)) - off[ids]
        ell[p, ids, rank] = _remap_slots(slots, p, rowmap, pad)
    return ell.reshape(P * pm.n_loc, lay.K).astype(np.int32)


def _contributor_map(src: np.ndarray, slot: np.ndarray, n_glob: int):
    """(n_glob, Kc) entry indices summing into each global slot, in entry
    order, padded with len(src) (the appended zero)."""
    order = np.argsort(slot, kind="stable")
    counts = np.bincount(slot, minlength=n_glob)
    Kc = max(int(counts.max()) if len(counts) else 0, 1)
    ell = np.full((n_glob, Kc), len(src), dtype=np.int64)
    off = np.concatenate([[0], np.cumsum(counts)])
    s = slot[order]
    ell[s, np.arange(len(order)) - off[s]] = order
    return ell


def _assembly_map(local: np.ndarray, slot: np.ndarray, n_rows: int,
                  n_glob: int, put) -> dict:
    """Fixed-order assembly maps of the shared ids: ``local`` / ``slot``
    (P, NI) padded with n_rows / n_glob, as the partition stores them."""
    P = local.shape[0]
    keep = local < n_rows
    p_of = np.broadcast_to(np.arange(P)[:, None], local.shape)[keep]
    src = p_of.astype(np.int64) * n_rows + local[keep]
    sl = slot[keep].astype(np.int64)
    return {"src": put(src, torch.int32),
            "dst": put(src, torch.int64),
            "slot": put(sl, torch.int32),
            "ell": put(_contributor_map(src, sl, n_glob), torch.int32)}


def _spring_map(pm: PartitionedModel, put, dtype) -> dict:
    """Flat spring endpoints, stiffnesses, and each spring dof's
    fixed-order contributor map: its a-side springs in spring order,
    then its b-side ones (the JAX package's ``.at[a].add(f).at[b].add(-f)``
    order); padded springs (k = 0) point at their part's dof 0 and are
    in no map."""
    P, NS = pm.spr_a.shape
    n_loc = pm.n_loc
    real = pm.spr_a < n_loc
    base = (np.arange(P, dtype=np.int64) * n_loc)[:, None]
    a = np.where(real, pm.spr_a, 0) + base
    b = np.where(real, pm.spr_b, 0) + base
    idx = np.arange(P * NS, dtype=np.int64).reshape(P, NS)
    dof = np.concatenate([a[real], b[real]])
    ent = np.concatenate([idx[real], P * NS + idx[real]])
    side = np.concatenate([np.zeros(real.sum(), np.int64),
                           np.ones(real.sum(), np.int64)])
    order = np.lexsort((ent, side, dof))
    dof, ent = dof[order], ent[order]
    uniq, first, counts = np.unique(dof, return_index=True,
                                    return_counts=True)
    ell = np.full((len(uniq), max(int(counts.max()), 1)), 2 * P * NS,
                  dtype=np.int64)
    grp = np.repeat(np.arange(len(uniq)), counts)
    ell[grp, np.arange(len(dof)) - first[grp]] = ent
    out = {"a": put(a.reshape(-1), torch.int32),
           "b": put(b.reshape(-1), torch.int32),
           "k": put(pm.spr_k.reshape(-1), dtype),
           "dof": put(uniq, torch.int64),
           "ell": put(ell, torch.int32)}
    if pm.node_layout:
        out["bpos"] = put((uniq // 3) * 9 + (uniq % 3) * 4, torch.int64)
    return out


def _putter(device):
    def put(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)
    return put


def device_data(pm: PartitionedModel, dtype: torch.dtype, device,
                bucket_values: Optional[float] = None,
                blocks: bool = True) -> dict:
    """Pack a ``PartitionedModel`` into the device tree the general
    operator reads: per bucket of :func:`plan_buckets` (over the sign
    sub-types of :func:`_sub_types`) the element-row gather ``gidx``, the
    transposed padded unit stiffnesses with the signs folded in ``KeT``
    (T, d, d), ``ck`` (T, M, 1), ``dKe`` (T, 1, d), the node-block
    diagonals ``D9`` (T, 1, nr, 9) on the node path, and for the strain
    export ``ce`` (T, M, 1) and ``SeT`` (T, d, 6; 3 for the scalar
    class's gradient), the transposed
    sign-folded strain modes (only when every type has its ``Se``); the
    ELL map over the
    stacked value rows; the interface, node-interface and spring maps;
    and the per-part weight, eff, F and Ud vectors.  Float leaves at
    ``dtype`` on ``device``, index leaves int32 (int64 where
    ``index_copy_`` needs it).  ``blocks=False`` leaves out the buckets
    and the ELL (the tree of :func:`build_bucketed_blocks`'s
    operator)."""
    put = _putter(device)
    data = {
        "weight": put(pm.weight, dtype),
        "node_weight": put(pm.node_weight, dtype),
        "eff": put(pm.eff, dtype),
        "F": put(pm.F, dtype),
        "Ud": put(pm.Ud, dtype),
    }
    if pm.n_iface:
        data["iface"] = _assembly_map(pm.iface_local, pm.iface_slot,
                                      pm.n_loc, pm.n_iface, put)
    if pm.n_node_iface:
        data["niface"] = _assembly_map(pm.niface_local, pm.niface_slot,
                                       pm.n_node_loc, pm.n_node_iface, put)
    if pm.spr_a is not None:
        data["springs"] = _spring_map(pm, put, dtype)
    if not blocks:
        return data
    lay = _layout(pm, bucket_values)
    P, w = pm.n_parts, lay.width
    n_rows = pm.n_node_loc if w == 3 else pm.n_loc

    buckets = []
    for g, (T, M, nr, d, _base) in zip(lay.groups, lay.shapes):
        nmax = M // P
        gidx = np.zeros((T, P, nmax, nr), dtype=np.int64)
        ck = np.zeros((T, P, nmax))
        KeT = np.zeros((T, d, d))
        dKe = np.zeros((T, 1, d))
        D9 = np.zeros((T, 1, nr, 9))
        ce = np.zeros((T, P, nmax))
        has_se = all(pm.type_blocks[lay.subs[si].t].Se is not None
                     for si in g)
        # strain components: 6 (Voigt), 3 for the scalar class's gradient
        n_se = max((pm.type_blocks[lay.subs[si].t].Se.shape[0] for si in g),
                   default=0) if has_se else 0
        SeT = np.zeros((T, d, n_se))
        for i, si in enumerate(g):
            st = lay.subs[si]
            tb = pm.type_blocks[st.t]
            dt_ = tb.d
            if w == 3:
                ids, pad, rows = tb.node, pm.n_node_loc, tb.n_nodes
            else:
                ids, pad, rows = tb.dof, pm.n_loc, tb.d
            # element slots past a part's count read its row 0 (ck = 0)
            gidx[i] = (np.arange(P) * n_rows)[:, None, None]
            for p in range(P):
                sel = st.sel[p]
                el = ids[p][:, sel].T.astype(np.int64)      # (n, rows)
                # arity padding reads the element's first row (its Ke
                # rows and columns are zero)
                full = np.repeat(el[:, :1], nr, axis=1)
                full[:, :rows] = el
                gidx[i, p, :len(sel)] += full
                ck[i, p, :len(sel)] = tb.ck[p, sel]
                ce[i, p, :len(sel)] = tb.ce[p, sel]
            sv = np.where(st.sign, -1.0, 1.0)
            if has_se:
                SeT[i, :dt_] = (tb.Se * sv[None, :]).T         # (Se S)^T
            Ke = sv[:, None] * tb.Ke * sv[None, :]             # S Ke S
            KeT[i, :dt_, :dt_] = Ke.T
            dKe[i, 0, :dt_] = np.diag(Ke)
            if w == 3:
                nn = tb.n_nodes
                Ke4 = Ke.reshape(nn, 3, nn, 3)
                D9[i, 0, :nn] = np.stack(
                    [Ke4[a, :, a, :].reshape(9) for a in range(nn)])
        b = {"gidx": put(gidx.reshape(-1), torch.int32),
             "KeT": put(KeT, dtype),
             "ck": put(ck.reshape(T, M, 1), dtype),
             "dKe": put(dKe, dtype)}
        if w == 3:
            b["D9"] = put(D9, dtype)
        if has_se:
            b["ce"] = put(ce.reshape(T, M, 1), dtype)
            b["SeT"] = put(SeT, dtype)
        buckets.append(b)
    data["buckets"] = buckets
    data["ell"] = put(_ell_map(pm, lay), torch.int32)
    return data


# ---------------------------------------------------------------------------
# The bucketed float64 refresh operator (the hybrid backend's default)
# ---------------------------------------------------------------------------
#
# Port of ``pcg_mpi_solver_tpu/ops/matvec.py:796-881``.  The JAX package
# stacks the type blocks into a few buckets by element-count size class
# only (power-of-16 boundaries), with the element arity zero-padded to
# each bucket's largest, for the few float64 matvecs a mixed hybrid solve
# runs outside its loop.  Its node sum is an unordered ``at[].add``; here
# each node row sums its contributions over the partition's node ELL
# (``pm.ell``, remapped into the bucketed value rows), a fixed order with
# no float atomics, so two refresh matvecs on the card give the same
# bits.

def _size_class(n: int) -> int:
    """The JAX package's bucket key: N <= 16, 256, 4096, 65536, ..."""
    c = 0
    while 16 ** (c + 1) < n:
        c += 1
    return c


def build_bucketed_blocks(pm: PartitionedModel, dtype: torch.dtype,
                          device) -> dict:
    """The bucketed refresh's device tree: :func:`device_data` without the
    general buckets (``blocks=False``) plus ``bucketed``, one dict a
    bucket (size classes ascending, types in partition order): the node
    row gather ``gidx`` (T * P * Nmax * nn; padded slots read the appended
    zero row P * n_node_loc), ``sck`` (T, P * Nmax, d) = ck * (-1)^sign,
    ``sgn`` (T, P * Nmax, d) = (-1)^sign on the product, ``KeT`` (T, d,
    d) and the shape (T, M, nn, base); and ``bell``, the node ELL over the
    bucketed value rows (row (t, p, n, a) at base + ((t * P + p) * Nmax +
    n) * nn + a, pad the trailing zero row)."""
    if pm.ell is None:
        raise ValueError("bucketed matvec requires the 3-dof node layout "
                         "(PartitionedModel.ell)")
    put = _putter(device)
    P, nnl = pm.n_parts, pm.n_node_loc
    groups: dict = {}
    for pos, tb in enumerate(pm.type_blocks):
        if tb.d != 3 * tb.n_nodes:
            raise ValueError(f"type {tb.type_id}: d={tb.d} is not "
                             f"3*n_nodes={tb.n_nodes} — not node layout")
        groups.setdefault(_size_class(tb.node.shape[2]), []).append(pos)
    # per type: its bucket's base row, position, Nmax and nn
    where = {}
    buckets, shapes, base = [], [], 0
    for _cls, members in sorted(groups.items()):
        tbs = [pm.type_blocks[i] for i in members]
        T = len(tbs)
        nmax = max(tb.node.shape[2] for tb in tbs)
        nn = max(tb.n_nodes for tb in tbs)
        d = 3 * nn
        KeT = np.zeros((T, d, d))
        gidx = np.full((T, P, nmax, nn), P * nnl, dtype=np.int64)
        sgn = np.ones((T, P, nmax, d))
        ck = np.zeros((T, P, nmax))
        for t, (i, tb) in enumerate(zip(members, tbs)):
            n = tb.node.shape[2]
            KeT[t, :tb.d, :tb.d] = tb.Ke.T
            node = tb.node.astype(np.int64)                 # (P, nn_t, n)
            rows = np.where(node < nnl,
                            node + (np.arange(P) * nnl)[:, None, None],
                            P * nnl)
            gidx[t, :, :n, :tb.n_nodes] = rows.transpose(0, 2, 1)
            sgn[t, :, :n, :tb.d] = np.where(tb.sign, -1.0, 1.0) \
                .transpose(0, 2, 1)
            ck[t, :, :n] = tb.ck
            where[i] = (base, t, nmax, nn)
        M = P * nmax
        sgn = sgn.reshape(T, M, d)
        buckets.append({"gidx": put(gidx.reshape(-1), torch.int32),
                        "sck": put(ck.reshape(T, M, 1) * sgn, dtype),
                        "sgn": put(sgn, dtype),
                        "KeT": put(KeT, dtype)})
        shapes.append((T, M, nn, base))
        base += T * M * nn
    # the node ELL's JAX slots (type base + node slot * N_t + element) ->
    # bucketed value rows
    jb, j = [], 0
    for tb in pm.type_blocks:
        jb.append(j)
        j += tb.n_nodes * tb.node.shape[2]
    jb = np.asarray(jb, dtype=np.int64)
    Ns = np.array([tb.node.shape[2] for tb in pm.type_blocks], np.int64)
    info = np.array([where[i] for i in range(len(pm.type_blocks))],
                    dtype=np.int64).reshape(-1, 4)
    ell = np.full(pm.ell.shape, base, dtype=np.int64)
    for p in range(P):
        s = pm.ell[p].astype(np.int64)
        real = s < j
        sr = s[real]
        t = np.searchsorted(jb, sr, side="right") - 1
        off = sr - jb[t]
        a, e = off // Ns[t], off % Ns[t]
        b0, tpos, nmax, nn = info[t].T
        ell[p][real] = b0 + ((tpos * P + p) * nmax + e) * nn + a
    data = device_data(pm, dtype, device, blocks=False)
    data["bucketed"] = buckets
    data["bucketed_shapes"] = shapes
    data["bell"] = put(ell.reshape(P * nnl, -1), torch.int32)
    return data


def bucketed_matvec(ops: Ops, data: dict, x: torch.Tensor) -> torch.Tensor:
    """Assembled K.x through :func:`build_bucketed_blocks`'s tree (the
    contract of ``Ops.matvec``; ``ops`` supplies the springs and the
    interface assembly).  Per bucket one node-row gather, the sign-folded
    ck scale, one batched product and the output signs; then each node row
    sums its value rows over ``bell`` in a fixed order."""
    R = x.shape[0] if x.dim() == 3 else 1
    xr = torch.cat([x.reshape(R, -1, 3), x.new_zeros((R, 1, 3))], dim=1)
    shapes = data["bucketed_shapes"]
    n_vrows = sum(T * M * nn for T, M, nn, _b in shapes)
    vbuf = torch.empty((R, n_vrows + 1, 3), dtype=x.dtype, device=x.device)
    vbuf[:, -1].zero_()
    for bkt, (T, M, nn, base) in zip(data["bucketed"], shapes):
        u = xr.index_select(1, bkt["gidx"]).view(R, T, M, 3 * nn)
        v = torch.matmul(u * bkt["sck"], bkt["KeT"])
        torch.mul(v, bkt["sgn"], out=vbuf[:, base:base + T * M * nn]
                  .view(R, T, M, 3 * nn))
    g = vbuf.index_select(1, data["bell"].reshape(-1))
    y = g.view(R, ops.n_parts * ops.n_node_loc, -1, 3).sum(dim=2) \
        .reshape(x.shape)
    return ops.iface_assemble(data, ops._apply_springs(data, x, y))

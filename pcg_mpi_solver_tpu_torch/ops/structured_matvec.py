"""The structured-slab block-stencil matvec: the CUDA kernels, their plain
version, the wrapper that picks between them by the device of its input,
and the variant selector.

    y[p] = sum_b shift_b( sum_a Ke[3b:3b+3, 3a:3a+3] . (ck[p] * x[p]_a) )

on node grids x, y (P, 3, nx+1, ny+1, nz+1), cell scales ck (P, nx, ny, nz)
and the (24, 24) unit element stiffness Ke — ``StructuredOps.matvec_local``
of the JAX package, one slab per part.

- :func:`structured_matvec` is the wrapper every structured matvec of the
  port calls.  On a CUDA tensor it launches a hand-written kernel, one
  launch over the leading part axis (the JAX package's per-part dispatch
  ``batched_structured_matvec``), and raises if the launch is refused.
  float32 goes to the kernel of the named variant, each replacing the
  TPU kernel of the same name in ``pcg_mpi_solver_tpu/ops/pallas_matvec.py``
  (:data:`VARIANTS`): v1 ``structured_matvec_pallas`` :214, v2
  ``structured_matvec_pallas_v2`` :324, v3 ``_v3`` :456, v4 ``_v4`` :774,
  v5 ``_v5`` :730, v6 ``_v6`` :940, v7 ``_v7`` :1094, v8 ``_v8`` :1227 and
  v9 ``_v9`` :1410 — every ``pallas_call`` of the JAX package has its
  CUDA kernel here.  float64 goes to the double instantiation of v6's
  kernel whatever the variant (the TPU kernels are float32 only, and the
  JAX package leaves float64 matvecs to XLA).  On a CPU tensor it runs the
  plain version.
- :func:`structured_matvec_plain` is the plain PyTorch version beside
  every kernel: all the variants compute this one function.  It is the gse
  form of ``pcg_mpi_solver_tpu/parallel/structured.py`` (:327-352,
  :428-453) in torch ops: eight slice-gathers, one (24, 24) einsum, a sum
  of eight zero-padded translates.  The CPU tests hold it against the JAX
  package and its Pallas kernels, and ``chip_smoke.py`` holds each kernel
  against it on the card.
- :func:`v6_geometry` is the launch grid of the kernels on v6's tiles
  (v6 in both dtypes, and v4, v2 and v8, each v6's float kernel in a
  library of its own): their (y, z) tiles and the x segments that fill
  the card; the CPU tests check it, the wrapper passes it to the kernel.
  The kernels' shared-memory layout is their own
  (``csrc/structured_tiles.cuh``, ``Layout``).
  :func:`v5_geometry` is the same for the node-owned gather of v5, v3
  and v7 (``csrc/structured_gather.cuh``), whose tile height and staging
  group depend on the chunk (``planes``) its shared-memory ring holds, and
  :func:`v9_geometry` for the v9 kernel's warp-strip tiles, and
  :func:`v1_geometry` for v1's x-march: the card's resident blocks, each
  marching the same number of node planes within one.
  :func:`launch_args` gives any variant's launch arguments, through one
  code path per kernel design.
- :func:`selected_variant` and :func:`pallas_planes` read the JAX
  package's knobs, ``PCG_TPU_PALLAS_V`` and ``PCG_TPU_PALLAS_PLANES``, with
  the same defaults and the same refusals, so a setting means the same in
  both packages.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
from typing import Optional

import torch
import torch.nn.functional as F

from pcg_mpi_solver_tpu_torch.models.element import HEX_CORNERS
from pcg_mpi_solver_tpu_torch.ops.kernels import load_kernel

# (dx, dy, dz) offset of each hex corner, VTK order; element dof 3*a + comp
CORNERS = tuple(tuple(int(v) for v in c) for c in HEX_CORNERS)

# Variant -> (kernel library under csrc/, whether its launch takes
# pallas_planes()).  The TPU kernel each replaces, in pallas_matvec.py:
# v1 structured_matvec_pallas :214, v2 structured_matvec_pallas_v2 :324,
# v3 structured_matvec_pallas_v3 :456, v4 structured_matvec_pallas_v4 :774,
# v5 structured_matvec_pallas_v5 :730, v6 structured_matvec_pallas_v6 :940,
# v7 structured_matvec_pallas_v7 :1094, v8 structured_matvec_pallas_v8
# :1227, v9 structured_matvec_pallas_v9 :1410.
VARIANTS = {"v1": ("structured_matvec_v1", False),
            "v2": ("structured_matvec_v2", False),
            "v3": ("structured_matvec_v3", True),
            "v4": ("structured_matvec_v4", False),
            "v5": ("structured_matvec_v5", True),
            "v6": ("structured_matvec", False),
            "v7": ("structured_matvec_v7", True),
            "v8": ("structured_matvec_v8", False),
            "v9": ("structured_matvec_v9", False)}
F64_VARIANT = "v6"          # the one kernel with a double instantiation

# Launches per (variant, dtype): incremented where a kernel is launched and
# nowhere else, so a run can show which kernel its matvecs went through.
LAUNCHES = {**{(v, "float32"): 0 for v in VARIANTS},
            (F64_VARIANT, "float64"): 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

# The Ke each (library, device index, dtype) holds in its constant bank:
# the tensor itself (held, so its storage cannot be reused by another
# tensor) and its in-place version counter at staging time.  Each library
# has its own bank, so the key names the library.
_STAGED: dict = {}


def selected_variant() -> str:
    """The kernel variant ``PCG_TPU_PALLAS_V`` selects (default ``"6"``),
    as the JAX package's ``selected_variant`` (pallas_matvec.py:159-195)
    names it.  ``Solver`` reads it once, at construction: build a new
    Solver to switch.  A value the JAX package refuses raises ValueError."""
    v = os.environ.get("PCG_TPU_PALLAS_V", "6")
    if v not in tuple("123456789"):
        raise ValueError(
            f"PCG_TPU_PALLAS_V must be 1|2|3|4|5|6|7|8|9, got {v!r}")
    return f"v{v}"


def pallas_planes() -> int:
    """Resolved ``PCG_TPU_PALLAS_PLANES`` (default 8), the cell planes per
    chunk of the chunked variants, as the JAX package's ``pallas_planes``
    (pallas_matvec.py:141-156) reads it: not a multiple of 8 raises
    ValueError."""
    planes = int(os.environ.get("PCG_TPU_PALLAS_PLANES", "8"))
    if planes % 8 != 0:
        raise ValueError(
            f"PCG_TPU_PALLAS_PLANES must be a multiple of 8, "
            f"got {planes}")
    return planes


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# The tile shape of the kernels on v6's tiles, as csrc/structured_tiles.cuh
# compiles it (smv::Layout<T>): a block computes V6_CELLS_Y[dtype] x
# V6_CELLS_Z cells a plane and owns the nodes inside them, (cells - 1) in
# each axis; an SM holds V6_BLOCKS_PER_SM[dtype] blocks (the kernel's
# __launch_bounds__ minimum, which its shared memory also allows).  A
# launch whose grid does not match the library's tile is refused.
V6_CELLS_Y = {torch.float32: 32, torch.float64: 8}
V6_CELLS_Z = 32
V6_BLOCKS_PER_SM = {torch.float32: 1, torch.float64: 2}
# the variants whose launch takes v6_geometry (v6's tile kernel) and
# v5_geometry (the node-owned gather)
TILED = ("v6", "v4", "v2", "v8")
GATHER = ("v5", "v3", "v7")
H100_SMS = 132


def _segments(nxn: int, tiles: int, slots: int, extra: int) -> tuple:
    """(seg_len, n_seg): the x segments of ``nxn`` node planes that
    minimise waves x (seg_len + extra), a wave being ``slots`` blocks (the
    card's SMs x the blocks an SM holds) of ``tiles`` x n_seg, ``extra``
    the planes a segment costs beyond its own; ties go to fewer
    segments."""
    best = None
    for n in range(1, nxn + 1):
        seg_len = -(-nxn // n)
        n_seg = -(-nxn // seg_len)
        cost = -(-tiles * n_seg // slots) * (seg_len + extra)
        if best is None or cost < best[0]:
            best = (cost, seg_len, n_seg)
    return best[1], best[2]


@dataclasses.dataclass(frozen=True)
class V6Geometry:
    """One launch of a kernel on v6's tiles: ``n_ty`` x ``n_tz`` (y, z)
    tiles of ``tile_nodes`` owned nodes, ``n_seg`` x segments of
    ``seg_len`` node planes (the last one ragged), ``blocks`` in all."""
    tile_nodes: tuple
    n_ty: int
    n_tz: int
    seg_len: int
    n_seg: int
    blocks: int


@functools.lru_cache(maxsize=256)
def v6_geometry(parts: int, nx: int, ny: int, nz: int, dtype: torch.dtype,
                sms: int = H100_SMS) -> V6Geometry:
    """Launch geometry of the kernels on v6's tiles (v6 in ``dtype``, v4,
    v2 and v8 in float32) for a (parts, nx, ny, nz) slab.

    The x segment length minimises waves x (seg_len + 3), a wave being the
    blocks the card holds at once (``sms`` x the blocks an SM holds): the
    planes of the longest chain of blocks on one SM, each segment's
    recomputed carry plane and two planes of ring fill included; ties go
    to fewer segments."""
    cy = V6_CELLS_Y[dtype]
    tile = (cy - 1, V6_CELLS_Z - 1)
    n_ty, n_tz = -(-(ny + 1) // tile[0]), -(-(nz + 1) // tile[1])
    tiles = parts * n_ty * n_tz
    seg_len, n_seg = _segments(nx + 1, tiles, sms * V6_BLOCKS_PER_SM[dtype],
                               3)
    return V6Geometry(tile, n_ty, n_tz, seg_len, n_seg, tiles * n_seg)


# The node-owned gather of v5, v3 and v7 (csrc/structured_gather.cuh): tiles
# of V5_ROWS[k] x V5_LANES_Z owned nodes, two rows a warp; the ring holds
# 2 * G + 2 slots of node and ck planes, G = planes where that fits a
# block's shared memory, else the largest G that does (v5_group: the chunk
# is then staged in groups of G planes).  8 rows at most: at 8 planes
# two 8-row blocks an SM ran 4.6 % faster than one 16-row block (PERF.md,
# Findings).  An SM has SM_SMEM bytes of shared memory, a block at most
# BLOCK_SMEM, and the runtime reserves SMEM_RESERVED a block.
V5_ROWS = (8, 4, 2)
V5_LANES_Z = 32
BLOCK_SMEM = 232448
SM_SMEM = 233472
SMEM_RESERVED = 1024


def _v5_slot(rows: int) -> int:
    """Values of one ring slot: 3 x (rows + 2) x 34 nodes, (rows + 1) x 33
    cells."""
    return 3 * (rows + 2) * (V5_LANES_Z + 2) + (rows + 1) * (V5_LANES_Z + 1)


def _v5_ring_bytes(slots: int, rows: int) -> int:
    """A ring of ``slots`` slots, Ke, and one copy-table entry (8 bytes) per
    slot value."""
    slot = _v5_slot(rows)
    return 4 * (slots * slot + 576) + 8 * slot


def v5_group(planes: int, rows: int) -> int:
    """G, the planes the gather stages at once (the kernel's
    ``group_planes``): ``planes`` where a ring of 2 * planes + 2 slots fits
    BLOCK_SMEM at ``rows``, else the largest G whose ring does (19 at 8
    rows, 35 at 4, 54 at 2)."""
    slot = _v5_slot(rows)
    fit = ((BLOCK_SMEM - 4 * 576 - 8 * slot) // (4 * slot) - 2) // 2
    return min(planes, fit)


def v5_smem_bytes(planes: int, rows: int) -> int:
    """Dynamic shared memory of a gather launch (v5, v3, v7; the kernel's
    ``smem_bytes``): the ring of 2 * G + 2 slots (:func:`v5_group`), Ke
    and the copy table."""
    return _v5_ring_bytes(2 * v5_group(planes, rows) + 2, rows)


@dataclasses.dataclass(frozen=True)
class V5Geometry:
    """One launch of the gather kernel: ``n_ty`` x ``n_tz`` (y, z) tiles of
    ``rows`` x 32 owned nodes (``threads`` = 16 x rows), ``n_seg`` x
    segments of ``seg_len`` node planes (the last one ragged), ``blocks``
    in all, ``smem_bytes`` of dynamic shared memory each, a ring of
    2 * ``group`` + 2 slots."""
    rows: int
    n_ty: int
    n_tz: int
    seg_len: int
    n_seg: int
    blocks: int
    threads: int
    smem_bytes: int
    group: int


@functools.lru_cache(maxsize=256)
def v5_geometry(parts: int, nx: int, ny: int, nz: int, planes: int,
                sms: int = H100_SMS,
                rows: Optional[int] = None) -> V5Geometry:
    """Launch geometry of the node-owned gather (v5, v3, v7) for a (parts,
    nx, ny, nz) slab at ``planes`` cell planes a chunk.

    The tile is ``rows`` high (one of V5_ROWS), by default the tallest
    whose ring of two whole chunks fits a block's shared memory; where
    none does (above 54 planes) the tallest, 8 rows, staging each chunk
    in groups of 19 (:func:`v5_group`): 0.236 ms at 150^3 and 56 planes
    against 0.479 at 4 rows and 1.141 at 2 (PERF.md, PR 19 run D).  The
    x segment length minimises waves x
    (seg_len + 2), a wave being the blocks the card holds at once
    (``sms`` x the blocks an SM's shared memory holds), each segment's two
    extra node planes included; ties go to fewer segments."""
    if rows is None:
        rows = next((r for r in V5_ROWS
                     if _v5_ring_bytes(2 * planes + 2, r) <= BLOCK_SMEM),
                    V5_ROWS[0])
    smem = v5_smem_bytes(planes, rows)
    n_ty, n_tz = -(-(ny + 1) // rows), -(-(nz + 1) // V5_LANES_Z)
    per_sm = max(1, SM_SMEM // (smem + SMEM_RESERVED))
    tiles = parts * n_ty * n_tz
    seg_len, n_seg = _segments(nx + 1, tiles, sms * per_sm, 2)
    return V5Geometry(rows, n_ty, n_tz, seg_len, n_seg, tiles * n_seg,
                      16 * rows, smem, v5_group(planes, rows))


# The v9 kernel (csrc/structured_matvec_v9.cu): V9_WARPS warps a block,
# each a strip of V9_ROWS cell rows x 32 cell columns that owns V9_ROWS - 1
# node rows x 31 node columns, so a block owns V9_WARPS (V9_ROWS - 1) x 31
# nodes; V9_STAGES ring slots of its node planes and halo as float4, and
# KeT; V9_BLOCKS_PER_SM blocks an SM (its __launch_bounds__ minimum, which
# its shared memory also allows).  V9_ROWS is the library's compile-time
# strip height (V9_ROWS in the source; tools/v9_kernel_compare.py builds
# others for its sweep and passes ``rows``).
V9_WARPS = 8
V9_ROWS = 6
V9_LANES_Z = 32
V9_STAGES = 3
V9_BLOCKS_PER_SM = 2


def v9_smem_bytes(rows: int = V9_ROWS) -> int:
    """Dynamic shared memory of a v9 block (the kernel's ``kSmemBytes``):
    V9_STAGES slots of (V9_WARPS (rows - 1) + 2) x 33 float4 nodes, and
    the 576 floats of KeT."""
    slot = (V9_WARPS * (rows - 1) + 2) * (V9_LANES_Z + 1)
    return 16 * V9_STAGES * slot + 4 * 576


@dataclasses.dataclass(frozen=True)
class V9Geometry:
    """One launch of the v9 kernel: ``n_ty`` x ``n_tz`` (y, z) tiles of
    ``tile_nodes`` owned nodes, ``n_seg`` x segments of ``seg_len`` node
    planes (the last one ragged), ``blocks`` of ``threads`` in all,
    ``smem_bytes`` of dynamic shared memory each."""
    rows: int
    tile_nodes: tuple
    n_ty: int
    n_tz: int
    seg_len: int
    n_seg: int
    blocks: int
    threads: int
    smem_bytes: int


@functools.lru_cache(maxsize=256)
def v9_geometry(parts: int, nx: int, ny: int, nz: int,
                sms: int = H100_SMS, rows: int = V9_ROWS) -> V9Geometry:
    """Launch geometry of the v9 kernel for a (parts, nx, ny, nz) slab with
    strips of ``rows`` cell rows (the library's V9_ROWS unless a sweep
    build says otherwise).

    The x segment length minimises waves x (seg_len + 2), a wave being the
    blocks the card holds at once (``sms`` x V9_BLOCKS_PER_SM): the planes
    of the longest chain of blocks on one SM, each segment's recomputed
    cell plane and its ring fill included; ties go to fewer segments."""
    tile = (V9_WARPS * (rows - 1), V9_LANES_Z - 1)
    n_ty, n_tz = -(-(ny + 1) // tile[0]), -(-(nz + 1) // tile[1])
    tiles = parts * n_ty * n_tz
    seg_len, n_seg = _segments(nx + 1, tiles, sms * V9_BLOCKS_PER_SM, 2)
    return V9Geometry(rows, tile, n_ty, n_tz, seg_len, n_seg,
                      tiles * n_seg, 32 * V9_WARPS, v9_smem_bytes(rows))


# The v1 kernel (csrc/structured_matvec_v1.cu): V1_THREADS threads a
# block, each owning V1_NODES z-adjacent node columns of one part and
# marching them in x; V1_BLOCKS_PER_SM blocks an SM (its __launch_bounds__
# minimum; no shared memory).  A column tile is V1_THREADS threads'
# columns, in (part, y, z) order.
V1_THREADS = 128
V1_NODES = 2
V1_BLOCKS_PER_SM = 3


@dataclasses.dataclass(frozen=True)
class V1Geometry:
    """One launch of the v1 kernel: ``cols`` thread columns (parts x (ny +
    1) x ceil((nz + 1) / V1_NODES)) in ``tiles`` tiles of V1_THREADS, each
    tile ``planes`` node planes deep; ``blocks`` blocks, block k marching
    the run of the (tile, plane) work from k x per + min(k, more), ``per``
    planes long and one more for the first ``more`` blocks."""
    cols: int
    tiles: int
    planes: int
    blocks: int
    per: int
    more: int


@functools.lru_cache(maxsize=256)
def v1_geometry(parts: int, nx: int, ny: int, nz: int,
                sms: int = H100_SMS) -> V1Geometry:
    """Launch geometry of the v1 kernel for a (parts, nx, ny, nz) slab: as
    many blocks as the card holds at once (``sms`` x V1_BLOCKS_PER_SM; no
    more than there are planes of work), the work split among them in
    runs that differ by at most one plane.  The kernel computes each
    block's run from the block count alone (its launch argument)."""
    cols = parts * (ny + 1) * -(-(nz + 1) // V1_NODES)
    tiles = -(-cols // V1_THREADS)
    work = tiles * (nx + 1)
    blocks = min(sms * V1_BLOCKS_PER_SM, work)
    return V1Geometry(cols, tiles, nx + 1, blocks, work // blocks,
                      work % blocks)


def v1_runs(g: V1Geometry, block: int) -> list:
    """The runs block ``block`` of a v1 launch marches, in order, as the
    kernel walks them: (tile, s, e), node planes s .. e - 1 of that column
    tile.  Only a first run can start past plane 0, and only such a run
    recomputes a carry (of cell plane s - 1)."""
    u = block * g.per + min(block, g.more)
    end = u + g.per + (block < g.more)
    runs = []
    while u < end:
        tile, s = divmod(u, g.planes)
        e = min(g.planes, s + end - u)
        runs.append((tile, s, e))
        u += e - s
    return runs


def launch_args(variant: str, parts: int, nx: int, ny: int, nz: int,
                dtype: torch.dtype, planes: Optional[int] = None,
                sms: int = H100_SMS) -> tuple:
    """The launch arguments after (P, nx, ny, nz) of ``variant``'s kernel
    entry point in ``dtype`` for a (parts, nx, ny, nz) slab on a card of
    ``sms`` SMs: the tiled variants (TILED) and v9 (seg_len, n_ty, n_tz,
    n_seg), the gather variants (GATHER, the chunked ones) (planes, rows,
    seg_len, n_ty, n_tz, n_seg), v1 (blocks,).  ``planes`` None reads
    :func:`pallas_planes` where the variant takes it."""
    if variant in TILED:
        g = v6_geometry(parts, nx, ny, nz, dtype, sms)
        return (g.seg_len, g.n_ty, g.n_tz, g.n_seg)
    if variant == "v9":
        g = v9_geometry(parts, nx, ny, nz, sms)
        return (g.seg_len, g.n_ty, g.n_tz, g.n_seg)
    if variant in GATHER:
        planes = pallas_planes() if planes is None else planes
        g = v5_geometry(parts, nx, ny, nz, planes, sms)
        return (planes, g.rows, g.seg_len, g.n_ty, g.n_tz, g.n_seg)
    if variant == "v1":
        return (v1_geometry(parts, nx, ny, nz, sms).blocks,)
    raise ValueError(f"variant must be one of {sorted(VARIANTS)}, got "
                     f"{variant!r}")


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index) \
        .multi_processor_count


def gather_cells(xg: torch.Tensor) -> torch.Tensor:
    """(P, 3, cx+1, cy+1, cz+1) -> (P, 24, cx, cy, cz) via 8 contiguous
    slices, in element-dof order 3*corner + comp."""
    cx, cy, cz = xg.shape[2] - 1, xg.shape[3] - 1, xg.shape[4] - 1
    return torch.cat([xg[:, :, dx:dx + cx, dy:dy + cy, dz:dz + cz]
                      for dx, dy, dz in CORNERS], dim=1)


def scatter_cells(v: torch.Tensor) -> torch.Tensor:
    """(P, 24, cx, cy, cz) -> (P, 3, cx+1, cy+1, cz+1): corner a's three
    channels land on the node grid as a zero-padded translate; the eight
    translates are summed in corner order."""
    y = None
    for a, (dx, dy, dz) in enumerate(CORNERS):
        t = F.pad(v[:, 3 * a:3 * a + 3],
                  (dz, 1 - dz, dy, 1 - dy, dx, 1 - dx))
        y = t if y is None else y + t
    return y


def structured_matvec_plain(xg: torch.Tensor, ck: torch.Tensor,
                            Ke: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of every variant's kernel (the JAX package's
    gse form)."""
    u = gather_cells(xg)
    v = torch.einsum("de,pexyz->pdxyz", Ke, ck[:, None] * u)
    return scatter_cells(v)


def _check(xg: torch.Tensor, ck: torch.Tensor, Ke: torch.Tensor) -> None:
    for name, t in (("xg", xg), ("ck", ck), ("Ke", Ke)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if xg.dim() != 5 or xg.shape[1] != 3 or min(xg.shape[2:]) < 2:
        raise ValueError(f"xg must be (P, 3, nx+1, ny+1, nz+1) with every "
                         f"cell count >= 1, got {tuple(xg.shape)}")
    P, _, nxn, nyn, nzn = xg.shape
    if tuple(ck.shape) != (P, nxn - 1, nyn - 1, nzn - 1):
        raise ValueError(f"ck must be {(P, nxn - 1, nyn - 1, nzn - 1)} for "
                         f"xg {tuple(xg.shape)}, got {tuple(ck.shape)}")
    if tuple(Ke.shape) != (24, 24):
        raise ValueError(f"Ke must be (24, 24), got {tuple(Ke.shape)}")
    if not (xg.dtype == ck.dtype == Ke.dtype) or xg.dtype not in _SUFFIX:
        raise TypeError(f"xg, ck and Ke must share one dtype, float32 or "
                        f"float64; got {xg.dtype}, {ck.dtype}, {Ke.dtype}")
    if not (xg.device == ck.device == Ke.device):
        raise ValueError(f"xg, ck and Ke must be on one device; got "
                         f"{xg.device}, {ck.device}, {Ke.device}")
    if not (xg.is_contiguous() and ck.is_contiguous()
            and Ke.is_contiguous()):
        raise ValueError("xg, ck and Ke must be contiguous")
    if xg.numel() >= 2**31:
        raise ValueError(f"xg has {xg.numel()} entries; the kernel indexes "
                         f"with 32-bit integers (< 2^31)")


def _library(variant: str) -> ctypes.CDLL:
    name = VARIANTS[variant][0]
    lib = load_kernel(name)
    err_fn = getattr(lib, f"{name}_error_string")
    if err_fn.restype is not ctypes.c_char_p:
        v6 = variant == F64_VARIANT
        # the launch arguments after (P, nx, ny, nz), as launch_args gives
        # them for any slab
        n_geom = len(launch_args(variant, 1, 1, 1, 1, torch.float32,
                                 planes=8))
        for sfx in ("f32", "f64") if v6 else ("f32",):
            stage = getattr(lib, f"{name}_stage_{sfx}")
            stage.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            stage.restype = ctypes.c_int
            fn = getattr(lib, f"{name}_{sfx}")
            # x, ck, y; P, nx, ny, nz, geometry, device; stream
            fn.argtypes = [ctypes.c_void_p] * 3 \
                + [ctypes.c_int] * (5 + n_geom) + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        if variant in TILED:
            smem = getattr(lib, f"{name}_smem_bytes")
            smem.argtypes = [ctypes.c_int]
            smem.restype = ctypes.c_longlong
        if variant in GATHER:
            smem = getattr(lib, f"{name}_smem_bytes")
            smem.argtypes = [ctypes.c_int, ctypes.c_int]
            smem.restype = ctypes.c_longlong
        if variant == "v9":
            smem = getattr(lib, f"{name}_smem_bytes")
            smem.argtypes = []
            smem.restype = ctypes.c_longlong
        if variant == "v1":
            for what in ("blocks_per_sm", "registers"):
                fn = getattr(lib, f"{name}_{what}")
                fn.argtypes = [ctypes.c_int]
                fn.restype = ctypes.c_int
        err_fn.argtypes = [ctypes.c_int]
        err_fn.restype = ctypes.c_char_p
    return lib


def _raise_on(lib: ctypes.CDLL, name: str, err: int, what: str,
              xg: torch.Tensor):
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} {what} failed on {xg.device} for xg "
                           f"{tuple(xg.shape)} {xg.dtype}: CUDA error "
                           f"{err} ({msg})")


def structured_matvec(xg: torch.Tensor, ck: torch.Tensor, Ke: torch.Tensor,
                      variant: str = "v6",
                      planes: Optional[int] = None) -> torch.Tensor:
    """y = K_slab . x per part.  CUDA tensors launch the kernel of
    ``variant`` in float32, v6's double kernel in float64 (or raise); CPU
    tensors run :func:`structured_matvec_plain`.  ``planes`` is the chunk
    of the chunked variants (v3, v5, v7); None reads
    :func:`pallas_planes`.  The other variants (v1, v2, v4, v6, v8, v9)
    ignore it."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {sorted(VARIANTS)}, got "
                         f"{variant!r}")
    _check(xg, ck, Ke)
    if xg.dtype == torch.float64:
        variant = F64_VARIANT
    if xg.device.type == "cpu":
        return structured_matvec_plain(xg, ck, Ke)
    if xg.device.type != "cuda":
        raise ValueError(f"structured_matvec runs on cuda or cpu tensors, "
                         f"got {xg.device}")
    name = VARIANTS[variant][0]
    lib = _library(variant)
    sfx = _SUFFIX[xg.dtype]
    dev = xg.device.index
    stream = torch.cuda.current_stream(xg.device).cuda_stream
    key = (name, dev, xg.dtype)
    held = _STAGED.get(key)
    if held is None or held[0] is not Ke or held[1] != Ke._version:
        err = getattr(lib, f"{name}_stage_{sfx}")(Ke.data_ptr(), dev, stream)
        _raise_on(lib, name, err, "Ke staging", xg)
        _STAGED[key] = (Ke, Ke._version)
    y = torch.empty_like(xg)
    P, _, nxn, nyn, nzn = xg.shape
    extra = launch_args(variant, P, nxn - 1, nyn - 1, nzn - 1, xg.dtype,
                        planes, _sm_count(dev))
    err = getattr(lib, f"{name}_{sfx}")(
        xg.data_ptr(), ck.data_ptr(), y.data_ptr(),
        P, nxn - 1, nyn - 1, nzn - 1, *extra, dev, stream)
    _raise_on(lib, name, err, "kernel launch", xg)
    LAUNCHES[(variant, str(xg.dtype).removeprefix("torch."))] += 1
    return y

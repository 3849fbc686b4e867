"""The port's structured matvec (plain version + wrapper) and StructuredOps
against the JAX package on the CPU, on bit-identical inputs.

Tolerances: float32 rtol/atol 2e-5, the tolerances of tests/test_pallas.py
(the einsum and the eight-translate sum round in another order than
XLA's); float64 1e-12 * max|y| (round-off of a 576-term sum per cell)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcg_mpi_solver_tpu.models.synthetic import make_cube_model as jax_cube
from pcg_mpi_solver_tpu.ops.matvec import Ops as JaxOps
from pcg_mpi_solver_tpu.ops import pallas_matvec as jax_pallas
from pcg_mpi_solver_tpu.ops.pallas_matvec import (
    structured_matvec_pallas_v4, structured_matvec_pallas_v6)
from pcg_mpi_solver_tpu.parallel.structured import (
    StructuredOps as JaxStructuredOps, device_data_structured as jax_data,
    partition_structured as jax_partition)
from pcg_mpi_solver_tpu_torch.ops import structured_matvec as smv
from pcg_mpi_solver_tpu_torch.ops.matvec import Ops
from pcg_mpi_solver_tpu_torch.parallel.structured import (
    StructuredOps, device_data_structured, partition_from_numpy)

F32 = dict(rtol=2e-5, atol=2e-5)


DIMS = [(6, 5, 4), (4, 4, 4), (7, 3, 5)]


def both(dims, n_parts=1, seed=11, dtype="float64"):
    """The same partition in both packages: JAX ops/data, port ops/data."""
    spj = jax_partition(jax_cube(*dims, heterogeneous=True, seed=seed),
                        n_parts)
    sp = partition_from_numpy({f.name: getattr(spj, f.name)
                               for f in dataclasses.fields(spj)})
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "float64": (jnp.float64, torch.float64)}[dtype]
    jops = JaxStructuredOps.from_partition(spj, dot_dtype=jdt)
    tops = StructuredOps.from_partition(sp, dot_dtype=tdt)
    return (jops, jax_data(spj, jdt)), (tops,
                                       device_data_structured(sp, tdt, "cpu"))


@pytest.mark.parametrize("dims", DIMS)
def test_plain_matches_jax_float32(dims):
    (jops, jd), (tops, td) = both(dims, dtype="float32")
    x = np.random.default_rng(3).normal(size=(1, tops.n_loc)) \
        .astype(np.float32)
    y_ref = np.asarray(jops.matvec_local(jd, jnp.asarray(x)))
    y = tops.matvec_local(td, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, y_ref, **F32)


@pytest.mark.parametrize("dims", DIMS)
def test_plain_matches_jax_float64(dims):
    (jops, jd), (tops, td) = both(dims)
    x = np.random.default_rng(5).normal(size=(1, tops.n_loc))
    y_ref = np.asarray(jops.matvec_local(jd, jnp.asarray(x)))
    y = tops.matvec_local(td, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, y_ref, rtol=0,
                               atol=1e-12 * np.abs(y_ref).max())


@pytest.mark.parametrize("dims,planes", [((6, 5, 4), 2), ((4, 4, 4), 4),
                                         ((7, 3, 5), 3), ((5, 4, 3), 8)])
def test_plain_matches_pallas_v6_interpret(dims, planes):
    """Against the TPU kernel itself, run through the Pallas interpreter
    exactly as tests/test_pallas.py runs it."""
    nx, ny, nz = dims
    (_jops, jd), (_tops, td) = both(dims, dtype="float32")
    blk = jd["blocks"][0]
    xg = np.random.default_rng(3).normal(
        size=(3, nx + 1, ny + 1, nz + 1)).astype(np.float32)
    y_ref = np.asarray(structured_matvec_pallas_v6(
        jnp.asarray(xg), blk["ck"][0], blk["Ke"], interpret=True,
        planes=planes))
    tb = td["blocks"][0]
    y = smv.structured_matvec_plain(torch.from_numpy(xg)[None], tb["ck"],
                                    tb["Ke"])[0].numpy()
    np.testing.assert_allclose(y, y_ref, **F32)


def tf32(v: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as cvt.rna.tf32.f32 does."""
    return ((v.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def cell_products(xg, ck, Ke, arithmetic):
    """The (P, 24, cx, cy, cz) float32 cell products ck * (Ke . u) of a
    float32 kernel on v6's tiles, emulated: ``"ffma"`` (the one the v6
    and v4 kernels ship: float32 products summed in float32) or one of the
    tensor-core products weighed against it, ``"dmma"`` (on the FP64
    tensor cores: u, Ke and ck widened to float64, each cell's sum scaled
    by its ck in float64 and rounded to float32 once),
    ``"3xtf32"`` (u and Ke split into hi = tf32(v) and lo =
    tf32(v - hi); lo.hi + hi.lo, then hi.hi; float32 sums) and
    ``"1xtf32"`` (hi.hi alone).  ck scales the product, as in the
    kernels."""
    u = smv.gather_cells(xg)

    def prod(k, v):
        return torch.einsum("de,pexyz->pdxyz", k, v)

    if arithmetic == "dmma":
        f = ck.double()[:, None] * prod(Ke.double(), u.double())
        return f.float()
    if arithmetic == "ffma":
        f = prod(Ke, u)
    else:
        uh, kh = tf32(u), tf32(Ke)
        f = prod(kh, uh)
        if arithmetic == "3xtf32":
            f = (prod(kh, tf32(u - uh)) + prod(tf32(Ke - kh), uh)) + f
    return ck[:, None] * f


def v6_float_arithmetic(xg, ck, Ke, arithmetic):
    """The float32 matvec of a kernel on v6's tiles, emulated: its
    cell_products placed onto the nodes by float32 sums."""
    return smv.scatter_cells(cell_products(xg, ck, Ke, arithmetic))


@pytest.mark.parametrize("reference", ["jax_f64", "pallas_v6", "pallas_v4"])
@pytest.mark.parametrize("arithmetic", ["ffma", "3xtf32", "dmma"])
@pytest.mark.parametrize("dims", DIMS)
def test_v6_float_arithmetic_within_kernel_tolerance(dims, arithmetic,
                                                     reference):
    """The float32 arithmetic the v6 and v4 kernels ship (FFMA) stays
    within the card's kernel tolerance, 2e-5 x max|y|, of the JAX
    package's matvec_local in float64 and of its TPU kernels v6 and v4
    (Pallas interpreter), on ragged shapes.  The 3xTF32 and DMMA cases are
    a record of why neither kernel is on the tensor cores although those
    products pass too: the tolerance does not decide it, the flagship
    solve's iterations did (PERF.md)."""
    nx, ny, nz = dims
    (_j, jd32), (_t, td) = both(dims, dtype="float32")
    tb = td["blocks"][0]
    xg = np.random.default_rng(3).normal(
        size=(3, nx + 1, ny + 1, nz + 1)).astype(np.float32)
    y = v6_float_arithmetic(torch.from_numpy(xg)[None], tb["ck"], tb["Ke"],
                            arithmetic)[0].numpy()
    if reference == "jax_f64":
        (jops, jd), _ = both(dims)
        y_ref = np.asarray(jops.matvec_local(
            jd, jnp.asarray(xg.reshape(1, -1), jnp.float64))).reshape(
                xg.shape)
    else:
        blk = jd32["blocks"][0]
        pallas = {"pallas_v6": structured_matvec_pallas_v6,
                  "pallas_v4": structured_matvec_pallas_v4}[reference]
        y_ref = np.asarray(pallas(jnp.asarray(xg), blk["ck"][0], blk["Ke"],
                                  interpret=True))
    assert np.abs(y - y_ref).max() <= 2e-5 * np.abs(y_ref).max()


@pytest.mark.parametrize("dims", DIMS)
def test_v6_1xtf32_misses_kernel_tolerance(dims):
    """A single TF32 product (10 mantissa bits) misses the 2e-5 x max|y|
    kernel tolerance against the float64 matvec: the record of why a
    tensor-core float product would have to be 3xTF32, whose cost and
    round-off kept the kernel on FFMAs (PERF.md)."""
    nx, ny, nz = dims
    (jops, jd), (_t, td) = both(dims)
    tb = td["blocks"][0]
    xg = np.random.default_rng(3).normal(
        size=(3, nx + 1, ny + 1, nz + 1)).astype(np.float32)
    y = v6_float_arithmetic(torch.from_numpy(xg)[None], tb["ck"].float(),
                            tb["Ke"].float(), "1xtf32")[0].numpy()
    y_ref = np.asarray(jops.matvec_local(
        jd, jnp.asarray(xg.reshape(1, -1), jnp.float64))).reshape(xg.shape)
    assert np.abs(y - y_ref).max() > 2e-5 * np.abs(y_ref).max()


# ragged shapes, shapes whose ny+1 and nz+1 are whole tiles (31 and 62
# nodes: float tiles are 31 x 31 nodes, double 7 x 31), and the flagship
GEOMETRY_SHAPES = [(1, 1, 1, 1), (1, 7, 3, 5), (2, 33, 17, 9),
                   (2, 40, 37, 70), (1, 20, 70, 40), (1, 30, 30, 61),
                   (3, 12, 61, 30), (1, 150, 150, 150)]


def check_tile_geometry(shape, dtype):
    """The launch geometry of the kernels on v6's tiles: the (y, z) tiles
    own every node exactly once, the x segments cover every node plane
    exactly once, and the blocks are parts x tiles x segments."""
    P, nx, ny, nz = shape
    g = smv.v6_geometry(P, nx, ny, nz, dtype)
    ty, tz = g.tile_nodes
    assert (ty + 1, tz + 1) == (smv.V6_CELLS_Y[dtype], smv.V6_CELLS_Z)
    for n_nodes, tile, n_tiles in ((ny + 1, ty, g.n_ty),
                                   (nz + 1, tz, g.n_tz),
                                   (nx + 1, g.seg_len, g.n_seg)):
        owned = np.zeros(n_nodes, int)
        for t in range(n_tiles):
            owned[t * tile:(t + 1) * tile] += 1
        assert (owned == 1).all()
        assert (n_tiles - 1) * tile < n_nodes    # no tile owns nothing
    assert g.blocks == P * g.n_ty * g.n_tz * g.n_seg


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", GEOMETRY_SHAPES)
def test_v6_geometry_covers_every_node_once(shape, dtype):
    """v6's launch geometry in both dtypes (check_tile_geometry)."""
    check_tile_geometry(shape, dtype)


@pytest.mark.parametrize("shape", GEOMETRY_SHAPES)
def test_v4_geometry_covers_every_node_once(shape):
    """v4 launches with v6's float32 geometry (check_tile_geometry)."""
    assert "v4" in smv.TILED
    check_tile_geometry(shape, torch.float32)


@pytest.mark.parametrize("shape", GEOMETRY_SHAPES)
def test_v8_geometry_covers_every_node_once(shape):
    """v8 runs v6 float's tiles, as v4 and v2 do (check_tile_geometry), and
    its launch arguments are that grid whatever ``planes`` says: v8 takes
    no chunk."""
    assert "v8" in smv.TILED and not smv.VARIANTS["v8"][1]
    check_tile_geometry(shape, torch.float32)
    g = smv.v6_geometry(*shape, torch.float32)
    for planes in (8, 16):
        assert smv.launch_args("v8", *shape, torch.float32, planes) \
            == (g.seg_len, g.n_ty, g.n_tz, g.n_seg)


def test_v6_geometry_flagship_fills_the_card():
    """At the flagship slab the x segments give nearly every SM of an H100
    SXM a block, where the (y, z) tiles alone do not."""
    for dtype in (torch.float32, torch.float64):
        g = smv.v6_geometry(1, 150, 150, 150, dtype)
        assert g.n_ty * g.n_tz < 0.9 * smv.H100_SMS < g.blocks


def test_v4_geometry_flagship_fills_the_card():
    """v4 at the flagship slab: the x segments give nearly every SM of an
    H100 SXM its blocks where the (y, z) tiles alone do not, and the last
    wave is at least 3/4 full."""
    assert "v4" in smv.TILED
    g = smv.v6_geometry(1, 150, 150, 150, torch.float32)
    per_sm = smv.V6_BLOCKS_PER_SM[torch.float32]
    assert g.n_ty * g.n_tz < 0.9 * smv.H100_SMS * per_sm < g.blocks
    waves = g.blocks / (smv.H100_SMS * per_sm)
    assert waves / -(-g.blocks // (smv.H100_SMS * per_sm)) >= 0.75


@pytest.mark.parametrize("planes", [8, 16])
@pytest.mark.parametrize("shape", GEOMETRY_SHAPES)
def test_v5_geometry_covers_every_node_once(shape, planes):
    """The v5 launch geometry: its (y, z) tiles of rows x 32 nodes own
    every node exactly once, its x segments cover every node plane exactly
    once, the blocks are parts x tiles x segments, and the tile is the
    tallest whose ring fits a block's shared memory."""
    P, nx, ny, nz = shape
    g = smv.v5_geometry(P, nx, ny, nz, planes)
    for n_nodes, tile, n_tiles in ((ny + 1, g.rows, g.n_ty),
                                   (nz + 1, smv.V5_LANES_Z, g.n_tz),
                                   (nx + 1, g.seg_len, g.n_seg)):
        owned = np.zeros(n_nodes, int)
        for t in range(n_tiles):
            owned[t * tile:(t + 1) * tile] += 1
        assert (owned == 1).all()
        assert (n_tiles - 1) * tile < n_nodes    # no tile owns nothing
    assert g.blocks == P * g.n_ty * g.n_tz * g.n_seg
    assert g.threads == 16 * g.rows
    assert g.smem_bytes == smv.v5_smem_bytes(planes, g.rows) \
        <= smv.BLOCK_SMEM
    taller = [r for r in smv.V5_ROWS if r > g.rows]
    assert all(smv.v5_smem_bytes(planes, r) > smv.BLOCK_SMEM
               for r in taller)


@pytest.mark.parametrize("planes", [8, 16])
def test_v5_geometry_flagship_fills_the_card(planes):
    """At the flagship slab the x segments give nearly every SM of an H100
    SXM a block where the tiles alone do not, and the ring fits 227 KB."""
    g = smv.v5_geometry(1, 150, 150, 150, planes)
    assert g.n_ty * g.n_tz < 0.9 * smv.H100_SMS <= g.blocks
    assert g.smem_bytes <= smv.BLOCK_SMEM == 232448
    # nearly full waves: the last wave of blocks is at least 3/4 full
    waves = g.blocks / smv.H100_SMS
    assert waves / -(-g.blocks // smv.H100_SMS) >= 0.75


def test_v5_geometry_past_the_shared_memory_takes_the_tallest_tile():
    """A chunk whose ring of two whole chunks does not fit even at two
    rows takes the tallest tile (8 rows) and is staged in groups of the
    largest G whose ring fits there (19), so the launch fits a block's
    shared memory (tests/test_torch_cuda.py launches it)."""
    g = smv.v5_geometry(1, 40, 4, 3, 56)
    assert g.rows == smv.V5_ROWS[0] == 8 and g.group == 19
    assert g.smem_bytes == smv.v5_smem_bytes(19, 8) <= smv.BLOCK_SMEM


@pytest.mark.parametrize("planes", [8, 16])
@pytest.mark.parametrize("shape", GEOMETRY_SHAPES)
def test_v3_launches_with_the_gather_arguments_of_v5(shape, planes):
    """v3 runs v5's node-owned gather: its launch arguments are v5's
    (planes, rows, seg_len, n_ty, n_tz, n_seg) at every shape, the
    flagship's included, and at any number of SMs."""
    assert {"v3", "v5"} <= set(smv.GATHER)
    for sms in (smv.H100_SMS, 114):
        args = smv.launch_args("v3", *shape, torch.float32, planes, sms)
        g = smv.v5_geometry(*shape, planes, sms)
        assert args == smv.launch_args("v5", *shape, torch.float32, planes,
                                       sms)
        assert args == (planes, g.rows, g.seg_len, g.n_ty, g.n_tz, g.n_seg)


@pytest.mark.parametrize("planes", [8, 16])
@pytest.mark.parametrize("shape", GEOMETRY_SHAPES)
def test_v7_launches_with_the_gather_arguments_of_v5(shape, planes):
    """v7 runs v5's node-owned gather, as v3 does: its launch arguments are
    v5's at every shape, the flagship's included, and at any number of
    SMs."""
    assert set(smv.GATHER) == {"v3", "v5", "v7"}
    for sms in (smv.H100_SMS, 114):
        assert smv.launch_args("v7", *shape, torch.float32, planes, sms) \
            == smv.launch_args("v5", *shape, torch.float32, planes, sms)


@pytest.mark.parametrize("planes", list(range(8, 129, 8)) + [54, 55])
def test_v7_chunk_fits_up_to_54_planes(planes):
    """v7's ring of two whole chunks (2C + 2 slots) fits a block's shared
    memory at 2-row tiles up to C = 54; above that the chunk is staged in
    groups on the 8-row tile (G = 19), so every multiple of 8 the JAX
    package's pallas_planes accepts (and any C) launches with its ring
    inside 227 KB, as PR 2's shuffle kernel, which used no shared memory,
    refused no C.  The launch passes the requested C itself, never a
    rounded one."""
    args = smv.launch_args("v7", 1, 40, 4, 3, torch.float32, planes)
    g = smv.v5_geometry(1, 40, 4, 3, planes)
    assert args[:2] == (planes, g.rows)
    assert g.smem_bytes <= smv.BLOCK_SMEM
    assert g.group == min(planes, smv.v5_group(planes, g.rows))
    assert (g.group == planes) == (planes <= 54)
    if planes > 54:
        assert g.rows == smv.V5_ROWS[0] and g.group == 19


@pytest.mark.parametrize("rows,largest", [(8, 19), (4, 35), (2, 54)])
def test_v5_group_is_the_largest_ring_that_fits(rows, largest):
    """G at each tile height is the largest group whose 2G + 2 slots, Ke
    and the copy table fit BLOCK_SMEM; one more plane would not."""
    assert smv.v5_group(1000, rows) == largest
    assert smv.v5_group(largest, rows) == largest
    assert smv.v5_smem_bytes(largest, rows) <= smv.BLOCK_SMEM
    assert smv._v5_ring_bytes(2 * largest + 4, rows) > smv.BLOCK_SMEM


def _gather_schedule(C, G, n_steps):
    """The gather kernel's staging schedule (structured_gather.cuh,
    matvec_kernel) replayed on the host: the slots each commit group
    writes, the waits, and the slots each step reads.  Asserts that every
    read finds its own plane, landed, and that no copy lands in a slot
    the running group still reads; returns the groups run."""
    ring, n_node, per_chunk = 2 * G + 2, n_steps + 2, -(-C // G)

    def group_end(q):
        g = q % per_chunk
        return min(q // per_chunk * C + min(g * G + G, C), n_steps)

    slot, landed, issued = {}, set(), []

    def issue(j0, j1, reading):
        gid = len(issued)
        issued.append(gid)
        for j in range(j0, min(j1, n_node)):
            assert j % ring not in reading
            slot[j % ring] = (j, gid)

    def read(j):
        assert slot[j % ring][0] == j and slot[j % ring][1] in landed

    issue(0, group_end(0) + 2, set())
    q = k = 0
    ends = []
    while k < n_steps:
        k_end = group_end(q)
        reading = {j % ring for j in range(k, k_end + 2)}
        assert len(reading) == k_end + 2 - k <= ring
        issue(k_end + 2, group_end(q + 1) + 2, reading)
        landed.update(issued[:-1])          # wait_copies<1>
        if q == 0:
            read(0), read(1)
        for kk in range(k, k_end):
            read(kk + 2), read(kk + 1)
        ends.append(k_end)
        k, q = k_end, q + 1
    return ends


@pytest.mark.parametrize("planes", [8, 16, 56, 64, 128])
def test_gather_groups_stage_every_plane_before_it_is_read(planes):
    """The grouped staging at the G each tile gives (and a few smaller G)
    reads each node and ck plane only after it landed and never overwrites
    a slot in use, over segments shorter and longer than a chunk; at
    G = C the groups are the chunks (today's schedule), and above G every
    chunk boundary (a multiple of C) is still a group boundary."""
    for rows in smv.V5_ROWS:
        for G in {smv.v5_group(planes, rows), 1, 3, 8}:
            G = min(G, planes)
            for n_steps in (1, 2, G, planes - 1, planes + 1, 3 * planes + 5):
                if n_steps < 1:
                    continue
                ends = _gather_schedule(planes, G, n_steps)
                chunks = list(range(planes, n_steps, planes)) + [n_steps]
                assert set(chunks) <= set(ends)
                if G == planes:
                    assert ends == chunks


# the cards the v1 split is held on: an H100 SXM (132 SMs) and one of 114
V1_SMS = (smv.H100_SMS, 114)


def v1_columns(g, tile, ny, nz):
    """(part, node row, first node column) of each thread of column tile
    ``tile`` that owns nodes, as the v1 kernel numbers its threads: id =
    (p (ny + 1) + iy) zcols + jz owns node columns V1_NODES jz + n."""
    zcols = -(-(nz + 1) // smv.V1_NODES)
    ids = tile * smv.V1_THREADS + np.arange(smv.V1_THREADS)
    ids = ids[ids < g.cols]
    return ids // zcols // (ny + 1), ids // zcols % (ny + 1), \
        ids % zcols * smv.V1_NODES


def v1_walk(shape, sms):
    """The v1 launch at ``shape`` on ``sms`` SMs as the kernel walks it:
    the times each (part, node plane, node row, node column) is written,
    the node planes each block marches and the carry planes each block
    recomputes (one for each run that starts past plane 0)."""
    P, nx, ny, nz = shape
    g = smv.v1_geometry(*shape, sms)
    written = np.zeros((P, nx + 1, ny + 1, nz + 1), int)
    marched, recomputed = [], []
    for k in range(g.blocks):
        runs = smv.v1_runs(g, k)
        marched.append(sum(e - s for _t, s, e in runs))
        recomputed.append(sum(s > 0 for _t, s, _e in runs))
        assert all(s == 0 for _t, s, _e in runs[1:])
        for tile, s, e in runs:
            p, iy, iz0 = v1_columns(g, tile, ny, nz)
            for n in range(smv.V1_NODES):
                ok = iz0 + n <= nz
                planes = np.arange(s, e)[None, :]
                np.add.at(written, (p[ok, None], planes, iy[ok, None],
                                    iz0[ok, None] + n), 1)
    return g, written, marched, recomputed


@pytest.mark.parametrize("sms", V1_SMS)
@pytest.mark.parametrize("shape", GEOMETRY_SHAPES)
def test_v1_geometry_covers_every_node_once(shape, sms):
    """The v1 launch split: the kernel's walk of its block runs writes
    every (part, node plane, node row, node column) exactly once; every
    block recomputes at most one carry plane (where its first run starts
    past plane 0: a run that crosses into the next column tile starts it
    at plane 0); the blocks march the same number of planes within one;
    the launch is the card's resident blocks unless the work is smaller,
    and launch_args passes that count."""
    g, written, marched, recomputed = v1_walk(shape, sms)
    assert (written == 1).all()
    assert max(recomputed) <= 1
    assert max(marched) - min(marched) <= 1
    assert sum(marched) == g.tiles * g.planes
    assert g.blocks == min(sms * smv.V1_BLOCKS_PER_SM, g.tiles * g.planes)
    assert smv.launch_args("v1", *shape, torch.float32, 8, sms) \
        == (g.blocks,)
    assert not smv.VARIANTS["v1"][1]


@pytest.mark.parametrize("sms", V1_SMS)
def test_v1_geometry_flagship_is_one_wave(sms):
    """At the flagship slab v1 launches exactly the blocks the card holds
    at once, each marching 34 or 35 of the 90 x 151 (tile, plane) steps
    (132 SMs), so no wave has a tail; a block recomputes at most one carry
    plane, half a step of product, where the 16-plane segments of the
    v1 before it (commit 1aab56a) recomputed one in 16."""
    g, _written, marched, recomputed = v1_walk((1, 150, 150, 150), sms)
    assert g.blocks == sms * smv.V1_BLOCKS_PER_SM
    assert max(marched) - min(marched) <= 1
    assert sum(recomputed) <= g.blocks
    assert min(marched) >= 16 * 2


def emulate_v1(xg, ck, Ke, g):
    """The v1 kernel's algorithm in float64 numpy, as csrc/
    structured_matvec_v1.cu writes it: each block walks its runs
    (v1_runs); a thread's window of 3 x (V1_NODES + 2) nodes, its rows
    clamped onto the slab and its columns off the slab holding whatever
    the window held (here: large garbage), and its cells' ck (0 for a
    missing cell); the dx = 0 corners of cell plane i finish node plane
    i, the dx = 1 corners are carried; a run past plane 0 first
    recomputes its carry; node plane nx is the carry.  Returns y and the
    writes of each node."""
    P, _, nxn, nyn, nzn = xg.shape
    nx, ny, nz = nxn - 1, nyn - 1, nzn - 1
    kw = smv.V1_NODES + 2
    y = np.zeros_like(xg)
    writes = np.zeros(xg.shape, int)
    garbage = np.random.default_rng(0)
    for k in range(g.blocks):
        for tile, s, e in smv.v1_runs(g, k):
            p, iy, iz0 = v1_columns(g, tile, ny, nz)
            jy = np.clip(iy[:, None] + np.arange(3) - 1, 0, ny)
            jz = iz0[:, None] + np.arange(kw) - 1
            zout = (jz < 0) | (jz > nz)
            jz = np.clip(jz, 0, nz)
            cy = iy[:, None] - np.arange(2)
            cz = iz0[:, None] + np.arange(kw - 1) - 1
            live = ((cy >= 0) & (cy < ny))[:, :, None] \
                & ((cz >= 0) & (cz < nz))[:, None, :]
            cyc, czc = np.clip(cy, 0, ny - 1), np.clip(cz, 0, nz - 1)

            def window(px):         # [lane, c, dy, kz]
                w = xg[p[:, None, None, None], np.arange(3)[:, None, None],
                       px, jy[:, None, :, None], jz[:, None, None, :]]
                return np.where(zout[:, None, None, :],
                                garbage.uniform(-1e6, 1e6, w.shape), w)

            def cells(i):           # [lane, ey, k]
                return ck[p[:, None, None], i, cyc[:, :, None],
                          czc[:, None, :]] * live

            def corners(lo, hi, sc, dx):    # [lane, n, r]
                acc = np.zeros((len(p), smv.V1_NODES, 3))
                for b, (bx, ey, ez) in enumerate(smv.CORNERS):
                    if bx != dx:
                        continue
                    for n in range(smv.V1_NODES):
                        u = np.stack([
                            (hi if ax else lo)[:, c, ay - ey + 1,
                                               n - ez + az + 1]
                            for ax, ay, az in smv.CORNERS
                            for c in range(3)], axis=1)
                        acc[:, n] += sc[:, ey, n - ez + 1, None] \
                            * (u @ Ke[3 * b:3 * b + 3].T)
                return acc

            def store(i, v):
                for n in range(smv.V1_NODES):
                    ok = iz0 + n <= nz
                    y[p[ok], :, i, iy[ok], iz0[ok] + n] = v[ok, n]
                    writes[p[ok], :, i, iy[ok], iz0[ok] + n] += 1

            carry = np.zeros((len(p), smv.V1_NODES, 3))
            if s > 0:
                carry = corners(window(s - 1), window(s), cells(s - 1), 1)
            for i in range(s, min(e, nx)):
                lo, hi, sc = window(i), window(i + 1), cells(i)
                store(i, carry + corners(lo, hi, sc, 0))
                if i + 1 < e:
                    carry = corners(lo, hi, sc, 1)
            if e > nx:
                store(nx, carry)
    return y, writes


@pytest.mark.parametrize("sms", [1, smv.H100_SMS])
@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (1, 7, 3, 5),
                                   (2, 33, 17, 9), (1, 5, 2, 40)])
def test_v1_algorithm_matches_plain(shape, sms):
    """The v1 kernel's algorithm (emulate_v1: block runs across column
    tiles, clamped windows, missing cells at ck = 0, dx = 0 / 1 corners,
    recomputed carries) against the plain version in float64 at 1e-12 x
    max|y|, every node written exactly once; on 1 SM the runs cross
    column tiles in mid-run, on 132 most runs start past plane 0."""
    P, nx, ny, nz = shape
    rng = np.random.default_rng(13)
    xg = rng.standard_normal((P, 3, nx + 1, ny + 1, nz + 1))
    ck = rng.uniform(1.0, 10.0, (P, nx, ny, nz))
    Ke = np.asarray(both((4, 4, 4))[1][1]["blocks"][0]["Ke"])
    y, writes = emulate_v1(xg, ck, Ke, smv.v1_geometry(*shape, sms))
    y_ref = smv.structured_matvec_plain(torch.from_numpy(xg),
                                        torch.from_numpy(ck),
                                        torch.from_numpy(Ke)).numpy()
    assert (writes == 1).all()
    assert np.abs(y - y_ref).max() <= 1e-12 * np.abs(y_ref).max()


@pytest.mark.parametrize("shape", GEOMETRY_SHAPES)
def test_v2_launches_on_v6_float_tiles(shape):
    """v2 runs v6 float's tiles, as v4 does: its launch arguments are v6
    float's (seg_len, n_ty, n_tz, n_seg), whatever ``planes`` says."""
    assert {"v2", "v4", "v6"} <= set(smv.TILED)
    g = smv.v6_geometry(*shape, torch.float32)
    args = smv.launch_args("v2", *shape, torch.float32, 16)
    assert args == smv.launch_args("v4", *shape, torch.float32) \
        == smv.launch_args("v6", *shape, torch.float32) \
        == (g.seg_len, g.n_ty, g.n_tz, g.n_seg)


def v9_owner_counts(shape, geom):
    """How many times the v9 kernel's ownership map writes each node, by
    simulating it: every block (part, segment, y tile, z tile), every warp
    strip with a node row on the grid, strip rows 1 .. rows-1, lanes
    1 .. 31, node planes x0 .. x_end-1, nodes on the grid only."""
    P, nx, ny, nz = shape
    nxn, nyn, nzn = nx + 1, ny + 1, nz + 1
    counts = np.zeros((P, nxn, nyn, nzn), int)
    ty_nodes, tz_nodes = geom.tile_nodes
    for p in range(P):
        for seg in range(geom.n_seg):
            x0 = seg * geom.seg_len
            xs = slice(x0, min(x0 + geom.seg_len, nxn))
            for ty in range(geom.n_ty):
                for tz in range(geom.n_tz):
                    gz = tz * tz_nodes - 1 + np.arange(1, 32)
                    gz = gz[gz < nzn]
                    for w in range(smv.V9_WARPS):
                        cy0 = ty * ty_nodes - 1 + w * (geom.rows - 1)
                        gy = cy0 + np.arange(1, geom.rows)
                        gy = gy[gy < nyn]
                        counts[p, xs, gy[:, None], gz[None, :]] += 1
    return counts


# and shapes whose nodes end exactly on, or one past, a v9 tile edge (40 x
# 31 nodes at 6-row strips, 56 x 31 at 8, 24 x 31 at 4)
V9_SHAPES = GEOMETRY_SHAPES + [(1, 8, 39, 30), (1, 8, 40, 31),
                               (2, 17, 79, 61), (1, 5, 55, 62),
                               (1, 6, 23, 30)]


@pytest.mark.parametrize("rows", [smv.V9_ROWS, 4, 8])
@pytest.mark.parametrize("shape", V9_SHAPES)
def test_v9_geometry_covers_every_node_once(shape, rows):
    """The v9 launch geometry at the library's strip height and the
    sweep's: simulating the kernel's ownership map (warp strips, lanes,
    y and z tiles, x segments) writes every node of every part exactly
    once, at ragged shapes and at shapes that end exactly on a tile or
    strip edge; the blocks are parts x tiles x segments and no tile or
    segment owns nothing."""
    P, nx, ny, nz = shape
    g = smv.v9_geometry(P, nx, ny, nz, rows=rows)
    assert g.tile_nodes == (smv.V9_WARPS * (rows - 1), smv.V9_LANES_Z - 1)
    assert (v9_owner_counts(shape, g) == 1).all()
    assert g.blocks == P * g.n_ty * g.n_tz * g.n_seg
    assert (g.n_ty - 1) * g.tile_nodes[0] < ny + 1
    assert (g.n_tz - 1) * g.tile_nodes[1] < nz + 1
    assert (g.n_seg - 1) * g.seg_len < nx + 1
    assert g.threads == 32 * smv.V9_WARPS


def test_v9_geometry_flagship_fills_the_card():
    """At the flagship slab v9's blocks fill every SM of an H100 SXM to
    its V9_BLOCKS_PER_SM resident blocks at least once (the tiles alone
    do not), and the last wave is at least 3/4 full."""
    g = smv.v9_geometry(1, 150, 150, 150)
    slots = smv.H100_SMS * smv.V9_BLOCKS_PER_SM
    assert g.n_ty * g.n_tz < 0.9 * slots
    assert g.blocks >= 0.95 * slots
    waves = g.blocks / slots
    assert waves / -(-g.blocks // slots) >= 0.75


@pytest.mark.parametrize("rows", [smv.V9_ROWS, 4, 8])
def test_v9_shared_memory_fits_two_blocks_an_sm(rows):
    """v9's shared memory (the ring and KeT) stays under the 227 KB a
    block can have, and two blocks (16 warps) fit an SM with the runtime's
    1 KB a block; v9_geometry reports v9_smem_bytes."""
    smem = smv.v9_smem_bytes(rows)
    assert smem <= smv.BLOCK_SMEM
    assert smv.V9_BLOCKS_PER_SM * (smem + smv.SMEM_RESERVED) \
        <= smv.SM_SMEM
    assert smv.V9_BLOCKS_PER_SM * smv.V9_WARPS >= 16
    assert smv.v9_geometry(1, 150, 150, 150, rows=rows).smem_bytes == smem
    assert smv.v9_smem_bytes() == 68832


def emulate_v9(xg, ck, Ke, geom, cells):
    """The v9 kernel's algorithm in float64 numpy: the blocks of
    ``geom``, warp strips of geom.rows cell rows, ``cells`` rows a step,
    lanes along z with the dz = 1 corners moved one lane up (lane 0 keeps
    its own, as __shfl_up_sync does), the dy = 1 corners held for the next
    row, the dx = 1 sums carried in a rotated array, each node's eight
    contributions added in the kernel's order, writes of owned nodes only
    (the kernel's two passes over the inputs give the same numbers and are
    not repeated here).  Returns y and how often each node was written."""
    P, _, nxn, nyn, nzn = xg.shape
    nx, ny, nz = nxn - 1, nyn - 1, nzn - 1
    rows = geom.rows
    ty_nodes, tz_nodes = geom.tile_nodes
    y = np.zeros(xg.shape)
    writes = np.zeros(xg.shape, int)
    corners = [tuple(c) for c in smv.CORNERS]
    lanes = np.arange(32)

    def node(p, gp, gy, gz):
        out = np.zeros((3, 32))
        if 0 <= gp < nxn and 0 <= gy < nyn:
            ok = (gz >= 0) & (gz < nzn)
            out[:, ok] = xg[p, :, gp, gy, gz[ok]].T
        return out

    for p in range(P):
        for seg in range(geom.n_seg):
            x0 = seg * geom.seg_len
            x_end = min(x0 + geom.seg_len, nxn)
            for ty in range(geom.n_ty):
                for tz in range(geom.n_tz):
                    gz = tz * tz_nodes - 1 + lanes
                    cell_z = (gz >= 0) & (gz < nz)
                    node_z = (lanes >= 1) & (gz < nzn)
                    for w in range(smv.V9_WARPS):
                        cy0 = ty * ty_nodes - 1 + w * (rows - 1)
                        if not cy0 + 1 < nyn:
                            continue
                        carry = np.zeros((rows, 3, 32))
                        for k in range(x_end - x0 + 1):
                            i = x0 - 1 + k
                            prev = np.zeros((4, 3, 32))
                            for r0 in range(0, rows, cells):
                                v = np.zeros((cells, 24, 32))
                                for j in range(cells):
                                    cy = cy0 + r0 + j
                                    if not (0 <= i < nx):
                                        continue
                                    s = np.zeros(32)
                                    if 0 <= cy < ny:
                                        s[cell_z] = ck[p, i, cy, gz[cell_z]]
                                    u = np.concatenate([
                                        node(p, i + dx, cy + dy, gz + dz)
                                        for dx, dy, dz in corners])
                                    v[j] = (Ke @ u) * s
                                nxt = np.zeros((cells, 3, 32))
                                for j in range(cells):
                                    sh = np.stack([
                                        np.concatenate([v[j, 3 * b:3 * b + 3,
                                                          :1],
                                                        v[j, 3 * b:3 * b + 3,
                                                          :-1]], axis=1)
                                        for b in range(4, 8)])
                                    r = r0 + j
                                    gy = cy0 + r
                                    nxt[j] = v[j, 3:6] + prev[0] + sh[1] \
                                        + prev[2]
                                    out = carry[j] + v[j, 0:3] + prev[1] \
                                        + sh[0] + prev[3]
                                    if k > 0 and r > 0 and gy < nyn:
                                        zw = gz[node_z]
                                        y[p, :, i, gy, zw] = out[:, node_z].T
                                        writes[p, :, i, gy, zw] += 1
                                    prev = np.stack([v[j, 6:9], v[j, 9:12],
                                                     sh[2], sh[3]])
                                carry = np.concatenate([carry[cells:], nxt])
    return y, writes


@pytest.mark.parametrize("rows,cells", [(smv.V9_ROWS, 2), (4, 1), (6, 3),
                                        (8, 4)])
@pytest.mark.parametrize("shape", [(1, 4, 3, 5), (2, 7, 30, 33),
                                   (1, 9, 15, 70)])
def test_v9_algorithm_matches_plain(shape, rows, cells):
    """The v9 kernel's algorithm (emulate_v9: strips, cells a step,
    shuffles, held dy = 1 corners, rotated dx carries, recomputed edges)
    against the plain version in float64 at 1e-12 x max|y|, with every
    node written exactly once, across strip, y/z tile and x segment edges
    (a 9-plane segment length forced where the geometry would choose one
    segment)."""
    P, nx, ny, nz = shape
    rng = np.random.default_rng(12)
    xg = rng.standard_normal((P, 3, nx + 1, ny + 1, nz + 1))
    ck = rng.uniform(1.0, 10.0, (P, nx, ny, nz))
    Ke = np.asarray(both((4, 4, 4))[1][1]["blocks"][0]["Ke"])
    g = smv.v9_geometry(P, nx, ny, nz, rows=rows)
    seg_len = min(g.seg_len, 3)
    g = dataclasses.replace(g, seg_len=seg_len,
                            n_seg=-(-(nx + 1) // seg_len))
    y, writes = emulate_v9(xg, ck, Ke, g, cells)
    y_ref = smv.structured_matvec_plain(torch.from_numpy(xg),
                                        torch.from_numpy(ck),
                                        torch.from_numpy(Ke)).numpy()
    assert (writes == 1).all()
    assert np.abs(y - y_ref).max() <= 1e-12 * np.abs(y_ref).max()


# the TPU kernels each ported variant replaces, with the chunk sizes that
# apply (v1 and v2 march one plane a step and take none; v6 has its own
# test above)
PORTED_PALLAS = [("v1", jax_pallas.structured_matvec_pallas, None),
                 ("v2", jax_pallas.structured_matvec_pallas_v2, None)] + [
    (v, getattr(jax_pallas, f"structured_matvec_pallas_{v}"), planes)
    for v in ("v3", "v4", "v5", "v7", "v8", "v9") for planes in (8, 16)]


@pytest.mark.parametrize("variant,fn,planes", PORTED_PALLAS,
                         ids=[f"{v}-planes{p}" for v, _f, p in PORTED_PALLAS])
@pytest.mark.parametrize("dims,masked", [(d, False) for d in DIMS]
                         + [((4, 3, 3), True)])
def test_plain_matches_ported_pallas_variants_interpret(variant, fn, planes,
                                                        dims, masked):
    """The plain version (every kernel's reference) against the TPU
    kernels v1-v5 and v7-v9 through the Pallas interpreter, on the shapes
    of tests/test_pallas.py; ``masked`` zeroes the far-z cells, as its
    isolation case does."""
    nx, ny, nz = dims
    (_jops, jd), (_tops, td) = both(dims, dtype="float32")
    ck = np.asarray(jd["blocks"][0]["ck"]).copy()
    if masked:
        ck[:, :, :, -1] = 0.0
    xg = np.random.default_rng(3).normal(
        size=(3, nx + 1, ny + 1, nz + 1)).astype(np.float32)
    kw = {} if planes is None else dict(planes=planes)
    y_ref = np.asarray(fn(jnp.asarray(xg), jnp.asarray(ck[0]),
                          jd["blocks"][0]["Ke"], interpret=True, **kw))
    y = smv.structured_matvec_plain(torch.from_numpy(xg)[None],
                                    torch.from_numpy(ck),
                                    td["blocks"][0]["Ke"])[0].numpy()
    np.testing.assert_allclose(y, y_ref, **F32)


def test_zero_ck_cells_isolated():
    """Cells with ck = 0 contribute nothing (tests/test_pallas.py's
    isolation case), against the JAX XLA path and the v6 kernel."""
    (jops, jd), (_tops, td) = both((4, 3, 3), seed=1, dtype="float32")
    jblk = jd["blocks"][0]
    ck_masked = np.asarray(jblk["ck"]).copy()
    ck_masked[:, :, :, -1] = 0.0
    xg = np.random.default_rng(9).normal(size=(3, 5, 4, 4)) \
        .astype(np.float32)
    jd2 = dict(jd, blocks=[{**jblk, "ck": jnp.asarray(ck_masked)}])
    y_xla = np.asarray(jops.matvec_local(jd2, jnp.asarray(xg.reshape(1, -1))))
    y_v6 = np.asarray(structured_matvec_pallas_v6(
        jnp.asarray(xg), jnp.asarray(ck_masked[0]), jblk["Ke"],
        interpret=True))
    y = smv.structured_matvec_plain(
        torch.from_numpy(xg)[None], torch.from_numpy(ck_masked),
        td["blocks"][0]["Ke"]).numpy()
    np.testing.assert_allclose(y.reshape(1, -1), y_xla, **F32)
    np.testing.assert_allclose(y[0], y_v6, **F32)
    # and the mask bit: with the far-z cells live the result differs
    y_full = smv.structured_matvec_plain(
        torch.from_numpy(xg)[None], td["blocks"][0]["ck"].float(),
        td["blocks"][0]["Ke"])
    assert not np.allclose(y_full.numpy(), y)


def test_multi_part_matvec_diag_halo_match_jax():
    """n_parts = 2 on one device: the unsharded roll-view halo, the
    assembled matvec and the assembled diagonal, in float64."""
    (jops, jd), (tops, td) = both((8, 3, 5), n_parts=2)
    x = np.random.default_rng(7).normal(size=(2, tops.n_loc))
    y_ref = np.asarray(jops.matvec(jd, jnp.asarray(x)))
    y = tops.matvec(td, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, y_ref, rtol=0,
                               atol=1e-12 * np.abs(y_ref).max())
    d_ref = np.asarray(jops.diag(jd))
    d = tops.diag(td).numpy()
    np.testing.assert_allclose(d, d_ref, rtol=1e-14, atol=0)
    g = np.random.default_rng(8).normal(size=(2, 3, 5, 4, 6))
    h_ref = np.asarray(jops._halo(jnp.asarray(g)))
    h = tops._halo(torch.from_numpy(g)).numpy()
    np.testing.assert_array_equal(h, h_ref)


@pytest.mark.parametrize("dot", ["float32", "float64"])
def test_weighted_dots_match_jax(dot):
    """wdot / wdots: operands cast to the dot dtype BEFORE the multiply
    (f32 storage, f64 accumulation stays exact per product).  Summation
    order differs from XLA's: rtol 1e-5 for f32 sums, 1e-12 for f64."""
    rng = np.random.default_rng(4)
    w = (rng.random((2, 500)) > 0.2).astype(np.float32)
    a, b = (rng.normal(size=(2, 500)).astype(np.float32) for _ in range(2))
    jo = JaxOps(n_loc=500, n_iface=0, dot_dtype=jnp.dtype(dot))
    to = Ops(n_loc=500, n_iface=0, dot_dtype=getattr(torch, dot))
    rtol = 1e-5 if dot == "float32" else 1e-12
    ref = np.asarray(jo.wdots(jnp.asarray(w), [(jnp.asarray(a),
                                                 jnp.asarray(b)),
                                                (jnp.asarray(a),
                                                 jnp.asarray(a))],
                              extra=[3.0]))
    got = to.wdots(torch.from_numpy(w), [(torch.from_numpy(a),
                                          torch.from_numpy(b)),
                                         (torch.from_numpy(a),
                                          torch.from_numpy(a))],
                   extra=[3.0])
    assert got.dtype == getattr(torch, dot)
    np.testing.assert_allclose(got.numpy(), ref, rtol=rtol)
    one = to.wdot(torch.from_numpy(w), torch.from_numpy(a),
                  torch.from_numpy(b))
    np.testing.assert_allclose(one.numpy(), ref[0], rtol=rtol)


def test_wrapper_cpu_takes_plain_path_and_counts_nothing():
    (_jops, _jd), (tops, td) = both((4, 4, 4))
    blk = td["blocks"][0]
    xg = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 3, 5, 5, 5)))
    before = dict(smv.LAUNCHES)
    y = smv.structured_matvec(xg, blk["ck"], blk["Ke"])
    assert smv.LAUNCHES == before
    assert torch.equal(y, smv.structured_matvec_plain(xg, blk["ck"],
                                                      blk["Ke"]))


@pytest.mark.parametrize("variant", sorted(smv.VARIANTS))
def test_wrapper_cpu_plain_path_for_every_variant(variant):
    """On a CPU tensor every variant (and any planes) takes the plain
    version and launches nothing."""
    (_jops, _jd), (_tops, td) = both((5, 4, 3), dtype="float32")
    blk = td["blocks"][0]
    xg = torch.from_numpy(np.random.default_rng(2).normal(
        size=(1, 3, 6, 5, 4)).astype(np.float32))
    before = dict(smv.LAUNCHES)
    y = smv.structured_matvec(xg, blk["ck"], blk["Ke"], variant=variant,
                              planes=16)
    assert smv.LAUNCHES == before
    assert torch.equal(y, smv.structured_matvec_plain(xg, blk["ck"],
                                                      blk["Ke"]))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    (_jops, _jd), (_tops, td) = both((4, 4, 4))
    blk = td["blocks"][0]
    xg = torch.zeros((1, 3, 5, 5, 5), dtype=torch.float64)
    with pytest.raises(TypeError, match="dtype"):
        smv.structured_matvec(xg.float(), blk["ck"], blk["Ke"])
    with pytest.raises(ValueError, match="contiguous"):
        smv.structured_matvec(xg.transpose(2, 4), blk["ck"], blk["Ke"])
    with pytest.raises(ValueError, match="ck must be"):
        smv.structured_matvec(xg, blk["ck"][:, :-1], blk["Ke"])
    with pytest.raises(ValueError, match="Ke must be"):
        smv.structured_matvec(xg, blk["ck"], blk["Ke"][:8])
    with pytest.raises(TypeError, match="dtype"):
        smv.structured_matvec(xg.half(), blk["ck"].half(), blk["Ke"].half())
    for bad in ("v0", "v10", "6", "xla"):
        with pytest.raises(ValueError, match="variant must be"):
            smv.structured_matvec(xg, blk["ck"], blk["Ke"], variant=bad)

"""Tests of the port that need the card: each CUDA kernel against its plain
PyTorch version, the kernel a solve's launches go to under each
``PCG_TPU_PALLAS_V``, a whole solve on the card against the same solve
on the CPU (classic, fused and pipelined; two pipelined solves bitwise
equal), the block3 and mg preconditioners' applies on the card
against the CPU (two V-cycles bitwise equal), and blocked right-hand
sides (``solve_many`` on the card against the CPU under each variant, a
blocked matvec's columns bit for bit its single launches, two blocks
bitwise equal, one kernel launch a lockstep trip), and the chunked path
(capped dispatches bitwise the one-shot solve, a NaN-carry recovery,
kill-and-resume bitwise), and the hybrid level-grid backend (every
kernel on level batches, the operator and the bucketed refresh against
the CPU and bitwise repeatable, the 6^3 octree solve against the CPU, a
block's columns bit for bit their width-1 solves), the node-owned
gather at chunks above 54 planes (v5's bits at 8), the export path's
nodal fields against the CPU's (two exports bitwise), the mixed
shell's windows against the CPU, and the time integrators (Newmark and
explicit dynamics on the card against the CPU, their level batches'
launches counted on the hybrid backend), a solve on the native graph
partition against the CPU, a warm partition-cache Solver against the
cold one, the convergence ring and a profile capture on the card (a
traced solve bitwise the untraced one, with as many synchronising calls;
v6 in the matvec phase), a served block of the solve service against
its jobs' width-1 solves, and two ranks over gloo on the one card (a
structured matvec bitwise the one-process one, a solve within one
iteration of it).  They carry the
``cuda`` marker and skip with a reason where
``torch.cuda.is_available()`` is False.  This file imports no JAX (the
machine with the card has none); there, run it without the repository's
JAX conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig, TimeHistoryConfig
from pcg_mpi_solver_tpu_torch.models import make_cube_model
from pcg_mpi_solver_tpu_torch.models.element import unit_element_library
from pcg_mpi_solver_tpu_torch.ops import structured_matvec as smv
from pcg_mpi_solver_tpu_torch.solver import Solver


@pytest.fixture
def cuda_device():
    """The card; decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.float64, 1e-12)])
def test_kernel_matches_plain_on_card(cuda_device, dtype, tol):
    """Ragged shapes and two parts; tolerance tol * max|y| (the kernel sums
    in another order than the einsum + translates)."""
    rng = np.random.default_rng(0)
    Ke = torch.as_tensor(unit_element_library(0.2)["Ke"], dtype=dtype,
                         device=cuda_device)
    name = str(dtype).removeprefix("torch.")
    for P, (nx, ny, nz) in [(1, (7, 3, 5)), (2, (6, 5, 4)), (1, (1, 1, 1))]:
        x = torch.as_tensor(rng.normal(size=(P, 3, nx + 1, ny + 1, nz + 1)),
                            dtype=dtype, device=cuda_device)
        ck = torch.as_tensor(rng.uniform(1, 10, (P, nx, ny, nz)),
                             dtype=dtype, device=cuda_device)
        before = smv.LAUNCHES[("v6", name)]
        y = smv.structured_matvec(x, ck, Ke)
        torch.cuda.synchronize()
        assert smv.LAUNCHES[("v6", name)] == before + 1
        y_plain = smv.structured_matvec_plain(x, ck, Ke)
        assert (y - y_plain).abs().max() <= tol * y_plain.abs().max()


NEW_VARIANTS = [("v1", None), ("v2", None)] + [
    (v, planes) for v in ("v3", "v4", "v5", "v7", "v8", "v9")
    for planes in (8, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("variant,planes", NEW_VARIANTS,
                         ids=[f"{v}-planes{p}" for v, p in NEW_VARIANTS])
def test_variant_kernel_matches_plain_on_card(cuda_device, variant, planes):
    """Each float32 variant on ragged shapes (34 node planes leave a ragged
    tail chunk at 8 and 16 planes) and two parts: within 2e-5 * max|y| of
    the plain version, two launches bitwise equal (no kernel uses
    atomics), one launch counted under its own name.  v6 runs first with
    the same Ke tensor: each library stages Ke into its own constant
    bank."""
    rng = np.random.default_rng(2)
    Ke = torch.as_tensor(unit_element_library(0.2)["Ke"],
                         dtype=torch.float32, device=cuda_device)
    for P, (nx, ny, nz) in [(1, (7, 3, 5)), (2, (33, 17, 9)),
                            (1, (1, 1, 1)), (2, (6, 5, 40))]:
        x = torch.as_tensor(rng.normal(size=(P, 3, nx + 1, ny + 1, nz + 1)),
                            dtype=torch.float32, device=cuda_device)
        ck = torch.as_tensor(rng.uniform(1, 10, (P, nx, ny, nz)),
                             dtype=torch.float32, device=cuda_device)
        y_plain = smv.structured_matvec_plain(x, ck, Ke)
        tol = 2e-5 * y_plain.abs().max()
        assert (smv.structured_matvec(x, ck, Ke) - y_plain).abs().max() \
            <= tol
        before = dict(smv.LAUNCHES)
        y = smv.structured_matvec(x, ck, Ke, variant=variant, planes=planes)
        y2 = smv.structured_matvec(x, ck, Ke, variant=variant, planes=planes)
        torch.cuda.synchronize()
        assert smv.LAUNCHES[(variant, "float32")] \
            == before[(variant, "float32")] + 2
        assert (y - y_plain).abs().max() <= tol
        assert torch.equal(y, y2)


@pytest.mark.cuda
@pytest.mark.parametrize("value", ["1", "2", "3", "4", "5", "7", "8", "9"])
def test_solver_routes_launches_to_its_variant(cuda_device, monkeypatch,
                                               value):
    """A Solver built under PCG_TPU_PALLAS_V=k sends every float32 matvec
    of a mixed solve to kernel vk and every float64 one to v6's double
    kernel; no other kernel is launched."""
    monkeypatch.setenv("PCG_TPU_PALLAS_V", value)
    model = make_cube_model(12, 6, 5, E=30e9, heterogeneous=True, seed=4,
                            load="dirichlet", load_value=1e-3)
    s = Solver(model, RunConfig(solver=SolverConfig(
        tol=1e-9, precision_mode="mixed", max_iter=500)))
    assert s.kernel_variant == f"v{value}"
    smv.reset_launch_counts()
    (res,) = s.solve()
    assert res.flag == 0
    variant = f"v{value}"
    assert smv.LAUNCHES[(variant, "float32")] >= res.iters
    assert smv.LAUNCHES[("v6", "float64")] >= 2
    assert all(n == 0 for (v, d), n in smv.LAUNCHES.items()
               if d == "float32" and v != variant)


@pytest.mark.cuda
@pytest.mark.parametrize("variant,planes", [("v5", 56), ("v3", 56),
                                            ("v7", 55)])
def test_chunk_too_large_for_shared_memory_is_refused(cuda_device, variant,
                                                      planes):
    """v5, v3 and v7 (the node-owned gather) at a chunk whose ring of two
    whole chunks (2C + 2 slots) is above the 227 KB a block can have even
    at 2 rows (55 is the first C above 54) are no longer refused: they
    stage each chunk in groups (of 19 on the 8-row tile), launch once
    (counted), and give v5's bits at C = 8."""
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.normal(size=(1, 3, 131, 5, 4)),
                        dtype=torch.float32, device=cuda_device)
    ck = torch.as_tensor(rng.uniform(1, 10, (1, 130, 4, 3)),
                         dtype=torch.float32, device=cuda_device)
    Ke = torch.as_tensor(unit_element_library(0.2)["Ke"],
                         dtype=torch.float32, device=cuda_device)
    before = smv.LAUNCHES[(variant, "float32")]
    y = smv.structured_matvec(x, ck, Ke, variant=variant, planes=planes)
    y8 = smv.structured_matvec(x, ck, Ke, variant="v5", planes=8)
    torch.cuda.synchronize()
    assert smv.LAUNCHES[(variant, "float32")] == before + 1 + (variant
                                                               == "v5")
    assert torch.equal(y, y8)


# the chunks JAX's pallas_planes accepts above the 54 a whole ring fits
BIG_PLANES = (56, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("planes", BIG_PLANES)
@pytest.mark.parametrize("variant", ["v5", "v3", "v7"])
@pytest.mark.parametrize("P,cells", [(1, (150, 150, 150)), (2, (40, 37, 70)),
                                     (1, (100, 200, 200))],
                         ids=["150^3", "40x37x70", "100x200x200"])
def test_gather_at_big_chunks_gives_the_bits_of_8_planes(
        cuda_device, P, cells, variant, planes):
    """v5, v3 and v7 at C = 56 and 64 (staged in groups of G = 19 on the
    8-row tile, the ring within 227 KB as the library reports) give v5's
    C = 8 bits at
    the flagship and across tile and segment edges, and the plain
    version's values within 2e-5 * max|y|."""
    nx, ny, nz = cells
    geo = smv.v5_geometry(P, nx, ny, nz, planes,
                          smv._sm_count(cuda_device.index or 0))
    lib = smv._library(variant)
    assert getattr(lib, f"structured_matvec_{variant}_smem_bytes")(
        planes, geo.rows) == geo.smem_bytes <= smv.BLOCK_SMEM
    assert geo.group == 19 < planes
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.normal(size=(P, 3, nx + 1, ny + 1, nz + 1)),
                        dtype=torch.float32, device=cuda_device)
    ck = torch.as_tensor(rng.uniform(1, 10, (P, nx, ny, nz)),
                         dtype=torch.float32, device=cuda_device)
    Ke = torch.as_tensor(unit_element_library(0.2)["Ke"],
                         dtype=torch.float32, device=cuda_device)
    y = smv.structured_matvec(x, ck, Ke, variant=variant, planes=planes)
    y8 = smv.structured_matvec(x, ck, Ke, variant="v5", planes=8)
    torch.cuda.synchronize()
    assert torch.equal(y, y8)
    y_plain = smv.structured_matvec_plain(x, ck, Ke)
    assert (y - y_plain).abs().max() <= 2e-5 * y_plain.abs().max()


# v5 at a single cell and at shapes whose ny+1 and nz+1 cross its (y, z)
# tiles without filling the last; the first two span several x segments,
# the last has segments longer than two chunks, so its ring wraps
V5_EDGE = [(1, (1, 1, 1)), (2, (40, 37, 70)), (1, (20, 70, 40)),
           (1, (100, 200, 200))]


@pytest.mark.cuda
@pytest.mark.parametrize("planes", [8, 16])
@pytest.mark.parametrize("P,cells", V5_EDGE,
                         ids=["x".join(map(str, c)) for _p, c in V5_EDGE])
def test_v5_kernel_across_tile_and_segment_edges(cuda_device, P, cells,
                                                 planes):
    """v5 within 2e-5 * max|y| of the plain version, two launches bitwise
    equal, each counted once; its shared memory as v5_smem_bytes says."""
    nx, ny, nz = cells
    geo = smv.v5_geometry(P, nx, ny, nz, planes,
                          smv._sm_count(cuda_device.index or 0))
    if cells != (1, 1, 1):
        assert min(geo.n_ty, geo.n_tz) >= 2
        assert (ny + 1) % geo.rows and (nz + 1) % smv.V5_LANES_Z
        if P == 2:
            assert geo.n_seg >= 2
        if nx == 100:
            assert geo.seg_len > 2 * planes
    lib = smv._library("v5")
    assert lib.structured_matvec_v5_smem_bytes(planes, geo.rows) \
        == geo.smem_bytes
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.normal(size=(P, 3, nx + 1, ny + 1, nz + 1)),
                        dtype=torch.float32, device=cuda_device)
    ck = torch.as_tensor(rng.uniform(1, 10, (P, nx, ny, nz)),
                         dtype=torch.float32, device=cuda_device)
    Ke = torch.as_tensor(unit_element_library(0.2)["Ke"],
                         dtype=torch.float32, device=cuda_device)
    before = smv.LAUNCHES[("v5", "float32")]
    y = smv.structured_matvec(x, ck, Ke, variant="v5", planes=planes)
    y2 = smv.structured_matvec(x, ck, Ke, variant="v5", planes=planes)
    torch.cuda.synchronize()
    assert smv.LAUNCHES[("v5", "float32")] == before + 2
    y_plain = smv.structured_matvec_plain(x, ck, Ke)
    assert (y - y_plain).abs().max() <= 2e-5 * y_plain.abs().max()
    assert torch.equal(y, y2)


V6_EDGE = [(1, (1, 1, 1)), (2, (40, 37, 70)), (1, (20, 70, 40))]


@pytest.mark.cuda
@pytest.mark.parametrize("P,cells", V6_EDGE,
                         ids=["x".join(map(str, c)) for _p, c in V6_EDGE])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.float64, 1e-12)],
                         ids=["float32", "float64"])
def test_v6_kernel_across_tile_and_segment_edges(cuda_device, dtype, tol, P,
                                                 cells):
    """v6 on a single cell and on shapes whose ny+1 and nz+1 cross several
    of its (y, z) tiles without filling the last one and whose nx+1 spans
    several x segments (two parts in one): within tol * max|y| of the plain
    version, two launches bitwise equal, each launch counted once."""
    geo = smv.v6_geometry(P, *cells, dtype)
    if cells != (1, 1, 1):
        assert min(geo.n_ty, geo.n_tz, geo.n_seg) >= 2
        assert (cells[1] + 1) % geo.tile_nodes[0] \
            and (cells[2] + 1) % geo.tile_nodes[1]
    rng = np.random.default_rng(3)
    nx, ny, nz = cells
    x = torch.as_tensor(rng.normal(size=(P, 3, nx + 1, ny + 1, nz + 1)),
                        dtype=dtype, device=cuda_device)
    ck = torch.as_tensor(rng.uniform(1, 10, (P, nx, ny, nz)), dtype=dtype,
                         device=cuda_device)
    Ke = torch.as_tensor(unit_element_library(0.2)["Ke"], dtype=dtype,
                         device=cuda_device)
    name = str(dtype).removeprefix("torch.")
    before = smv.LAUNCHES[("v6", name)]
    y = smv.structured_matvec(x, ck, Ke)
    y2 = smv.structured_matvec(x, ck, Ke)
    torch.cuda.synchronize()
    assert smv.LAUNCHES[("v6", name)] == before + 2
    y_plain = smv.structured_matvec_plain(x, ck, Ke)
    assert (y - y_plain).abs().max() <= tol * y_plain.abs().max()
    assert torch.equal(y, y2)


@pytest.mark.cuda
@pytest.mark.parametrize("P,cells", V6_EDGE,
                         ids=["x".join(map(str, c)) for _p, c in V6_EDGE])
def test_v4_kernel_across_tile_and_segment_edges(cuda_device, P, cells):
    """v4 (float32 on v6's tiles, in a library of its own) on a single
    cell and on shapes that cross several of its (y, z)
    tiles without filling the last one and span several x segments (two
    parts in one): within 2e-5 * max|y| of the plain version, two launches
    bitwise equal, each launch counted once; a grid that is not the
    library's tile is refused by its entry point."""
    nx, ny, nz = cells
    geo = smv.v6_geometry(P, nx, ny, nz, torch.float32)
    if cells != (1, 1, 1):
        assert min(geo.n_ty, geo.n_tz, geo.n_seg) >= 2
        assert (ny + 1) % geo.tile_nodes[0] and (nz + 1) % geo.tile_nodes[1]
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.normal(size=(P, 3, nx + 1, ny + 1, nz + 1)),
                        dtype=torch.float32, device=cuda_device)
    ck = torch.as_tensor(rng.uniform(1, 10, (P, nx, ny, nz)),
                         dtype=torch.float32, device=cuda_device)
    Ke = torch.as_tensor(unit_element_library(0.2)["Ke"],
                         dtype=torch.float32, device=cuda_device)
    before = smv.LAUNCHES[("v4", "float32")]
    y = smv.structured_matvec(x, ck, Ke, variant="v4")
    y2 = smv.structured_matvec(x, ck, Ke, variant="v4")
    torch.cuda.synchronize()
    assert smv.LAUNCHES[("v4", "float32")] == before + 2
    y_plain = smv.structured_matvec_plain(x, ck, Ke)
    assert (y - y_plain).abs().max() <= 2e-5 * y_plain.abs().max()
    assert torch.equal(y, y2)
    lib = smv._library("v4")
    bad = (geo.seg_len, geo.n_ty + 1, geo.n_tz, geo.n_seg)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    err = lib.structured_matvec_v4_f32(
        x.data_ptr(), ck.data_ptr(), y.data_ptr(), P, nx, ny, nz, *bad,
        cuda_device.index or 0, stream)
    assert lib.structured_matvec_v4_error_string(err).decode() \
        == "invalid argument"


# v2 and v8 run v6 float's tile kernel, v3 and v7 v5's node-owned gather,
# each from a library of its own: each gives the bits of the kernel it shares, at the
# shapes of test_variant_kernel_matches_plain_on_card and at that design's
# edge shapes (V6_EDGE, V5_EDGE), v3 and v7 at 8 and 16 planes
SAME_BITS = [("v2", "v6", None), ("v3", "v5", 8), ("v3", "v5", 16),
             ("v8", "v6", None), ("v7", "v5", 8), ("v7", "v5", 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("variant,like,planes", SAME_BITS,
                         ids=[f"{v}-{w}-planes{p}" for v, w, p in SAME_BITS])
def test_variant_gives_the_bits_of_the_kernel_it_shares(cuda_device,
                                                        variant, like,
                                                        planes):
    """v2 and v8 give v6 float's bits, v3 and v7 v5's (two parts
    included); two launches of each are bitwise equal (no atomics), each
    counted once under its own name; the entry points of v2 and v8 refuse
    a grid that is not their library's tile, as v4's does."""
    rng = np.random.default_rng(7)
    Ke = torch.as_tensor(unit_element_library(0.2)["Ke"],
                         dtype=torch.float32, device=cuda_device)
    edge = V6_EDGE if variant in smv.TILED else V5_EDGE
    shapes = [(1, (7, 3, 5)), (2, (33, 17, 9)), (2, (6, 5, 40))] + edge
    for P, (nx, ny, nz) in shapes:
        x = torch.as_tensor(rng.normal(size=(P, 3, nx + 1, ny + 1, nz + 1)),
                            dtype=torch.float32, device=cuda_device)
        ck = torch.as_tensor(rng.uniform(1, 10, (P, nx, ny, nz)),
                             dtype=torch.float32, device=cuda_device)
        before = smv.LAUNCHES[(variant, "float32")]
        y = smv.structured_matvec(x, ck, Ke, variant=variant, planes=planes)
        y2 = smv.structured_matvec(x, ck, Ke, variant=variant, planes=planes)
        y_like = smv.structured_matvec(x, ck, Ke, variant=like,
                                       planes=planes)
        torch.cuda.synchronize()
        assert smv.LAUNCHES[(variant, "float32")] == before + 2
        assert torch.equal(y, y2)
        assert torch.equal(y, y_like), (P, nx, ny, nz)
    if variant in smv.TILED:
        g = smv.v6_geometry(P, nx, ny, nz, torch.float32)
        bad = (g.seg_len, g.n_ty + 1, g.n_tz, g.n_seg)
        name = smv.VARIANTS[variant][0]
        lib = smv._library(variant)
        err = getattr(lib, f"{name}_f32")(
            x.data_ptr(), ck.data_ptr(), y.data_ptr(), P, nx, ny, nz, *bad,
            cuda_device.index or 0,
            torch.cuda.current_stream(cuda_device).cuda_stream)
        assert getattr(lib, f"{name}_error_string")(err).decode() \
            == "invalid argument"


# v9 at a single cell, at shapes that cross its warp strips, (y, z) tiles
# (40 x 31 nodes) and x segments without filling the last (two parts in
# one), at two whose nodes end exactly on a tile edge (two parts in one),
# and at one whose segments wrap the three-slot ring
V9_EDGE = [(1, (1, 1, 1)), (2, (40, 37, 70)), (1, (20, 70, 40)),
           (2, (9, 79, 61)), (1, (30, 39, 30)), (1, (100, 200, 200))]


@pytest.mark.cuda
@pytest.mark.parametrize("P,cells", V9_EDGE,
                         ids=["x".join(map(str, c)) for _p, c in V9_EDGE])
def test_v9_kernel_across_strip_tile_and_segment_edges(cuda_device, P,
                                                       cells):
    """v9 within 2e-5 * max|y| of the plain version, two launches bitwise
    equal (no atomics), each counted once; its shared memory as
    v9_geometry says, and a grid that is not the library's tile is
    refused by its entry point."""
    nx, ny, nz = cells
    geo = smv.v9_geometry(P, nx, ny, nz,
                          smv._sm_count(cuda_device.index or 0))
    if cells != (1, 1, 1):
        exact = (ny + 1) % geo.tile_nodes[0] == 0 \
            and (nz + 1) % geo.tile_nodes[1] == 0
        assert geo.n_seg >= 2 and (geo.n_ty * geo.n_tz >= 2 or exact)
    lib = smv._library("v9")
    assert lib.structured_matvec_v9_smem_bytes() == geo.smem_bytes
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.normal(size=(P, 3, nx + 1, ny + 1, nz + 1)),
                        dtype=torch.float32, device=cuda_device)
    ck = torch.as_tensor(rng.uniform(1, 10, (P, nx, ny, nz)),
                         dtype=torch.float32, device=cuda_device)
    Ke = torch.as_tensor(unit_element_library(0.2)["Ke"],
                         dtype=torch.float32, device=cuda_device)
    before = smv.LAUNCHES[("v9", "float32")]
    y = smv.structured_matvec(x, ck, Ke, variant="v9")
    y2 = smv.structured_matvec(x, ck, Ke, variant="v9")
    torch.cuda.synchronize()
    assert smv.LAUNCHES[("v9", "float32")] == before + 2
    y_plain = smv.structured_matvec_plain(x, ck, Ke)
    assert (y - y_plain).abs().max() <= 2e-5 * y_plain.abs().max()
    assert torch.equal(y, y2)
    bad = (geo.seg_len, geo.n_ty + 1, geo.n_tz, geo.n_seg)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    err = lib.structured_matvec_v9_f32(
        x.data_ptr(), ck.data_ptr(), y.data_ptr(), P, nx, ny, nz, *bad,
        cuda_device.index or 0, stream)
    assert lib.structured_matvec_v9_error_string(err).decode() \
        == "invalid argument"


V1_EDGE = [(1, (1, 1, 1)), (2, (40, 37, 70)), (2, (60, 70, 40)),
           (1, (100, 200, 200))]


@pytest.mark.cuda
@pytest.mark.parametrize("P,cells", V1_EDGE,
                         ids=["x".join(map(str, c)) for _p, c in V1_EDGE])
def test_v1_kernel_across_column_tiles(cuda_device, P, cells):
    """v1 on a single cell and on shapes where the card's resident blocks
    march runs that cross from one column tile into the next in mid-run,
    the last tile ragged (two parts in two of them): within 2e-5 * max|y|
    of the plain version, two launches bitwise equal, each counted once;
    an SM holds the blocks v1_geometry launches; the same bits from other
    block counts (the split only moves work between blocks), and a launch
    of no blocks refused by its entry point."""
    nx, ny, nz = cells
    dev = cuda_device.index or 0
    geo = smv.v1_geometry(P, nx, ny, nz, smv._sm_count(dev))
    if cells != (1, 1, 1):
        assert geo.cols % smv.V1_THREADS
        assert any(len(smv.v1_runs(geo, k)) > 1 for k in range(geo.blocks))
    lib = smv._library("v1")
    assert lib.structured_matvec_v1_blocks_per_sm(dev) \
        == smv.V1_BLOCKS_PER_SM
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.normal(size=(P, 3, nx + 1, ny + 1, nz + 1)),
                        dtype=torch.float32, device=cuda_device)
    ck = torch.as_tensor(rng.uniform(1, 10, (P, nx, ny, nz)),
                         dtype=torch.float32, device=cuda_device)
    Ke = torch.as_tensor(unit_element_library(0.2)["Ke"],
                         dtype=torch.float32, device=cuda_device)
    before = smv.LAUNCHES[("v1", "float32")]
    y = smv.structured_matvec(x, ck, Ke, variant="v1")
    y2 = smv.structured_matvec(x, ck, Ke, variant="v1")
    torch.cuda.synchronize()
    assert smv.LAUNCHES[("v1", "float32")] == before + 2
    y_plain = smv.structured_matvec_plain(x, ck, Ke)
    assert (y - y_plain).abs().max() <= 2e-5 * y_plain.abs().max()
    assert torch.equal(y, y2)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    for blocks in (1, 7, geo.blocks + 5, 0):
        y3 = torch.empty_like(x)
        err = lib.structured_matvec_v1_f32(
            x.data_ptr(), ck.data_ptr(), y3.data_ptr(), P, nx, ny, nz,
            blocks, dev, stream)
        if blocks == 0:
            assert lib.structured_matvec_v1_error_string(err).decode() \
                == "invalid argument"
        else:
            torch.cuda.synchronize()
            assert err == 0 and torch.equal(y3, y)


@pytest.mark.cuda
def test_kernel_reads_the_ke_it_is_given(cuda_device):
    """Ke is staged into the constant bank only when it changes: an
    in-place change of the same tensor and another tensor are both seen.
    Doubling Ke is exact, so the results compare bitwise.  The caller's
    current device is left as it was."""
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(size=(1, 3, 6, 5, 4)),
                        dtype=torch.float32, device=cuda_device)
    ck = torch.as_tensor(rng.uniform(1, 10, (1, 5, 4, 3)),
                         dtype=torch.float32, device=cuda_device)
    Ke = torch.as_tensor(unit_element_library(0.2)["Ke"],
                         dtype=torch.float32, device=cuda_device)
    before = torch.cuda.current_device()
    y1 = smv.structured_matvec(x, ck, Ke)
    Ke.mul_(2.0)
    y2 = smv.structured_matvec(x, ck, Ke)
    y3 = smv.structured_matvec(x, ck, Ke * 0.5)
    torch.cuda.synchronize()
    assert torch.equal(y2, 2.0 * y1)
    assert torch.equal(y3, y1)
    assert torch.cuda.current_device() == before


@pytest.mark.cuda
@pytest.mark.parametrize("mode,rtol", [("direct", 1e-8), ("mixed", 1e-5)])
def test_solve_on_card_matches_cpu(cuda_device, mode, rtol):
    """The whole slice on the card against the plain path on the CPU:
    flag 0 both, displacements within the solve's tolerance scale."""
    model = make_cube_model(12, 6, 5, E=30e9, heterogeneous=True, seed=4,
                            load="dirichlet", load_value=1e-3)
    cfg = RunConfig(solver=SolverConfig(tol=1e-9, precision_mode=mode,
                                        max_iter=500),
                    time_history=TimeHistoryConfig(
                        time_step_delta=(0.0, 0.5, 1.0)))
    out = {}
    for dev in ("cuda", "cpu"):
        s = Solver(model, cfg, device=dev)
        out[dev] = ([r.flag for r in s.solve()], s.displacement_global())
    assert out["cuda"][0] == out["cpu"][0] == [0, 0]
    u_g, u_c = out["cuda"][1], out["cpu"][1]
    np.testing.assert_allclose(u_g, u_c, rtol=0,
                               atol=rtol * np.abs(u_c).max())


def _precond_solvers(precond, dtype, n_parts=2):
    """The same mg- or block3-configured cube on the card and on the CPU
    (two parts, so the halo and the owner-weighted restriction run)."""
    model = make_cube_model(12, 8, 6, E=30e9, heterogeneous=True, seed=4)
    cfg = RunConfig(solver=SolverConfig(precond=precond, dtype=dtype))
    return {dev: Solver(model, cfg, n_parts=n_parts, device=dev)
            for dev in ("cuda", "cpu")}


@pytest.mark.cuda
@pytest.mark.parametrize("precond", ["block3", "mg"])
@pytest.mark.parametrize("dtype,tol", [("float64", 1e-10),
                                       ("float32", 1e-5)])
def test_preconditioner_apply_on_card_matches_cpu(cuda_device, precond,
                                                  dtype, tol):
    """block3's inverse and apply and one V-cycle on the card (the fine
    matvecs through the kernel, the coarse levels as torch ops) against
    the plain path on the CPU, within tol * max|z| (the kernel and the
    card's reductions sum in another order).  Under mg the fine level
    launches the kernel 2 * mg_smooth_degree times an apply."""
    from pcg_mpi_solver_tpu_torch.ops.precond import make_prec

    solvers = _precond_solvers(precond, dtype)
    r = np.random.default_rng(9).normal(size=solvers["cpu"].un.shape) \
        * solvers["cpu"].pm.eff
    z = {}
    for dev, s in solvers.items():
        m = make_prec(s.ops, s.data, precond)
        if dev == "cuda":
            smv.reset_launch_counts()
        z[dev] = s.ops.apply_prec(
            m, torch.as_tensor(r, dtype=s.dtype, device=dev), s.data)
        if dev == "cuda":
            torch.cuda.synchronize()
            launched = smv.LAUNCHES[("v6", dtype)]
            assert launched == (2 * s.ops.mg_degree if precond == "mg"
                                else 0)
    if precond == "mg":
        np.testing.assert_allclose(solvers["cuda"].mg_lam,
                                   solvers["cpu"].mg_lam, rtol=tol)
    zc = z["cpu"].numpy()
    np.testing.assert_allclose(z["cuda"].cpu().numpy(), zc, rtol=0,
                               atol=tol * np.abs(zc).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_vcycle_applies_are_bitwise_equal_on_card(cuda_device, dtype):
    """Two V-cycles on the same vector give the same bits on the card: the
    restrictions are fixed-order gathers, not float atomics, so the
    preconditioner is the one fixed operator plain CG needs."""
    from pcg_mpi_solver_tpu_torch.ops.precond import make_prec

    s = _precond_solvers("mg", dtype)["cuda"]
    m = make_prec(s.ops, s.data, "mg")
    r = torch.randn(s.un.shape, dtype=s.dtype, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(3))
    r = r * s.data["eff"]
    z1 = s.ops.apply_prec(m, r, s.data)
    z2 = s.ops.apply_prec(m, r, s.data)
    torch.cuda.synchronize()
    assert torch.isfinite(z1).all() and torch.equal(z1, z2)


def _variant_solver(variant, mode, device, precond="jacobi"):
    """The 12x6x5 card-against-CPU model under a PCG variant."""
    model = make_cube_model(12, 6, 5, E=30e9, heterogeneous=True, seed=4,
                            load="dirichlet", load_value=1e-3)
    cfg = RunConfig(solver=SolverConfig(tol=1e-9, precision_mode=mode,
                                        max_iter=500, precond=precond,
                                        pcg_variant=variant),
                    time_history=TimeHistoryConfig(
                        time_step_delta=(0.0, 0.5, 1.0)))
    return Solver(model, cfg, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,rtol", [("direct", 1e-8), ("mixed", 1e-5)])
@pytest.mark.parametrize("variant", ["fused", "pipelined"])
def test_variant_solve_on_card_matches_cpu(cuda_device, variant, mode,
                                           rtol):
    """A fused or pipelined solve on the card against the same solve on the
    CPU: flag 0 both steps on both, direct iterations within +-1 (the
    reduction order alone), displacements within the solve's scale."""
    out = {}
    for dev in ("cuda", "cpu"):
        s = _variant_solver(variant, mode, dev)
        out[dev] = ([(r.flag, r.iters) for r in s.solve()],
                    s.displacement_global())
    (steps_g, u_g), (steps_c, u_c) = out["cuda"], out["cpu"]
    assert [f for f, _ in steps_g] == [f for f, _ in steps_c] == [0, 0]
    if mode == "direct":
        assert all(abs(a[1] - b[1]) <= 1 for a, b in zip(steps_g, steps_c))
    np.testing.assert_allclose(u_g, u_c, rtol=0,
                               atol=rtol * np.abs(u_c).max())


@pytest.mark.cuda
@pytest.mark.parametrize("precond", ["jacobi", "mg"])
def test_pipelined_solves_repeat_bitwise_on_card(cuda_device, precond):
    """Two pipelined mixed solves give the same bits: the reduction's early
    read into pinned memory changes no value (mg on an even cube, whose
    V-cycle is one fixed operator)."""
    runs = []
    for _ in range(2):
        if precond == "mg":
            model = make_cube_model(12, 8, 8, E=30e9, heterogeneous=True,
                                    seed=4, load="dirichlet",
                                    load_value=1e-3)
            s = Solver(model, RunConfig(solver=SolverConfig(
                tol=1e-9, precision_mode="mixed", max_iter=500,
                precond="mg", pcg_variant="pipelined")), device=cuda_device)
        else:
            s = _variant_solver("pipelined", "mixed", cuda_device)
        r = s.step(1.0)
        runs.append(((r.flag, r.iters, r.relres), s.un.clone()))
    assert runs[0][0] == runs[1][0] and runs[0][0][0] == 0
    assert torch.equal(runs[0][1], runs[1][1])


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["fused", "pipelined"])
def test_variant_solve_launches_the_float32_kernel(cuda_device, variant):
    """Each inner iteration of a mixed solve under a variant launches v6's
    float32 kernel at least once (pipelined also on its priming trips)."""
    s = _variant_solver(variant, "mixed", cuda_device)
    torch.cuda.synchronize()
    smv.reset_launch_counts()
    r = s.step(1.0)
    assert r.flag == 0
    assert smv.LAUNCHES[("v6", "float32")] >= r.iters
    assert smv.LAUNCHES[("v6", "float64")] >= 2


def _many_solver(variant, mode, device, n_parts=2):
    """The 12x8x6 traction cube for blocked solves (two parts: the halo
    runs within each column), under jacobi, and under mg for pipelined
    mixed: its f32 cycles under jacobi end on breakdowns at round-off-set
    iterations, so its totals part between the card and the CPU."""
    model = make_cube_model(12, 8, 6, E=30e9, heterogeneous=True, seed=4,
                            load="traction", load_value=1e6)
    precond = "mg" if (variant, mode) == ("pipelined", "mixed") \
        else "jacobi"
    cfg = RunConfig(solver=SolverConfig(tol=1e-9, precision_mode=mode,
                                        max_iter=1000, precond=precond,
                                        pcg_variant=variant))
    return model, Solver(model, cfg, n_parts=n_parts, device=device)


def _many_block(model):
    """[F, 2F, a random load on the effective dofs]."""
    F = np.asarray(model.F)
    hard = np.zeros(model.n_dof)
    eff = np.asarray(model.dof_eff)
    hard[eff] = np.random.default_rng(3).standard_normal(eff.size) \
        * np.abs(F).max()
    return np.stack([F, 2 * F, hard], axis=-1)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,rtol", [("direct", 1e-8), ("mixed", 1e-5)])
@pytest.mark.parametrize("variant", ["classic", "fused", "pipelined"])
def test_blocked_solve_on_card_matches_cpu(cuda_device, variant, mode, rtol):
    """solve_many of a three-column block on the card against the same
    block on the CPU: flag 0 on every column on both, direct iterations
    within +-1 (the reduction order alone), the columns within the solve's
    scale; the 2F column takes F's iterations with x = 2 x(F) bit for bit
    on the card."""
    out = {}
    for dev in ("cuda", "cpu"):
        model, s = _many_solver(variant, mode, dev)
        r = s.solve_many(_many_block(model))
        out[dev] = (r, s.displacement_global_many(r.x))
    (rg, ug), (rc, uc) = out["cuda"], out["cpu"]
    assert list(rg.flags) == list(rc.flags) == [0, 0, 0]
    if mode == "direct":
        assert np.abs(rg.iters - rc.iters).max() <= 1
    np.testing.assert_allclose(ug, uc, rtol=0, atol=rtol * np.abs(uc).max())
    assert rg.iters[1] == rg.iters[0]
    assert torch.equal(rg.x[..., 1], 2 * rg.x[..., 0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_blocked_matvec_columns_equal_single_launches(cuda_device, dtype):
    """A blocked matvec is ONE launch of v6 over the R * P slabs (cell
    scales repeated per column), and each column of it is, bit for bit,
    the single launch on that column."""
    from pcg_mpi_solver_tpu_torch.parallel.structured import (
        StructuredOps, block_data, device_data_structured,
        partition_structured)

    sp = partition_structured(make_cube_model(12, 6, 5, heterogeneous=True,
                                              seed=4), 2)
    ops = StructuredOps.from_partition(sp)
    data = device_data_structured(sp, dtype, cuda_device)
    x = torch.randn((4,) + tuple(sp.eff.shape), dtype=dtype,
                    device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(1))
    blk = block_data(data, 4)
    name = str(dtype).removeprefix("torch.")
    before = smv.LAUNCHES[("v6", name)]
    y = ops.matvec_local(blk, x)
    torch.cuda.synchronize()
    assert smv.LAUNCHES[("v6", name)] == before + 1
    for j in range(4):
        assert torch.equal(y[j], ops.matvec_local(data, x[j]))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["direct", "mixed"])
def test_blocked_solves_repeat_bitwise_on_card(cuda_device, mode):
    runs = []
    for _ in range(2):
        model, s = _many_solver("classic", mode, cuda_device)
        r = s.solve_many(_many_block(model))
        runs.append((list(r.flags), list(r.iters), list(r.relres),
                     r.x.clone()))
    assert runs[0][:3] == runs[1][:3] and runs[0][0] == [0, 0, 0]
    assert torch.equal(runs[0][3], runs[1][3])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["direct", "mixed"])
@pytest.mark.parametrize("variant", ["classic", "fused", "pipelined"])
def test_blocked_solve_launches_one_kernel_a_trip(cuda_device, variant,
                                                  mode):
    """Each lockstep trip (iterations, deferred checks and priming trips
    of all columns at once) is one launch of the storage dtype's kernel,
    and under mg also the V-cycle's 2 * mg_smooth_degree fine ones, each
    over the whole block: v6 float64 for a direct solve, v6 float32 for
    the inner cycles of a mixed one, whose float64 refreshes are one
    blocked launch a cycle."""
    model, s = _many_solver(variant, mode, cuda_device)
    torch.cuda.synchronize()
    smv.reset_launch_counts()
    r = s.solve_many(_many_block(model))
    assert list(r.flags) == [0, 0, 0] and r.trips >= r.iters.max()
    f32, f64 = smv.LAUNCHES[("v6", "float32")], smv.LAUNCHES[("v6",
                                                              "float64")]
    a_trip = 1 + (2 * s.ops.mg_degree
                  if s.config.solver.precond == "mg" else 0)
    if mode == "direct":
        assert (f32, f64) == (0, a_trip * r.trips)
    else:
        assert f32 == a_trip * r.trips and 1 <= f64 <= 13


# -- the general (pattern-type) backend --------------------------------------

def _general_case(name):
    """A small model of the general backend and its partition at 1 part:
    an octree (reflected pattern types, several buckets) or the glued
    blocks (cohesive springs)."""
    from pcg_mpi_solver_tpu_torch.models.octree import make_octree_model
    from pcg_mpi_solver_tpu_torch.models.synthetic import (
        make_glued_blocks_model)
    from pcg_mpi_solver_tpu_torch.parallel.partition import partition_model

    if name == "octree":
        m = make_octree_model(2, 2, 2, max_level=3, n_incl=2, seed=3,
                              E=30e9, load_value=1e6)
    else:
        m = make_glued_blocks_model(2, 3, 2, 2, E=3.0, penalty=50.0)
    return m, partition_model(m, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["octree", "glued"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.float64, 1e-12)])
def test_general_matvec_on_card_matches_cpu(cuda_device, name, dtype, tol):
    """matvec, diag and the node blocks on the card against the CPU's
    float64, tol * max|y|; two card matvecs bitwise equal (no float
    atomics: the ELL, interface and spring sums are fixed-order
    gathers)."""
    from pcg_mpi_solver_tpu_torch.ops.matvec import Ops, device_data

    _m, pm = _general_case(name)
    ops = Ops.from_model(pm)
    cpu = device_data(pm, torch.float64, "cpu")
    card = device_data(pm, dtype, cuda_device)
    x = np.where(pm.dof_gid >= 0,
                 np.random.default_rng(4).standard_normal(pm.dof_gid.shape),
                 0.0)
    y_cpu = ops.matvec(cpu, torch.as_tensor(x))
    xc = torch.as_tensor(x, dtype=dtype, device=cuda_device)
    y1, y2 = ops.matvec(card, xc), ops.matvec(card, xc)
    assert torch.equal(y1, y2)
    scale = y_cpu.abs().max()
    assert (y1.cpu().double() - y_cpu).abs().max() <= tol * scale
    d = ops.diag(card).cpu().double()
    d_cpu = ops.diag(cpu)
    assert (d - d_cpu).abs().max() <= tol * d_cpu.abs().max()
    b = ops.node_block_diag(card).cpu().double()
    b_cpu = ops.node_block_diag(cpu)
    assert (b - b_cpu).abs().max() <= tol * b_cpu.abs().max()
    # one bucket a sign sub-type: the stacked layout at many buckets
    ops0 = Ops.from_model(pm, bucket_values=0)
    y0 = ops0.matvec(device_data(pm, dtype, cuda_device, bucket_values=0),
                     xc)
    assert (y0.cpu().double() - y_cpu).abs().max() <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("mode,rtol", [("direct", 1e-8), ("mixed", 1e-5)])
def test_general_octree_solve_on_card_matches_cpu(cuda_device, mode, rtol):
    """A small octree through Solver(backend="general") on the card and
    on the CPU: flag 0, iterations within 1 (direct: the reductions sum in
    another order) or max(3, 5 %) (mixed), displacements within rtol; no
    structured kernel launches."""
    m, _pm = _general_case("octree")
    cfg = RunConfig(solver=SolverConfig(tol=1e-8, max_iter=800,
                                        precision_mode=mode))
    smv.reset_launch_counts()
    card = Solver(m, cfg, backend="general")
    rc = card.step(1.0)
    assert card.backend == "general"
    assert not any(smv.LAUNCHES.values()), dict(smv.LAUNCHES)
    cpu = Solver(m, cfg, device="cpu", backend="general")
    rp = cpu.step(1.0)
    assert rc.flag == rp.flag == 0 and rc.relres <= 1e-8
    tol_it = 1 if mode == "direct" else max(3, 0.05 * rp.iters)
    assert abs(rc.iters - rp.iters) <= tol_it
    uc, up = card.displacement_global(), cpu.displacement_global()
    assert np.abs(uc - up).max() <= rtol * np.abs(up).max()


# ----------------------------------------------------------------------
# The chunked path and the resilience subsystem on the card
# ----------------------------------------------------------------------

def _chunked_solver(device, cap, mode, tmp_path=None, run_id="1",
                    deltas=(0.0, 1.0), fault=None, **extra):
    from pcg_mpi_solver_tpu_torch.resilience import FaultPlan

    kw = dict(tol=1e-8, max_iter=4000, iters_per_dispatch=cap)
    if mode == "mixed":
        kw.update(precision_mode="mixed", inner_tol=0.1, tol=1e-9)
    cfg = RunConfig(solver=SolverConfig(**kw),
                    time_history=TimeHistoryConfig(
                        time_step_delta=list(deltas)), **extra)
    if tmp_path is not None:
        cfg.scratch_path, cfg.run_id = str(tmp_path), run_id
    s = Solver(make_cube_model(12, 6, 5, heterogeneous=True, seed=4), cfg,
               device=device)
    if fault is not None:
        s.fault_plan = FaultPlan(fault)
    return s


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["direct", "mixed"])
def test_chunked_is_bitwise_one_shot_on_card(cuda_device, mode):
    """Direct f64: capped dispatches are the one-shot solve bit for bit.
    Mixed: the chunked refinement loop at cap 12 is bit for bit the same
    loop at a cap no inner cycle reaches (one dispatch a cycle)."""
    ref_cap = 0 if mode == "direct" else 4000
    out = []
    for cap in (12, ref_cap):
        s = _chunked_solver(cuda_device, cap, mode)
        r = s.step(1.0)
        out.append((r.flag, r.iters, r.relres, s.displacement_global()))
    assert out[0][0] == 0 and out[0][:3] == out[1][:3]
    np.testing.assert_array_equal(out[0][3], out[1][3])


@pytest.mark.cuda
def test_nan_carry_recovers_on_card(cuda_device):
    from pcg_mpi_solver_tpu_torch.obs.metrics import MetricsRecorder

    class Capture:
        events = []

        def emit(self, ev):
            self.events.append(ev)

    cap = Capture()
    s = _chunked_solver(cuda_device, 12, "direct", fault="nan@1")
    s.recorder.sinks.append(cap)
    r = s.step(1.0)
    assert r.flag == 0 and r.relres <= 1e-8
    assert [(e["action"], e["trigger"]) for e in cap.events
            if e["kind"] == "recovery"] == [("restart_minres", "nan_carry")]
    assert isinstance(s.recorder, MetricsRecorder)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["direct", "mixed"])
def test_kill_and_resume_bitwise_on_card(cuda_device, tmp_path, mode):
    from pcg_mpi_solver_tpu_torch.resilience import (
        FaultPlan, SimulatedKill)

    kw = dict(checkpoint_every=1, snapshot_every=1)
    deltas = (0.0, 0.5, 1.0)
    sa = _chunked_solver(cuda_device, 12, mode, tmp_path, "a", deltas, **kw)
    sa.fault_plan = FaultPlan("")
    seen = {}
    sa.solve(on_step=lambda t, r: seen.setdefault(t,
                                                  sa.fault_plan.boundaries))
    sk = _chunked_solver(cuda_device, 12, mode, tmp_path, "b", deltas,
                         fault=f"kill@{seen[1] + 1}", **kw)
    with pytest.raises(SimulatedKill):
        sk.solve()
    sr = _chunked_solver(cuda_device, 12, mode, tmp_path, "b", deltas, **kw)
    sr.solve(resume=True)
    assert sr.flags == sa.flags and sr.iters == sa.iters
    assert sr.relres == sa.relres
    np.testing.assert_array_equal(sr.displacement_global(),
                                  sa.displacement_global())


# ----------------------------------------------------------------------
# The hybrid level-grid backend on the card
# ----------------------------------------------------------------------

# level batches as the hybrid backend gives them: thousands of 8^3-cell
# blocks in one launch, and the 6^3 octree's 1x1x1, 12^3 and 22x24x24
# dense levels
HYBRID_LEVEL_SHAPES = [(3000, 8, 8, 8), (1, 1, 1, 1), (2, 12, 12, 12),
                       (1, 22, 24, 24)]
HYBRID_KERNELS = [(v, "float32") for v in
                  ("v6", "v1", "v2", "v3", "v4", "v5", "v7", "v8", "v9")] \
    + [("v6", "float64")]


@pytest.mark.cuda
@pytest.mark.parametrize("variant,name", HYBRID_KERNELS,
                         ids=[f"{v}-{d}" for v, d in HYBRID_KERNELS])
def test_kernels_on_hybrid_level_batches(cuda_device, variant, name):
    """Each kernel on level batches with holes (ck = 0 on 70 % of the
    cells, as a level's block holds few bricks): within the kernel
    tolerance of the plain version, two launches bitwise equal, one
    launch a batch."""
    dtype = getattr(torch, name)
    tol = 2e-5 if dtype == torch.float32 else 1e-12
    rng = np.random.default_rng(21)
    Ke = torch.as_tensor(unit_element_library(0.2)["Ke"], dtype=dtype,
                         device=cuda_device)
    for P, nx, ny, nz in HYBRID_LEVEL_SHAPES:
        x = torch.as_tensor(rng.normal(size=(P, 3, nx + 1, ny + 1, nz + 1)),
                            dtype=dtype, device=cuda_device)
        ck = rng.uniform(1, 10, (P, nx, ny, nz))
        ck[rng.uniform(size=ck.shape) < 0.7] = 0.0
        ck = torch.as_tensor(ck, dtype=dtype, device=cuda_device)
        before = smv.LAUNCHES[(variant, name)]
        y = smv.structured_matvec(x, ck, Ke, variant=variant)
        y2 = smv.structured_matvec(x, ck, Ke, variant=variant)
        torch.cuda.synchronize()
        assert smv.LAUNCHES[(variant, name)] == before + 2
        assert torch.equal(y, y2)
        y_plain = smv.structured_matvec_plain(x, ck, Ke)
        assert (y - y_plain).abs().max() <= tol * y_plain.abs().max(), \
            (P, nx, ny, nz)


def _hybrid_octree(n=3, max_level=3):
    from pcg_mpi_solver_tpu_torch.models import make_octree_model

    return make_octree_model(n, n, n, max_level=max_level, n_incl=2, seed=3,
                             E=30e9, load_value=1e6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.float64, 1e-12)])
def test_hybrid_matvec_on_card_matches_cpu(cuda_device, dtype, tol):
    """Two parts: matvec, diag and node blocks on the card against the
    CPU's float64 (tol * max|y|); two card matvecs bitwise equal; one
    kernel launch a level; a structured matvec with another Ke between two
    hybrid matvecs leaves them equal (each Ke is staged on its own
    turn)."""
    from pcg_mpi_solver_tpu_torch.parallel.hybrid import (
        HybridOps, device_data_hybrid, partition_hybrid)

    hp = partition_hybrid(_hybrid_octree(), 2)
    ops = HybridOps.from_hybrid(hp)
    cpu = device_data_hybrid(hp, torch.float64, "cpu")
    card = device_data_hybrid(hp, dtype, cuda_device)
    x = np.where(hp.dof_gid >= 0, np.random.default_rng(5).standard_normal(
        hp.dof_gid.shape), 0.0)
    y_cpu = ops.matvec(cpu, torch.as_tensor(x))
    xc = torch.as_tensor(x, dtype=dtype, device=cuda_device)
    name = str(dtype).removeprefix("torch.")
    before = smv.LAUNCHES[("v6", name)]
    y1 = ops.matvec(card, xc)
    assert smv.LAUNCHES[("v6", name)] == before + len(hp.levels)
    other = torch.as_tensor(unit_element_library(0.3)["Ke"], dtype=dtype,
                            device=cuda_device)
    g = torch.ones((1, 3, 3, 3, 3), dtype=dtype, device=cuda_device)
    smv.structured_matvec(g, torch.ones((1, 2, 2, 2), dtype=dtype,
                                        device=cuda_device), other)
    y2 = ops.matvec(card, xc)
    assert torch.equal(y1, y2)
    assert (y1.cpu().double() - y_cpu).abs().max() <= tol * y_cpu.abs().max()
    for fn in (ops.diag, ops.node_block_diag):
        a, b = fn(card).cpu().double(), fn(cpu)
        assert (a - b).abs().max() <= tol * b.abs().max()


@pytest.mark.cuda
def test_bucketed_refresh_repeats_bitwise_on_card(cuda_device):
    """The bucketed float64 refresh: two card matvecs bitwise equal (its
    node sums are fixed-order gathers), within 1e-12 of the CPU's."""
    from pcg_mpi_solver_tpu_torch.ops.matvec import (
        Ops, bucketed_matvec, build_bucketed_blocks)
    from pcg_mpi_solver_tpu_torch.parallel.partition import partition_model

    pm = partition_model(_hybrid_octree(), 2)
    ops = Ops(n_loc=pm.n_loc, n_iface=pm.n_iface, n_node_loc=pm.n_node_loc,
              n_node_iface=pm.n_node_iface, n_parts=pm.n_parts)
    x = np.where(pm.dof_gid >= 0, np.random.default_rng(6).standard_normal(
        pm.dof_gid.shape), 0.0)
    y_cpu = bucketed_matvec(ops, build_bucketed_blocks(
        pm, torch.float64, "cpu"), torch.as_tensor(x))
    card = build_bucketed_blocks(pm, torch.float64, cuda_device)
    xc = torch.as_tensor(x, device=cuda_device)
    y1, y2 = bucketed_matvec(ops, card, xc), bucketed_matvec(ops, card, xc)
    assert torch.equal(y1, y2)
    assert (y1.cpu() - y_cpu).abs().max() <= 1e-12 * y_cpu.abs().max()


@pytest.mark.cuda
def test_hybrid_octree6_solve_on_card_matches_cpu(cuda_device):
    """The 6^3 cut of the octree flagship (its 1x1x1, 12^3 and 22x24x24
    levels beside tiled 8^3 ones) through Solver(backend="hybrid"), mixed,
    tol 1e-7, on the card and on the CPU: flag 0, iterations within
    max(3, 5 %), displacements within 1e-5 of max|u|; the float32 v6
    kernel launched at least levels x iterations times."""
    from pcg_mpi_solver_tpu_torch.models import make_octree_model

    m = make_octree_model(6, 6, 6, max_level=4, n_incl=6, seed=2, E=30e9,
                          nu=0.2, load="traction", load_value=1e6)
    cfg = RunConfig(solver=SolverConfig(tol=1e-7, precision_mode="mixed"))
    smv.reset_launch_counts()
    card = Solver(m, cfg, backend="hybrid")
    rc = card.step(1.0)
    assert smv.LAUNCHES[("v6", "float32")] >= \
        len(card.ops.level_dims) * rc.iters
    cpu = Solver(m, cfg, device="cpu", backend="hybrid")
    rp = cpu.step(1.0)
    assert rc.flag == rp.flag == 0 and rc.relres <= 1e-7
    assert abs(rc.iters - rp.iters) <= max(3, 0.05 * rp.iters)
    uc, up = card.displacement_global(), cpu.displacement_global()
    assert np.abs(uc - up).max() <= 1e-5 * np.abs(up).max()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["direct", "mixed"])
def test_hybrid_block_columns_equal_width1_solves(cuda_device, mode):
    """A width-2 hybrid block (one launch a level over R * P * nb blocks):
    each column's flag, iterations and x bit for bit its width-1 solve's
    on the card."""
    m = _hybrid_octree()
    kw = dict(tol=1e-8, max_iter=2000)
    kw.update(dict(precision_mode="mixed") if mode == "mixed"
              else dict(dtype="float64"))
    s = Solver(m, RunConfig(solver=SolverConfig(**kw)), n_parts=2,
               backend="hybrid")
    F = np.asarray(m.F)
    Fr = np.random.default_rng(8).standard_normal(F.shape) * (F != 0)
    blk = s.solve_many(np.stack([F, Fr], -1))
    ub = s.displacement_global_many(blk.x)
    for j, col in enumerate((F, Fr)):
        one = s.solve_many(col[:, None])
        assert (int(one.flags[0]), int(one.iters[0])) == \
            (int(blk.flags[j]), int(blk.iters[j])) and blk.flags[j] == 0
        np.testing.assert_array_equal(
            s.displacement_global_many(one.x)[:, 0], ub[:, j])


# the export path: (backend, model) of each card-against-CPU field check
EXPORT_CASES = ("structured", "general", "hybrid")


def _export_solver(backend, device):
    if backend == "structured":
        m = make_cube_model(12, 6, 5, E=30e9, heterogeneous=True, seed=4,
                            load_value=1e6)
    else:
        m = _hybrid_octree()
    cfg = RunConfig(solver=SolverConfig(tol=1e-10, dtype="float64",
                                        max_iter=3000),
                    time_history=TimeHistoryConfig(export_vars="D ES PS PE"))
    return Solver(m, cfg, n_parts=2, device=device, backend=backend)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", EXPORT_CASES)
def test_nodal_fields_on_card_match_cpu(cuda_device, backend):
    """The nodal export fields of one float64 solution on the card
    against the CPU path's from the same solution (within 1e-12 of
    max|field|: sums in another order), two card exports bitwise equal."""
    card = _export_solver(backend, None)
    assert card.step(1.0).flag == 0
    cpu = _export_solver(backend, "cpu")
    cpu.un = card.un.cpu()
    a, b = card._nodal_fields(), card._nodal_fields()
    c = cpu._nodal_fields()
    assert sorted(a) == sorted(c) == ["D", "ES", "PE1", "PE2", "PE3", "PS1",
                                      "PS2", "PS3"]
    for k in a:
        assert a[k].is_cuda and a[k].dtype == torch.float64
        assert torch.equal(a[k], b[k])
        ref = c[k].numpy()
        got = a[k].cpu().numpy()
        assert np.abs(got - ref).max() <= 1e-12 * max(np.abs(ref).max(),
                                                      1e-300)


@pytest.mark.cuda
@pytest.mark.parametrize("window,opts,flag", [
    ("plateau", dict(mixed_plateau_window=25), 3),
    ("progress", dict(mixed_progress_window=10), 0)])
def test_windowed_mixed_solve_on_card_matches_cpu(cuda_device, window, opts,
                                                  flag):
    """The mixed shell with each window set so that it fires (the CPU
    tests' model and settings): the card's flag is the CPU's (the JAX
    package's), iterations within max(3, 5 %)."""
    m = make_cube_model(16, 6, 6, E=30e9, heterogeneous=True, seed=5,
                        load_value=1e6)
    cfg = RunConfig(solver=SolverConfig(tol=1e-8, max_iter=2000,
                                        precision_mode="mixed",
                                        inner_tol=1e-6, **opts))
    rc = Solver(m, cfg).step(1.0)
    rp = Solver(m, cfg, device="cpu").step(1.0)
    assert rc.flag == rp.flag == flag
    assert abs(rc.iters - rp.iters) <= max(3, 0.05 * rp.iters)


TIME_DELTAS = [0.5, 1.0, 1.0, 0.7, 0.3]
# the card-vs-CPU window of mixed Newmark totals on the 12x6x5 cube: the
# largest drift between the card and the CPU on the shipped paths at 1-4
# parts (6.6 %; test_newmark_on_card_matches_cpu), with room to spare
MIXED_NEWMARK_WINDOW = 0.08


@pytest.mark.cuda
@pytest.mark.parametrize("case", [dict(precond="block3"),
                                  dict(precision_mode="mixed")])
def test_newmark_on_card_matches_cpu(cuda_device, case):
    """Newmark on a 12x6x5 cube (dt 0.2, damping 0.1, tol 1e-12,
    one-shot and at cap 7): the card's u within 1e-10 of max|u| of the
    CPU's; direct, iterations within +-1 a step; mixed, the total within
    max(3, MIXED_NEWMARK_WINDOW) of the CPU's.

    The mixed window holds the drift that f32 round-off gives between
    the card and the CPU (``tools/newmark_drift.py``, PERF.md §6): this
    cube's f32 cycles end on stagnation exits, and the total follows the
    f32 operator's rounding.  On the shipped paths the card takes
    1662-1726 iterations at 1-4 parts against the CPU's 1751-1822, at
    most 6.6 % fewer (1 part; at 2 parts 1663 against 1777, 6.4 %, and
    1726 against 1753 at cap 7); the window is that drift with room to
    spare.  That the drift is round-off has a witness: with the f32
    matvec rounded exactly from float64 the card and the CPU land in
    one band (1483-1568)."""
    from pcg_mpi_solver_tpu_torch.solver import NewmarkSolver

    model = make_cube_model(12, 6, 5, E=30e9, nu=0.2, heterogeneous=True,
                            seed=5, load_value=1e6)
    for ipd in (0, 7):
        cfg = RunConfig(solver=SolverConfig(tol=1e-12, max_iter=2000,
                                            iters_per_dispatch=ipd, **case))
        out = {}
        for dev in ("cpu", cuda_device):
            s = NewmarkSolver(model, cfg, n_parts=2, dt=0.2, damping=0.1,
                              device=dev)
            res = s.run(TIME_DELTAS)
            assert all(r.flag == 0 for r in res)
            out[str(dev)] = ([r.iters for r in res], s.displacement_global())
        (it_c, u_c), (it_g, u_g) = out["cpu"], out["cuda"]
        if "precision_mode" not in case:
            assert all(abs(a - b) <= 1 for a, b in zip(it_g, it_c))
        else:
            tc, tg = sum(it_c), sum(it_g)
            assert abs(tg - tc) <= max(3, MIXED_NEWMARK_WINDOW * tc), (
                ipd, it_c, it_g)
        assert np.abs(u_g - u_c).max() <= 1e-10 * np.abs(u_c).max()


@pytest.mark.cuda
@pytest.mark.parametrize("backend,dtype", [("general", "float64"),
                                           ("hybrid", "float64"),
                                           ("hybrid", "float32")])
def test_dynamics_on_card_matches_cpu(cuda_device, backend, dtype):
    """Explicit dynamics on a 3^3/L3 octree, 60 steps at half the CFL dt
    in chunks of 20: the card against the CPU within 1e-10 (float64) or
    1e-5 (float32) of max|u|; on the hybrid backend exactly one kernel
    launch a level a step."""
    from pcg_mpi_solver_tpu_torch.solver import DynamicsSolver, stable_dt

    model = _hybrid_octree()
    name = dtype
    out = {}
    for dev in ("cpu", cuda_device):
        s = DynamicsSolver(model, RunConfig(solver=SolverConfig(dtype=dtype)),
                           n_parts=2, dt=0.5 * stable_dt(model),
                           damping=0.1, probe_dofs=(30,), device=dev,
                           backend=backend)
        variant = s.kernel_variant if dtype == "float32" else "v6"
        before = smv.LAUNCHES[(variant, name)]
        res = s.run(60, export_every=20)
        torch.cuda.synchronize()
        if dev != "cpu":
            n_levels = len(s.pm.levels) if backend == "hybrid" else 0
            assert smv.LAUNCHES[(variant, name)] - before == 60 * n_levels
            assert s.chunks == 3
        out[str(dev)] = res
    tol = 1e-10 if dtype == "float64" else 1e-5
    scale = np.abs(out["cpu"].u).max()
    assert np.abs(out["cuda"].u - out["cpu"].u).max() <= tol * scale
    assert np.abs(out["cuda"].probe_u - out["cpu"].probe_u).max() \
        <= tol * scale


@pytest.mark.cuda
def test_graph_partition_solve_on_card_matches_cpu(cuda_device,
                                                   monkeypatch):
    """A 3^3/L3 octree at 8 parts under partition_method="graph" (the
    native library built on the card's host), general backend, float64:
    the card's flag equals the CPU's, iterations within +-1, u within
    1e-10 of max|u|; the two element maps are the same array."""
    monkeypatch.delenv("PCG_TPU_NO_NATIVE", raising=False)
    model = _hybrid_octree()
    cfg = RunConfig(partition_method="graph",
                    solver=SolverConfig(tol=1e-9, max_iter=3000,
                                        dtype="float64"))
    out = {}
    for dev in ("cpu", cuda_device):
        s = Solver(model, cfg, n_parts=8, device=dev)
        assert s.backend == "general"
        out[str(dev)] = (s.step(1.0), s.displacement_global(),
                         np.asarray(s.pm.elem_part))
    (rc, uc, pc), (rg, ug, pg) = out["cpu"], out["cuda"]
    np.testing.assert_array_equal(pg, pc)
    assert len(np.unique(pg)) == 8
    assert rg.flag == rc.flag == 0
    assert abs(rg.iters - rc.iters) <= 1
    assert np.abs(ug - uc).max() <= 1e-10 * np.abs(uc).max()


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["general", "hybrid"])
def test_warm_cache_solver_on_card_equals_cold(cuda_device, tmp_path,
                                               backend):
    """A Solver built warm from the partition cache on the card: "cold"
    then "warm", the partition equal array for array, the mixed solve's
    flag, iterations and u bitwise the cold one's."""
    import dataclasses

    model = _hybrid_octree()
    cfg = RunConfig(cache_dir=str(tmp_path),
                    solver=SolverConfig(tol=1e-8, max_iter=3000,
                                        precision_mode="mixed"))
    runs = []
    for _ in range(2):
        s = Solver(model, cfg, n_parts=2, backend=backend)
        r = s.step(1.0)
        runs.append((s.setup_cache, s.pm, r.flag, r.iters,
                     s.displacement_global()))
    (c0, pm0, f0, i0, u0), (c1, pm1, f1, i1, u1) = runs
    assert (c0, c1) == ("cold", "warm")
    for f in dataclasses.fields(pm0):
        a, b = getattr(pm0, f.name), getattr(pm1, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
    assert (f0, i0) == (f1, i1) and f0 == 0
    np.testing.assert_array_equal(u0, u1)


def _sync_count(run):
    """``run()`` under torch's CUDA sync debug mode: (its result, the
    synchronising calls it made)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # one warning a synchronising call (the mode's own notice, once a
    # process, is not one)
    return out, sum(str(w.message).startswith("called a synchronizing CUDA")
                    for w in caught)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,cap", [("direct", 0), ("mixed", 0),
                                      ("mixed", 40)])
def test_traced_solve_on_card_is_untraced_solve(cuda_device, mode, cap):
    """The convergence ring on the card: flag, iterations and u bitwise
    the untraced solve's, the same number of synchronising calls (a
    record is a host row write), every iteration recorded."""
    model = make_cube_model(12, 6, 5, heterogeneous=True)
    out = {}
    for ring in (0, 4000):
        s = Solver(model, RunConfig(solver=SolverConfig(
            tol=1e-8, precision_mode=mode, iters_per_dispatch=cap,
            trace_resid=ring)), device=cuda_device)
        s.step(1.0)                     # the kernels' first launches
        s.reset_state()
        r, n = _sync_count(lambda: s.step(1.0))
        out[ring] = (r, s.un.clone(), n, s.last_trace)
    (ra, ua, na, _ta), (rb, ub, nb, tb) = out[0], out[4000]
    assert (ra.flag, ra.iters) == (rb.flag, rb.iters) and ra.flag == 0
    assert torch.equal(ua, ub) and na == nb > 0
    assert tb.n_recorded == rb.iters and not tb.truncated


@pytest.mark.cuda
def test_profile_capture_on_card_puts_v6_in_matvec(cuda_device, tmp_path):
    """A torch.profiler capture of a solve on the card read back by
    ``obs/profview.py``: every float32 v6 launch in the matvec phase,
    every phase with device time, the verdict clean."""
    from pcg_mpi_solver_tpu_torch.obs import profview

    s = Solver(make_cube_model(12, 6, 5, heterogeneous=True),
               RunConfig(solver=SolverConfig(tol=1e-8,
                                             precision_mode="mixed")),
               device=cuda_device)
    cap = profview.capture_solve_profile(s, str(tmp_path))
    rep = profview.profile_report(cap["artifact"])
    evs, _ = profview.read_trace_events(
        profview.find_trace_files(cap["artifact"])[0])
    # v6's float launches: the f32 inner iterations' (the float64
    # refreshes of the mixed shell run outside pcg's phases, as in JAX)
    v6 = [op for op in profview.device_ops(evs)
          if "structured_matvec_kernel" in op["name"]
          and "FfmaProduct" in op["name"]]
    assert v6 and all(op["label"] == "pcg/matvec" for op in v6)
    assert rep["verdict"] == "ok"
    for ph in ("matvec", "precond", "reduction", "axpy"):
        assert rep["phases"][ph]["events"] > 0, ph


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["direct", "mixed"])
def test_served_block_on_card_matches_width1_solves(cuda_device, tmp_path,
                                                    mode):
    """The solve service on the card: two jobs (scales 1 and 2) served as
    ONE width-2 block through ``Solver.solve_many`` (one v6 launch a
    lockstep trip), each job's solution within 1e-12 of max|u| of its
    width-1 ``solve_many``, with equal iterations."""
    from pcg_mpi_solver_tpu_torch.resilience import FaultPlan
    from pcg_mpi_solver_tpu_torch.serve import jobs as sjobs
    from pcg_mpi_solver_tpu_torch.serve.daemon import ServeDaemon

    model = make_cube_model(12, 6, 5, heterogeneous=True)
    s = Solver(model, RunConfig(solver=SolverConfig(
        tol=1e-8, precision_mode=mode)), device=cuda_device)
    spool = str(tmp_path / "spool")
    for t, (job, sc) in enumerate((("a", 1.0), ("b", 2.0))):
        sjobs.submit(spool, {"job": job, "scale": sc}, submit_t=float(t))
    d = ServeDaemon(s, spool, widths=(1, 2), fault_plan=FaultPlan(""))
    d.poll_once()
    name = "float32" if mode == "mixed" else "float64"
    before = smv.LAUNCHES[("v6", name)]
    assert d.serve_block() == 2
    torch.cuda.synchronize()
    launched = smv.LAUNCHES[("v6", name)] - before
    assert d.run(idle_exit_s=0.0, install_signals=False) == "idle"
    F = np.asarray(model.F)
    for job, sc in (("a", 1.0), ("b", 2.0)):
        res = sjobs.read_result(spool, job)
        assert res["ok"] and res["width"] == 2
        ref = s.solve_many(F * sc)
        u_ref = s.displacement_global_many(ref.x)[:, 0]
        u = np.load(sjobs.solution_path(spool, job))
        assert res["iters"] == int(ref.iters[0])
        assert np.abs(u - u_ref).max() <= 1e-12 * np.abs(u_ref).max()
    assert launched >= res["iters"]


_CHILD_CARD = r"""
import numpy as np
from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig
from pcg_mpi_solver_tpu_torch.models import make_cube_model
from pcg_mpi_solver_tpu_torch.parallel.distributed import fetch_global
from pcg_mpi_solver_tpu_torch.solver import Solver

OUT, MODE = sys.argv[4], sys.argv[5]
model = make_cube_model(16, 6, 6, heterogeneous=True)
if MODE == "matvec":
    s = Solver(model, RunConfig(solver=SolverConfig(
        dtype="float32", precision_mode="direct")), mesh=mesh, n_parts=8,
        backend="structured")
    x = np.random.default_rng(0).standard_normal(
        (8, s.pm.n_loc)).astype(np.float32)
    lo, hi = s._part_range
    xt = torch.as_tensor(x[lo:hi], device=s.device) * s.data["eff"]
    y = fetch_global(s.ops.matvec(s.data, xt), mesh)
    if pid == 0:
        np.save(os.path.join(OUT, "y.npy"), y)
    print(f"RESULT {pid} device={s.device}", flush=True)
else:
    s = Solver(model, RunConfig(solver=SolverConfig(tol=1e-8,
                                                    max_iter=2000)),
               mesh=mesh, n_parts=8, backend="structured")
    r = s.step(1.0)
    u = s.displacement_global()
    print(f"RESULT {pid} flag={r.flag} iters={r.iters} "
          f"cs={float(np.abs(u).sum()):.10e}", flush=True)
"""


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["matvec", "solve"])
def test_two_rank_structured_on_card(cuda_device, tmp_path, mode):
    """Two ranks over gloo on the one card: the float32 slab matvec (v6,
    the halo's planes staged through pinned host buffers) is bitwise the
    one-process matvec; the mixed v6 solve gives the one-process flag,
    its iterations within one (only the cross-rank sum order differs),
    and the same result line on both ranks."""
    from test_torch_distributed import run_ranks

    model = make_cube_model(16, 6, 6, heterogeneous=True)
    results = run_ranks(tmp_path, _CHILD_CARD, 2, [tmp_path, mode])
    assert len(results) == 2
    if mode == "matvec":
        assert all("device=cuda:0" in r for r in results)
        s = Solver(model, RunConfig(solver=SolverConfig(
            dtype="float32", precision_mode="direct")), n_parts=8,
            backend="structured")
        x = np.random.default_rng(0).standard_normal(
            (8, s.pm.n_loc)).astype(np.float32)
        xt = torch.as_tensor(x, device=s.device) * s.data["eff"]
        y = s.ops.matvec(s.data, xt).cpu().numpy()
        np.testing.assert_array_equal(np.load(tmp_path / "y.npy"), y)
        return
    assert results[0].split(" ", 2)[2] == results[1].split(" ", 2)[2]
    s = Solver(model, RunConfig(solver=SolverConfig(tol=1e-8,
                                                    max_iter=2000)),
               n_parts=8, backend="structured")
    ref = s.step(1.0)
    assert "flag=0" in results[0] and ref.flag == 0
    iters = int(results[0].split("iters=")[1].split()[0])
    assert abs(iters - ref.iters) <= 1

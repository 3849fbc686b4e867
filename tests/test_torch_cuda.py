"""Tests of the port that need the card: each CUDA kernel against its plain
PyTorch version, the kernel a solve's launches go to under each
``PCG_TPU_PALLAS_V``, a whole solve on the card against the same solve
on the CPU (classic, fused and pipelined; two pipelined solves bitwise
equal), and the block3 and mg preconditioners' applies on the card
against the CPU (two V-cycles bitwise equal).  They carry the ``cuda`` marker and skip with a reason where
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
    """v5, v3 and v7 (the node-owned gather) stage a ring of 2C + 2 node
    and ck planes of their shortest tile: at these planes (55 is the first
    above 54) that is above the 227 KB a block can have, so the launch is
    refused with the CUDA error named, and nothing is counted."""
    x = torch.zeros((1, 3, 41, 5, 4), dtype=torch.float32,
                    device=cuda_device)
    ck = torch.ones((1, 40, 4, 3), dtype=torch.float32, device=cuda_device)
    Ke = torch.as_tensor(unit_element_library(0.2)["Ke"],
                         dtype=torch.float32, device=cuda_device)
    before = dict(smv.LAUNCHES)
    with pytest.raises(RuntimeError, match="invalid configuration"):
        smv.structured_matvec(x, ck, Ke, variant=variant, planes=planes)
    assert smv.LAUNCHES == before


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

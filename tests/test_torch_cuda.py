"""Tests of the port that need the card: each CUDA kernel against its plain
PyTorch version, the kernel a solve's launches go to under each
``PCG_TPU_PALLAS_V``, and a whole solve on the card against the same solve
on the CPU.  They carry the ``cuda`` marker and skip with a reason where
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
def test_chunk_too_large_for_shared_memory_is_refused(cuda_device):
    """v9 stages two slots of C + 1 float4 node planes of its tile: at 32
    planes that is above the 227 KB a block can have, so the launch is
    refused with the CUDA error named, and nothing is counted."""
    x = torch.zeros((1, 3, 41, 5, 4), dtype=torch.float32,
                    device=cuda_device)
    ck = torch.ones((1, 40, 4, 3), dtype=torch.float32, device=cuda_device)
    Ke = torch.as_tensor(unit_element_library(0.2)["Ke"],
                         dtype=torch.float32, device=cuda_device)
    before = dict(smv.LAUNCHES)
    with pytest.raises(RuntimeError, match="invalid configuration"):
        smv.structured_matvec(x, ck, Ke, variant="v9", planes=32)
    assert smv.LAUNCHES == before


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

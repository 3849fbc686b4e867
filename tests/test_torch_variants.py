"""The port's kernel selector and its variants against the JAX package
(CPU): ``selected_variant`` / ``pallas_planes`` read the same knobs with
the same answers and refusals, and a whole mixed solve under each ported
variant agrees with the JAX Solver running that variant's TPU kernel
through the Pallas interpreter (``SolverConfig(pallas="interpret")``).

Solve tolerances are those of tests/test_torch_solver.py for mixed
precision: the same flag, iteration counts within max(3, 5 %) (the f32
inner dots are summed in another order than XLA's), displacements within
1e-5 relative (both reach tol)."""

import numpy as np
import pytest

from pcg_mpi_solver_tpu import RunConfig as JaxRunConfig
from pcg_mpi_solver_tpu import SolverConfig as JaxSolverConfig
from pcg_mpi_solver_tpu import TimeHistoryConfig as JaxTimeHistoryConfig
from pcg_mpi_solver_tpu.models import make_cube_model as jax_cube
from pcg_mpi_solver_tpu.ops import pallas_matvec as jax_pallas
from pcg_mpi_solver_tpu.parallel.mesh import make_mesh
from pcg_mpi_solver_tpu.solver import Solver as JaxSolver
from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig, TimeHistoryConfig
from pcg_mpi_solver_tpu_torch.models import make_cube_model
from pcg_mpi_solver_tpu_torch.ops import structured_matvec as smv
from pcg_mpi_solver_tpu_torch.solver import Solver

PORTED = list("123456789")


@pytest.mark.parametrize("value", [None] + PORTED)
def test_selected_variant_names_match_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("PCG_TPU_PALLAS_V", raising=False)
    else:
        monkeypatch.setenv("PCG_TPU_PALLAS_V", value)
    assert smv.selected_variant() == jax_pallas.selected_variant()[0]
    assert smv.selected_variant() in smv.VARIANTS


@pytest.mark.parametrize("value", ["0", "10", "v1", "", " 1", "six"])
def test_selected_variant_refuses_what_jax_refuses(monkeypatch, value):
    monkeypatch.setenv("PCG_TPU_PALLAS_V", value)
    with pytest.raises(ValueError, match="PCG_TPU_PALLAS_V"):
        jax_pallas.selected_variant()
    with pytest.raises(ValueError, match="PCG_TPU_PALLAS_V"):
        smv.selected_variant()


@pytest.mark.parametrize("value", PORTED)
def test_every_jax_variant_has_a_kernel(monkeypatch, value):
    """Each variant the JAX selector names has a kernel in the port, and a
    Solver built under it carries it.  The port's launch takes
    pallas_planes() where the JAX wrapper reads it (``_planes_env``), except
    v6: the JAX v6 uses the chunk only to size its VMEM slabs, and the
    port's v6 is one thread per node with no chunk."""
    monkeypatch.setenv("PCG_TPU_PALLAS_V", value)
    name, fn = jax_pallas.selected_variant()
    assert name in smv.VARIANTS
    reads_planes = fn.__qualname__.startswith("_planes_env.")
    assert smv.VARIANTS[name][1] == (reads_planes and name != "v6")
    s = Solver(make_cube_model(4, 3, 3), RunConfig(), device="cpu")
    assert s.kernel_variant == name


@pytest.mark.parametrize("value", [None, "8", "16", "64", "0"])
def test_pallas_planes_matches_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("PCG_TPU_PALLAS_PLANES", raising=False)
    else:
        monkeypatch.setenv("PCG_TPU_PALLAS_PLANES", value)
    assert smv.pallas_planes() == jax_pallas.pallas_planes()


@pytest.mark.parametrize("value", ["4", "12", "7", "eight"])
def test_pallas_planes_refuses_what_jax_refuses(monkeypatch, value):
    monkeypatch.setenv("PCG_TPU_PALLAS_PLANES", value)
    with pytest.raises(ValueError):
        jax_pallas.pallas_planes()
    with pytest.raises(ValueError):
        smv.pallas_planes()


@pytest.mark.parametrize("value,dtype", [("3", "float32"), ("7", "float64"),
                                         ("1", "mixed")])
def test_solver_resolves_variant_once(monkeypatch, value, dtype):
    """The variant and, for a chunked one, the planes are read at
    construction; only the float32 operator carries them."""
    monkeypatch.setenv("PCG_TPU_PALLAS_V", value)
    monkeypatch.setenv("PCG_TPU_PALLAS_PLANES", "16")
    mode = "mixed" if dtype == "mixed" else "direct"
    sc = SolverConfig(precision_mode=mode,
                      dtype="float64" if mode == "mixed" else dtype)
    s = Solver(make_cube_model(4, 3, 3), RunConfig(solver=sc), device="cpu")
    monkeypatch.setenv("PCG_TPU_PALLAS_V", "2")      # too late: no effect
    planes = 16 if smv.VARIANTS[f"v{value}"][1] else None
    assert (s.kernel_variant, s.kernel_planes) == (f"v{value}", planes)
    ops32 = s.ops32 if mode == "mixed" else s.ops
    if mode == "mixed" or dtype == "float32":
        assert (ops32.variant, ops32.planes) == (f"v{value}", planes)
    if mode == "mixed" or dtype == "float64":
        assert (s.ops.variant, s.ops.planes) == ("v6", None)


@pytest.mark.parametrize("value", ["1", "2", "3", "4", "5", "7", "8", "9"])
def test_mixed_solve_under_variant_matches_jax_interpret(monkeypatch, value):
    """A Dirichlet cube solved in mixed precision under the same
    PCG_TPU_PALLAS_V: the JAX Solver through that variant's Pallas kernel
    (interpreted), the port's Solver on the CPU (its plain version)."""
    monkeypatch.setenv("PCG_TPU_PALLAS_V", value)
    dims = (8, 5, 4)
    kw = dict(E=30e9, nu=0.2, heterogeneous=True, seed=6, load="dirichlet",
              load_value=1e-3)
    sc = dict(tol=1e-8, max_iter=400, precision_mode="mixed")
    js = JaxSolver(jax_cube(*dims, **kw),
                   JaxRunConfig(solver=JaxSolverConfig(pallas="interpret",
                                                       **sc),
                                time_history=JaxTimeHistoryConfig(
                                    time_step_delta=(0.0, 1.0),
                                    export_flag=False)),
                   mesh=make_mesh(1), n_parts=1)
    ts = Solver(make_cube_model(*dims, **kw),
                RunConfig(solver=SolverConfig(**sc),
                          time_history=TimeHistoryConfig(
                              time_step_delta=(0.0, 1.0))),
                device="cpu")
    assert js.backend == "structured" and js.ops.use_pallas
    assert ts.pm.glob_n_dof_eff - sc["max_iter"] >= 5
    assert js.pallas_variant == ts.kernel_variant == f"v{value}"
    (rj,), (rt,) = js.solve(), ts.solve()
    assert rt.flag == rj.flag == 0
    assert rt.relres <= sc["tol"]
    assert abs(rt.iters - rj.iters) <= max(3, 0.05 * rj.iters)
    uj, ut = js.displacement_global(), ts.displacement_global()
    np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-5 * np.abs(uj).max())

"""The port's Solver end to end on the CPU against the JAX package's Solver
(structured backend, one part), on the same model.

Tolerances: direct f64 — same flags, iteration counts within +-1 (the
f64 dots' reduction order can move a count sitting at the tol boundary
by one; see the assertion), relres <= tol,
displacements within 1e-8 relative.  Mixed — iteration counts within
max(3, 5 %) (the f32 inner dots are summed in another order than XLA's,
which moves the refinement sequence a little), relres <= tol,
displacements within 1e-5 relative.  max_iter stays below n_eff - 5 so
MATLAB's MoreSteps budget is 5, as at the flagship."""

import re

import numpy as np
import pytest
import torch

from pcg_mpi_solver_tpu import RunConfig as JaxRunConfig
from pcg_mpi_solver_tpu import SolverConfig as JaxSolverConfig
from pcg_mpi_solver_tpu import TimeHistoryConfig as JaxTimeHistoryConfig
from pcg_mpi_solver_tpu.models import make_cube_model as jax_cube
from pcg_mpi_solver_tpu.parallel.mesh import make_mesh
from pcg_mpi_solver_tpu.solver import Solver as JaxSolver
from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig, TimeHistoryConfig
from pcg_mpi_solver_tpu_torch.models import make_cube_model
from pcg_mpi_solver_tpu_torch.solver import Solver

DELTAS = (0.0, 0.5, 1.0)
DIMS = (16, 6, 6)


def model_kw(load):
    return dict(E=30e9, nu=0.2, heterogeneous=True, seed=5, load=load,
                load_value=1e6 if load == "traction" else 1e-3)


@pytest.mark.parametrize("mode", ["direct", "mixed"])
@pytest.mark.parametrize("load", ["traction", "dirichlet"])
def test_solver_matches_jax(mode, load):
    sc = dict(tol=1e-8, max_iter=1000, precision_mode=mode)
    js = JaxSolver(jax_cube(*DIMS, **model_kw(load)),
                   JaxRunConfig(solver=JaxSolverConfig(**sc),
                                time_history=JaxTimeHistoryConfig(
                                    time_step_delta=DELTAS,
                                    export_flag=False)),
                   mesh=make_mesh(1), n_parts=1)
    assert js.backend == "structured"
    ts = Solver(make_cube_model(*DIMS, **model_kw(load)),
                RunConfig(solver=SolverConfig(**sc),
                          time_history=TimeHistoryConfig(
                              time_step_delta=DELTAS)),
                n_parts=1, device="cpu")
    assert ts.pm.glob_n_dof_eff - sc["max_iter"] >= 5
    rj, rt = js.solve(), ts.solve()
    assert len(rt) == len(rj) == 2
    for a, b in zip(rt, rj):
        assert a.flag == b.flag == 0
        assert a.relres <= sc["tol"]
        if mode == "direct":
            # step 2 starts from step 1's solution, on which the two
            # packages agree only to tol, and the f64 dots' reduction
            # order can move the deferred check across tol by one
            # iteration (traction: 190 vs JAX's 189, its relres 9.75e-9
            # against tol 1e-8): +-1
            assert abs(a.iters - b.iters) <= 1
        else:
            assert abs(a.iters - b.iters) <= max(3, 0.05 * b.iters)
    uj, ut = js.displacement_global(), ts.displacement_global()
    assert ut.shape == uj.shape and ut.dtype == np.float64
    rel = 1e-8 if mode == "direct" else 1e-5
    np.testing.assert_allclose(ut, uj, rtol=0, atol=rel * np.abs(uj).max())


def test_explicit_dispatch_cap_is_bitwise_one_shot():
    """iters_per_dispatch=7 engages the chunked path on a model far below
    the automatic 4 M-dof threshold (where -1 keeps the one-shot solve);
    the capped dispatches are bit for bit the one-shot solve."""
    m = make_cube_model(8, 4, 4, **model_kw("traction"))
    runs = []
    for ipd in (-1, 7):
        s = Solver(m, RunConfig(solver=SolverConfig(
            tol=1e-8, iters_per_dispatch=ipd)), device="cpu")
        r = s.step(1.0)
        runs.append((r.flag, r.iters, r.relres, s.displacement_global()))
    assert runs[0][:3] == runs[1][:3]
    np.testing.assert_array_equal(runs[0][3], runs[1][3])


def test_solver_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = make_cube_model(4, 3, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Solver(m, RunConfig())
    assert Solver(m, RunConfig(), device="cpu").device.type == "cpu"


@pytest.mark.parametrize("dims,kw,n_parts", [
    ((4, 3, 3), dict(n_types=2), 1),    # two pattern types: no grid
    ((5, 3, 3), {}, 2),                 # nx not divisible by the parts
], ids=["n_types2", "nx5_parts2"])
def test_general_backend_models_solve(dims, kw, n_parts):
    """The two models the structured-only port refused (until the general
    backend came) now solve on it, against the JAX Solver on the same
    model: direct float64, the same flag, iterations within +-1 (the f64
    reductions sum in another order than XLA's), displacements within
    1e-8."""
    sc = dict(tol=1e-8, max_iter=100)
    mk = dict(E=30e9, nu=0.2, load_value=1e6, heterogeneous=True, seed=4,
              **kw)
    js = JaxSolver(jax_cube(*dims, **mk), JaxRunConfig(
        solver=JaxSolverConfig(iters_per_dispatch=0, **sc)),
        mesh=make_mesh(1), n_parts=n_parts)
    ts = Solver(make_cube_model(*dims, **mk),
                RunConfig(solver=SolverConfig(**sc)), n_parts=n_parts,
                device="cpu")
    assert js.backend == ts.backend == "general"
    assert ts.pm.glob_n_dof_eff - sc["max_iter"] >= 5
    rj, rt = js.step(1.0), ts.step(1.0)
    assert rt.flag == rj.flag == 0 and rt.relres <= sc["tol"]
    assert abs(rt.iters - rj.iters) <= 1
    uj, ut = js.displacement_global(), ts.displacement_global()
    np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-8 * np.abs(uj).max())


def _refuse(where):
    """The text of the port's refusal at ``where``: for the single-process
    psum, its docstring; for the others, the message they raise."""
    from pcg_mpi_solver_tpu_torch.models import make_octree_model
    from pcg_mpi_solver_tpu_torch.ops.matvec import Ops
    from pcg_mpi_solver_tpu_torch.parallel.partition import partition_model

    if where == "psum":
        return Ops._psum.__doc__
    octree = make_octree_model(2, 2, 2, max_level=2, n_incl=2, seed=3)
    calls = {
        "part_range": lambda: partition_model(octree, 2, part_range=(0, 1)),
        "comm": lambda: partition_model(octree, 2, comm=object()),
        "layout": lambda: partition_model(octree, 2, layout=object()),
    }
    with pytest.raises(NotImplementedError) as err:
        calls[where]()
    return str(err.value)


@pytest.mark.parametrize("where,items", [
    ("psum", [r"sharding is ROADMAP queue 1 item 12\b"]),
    ("part_range", [r"ROADMAP queue 1 item 12\b"]),
    ("comm", [r"ROADMAP queue 1 item 12\b"]),
    ("layout", [r"ROADMAP queue 1 item 12\b"]),
])
def test_module_refusals_name_their_queue_items(where, items):
    """Each refusal inside the port's modules (outside solver/driver.py's
    option refusals, which tests/test_torch_config.py checks) names the
    ROADMAP queue 1 item that owns what it refuses: sharding 12."""
    text = " ".join(_refuse(where).split())
    for item in items:
        assert re.search(item, text), (where, text)

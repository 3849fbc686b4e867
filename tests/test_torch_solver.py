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


def test_iters_per_dispatch_is_accepted_and_ignored():
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


@pytest.mark.parametrize("change,item", [
    (dict(solver=SolverConfig(nrhs=2)), "item 7"),
    (dict(snapshot_every=5), "item 9"),
])
def test_unported_options_raise(change, item):
    with pytest.raises(NotImplementedError, match=item):
        Solver(make_cube_model(4, 3, 3), RunConfig(**change), device="cpu")


def test_unported_backends_raise():
    with pytest.raises(NotImplementedError, match="item 8"):
        Solver(make_cube_model(4, 3, 3, n_types=2), RunConfig(),
               device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        Solver(make_cube_model(5, 3, 3), RunConfig(), n_parts=2,
               device="cpu")


def _refuse(where):
    """Triggers the port's refusal at ``where`` on a small one-part cube
    (or, for the single-process psum, returns its docstring)."""
    from pcg_mpi_solver_tpu_torch.ops.matvec import Ops
    from pcg_mpi_solver_tpu_torch.parallel.structured import (
        StructuredOps, device_data_structured, partition_structured)

    if where == "psum":
        return Ops._psum.__doc__
    sp = partition_structured(make_cube_model(4, 3, 3), 1)
    data = device_data_structured(sp, torch.float64, "cpu")
    ops = StructuredOps.from_partition(sp)
    v = torch.zeros(1, ops.n_loc, dtype=torch.float64)
    calls = {
        "apply_prec": lambda: ops.apply_prec(v, v[..., None], data),
        "matvec_local": lambda: ops.matvec_local(data, v[..., None]),
    }
    with pytest.raises(NotImplementedError) as info:
        calls[where]()
    return str(info.value)


@pytest.mark.parametrize("where,items", [
    ("psum", [r"sharding is ROADMAP queue 1 item 12\b"]),
    ("apply_prec", [r"blocked right-hand sides: item 7\b"]),
    ("matvec_local", [r"blocked right-hand sides .*item 7\b"]),
])
def test_module_refusals_name_their_queue_items(where, items):
    """Each refusal inside the port's modules (outside solver/driver.py's,
    which test_unported_options_raise checks) names the ROADMAP queue 1 item
    that owns what it refuses: sharding 12, blocked right-hand sides 7."""
    text = " ".join(_refuse(where).split())
    for item in items:
        assert re.search(item, text), (where, text)

"""``Solver(backend="hybrid")`` of the port against the JAX package's, on
the CPU, on ``tests/test_hybrid.py``'s 2x2x2/L2 octree (tol 1e-9).

Both packages force the chunked path on this backend (``force_engage``:
one dispatch here, ``dispatch_log`` non-empty).  JAX's solves are shared
through a module cache.

- Direct float64 at one and two parts: flag 0, iterations within +-1 and
  x within 1e-9 of max|u| (``tests/test_hybrid.py::
  test_solve_matches_general``'s window; the level sums run in another
  order than XLA's).
- Mixed under each ``PCG_TPU_HYBRID_F64_REFRESH`` mode (bucketed,
  general, stencil): flag 0, iterations within max(3, 5 %) of JAX's (the
  ground rules' mixed window), the same recorded refresh.
- block3 (direct): iterations within +-1.
- ``solve_many([F, 2F])``, direct and mixed: per-column flags equal,
  iterations within +-1 (direct) or the mixed window.
- The backend choice: auto under ``PCG_TPU_ENABLE_HYBRID=1`` takes
  hybrid in both packages; without it, general with JAX's gate note.
  mg on hybrid raises ``ValueError`` (JAX's message), and so does hybrid
  on a model without brick metadata, and an unknown refresh mode.
- The checkpoint fingerprint of a mixed hybrid Solver equals JAX's
  (level dims, combine, KD, refresh); a mid-solve snapshot taken under
  the gather combine refuses to resume under scatter.
"""

import copy
import os

import numpy as np
import pytest

from pcg_mpi_solver_tpu import RunConfig as JaxRunConfig
from pcg_mpi_solver_tpu import SolverConfig as JaxSolverConfig
from pcg_mpi_solver_tpu.models.octree import make_octree_model as jax_octree
from pcg_mpi_solver_tpu.obs.metrics import MetricsRecorder as JaxRecorder
from pcg_mpi_solver_tpu.parallel.mesh import make_mesh
from pcg_mpi_solver_tpu.solver import Solver as JaxSolver
from pcg_mpi_solver_tpu.utils.checkpoint import _fingerprint as jax_fingerprint
from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig
from pcg_mpi_solver_tpu_torch.models import make_octree_model
from pcg_mpi_solver_tpu_torch.obs.metrics import MetricsRecorder
from pcg_mpi_solver_tpu_torch.resilience import FaultPlan, SimulatedKill
from pcg_mpi_solver_tpu_torch.solver import Solver
from pcg_mpi_solver_tpu_torch.utils.checkpoint import _fingerprint

MODEL = ((2, 2, 2), dict(max_level=2, n_incl=2, seed=3, load="traction",
                         load_value=1.0))
SC = dict(tol=1e-9, max_iter=3000)
CASES = {"direct": dict(dtype="float64"),
         "mixed": dict(precision_mode="mixed"),
         "block3": dict(dtype="float64", precond="block3")}
KNOBS = ("PCG_TPU_ENABLE_HYBRID", "PCG_TPU_HYBRID_F64_REFRESH",
         "PCG_TPU_HYBRID_COMBINE", "PCG_TPU_HYBRID_BLOCK",
         "PCG_TPU_HYBRID_MERGE", "PCG_TPU_HYBRID_KD")
_JAX = {}


class _Notes:
    def __init__(self):
        self.msgs = []

    def emit(self, ev):
        if ev.get("kind") == "note":
            self.msgs.append(ev["msg"])


@pytest.fixture(scope="module")
def models():
    args, kw = MODEL
    return jax_octree(*args, **kw), make_octree_model(*args, **kw)


@pytest.fixture(autouse=True)
def _clean_knobs(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)


def _mixed_window(n: int) -> float:
    return max(3, 0.05 * n)


def _jax_run(models, case, n_parts=1, refresh="bucketed"):
    """(flags, iters, u, f64_refresh, many flags, many iters) of JAX's
    hybrid Solver on ``case``, run once."""
    key = (case, n_parts, refresh)
    if key not in _JAX:
        os.environ["PCG_TPU_HYBRID_F64_REFRESH"] = refresh
        try:
            s = JaxSolver(models[0], JaxRunConfig(
                solver=JaxSolverConfig(**SC, **CASES[case])),
                mesh=make_mesh(n_parts), n_parts=n_parts, backend="hybrid")
            r = s.step(1.0)
            F = np.asarray(models[0].F)
            m = s.solve_many(np.stack([F, 2 * F], -1)) if n_parts == 1 \
                else None
        finally:
            del os.environ["PCG_TPU_HYBRID_F64_REFRESH"]
        _JAX[key] = (r.flag, r.iters, s.displacement_global(),
                     s.f64_refresh, m)
    return _JAX[key]


def _port(models, case, n_parts=1, **kw):
    return Solver(models[1], RunConfig(solver=SolverConfig(
        **SC, **CASES[case])), n_parts=n_parts, device="cpu",
        backend="hybrid", **kw)


@pytest.mark.parametrize("n_parts", [1, 2])
def test_direct_matches_jax(models, n_parts):
    flag_j, it_j, u_j, _r, _m = _jax_run(models, "direct", n_parts)
    s = _port(models, "direct", n_parts)
    assert s.backend == "hybrid" and s.f64_refresh == "stencil"
    assert s._dispatch_cap > 0
    r = s.step(1.0)
    assert s.dispatch_log, "the hybrid step must take the chunked path"
    assert r.flag == flag_j == 0 and r.relres <= SC["tol"]
    assert abs(r.iters - it_j) <= 1, (r.iters, it_j)
    np.testing.assert_allclose(s.displacement_global(), u_j, rtol=0,
                               atol=1e-9 * np.abs(u_j).max())


@pytest.mark.parametrize("refresh", ["bucketed", "general", "stencil"])
def test_mixed_refresh_modes_match_jax(models, monkeypatch, refresh):
    flag_j, it_j, u_j, rf_j, _m = _jax_run(models, "mixed",
                                           refresh=refresh)
    monkeypatch.setenv("PCG_TPU_HYBRID_F64_REFRESH", refresh)
    s = _port(models, "mixed")
    assert s.f64_refresh == rf_j == refresh
    assert (s._refresh64 is None) == (refresh == "stencil")
    r = s.step(1.0)
    assert r.flag == flag_j == 0 and r.relres <= SC["tol"]
    assert abs(r.iters - it_j) <= _mixed_window(it_j), (r.iters, it_j)
    np.testing.assert_allclose(s.displacement_global(), u_j, rtol=0,
                               atol=1e-7 * np.abs(u_j).max())


def test_block3_matches_jax(models):
    flag_j, it_j, u_j, _r, _m = _jax_run(models, "block3")
    s = _port(models, "block3")
    r = s.step(1.0)
    assert r.flag == flag_j == 0
    assert abs(r.iters - it_j) <= 1, (r.iters, it_j)
    np.testing.assert_allclose(s.displacement_global(), u_j, rtol=0,
                               atol=1e-9 * np.abs(u_j).max())


@pytest.mark.parametrize("case", ["direct", "mixed"])
def test_solve_many_matches_jax(models, case):
    *_x, mj = _jax_run(models, case)
    s = _port(models, case)
    F = np.asarray(models[1].F)
    m = s.solve_many(np.stack([F, 2 * F], -1))
    np.testing.assert_array_equal(m.flags, mj.flags)
    assert (m.flags == 0).all()
    win = 1 if case == "direct" else _mixed_window(int(mj.iters.max()))
    assert np.abs(m.iters - mj.iters).max() <= win, (m.iters, mj.iters)
    u = s.displacement_global_many(m.x)
    np.testing.assert_allclose(u[:, 1], 2 * u[:, 0], rtol=0,
                               atol=1e-7 * np.abs(u).max())


def test_auto_choice_and_gate(models, monkeypatch):
    mj, mt = models
    notes, jnotes = _Notes(), _Notes()
    cfg = RunConfig(solver=SolverConfig(**SC))
    s = Solver(mt, cfg, device="cpu",
               recorder=MetricsRecorder(sinks=[notes]))
    sj = JaxSolver(mj, JaxRunConfig(solver=JaxSolverConfig(**SC)),
                   mesh=make_mesh(1), n_parts=1,
                   recorder=JaxRecorder(sinks=[jnotes]))
    assert s.backend == sj.backend == "general"
    gate = [m for m in notes.msgs if "PCG_TPU_ENABLE_HYBRID=1" in m]
    assert len(gate) == 1
    assert any(gate[0] in m for m in jnotes.msgs), jnotes.msgs
    monkeypatch.setenv("PCG_TPU_ENABLE_HYBRID", "1")
    s = Solver(mt, cfg, device="cpu")
    assert s.backend == "hybrid"
    sj = JaxSolver(mj, JaxRunConfig(solver=JaxSolverConfig(**SC)),
                   mesh=make_mesh(1), n_parts=1)
    assert sj.backend == "hybrid"
    assert Solver(mt, cfg, device="cpu", backend="general").backend \
        == "general"


def test_hybrid_refusals(models, monkeypatch):
    mt = models[1]
    with pytest.raises(ValueError, match="precond='mg' is not supported "
                                         "on the hybrid"):
        Solver(mt, RunConfig(solver=SolverConfig(precond="mg")),
               device="cpu", backend="hybrid")
    bare = copy.deepcopy(mt)
    bare.octree = None
    with pytest.raises(ValueError, match="no octree/brick metadata"):
        Solver(bare, RunConfig(), device="cpu", backend="hybrid")
    assert Solver(bare, RunConfig(), device="cpu").backend == "general"
    monkeypatch.setenv("PCG_TPU_HYBRID_F64_REFRESH", "stencl")
    with pytest.raises(ValueError, match="PCG_TPU_HYBRID_F64_REFRESH"):
        _port(models, "mixed")


def test_fingerprint_matches_jax(models):
    sj = JaxSolver(models[0], JaxRunConfig(
        solver=JaxSolverConfig(**SC, **CASES["mixed"])),
        mesh=make_mesh(1), n_parts=1, backend="hybrid")
    st = _port(models, "mixed")
    fp = _fingerprint(st)
    assert fp == jax_fingerprint(sj)
    assert fp["level_dims"] == [list(d) for d in st.ops.level_dims]
    assert (fp["combine"], fp["combine_kd"], fp["f64_refresh"]) \
        == ("gather", 2, "bucketed")


def test_snapshot_refuses_another_combine(models, monkeypatch, tmp_path):
    def cfg():
        c = RunConfig(scratch_path=str(tmp_path), run_id="hy", solver=(
            SolverConfig(**SC, **CASES["direct"], iters_per_dispatch=20)))
        c.snapshot_every = 1
        return c

    s = Solver(models[1], cfg(), device="cpu", backend="hybrid")
    s.fault_plan = FaultPlan("kill@1", recorder=s.recorder)
    with pytest.raises(SimulatedKill):
        s.solve()
    monkeypatch.setenv("PCG_TPU_HYBRID_COMBINE", "scatter")
    s2 = Solver(models[1], cfg(), device="cpu", backend="hybrid")
    assert s2.ops.combine == "scatter"
    with pytest.raises(ValueError, match="mismatch.*combine"):
        s2.solve(resume=True)

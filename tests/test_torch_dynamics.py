"""The port's explicit central-difference dynamics (``DynamicsSolver``,
``stable_dt``, ``select_time_backend``) against the JAX package's, on the
CPU (``device="cpu"``), on ``tests/test_dynamics.py``'s models.

- Float64, 4 parts, dt = stable_dt(safety=0.5), damping 0.05, probes 6
  and 13, frames every 5 steps: the final u, the probe series and the
  frames within rtol 1e-9 and atol 1e-12 * max|u| of JAX's (the window
  of JAX's own numpy-integrator test; the matvec sums in another order).
- The same on the 2x2x2/L2 octree's hybrid backend against JAX's hybrid,
  and the port's hybrid against its general backend (1e-11 * max|u|,
  JAX's window); float32 on the hybrid level batches (the plain kernel
  version on the CPU) within 1e-4 * max|u| of float64.
- Chunk splitting is bitwise neutral within the port: export cadences
  0, 5 and 7 and snapshot cadence 3 give the one-chunk run's bits.
- A caller's dt of 1.5 * stable_dt(model, safety=1) raises
  ``PreflightError``; a model-file dt above the bound only warns (in the
  preflight event); ``PCG_TPU_PREFLIGHT=off`` skips the check.
- The backend rule (auto gated by ``PCG_TPU_ENABLE_HYBRID``), probe and
  option refusals, and the card default without CUDA.
"""

import numpy as np
import pytest
import torch

from pcg_mpi_solver_tpu import RunConfig as JaxRunConfig
from pcg_mpi_solver_tpu.models import make_cube_model as jax_cube
from pcg_mpi_solver_tpu.models.octree import make_octree_model as jax_octree
from pcg_mpi_solver_tpu.parallel.mesh import make_mesh
from pcg_mpi_solver_tpu.solver.dynamics import DynamicsSolver as JaxDynamics
from pcg_mpi_solver_tpu.solver.dynamics import stable_dt as jax_stable_dt
from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig
from pcg_mpi_solver_tpu_torch.models import make_cube_model, make_octree_model
from pcg_mpi_solver_tpu_torch.obs.metrics import MetricsRecorder
from pcg_mpi_solver_tpu_torch.solver import (
    DynamicsSolver, select_time_backend, stable_dt)
from pcg_mpi_solver_tpu_torch.validate import PreflightError

CUBE = ((4, 3, 3), dict(E=100.0, nu=0.25, rho=1.0, load="traction",
                        load_value=1.0, heterogeneous=True))
OCTREE = ((2, 2, 2), dict(max_level=2, n_incl=2, seed=3, load="traction",
                          load_value=1.0))
RTOL, ATOL = 1e-9, 1e-12        # atol x max|u|
_JAX = {}


class _Events:
    def __init__(self):
        self.events = []

    def emit(self, ev):
        self.events.append(ev)


@pytest.fixture(scope="module")
def cubes():
    args, kw = CUBE
    return jax_cube(*args, **kw), make_cube_model(*args, **kw)


@pytest.fixture(scope="module")
def octrees():
    args, kw = OCTREE
    return jax_octree(*args, **kw), make_octree_model(*args, **kw)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ("PCG_TPU_ENABLE_HYBRID", "PCG_TPU_PREFLIGHT",
              "PCG_TPU_FAULTS"):
        monkeypatch.delenv(k, raising=False)


def _jax_run(key, model, n_steps, backend="auto", **kw):
    """JAX's DynamicsSolver result on ``model``, run once per key."""
    if key not in _JAX:
        s = JaxDynamics(model, JaxRunConfig(), mesh=make_mesh(4), n_parts=4,
                        backend=backend, **kw)
        _JAX[key] = (s.backend, s.run(n_steps, export_every=5))
    return _JAX[key]


def _close(got, want):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale)


def test_stable_dt_matches_jax(cubes, octrees):
    for jm, pm in (cubes, octrees):
        for safety in (0.5, 0.9, 1.0):
            assert stable_dt(pm, safety) == jax_stable_dt(jm, safety)


def test_explicit_float64_matches_jax(cubes):
    dt = stable_dt(cubes[1], safety=0.5)
    kw = dict(dt=dt, damping=0.05, probe_dofs=(6, 13))
    _b, ref = _jax_run("cube", cubes[0], 25, **kw)
    s = DynamicsSolver(cubes[1], RunConfig(), n_parts=4, device="cpu", **kw)
    assert s.backend == "general" and s.dtype == torch.float64
    res = s.run(25, export_every=5)
    _close(res.u, np.asarray(ref.u))
    _close(res.probe_u, np.asarray(ref.probe_u))
    np.testing.assert_array_equal(res.probe_t, ref.probe_t)
    assert len(res.frames) == len(ref.frames) == 5
    assert res.frame_times == ref.frame_times
    for a, b in zip(res.frames, ref.frames):
        _close(a, np.asarray(b))
    # one chunk a frame
    assert s.chunks == 5


def test_explicit_hybrid_matches_jax(octrees):
    dt = 0.5 * stable_dt(octrees[1])
    kw = dict(dt=dt, damping=0.1)
    b_j, ref = _jax_run("octree-hybrid", octrees[0], 50, backend="hybrid",
                        **kw)
    s = DynamicsSolver(octrees[1], RunConfig(), n_parts=4, device="cpu",
                       backend="hybrid", **kw)
    assert s.backend == b_j == "hybrid"
    res = s.run(50, export_every=5)
    _close(res.u, np.asarray(ref.u))
    for a, b in zip(res.frames, ref.frames):
        _close(a, np.asarray(b))
    g = DynamicsSolver(octrees[1], RunConfig(), n_parts=4, device="cpu",
                       backend="general", **kw).run(50)
    np.testing.assert_allclose(res.u, g.u, rtol=0,
                               atol=1e-11 * np.abs(g.u).max())


def test_explicit_float32_hybrid_near_float64(octrees):
    dt = 0.5 * stable_dt(octrees[1])
    out = {}
    for dtype in ("float32", "float64"):
        cfg = RunConfig(solver=SolverConfig(dtype=dtype))
        s = DynamicsSolver(octrees[1], cfg, n_parts=2, device="cpu",
                           backend="hybrid", dt=dt, damping=0.1,
                           probe_dofs=(20,))
        assert s.data["levels"][0]["ck"].dtype == getattr(torch, dtype)
        out[dtype] = s.run(40)
    scale = np.abs(out["float64"].u).max()
    assert np.isfinite(out["float32"].u).all()
    np.testing.assert_allclose(out["float32"].u, out["float64"].u, rtol=0,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(out["float32"].probe_u,
                               out["float64"].probe_u, rtol=0,
                               atol=1e-4 * scale)


@pytest.mark.parametrize("cadence", [("export", 5), ("export", 7),
                                     ("snapshot", 3)])
def test_chunk_splitting_is_bitwise_neutral(cubes, tmp_path, cadence):
    dt = stable_dt(cubes[1], safety=0.5)

    def run(export_every=0, snap=0):
        cfg = RunConfig(scratch_path=str(tmp_path), run_id=f"s{snap}")
        cfg.snapshot_every = snap
        s = DynamicsSolver(cubes[1], cfg, n_parts=2, device="cpu", dt=dt,
                           probe_dofs=(6,))
        return s, s.run(20, export_every=export_every)

    s0, r0 = run()
    assert s0.chunks == 1
    kind, k = cadence
    s1, r1 = run(**({"export_every": k} if kind == "export"
                    else {"snap": k}))
    assert s1.chunks == -(-20 // k)
    np.testing.assert_array_equal(r1.probe_u, r0.probe_u)
    np.testing.assert_array_equal(r1.u, r0.u)


def test_caller_dt_above_cfl_raises(cubes, monkeypatch):
    bound = stable_dt(cubes[1], safety=1.0)
    with pytest.raises(PreflightError, match="explicit_dt"):
        DynamicsSolver(cubes[1], RunConfig(), device="cpu", dt=1.5 * bound)
    monkeypatch.setenv("PCG_TPU_PREFLIGHT", "off")
    s = DynamicsSolver(cubes[1], RunConfig(), device="cpu", dt=1.5 * bound)
    assert s.dt == 1.5 * bound


def test_model_dt_above_cfl_only_warns(cubes):
    import dataclasses

    m = dataclasses.replace(cubes[1], dt=1.5 * stable_dt(cubes[1], 1.0))
    ev = _Events()
    s = DynamicsSolver(m, RunConfig(), device="cpu",
                       recorder=MetricsRecorder(sinks=[ev]))
    assert s.dt == m.dt
    pre = [e for e in ev.events if e["kind"] == "preflight"]
    assert pre and pre[0]["failed"] == 0
    check = [c for c in pre[0]["checks"] if c["name"] == "explicit_dt"][0]
    assert check["status"] == "warn" and "(model)" in check["detail"]
    # the CFL default is the bound itself
    cfl = DynamicsSolver(dataclasses.replace(m, dt=0.0), RunConfig(),
                         device="cpu")
    assert cfl.dt == stable_dt(m)


def test_backend_rule(octrees, cubes, monkeypatch):
    kw = dict(partition_method="rcb", device=torch.device("cpu"))
    with pytest.warns(UserWarning, match="PCG_TPU_ENABLE_HYBRID"):
        name, *_ = select_time_backend(octrees[1], 2, **kw)
    assert name == "general"
    monkeypatch.setenv("PCG_TPU_ENABLE_HYBRID", "1")
    name, pm, mk_ops, mk_data = select_time_backend(
        octrees[1], 2, kernel=dict(variant="v1", planes=None), **kw)
    assert name == "hybrid" and mk_ops(torch.float32).variant == "v1"
    assert mk_data(torch.float32)["levels"][0]["ck"].dtype == torch.float32
    assert select_time_backend(cubes[1], 2, **kw)[0] == "general"
    with pytest.raises(ValueError, match="brick metadata"):
        select_time_backend(cubes[1], 2, backend="hybrid", **kw)
    with pytest.raises(ValueError, match="backend must be"):
        select_time_backend(cubes[1], 2, backend="structured", **kw)


def test_refusals(cubes, tmp_path):
    dt = stable_dt(cubes[1], safety=0.5)
    with pytest.raises(ValueError, match="probe dof"):
        DynamicsSolver(cubes[1], RunConfig(), device="cpu", dt=dt,
                       probe_dofs=(10**7,))
    with pytest.raises(NotImplementedError, match="pallas='interpret'"):
        DynamicsSolver(cubes[1], RunConfig(solver=SolverConfig(
            pallas="interpret")), device="cpu", dt=dt)
    # the telemetry stream is ported: the run ends it with its summary
    tel = tmp_path / "t.jsonl"
    DynamicsSolver(cubes[1], RunConfig(telemetry_path=str(tel)),
                   device="cpu", dt=dt).run(2)
    assert '"run_summary"' in tel.read_text().splitlines()[-1]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DynamicsSolver(cubes[1], RunConfig(), dt=dt)

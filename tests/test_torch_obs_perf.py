"""The port's cost model, profile reader, phase probes and preflight
against the JAX package's, on the CPU.

The cost model on the ``"cpu"`` profile is the JAX package's number for
number, for every variant, preconditioner and block width, and
``shape_from_solver`` reads the same geometry from both packages'
Solvers of one model.  The profile reader is held to a handmade Chrome
trace (its phases, ``other``, unknown scopes, busy time and the
launch-or-device attribution) and to a real CPU ``torch.profiler``
capture that shows the four ``pcg/*`` ranges.  The preflight gives the
JAX package's check names and severities on a sound model and on broken
ones.  No timing band is asserted.
"""

import gzip
import json

import numpy as np
import pytest

from pcg_mpi_solver_tpu.config import RunConfig as JaxRunConfig
from pcg_mpi_solver_tpu.config import SolverConfig as JaxSolverConfig
from pcg_mpi_solver_tpu.models.synthetic import make_cube_model as jax_cube
from pcg_mpi_solver_tpu.obs import perf as jax_perf
from pcg_mpi_solver_tpu.obs import profview as jax_profview
from pcg_mpi_solver_tpu.parallel.mesh import make_mesh
from pcg_mpi_solver_tpu.solver.driver import Solver as JaxSolver
from pcg_mpi_solver_tpu.validate import preflight_checks as jax_checks
from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig
from pcg_mpi_solver_tpu_torch.config import PCG_VARIANTS, PRECONDS
from pcg_mpi_solver_tpu_torch.models import make_cube_model
from pcg_mpi_solver_tpu_torch.obs import perf, profview
from pcg_mpi_solver_tpu_torch.obs.phases import run_phase_probe
from pcg_mpi_solver_tpu_torch.solver import Solver
from pcg_mpi_solver_tpu_torch.solver.pcg import phase_scopes
from pcg_mpi_solver_tpu_torch.validate import (
    PreflightError, preflight_checks, run_preflight)

SHAPE = dict(n_dof=123456, n_parts=4, n_iface=3000,
             elem_groups=((24, 40000), (12, 900)), backend="general",
             itemsize=4, dot_itemsize=8, mg_degree=3, mg_coarse_dofs=5000)


# ---------------------------------------------------------------- cost model
@pytest.mark.parametrize("precond", PRECONDS)
@pytest.mark.parametrize("variant", PCG_VARIANTS)
def test_cost_model_matches_jax(variant, precond):
    for kw in (SHAPE, dict(SHAPE, backend="structured", n_parts=1),
               dict(SHAPE, elem_groups=(), n_parts=2, backend="structured")):
        ps, js = perf.ProblemShape(**kw), jax_perf.ProblemShape(**kw)
        for nrhs in (1, 8):
            assert perf.cost_model(ps, variant, precond, nrhs) == \
                jax_perf.cost_model(js, variant, precond, nrhs)
            ours = perf.phase_costs(ps, variant, precond, nrhs)
            theirs = jax_perf.phase_costs(js, variant, precond, nrhs)
            assert {k: v.to_dict() for k, v in ours.items()} == \
                {k: v.to_dict() for k, v in theirs.items()}


def test_cost_model_tables_and_profiles():
    ps = perf.ProblemShape(**SHAPE)
    table = perf.cost_model_table(ps)
    assert len(table) == len(PCG_VARIANTS) * len(PRECONDS) * 2
    with pytest.raises(KeyError):
        perf.cost_model(ps, "bogus", "jacobi")
    with pytest.raises(KeyError):
        perf.cost_model(ps, "classic", "bogus")
    assert set(perf.HW_PROFILES) == {"cpu", "cuda"}
    assert vars(perf.HW_PROFILES["cpu"]) == vars(jax_perf.HW_PROFILES["cpu"])
    assert perf.resolve_profile("NVIDIA H100 80GB HBM3").name == "cuda"
    cuda = perf.resolve_profile("cuda")
    assert (cuda.flops_per_s, cuda.hbm_bytes_per_s) == (67e12, 3.35e12)
    meta = dict(n_dof=5000, mode="mixed", backend="structured", n_parts=1)
    assert vars(perf.shape_from_detail(meta)) == \
        vars(jax_perf.shape_from_detail(meta))


def test_cost_model_roofline_env_overrides(monkeypatch):
    monkeypatch.setenv("PCG_TPU_ROOFLINE_HBM_GBS", "100")
    monkeypatch.setenv("PCG_TPU_ROOFLINE_COLL_LAT_US", "3")
    p = perf.resolve_profile("cuda")
    assert p.hbm_bytes_per_s == 100e9 and p.coll_latency_s == 3e-6


@pytest.mark.parametrize("backend,precond,cells,n_parts", [
    ("structured", "jacobi", (4, 3, 3), 1),
    ("general", "block3", (4, 3, 3), 2),
    ("structured", "mg", (8, 4, 4), 1)])
def test_shape_from_solver_matches_jax(backend, precond, cells, n_parts):
    """Both packages' Solvers of one model read the same geometry, and
    the port's Solver emits the cost model of it."""
    kw = dict(E=30e9, heterogeneous=True, load="traction", load_value=1e6)
    sc = dict(precond=precond, precision_mode="mixed")
    js = JaxSolver(jax_cube(*cells, **kw),
                   JaxRunConfig(solver=JaxSolverConfig(**sc)),
                   mesh=make_mesh(1), n_parts=n_parts, backend=backend)
    s = Solver(make_cube_model(*cells, **kw),
               RunConfig(solver=SolverConfig(**sc)), n_parts=n_parts,
               backend=backend, device="cpu")
    assert vars(perf.shape_from_solver(s)) == \
        vars(jax_perf.shape_from_solver(js))
    assert s.predicted_ms_per_iter() == js.predicted_ms_per_iter()
    assert s.predicted_ms_per_iter(4) == js.predicted_ms_per_iter(4)
    assert s.recorder.gauges["perf.model_profile"] == "cpu"


# ------------------------------------------------------------------- profiles
@pytest.mark.parametrize("spans", [
    [], [(0, 1)], [(3, 4), (0, 2), (1, 1.5)], [(0, 2), (2, 3), (5, 4)]])
def test_interval_math_matches_jax(spans):
    assert profview.merge_intervals(spans) == \
        jax_profview.merge_intervals(spans)
    m = profview.merge_intervals(spans)
    for span in ((0.5, 3.5), (10, 11)):
        assert profview.intersect_len(span, m) == \
            jax_profview.intersect_len(span, m)


def _x(cat, name, ts, dur, pid=1, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid, "args": args}


def _fixture_events():
    """Host thread (1, 1) with four phase ranges, an unknown one and
    launches; device lane (0, 7) with the kernels and a copy."""
    host = [_x("user_annotation", "pcg/matvec", 0, 10),
            _x("user_annotation", "pcg/reduce", 10, 10),
            _x("user_annotation", "pcg/axpy", 20, 5),
            _x("user_annotation", "pcg/precond", 25, 5),
            _x("user_annotation", "pcg/bogus", 30, 5),
            _x("user_annotation", "pcg-tpu/cycle", 0, 50)]
    launches = [(1, 2), (2, 12), (3, 21), (4, 26), (5, 31), (6, 40)]
    host += [_x("cuda_runtime", "cudaLaunchKernel", ts, 1, correlation=c)
             for c, ts in launches]
    dev = [_x("kernel", "structured_matvec", 5, 4, pid=0, tid=7,
              correlation=1),
           _x("kernel", "reduce_kernel", 15, 2, pid=0, tid=7,
              correlation=2),
           _x("gpu_memcpy", "Memcpy DtoH", 17, 1, pid=0, tid=7,
              correlation=2),
           _x("kernel", "add_kernel", 22, 2, pid=0, tid=7, correlation=3),
           _x("kernel", "jacobi", 27, 1, pid=0, tid=7, correlation=4),
           _x("kernel", "mystery", 32, 1, pid=0, tid=7, correlation=5),
           _x("kernel", "late", 41, 3, pid=0, tid=7, correlation=6),
           # no launch event: the device-lane range decides
           _x("kernel", "orphan", 51, 2, pid=0, tid=7),
           _x("gpu_user_annotation", "pcg/axpy", 50, 5, pid=0, tid=7)]
    return host + dev


def test_bucket_phases_on_a_handmade_trace():
    ops = profview.device_ops(_fixture_events())
    assert len(ops) == 8
    via = {op["name"]: op["via"] for op in ops}
    assert via["orphan"] == "device" and via["structured_matvec"] == \
        "launch"
    b = profview.bucket_phases(ops)
    ph = {k: (v["us"], v["events"]) for k, v in b["phases"].items()}
    assert ph == {"matvec": (4.0, 1), "reduction": (3.0, 2),
                  "axpy": (4.0, 2), "precond": (1.0, 1)}
    assert (b["other_us"], b["other_events"]) == (4.0, 2)
    assert b["unknown_scopes"] == {"bogus": 1}
    # the union of [5,9) [15,18) [22,24) [27,28) [32,33) [41,44) [51,53)
    assert b["busy_us"] == 16.0


def test_profile_report_reads_and_degrades(tmp_path):
    run = tmp_path / "cap" / "run1"
    run.mkdir(parents=True)
    with gzip.open(run / profview.TRACE_FILE, "wt") as f:
        json.dump({"traceEvents": _fixture_events()}, f)
    (run / profview.PROFVIEW_META).write_text(json.dumps(dict(
        iters=2, anchor_ms_per_iter=0.02, wall_s=0.0001, n_dof=1000,
        mode="mixed", backend="structured", pcg_variant="classic",
        precond="jacobi", platform="cuda")))
    rep = profview.profile_report(str(tmp_path / "cap"))
    assert rep["verdict"] == "ok" and rep["n_device_ops"] == 8
    assert rep["phases"]["matvec"]["ms_per_iter"] == 0.002
    assert rep["busy_ms"] == 0.016 and rep["busy_share"] == 0.16
    assert rep["attributed_via"] == {"launch": 7, "device": 1}
    pred = profview.predicted_from_meta(profview.load_meta(
        str(run / profview.TRACE_FILE)))
    assert pred["profile"] == "cuda"
    table = profview.format_report(rep, predicted=pred)
    assert "busy: 0.016 ms" in table and "verdict: ok" in table
    assert profview.newest_profile_artifact(str(tmp_path / "cap")) == \
        str(run)
    # the tolerated failures: a missing artifact, a cut file, no lanes
    assert "no trace artifact" in profview.profile_report(
        str(tmp_path / "none"))["verdict"]
    cut = tmp_path / "cut.trace.json"
    cut.write_text('{"traceEvents": [')
    assert "truncated/invalid" in profview.profile_report(
        str(cut))["verdict"]
    empty = tmp_path / "e.trace.json"
    empty.write_text(json.dumps({"traceEvents": [
        {"ph": "M", "name": "process_name"}]}))
    assert "no device-op events" in profview.profile_report(
        str(empty))["verdict"]


def test_cpu_capture_shows_the_four_phase_ranges(tmp_path):
    """A CPU capture of a port solve: the trace holds the four pcg/*
    ranges, every phase gets time, and the report reads clean; with no
    capture on, the scopes are one shared null context."""
    assert phase_scopes()("pcg/matvec") is phase_scopes()("pcg/axpy")
    s = Solver(make_cube_model(4, 3, 3, heterogeneous=True),
               RunConfig(solver=SolverConfig(tol=1e-8)), device="cpu")
    cap = profview.capture_solve_profile(s, str(tmp_path / "p"))
    assert cap["meta"]["platform"] == "cpu" and cap["iters"] > 1
    evs, probs = profview.read_trace_events(
        profview.find_trace_files(cap["artifact"])[0])
    names = {e.get("name") for e in evs if e.get("cat") == "user_annotation"}
    assert set(profview.PHASE_SCOPES) <= names and not probs
    rep = profview.profile_report(cap["artifact"])
    assert rep["verdict"] == "ok" and rep["iters"] == cap["iters"]
    for ph in perf.PHASES:
        assert rep["phases"][ph]["events"] > 0, ph
    assert rep["unknown_scopes"] == {}
    assert s.recorder.dispatch_stats()["step"]["calls"] == 2


@pytest.mark.parametrize("mode", ["direct", "mixed"])
def test_phase_probe_measures_every_phase(mode):
    """Every phase gets a positive time and the event carries them; a
    mixed solver is probed on its float32 operator.  No timing band."""
    s = Solver(make_cube_model(4, 3, 3, heterogeneous=True),
               RunConfig(solver=SolverConfig(tol=1e-8, precision_mode=mode,
                                             pcg_variant="fused")),
               device="cpu")
    out = run_phase_probe(s, reps=1, inner=2)
    assert set(out["phases"]) == set(perf.PHASES)
    assert all(v > 0 for v in out["phases"].values())
    assert out["whole_ms_per_iter"] > 0 and out["attribution"] > 0
    assert "perf.measured.axpy_ms" in s.recorder.gauges


# ------------------------------------------------------------------ preflight
def _broken(kind):
    """(port model, JAX model, config kwargs) of one preflight case."""
    kw = dict(nu=0.499 if kind == "nu_half" else 0.2, heterogeneous=True)
    m, jm = make_cube_model(4, 3, 3, **kw), jax_cube(4, 3, 3, **kw)
    cfg = {}
    for mod in (m, jm):
        if kind == "nan_coord":
            mod.node_coords = mod.node_coords.copy()
            mod.node_coords[3, 1] = np.nan
        elif kind == "bad_connectivity":
            mod.elem_dofs_flat = mod.elem_dofs_flat.copy()
            mod.elem_dofs_flat[5] = mod.n_dof + 7
        elif kind == "no_constraints":
            mod.fixed_dof = mod.fixed_dof[:0]
    if kind == "tol_floor":
        cfg = dict(precision_mode="mixed", tol=1e-15)
    if kind == "nu_half":
        for mod in (m, jm):
            mod.mat_prop = [dict(p, Pos=0.5) for p in mod.mat_prop]
    return m, jm, cfg


@pytest.mark.parametrize("kind", ["sound", "nan_coord", "bad_connectivity",
                                  "nu_half", "tol_floor", "no_constraints"])
def test_preflight_checks_match_jax(kind):
    m, jm, sc = _broken(kind)
    ours = preflight_checks(m, RunConfig(solver=SolverConfig(**sc)),
                            {"kind": "quasi_static"})
    theirs = jax_checks(jm, JaxRunConfig(solver=JaxSolverConfig(**sc)),
                        {"kind": "quasi_static"})
    assert [(r.name, r.status) for r in ours] == \
        [(r.name, r.status) for r in theirs]
    bad = {r.name for r in ours if r.status != "ok"}
    assert bad == {"sound": set(), "nan_coord": {"finite_coords"},
                   "bad_connectivity": {"connectivity"}, "nu_half": set(),
                   "tol_floor": {"tol_floor"},
                   "no_constraints": {"constraints", "dof_partition"}}[kind]


@pytest.mark.parametrize("field", ["dof_eff", "fixed_dof"])
def test_out_of_range_dof_ids_fail_the_dof_partition(field):
    """An id past n_dof in either list fails the dof partition, named,
    before any mask is built."""
    m = make_cube_model(4, 3, 3, heterogeneous=True)
    ids = getattr(m, field).copy()
    ids[0] = m.n_dof + 3
    setattr(m, field, ids)
    res = {r.name: r for r in preflight_checks(m, RunConfig(),
                                               {"kind": "quasi_static"})}
    assert res["dof_partition"].status == "fail"
    assert "outside" in res["dof_partition"].detail


def test_preflight_policy_order(monkeypatch):
    """RunConfig.preflight wins over PCG_TPU_PREFLIGHT, which wins over
    fail; the Solver gates before its partition and records the event."""
    m, _jm, _ = _broken("nan_coord")
    monkeypatch.delenv("PCG_TPU_PREFLIGHT", raising=False)
    with pytest.raises(PreflightError, match="finite_coords"):
        Solver(m, RunConfig(), device="cpu")
    monkeypatch.setenv("PCG_TPU_PREFLIGHT", "off")
    assert run_preflight(m, RunConfig()) == []
    with pytest.warns(UserWarning, match="finite_coords"):
        res = run_preflight(m, RunConfig(preflight="warn"))
    assert any(r.status == "fail" for r in res)
    with pytest.raises(ValueError, match="policy"):
        run_preflight(m, RunConfig(preflight="maybe"))
    s = Solver(make_cube_model(4, 3, 3), RunConfig(preflight="warn"),
               device="cpu")
    assert s.recorder.counters["preflight.runs"] == 1

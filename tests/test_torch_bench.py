"""The port's bench family on the CPU against the JAX package's.

* ``solver/numpy_ref.py``: the port's ``NumpyRefSolver`` and JAX's on the
  same model (a 3x3x3 heterogeneous cube, octrees at n 2 and 3, level 2)
  give the same ``u``, ``flag``, ``iters`` and ``normr_hist`` bit for bit:
  both are the same float64 numpy operations in the same order on equal
  arrays, so no tolerance is needed.  Against the port's direct float64
  ``Solver`` (another loop with its own stagnation checks and reduction
  order) the iterations agree within +-1.
* ``obs/schema.py``'s bench half: the same ``validate_bench_line`` and
  ``validate_bench_text`` errors as JAX's, on good and bad lines and on
  the committed ``BENCH_r*.json``.
* ``bench.py``'s pieces in process against JAX's own functions:
  ``_ladder`` over the env specs of JAX's ``tests/test_bench_harness.py``
  (its provisional cases have no port), ``_result_json`` (the same line
  but for ``tpu_ms_per_iter`` -> ``ms_per_iter``, ``detail.platform``,
  ``detail.device`` and ``detail.phases``), ``_predict_ms_per_iter`` on
  CPU details (equal floats: the same cost tables), the model cache's
  key, eviction and stale-tmp sweep.
* end to end on the CPU: one ``BENCH_FORCE_CPU=1`` child at 4^3 prints
  exactly one valid line, flag 0, the JAX ``Solver``'s iterations on the
  same model and config, a live baseline; without a card and without
  ``BENCH_FORCE_CPU`` the bench prints the sentinel and exits 1, as it
  does when the live baseline or the last rung fails.
* the serve leg (``BENCH_SERVE=1``) at 3x3x3, 4 jobs, widths 1 and 2:
  one valid line, the block counts of JAX's packer, nothing shed.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from pcg_mpi_solver_tpu import bench as jbench
from pcg_mpi_solver_tpu import RunConfig as JaxRunConfig
from pcg_mpi_solver_tpu import SolverConfig as JaxSolverConfig
from pcg_mpi_solver_tpu import TimeHistoryConfig as JaxTimeHistoryConfig
from pcg_mpi_solver_tpu.models import make_cube_model as jax_cube
from pcg_mpi_solver_tpu.models.octree import make_octree_model as jax_octree
from pcg_mpi_solver_tpu.obs import schema as jschema
from pcg_mpi_solver_tpu.parallel.mesh import make_mesh
from pcg_mpi_solver_tpu.serve.packer import pick_width as jax_pick_width
from pcg_mpi_solver_tpu.solver import Solver as JaxSolver
from pcg_mpi_solver_tpu.solver.driver import StepResult as JaxStepResult
from pcg_mpi_solver_tpu.solver.numpy_ref import (
    NumpyRefSolver as JaxNumpyRefSolver)
from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig
from pcg_mpi_solver_tpu_torch import bench
from pcg_mpi_solver_tpu_torch.models import make_cube_model, make_octree_model
from pcg_mpi_solver_tpu_torch.obs import schema
from pcg_mpi_solver_tpu_torch.solver import Solver, StepResult
from pcg_mpi_solver_tpu_torch.solver.numpy_ref import NumpyRefSolver

ROOT = Path(__file__).resolve().parents[1]

# the bench's model arguments (bench._build_model)
CUBE_KW = dict(E=30e9, nu=0.2, load="traction", load_value=1e6,
               heterogeneous=True)
OCTREE_KW = dict(n_incl=6, seed=2, E=30e9, nu=0.2, load="traction",
                 load_value=1e6)


def _clear_bench_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("BENCH_") or k.startswith("PCG_TPU_"):
            monkeypatch.delenv(k, raising=False)


# ----------------------------------------------------------------------
# solver/numpy_ref.py
# ----------------------------------------------------------------------

def _models(kind, n):
    if kind == "cube":
        return (make_cube_model(n, n, n, **CUBE_KW),
                jax_cube(n, n, n, **CUBE_KW))
    kw = dict(nx0=n, ny0=n, nz0=n, max_level=2, **OCTREE_KW)
    return make_octree_model(**kw), jax_octree(**kw)


@pytest.mark.parametrize("kind,n", [("cube", 3), ("octree", 2),
                                    ("octree", 3)])
def test_numpy_ref_matches_jax_bitwise(kind, n):
    tm, jm = _models(kind, n)
    t = NumpyRefSolver(tm).solve(tol=1e-8, max_iter=5000)
    j = JaxNumpyRefSolver(jm).solve(tol=1e-8, max_iter=5000)
    assert (t.flag, t.iters) == (j.flag, j.iters)
    assert t.flag == 0 and t.iters > 5
    assert np.array_equal(t.u, j.u)
    assert np.array_equal(t.normr_hist, j.normr_hist)
    assert t.relres == j.relres
    x = np.linspace(-1.0, 1.0, tm.n_dof)
    assert np.array_equal(NumpyRefSolver(tm).matvec(x),
                          JaxNumpyRefSolver(jm).matvec(x))


@pytest.mark.parametrize("kind,n", [("cube", 3), ("octree", 2)])
def test_numpy_ref_iterations_match_port_solver(kind, n):
    """The reference loop and the port's direct float64 Solver on the CPU
    take the same iterations within +-1 (their norms are summed in other
    orders); max_iter stays below n_eff - 5 (MATLAB's MoreSteps budget)."""
    tm, _ = _models(kind, n)
    ref = NumpyRefSolver(tm).solve(tol=1e-8, max_iter=5000)
    s = Solver(tm, RunConfig(solver=SolverConfig(
        tol=1e-8, max_iter=min(5000, len(tm.dof_eff) - 6),
        precision_mode="direct", dtype="float64")), device="cpu")
    r = s.step(1.0)
    assert r.flag == ref.flag == 0
    assert abs(r.iters - ref.iters) <= 1, (r.iters, ref.iters)
    u = s.displacement_global()
    assert np.max(np.abs(u - ref.u)) <= 1e-6 * np.max(np.abs(ref.u))


# ----------------------------------------------------------------------
# obs/schema.py, the bench half
# ----------------------------------------------------------------------

_GOOD = {"schema": "pcg-tpu-bench/1", "metric": "m", "value": 1.5,
         "unit": "u", "vs_baseline": 2.0,
         "detail": {"setup_s": 1.0, "time_to_first_iter_s": None,
                    "setup_cache": "warm", "pcg_variant": "fused",
                    "nrhs": 4, "jobs_shed": 0}}

BENCH_LINES = [
    _GOOD,
    {k: v for k, v in _GOOD.items() if k != "schema"},       # legacy
    {k: v for k, v in _GOOD.items() if k != "unit"},
    {k: v for k, v in _GOOD.items() if k not in ("metric", "value")},
    dict(_GOOD, value="fast"),
    dict(_GOOD, schema="pcg-tpu-bench/9"),
    dict(_GOOD, detail=dict(_GOOD["detail"], setup_s="1.0")),
    dict(_GOOD, detail=dict(_GOOD["detail"], setup_cache="hot")),
    dict(_GOOD, detail=dict(_GOOD["detail"], pcg_variant="cg")),
    dict(_GOOD, detail=dict(_GOOD["detail"], jobs_per_s=[1])),
    dict(_GOOD, detail="not a dict"),
    ["not", "an", "object"],
    json.loads(bench._error_line("boom")),
]


@pytest.mark.parametrize("i", range(len(BENCH_LINES)))
def test_validate_bench_line_matches_jax(i):
    line = BENCH_LINES[i]
    errs = schema.validate_bench_line(line)
    assert errs == jschema.validate_bench_line(line)
    # a non-object detail carries no typed field: valid in both packages
    assert (errs == []) == (i in (0, 1, 10, 12)), errs
    text = json.dumps(line)
    assert schema.validate_bench_text(text) == \
        jschema.validate_bench_text(text)


def test_validate_bench_text_committed_artifacts():
    paths = sorted(ROOT.glob("BENCH_r*.json"))
    assert len(paths) >= 5
    for p in paths:
        text = p.read_text()
        assert schema.validate_bench_text(text) == \
            jschema.validate_bench_text(text) == [], p
    failed = json.dumps({"n": 1, "cmd": "x", "rc": 1, "tail": "",
                         "parsed": None})
    assert schema.validate_bench_text(failed) == []
    assert schema.validate_bench_text("{") == \
        jschema.validate_bench_text("{")
    assert schema.BENCH_DETAIL_NUMERIC == jschema.BENCH_DETAIL_NUMERIC
    assert schema.BENCH_SCHEMA == jschema.BENCH_SCHEMA


# ----------------------------------------------------------------------
# bench.py's pieces against JAX's own functions
# ----------------------------------------------------------------------

# (env, kind, cpu_fallback): tests/test_bench_harness.py's ladder cases
LADDER_CASES = [
    ({}, "cube", False),
    ({"BENCH_LADDER": "100,50", "BENCH_NX": "64"}, "cube", False),
    ({"BENCH_LADDER": " 100 , 50 , "}, "cube", False),
    ({"BENCH_OT_LADDER": "14,8", "BENCH_OT_N": "10",
      "BENCH_OT_LEVEL": "3"}, "octree", False),
    ({}, "octree", False),
    ({"BENCH_NX": "150", "BENCH_NY": "150", "BENCH_NZ": "150"}, "cube",
     True),
    ({"BENCH_OT_N": "22"}, "octree", True),
    ({"BENCH_NX": "64", "BENCH_NZ": "32"}, "cube", False),
    ({"BENCH_CPU_NX": "4"}, "cube", True),
]


@pytest.mark.parametrize("i", range(len(LADDER_CASES)))
def test_ladder_matches_jax(monkeypatch, i):
    env, kind, cpu = LADDER_CASES[i]
    _clear_bench_env(monkeypatch)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert bench._ladder(kind, cpu) == jbench._ladder(kind, cpu)


def test_ladder_sloppy_spec_raises_like_jax(monkeypatch):
    _clear_bench_env(monkeypatch)
    monkeypatch.setenv("BENCH_LADDER", ",,")
    for mod in (bench, jbench):
        with pytest.raises(ValueError, match="no sizes"):
            mod._ladder("cube", False)


def _common_extra():
    return {"dtype": "float32", "mode": "mixed", "backend": "structured",
            "pcg_variant": "classic", "precond": "jacobi", "pallas": True,
            "matvec_form": "n/a", "combine": "n/a", "nrhs": 1,
            "n_parts": 1, "partition_s": 1.5, "setup_s": 2.0,
            "setup_cache": "off", "time_to_first_iter_s": 3.0,
            "baseline_source": "measured-live"}


@pytest.mark.parametrize("flag,nrhs", [(0, 1), (1, 1), (0, 4)])
def test_result_json_matches_jax(flag, nrhs):
    model = make_cube_model(3, 3, 3, **CUBE_KW)
    assert model.n_dof == jax_cube(3, 3, 3, **CUBE_KW).n_dof
    extra = dict(_common_extra(), nrhs=nrhs)
    t = json.loads(bench._result_json(
        model, "cube", StepResult(flag=flag, relres=3e-8, iters=41,
                                  wall_s=0.25),
        41, 198.1137, "same model",
        dict(extra, platform="cpu", device="cpu")))
    j = json.loads(jbench._result_json(
        model, "cube", JaxStepResult(flag=flag, relres=3e-8, iters=41,
                                     wall_s=0.25),
        41, 198.1137, "same model", dict(extra, platform="cpu")))
    assert schema.validate_bench_line(t) == []
    td, jd = t.pop("detail"), j.pop("detail")
    assert t == j
    assert td.pop("ms_per_iter") == jd.pop("tpu_ms_per_iter")
    assert td.pop("device") == "cpu"
    assert td.pop("platform") == jd.pop("platform") == "cpu"
    td.pop("phases"), jd.pop("phases")
    assert td == jd
    assert (td["time_to_tol_s"] is None) == (flag != 0)
    assert td["dof_iter_rhs_per_s"] == pytest.approx(
        t["value"] * nrhs, rel=1e-9)


DETAILS = [
    {"n_dof": 10_328_853, "mode": "mixed", "backend": "structured",
     "platform": "cpu"},
    {"n_dof": 375, "mode": "direct", "dtype": "float64",
     "backend": "structured", "platform": "cpu", "precond": "mg"},
    {"n_dof": 5_670_981, "mode": "mixed", "backend": "general",
     "platform": "cpu", "pcg_variant": "pipelined", "nrhs": 8,
     "n_parts": 4},
    {"n_dof": 192, "mode": "direct", "backend": "general",
     "platform": "cpu (CPU FALLBACK)", "pcg_variant": "fused",
     "precond": "block3"},
    {"mode": "mixed", "platform": "cpu"},                   # no n_dof
]


@pytest.mark.parametrize("i", range(len(DETAILS)))
def test_predict_ms_per_iter_matches_jax(i):
    d = DETAILS[i]
    got = bench._predict_ms_per_iter(d)
    assert got == jbench._predict_ms_per_iter(d)
    assert (got is None) == ("n_dof" not in d)


def test_predict_ms_per_iter_unknown_variant_raises():
    d = dict(DETAILS[0], pcg_variant="cgs")
    for mod in (bench, jbench):
        with pytest.raises(KeyError):
            mod._predict_ms_per_iter(d)


def test_model_cache_key_stable():
    kw = dict(nx=4, ny=4, nz=4, E=30e9, heterogeneous=True)
    k = bench._model_cache_key("cube", kw)
    assert k == bench._model_cache_key("cube", dict(reversed(kw.items())))
    assert len(k) == 16
    assert k != bench._model_cache_key("cube", dict(kw, nx=5))
    assert k != bench._model_cache_key("octree", kw)


def test_cached_model_roundtrip(monkeypatch, tmp_path):
    monkeypatch.setattr(bench, "REPO", str(tmp_path))
    monkeypatch.setenv("BENCH_MODEL_CACHE", "1")
    a = bench._build_model("cube", 3, 3, 3, 0, 0)
    files = os.listdir(tmp_path / ".bench_cache")
    assert len(files) == 1 and files[0].startswith("model_")
    b = bench._build_model("cube", 3, 3, 3, 0, 0)
    assert np.array_equal(a.ck, b.ck) and np.array_equal(a.F, b.F)
    assert a.n_dof == jax_cube(3, 3, 3, **CUBE_KW).n_dof


@pytest.mark.parametrize("mod", [bench, jbench], ids=["port", "jax"])
def test_model_cache_eviction(tmp_path, mod):
    """tests/test_bench_harness.py's eviction case, on both packages:
    the cache fits the cap, the kept entry survives, oldest go first."""
    d = str(tmp_path)
    for i, sz in enumerate([100, 200, 300]):
        p = os.path.join(d, f"model_{i}.pkl")
        with open(p, "wb") as f:
            f.write(b"x" * sz)
        os.utime(p, (time.time() - 100 + i,) * 2)
    keep = os.path.join(d, "model_2.pkl")
    mod._evict_model_cache(d, keep=keep, cap_bytes=550)
    assert sorted(os.listdir(d)) == ["model_1.pkl", "model_2.pkl"]
    mod._evict_model_cache(d, keep=keep, cap_bytes=50)
    assert sorted(os.listdir(d)) == ["model_2.pkl"]


@pytest.mark.parametrize("mod", [bench, jbench], ids=["port", "jax"])
def test_sweep_stale_tmps(tmp_path, mod):
    d = str(tmp_path)
    old = os.path.join(d, "model_dead.tmp")
    fresh = os.path.join(d, "model_live.tmp")
    for p in (old, fresh):
        with open(p, "wb") as f:
            f.write(b"x")
    os.utime(old, (time.time() - 7200,) * 2)
    mod._sweep_stale_tmps(d)
    assert sorted(os.listdir(d)) == ["model_live.tmp"]


def test_error_line_is_a_sentinel():
    d = json.loads(bench._error_line("boom"))
    j = json.loads(jbench._error_line("boom"))
    assert d["value"] == d["vs_baseline"] == 0.0
    assert d["detail"]["error"] == j["detail"]["error"] == "boom"
    assert {k: v for k, v in d.items() if k != "detail"} == \
        {k: v for k, v in j.items() if k != "detail"}


# ----------------------------------------------------------------------
# end to end on the CPU, and no fallback
# ----------------------------------------------------------------------

E2E_ENV = {"BENCH_FORCE_CPU": "1", "BENCH_CPU_NX": "4",
           "BENCH_MODE": "direct", "BENCH_DTYPE": "float64",
           "BENCH_PARTS": "1", "BENCH_REF_MAX_DOFS": "1000",
           "BENCH_REF_ITERS": "3", "BENCH_MODEL_CACHE": "0"}


def test_bench_end_to_end_cpu(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BENCH_", "PCG_TPU_"))}
    env.update(E2E_ENV, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-m", "pcg_mpi_solver_tpu_torch.bench"],
        cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, out.stdout
    line = json.loads(lines[0])
    assert schema.validate_bench_line(line) == []
    d = line["detail"]
    assert line["metric"] == "pcg_dof_iterations_per_second"
    assert line["value"] > 0 and line["vs_baseline"] > 0
    assert d["flag"] == 0 and d["relres"] <= 1e-7
    assert d["platform"] == "cpu" and d["device"] == "cpu"
    assert d["baseline_source"] == "measured-live"
    assert d["ref_measured_on"] == "same model"
    assert d["n_dof"] == 375 and d["backend"] == "structured"
    assert "ms_per_iter" in d and "tpu_ms_per_iter" not in d
    assert "# launches: {" in out.stderr
    # the JAX package's Solver on the same model and config
    js = JaxSolver(jax_cube(4, 4, 4, **CUBE_KW),
                   JaxRunConfig(solver=JaxSolverConfig(
                       tol=1e-7, max_iter=20000, dtype="float64",
                       dot_dtype="float64", precision_mode="direct"),
                       time_history=JaxTimeHistoryConfig(
                           time_step_delta=[0.0, 1.0])),
                   mesh=make_mesh(1), n_parts=1)
    r = js.step(1.0)
    assert r.flag == 0 and d["iters"] == r.iters
    assert (tmp_path / "bench_flight.jsonl").exists()


def _run_main(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_FLIGHT", "0")
    with pytest.raises(SystemExit) as err:
        bench.main()
    out = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    return err.value.code, out


def test_no_card_no_fallback(monkeypatch, capsys, tmp_path):
    """Without a CUDA device and without BENCH_FORCE_CPU the bench prints
    the sentinel and exits 1: no CPU number takes the card's place."""
    _clear_bench_env(monkeypatch)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code, out = _run_main(monkeypatch, capsys)
    assert code == 1 and len(out) == 1
    d = json.loads(out[0])
    assert d["value"] == 0.0 and "no CUDA device" in d["detail"]["error"]


def test_failed_live_baseline_is_a_failure(monkeypatch, capsys, tmp_path):
    _clear_bench_env(monkeypatch)
    monkeypatch.chdir(tmp_path)
    for k, v in E2E_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(bench, "_live_baseline", lambda *a, **k: None)
    code, out = _run_main(monkeypatch, capsys)
    assert code == 1 and len(out) == 1
    d = json.loads(out[0])
    assert d["value"] == 0.0 and "baseline" in d["detail"]["error"]


def test_ladder_steps_down_and_last_rung_fails(monkeypatch, capsys,
                                                tmp_path):
    """A failed rung steps down to the next one (logged); a failed last
    rung is the run's failure: the sentinel and exit 1."""
    _clear_bench_env(monkeypatch)
    monkeypatch.chdir(tmp_path)
    for k, v in E2E_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(bench, "_ladder",
                        lambda kind, cpu_fallback: [(5, 5, 5, 0, 0),
                                                    (4, 4, 4, 0, 0)])
    solve_once = bench._solve_once
    seen = []

    def flaky(kind, nx, *a):
        seen.append(nx)
        if nx == 5:
            raise RuntimeError("rung too big")
        return solve_once(kind, nx, *a)

    monkeypatch.setattr(bench, "_solve_once", flaky)
    monkeypatch.setattr(bench, "_live_baseline",
                        lambda *a, **k: (150.0, "same model"))
    line = json.loads(bench._run_bench("cpu"))
    assert seen == [5, 4] and line["detail"]["n_dof"] == 375
    assert "ladder rung 0 failed" in capsys.readouterr().err

    def broken(*a):
        raise RuntimeError("kernel did not launch")

    monkeypatch.setattr(bench, "_solve_once", broken)
    code, out = _run_main(monkeypatch, capsys)
    assert code == 1 and len(out) == 1
    assert "kernel did not launch" in json.loads(out[0])["detail"]["error"]


def test_bench_blocked_and_profiled_cpu(monkeypatch, tmp_path):
    """BENCH_NRHS=2 times a width-2 block through solve_many (the line's
    dof*iter*rhs/s is twice its value) and BENCH_PROFILE=1 adds the
    profiled warm solve's matvec ms/iter, in process on the CPU."""
    _clear_bench_env(monkeypatch)
    monkeypatch.chdir(tmp_path)
    for k, v in dict(E2E_ENV, BENCH_NRHS="2", BENCH_PROFILE="1",
                     BENCH_PROFILE_DIR=str(tmp_path / "prof")).items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(bench, "_live_baseline",
                        lambda *a, **k: (150.0, "same model"))
    line = json.loads(bench._run_bench("cpu"))
    d = line["detail"]
    assert schema.validate_bench_line(line) == []
    assert d["nrhs"] == 2 and d["flag"] == 0
    assert d["dof_iter_rhs_per_s"] == pytest.approx(2 * line["value"],
                                                    rel=1e-6)
    assert d["nrhs_quarantined"] == d["nrhs_recoveries"] == 0
    assert d["measured_ms_per_iter_matvec"] > 0
    assert "profile_capture" in d["phases"]


# ----------------------------------------------------------------------
# the serve leg
# ----------------------------------------------------------------------

def _jax_blocks(n_jobs, widths):
    left, blocks = n_jobs, 0
    while left > 0:
        left -= jax_pick_width(left, widths)
        blocks += 1
    return blocks


def test_serve_bench_cpu(monkeypatch, capsys, tmp_path):
    _clear_bench_env(monkeypatch)
    monkeypatch.chdir(tmp_path)
    for k, v in {"BENCH_SERVE": "1", "BENCH_FORCE_CPU": "1",
                 "BENCH_SERVE_NX": "3,3,3", "BENCH_SERVE_JOBS": "4",
                 "BENCH_SERVE_WIDTHS": "1,2",
                 "BENCH_SERVE_OUT": str(tmp_path / "serve.json")}.items():
        monkeypatch.setenv(k, v)
    code, out = _run_main(monkeypatch, capsys)
    assert code == 0 and len(out) == 1
    line = json.loads(out[0])
    assert schema.validate_bench_line(line) == []
    assert json.loads((tmp_path / "serve.json").read_text()) == line
    d = line["detail"]
    assert line["metric"] == "serve_jobs_per_s" and line["value"] > 0
    assert d["jobs_shed"] == 0 and d["jobs_failed"] == 0
    assert d["blocks"] == _jax_blocks(4, (1, 2)) == 2
    assert d["blocks_serial"] == _jax_blocks(4, (1,)) == 4
    assert d["nrhs"] == 2 and d["n_dof"] == 192
    assert d["platform"] == "cpu" and d["backend"] == "general"

"""The port's command line (``python -m pcg_mpi_solver_tpu_torch.cli``) on
the CPU: the JAX package's ``tests/test_cli.py`` cases with ``--device
cpu`` (ingest -> partition -> solve -> export on a model written in the
reference's MDF format, the cube, Poisson and octree demos, the speed
test, the backend flag), a bundle the JAX package wrote, one run as a
subprocess, and every subcommand the port does not have yet refused with
its ROADMAP queue 1 item.  The service subcommands (``submit``, ``serve
--device cpu``, ``jobs``, ``watch --once``) drive a spool end to end,
``jobs`` and ``watch`` printing what the JAX package's print; ``validate``
prints JAX's checks on one bundle; ``warmup`` fills the cache the later
solve reads, and ``Solver.warmup`` leaves a solve bitwise.  The observability subcommands (``summary``,
``telemetry-merge``, ``perf-report``, ``prof-report``) and the per-run
telemetry flags run against the JAX package's CLI where both read the
same files.

The time-history subcommands run on an ingested 4x3x3 bundle against the
JAX package's CLI on the same scratch directory (2 parts): ``dynamics``
(25 steps at half the CFL dt, damping 0.05, probes 6 and 13) within rtol
1e-9 and atol 1e-12 * max|u| of JAX's ``u_dynamics.npy`` and
``probe_dynamics.npy``; ``newmark`` (5 steps, dt 0.2, damping 0.1, tol
1e-12, direct) with iterations per step within +-1 and ``u_newmark.npy``
within 1e-9 * max|u|; both killed at a step by ``PCG_TPU_FAULTS`` and
continued with ``--resume``, bitwise the uninterrupted run."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pcg_mpi_solver_tpu.cli import main as jax_main
from pcg_mpi_solver_tpu.models.mdf import write_mdf as jax_write_mdf
from pcg_mpi_solver_tpu.models.synthetic import make_cube_model as jax_cube
from pcg_mpi_solver_tpu_torch.cli import REFUSED, main
from pcg_mpi_solver_tpu_torch.models import make_cube_model, make_octree_model
from pcg_mpi_solver_tpu_torch.models.mdf import read_mdf, write_mdf
from pcg_mpi_solver_tpu_torch.resilience import SimulatedKill
from pcg_mpi_solver_tpu_torch.solver import stable_dt

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]


def _bundle(tmp_path, model, write=write_mdf):
    src = tmp_path / "src"
    write(model, str(src))
    archive = shutil.make_archive(str(tmp_path / "model"), "zip", src)
    return archive, str(tmp_path / "scratch")


def test_cli_full_pipeline(tmp_path, capsys):
    model = make_cube_model(4, 4, 4, load="traction", heterogeneous=True)
    archive, scratch = _bundle(tmp_path, model)
    main(["ingest", archive, scratch])
    out = capsys.readouterr().out
    assert f">dofs:      {model.n_dof}" in out
    main(["partition", scratch, "2"])
    assert os.path.exists(f"{scratch}/ModelData/MeshPart_2.npy")
    main(["solve", scratch, "1", "--n-parts", "2", "--tol", "1e-8",
          "--precision", "direct"] + CPU)
    out = capsys.readouterr().out
    assert "flag=0" in out and ">success!" in out
    assert os.path.exists(f"{scratch}/Results_Run1/ResVecData/U_1.npy")
    main(["export", scratch, "1", "U", "Full"])
    out = capsys.readouterr().out
    assert "vtu files" in out
    assert os.path.exists(f"{scratch}/Results_Run1/VTKs/VTKInfo.txt")


def test_cli_solves_a_bundle_the_jax_package_wrote(tmp_path, capsys):
    """A JAX-written bundle, nodal fields included, through the port's
    ingest, slab2 partition, solve (settings file) and export."""
    archive, scratch = _bundle(tmp_path, jax_cube(6, 4, 4, seed=1,
                                                  heterogeneous=True),
                               write=jax_write_mdf)
    settings = tmp_path / "settings.json"
    settings.write_text('{"TimeHistoryParam": {"ExportVars": "U PS ES", '
                        '"TimeStepDelta": [0.0, 0.5, 1.0]}, '
                        '"SolverParam": {"Tol": 1e-9}}')
    main(["ingest", archive, scratch])
    main(["partition", scratch, "2", "--method", "slab2"])
    main(["solve", scratch, "7", "--n-parts", "2", "--settings",
          str(settings)] + CPU)
    out = capsys.readouterr().out
    assert out.count("flag=0") == 2 and ">success!" in out
    main(["export", scratch, "7", "U PS1 ES", "Boundary"])
    out = capsys.readouterr().out
    assert ">wrote 3 vtu files" in out
    res = f"{scratch}/Results_Run7/ResVecData"
    assert np.load(f"{res}/PS1_2.npy").shape == np.load(
        f"{res}/NodeId.npy").shape


def test_cli_demo(tmp_path, capsys):
    main(["demo", "--nx", "4", "--scratch", str(tmp_path / "s"),
          "--tol", "1e-7", "--precision", "direct"] + CPU)
    out = capsys.readouterr().out
    assert ">success!" in out and "flag=0" in out


def test_cli_poisson_demo(tmp_path, capsys):
    main(["demo", "--poisson", "--nx", "4", "--scratch", str(tmp_path / "s"),
          "--tol", "1e-8", "--precision", "direct"] + CPU)
    out = capsys.readouterr().out
    assert ">success!" in out and "flag=0" in out and "scalar" in out


def test_cli_speed_test_no_exports(tmp_path, capsys):
    archive, scratch = _bundle(tmp_path, make_cube_model(4, 4, 4))
    main(["ingest", archive, scratch])
    main(["solve", scratch, "2", "--n-parts", "1", "--speed-test",
          "--precision", "direct"] + CPU)
    capsys.readouterr()
    assert not os.path.exists(
        f"{scratch}/Results_Run2_SpeedTest/ResVecData/U_1.npy")


def test_cli_octree_demo(tmp_path, capsys):
    main(["demo", "--octree", "--nx", "2", "--max-level", "2",
          "--scratch", str(tmp_path / "sc"), "--max-iter", "2000"] + CPU)
    out = capsys.readouterr().out
    assert "pattern types" in out
    assert "[hybrid backend]" in out
    assert "flag=0" in out and ">success!" in out


def test_cli_solve_backend_flag(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("PCG_TPU_ENABLE_HYBRID", "1")   # auto->hybrid gate
    model = make_octree_model(2, 2, 2, max_level=2, n_incl=2, seed=3)
    archive, scratch = _bundle(tmp_path, model)
    main(["ingest", archive, scratch])
    # the sidecar survives ingest -> auto resolves hybrid; the flag can
    # force the general path
    main(["solve", scratch, "3", "--n-parts", "4", "--precision",
          "direct"] + CPU)
    out = capsys.readouterr().out
    assert ">backend: hybrid" in out and "flag=0" in out
    main(["solve", scratch, "4", "--n-parts", "4", "--backend", "general",
          "--precision", "direct"] + CPU)
    out = capsys.readouterr().out
    assert ">backend: general" in out and "flag=0" in out


def test_cli_solve_many(tmp_path, capsys):
    archive, scratch = _bundle(tmp_path, make_cube_model(4, 3, 3,
                                                         heterogeneous=True))
    main(["ingest", archive, scratch])
    main(["solve-many", scratch, "5", "--scales", "1.0,0.5", "--tol",
          "1e-8"] + CPU)
    out = capsys.readouterr().out
    assert out.count("flag=0") == 2 and ">success!" in out
    u = np.load(f"{scratch}/Results_Run5/u_many.npy")
    np.testing.assert_array_equal(u[:, 1] * 2, u[:, 0])


def test_cli_runs_as_a_module(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "pcg_mpi_solver_tpu_torch.cli", "demo",
         "--nx", "3", "--scratch", str(tmp_path / "s"), "--precision",
         "direct", "--device", "cpu"], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "flag=0" in out.stdout and ">success!" in out.stdout


@pytest.mark.parametrize("cmd", sorted(set(REFUSED) | {"fleet-report",
                                                      "lint"}))
def test_unported_subcommands_name_their_item(cmd, tmp_path, capsys):
    """The subcommands still refused name their ROADMAP queue 1 item;
    ``fleet-report`` (item 12, once refused) reads a capture root, and an
    empty one is a named degraded verdict with exit status 2; ``lint``
    (item 14, once refused) lists the JAX package's rule ids and runs
    clean on the CPU, its trip rules recorded by two gloo ranks."""
    if cmd == "lint":
        main([cmd, "--list-rules"])
        ids = {ln.split()[0] for ln in capsys.readouterr().out.splitlines()}
        assert len(ids) == 15 and "collective-budget" in ids
        main([cmd, "--fast", "--device", "cpu"])       # exit 0: returns
        out = capsys.readouterr().out
        assert "12 rule(s), 0 error(s)" in out, out
        assert "0 engine error(s)" in out, out
        return
    if cmd == "fleet-report":
        with pytest.raises(SystemExit) as err:
            main([cmd, str(tmp_path)])
        assert err.value.code == 2
        assert "verdict: degraded" in capsys.readouterr().out
        return
    with pytest.raises(NotImplementedError,
                       match=rf"{cmd}.*ROADMAP queue 1 item "
                             rf"{REFUSED[cmd]}\b"):
        main([cmd, "--spool", "x", "some", "args"])


@pytest.mark.parametrize("argv,item", [
    (["solve", "{scratch}", "1", "--resume-elastic"], 12),
])
def test_unported_flags_name_their_item(tmp_path, capsys, argv, item):
    """``--resume-elastic`` (ROADMAP queue 1 item ``item``, once refused)
    resumes a checkpointed run: here on the process count that wrote it,
    so the elastic path restores the last step and runs nothing more."""
    assert item == 12
    archive, scratch = _bundle(tmp_path, make_cube_model(3, 3, 3))
    main(["ingest", archive, scratch])
    main(["solve", scratch, "1", "--checkpoint-every", "1"] + CPU)
    capsys.readouterr()
    main([a.format(scratch=scratch) for a in argv] + CPU)
    assert ">success!" in capsys.readouterr().out
    assert len(REFUSED) == 2 and set(REFUSED.values()) == {1}


# ----------------------------------------------------------------------
# the service and operator subcommands: serve, submit, jobs, watch,
# validate, warmup
# ----------------------------------------------------------------------

def _submit_three(spool):
    """The CPU drive's three jobs: two tenants and one deadline no cost
    model can meet."""
    for argv in (["--scale", "1.0", "--job-id", "tenant-a"],
                 ["--scale", "2.0", "--job-id", "tenant-b"],
                 ["--scale", "1.0", "--deadline-s", "1e-7", "--job-id",
                  "rush"]):
        main(["submit", "--spool", spool] + argv)


@pytest.fixture
def served(tmp_path, capsys, monkeypatch):
    """``submit`` three jobs and ``serve --device cpu`` them (``exc@job:1``
    fails tenant-b by name) until idle: (spool, serve's output)."""
    import signal

    spool = str(tmp_path / "spool")
    _submit_three(spool)
    capsys.readouterr()
    monkeypatch.setenv("PCG_TPU_FAULTS", "exc@job:1")
    handler = signal.getsignal(signal.SIGTERM)
    try:
        main(["serve", "--spool", spool, "--synthetic", "6,5,5",
              "--widths", "1,2,4", "--idle-exit-s", "0.5", "--n-parts", "2",
              "--poll-s", "0.01"] + CPU)
    finally:
        signal.signal(signal.SIGTERM, handler)
    return spool, capsys.readouterr().out


def test_cli_submit(tmp_path, capsys):
    """``submit`` drops an atomic spec the JAX package's spool reader
    lists; a spec with neither --scale nor --rhs exits by name."""
    from pcg_mpi_solver_tpu.serve import jobs as jax_jobs

    spool = str(tmp_path / "spool")
    _submit_three(spool)
    out = capsys.readouterr().out
    assert out.count(">submitted") == 3 and "tenant-a" in out
    listed = [spec["job"] for _p, spec in jax_jobs.list_incoming(spool)]
    assert listed == ["tenant-a", "tenant-b", "rush"]
    with pytest.raises(SystemExit, match="exactly one of scale / rhs"):
        main(["submit", "--spool", spool])


def test_cli_serve(served):
    """The daemon serves tenant-a (a solution column), fails tenant-b by
    the injected fault's name, rejects rush at the door, and drains."""
    from pcg_mpi_solver_tpu_torch.serve import jobs as sjobs

    spool, out = served
    assert ">serve: drained (idle) — 1 done, 1 failed" in out
    assert ">success!" in out and "backend=structured" in out
    a = sjobs.read_result(spool, "tenant-a")
    assert a["ok"] and a["verdict"] == "converged" and a["flag"] == 0
    assert np.isfinite(np.load(sjobs.solution_path(spool, "tenant-a"))).all()
    assert sjobs.read_result(spool, "tenant-b")["verdict"].startswith(
        "injected: ")
    assert sjobs.read_result(spool, "rush")["verdict"] == \
        "rejected: deadline_infeasible"


def test_cli_jobs_matches_jax(served, capsys):
    """``jobs`` prints the JAX package's table of the same journal."""
    spool, _out = served
    main(["jobs", "--spool", spool])
    ours = capsys.readouterr().out
    jax_main(["jobs", "--spool", spool])
    assert ours == capsys.readouterr().out
    assert ">3 job(s), 3 terminal, 0 in flight" in ours
    with pytest.raises(SystemExit, match="no journal"):
        main(["jobs", "--spool", spool + "-none"])


def test_cli_watch_once_matches_jax(served, capsys):
    """``watch --once`` on the drained journal: DONE with the serve
    counts, as JAX's watch prints (clock lines apart), exit 0."""
    spool, _out = served
    path = os.path.join(spool, "journal.jsonl")
    main(["watch", path, "--once"])
    ours = capsys.readouterr().out
    jax_main(["watch", path, "--once"])
    theirs = capsys.readouterr().out

    def steady(text):
        return [ln for ln in text.splitlines() if " ago" not in ln]

    assert steady(ours) == steady(theirs)
    assert "status: DONE" in ours and "serve drained (idle)" in ours
    assert "done=1" in ours and "failed=1" in ours and "rejected=1" in ours


@pytest.mark.parametrize("argv", [
    [], ["--precision", "mixed", "--tol", "1e-12"],
    ["--preflight", "warn", "--tol", "1e-20"],
    ["--preflight", "off"]])
def test_cli_validate_matches_jax(tmp_path, capsys, argv):
    """``validate`` on one JAX-written MDF bundle: the JAX package's check
    names, statuses and details line for line, under each policy."""
    archive, scratch = _bundle(tmp_path, jax_cube(4, 3, 3, seed=1,
                                                  heterogeneous=True),
                               write=jax_write_mdf)
    main(["ingest", archive, scratch])
    capsys.readouterr()
    main(["validate", scratch] + argv)
    ours = capsys.readouterr().out
    jax_main(["validate", scratch] + argv)
    assert ours == capsys.readouterr().out
    assert ">preflight:" in ours or "policy is off" in ours


def test_cli_validate_fails_a_bad_model_as_jax(tmp_path, capsys):
    model = jax_cube(4, 3, 3, heterogeneous=True)
    model.F[5] = np.nan
    archive, scratch = _bundle(tmp_path, model, write=jax_write_mdf)
    main(["ingest", archive, scratch])
    capsys.readouterr()
    with pytest.raises(SystemExit) as ours:
        main(["validate", scratch])
    out = capsys.readouterr().out
    with pytest.raises(SystemExit) as theirs:
        jax_main(["validate", scratch])
    assert out == capsys.readouterr().out and " FAIL" in out
    assert str(ours.value) == str(theirs.value)


def test_cli_warmup(tmp_path, capsys):
    """``warmup`` fills the cache the later solve reads (its Solver comes
    up warm); without --cache-dir it exits by name, as JAX's does."""
    from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig
    from pcg_mpi_solver_tpu_torch.solver import Solver

    archive, scratch = _bundle(tmp_path, make_cube_model(
        4, 4, 4, heterogeneous=True))
    main(["ingest", archive, scratch])
    with pytest.raises(SystemExit, match="--cache-dir"):
        main(["warmup", scratch] + CPU)
    cache = str(tmp_path / "cache")
    main(["warmup", scratch, "--cache-dir", cache, "--n-parts", "2",
          "--precision", "mixed", "--precond", "mg"] + CPU)
    out = capsys.readouterr().out
    assert "(cold partition)" in out and ">warm path ready" in out
    s = Solver(read_mdf(f"{scratch}/ModelData/MDF"), RunConfig(
        cache_dir=cache, solver=SolverConfig(precision_mode="mixed",
                                             precond="mg")),
        n_parts=2, device="cpu")
    assert s.setup_cache == "warm"


@pytest.mark.parametrize("mode,precond", [("direct", "jacobi"),
                                          ("mixed", "mg")])
def test_warmup_leaves_the_solve_bitwise(mode, precond):
    """``Solver.warmup()`` leaves ``un``, the trace ring and the history
    untouched, and a solve after it is bit for bit one without it."""
    import torch

    from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig
    from pcg_mpi_solver_tpu_torch.solver import Solver

    model = make_cube_model(8, 4, 4, heterogeneous=True)
    out = []
    for warm in (True, False):
        s = Solver(model, RunConfig(solver=SolverConfig(
            tol=1e-8, precision_mode=mode, precond=precond,
            trace_resid=16)), n_parts=2, device="cpu")
        if warm:
            un = s.un.clone()
            s.warmup()
            assert torch.equal(s.un, un) and s.last_trace is None
            assert s.flags == [] and s.iters == []
        r = s.step(1.0)
        out.append((r.flag, r.iters, r.relres, s.un.clone()))
    (fa, ia, ra, ua), (fb, ib, rb, ub) = out
    assert (fa, ia, ra) == (fb, ib, rb) and fa == 0
    assert torch.equal(ua, ub)


@pytest.fixture
def telemetry_run(tmp_path, capsys):
    """A chunked CPU solve of an ingested cube with every telemetry flag:
    (scratch, telemetry file, flight file, its printed output)."""
    archive, scratch = _bundle(tmp_path, make_cube_model(
        4, 3, 3, heterogeneous=True))
    main(["ingest", archive, scratch])
    capsys.readouterr()
    tel, fl = str(tmp_path / "run.jsonl"), str(tmp_path / "flight.jsonl")
    main(["solve", scratch, "1", "--tol", "1e-8", "--precision", "mixed",
          "--telemetry-out", tel, "--flight-out", fl, "--trace-resid", "32",
          "--summary", "--profile-spans", "--preflight", "warn",
          "--profile-dir", str(tmp_path / "prof")] + CPU)
    return scratch, tel, fl, capsys.readouterr().out


@pytest.mark.parametrize("flag", ["--telemetry-out", "--trace-resid",
                                  "--flight-out", "--summary",
                                  "--profile-spans", "--preflight",
                                  "--profile-dir"])
def test_run_flags_take_effect(telemetry_run, flag):
    """Each per-run telemetry flag shows in what the solve left behind."""
    import json

    scratch, tel, fl, out = telemetry_run
    events = [json.loads(ln) for ln in open(tel)]
    kinds = [e["kind"] for e in events]
    if flag == "--telemetry-out":
        assert kinds[-1] == "run_summary" and "step" in kinds
        assert f">telemetry: {tel}" in out
    elif flag == "--trace-resid":
        rt = [e for e in events if e["kind"] == "resid_trace"]
        assert len(rt) == 1 and len(rt[0]["normr"]) == 32
    elif flag == "--flight-out":
        from pcg_mpi_solver_tpu.obs.flight import flight_verdict_path

        assert flight_verdict_path(fl)["verdict"] == "clean"
    elif flag == "--summary":
        assert "dispatch                  calls" in out
    elif flag == "--profile-spans":
        from pcg_mpi_solver_tpu_torch.obs.profview import (
            find_trace_files, read_trace_events)

        evs, _ = read_trace_events(find_trace_files(
            os.path.join(os.path.dirname(tel), "prof"))[0])
        assert any(str(e.get("name", "")).startswith("pcg-tpu/")
                   for e in evs)
    elif flag == "--preflight":
        pre = [e for e in events if e["kind"] == "preflight"]
        assert pre and pre[0]["policy"] == "warn"
    else:
        caps = [e for e in events if e["kind"] == "profile_capture"]
        assert caps and caps[0]["source"] == "solve"


def _merge_shards(tmp_path):
    import json

    for idx in (0, 1):
        lines = [json.dumps({"schema": "pcg-tpu-telemetry/1",
                             "t": 10.0 + k + 3 * idx, "kind": "dispatch",
                             "name": "cycle", "wall_s": 0.1,
                             "cold": k == 0}) for k in range(3)]
        (tmp_path / f"m.p{idx}.jsonl").write_text("\n".join(lines) + "\n")
    return str(tmp_path / "m.jsonl")


@pytest.mark.parametrize("cmd", ["summary", "telemetry-merge",
                                 "perf-report", "prof-report"])
def test_obs_subcommands_against_jax(tmp_path, capsys, telemetry_run, cmd):
    """The four observability subcommands: summary and telemetry-merge
    print (and write) what the JAX package's print on the same files;
    perf-report prints the phase table with the cost-model column of the
    JAX package's model of the same cube; prof-report reads the solve's
    capture back, and degrades on a truncated trace as JAX's does."""
    scratch, tel, fl, _out = telemetry_run
    if cmd == "summary":
        main(["summary", tel, fl])
        ours = capsys.readouterr().out
        jax_main(["summary", tel, fl])
        assert ours == capsys.readouterr().out
        assert "flight verdict: clean" in ours
    elif cmd == "telemetry-merge":
        base = _merge_shards(tmp_path)
        for fn, out in ((main, "ours.jsonl"), (jax_main, "theirs.jsonl")):
            fn(["telemetry-merge", base, "--out", str(tmp_path / out),
                "--align", "collectives"])
        text = capsys.readouterr().out.replace("theirs", "ours")
        half = len(text) // 2
        assert text[:half] == text[half:] and "3 matched anchor" in text
        assert (tmp_path / "ours.jsonl").read_text() == \
            (tmp_path / "theirs.jsonl").read_text()
    elif cmd == "perf-report":
        from pcg_mpi_solver_tpu.models.synthetic import make_cube_model as jc
        from pcg_mpi_solver_tpu.obs import perf as jperf
        from pcg_mpi_solver_tpu.parallel.mesh import make_mesh
        from pcg_mpi_solver_tpu.solver.driver import Solver as JaxSolver

        main(["perf-report", "--nx", "4", "--reps", "1", "--inner", "2"]
             + CPU)
        out = capsys.readouterr().out
        js = JaxSolver(jc(4, 0, 0, E=30e9, nu=0.2, load="traction",
                          load_value=1e6, heterogeneous=True),
                       mesh=make_mesh(1), n_parts=1, backend="general")
        cm = jperf.cost_model(jperf.shape_from_solver(js), "classic",
                              "jacobi", 1, jperf.resolve_profile("cpu"))
        for ph in jperf.PHASES:
            row = [ln for ln in out.splitlines() if ln.startswith(ph)][0]
            assert float(row.split()[1]) == round(
                cm["phases"][ph]["model_ms"], 4)
        assert ">whole-iteration anchor" in out
    else:
        prof = os.path.join(os.path.dirname(tel), "prof")
        main(["prof-report", prof])
        out = capsys.readouterr().out
        assert "verdict:" in out and "busy:" in out
        bad = tmp_path / "cut" / "x.trace.json.gz"
        bad.parent.mkdir()
        import gzip

        with gzip.open(bad, "wt") as f:
            f.write('{"traceEvents": [{"ph": "X", ')
        main(["prof-report", str(bad)])
        ours = capsys.readouterr().out.splitlines()[-1]
        jax_main(["prof-report", str(bad)])
        assert ours == capsys.readouterr().out.splitlines()[-1]
        assert ours.startswith("verdict: degraded: truncated/invalid")


DYN_CUBE = dict(E=100.0, nu=0.25, rho=1.0, load="traction", load_value=1.0,
                heterogeneous=True)


@pytest.fixture
def time_bundle(tmp_path):
    archive, scratch = _bundle(tmp_path, make_cube_model(4, 3, 3,
                                                         **DYN_CUBE))
    main(["ingest", archive, scratch])
    dt = stable_dt(read_mdf(f"{scratch}/ModelData/MDF"), safety=0.5)
    return scratch, dt


def _dyn_args(scratch, run_id, dt):
    return ["dynamics", scratch, run_id, "--n-steps", "25", "--dt",
            repr(dt), "--damping", "0.05", "--n-parts", "2",
            "--probe-dofs", "6,13", "--export-every", "5"]


def _nm_args(scratch, run_id):
    return ["newmark", scratch, run_id, "--n-steps", "5", "--dt", "0.2",
            "--damping", "0.1", "--n-parts", "2", "--tol", "1e-12",
            "--precision", "direct"]


def _iters(out):
    return [int(line.split("iters=")[1].split()[0])
            for line in out.splitlines() if line.startswith(">step ")]


def test_cli_dynamics_matches_jax(time_bundle, capsys):
    scratch, dt = time_bundle
    jax_main(_dyn_args(scratch, "1", dt))
    main(_dyn_args(scratch, "2", dt) + CPU)
    out = capsys.readouterr().out
    assert ">backend: general" in out and ">success!" in out
    assert "(5 frames, 2 probes, 5 chunks)" in out
    for name in ("u_dynamics", "probe_dynamics"):
        want = np.load(f"{scratch}/Results_Run1/{name}.npy")
        got = np.load(f"{scratch}/Results_Run2/{name}.npy")
        np.testing.assert_allclose(got, want, rtol=1e-9,
                                   atol=1e-12 * np.abs(want).max())


def test_cli_newmark_matches_jax(time_bundle, capsys):
    scratch, _dt = time_bundle
    jax_main(_nm_args(scratch, "1"))
    it_j = _iters(capsys.readouterr().out)
    main(_nm_args(scratch, "2") + CPU)
    out = capsys.readouterr().out
    assert out.count("flag=0") == 5 and ">success!" in out
    assert len(it_j) == 5 and all(
        abs(a - b) <= 1 for a, b in zip(_iters(out), it_j))
    want = np.load(f"{scratch}/Results_Run1/u_newmark.npy")
    got = np.load(f"{scratch}/Results_Run2/u_newmark.npy")
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-9 * np.abs(want).max())


@pytest.mark.parametrize("cmd,kill,every", [("dynamics", "kill@s:10", 5),
                                            ("newmark", "kill@s:2", 1)])
def test_cli_time_snapshot_resume(time_bundle, capsys, monkeypatch, cmd,
                                  kill, every):
    scratch, dt = time_bundle

    def argv(run_id, *extra):
        base = (_dyn_args(scratch, run_id, dt) if cmd == "dynamics"
                else _nm_args(scratch, run_id))
        return base + CPU + list(extra)

    name = f"u_{cmd}"
    main(argv("1"))
    monkeypatch.setenv("PCG_TPU_FAULTS", kill)
    with pytest.raises(SimulatedKill):
        main(argv("2", "--snapshot-every", str(every)))
    assert not os.path.exists(f"{scratch}/Results_Run2/{name}.npy")
    monkeypatch.delenv("PCG_TPU_FAULTS")
    capsys.readouterr()
    main(argv("2", "--snapshot-every", str(every), "--resume"))
    out = capsys.readouterr().out
    assert ">success!" in out
    if cmd == "newmark":
        # the resumed run labels and runs steps 3..5 only
        assert ">step 3:" in out and ">step 1:" not in out
    np.testing.assert_array_equal(
        np.load(f"{scratch}/Results_Run2/{name}.npy"),
        np.load(f"{scratch}/Results_Run1/{name}.npy"))


@pytest.mark.parametrize("cmd", ["dynamics", "newmark"])
def test_time_subcommands_take_telemetry_flags(tmp_path, capsys, cmd):
    """The time-history subcommands write the telemetry stream (ending
    in the run summary, every event valid for the JAX package) and a
    clean flight file under the JAX package's flags."""
    from pcg_mpi_solver_tpu.obs.flight import flight_verdict_path
    from pcg_mpi_solver_tpu.obs.schema import validate_jsonl_text

    archive, scratch = _bundle(tmp_path, make_cube_model(3, 3, 3))
    main(["ingest", archive, scratch])
    tel, fl = str(tmp_path / "t.jsonl"), str(tmp_path / "f.jsonl")
    main([cmd, scratch, "1", "--n-steps", "2", "--telemetry-out", tel,
          "--flight-out", fl, "--preflight", "warn", "--summary"] + CPU)
    assert ">success!" in capsys.readouterr().out
    text = open(tel).read()
    assert validate_jsonl_text(text) == []
    assert '"run_summary"' in text.splitlines()[-1]
    assert flight_verdict_path(fl)["verdict"] == "clean"

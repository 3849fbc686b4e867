"""The port's command line (``python -m pcg_mpi_solver_tpu_torch.cli``) on
the CPU: the JAX package's ``tests/test_cli.py`` cases with ``--device
cpu`` (ingest -> partition -> solve -> export on a model written in the
reference's MDF format, the cube, Poisson and octree demos, the speed
test, the backend flag), a bundle the JAX package wrote, one run as a
subprocess, and every subcommand the port does not have yet refused with
its ROADMAP queue 1 item.

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


@pytest.mark.parametrize("cmd", sorted(REFUSED))
def test_unported_subcommands_name_their_item(cmd):
    with pytest.raises(NotImplementedError,
                       match=rf"{cmd}.*ROADMAP queue 1 item "
                             rf"{REFUSED[cmd]}\b"):
        main([cmd, "--spool", "x", "some", "args"])


@pytest.mark.parametrize("argv,item", [
    (["solve", "sc", "1", "--resume-elastic"], 12),
    (["solve", "{scratch}", "1", "--telemetry-out", "t.jsonl"], 14),
    (["solve", "{scratch}", "1", "--trace-resid", "8"], 14),
])
def test_unported_flags_name_their_item(tmp_path, argv, item):
    archive, scratch = _bundle(tmp_path, make_cube_model(3, 3, 3))
    main(["ingest", archive, scratch])
    with pytest.raises(NotImplementedError, match=rf"item {item}\b"):
        main([a.format(scratch=scratch) for a in argv] + (
            CPU if argv[0] == "solve" else []))
    assert len(REFUSED) == 14 and set(REFUSED.values()) == {1, 14}


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


@pytest.mark.parametrize("argv", [
    ["dynamics", "{scratch}", "1", "--n-steps", "2", "--telemetry-out",
     "t.jsonl"],
    ["newmark", "{scratch}", "1", "--n-steps", "2", "--preflight", "warn"],
])
def test_time_subcommands_refuse_unported_flags(tmp_path, argv):
    archive, scratch = _bundle(tmp_path, make_cube_model(3, 3, 3))
    main(["ingest", archive, scratch])
    with pytest.raises(NotImplementedError, match=r"item 14\b"):
        main([a.format(scratch=scratch) for a in argv] + CPU)

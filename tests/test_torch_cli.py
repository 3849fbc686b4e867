"""The port's command line (``python -m pcg_mpi_solver_tpu_torch.cli``) on
the CPU: the JAX package's ``tests/test_cli.py`` cases with ``--device
cpu`` (ingest -> partition -> solve -> export on a model written in the
reference's MDF format, the cube, Poisson and octree demos, the speed
test, the backend flag), a bundle the JAX package wrote, one run as a
subprocess, and every subcommand the port does not have yet refused with
its ROADMAP queue 1 item."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pcg_mpi_solver_tpu.models.mdf import write_mdf as jax_write_mdf
from pcg_mpi_solver_tpu.models.synthetic import make_cube_model as jax_cube
from pcg_mpi_solver_tpu_torch.cli import REFUSED, main
from pcg_mpi_solver_tpu_torch.models import make_cube_model, make_octree_model
from pcg_mpi_solver_tpu_torch.models.mdf import write_mdf

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
    (["partition", "{scratch}", "2", "--method", "graph"], 15),
    (["solve", "{scratch}", "1", "--telemetry-out", "t.jsonl"], 14),
    (["solve", "{scratch}", "1", "--cache-dir", "c"], 14),
    (["solve", "{scratch}", "1", "--trace-resid", "8"], 14),
])
def test_unported_flags_name_their_item(tmp_path, argv, item):
    archive, scratch = _bundle(tmp_path, make_cube_model(3, 3, 3))
    main(["ingest", archive, scratch])
    with pytest.raises(NotImplementedError, match=rf"item {item}\b"):
        main([a.format(scratch=scratch) for a in argv] + (
            CPU if argv[0] == "solve" else []))
    assert len(REFUSED) == 17 and set(REFUSED.values()) == {1, 10, 14}

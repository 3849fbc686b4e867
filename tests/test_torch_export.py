"""The port's export path against the JAX package's (CPU).

``Solver.solve(store=...)`` on a structured cube, a general octree and the
same octree on the hybrid backend, in direct float64 with a three-step
schedule and every export variable (U D ES PS PE NS), a probe dof and its
history: against the JAX package's Solver on the same model and parts,

- the run directory holds the same files, and the Dof and NodeId maps
  are equal arrays;
- every frame equals the JAX package's within 1e-9 x max|frame| (two
  float64 solves to tol 1e-10; the fields sum in another order), the time
  list is equal, the time data has the same flags and iterations (+-1:
  the reduction order) and the probe history matches within 1e-9;
- the JAX package's RunStore reads the port's store, and its export_vtk
  writes the same .vtu arrays from it as the port's export_vtk (and the
  same as from its own store, within 1e-9), in Full, Boundary and
  MidSlices modes; a spawn pool writes the serial loop's bytes;
- two exports of one solution are bitwise equal; a mixed-precision solve
  exports float64 fields of its float64 solution; the scalar class
  refuses nodal fields up front; a checkpointed solve resumed mid-run
  writes the frames and time list of an uninterrupted one.

Also ``write_vtu``/``read_vtu_arrays`` and ``utils.postproc`` against the
JAX package's on the same files.
"""

import os

import numpy as np
import pytest
import torch

from pcg_mpi_solver_tpu import RunConfig as JaxRunConfig
from pcg_mpi_solver_tpu import SolverConfig as JaxSolverConfig
from pcg_mpi_solver_tpu import TimeHistoryConfig as JaxTimeHistoryConfig
from pcg_mpi_solver_tpu.models.octree import make_octree_model as jax_octree
from pcg_mpi_solver_tpu.models.synthetic import make_cube_model as jax_cube
from pcg_mpi_solver_tpu.parallel.mesh import make_mesh
from pcg_mpi_solver_tpu.solver import Solver as JaxSolver
from pcg_mpi_solver_tpu.utils import postproc as jax_postproc
from pcg_mpi_solver_tpu.utils.io import RunStore as JaxRunStore
from pcg_mpi_solver_tpu.vtk.export import export_vtk as jax_export_vtk
from pcg_mpi_solver_tpu.vtk.writer import read_vtu_arrays as jax_read_vtu
from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig, TimeHistoryConfig
from pcg_mpi_solver_tpu_torch.models import (
    make_cube_model, make_octree_model, make_poisson_model)
from pcg_mpi_solver_tpu_torch.solver import Solver
from pcg_mpi_solver_tpu_torch.utils import postproc
from pcg_mpi_solver_tpu_torch.utils.io import RunStore
from pcg_mpi_solver_tpu_torch.vtk.export import export_vtk
from pcg_mpi_solver_tpu_torch.vtk.writer import read_vtu_arrays, write_vtu

EXPORT_VARS = "U D ES PS PE NS"
FRAME_VARS = ("U", "D", "ES", "PS1", "PS2", "PS3", "PE1", "PE2", "PE3", "NS")
DELTAS = (0.0, 0.5, 1.0)
SOLVER = dict(tol=1e-10, max_iter=3000, dtype="float64")
MODELS = {
    "structured": ((6, 4, 4), dict(E=30e9, heterogeneous=True, seed=5,
                                   load_value=1e6), "structured"),
    "general": ((2, 2, 2), dict(max_level=2, n_incl=2, seed=3, E=30e9,
                                load="traction", load_value=1e6), "general"),
    "hybrid": ((2, 2, 2), dict(max_level=2, n_incl=2, seed=3, E=30e9,
                               load="traction", load_value=1e6), "hybrid"),
}


def _models(name):
    args, kw, _b = MODELS[name]
    if name == "structured":
        return jax_cube(*args, **kw), make_cube_model(*args, **kw)
    return jax_octree(*args, **kw), make_octree_model(*args, **kw)


def _th(probe):
    return dict(time_step_delta=DELTAS, export_vars=EXPORT_VARS,
                plot_flag=True, probe_dofs=(probe,))


def _run(name, root):
    """Both packages' solves of ``name`` with a store."""
    mj, mt = _models(name)
    backend = MODELS[name][2]
    probe = 3 * (mt.n_node - 1)
    # the JAX structured backend wants one device a part
    js = JaxSolver(mj, JaxRunConfig(
        solver=JaxSolverConfig(iters_per_dispatch=0, **SOLVER),
        time_history=JaxTimeHistoryConfig(**_th(probe))),
        mesh=make_mesh(2), n_parts=2, backend=backend)
    ts = Solver(mt, RunConfig(solver=SolverConfig(**SOLVER),
                              time_history=TimeHistoryConfig(**_th(probe))),
                n_parts=2, device="cpu", backend=backend)
    assert js.backend == ts.backend == backend
    jst = JaxRunStore(str(root / f"{name}_jax"), "m")
    tst = RunStore(str(root / f"{name}_port"), "m")
    js.solve(store=jst)
    ts.solve(store=tst)
    return mj, mt, js, ts, jst, tst


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``_run`` of each model, once a module."""
    root, memo = tmp_path_factory.mktemp("export"), {}

    def get(name):
        if name not in memo:
            memo[name] = _run(name, root)
        return memo[name]
    return get


def _close(a, b, tol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)
    assert err <= tol, (what, err)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_solve_with_store_matches_jax(runs, name):
    mj, mt, js, ts, jst, tst = runs(name)
    for sub in ("ResVecData", "PlotData"):
        assert sorted(os.listdir(f"{tst.result_path}/{sub}")) == sorted(
            os.listdir(f"{jst.result_path}/{sub}")), sub
    for m in ("Dof", "NodeId"):
        np.testing.assert_array_equal(tst.read_map(m), jst.read_map(m))
    n_frames = len(DELTAS)
    for var in FRAME_VARS:
        assert tst.n_frames(var) == jst.n_frames(var) == n_frames
        for k in range(n_frames):
            a, b = tst.read_frame(var, k), jst.read_frame(var, k)
            assert a.dtype == np.float64
            if k == 0:
                assert not a.any() and not b.any(), (var, "frame 0")
            else:
                _close(a, b, 1e-9, f"{name} {var}_{k}")
    np.testing.assert_array_equal(tst.read_time_list(), jst.read_time_list())
    tdt, tdj = tst.read_time_data(2), jst.read_time_data(2)
    assert set(tdt) == set(tdj)
    np.testing.assert_array_equal(tdt["Flag"], tdj["Flag"])
    assert (np.abs(tdt["Iter"] - tdj["Iter"]) <= 1).all()
    assert tdt["N_Parts"] == 2 and tdt["MP_NDOF"] == tdj["MP_NDOF"]
    pt = np.load(f"{tst.plot_path}/m_PlotData.npz",
                 allow_pickle=True)["PlotData"].item()
    pj = np.load(f"{jst.plot_path}/m_PlotData.npz",
                 allow_pickle=True)["PlotData"].item()
    np.testing.assert_array_equal(pt["Plot_Dof"], pj["Plot_Dof"])
    np.testing.assert_array_equal(pt["Plot_T"], pj["Plot_T"])
    _close(pt["Plot_U"], pj["Plot_U"], 1e-9, "probe history")
    assert os.path.exists(f"{tst.plot_path}/m_PlotData.mat")


@pytest.mark.parametrize("mode", ["Full", "Boundary", "MidSlices"])
@pytest.mark.parametrize("name", ["structured", "hybrid"])
def test_jax_reads_the_port_store_to_the_same_vtu(runs, name, mode):
    mj, mt, _js, _ts, jst, tst = runs(name)
    vars_ = ["U", "PS1", "ES", "NS"]
    jax_view = JaxRunStore(tst.result_path, "m")
    files_t = export_vtk(mt, tst, vars_, mode, frames=[2])
    arrays_t = read_vtu_arrays(files_t[0])
    files_tj = jax_export_vtk(mj, jax_view, vars_, mode, frames=[2])
    arrays_tj = jax_read_vtu(files_tj[0])
    assert sorted(arrays_t) == sorted(arrays_tj)
    for k in arrays_t:
        np.testing.assert_array_equal(arrays_t[k], arrays_tj[k])
    files_j = jax_export_vtk(mj, jst, vars_, mode, frames=[2])
    arrays_j = jax_read_vtu(files_j[0])
    for k in arrays_t:
        if arrays_t[k].dtype.kind == "f" and k not in ("x", "y", "z"):
            _close(arrays_t[k], arrays_j[k], 1e-9, f"{mode} {k}")
        else:
            np.testing.assert_array_equal(arrays_t[k], arrays_j[k])


def test_spawn_pool_writes_the_serial_bytes(runs):
    _mj, mt, _js, _ts, _jst, tst = runs("structured")
    serial = export_vtk(mt, tst, ["U", "PS1"], "Boundary")
    blobs = [open(f, "rb").read() for f in serial]
    pooled = export_vtk(mt, tst, ["U", "PS1"], "Boundary", n_workers=2)
    assert pooled == serial
    assert [open(f, "rb").read() for f in pooled] == blobs


def test_two_exports_bitwise_and_mixed_fields_are_float64(tmp_path):
    model = make_cube_model(6, 4, 4, E=30e9, heterogeneous=True, seed=5,
                            load_value=1e6)
    cfg = RunConfig(solver=SolverConfig(tol=1e-9, max_iter=2000,
                                        precision_mode="mixed"),
                    time_history=TimeHistoryConfig(export_vars="D ES PS PE"))
    s = Solver(model, cfg, device="cpu")
    s.step(1.0)
    a, b = s._nodal_fields(), s._nodal_fields()
    assert sorted(a) == ["D", "ES", "PE1", "PE2", "PE3", "PS1", "PS2", "PS3"]
    for k in a:
        assert a[k].dtype == s.un.dtype == torch.float64
        assert torch.equal(a[k], b[k])


def test_scalar_class_refuses_nodal_fields(tmp_path):
    model = make_poisson_model(3, 3, 3)
    cfg = RunConfig(solver=SolverConfig(tol=1e-8),
                    time_history=TimeHistoryConfig(export_vars="U PS"))
    s = Solver(model, cfg, device="cpu")
    with pytest.raises(ValueError, match="scalar problem class"):
        s.solve(store=RunStore(str(tmp_path / "r"), "m"))
    # U alone exports for the scalar class
    cfg.time_history.export_vars = "U"
    s = Solver(model, cfg, device="cpu")
    s.solve(store=RunStore(str(tmp_path / "r2"), "m"))
    assert RunStore(str(tmp_path / "r2"), "m").n_frames("U") == 2


def test_checkpointed_solve_resumes_its_frames(tmp_path):
    """A solve stopped after step 1 of 3 and resumed from its checkpoint
    writes the frames, time list and probe history of the uninterrupted
    run, bit for bit."""
    model = make_cube_model(4, 3, 3, heterogeneous=True, seed=2,
                            load="traction", load_value=1e6)
    th = dict(time_step_delta=(0.0, 0.25, 0.5, 1.0), export_vars="U PS",
              plot_flag=True, probe_dofs=(5,))

    def cfg(run):
        return RunConfig(scratch_path=str(tmp_path), run_id=run,
                         checkpoint_every=1,
                         solver=SolverConfig(tol=1e-10, dtype="float64"),
                         time_history=TimeHistoryConfig(**th))

    full = RunStore(cfg("a").result_path, "m")
    Solver(model, cfg("a"), device="cpu").solve(store=full)

    class Stop(Exception):
        pass

    def stop_at_2(t, _res):
        if t == 2:
            raise Stop

    cut = RunStore(cfg("b").result_path, "m")
    with pytest.raises(Stop):
        Solver(model, cfg("b"), device="cpu").solve(store=cut,
                                                    on_step=stop_at_2)
    Solver(model, cfg("b"), device="cpu").solve(store=cut, resume=True)
    for var in ("U", "PS1", "PS3"):
        for k in range(4):
            np.testing.assert_array_equal(cut.read_frame(var, k),
                                          full.read_frame(var, k))
    np.testing.assert_array_equal(cut.read_time_list(),
                                  full.read_time_list())
    np.testing.assert_array_equal(_probe(cut), _probe(full))


def _probe(store):
    return np.load(f"{store.plot_path}/m_PlotData.npz",
                   allow_pickle=True)["PlotData"].item()["Plot_U"]


def test_vtu_roundtrip_and_postproc_match_jax(tmp_path):
    pts = tuple(np.arange(4.0) + i for i in range(3))
    path = write_vtu(str(tmp_path / "a"), pts, np.arange(4),
                     np.array([4]), np.array([7], np.uint8),
                     point_data={"s": np.arange(4.0),
                                 "v": tuple(np.ones(4) * i
                                            for i in range(3))})
    got, want = read_vtu_arrays(path), jax_read_vtu(path)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["s"], np.arange(4.0))
    # a damage front along +x, read by both packages' post-processing
    model = make_cube_model(10, 3, 3, h=1.0)
    store = RunStore(str(tmp_path / "run"), "m")
    store.prepare()
    store.write_map("NodeId", np.arange(model.n_node))
    store.write_map("Dof", np.arange(model.n_dof))
    x = model.node_coords[:, 0]
    for k in range(12):
        store.write_frame("D", k, (x <= 0.5 * k).astype(float))
        store.write_frame("U", k, np.full(model.n_dof, 0.1 * k))
        store.write_frame("PS1", k, x * k)
    store.write_time_list(0.25 * np.arange(12))
    tips = postproc.crack_tip_history(store, model)
    np.testing.assert_array_equal(
        tips, jax_postproc.crack_tip_history(store, model))
    t = store.read_time_list()
    for a, b in zip(postproc.crack_length_and_velocity(t, tips),
                    jax_postproc.crack_length_and_velocity(t, tips)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        postproc.smooth_moving_average(x, 3, passes=2),
        jax_postproc.smooth_moving_average(x, 3, passes=2))
    coords = model.node_coords[[0, 5]]
    h = postproc.get_time_history_data(store, model, coords,
                                       nodal_vars=("PS1",))
    hj = jax_postproc.get_time_history_data(store, model, coords,
                                            nodal_vars=("PS1",))
    assert sorted(h) == sorted(hj)
    for k in h:
        np.testing.assert_array_equal(h[k], hj[k])

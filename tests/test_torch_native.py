"""The port's native host library (``pcg_mpi_solver_tpu_torch/native.py``,
built with g++ from ``pcg_mpi_solver_tpu_torch/native/``) against the
JAX package's (``pcg_mpi_solver_tpu/native.py``), on the CPU.

- ``part_mesh_dual`` and ``part_graph``: equal part maps, array for array,
  on a 6x5x4 cube and a 3^3/L3 octree at 2 and 8 parts, seeds 0 and 1;
  ``part_graph`` on the numpy dual graph with unit and with shared-node
  weights.
- ``edge_cut`` equals its numpy form and JAX's.
- ``csr_take``, ``unique_renumber`` and ``sort_i32`` above the 4096-item
  threshold equal JAX's and the port's numpy forms (values and dtypes);
  below it they defer to numpy (None).
- ``build_dual_graph_np`` equals JAX's.
- Solves on the graph partition: ``Solver`` on the 8x6x6 cube at 8 parts
  (``"graph"`` and ``"auto"``; tests/test_native.py's case) and
  ``NewmarkSolver`` at 4 parts against JAX's (flag equal, iterations
  +-1, u within 1e-10 / 1e-9 of max|u|), ``DynamicsSolver`` under
  ``"auto"``, and the CLI's ``partition --method graph``.
- ``PCG_TPU_NO_NATIVE``: ``available()`` is False, ``"auto"`` takes RCB,
  ``"graph"`` raises; a library that does not build raises with the
  compiler's output for ``"graph"`` and ``"auto"`` alike (no silent
  RCB), while the prep helpers take their numpy forms.
Tolerance: none (equal arrays).
"""

import dataclasses

import numpy as np
import pytest

from pcg_mpi_solver_tpu import native as jax_native
from pcg_mpi_solver_tpu.models.octree import make_octree_model as jax_octree
from pcg_mpi_solver_tpu.models.synthetic import make_cube_model as jax_cube
from pcg_mpi_solver_tpu_torch import native
from pcg_mpi_solver_tpu_torch.models import make_cube_model, make_octree_model
from pcg_mpi_solver_tpu_torch.parallel.partition import (
    make_elem_part, rcb_partition)

MODELS = {"cube": (jax_cube, make_cube_model, (6, 5, 4),
                   dict(heterogeneous=True, seed=1)),
          "octree": (jax_octree, make_octree_model, (3, 3, 3),
                     dict(max_level=3, n_incl=2, seed=3))}
_BUILT = {}


def _models(name):
    if name not in _BUILT:
        fj, ft, args, kw = MODELS[name]
        _BUILT[name] = (fj(*args, **kw), ft(*args, **kw))
    return _BUILT[name]


def _csr(model):
    return (np.asarray(model.elem_nodes_offset, dtype=np.int64),
            np.asarray(model.elem_nodes_flat, dtype=np.int64))


@pytest.fixture(autouse=True)
def _native_on(monkeypatch):
    monkeypatch.delenv("PCG_TPU_NO_NATIVE", raising=False)


CASES = [(m, p, s) for m in sorted(MODELS) for p in (2, 8) for s in (0, 1)]


@pytest.mark.parametrize("name,n_parts,seed", CASES)
def test_part_mesh_dual_equals_jax(name, n_parts, seed):
    mj, mt = _models(name)
    eptr, eind = _csr(mt)
    want = jax_native.part_mesh_dual(*_csr(mj), mj.n_node, n_parts,
                                     seed=seed)
    got = native.part_mesh_dual(eptr, eind, mt.n_node, n_parts, seed=seed)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) == set(range(n_parts))


@pytest.mark.parametrize("weights", ["unit", "shared"])
@pytest.mark.parametrize("name,n_parts,seed", CASES)
def test_part_graph_equals_jax(name, n_parts, seed, weights):
    _mj, mt = _models(name)
    eptr, eind = _csr(mt)
    xadj, adj = native.build_dual_graph_np(eptr, eind, mt.n_node)
    aw = None
    if weights == "shared":
        # edge weight = shared nodes, what part_mesh_dual gives the graph
        src = np.repeat(np.arange(len(xadj) - 1), np.diff(xadj))
        rows = [set(eind[eptr[e]:eptr[e + 1]]) for e in range(mt.n_elem)]
        aw = np.array([len(rows[a] & rows[b]) for a, b in zip(src, adj)],
                      dtype=np.int64)
    want = jax_native.part_graph(xadj, adj, n_parts, adjwgt=aw, seed=seed)
    got = native.part_graph(xadj, adj, n_parts, adjwgt=aw, seed=seed)
    np.testing.assert_array_equal(got, want)
    cut = native.edge_cut(xadj, adj, got)
    assert cut == native.edge_cut_np(xadj, adj, got) == \
        jax_native.edge_cut(xadj, adj, want)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_dual_graph_np_equals_jax(name):
    _mj, mt = _models(name)
    eptr, eind = _csr(mt)
    for ncommon in (1, 4):
        got = native.build_dual_graph_np(eptr, eind, mt.n_node, ncommon)
        want = jax_native.build_dual_graph_np(eptr, eind, mt.n_node, ncommon)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


N_PREP = 3 * native._PREP_THRESHOLD


def test_csr_take_above_threshold_equals_jax_and_numpy():
    from pcg_mpi_solver_tpu_torch.parallel import partition

    rng = np.random.default_rng(0)
    lens = rng.integers(1, 9, size=N_PREP)
    offset = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    elems = rng.permutation(N_PREP)[: N_PREP - 5]
    for flat in (rng.integers(0, 10**9, offset[-1]),
                 rng.integers(0, 2**31 - 1, offset[-1]).astype(np.int32),
                 rng.random(offset[-1]) < 0.5):
        got = native.csr_take(flat, offset, elems)
        want = jax_native.csr_take(flat, offset, elems)
        ref = np.concatenate([flat[offset[e]:offset[e + 1]] for e in elems])
        assert got.dtype == want.dtype == ref.dtype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(
            partition._csr_take(flat, offset, elems), ref)
    assert native.csr_take(flat, offset, elems[:100]) is None


def test_unique_renumber_and_sort_above_threshold_equal_jax_and_numpy():
    from pcg_mpi_solver_tpu_torch.parallel import partition

    rng = np.random.default_rng(1)
    ids = rng.integers(0, N_PREP // 2, size=N_PREP)
    uniq, loc = native.unique_renumber(ids)
    juniq, jloc = jax_native.unique_renumber(ids)
    np.testing.assert_array_equal(uniq, np.unique(ids))
    np.testing.assert_array_equal(uniq, juniq)
    np.testing.assert_array_equal(loc, jloc)
    np.testing.assert_array_equal(uniq[loc], ids)
    assert uniq.dtype == np.int64 and loc.dtype == np.int32
    assert native.unique_renumber(ids, renumber=False)[1] is None
    assert partition._unique(ids).dtype == np.int64
    np.testing.assert_array_equal(partition._unique(ids), uniq)

    keys = rng.integers(-50, 50, size=N_PREP).astype(np.int32)
    perm, skeys = native.sort_i32(keys)
    jperm, jskeys = jax_native.sort_i32(keys)
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(skeys, jskeys)
    np.testing.assert_array_equal(perm, np.argsort(keys, kind="stable"))
    np.testing.assert_array_equal(skeys, np.sort(keys, kind="stable"))
    assert native.sort_i32(keys[:10]) is None
    assert native.unique_renumber(ids[:10]) is None


def test_no_native_turns_the_library_off(monkeypatch):
    _mj, mt = _models("octree")
    monkeypatch.setenv("PCG_TPU_NO_NATIVE", "1")
    assert not native.available()
    np.testing.assert_array_equal(make_elem_part(mt, 4, "auto"),
                                  rcb_partition(mt.sctrs, 4))
    with pytest.raises(RuntimeError, match="PCG_TPU_NO_NATIVE"):
        make_elem_part(mt, 4, "graph")
    ids = np.arange(N_PREP)
    assert native.unique_renumber(ids) is None


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    """A library that does not build: "graph" and "auto" raise with the
    compiler's message; the prep helpers take their numpy forms."""
    _mj, mt = _models("cube")
    src = tmp_path / "src"
    src.mkdir()
    for name in native.SOURCES:
        (src / name).write_text("this is not C++ at all;\n")
    monkeypatch.setattr(native, "SRC_DIR", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    for method in ("graph", "auto"):
        with pytest.raises(native.NativeBuildError,
                           match="this is not C"):
            make_elem_part(mt, 2, method)
    assert native.sort_i32(np.zeros(N_PREP, np.int32)) is None
    assert not list((tmp_path / "build").glob("*.so"))


def test_graph_and_auto_agree_and_are_balanced():
    """'auto' takes the graph when the library loads; the 8-part map has
    no empty part and is within the JAX package's balance (10 % of the
    ideal count, tests/test_native.py)."""
    _mj, mt = _models("octree")
    g = make_elem_part(mt, 8, "graph")
    np.testing.assert_array_equal(make_elem_part(mt, 8, "auto"), g)
    counts = np.bincount(g, minlength=8)
    assert counts.min() > 0
    assert counts.max() <= 1.10 * mt.n_elem / 8


_SOLVES = {}


def _jax_graph_solve(method):
    """(flag, iterations, u) of the JAX Solver on the 8x6x6 cube at 8
    parts under ``method`` (tests/test_native.py's case), run once."""
    if method not in _SOLVES:
        from pcg_mpi_solver_tpu import RunConfig as JRC
        from pcg_mpi_solver_tpu import SolverConfig as JSC
        from pcg_mpi_solver_tpu.models import make_cube_model as jcube
        from pcg_mpi_solver_tpu.parallel.mesh import make_mesh
        from pcg_mpi_solver_tpu.solver import Solver as JaxSolver

        s = JaxSolver(jcube(8, 6, 6, heterogeneous=True),
                      JRC(partition_method=method,
                          solver=JSC(tol=1e-9, max_iter=2000)),
                      mesh=make_mesh(8), n_parts=8, backend="general")
        r = s.step(1.0)
        _SOLVES[method] = (r.flag, r.iters, s.displacement_global(),
                           np.asarray(s.pm.elem_part))
    return _SOLVES[method]


@pytest.mark.parametrize("method", ["graph", "auto"])
def test_solve_on_graph_partition_matches_jax(method):
    """A float64 solve on the 8-part graph partition, general backend:
    the partition equals JAX's, flag equal, iterations within +-1, u
    within 1e-10 of max|u|."""
    from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig
    from pcg_mpi_solver_tpu_torch.solver import Solver

    flag, iters, uj, epj = _jax_graph_solve(method)
    s = Solver(make_cube_model(8, 6, 6, heterogeneous=True),
               RunConfig(partition_method=method,
                         solver=SolverConfig(tol=1e-9, max_iter=2000)),
               n_parts=8, device="cpu", backend="general")
    np.testing.assert_array_equal(s.pm.elem_part, epj)
    r = s.step(1.0)
    assert r.flag == flag == 0
    assert abs(r.iters - iters) <= 1
    ut = s.displacement_global()
    assert np.abs(ut - uj).max() <= 1e-10 * np.abs(uj).max()


def test_time_solvers_take_the_graph_partition():
    """NewmarkSolver (direct, tol 1e-12) on the 4-part graph partition
    against the JAX package's on the same partition: iterations within
    +-1 a step, u within 1e-9 of max|u|; DynamicsSolver under "auto"
    runs on the same element map."""
    from pcg_mpi_solver_tpu.config import RunConfig as JRC
    from pcg_mpi_solver_tpu.config import SolverConfig as JSC
    from pcg_mpi_solver_tpu.parallel.mesh import make_mesh
    from pcg_mpi_solver_tpu.solver.newmark import NewmarkSolver as JaxNewmark
    from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig
    from pcg_mpi_solver_tpu_torch.solver import (
        DynamicsSolver, NewmarkSolver, stable_dt)

    args, kw = (4, 3, 3), dict(h=0.5, nu=0.3, heterogeneous=True, seed=0)
    deltas = [0.5, 1.0, 1.0]
    js = JaxNewmark(jax_cube(*args, **kw), JRC(
        partition_method="graph", solver=JSC(tol=1e-12, max_iter=3000)),
        mesh=make_mesh(4), n_parts=4, dt=0.2, damping=0.1)
    jres = js.run(deltas)
    model = make_cube_model(*args, **kw)
    cfg = RunConfig(partition_method="graph",
                    solver=SolverConfig(tol=1e-12, max_iter=3000))
    s = NewmarkSolver(model, cfg, n_parts=4, dt=0.2, damping=0.1,
                      device="cpu")
    np.testing.assert_array_equal(s.pm.elem_part,
                                  np.asarray(js.pm.elem_part))
    res = s.run(deltas)
    assert all(r.flag == 0 for r in res)
    assert all(abs(r.iters - int(j.iters)) <= 1 for r, j in zip(res, jres))
    uj = js.state_global()[0]
    assert np.abs(s.state_global()[0] - uj).max() <= 1e-9 * np.abs(uj).max()
    auto = dataclasses.replace(cfg, partition_method="auto")
    d = DynamicsSolver(model, auto, n_parts=4, dt=0.5 * stable_dt(model),
                       device="cpu")
    np.testing.assert_array_equal(d.pm.elem_part, s.pm.elem_part)
    assert np.isfinite(d.run(5).u).all()


def test_cli_partition_writes_the_graph_map(tmp_path, capsys):
    """``partition --method graph`` (and the default, auto) writes the
    native partitioner's element map as MeshPart_<n>.npy."""
    from pcg_mpi_solver_tpu_torch.cli import main
    from pcg_mpi_solver_tpu_torch.models.mdf import read_mdf

    from test_torch_cli import _bundle

    archive, scratch = _bundle(tmp_path, make_cube_model(4, 3, 3))
    main(["ingest", archive, scratch])
    model = read_mdf(f"{scratch}/ModelData/MDF")
    want = make_elem_part(model, 4, "graph")
    for extra in (["--method", "graph"], []):
        main(["partition", scratch, "4"] + extra)
        assert "(graph)" in capsys.readouterr().out or not extra
        np.testing.assert_array_equal(
            np.load(f"{scratch}/ModelData/MeshPart_4.npy"), want)

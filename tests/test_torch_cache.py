"""The port's partition cache (``pcg_mpi_solver_tpu_torch/cache/``, served
by ``Solver`` from ``RunConfig.cache_dir``) on the CPU.

- ``model_fingerprint`` equals the JAX package's for the same model (the
  same walk over the same ModelData fields); ``partition_cache_key`` has
  JAX's knobs, each knob (and the schema and version) changes the key,
  and the port's key differs from JAX's on the same arguments (the
  package name keeps the two packages' pickles apart).
- A warm Solver equals the cold one, array for array: the structured,
  general (rcb and graph) and hybrid partitions with the hybrid's float64
  refresh partition, the mg hierarchy and its fine bound; the warm solve
  gives the cold one's flag, iterations and u bitwise, and builds nothing
  (the partition functions are replaced by ones that raise).
- ``setup_cache`` reads "off", "cold", then "warm"; the hit and miss
  counters and ``cache`` events reach the recorder.
- A corrupt entry is a miss, is removed and rebuilt; LRU eviction keeps
  the newest entry under the cap.
- The time solvers (``NewmarkSolver``, ``DynamicsSolver``) take a
  ``cache_dir`` and cache nothing, as in the JAX package.
- The CLI: ``--cache-dir`` (and ``PCG_TPU_CACHE_DIR``) give a cold then a
  warm ``solve-many``, ``cache-stats`` prints the table.
"""

import dataclasses
import inspect
import os

import numpy as np
import pytest

from pcg_mpi_solver_tpu.cache import keys as jax_keys
from pcg_mpi_solver_tpu.models.octree import make_octree_model as jax_octree
from pcg_mpi_solver_tpu.models.synthetic import make_cube_model as jax_cube
from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig
from pcg_mpi_solver_tpu_torch.cache import keys, partition_cache
from pcg_mpi_solver_tpu_torch.cli import main
from pcg_mpi_solver_tpu_torch.models import make_cube_model, make_octree_model
from pcg_mpi_solver_tpu_torch.obs.metrics import MetricsRecorder
from pcg_mpi_solver_tpu_torch.solver import (
    DynamicsSolver, NewmarkSolver, Solver, stable_dt)
from pcg_mpi_solver_tpu_torch.solver import driver

from test_torch_cli import CPU, _bundle
from test_torch_partition import assert_same

OCTREE = ((2, 2, 2), dict(max_level=2, n_incl=2, seed=3, load="traction",
                          load_value=1.0))
CUBE = ((8, 8, 8), dict(h=0.5, nu=0.3, heterogeneous=True))


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ("PCG_TPU_NO_NATIVE", "PCG_TPU_ENABLE_HYBRID",
              "PCG_TPU_HYBRID_F64_REFRESH", "PCG_TPU_CACHE_DIR",
              "PCG_TPU_FAULTS"):
        monkeypatch.delenv(k, raising=False)


@pytest.mark.parametrize("name", ["cube", "octree"])
def test_fingerprint_equals_jax(name):
    if name == "cube":
        args, kw = (6, 5, 4), dict(heterogeneous=True, seed=1)
        mj, mt = jax_cube(*args, **kw), make_cube_model(*args, **kw)
    else:
        args, kw = OCTREE
        mj, mt = jax_octree(*args, **kw), make_octree_model(*args, **kw)
    assert keys.model_fingerprint(mt) == jax_keys.model_fingerprint(mj)
    ep = np.arange(mt.n_elem, dtype=np.int32) % 3
    assert keys.array_hash(ep) == jax_keys.array_hash(ep)


BASE = dict(n_parts=2, backend="general", dtype="float64", method="rcb",
            elem_part_hash=None, pad_multiple=8, extra={})
KNOBS = {"n_parts": 3, "backend": "hybrid", "dtype": "float32",
         "method": "graph", "elem_part_hash": "0123456789abcdef",
         "pad_multiple": 16, "extra": {"native": True}}


def test_key_has_jax_knobs_and_each_changes_it(monkeypatch):
    sig = inspect.signature(keys.partition_cache_key).parameters
    assert list(sig) == list(inspect.signature(
        jax_keys.partition_cache_key).parameters)
    assert set(KNOBS) | {"model_fp"} == set(sig)
    base = keys.partition_cache_key("fp", **BASE)
    assert base == keys.partition_cache_key("fp", **BASE)
    assert keys.partition_cache_key("fp2", **BASE) != base
    for k, v in KNOBS.items():
        assert keys.partition_cache_key("fp", **{**BASE, k: v}) != base, k
    # the port's entries never share a key with the JAX package's
    assert base != jax_keys.partition_cache_key("fp", **BASE)
    monkeypatch.setattr(keys, "PACKAGE_VERSION", "9.9.9")
    assert keys.partition_cache_key("fp", **BASE) != base
    monkeypatch.undo()
    monkeypatch.setattr(keys, "CACHE_SCHEMA", keys.CACHE_SCHEMA + 1)
    assert keys.partition_cache_key("fp", **BASE) != base


def test_key_changes_with_the_code_that_shapes_an_entry(monkeypatch,
                                                        tmp_path):
    """A changed source of the partition, mg or native code gives a new
    key, so a cache directory shared across commits serves no entry that
    other code built."""
    names = {p.relative_to(keys._PKG).as_posix() for p in keys.CODE_SOURCES}
    assert {"parallel/partition.py", "parallel/hybrid.py",
            "parallel/structured.py", "ops/mg.py", "native/partition.cpp",
            "native/prep.cpp"} <= names
    copies = []
    for src in keys.CODE_SOURCES:
        dst = tmp_path / src.relative_to(keys._PKG)
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_bytes(src.read_bytes())
        copies.append(dst)
    monkeypatch.setattr(keys, "CODE_SOURCES", tuple(copies))
    base = keys.partition_cache_key("fp", **BASE)
    for dst in (tmp_path / "parallel" / "partition.py",
                tmp_path / "ops" / "mg.py",
                tmp_path / "native" / "partition.cpp"):
        old = dst.read_bytes()
        dst.write_bytes(old + b"\n")
        assert keys.partition_cache_key("fp", **BASE) != base, dst.name
        dst.write_bytes(old)
    assert keys.partition_cache_key("fp", **BASE) == base


def _no_builds(monkeypatch):
    """Replace every partition function the Solver calls with one that
    raises: a warm construction must not reach them."""
    def boom(*a, **k):
        raise AssertionError("a warm Solver built a partition")
    for name in ("partition_model", "partition_hybrid",
                 "partition_structured"):
        monkeypatch.setattr(driver, name, boom)
    monkeypatch.setattr(driver.mgmod, "build_mg_host", boom)
    monkeypatch.setattr(driver.mgmod, "estimate_fine_lam", boom)


# name -> (model spec, Solver kwargs, RunConfig kwargs, SolverConfig kwargs)
SOLVES = {
    "structured": (CUBE, dict(n_parts=2), {}, {}),
    "general": (OCTREE, dict(n_parts=2), {}, {}),
    "general-graph": (OCTREE, dict(n_parts=4),
                      dict(partition_method="graph"), {}),
    "general-auto": (OCTREE, dict(n_parts=4),
                     dict(partition_method="auto"), {}),
    "hybrid-refresh": (OCTREE, dict(n_parts=2, backend="hybrid"), {},
                       dict(precision_mode="mixed")),
    "mg": (CUBE, dict(n_parts=2), {}, dict(precond="mg")),
}


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_warm_solver_equals_cold(tmp_path, monkeypatch, name):
    (args, kw), skw, rkw, scw = SOLVES[name]
    make = make_cube_model if args == CUBE[0] else make_octree_model
    model = make(*args, **kw)
    cfg = RunConfig(cache_dir=str(tmp_path / "c"), **rkw,
                    solver=SolverConfig(tol=1e-8, max_iter=2000, **scw))
    assert Solver(model, dataclasses.replace(cfg, cache_dir=""),
                  device="cpu", **skw).setup_cache == "off"
    rec = MetricsRecorder()
    cold = Solver(model, cfg, device="cpu", recorder=rec, **skw)
    assert cold.setup_cache == "cold" and cold.partition_build_s > 0
    n_miss = rec.counters["cache.partition.miss"]
    assert n_miss >= 1 and "cache.partition.hit" not in rec.counters
    rc = cold.step(1.0)
    _no_builds(monkeypatch)
    warm = Solver(model, cfg, device="cpu", recorder=rec, **skw)
    assert warm.setup_cache == "warm" and warm.partition_build_s == 0.0
    assert rec.counters["cache.partition.hit"] == n_miss
    assert rec.gauges["setup.cache"] == "warm"
    assert_same(warm.pm, cold.pm, name)
    if name == "hybrid-refresh":
        assert cold.f64_refresh == "bucketed"
    if name == "mg":
        assert_same(warm.mg_setup, cold.mg_setup, "mg")
        np.testing.assert_array_equal(warm.mg_lam, cold.mg_lam)
    rw = warm.step(1.0)
    assert (rw.flag, rw.iters) == (rc.flag, rc.iters) and rc.flag == 0
    np.testing.assert_array_equal(warm.displacement_global(),
                                  cold.displacement_global())


def test_auto_key_records_the_native_choice(tmp_path, monkeypatch):
    """'auto' keys the resolved choice: with the library off it is RCB,
    under another key than the graph's."""
    args, kw = OCTREE
    model = make_octree_model(*args, **kw)
    cfg = RunConfig(cache_dir=str(tmp_path), partition_method="auto")
    graph = Solver(model, cfg, n_parts=4, device="cpu")
    monkeypatch.setenv("PCG_TPU_NO_NATIVE", "1")
    rcb = Solver(model, cfg, n_parts=4, device="cpu")
    assert graph.setup_cache == rcb.setup_cache == "cold"
    assert graph._partition_cache_id != rcb._partition_cache_id
    assert not np.array_equal(graph.pm.elem_part, rcb.pm.elem_part)


def test_corrupt_entry_is_a_miss_and_is_rebuilt(tmp_path):
    args, kw = OCTREE
    model = make_octree_model(*args, **kw)
    cfg = RunConfig(cache_dir=str(tmp_path))
    cold = Solver(model, cfg, n_parts=2, device="cpu")
    (entry,) = (tmp_path / "partition").glob("*.zpkl")
    entry.write_bytes(b"not a zlib pickle")
    assert partition_cache.load_partition(str(tmp_path),
                                          entry.stem) is None
    assert not entry.exists()
    entry.write_bytes(b"not a zlib pickle")
    again = Solver(model, cfg, n_parts=2, device="cpu")
    assert again.setup_cache == "cold"
    assert_same(again.pm, cold.pm, "rebuilt")
    assert Solver(model, cfg, n_parts=2, device="cpu").setup_cache == "warm"


def test_lru_eviction_keeps_the_newest(tmp_path):
    d = str(tmp_path)
    blob = np.zeros(4096)
    assert partition_cache.store_partition(d, "old", blob)
    os.utime(tmp_path / "partition" / "old.zpkl", (1, 1))
    assert partition_cache.store_partition(d, "new", blob, cap_bytes=1)
    names = sorted(p.name for p in (tmp_path / "partition").iterdir())
    assert names == ["new.zpkl"]
    stats = partition_cache.cache_stats(d)
    assert stats["partition"]["entries"] == 1


def test_time_solvers_cache_nothing(tmp_path):
    """NewmarkSolver and DynamicsSolver accept a cache_dir and leave it
    empty: the JAX package wires no cache into them
    (newmark.py:507-508)."""
    model = make_cube_model(4, 3, 3, h=0.5, nu=0.3, heterogeneous=True)
    cfg = RunConfig(cache_dir=str(tmp_path),
                    solver=SolverConfig(tol=1e-10, max_iter=500))
    res = NewmarkSolver(model, cfg, n_parts=2, dt=0.2, damping=0.1,
                        device="cpu").run([0.5, 1.0])
    assert all(r.flag == 0 for r in res)
    dyn = DynamicsSolver(model, cfg, n_parts=2, dt=0.5 * stable_dt(model),
                         device="cpu")
    dyn.run(5)
    assert not any(tmp_path.iterdir())


def test_cli_cache_dir_and_cache_stats(tmp_path, capsys, monkeypatch):
    archive, scratch = _bundle(tmp_path, make_cube_model(4, 3, 3))
    main(["ingest", archive, scratch])
    cache = str(tmp_path / "cache")
    with pytest.raises(SystemExit, match="cache-stats"):
        main(["cache-stats"])
    args = ["solve-many", scratch, "1", "--scales", "1.0", "--tol", "1e-8",
            "--n-parts", "2"] + CPU
    main(args + ["--cache-dir", cache])
    assert "(cold partition)" in capsys.readouterr().out
    monkeypatch.setenv("PCG_TPU_CACHE_DIR", cache)
    main(args)
    out = capsys.readouterr().out
    assert "(warm partition)" in out and ">success!" in out
    main(["cache-stats"])
    out = capsys.readouterr().out
    assert f"cache dir: {cache}" in out
    line = next(s for s in out.splitlines() if s.startswith("partition"))
    assert line.split()[1] == "1"

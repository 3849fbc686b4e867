"""The port's sharded setup against the JAX package's
(``tests/test_setup_shard.py``): the two-level element split, ``part_range``
builds of the general and structured partitions (their rows bitwise the
JAX package's full build), the shard-addressed partition cache
(``cache/shards.py``: split/join, loads of only the requested parts, the
monolithic-entry shim, the mg hierarchy), the streamed slab ingest
(``models/mdf.read_mdf_slab``, ``SparseVec``), and a REAL 2-rank gloo run
whose sharded cold build matches the JAX package's full build row for row
and whose warm start reads only each rank's own entries."""

import dataclasses
import json

import numpy as np
import pytest

from pcg_mpi_solver_tpu.models import mdf as jax_mdf
from pcg_mpi_solver_tpu.models.synthetic import (
    make_cube_model as jax_cube_model)
from pcg_mpi_solver_tpu.parallel import partition as JP
from pcg_mpi_solver_tpu_torch.cache import keys as ckeys
from pcg_mpi_solver_tpu_torch.cache import partition_cache as pc
from pcg_mpi_solver_tpu_torch.cache.shards import (
    join_mg, join_partition, split_mg, split_partition)
from pcg_mpi_solver_tpu_torch.models import make_cube_model
from pcg_mpi_solver_tpu_torch.models import mdf
from pcg_mpi_solver_tpu_torch.models.model_data import SparseVec
from pcg_mpi_solver_tpu_torch.parallel import partition as P

from test_torch_distributed import run_ranks


def _rows_equal(full, shard, lo, hi, n_parts, skip=("elem_part",)):
    """Every (P, ...) array's [lo, hi) rows equal between two partitions
    (either package's; type blocks too)."""
    for f in dataclasses.fields(full):
        if f.name in ("type_blocks", "layout", "part_range") + tuple(skip):
            continue
        a, b = getattr(full, f.name), getattr(shard, f.name)
        if isinstance(a, np.ndarray) and a.ndim >= 1 \
                and a.shape[0] == n_parts:
            assert np.array_equal(a[lo:hi], b[lo:hi]), f.name
        elif isinstance(a, np.ndarray):
            assert np.array_equal(a, b), f.name
    for ta, tb in zip(getattr(full, "type_blocks", []) or [],
                      getattr(shard, "type_blocks", []) or []):
        for ff in dataclasses.fields(ta):
            va, vb = getattr(ta, ff.name), getattr(tb, ff.name)
            if isinstance(va, np.ndarray) and va.ndim >= 1 \
                    and va.shape[0] == n_parts:
                assert np.array_equal(va[lo:hi], vb[lo:hi]), ff.name


def test_two_level_partition_matches_jax():
    m = make_cube_model(8, 6, 5, heterogeneous=True)
    for slabs in (1, 2, 4):
        np.testing.assert_array_equal(
            P.two_level_partition(m.sctrs, 8, slabs),
            JP.two_level_partition(m.sctrs, 8, slabs))
    for s in range(4):
        np.testing.assert_array_equal(
            P.two_level_partition(m.sctrs, 8, 4, refine=[s]),
            JP.two_level_partition(m.sctrs, 8, 4, refine=[s]))


def test_partition_part_range_rows_match_jax_full_build():
    """A ``part_range`` build on the full build's layout: its rows are the
    JAX package's full build's, bit for bit; unbuilt rows stay padding."""
    m = make_cube_model(6, 5, 4, heterogeneous=True)
    full = P.partition_model(m, 8)
    jfull = JP.partition_model(jax_cube_model(6, 5, 4, heterogeneous=True),
                               8)
    for lo, hi in ((0, 2), (2, 4), (4, 8)):
        sh = P.partition_model(m, 8, part_range=(lo, hi),
                               layout=full.layout)
        assert sh.part_range == (lo, hi)
        _rows_equal(jfull, sh, lo, hi, 8)
        assert (sh.dof_gid[:lo] == -1).all() and (sh.weight[:lo] == 0).all()


def test_structured_part_range_rows_match_jax_full_build():
    from pcg_mpi_solver_tpu.parallel.structured import (
        partition_structured as jax_structured)
    from pcg_mpi_solver_tpu_torch.parallel.structured import (
        partition_structured)

    full = jax_structured(jax_cube_model(8, 4, 4), 8)
    sh = partition_structured(make_cube_model(8, 4, 4), 8, part_range=(2, 6))
    for f in dataclasses.fields(sh):
        a, b = getattr(full, f.name, None), getattr(sh, f.name)
        if isinstance(a, np.ndarray) and a.ndim >= 1 and a.shape[0] == 8:
            assert np.array_equal(a[2:6], b[2:6]), f.name
    assert (sh.dof_gid[:2] == -1).all()


def _shard_keys(n_parts=8):
    kw = dict(n_parts=n_parts, backend="general", dtype="float64",
              method="rcb")
    return (ckeys.partition_glue_key("fp", **kw),
            {p: ckeys.partition_shard_key("fp", part_idx=p, **kw)
             for p in range(n_parts)},
            ckeys.partition_cache_key("fp", **kw))


def test_shard_cache_round_trip_and_loads_only_requested_parts(tmp_path,
                                                               monkeypatch):
    """A cold build publishes the glue and one entry a part; a warm read
    of parts 2-3 opens only the glue and those two entries, builds
    nothing, and joins rows bitwise the cold ``part_range`` build's."""
    m = make_cube_model(6, 5, 4, heterogeneous=True)
    full = P.partition_model(m, 8)
    glue_key, keys, _ = _shard_keys()
    pc.cached_partition_shards(
        str(tmp_path), glue_key=glue_key, part_keys=keys,
        builder=lambda: full, split=split_partition, join=join_partition)
    entries = [f for f in (tmp_path / "partition").iterdir()
               if f.suffix == ".zpkl"]
    assert len(entries) == 9                   # 8 parts + the glue
    opened = []
    orig = pc.load_partition

    def spy(cache_dir, key):
        opened.append(key)
        return orig(cache_dir, key)

    monkeypatch.setattr(pc, "load_partition", spy)
    pm = pc.cached_partition_shards(
        str(tmp_path), glue_key=glue_key,
        part_keys={p: keys[p] for p in (2, 3)},
        builder=lambda: pytest.fail("a warm hit must not build"),
        split=split_partition, join=join_partition)
    assert set(opened) == {glue_key, keys[2], keys[3]}
    assert pm.part_range == (2, 4)
    cold = P.partition_model(m, 8, part_range=(2, 4), layout=full.layout)
    _rows_equal(cold, pm, 0, 8, 8)


def test_monolithic_entry_loads_via_shim(tmp_path):
    """An entry under the monolithic key (the port's one-process cache)
    still serves a sharded read when the shard entries are absent."""
    m = make_cube_model(6, 5, 4, heterogeneous=True)
    full = P.partition_model(m, 8)
    glue_key, keys, legacy = _shard_keys()
    pc.store_partition(str(tmp_path), legacy, full)
    pm = pc.cached_partition_shards(
        str(tmp_path), glue_key=glue_key, part_keys=keys,
        builder=lambda: pytest.fail("the shim must not rebuild"),
        split=split_partition, join=join_partition, legacy_key=legacy)
    _rows_equal(full, pm, 0, 8, 8)


def test_mg_hierarchy_split_join_round_trip():
    from pcg_mpi_solver_tpu_torch.ops import mg as mgmod

    m = make_cube_model(8, 4, 4, heterogeneous=True)
    pm = P.partition_model(m, 4)
    setup = mgmod.build_mg_host(m, pm)
    glue, shards = split_mg(setup, (0, 4))
    back = join_mg(glue, shards)
    for k in ("gidx", "gw"):
        np.testing.assert_array_equal(back.tree["fine"][k],
                                      setup.tree["fine"][k])
    part = join_mg(glue, {p: shards[p] for p in (1, 2)})
    np.testing.assert_array_equal(part.tree["fine"]["gw"][1:3],
                                  setup.tree["fine"]["gw"][1:3])
    assert not part.tree["fine"]["gw"][0].any()
    local = mgmod.local_tree(setup.tree, 1, 3)
    np.testing.assert_array_equal(local["fine"]["gidx"],
                                  setup.tree["fine"]["gidx"][1:3])
    assert local["levels"] is setup.tree["levels"]


def test_read_mdf_slab_matches_jax_and_partitions_as_full_build(tmp_path):
    """The slab ingest: each slab the JAX package's (ids, element data,
    sparse nodal restriction), the slabs tile the model, the peak stays
    bounded, and a slab's partition rows (built from only its slab, the
    full layout injected) are the full build's."""
    m = make_cube_model(8, 6, 5, heterogeneous=True)
    mdf.write_mdf(m, str(tmp_path))
    n_parts, n_slabs = 8, 4
    full = P.partition_model(m, n_parts, method="slab2",
                             slab2_slabs=n_slabs)
    full_bytes = (m.elem_nodes_flat.nbytes + m.elem_dofs_flat.nbytes
                  + m.node_coords.nbytes + 4 * m.F.nbytes + m.sctrs.nbytes)
    seen = []
    for q in range(n_slabs):
        st = mdf.IngestStats()
        slab = mdf.read_mdf_slab(str(tmp_path), q, n_slabs, chunk_elems=64,
                                 stats=st)
        js = jax_mdf.read_mdf_slab(str(tmp_path), q, n_slabs, chunk_elems=64)
        assert st.peak_bytes < full_bytes / 2
        np.testing.assert_array_equal(slab.elem_ids, js.elem_ids)
        np.testing.assert_array_equal(slab.ck, js.ck)
        np.testing.assert_array_equal(slab.F.materialize(),
                                      js.F.materialize())
        e = slab.elem_ids
        np.testing.assert_array_equal(slab.sctrs, m.sctrs[e])
        some = slab.elem_dofs_flat[:50]
        np.testing.assert_array_equal(slab.F[some], m.F[some])
        seen.append(np.asarray(e))
        ep, rng = P.slab_local_parts(slab.sctrs, n_parts, n_slabs, q)
        pm = P.partition_model(slab, n_parts, elem_part=ep, part_range=rng,
                               layout=full.layout)
        _rows_equal(full, pm, rng[0], rng[1], n_parts)
    np.testing.assert_array_equal(np.sort(np.concatenate(seen)),
                                  np.arange(m.n_elem))


def test_read_mdf_slab_rejects_unseparable_models(tmp_path):
    from pcg_mpi_solver_tpu_torch.models import make_glued_blocks_model

    mdf.write_mdf(make_glued_blocks_model(3, 3, 4, 4), str(tmp_path / "g"))
    with pytest.raises(NotImplementedError, match="read_mdf"):
        mdf.read_mdf_slab(str(tmp_path / "g"), 0, 2)


def test_sparsevec_strict_fill_and_ragged_index_match_jax():
    from pcg_mpi_solver_tpu.models.mdf import _ragged_index as jax_ragged
    from pcg_mpi_solver_tpu.models.model_data import SparseVec as JaxSparse

    args = (np.array([2, 5, 9]), np.array([1.0, 2.0, 3.0]), 12)
    v, jv = SparseVec(*args), JaxSparse(*args)
    for idx in (np.array([5, 2, 9]), np.array([0, 5]), np.arange(12)):
        np.testing.assert_array_equal(v[idx], jv[idx])
    assert np.ndim(v[5]) == 0 and float(v[5]) == 2.0
    strict = SparseVec(np.array([2, 5]), np.array([1.0, 2.0]), 12,
                       strict=True)
    with pytest.raises(IndexError):
        strict[np.array([3])]
    np.testing.assert_array_equal(v.materialize(), jv.materialize())
    with pytest.raises(ValueError, match="strictly increasing"):
        SparseVec(np.array([3, 1]), np.zeros(2), 4)
    for starts, lens in (([10, 50, 20], [2, 0, 3]), ([5, 9], [3, 0]),
                         ([3], [0])):
        np.testing.assert_array_equal(
            mdf._ragged_index(np.array(starts), np.array(lens)),
            jax_ragged(np.array(starts), np.array(lens)))


_CHILD_SHARD = r"""
import json
import numpy as np
from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig, TimeHistoryConfig
from pcg_mpi_solver_tpu_torch.models import make_cube_model
from pcg_mpi_solver_tpu_torch.obs.metrics import MetricsRecorder
from pcg_mpi_solver_tpu_torch.parallel.distributed import fetch_global
from pcg_mpi_solver_tpu_torch.solver import Solver

CACHE, OUT = sys.argv[4], sys.argv[5]

class Cap:
    def __init__(self): self.events = []
    def emit(self, ev): self.events.append(ev)
    def close(self): pass

model = make_cube_model(6, 5, 4, heterogeneous=True)
def cfg(**kw):
    return RunConfig(solver=SolverConfig(tol=1e-8, max_iter=500),
                     time_history=TimeHistoryConfig(
                         time_step_delta=[0.0, 1.0], export_flag=False),
                     **kw)
s_mono = Solver(model, cfg(setup_shard="off"), mesh=mesh, n_parts=8,
                backend="general", device="cpu")
assert s_mono._setup_range is None
r_mono = s_mono.step(1.0)
u_mono = fetch_global(s_mono.un, mesh)
# the sharded cold build: this rank's rows, the layout merged over gloo
cold = Solver(model, cfg(cache_dir=CACHE), mesh=mesh, n_parts=8,
              backend="general", device="cpu")
lo, hi = cold._setup_range
assert cold.setup_cache == "cold"
pm = cold.pm
np.savez(os.path.join(OUT, f"rows{pid}.npz"), lo=lo, hi=hi,
         **{n: getattr(pm, n)[lo:hi] for n in
            ("weight", "eff", "F", "iface_local", "iface_slot", "ell")},
         dof_gid=pm.dof_gid, node_gid=pm.node_gid)
cap = Cap()
warm = Solver(model, cfg(cache_dir=CACHE), mesh=mesh, n_parts=8,
              backend="general", device="cpu",
              recorder=MetricsRecorder(sinks=(cap,)))
assert warm.setup_cache == "warm" and warm.partition_build_s == 0.0
ev = [e for e in cap.events if e.get("kind") == "cache" and e.get("shard")]
sev = [e for e in cap.events if e.get("kind") == "setup_shard"]
r = warm.step(1.0)
u = fetch_global(warm.un, mesh)
assert (r.flag, r.iters) == (r_mono.flag, r_mono.iters), (r, r_mono)
np.testing.assert_array_equal(u, u_mono)
print("RESULT " + json.dumps({
    "pid": pid, "parts_read": ev[0]["parts"], "entries": ev[0]["entries"],
    "setup_shard": sev[0]["parts"], "cold": sev[0]["cold"],
    "flag": int(r.flag)}), flush=True)
"""


def test_two_rank_sharded_build_rows_and_warm_start(tmp_path):
    """Two ranks over gloo: the sharded cold build's rows are the JAX
    package's full build's (each rank built only its own, the layout
    merged by HostComm) with the export glue of every part exchanged; the
    warm start reads only the rank's own part entries and the glue, builds
    nothing, and solves bitwise as the monolithic build does."""
    out = tmp_path / "rows"
    out.mkdir()
    res = [json.loads(r[len("RESULT "):]) for r in run_ranks(
        tmp_path, _CHILD_SHARD, 2, [tmp_path / "cache", out])]
    by = {r["pid"]: r for r in res}
    assert by[0]["parts_read"] == [0, 1, 2, 3]
    assert by[1]["parts_read"] == [4, 5, 6, 7]
    assert all(r["entries"] == 5 and r["flag"] == 0 for r in res)
    assert by[1]["setup_shard"] == [4, 8] and by[1]["cold"] is False
    jfull = JP.partition_model(jax_cube_model(6, 5, 4, heterogeneous=True),
                               8)
    for pid in (0, 1):
        z = np.load(out / f"rows{pid}.npz")
        lo, hi = int(z["lo"]), int(z["hi"])
        for n in ("weight", "eff", "F", "iface_local", "iface_slot", "ell"):
            np.testing.assert_array_equal(z[n], getattr(jfull, n)[lo:hi],
                                          err_msg=n)
        # the exchanged export glue covers every part
        np.testing.assert_array_equal(z["dof_gid"], jfull.dof_gid)
        np.testing.assert_array_equal(z["node_gid"], jfull.node_gid)


def test_setup_ladder_two_rank_rung_on_the_cpu(tmp_path):
    """``setup_ladder``'s 2-process rung with ``device="cpu"``: a cold
    sharded build, then a warm start that reads only each rank's own
    shard entries (asserted in the children)."""
    from pcg_mpi_solver_tpu_torch.setup_ladder import run_ladder

    out = tmp_path / "ladder.json"
    lines = run_ladder([2], nx=4, ppp=2, cache_dir=str(tmp_path / "c"),
                       out_path=str(out), timeout_s=110, device="cpu")
    d = lines[0]["detail"]
    assert (d["procs"], d["n_parts"], d["n_dof"]) == (2, 4, 675)
    assert d["partition_build_s"] > 0 and d["ingest_peak_bytes"] > 0
    assert json.loads(out.read_text())["rungs"] == lines

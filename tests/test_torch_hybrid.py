"""The port's hybrid level-grid backend against the JAX package's, on the
CPU: the partition and the operators.

- ``partition_hybrid``: every ``LevelGrid`` (size, nb, dims, origin, ck,
  ce, nidx, n_cells), the ``CombineMaps``, the brick stiffness and the
  block-filtered ``PartitionedModel`` equal the JAX package's, bytes and
  dtypes, on ``tests/test_hybrid.py``'s 2x2x2/L2 octree at one and two
  parts, under the default knobs (every level one dense block here),
  ``PCG_TPU_HYBRID_BLOCK=1`` (tiled), ``=2`` (tiled and dense mixed),
  ``PCG_TPU_HYBRID_MERGE=1`` and ``PCG_TPU_HYBRID_KD=1`` (heavy nodes).
  ``partition_model(block_filter=)`` equals JAX's, also for a filter that
  leaves no type block (``ell`` None).
- ``HybridOps`` matvec, diag and node blocks against JAX ``HybridOps`` in
  float64 (jitted: one compile instead of an eager compile per op) and
  against the port's general ``Ops`` on the same element map: within
  1e-12 of max|y| in float64, 2e-5 in float32 (the port's float32 runs
  the slab kernel's plain version here); a block of two columns is its
  two single matvecs bit for bit; the gather combine against the scatter
  one within 1e-12.
- ``bucketed_matvec`` against the JAX package's and against the general
  operator: within 1e-12 of max|y|; it refuses a partition without the
  node layout.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcg_mpi_solver_tpu.models.octree import make_octree_model as jax_octree
from pcg_mpi_solver_tpu.ops.matvec import Ops as JaxOps
from pcg_mpi_solver_tpu.ops.matvec import (
    bucketed_matvec as jax_bucketed_matvec,
    build_bucketed_blocks as jax_build_bucketed,
    device_data as jax_device_data)
from pcg_mpi_solver_tpu.parallel.hybrid import HybridOps as JaxHybridOps
from pcg_mpi_solver_tpu.parallel.hybrid import (
    device_data_hybrid as jax_device_data_hybrid,
    partition_hybrid as jax_partition_hybrid)
from pcg_mpi_solver_tpu.parallel.partition import (
    make_elem_part as jax_elem_part, partition_model as jax_partition)
from pcg_mpi_solver_tpu_torch.models import make_octree_model
from pcg_mpi_solver_tpu_torch.ops.matvec import (
    Ops, bucketed_matvec, build_bucketed_blocks, device_data)
from pcg_mpi_solver_tpu_torch.parallel.hybrid import (
    HybridOps, block_data, device_data_hybrid, partition_hybrid)
from pcg_mpi_solver_tpu_torch.parallel.partition import (
    make_elem_part, partition_model)

from test_torch_partition import assert_same

MODEL = ((2, 2, 2), dict(max_level=2, n_incl=2, seed=3, load="traction",
                         load_value=1.0))
# knob settings -> environment; "block1" tiles every level, "block2"
# tiles the finest level and keeps the coarse one dense
KNOBS = {"default": {}, "block1": {"PCG_TPU_HYBRID_BLOCK": "1"},
         "block2": {"PCG_TPU_HYBRID_BLOCK": "2"},
         "merge": {"PCG_TPU_HYBRID_MERGE": "1", "PCG_TPU_HYBRID_BLOCK": "2"},
         "kd1": {"PCG_TPU_HYBRID_KD": "1"}}
TOL = {torch.float64: 1e-12, torch.float32: 2e-5}


@pytest.fixture(scope="module")
def models():
    args, kw = MODEL
    return jax_octree(*args, **kw), make_octree_model(*args, **kw)


def _with_knobs(monkeypatch, knobs):
    for k in ("PCG_TPU_HYBRID_BLOCK", "PCG_TPU_HYBRID_MERGE",
              "PCG_TPU_HYBRID_KD", "PCG_TPU_HYBRID_COMBINE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)


def _pair(models, n_parts):
    mj, mt = models
    ep = jax_elem_part(mj, n_parts, method="rcb")
    np.testing.assert_array_equal(ep, make_elem_part(mt, n_parts))
    return (jax_partition_hybrid(mj, n_parts, elem_part=ep),
            partition_hybrid(mt, n_parts, elem_part=ep), ep)


@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_partition_hybrid_bitwise(models, monkeypatch, knob, n_parts):
    _with_knobs(monkeypatch, KNOBS[knob])
    hj, ht, _ep = _pair(models, n_parts)
    assert len(ht.levels) == len(hj.levels) >= 1
    for i, (lt, lj) in enumerate(zip(ht.levels, hj.levels)):
        assert_same(lt, lj, f"{knob}/{n_parts}/level{i}")
    assert_same(ht.combine, hj.combine, f"{knob}/{n_parts}/combine")
    assert_same(ht.pm, hj.pm, f"{knob}/{n_parts}/pm")
    for f in ("brick_Ke", "brick_diag", "brick_Se"):
        assert_same(getattr(ht, f), getattr(hj, f), f)
    # the delegation to pm, and what each knob is for
    assert ht.n_loc == ht.pm.n_loc
    nbs = [lv.nb for lv in ht.levels]
    if knob == "default":
        assert nbs == [1] * len(nbs)
    elif knob in ("block1", "merge"):
        assert max(nbs) > 1
    elif knob == "kd1":
        assert ht.combine.hnode.shape[1] > 0
    if knob == "merge":
        assert len(ht.levels) == 1 and ht.levels[0].size == 0


@pytest.mark.parametrize("keep", ["bricks_out", "none"])
def test_block_filter_bitwise(models, keep):
    """Bricks filtered out (the hybrid's general half), and every element
    filtered out: no type block, no ELL, the nodes and dofs still
    local."""
    mj, mt = models
    bt = mt.octree["brick_type"]
    filt = (mt.elem_type != bt) if keep == "bricks_out" \
        else np.zeros(mt.n_elem, bool)
    pj = jax_partition(mj, 2, block_filter=filt)
    pt = partition_model(mt, 2, block_filter=filt)
    assert_same(pt, pj, keep)
    full = partition_model(mt, 2)
    np.testing.assert_array_equal(pt.dof_gid, full.dof_gid)
    if keep == "none":
        assert pt.ell is None and pt.type_blocks == []


_JAX_OUT = {}


def _jax_outputs(hj, knob, n_parts, x):
    """JAX ``HybridOps`` float64 matvec, diag and node blocks of ``hj``
    on ``x``, jitted, computed once per (knob, parts)."""
    key = (knob, n_parts)
    if key not in _JAX_OUT:
        oj = JaxHybridOps.from_hybrid(hj, combine="gather")
        fn = jax.jit(lambda d, v: (oj.matvec(d, v), oj.diag(d),
                                   oj.node_block_diag(d)))
        _JAX_OUT[key] = [np.asarray(a) for a in fn(
            jax_device_data_hybrid(hj, jnp.float64), jnp.asarray(x))]
    return _JAX_OUT[key]


def _seeded(pm, seed=7):
    rng = np.random.default_rng(seed)
    return np.where(pm.dof_gid >= 0, rng.standard_normal(pm.dof_gid.shape),
                    0.0)


def _close(a, b, tol, what):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-300)
    err = np.abs(a - b).max() / scale
    assert err <= tol, (what, err)


@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("knob", ["default", "block2", "kd1"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_hybrid_operator_matches_jax_and_general(models, monkeypatch, knob,
                                                 n_parts, dtype):
    _with_knobs(monkeypatch, KNOBS[knob])
    hj, ht, ep = _pair(models, n_parts)
    ot = HybridOps.from_hybrid(ht, dot_dtype=dtype, combine="gather")
    dt = device_data_hybrid(ht, dtype, "cpu")
    pg = partition_model(models[1], n_parts, elem_part=ep)
    og, dg = Ops.from_model(pg), device_data(pg, torch.float64, "cpu")
    x = _seeded(pg)
    yj, dj, bj = _jax_outputs(hj, knob, n_parts, x)
    xt = torch.as_tensor(x, dtype=dtype)
    tol = TOL[dtype]
    y = ot.matvec(dt, xt)
    _close(y, yj, tol, "matvec vs JAX")
    _close(y, og.matvec(dg, torch.as_tensor(x)), tol, "matvec vs general")
    d = ot.diag(dt)
    _close(d, dj, tol, "diag vs JAX")
    _close(d, og.diag(dg), tol, "diag vs general")
    b = ot.node_block_diag(dt)
    _close(b, bj.reshape(b.shape), tol, "node blocks vs JAX")
    _close(b, og.node_block_diag(dg), tol, "node blocks vs general")
    # a block of two columns: each column its single matvec's bits
    blk = torch.stack([xt, 2 * xt])
    yb = ot.matvec(block_data(dt, 2), blk)
    assert torch.equal(yb[0], y) and torch.equal(yb[1], ot.matvec(dt, 2 * xt))
    with pytest.raises(ValueError, match="block_data"):
        ot.matvec(dt, blk)


@pytest.mark.parametrize("n_parts", [1, 2])
def test_gather_combine_matches_scatter(models, monkeypatch, n_parts):
    _with_knobs(monkeypatch, KNOBS["kd1"])
    _hj, ht, _ep = _pair(models, n_parts)
    data = device_data_hybrid(ht, torch.float64, "cpu")
    og = HybridOps.from_hybrid(ht, combine="gather")
    osc = dataclasses.replace(og, combine="scatter")
    assert osc._use_gather(data) is False and og._use_gather(data)
    x = torch.as_tensor(_seeded(ht.pm, 3))
    _close(osc.matvec(data, x), og.matvec(data, x), 1e-12, "matvec")
    _close(osc.diag(data), og.diag(data), 1e-12, "diag")
    _close(osc.node_block_diag(data), og.node_block_diag(data), 1e-12,
           "node blocks")
    with pytest.raises(ValueError, match="gather|scatter"):
        HybridOps.from_hybrid(ht, combine="sum")


@pytest.mark.parametrize("n_parts", [1, 2])
def test_bucketed_matvec_matches_jax_and_general(models, n_parts):
    mj, mt = models
    pj = jax_partition(mj, n_parts)
    pt = partition_model(mt, n_parts)
    x = _seeded(pt, 5)
    rj = jax_device_data(pj, jnp.float64, blocks=False)
    rj["buckets"] = jax_build_bucketed(pj, jnp.float64)
    oj = JaxOps.from_model(pj)
    yj = jax.jit(lambda d, v: jax_bucketed_matvec(oj, d, v))(
        rj, jnp.asarray(x))
    rt = build_bucketed_blocks(pt, torch.float64, "cpu")
    ops = Ops(n_loc=pt.n_loc, n_iface=pt.n_iface, n_node_loc=pt.n_node_loc,
              n_node_iface=pt.n_node_iface, n_parts=pt.n_parts)
    y = bucketed_matvec(ops, rt, torch.as_tensor(x))
    assert len(rt["bucketed"]) == len(rj["buckets"])
    _close(y, yj, 1e-12, "bucketed vs JAX")
    og, dg = Ops.from_model(pt), device_data(pt, torch.float64, "cpu")
    _close(y, og.matvec(dg, torch.as_tensor(x)), 1e-12, "bucketed vs general")
    assert torch.equal(y, bucketed_matvec(ops, rt, torch.as_tensor(x)))
    bare = partition_model(mt, n_parts, block_filter=np.zeros(mt.n_elem,
                                                              bool))
    with pytest.raises(ValueError, match="node layout"):
        build_bucketed_blocks(bare, torch.float64, "cpu")

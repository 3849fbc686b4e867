"""The port's general-backend models and partition against the JAX
package's: ``make_octree_model``, ``make_glued_blocks_model``,
``make_poisson_model`` and ``make_cube_model(n_types=2)`` field by field,
and ``partition_model`` array by array (every ``TypeBlock``, the
``PartitionedModel`` and its ``PartitionLayout``), under rcb at one, two
and three parts, slab2 and an explicit ``elem_part``; the
``partition_from_numpy`` round trip; ``partition_model`` and
``partition_hybrid`` on the native graph partition (``"graph"``, and
``"auto"``, which takes it) at 2 and 8 parts; and the partition
arguments the port refuses, each naming its ROADMAP queue 1 item.  Tolerance: none —
equal bytes, equal dtypes."""

import dataclasses

import numpy as np
import pytest

from pcg_mpi_solver_tpu.models.octree import make_octree_model as jax_octree
from pcg_mpi_solver_tpu.models.synthetic import (
    make_cube_model as jax_cube, make_glued_blocks_model as jax_glued,
    make_poisson_model as jax_poisson)
from pcg_mpi_solver_tpu.parallel.hybrid import (
    partition_hybrid as jax_partition_hybrid)
from pcg_mpi_solver_tpu.parallel.partition import (
    partition_model as jax_partition, slab_local_parts as jax_slab_parts,
    two_level_partition as jax_two_level)
from pcg_mpi_solver_tpu_torch.models import (
    make_cube_model, make_glued_blocks_model, make_octree_model,
    make_poisson_model)
from pcg_mpi_solver_tpu_torch.parallel import (
    PartitionedModel, partition_from_numpy, partition_model)
from pcg_mpi_solver_tpu_torch.parallel.hybrid import partition_hybrid
from pcg_mpi_solver_tpu_torch.parallel.partition import (
    make_elem_part, slab_local_parts, two_level_partition)

# name -> (JAX generator, port generator, args, kwargs)
MODELS = {
    "octree_l2": (jax_octree, make_octree_model, (2, 2, 2),
                  dict(max_level=2, n_incl=2, seed=3)),
    "octree_l3": (jax_octree, make_octree_model, (2, 2, 2),
                  dict(max_level=3, n_incl=2, seed=3, E=30e9,
                       load_value=1e6)),
    "octree_dirichlet": (jax_octree, make_octree_model, (2, 1, 2),
                         dict(max_level=2, n_incl=1, seed=5,
                              load="dirichlet", load_value=1e-3,
                              canonicalize=False)),
    "glued": (jax_glued, make_glued_blocks_model, (2, 3, 2, 2),
              dict(E=3.0, penalty=50.0, kt_factor=0.25)),
    "poisson": (jax_poisson, make_poisson_model, (4, 3, 3), {}),
    "poisson_het": (jax_poisson, make_poisson_model, (4, 3, 3),
                    dict(heterogeneous=True, seed=2, load="dirichlet")),
    "cube_types2": (jax_cube, make_cube_model, (4, 3, 3),
                    dict(n_types=2, heterogeneous=True, seed=1)),
}


def build(name):
    fj, ft, args, kw = MODELS[name]
    return fj(*args, **kw), ft(*args, **kw)


def assert_same(a, b, where):
    if dataclasses.is_dataclass(a):
        assert dataclasses.is_dataclass(b), where
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{where}.{f.name}")
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b), where
    else:
        assert a == b, where


@pytest.mark.parametrize("name", sorted(MODELS))
def test_general_models_bitwise(name):
    mj, mt = build(name)
    for f in dataclasses.fields(mt):
        assert_same(getattr(mt, f.name), getattr(mj, f.name), f.name)
    assert mt.grid is None


def test_octree_models_have_reflected_transition_types():
    _mj, mt = build("octree_l3")
    n_nodes = {lib["n_nodes"] for lib in mt.elem_lib.values()}
    assert 8 in n_nodes and max(n_nodes) > 8
    assert mt.elem_sign_flat.any()
    assert mt.octree["brick_type"] is not None


# (model, n_parts, method): rcb at 1, 2 and 3 parts on the three
# model families, the two-level split on the octree
PARTITIONS = ([(n, p, "rcb") for n in ("octree_l2", "glued", "poisson")
               for p in (1, 2, 3)]
              + [("octree_l3", 3, "rcb"), ("octree_l2", 2, "slab2"),
                 ("cube_types2", 2, "rcb")])


@pytest.mark.parametrize("name,n_parts,method", PARTITIONS)
def test_partition_model_bitwise(name, n_parts, method):
    mj, mt = build(name)
    pj = jax_partition(mj, n_parts, method=method)
    pt = partition_model(mt, n_parts, method=method)
    assert isinstance(pt, PartitionedModel)
    assert_same(pt, pj, f"{name}/{n_parts}/{method}")


@pytest.mark.parametrize("n_parts", [2, 8])
@pytest.mark.parametrize("name,method", [("octree_l3", "graph"),
                                         ("poisson", "graph"),
                                         ("octree_l2", "auto")])
def test_graph_partition_model_bitwise(monkeypatch, name, method, n_parts):
    """The native dual-graph partition (``"auto"`` takes it when the
    library loads) through the whole build, array for array."""
    monkeypatch.delenv("PCG_TPU_NO_NATIVE", raising=False)
    mj, mt = build(name)
    pj = jax_partition(mj, n_parts, method=method)
    pt = partition_model(mt, n_parts, method=method)
    assert_same(pt, pj, f"{name}/{n_parts}/{method}")
    assert len(np.unique(pt.elem_part)) == n_parts


@pytest.mark.parametrize("n_parts", [2, 8])
def test_graph_partition_hybrid_bitwise(monkeypatch, n_parts):
    """``partition_hybrid`` under ``"graph"``: every level grid, the
    combine maps and the transition partition, array for array."""
    monkeypatch.delenv("PCG_TPU_NO_NATIVE", raising=False)
    for k in ("PCG_TPU_HYBRID_BLOCK", "PCG_TPU_HYBRID_MERGE",
              "PCG_TPU_HYBRID_KD", "PCG_TPU_HYBRID_COMBINE"):
        monkeypatch.delenv(k, raising=False)
    mj, mt = build("octree_l3")
    hj = jax_partition_hybrid(mj, n_parts, method="graph")
    ht = partition_hybrid(mt, n_parts, method="graph")
    assert len(ht.levels) == len(hj.levels) >= 1
    for i, (lt, lj) in enumerate(zip(ht.levels, hj.levels)):
        assert_same(lt, lj, f"graph/{n_parts}/level{i}")
    assert_same(ht.combine, hj.combine, f"graph/{n_parts}/combine")
    assert_same(ht.pm, hj.pm, f"graph/{n_parts}/pm")


def test_partition_with_explicit_elem_part_bitwise():
    mj, mt = build("octree_l3")
    ep = (np.arange(mt.n_elem) * 7 % 3).astype(np.int32)
    pj = jax_partition(mj, 3, elem_part=ep)
    pt = partition_model(mt, 3, elem_part=ep)
    assert_same(pt, pj, "elem_part")
    np.testing.assert_array_equal(pt.elem_part, ep)


def test_partition_from_numpy_round_trip():
    mj, _mt = build("glued")
    pj = jax_partition(mj, 2)
    pm = partition_from_numpy(pj)
    assert isinstance(pm, PartitionedModel)
    assert_same(pm, pj, "from JAX")
    again = partition_from_numpy(dataclasses.asdict(pm))
    assert_same(again, pm, "from a dict")
    bad = dataclasses.asdict(pm)
    bad["weight"] = bad["weight"][:, :-1]
    with pytest.raises(ValueError, match="weight"):
        partition_from_numpy(bad)


@pytest.mark.parametrize("kw,item", [
    (dict(part_range=(1, 2)), 12),
    (dict(comm="serial"), 12),
    (dict(layout="full"), 12),
])
def test_partition_refusals_name_their_items(kw, item):
    """The sharded-setup arguments that ROADMAP queue 1 item ``item``
    brought (once refused, naming it) build what the full build does: a
    ``part_range`` build's rows are the full build's, bit for bit (on the
    full build's layout, which one process alone cannot merge); an
    explicit one-process comm, or the full build's own layout, give the
    full build."""
    from pcg_mpi_solver_tpu_torch.parallel.partition import SerialComm

    assert item == 12
    _mj, mt = build("octree_l2")
    full = partition_model(mt, 2)
    if "part_range" in kw:
        pm = partition_model(mt, 2, layout=full.layout, **kw)
        assert pm.part_range == (1, 2)
        for name in ("weight", "dof_gid", "node_gid", "eff", "F",
                     "iface_local", "iface_slot", "ell"):
            np.testing.assert_array_equal(getattr(pm, name)[1],
                                          getattr(full, name)[1])
        assert (pm.dof_gid[0] == -1).all() and (pm.weight[0] == 0).all()
        return
    arg = SerialComm() if "comm" in kw else full.layout
    pm = partition_model(mt, 2, **{next(iter(kw)): arg})
    assert_same(pm, full, "sharded argument")


def test_single_part_takes_every_method_as_jax_does():
    """At one part the JAX package returns the all-zero map whatever the
    method (no partitioner runs), and so does the port."""
    _mj, mt = build("octree_l2")
    for method in ("rcb", "slab2", "graph", "auto"):
        np.testing.assert_array_equal(make_elem_part(mt, 1, method),
                                      np.zeros(mt.n_elem, np.int32))


def test_two_level_split_and_slab_halves_bitwise():
    """The two-level split at several slab counts, and each slab's own
    refinement half (``slab_local_parts``), against the JAX package's."""
    _mj, mt = build("octree_l3")
    c = mt.sctrs
    for n_parts, n_slabs in ((4, 1), (4, 2), (6, 3)):
        full = two_level_partition(c, n_parts, n_slabs)
        np.testing.assert_array_equal(full,
                                      jax_two_level(c, n_parts, n_slabs))
        pps = n_parts // n_slabs
        for s in range(n_slabs):
            idx = np.where(full // pps == s)[0]
            part, rng = slab_local_parts(c[idx], n_parts, n_slabs, s)
            jpart, jrng = jax_slab_parts(c[idx], n_parts, n_slabs, s)
            np.testing.assert_array_equal(part, jpart)
            assert rng == tuple(jrng) == (s * pps, (s + 1) * pps)
            np.testing.assert_array_equal(part, full[idx])

"""The port's general (pattern-type) backend against the JAX package's, on
the CPU, on partitions built by the JAX package and carried across
(``partition_from_numpy``), so both operators read the same arrays.

Windows:

- The operator (``matvec_local``, ``matvec``, ``diag``,
  ``node_block_diag``; ``matvec`` also with one bucket a sign sub-type)
  against JAX ``Ops``: float64 within 1e-12 of the largest value, float32 within rtol/atol 2e-5 (``tests/test_pallas.py``'s
  window), on the octree at one part and at three (a dof shared by three
  parts: the fixed-order interface assembly), the glued blocks (the
  cohesive springs; at three parts their node-less dofs break the node
  layout, so the flat dof rows run) and the Poisson model (one dof a node:
  the flat dof-row scatter).  A block of R = 3 columns equals three single
  matvecs bit for bit.
- Solves through ``Solver(backend="general", device="cpu")`` against the
  JAX Solver (``iters_per_dispatch=0``, its one-shot program) on the
  small octree: direct float64 the same flag, iterations within +-1 (the
  f64 dots and element products sum in another order than XLA's, which
  can move the exit at the tol boundary by one), relres <= tol, x within
  1e-8; mixed totals within max(3, 5 %) (the ground rules' mixed window),
  x within 1e-5; block3, fused and pipelined one case each; two parts
  against one at +-1; the glued blocks (mixed) and Poisson (direct);
  ``solve_many`` columns against the JAX package's.
- The backend choice as the JAX Solver makes it (a solve on the native
  graph partition is ``tests/test_torch_native.py``); the hybrid
  backend is
  ``tests/test_torch_hybrid_solver.py``, mg on the general backend
  ``tests/test_torch_mg_general.py``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pcg_mpi_solver_tpu import RunConfig as JaxRunConfig
from pcg_mpi_solver_tpu import SolverConfig as JaxSolverConfig
from pcg_mpi_solver_tpu.models.octree import make_octree_model as jax_octree
from pcg_mpi_solver_tpu.models.synthetic import (
    make_glued_blocks_model as jax_glued, make_poisson_model as jax_poisson)
from pcg_mpi_solver_tpu.ops.matvec import Ops as JaxOps
from pcg_mpi_solver_tpu.ops.matvec import device_data as jax_device_data
from pcg_mpi_solver_tpu.parallel.mesh import make_mesh
from pcg_mpi_solver_tpu.parallel.partition import (
    partition_model as jax_partition)
from pcg_mpi_solver_tpu.solver import Solver as JaxSolver
from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig
from pcg_mpi_solver_tpu_torch.models import (
    make_glued_blocks_model, make_octree_model, make_poisson_model)
from pcg_mpi_solver_tpu_torch.ops.matvec import (
    BUCKET_VALUES, Ops, device_data, plan_buckets)
from pcg_mpi_solver_tpu_torch.parallel import partition_from_numpy
from pcg_mpi_solver_tpu_torch.solver import ManySolveResult, Solver

OCTREE = ((2, 2, 2), dict(max_level=3, n_incl=2, seed=3, E=30e9,
                          load_value=1e6))
GLUED = ((2, 3, 2, 2), dict(E=3.0, penalty=50.0))
POISSON = ((4, 3, 3), dict(heterogeneous=True, seed=2))
OPERATOR_CASES = {
    "octree": (jax_octree, OCTREE), "glued": (jax_glued, GLUED),
    "poisson": (jax_poisson, POISSON)}


def carried(name, n_parts):
    """The JAX partition of a model and its carry-across into the port."""
    gen, (args, kw) = OPERATOR_CASES[name]
    pj = jax_partition(gen(*args, **kw), n_parts)
    return pj, partition_from_numpy(pj)


def seeded_x(pm, seed=1, cols=()):
    """A seeded vector on the real dofs (padding 0), or a (R, P, n_loc)
    block of ``len(cols)`` scaled copies plus noise."""
    rng = np.random.default_rng(seed)
    x = np.where(pm.dof_gid >= 0, rng.standard_normal(pm.dof_gid.shape),
                 0.0)
    if not cols:
        return x
    return np.stack([c * x + np.where(pm.dof_gid >= 0, rng.standard_normal(
        x.shape), 0.0) for c in cols])


def rel_err(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("name,n_parts", [
    ("octree", 1), ("octree", 3), ("glued", 1), ("glued", 3),
    ("poisson", 1), ("poisson", 3)])
def test_operator_matches_jax(name, n_parts):
    pj, pm = carried(name, n_parts)
    if name == "poisson" or (name == "glued" and n_parts == 3):
        assert pm.ell is None                  # the flat dof rows
    else:
        assert pm.ell is not None
    jops, jdata = JaxOps.from_model(pj), jax_device_data(pj)
    ops, data = Ops.from_model(pm), device_data(pm, torch.float64, "cpu")
    assert ops.row_width == (3 if pm.ell is not None else 1)
    x = seeded_x(pm)
    xt = torch.as_tensor(x)
    for meth in ("matvec_local", "matvec"):
        yj = np.asarray(jax.jit(getattr(jops, meth))(jdata, x))
        yt = getattr(ops, meth)(data, xt).numpy()
        assert rel_err(yt, yj) <= 1e-12, meth
    dj = np.asarray(jax.jit(jops.diag)(jdata))
    assert rel_err(ops.diag(data).numpy(), dj) <= 1e-12
    if pm.ell is not None:
        bj = np.asarray(jax.jit(jops.node_block_diag)(jdata))
        bt = ops.node_block_diag(data).numpy()
        assert bt.shape == bj.shape
        assert rel_err(bt, bj) <= 1e-12
    else:
        with pytest.raises(ValueError, match="node-contiguous"):
            ops.node_block_diag(data)
    # one bucket a sign sub-type (the small models above fit one bucket
    # at the default cost): the same operator through many buckets
    ops0 = Ops.from_model(pm, bucket_values=0)
    if name == "octree":
        assert len(ops0.buckets) > len(pm.type_blocks)
    y0 = ops0.matvec(device_data(pm, torch.float64, "cpu",
                                 bucket_values=0), xt).numpy()
    assert rel_err(y0, np.asarray(jax.jit(jops.matvec)(jdata, x))) <= 1e-12
    # float32
    data32 = device_data(pm, torch.float32, "cpu")
    j32 = np.asarray(jax.jit(jops.matvec)(jax_device_data(pj, np.float32),
                                          x.astype(np.float32)))
    t32 = ops.matvec(data32, torch.as_tensor(x, dtype=torch.float32))
    assert t32.dtype == torch.float32
    np.testing.assert_allclose(t32.numpy(), j32, rtol=2e-5,
                               atol=2e-5 * np.abs(j32).max())


@pytest.mark.parametrize("name", ["octree", "glued"])
def test_block_of_columns_equals_single_matvecs(name):
    _pj, pm = carried(name, 3)
    ops, data = Ops.from_model(pm), device_data(pm, torch.float64, "cpu")
    xb = torch.as_tensor(seeded_x(pm, seed=2, cols=(1.0, 2.0, -0.5)))
    yb = ops.matvec(data, xb)
    assert yb.shape == xb.shape
    assert ops.block_data(data, 3) is data
    for r in range(3):
        assert torch.equal(yb[r], ops.matvec(data, xb[r]))


def test_matvec_repeats_bitwise_and_leaves_x_alone():
    _pj, pm = carried("glued", 1)
    ops, data = Ops.from_model(pm), device_data(pm, torch.float64, "cpu")
    x = torch.as_tensor(seeded_x(pm))
    x0 = x.clone()
    assert torch.equal(ops.matvec(data, x), ops.matvec(data, x))
    assert torch.equal(x, x0)


def cost(sizes, groups, bucket_values):
    return sum(bucket_values + len(g) * max(sizes[t][0] for t in g)
               * max(sizes[t][1] for t in g) for g in groups)


def test_plan_buckets_is_the_least_cost_cut():
    """Every type in one bucket; the cut of the size-sorted types is the
    cheapest contiguous one (checked against every cut of six types); no
    bucket cost keeps padding-free buckets apart only, a huge one merges
    everything; the largest type stays alone at the default cost."""
    import itertools

    sizes = [(64, 24), (56, 24), (8, 30), (8, 24), (16, 78), (8, 27)]
    order = sorted(range(6), key=lambda t: (-sizes[t][0], -sizes[t][1], t))
    for bv in (0, 50, 500, 5000, 1e9):
        groups = plan_buckets(sizes, bv)
        assert sorted(t for g in groups for t in g) == list(range(6))
        cuts = [min(cost(sizes, [order[a:b] for a, b in zip(
            (0,) + c, c + (6,))], bv) for c in itertools.combinations(
                range(1, 6), k)) for k in range(6)]
        assert cost(sizes, groups, bv) == min(cuts)
    assert len(plan_buckets(sizes, 0)) == 6
    assert plan_buckets(sizes, 1e9) == [order]
    brick = [(1_000_000, 24)] + sizes
    assert plan_buckets(brick, BUCKET_VALUES)[0] == [0]


# ----------------------------------------------------------------------
# Solves through Solver
# ----------------------------------------------------------------------

def solver_pair(gen_j, gen_t, case, sc, n_parts=1):
    args, kw = case
    js = JaxSolver(gen_j(*args, **kw), JaxRunConfig(
        solver=JaxSolverConfig(iters_per_dispatch=0, **sc)),
        mesh=make_mesh(1), n_parts=n_parts)
    ts = Solver(gen_t(*args, **kw), RunConfig(solver=SolverConfig(**sc)),
                n_parts=n_parts, device="cpu", backend="general")
    assert js.backend == ts.backend == "general"
    # MATLAB's MoreSteps budget stays positive
    assert ts.pm.glob_n_dof_eff - sc["max_iter"] >= 5
    return js, ts


def check_step(js, ts, sc, delta=1.0):
    rj, rt = js.step(delta), ts.step(delta)
    assert rt.flag == rj.flag == 0
    assert rt.relres <= sc["tol"]
    if sc.get("precision_mode", "direct") == "direct":
        assert abs(rt.iters - rj.iters) <= 1
        rel = 1e-8
    else:
        assert abs(rt.iters - rj.iters) <= max(3, 0.05 * rj.iters)
        rel = 1e-5
    uj, ut = js.displacement_global(), ts.displacement_global()
    assert ut.shape == uj.shape
    np.testing.assert_allclose(ut, uj, rtol=0, atol=rel * np.abs(uj).max())
    return rt


@pytest.mark.parametrize("mode,precond,variant", [
    ("direct", "jacobi", "classic"), ("mixed", "jacobi", "classic"),
    ("direct", "block3", "classic"), ("mixed", "block3", "classic"),
    ("direct", "jacobi", "fused"), ("direct", "jacobi", "pipelined")])
def test_octree_solve_matches_jax(mode, precond, variant):
    sc = dict(tol=1e-8, max_iter=1000, precision_mode=mode,
              precond=precond, pcg_variant=variant)
    js, ts = solver_pair(jax_octree, make_octree_model, OCTREE, sc)
    check_step(js, ts, sc)


def test_octree_two_parts_against_one():
    sc = dict(tol=1e-8, max_iter=1000)
    args, kw = OCTREE
    m = make_octree_model(*args, **kw)
    runs = []
    for P in (1, 2):
        s = Solver(m, RunConfig(solver=SolverConfig(**sc)), n_parts=P,
                   device="cpu")
        assert s.backend == "general"
        assert (s.pm.n_iface > 0) == (P == 2)
        r = s.step(1.0)
        runs.append((r, s.displacement_global()))
    (r1, u1), (r2, u2) = runs
    assert r1.flag == r2.flag == 0 and abs(r1.iters - r2.iters) <= 1
    np.testing.assert_allclose(u2, u1, rtol=0, atol=1e-8 * np.abs(u1).max())


def test_glued_blocks_mixed_matches_jax():
    sc = dict(tol=1e-8, max_iter=150, precision_mode="mixed")
    js, ts = solver_pair(jax_glued, make_glued_blocks_model, GLUED, sc)
    assert "springs" in ts.data
    check_step(js, ts, sc)


def test_poisson_direct_matches_jax():
    sc = dict(tol=1e-8, max_iter=40)
    js, ts = solver_pair(jax_poisson, make_poisson_model, POISSON, sc)
    assert ts.ops.row_width == 1
    check_step(js, ts, sc)


def test_solve_many_matches_jax():
    sc = dict(tol=1e-8, max_iter=1000)
    js, ts = solver_pair(jax_octree, make_octree_model, OCTREE, sc)
    args, kw = OCTREE
    m = make_octree_model(*args, **kw)
    Fy = np.zeros(m.n_dof)
    Fy[1::3] = m.F[0::3]                       # the face forces along y
    glob = np.stack([m.F, Fy], axis=-1)
    rj, rt = js.solve_many(glob), ts.solve_many(glob)
    assert isinstance(rt, ManySolveResult) and rt.nrhs == 2
    np.testing.assert_array_equal(rt.flags, np.asarray(rj.flags))
    assert (rt.flags == 0).all() and (rt.relres <= sc["tol"]).all()
    assert np.abs(rt.iters - np.asarray(rj.iters)).max() <= 1
    uj = js.displacement_global_many(rj.x)
    ut = ts.displacement_global_many(rt.x)
    np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-8 * np.abs(uj).max())


# ----------------------------------------------------------------------
# Backend choice and refusals
# ----------------------------------------------------------------------

def test_backend_choice_follows_jax():
    from pcg_mpi_solver_tpu_torch.models import make_cube_model

    cube = make_cube_model(4, 3, 3)
    cfg = RunConfig()
    assert Solver(cube, cfg, device="cpu").backend == "structured"
    for kw in (dict(backend="general"), dict(n_parts=3),
               dict(elem_part=np.zeros(cube.n_elem, np.int32))):
        assert Solver(cube, cfg, device="cpu", **kw).backend == "general"
    slab2 = dataclasses.replace(cfg, partition_method="slab2")
    assert Solver(cube, slab2, device="cpu").backend == "general"
    args, kw = OCTREE
    octree = make_octree_model(*args, **kw)
    assert Solver(octree, cfg, device="cpu").backend == "general"
    with pytest.raises(ValueError, match="structured backend requested"):
        Solver(octree, cfg, device="cpu", backend="structured")
    with pytest.raises(ValueError, match="backend must be"):
        Solver(cube, cfg, device="cpu", backend="slab")


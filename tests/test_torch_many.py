"""The port's blocked right-hand sides (``pcg_many``, ``pcg_mixed_many``,
``Solver.solve_many``) against the JAX package's, on the same seeded
inputs (CPU), at 8x4x4 with one and two parts.

The port carries a block as (R, P, n_loc), the JAX package as (P, n_loc,
R); the tests move the axis at the boundary.  Windows:

- The blocked ops (``matvec`` over two parts with distinct columns, so a
  halo that leaked across columns would show; ``wdot_many``,
  ``wdots_many``; ``apply_prec`` under jacobi, block3 and mg): float64
  within 1e-12 of the largest value, float32 within the 2e-5 of
  ``tests/test_pallas.py``.
- ``pcg_many`` direct float64 under each variant and preconditioner, on
  the block [F, 0.5 F, a random load, 0]: the same flags, the same
  iterations per column, one apart only where the test shows that the
  reduction order alone moves that column's count (the same package's
  solve on the other partition, another order of the same sums, takes
  another count), relres <= tol, x within 1e-8 of max|x|.
- ``pcg_mixed_many`` and ``Solver.solve_many`` in mixed precision: the
  same flags, per-column totals within max(3, 5 %), the ground rules'
  mixed window.  ``inner_tol=1e-4``: the default sits at this model's
  float32 floor (``tests/test_torch_mg.py`` says why).  The JAX Solver
  runs with ``iters_per_dispatch=0``, its one-shot blocked program: a
  chunked JAX blocked solve runs the per-column recovery ladder, which
  the port does not have.
- In the port alone: each column of a classic direct block bit for bit
  equal to ``solve_many`` of that column alone (the per-column reductions
  and the R * P-slab matvec sum each column in the order of a width-1
  block on the CPU); a frozen column keeping its solo bits; 2F taking
  F's iterations with x exactly 2 x(F).
- A budget exit (each failed column's min-residual iterate), the drift
  guard on one column (flag 6, then quarantined as flag 5 by the
  one-shot post-pass, as in the JAX Solver), ``check_rhs_block`` and
  ``normalize_rhs_block`` against the JAX package's, and the block-width
  bound.  The chunked blocked path (resume, snapshots, the per-column
  ladder) is ``tests/test_torch_many_chunked.py``.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pcg_mpi_solver_tpu_torch.solver.pcg as pcg_mod
from pcg_mpi_solver_tpu import RunConfig as JaxRunConfig
from pcg_mpi_solver_tpu import SolverConfig as JaxSolverConfig
from pcg_mpi_solver_tpu.models.synthetic import make_cube_model as jax_cube
from pcg_mpi_solver_tpu.ops import mg as jmg
from pcg_mpi_solver_tpu.ops.precond import make_prec as jax_make_prec
from pcg_mpi_solver_tpu.parallel.mesh import make_mesh
from pcg_mpi_solver_tpu.parallel.structured import (
    StructuredOps as JaxStructuredOps, device_data_structured as jax_data,
    partition_structured as jax_partition)
from pcg_mpi_solver_tpu.solver import Solver as JaxSolver
from pcg_mpi_solver_tpu.solver.driver import (
    normalize_rhs_block as jax_normalize)
from pcg_mpi_solver_tpu.validate import check_rhs_block as jax_check_rhs
from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig
from pcg_mpi_solver_tpu_torch.models import make_cube_model
from pcg_mpi_solver_tpu_torch.ops import mg
from pcg_mpi_solver_tpu_torch.ops.precond import make_prec
from pcg_mpi_solver_tpu_torch.parallel.structured import (
    StructuredOps, block_data, device_data_structured, partition_from_numpy)
from pcg_mpi_solver_tpu_torch.solver import (
    ManySolveResult, Solver, normalize_rhs_block)
from pcg_mpi_solver_tpu_torch.validate import (
    PreflightError, check_rhs_block)

# the JAX package's solver/__init__ exports the function under the module's
# name
jax_pcg_mod = importlib.import_module("pcg_mpi_solver_tpu.solver.pcg")

DIMS = (8, 4, 4)            # n_eff 600: max_iter 500 keeps MoreSteps at 5
TOL, MAX_ITER = 1e-8, 500
CUBE = dict(E=30e9, nu=0.3, heterogeneous=True, seed=5, load="traction",
            load_value=1e6)
DTYPES = {"64": (jnp.float64, torch.float64),
          "32": (jnp.float32, torch.float32)}
VARIANTS = ("classic", "fused", "pipelined")
PRECONDS = ("jacobi", "block3", "mg")
MIXED = dict(tol=1e-7, max_iter=MAX_ITER, inner_tol=1e-4)


def global_loads(model, seed=5):
    """The block's global columns: F, 0.5 F, a random load on the
    effective dofs (a rough rhs converges slower than the smooth
    traction), and a zero column."""
    F = np.asarray(model.F, np.float64)
    rng = np.random.default_rng(seed)
    hard = np.zeros(model.n_dof)
    eff = np.asarray(model.dof_eff)
    hard[eff] = rng.standard_normal(eff.size) * np.abs(F).max()
    return np.stack([F, 0.5 * F, hard, np.zeros_like(F)], axis=-1)


def local_block(sp, glob):
    """(n_dof, R) global columns -> the port's (R, P, n_loc) eff-restricted
    block (shared planes carry their value on both parts)."""
    gid = np.asarray(sp.dof_gid)
    loc = glob[np.clip(gid, 0, None), :] * (gid >= 0)[..., None]
    return np.ascontiguousarray(np.moveaxis(loc, -1, 0)) * sp.eff


def build(n_parts, ops_cls=(JaxStructuredOps, StructuredOps)):
    """Both packages' ops and data (float64 and float32, each with the JAX
    package's mg hierarchy and one lam vector) on the JAX package's
    partition carried across, and the rhs block."""
    jmodel = jax_cube(*DIMS, **CUBE)
    spj = jax_partition(jmodel, n_parts)
    sp = partition_from_numpy({f.name: getattr(spj, f.name)
                               for f in dataclasses.fields(spj)})
    jcls, tcls = ops_cls
    jops = {k: jcls.from_partition(spj, dot_dtype=jd)
            for k, (jd, _) in DTYPES.items()}
    tops = {k: tcls.from_partition(sp, dot_dtype=td)
            for k, (_, td) in DTYPES.items()}
    jdat = {k: jax_data(spj, jd) for k, (jd, _) in DTYPES.items()}
    tdat = {k: device_data_structured(sp, td, "cpu")
            for k, (_, td) in DTYPES.items()}
    setup = jmg.build_mg_host(jmodel, spj)
    lam = np.asarray([mg.estimate_fine_lam(tops["64"], tdat["64"])]
                     + setup.coarse_lams)
    for k, (jd, td) in DTYPES.items():
        jdat[k]["mg"] = jax.tree.map(jnp.asarray,
                                     jmg.cast_tree(setup.tree, jd))
        jdat[k]["mg"]["lam"] = jnp.asarray(lam, jd)
        tdat[k]["mg"] = mg.tree_from_numpy(setup.tree, td, "cpu")
        tdat[k]["mg"]["lam"] = lam.astype(np.dtype(jd))
    blk = local_block(sp, global_loads(jmodel))
    return dict(sp=sp, jops=jops, jdat=jdat, tops=tops, tdat=tdat, blk=blk)


@pytest.fixture(scope="module")
def cases():
    return {P: build(P) for P in (1, 2)}


def to_jax(blk, d="64"):
    return jnp.asarray(np.moveaxis(blk, 0, -1), DTYPES[d][0])


def from_jax(a):
    return np.moveaxis(np.asarray(a), -1, 0)


@pytest.fixture(scope="module")
def jax_many(cases):
    """The JAX package's ``pcg_many`` results, each computed once."""
    memo = {}

    def run(n_parts, variant, precond, **kw):
        key = (n_parts, variant, precond, tuple(sorted(kw.items())))
        if key not in memo:
            b = cases[n_parts]
            jo, jd = b["jops"]["64"], b["jdat"]["64"]
            f = to_jax(b["blk"])
            args = dict(dict(tol=TOL, max_iter=MAX_ITER,
                             glob_n_dof_eff=b["sp"].glob_n_dof_eff), **kw)
            memo[key] = jax_pcg_mod.pcg_many(
                jo, jd, f, jnp.zeros_like(f), jax_make_prec(jo, jd, precond),
                x0_zero=True, variant=variant, **args)
        return memo[key]

    return run


def port_many(b, variant, precond, ops=None, **kw):
    to, td = ops or b["tops"]["64"], b["tdat"]["64"]
    f = torch.as_tensor(b["blk"])
    args = dict(dict(tol=TOL, max_iter=MAX_ITER,
                     glob_n_dof_eff=b["sp"].glob_n_dof_eff), **kw)
    return pcg_mod.pcg_many(to, block_data(td, f.shape[0]), f,
                            torch.zeros_like(f), make_prec(to, td, precond),
                            x0_zero=True, variant=variant, **args)


def assert_close(a, b, d):
    scale = np.abs(b).max()
    if d == "64":
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12 * scale)
    else:
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5 * scale)


# ----------------------------------------------------------------------
# The blocked ops
# ----------------------------------------------------------------------

def random_block(b, d, R=3, seed=11):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((R,) + b["sp"].eff.shape)
    return x.astype(np.dtype(DTYPES[d][0]))


@pytest.mark.parametrize("d", ["64", "32"])
@pytest.mark.parametrize("n_parts", [1, 2])
def test_blocked_matvec_matches_jax(cases, n_parts, d):
    """Distinct columns over two parts: each column's shared plane sums
    its own two partial copies (a halo over the flattened R * P axis
    would add column j's last part into column j+1's first)."""
    b = cases[n_parts]
    x = random_block(b, d)
    yj = from_jax(b["jops"][d].matvec(b["jdat"][d], to_jax(x, d)))
    yt = b["tops"][d].matvec(block_data(b["tdat"][d], 3), torch.as_tensor(x))
    assert yt.shape == x.shape
    assert_close(yt.numpy(), yj, d)
    for j in range(3):
        assert torch.equal(yt[j], b["tops"][d].matvec(b["tdat"][d],
                                                      torch.as_tensor(x[j])))


def test_blocked_matvec_needs_its_width(cases):
    b = cases[2]
    x = torch.as_tensor(random_block(b, "64"))
    with pytest.raises(ValueError, match=r"block_data\(data, 3\)"):
        b["tops"]["64"].matvec(block_data(b["tdat"]["64"], 2), x)


@pytest.mark.parametrize("d", ["64", "32"])
@pytest.mark.parametrize("n_parts", [1, 2])
def test_blocked_dots_match_jax(cases, n_parts, d):
    b = cases[n_parts]
    x, y = random_block(b, d, seed=1), random_block(b, d, seed=2)
    jo, to = b["jops"][d], b["tops"][d]
    wj = b["jdat"][d]["weight"] * b["jdat"][d]["eff"]
    wt = b["tdat"][d]["weight"] * b["tdat"][d]["eff"]
    extra = np.asarray([1.0, 0.0, 2.0])
    rj = jo.wdots_many(wj, [(to_jax(x, d), to_jax(y, d)),
                            (to_jax(x, d), to_jax(x, d))], extra=[extra])
    X, Y = torch.as_tensor(x), torch.as_tensor(y)
    rt = to.wdots_many(wt, [(X, Y), (X, X)], extra=[torch.as_tensor(extra)])
    assert rt.shape == (3, 3) and rt.dtype == DTYPES[d][1]
    assert_close(rt.numpy(), np.asarray(rj), d)
    assert_close(to.wdot_many(wt, X, Y).numpy(),
                 np.asarray(jo.wdot_many(wj, to_jax(x, d), to_jax(y, d))), d)
    np.testing.assert_array_equal(rt[0].numpy(),
                                  to.wdot_many(wt, X, Y).numpy())


@pytest.mark.parametrize("n_parts,precond,d", [
    (2, pc, d) for pc in PRECONDS for d in ("64", "32")]
    + [(1, "jacobi", "64")])
def test_blocked_apply_prec_matches_jax(cases, n_parts, precond, d):
    b = cases[n_parts]
    r = (random_block(b, d) * b["sp"].eff).astype(np.dtype(DTYPES[d][0]))
    jo, jd, to, td = b["jops"][d], b["jdat"][d], b["tops"][d], b["tdat"][d]
    zj = from_jax(jo.apply_prec(jax_make_prec(jo, jd, precond),
                                to_jax(r, d), data=jd))
    m = make_prec(to, td, precond)
    zt = to.apply_prec(m, torch.as_tensor(r), block_data(td, 3))
    assert zt.shape == r.shape and zt.dtype == DTYPES[d][1]
    assert_close(zt.numpy(), zj, d)
    for j in range(3):
        assert torch.equal(zt[j], to.apply_prec(m, torch.as_tensor(r[j]), td))


# ----------------------------------------------------------------------
# pcg_many, direct float64
# ----------------------------------------------------------------------

# every variant under every preconditioner on two parts (the halo), each
# variant under jacobi on one
DIRECT_CASES = ([(2, v, pc) for v in VARIANTS for pc in PRECONDS]
                + [(1, v, "jacobi") for v in VARIANTS])


@pytest.mark.parametrize("n_parts,variant,precond", DIRECT_CASES)
def test_pcg_many_direct_matches_jax(cases, jax_many, n_parts, variant,
                                     precond):
    """Per column: the same flag and iterations, or one apart where the
    same package's solve on the other partition takes another count for
    that column (two parts: classic block3 on F, JAX 70 on two parts and
    71 on one; fused jacobi on the random load, the port 128 on two parts
    and 129 on one; pipelined jacobi on it, JAX 129 and 130)."""
    rj = jax_many(n_parts, variant, precond)
    rt = port_many(cases[n_parts], variant, precond)
    np.testing.assert_array_equal(rt.flag, np.asarray(rj.flag))
    assert (rt.flag == 0).all()
    ij, it = np.asarray(rj.iters), rt.iters
    off = np.flatnonzero(ij != it)
    if off.size:
        other = 3 - n_parts
        jo = np.asarray(jax_many(other, variant, precond).iters)
        to = port_many(cases[other], variant, precond).iters
        for j in off:
            assert abs(int(ij[j]) - int(it[j])) == 1, (j, ij, it)
            assert jo[j] != ij[j] or to[j] != it[j], (j, ij, it, jo, to)
    assert it[3] == 0 and not rt.x[3].any()
    assert (rt.relres <= TOL).all() and rt.relres.dtype == np.float32
    xj = from_jax(rj.x)
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=0,
                               atol=1e-8 * np.abs(xj).max())
    assert rt.trips >= it.max()


@pytest.mark.parametrize("variant", VARIANTS)
def test_budget_exit_returns_min_residual_iterates_like_jax(
        cases, jax_many, variant):
    """max_iter 17 at tol 1e-12: every running column exits flag 1 with
    its min-residual iterate (classic: where its true residual is the
    smaller), its index and its recomputed relres."""
    kw = dict(tol=1e-12, max_iter=17)
    rj = jax_many(2, variant, "jacobi", **kw)
    rt = port_many(cases[2], variant, "jacobi", **kw)
    np.testing.assert_array_equal(rt.flag, [1, 1, 1, 0])
    np.testing.assert_array_equal(rt.flag, np.asarray(rj.flag))
    np.testing.assert_array_equal(rt.iters, np.asarray(rj.iters))
    np.testing.assert_allclose(rt.relres, np.asarray(rj.relres), rtol=1e-6)
    xj = from_jax(rj.x)
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=0,
                               atol=1e-10 * np.abs(xj).max())
    # the relres is the returned iterate's true residual
    b = cases[2]
    to, td = b["tops"]["64"], b["tdat"]["64"]
    w = td["weight"] * td["eff"]
    f = torch.as_tensor(b["blk"])
    r = f - td["eff"] * to.matvec(block_data(td, 4), rt.x)
    rel = np.sqrt(to.wdot_many(w, r, r).numpy()[:3]
                  / to.wdot_many(w, f, f).numpy()[:3])
    np.testing.assert_allclose(rt.relres[:3], rel, rtol=1e-6)


LIE = 1e-20     # the recurrence's squared residual norm of column 1, scaled


class LyingJaxOps(JaxStructuredOps):
    """The five-dot reduction of the lagged bodies reports column 1's
    ||r||^2 x LIE."""

    def wdots_many(self, w, pairs, extra=()):
        out = super().wdots_many(w, pairs, extra)
        return out.at[2, 1].multiply(LIE) if len(pairs) == 5 else out


class LyingOps(StructuredOps):
    def wdots_many(self, w, pairs, extra=()):
        out = super().wdots_many(w, pairs, extra)
        if len(pairs) == 5:
            out = out.clone()
            out[2, 1] *= LIE
        return out


@pytest.mark.parametrize("variant", ["fused", "pipelined"])
def test_drift_guard_per_column_like_jax(variant):
    """Column 1's recurrence norm lies: each of its candidate checks finds
    a true residual far above it, and at the variant's limit (3 fused, 2
    pipelined) it exits with flag 6 while the others converge, in both
    packages; the one-shot Solver reports it quarantined (flag 5)."""
    b = build(1, ops_cls=(LyingJaxOps, LyingOps))
    jo, jd = b["jops"]["64"], b["jdat"]["64"]
    f = to_jax(b["blk"])
    rj = jax_pcg_mod.pcg_many(
        jo, jd, f, jnp.zeros_like(f), jax_make_prec(jo, jd, "jacobi"),
        tol=TOL, max_iter=MAX_ITER, glob_n_dof_eff=b["sp"].glob_n_dof_eff,
        x0_zero=True, variant=variant)
    rt = port_many(b, variant, "jacobi")
    np.testing.assert_array_equal(rt.flag, [0, pcg_mod.DRIFT_FLAG, 0, 0])
    np.testing.assert_array_equal(rt.flag, np.asarray(rj.flag))
    np.testing.assert_array_equal(rt.iters, np.asarray(rj.iters))
    # the drifted column's min-residual iterate, recomputed relres
    np.testing.assert_allclose(rt.relres[1], np.asarray(rj.relres)[1],
                               rtol=1e-6)
    assert (rt.relres[[0, 2, 3]] <= TOL).all()

    sc = dict(tol=TOL, max_iter=MAX_ITER, pcg_variant=variant)
    js = JaxSolver(jax_cube(*DIMS, **CUBE), JaxRunConfig(
        solver=JaxSolverConfig(iters_per_dispatch=0, **sc)),
        mesh=make_mesh(1), n_parts=1)
    js.ops = LyingJaxOps(**{fl.name: getattr(js.ops, fl.name)
                            for fl in dataclasses.fields(js.ops)})
    ts = Solver(make_cube_model(*DIMS, **CUBE),
                RunConfig(solver=SolverConfig(**sc)), device="cpu")
    ts.ops = LyingOps(**{fl.name: getattr(ts.ops, fl.name)
                         for fl in dataclasses.fields(ts.ops)})
    glob = global_loads(make_cube_model(*DIMS, **CUBE))
    mj, mt = js.solve_many(glob), ts.solve_many(glob)
    np.testing.assert_array_equal(mt.flags, [0, pcg_mod.QUARANTINE_FLAG,
                                             0, 0])
    np.testing.assert_array_equal(mt.flags, np.asarray(mj.flags))
    assert mt.quarantined == tuple(mj.quarantined) == (1,)
    np.testing.assert_array_equal(mt.iters, np.asarray(mj.iters))


# ----------------------------------------------------------------------
# Mixed precision
# ----------------------------------------------------------------------

def within_mixed_window(it, ij):
    return all(abs(int(a) - int(b)) <= max(3, 0.05 * int(b))
               for a, b in zip(it, ij))


@pytest.mark.parametrize("variant,precond,n_parts", [
    ("classic", "block3", 2), ("fused", "jacobi", 2), ("fused", "mg", 1),
    ("pipelined", "mg", 2)])
def test_pcg_mixed_many_matches_jax(cases, variant, precond, n_parts):
    b = cases[n_parts]
    args = dict(tol=MIXED["tol"], max_iter=MAX_ITER,
                glob_n_dof_eff=b["sp"].glob_n_dof_eff,
                inner_tol=MIXED["inner_tol"], variant=variant)
    f = to_jax(b["blk"])
    jo32, jd32 = b["jops"]["32"], b["jdat"]["32"]
    rj = jax_pcg_mod.pcg_mixed_many(
        jo32, jd32, b["jops"]["64"], b["jdat"]["64"], f, jnp.zeros_like(f),
        jax_make_prec(jo32, jd32, precond), **args)
    ft = torch.as_tensor(b["blk"])
    to32, td32 = b["tops"]["32"], b["tdat"]["32"]
    rt = pcg_mod.pcg_mixed_many(
        to32, block_data(td32, 4), b["tops"]["64"],
        block_data(b["tdat"]["64"], 4), ft, torch.zeros_like(ft),
        make_prec(to32, td32, precond), **args)
    np.testing.assert_array_equal(rt.flag, np.asarray(rj.flag))
    assert (rt.flag == 0).all() and (rt.relres <= MIXED["tol"]).all()
    assert within_mixed_window(rt.iters, np.asarray(rj.iters))
    assert rt.iters[3] == 0 and not rt.x[3].any()
    xj = from_jax(rj.x)
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=0,
                               atol=1e-5 * np.abs(xj).max())


@pytest.mark.parametrize("mode,variant,precond,n_parts", [
    ("mixed", "classic", "jacobi", 1), ("mixed", "classic", "mg", 2),
    ("mixed", "fused", "block3", 2), ("mixed", "pipelined", "mg", 1),
    ("direct", "classic", "block3", 2)])
def test_solve_many_matches_jax(mode, variant, precond, n_parts):
    """Through each package's Solver on the global block: flags, per-column
    iterations (direct within the +-1 of the reduction order, mixed within
    the mixed window), relres <= tol, the global columns."""
    sc = dict(precision_mode=mode, pcg_variant=variant, precond=precond,
              max_iter=MAX_ITER,
              **(dict(tol=MIXED["tol"], inner_tol=MIXED["inner_tol"])
                 if mode == "mixed" else dict(tol=TOL)))
    js = JaxSolver(jax_cube(*DIMS, **CUBE), JaxRunConfig(
        solver=JaxSolverConfig(iters_per_dispatch=0, **sc)),
        mesh=make_mesh(n_parts), n_parts=n_parts)
    model = make_cube_model(*DIMS, **CUBE)
    ts = Solver(model, RunConfig(solver=SolverConfig(**sc)),
                n_parts=n_parts, device="cpu")
    glob = global_loads(model)
    rj, rt = js.solve_many(glob), ts.solve_many(glob)
    assert isinstance(rt, ManySolveResult) and rt.nrhs == 4
    np.testing.assert_array_equal(rt.flags, np.asarray(rj.flags))
    assert (rt.flags == 0).all() and (rt.relres <= sc["tol"]).all()
    if mode == "direct":
        assert np.abs(rt.iters - np.asarray(rj.iters)).max() <= 1
    else:
        assert within_mixed_window(rt.iters, np.asarray(rj.iters))
    assert rt.x.shape == (n_parts, ts.pm.n_loc, 4)
    assert rt.quarantined == () and rt.recoveries == 0 == rt.drift
    assert 0 < rt.solve_wall_s <= rt.wall_s
    uj = js.displacement_global_many(rj.x)
    ut = ts.displacement_global_many(rt.x)
    assert ut.shape == uj.shape == (model.n_dof, 4)
    rel = 1e-8 if mode == "direct" else 1e-5
    np.testing.assert_allclose(ut, uj, rtol=0, atol=rel * np.abs(uj).max())


# ----------------------------------------------------------------------
# The port alone: columns against width 1, frozen columns, exact scaling
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def direct2():
    model = make_cube_model(*DIMS, **CUBE)
    return model, Solver(model, RunConfig(solver=SolverConfig(
        tol=TOL, max_iter=MAX_ITER)), n_parts=2, device="cpu")


def test_columns_match_width1_solves_bitwise(direct2):
    """Classic direct, two parts: each column of the block, bit for bit,
    is ``solve_many`` of that column alone (flag, iterations, x)."""
    model, s = direct2
    glob = global_loads(model)
    blk = s.solve_many(glob)
    np.testing.assert_array_equal(blk.flags, [0, 0, 0, 0])
    for j in range(glob.shape[1]):
        one = s.solve_many(glob[:, j])
        assert one.nrhs == 1
        assert (int(one.flags[0]), int(one.iters[0])) == (
            int(blk.flags[j]), int(blk.iters[j]))
        assert one.relres[0] == blk.relres[j]
        assert torch.equal(one.x[..., 0], blk.x[..., j])
    assert blk.iters[3] == 0 and not blk.x[..., 3].any()


def test_frozen_column_keeps_its_solo_bits(direct2):
    """An easy column (the image of a smooth ramp displacement: low modes,
    few iterations) beside a hard one (the random load): the hard one
    iterates on after the easy one froze, and the easy one's result is
    its solo solve's, bit for bit."""
    model, s = direct2
    ramp = np.zeros(model.n_dof)
    ramp[0::3] = np.asarray(model.node_coords)[:, 0]
    ramp_loc = torch.as_tensor(local_block(s.pm, ramp[:, None]))
    easy_loc = s.data["eff"] * s.ops.matvec(s.data, ramp_loc[0])
    easy = s.displacement_global_many(easy_loc[..., None])[:, 0]
    hard = global_loads(model)[:, 2]
    blk = s.solve_many(np.stack([easy, hard], axis=-1))
    np.testing.assert_array_equal(blk.flags, [0, 0])
    assert int(blk.iters[1]) > int(blk.iters[0])
    solo = s.solve_many(easy)
    assert int(solo.iters[0]) == int(blk.iters[0])
    assert torch.equal(solo.x[..., 0], blk.x[..., 0])


@pytest.mark.parametrize("mode", ["direct", "mixed"])
def test_doubled_load_doubles_the_solution_exactly(mode):
    """Power-of-two scaling is exact through the dots, the square roots
    and the matvec: the column 2F takes F's iterations and its x is 2
    x(F), bit for bit."""
    model = make_cube_model(*DIMS, **CUBE)
    sc = dict(tol=TOL, max_iter=MAX_ITER) if mode == "direct" else MIXED
    s = Solver(model, RunConfig(solver=SolverConfig(precision_mode=mode,
                                                    **sc)),
               n_parts=2, device="cpu")
    F = np.asarray(model.F)
    r = s.solve_many(np.stack([F, 2 * F]))        # (R, n_dof) stack
    np.testing.assert_array_equal(r.flags, [0, 0])
    assert r.iters[0] == r.iters[1] and r.relres[0] == r.relres[1]
    assert torch.equal(r.x[..., 1], 2 * r.x[..., 0])


# ----------------------------------------------------------------------
# Requests: validation, shapes, refusals
# ----------------------------------------------------------------------

def test_quarantine_flag_matches_jax():
    assert pcg_mod.QUARANTINE_FLAG == jax_pcg_mod.QUARANTINE_FLAG == 5


def test_check_rhs_block_names_the_nan_column(direct2):
    model, s = direct2
    glob = global_loads(model)
    glob[7, 2] = np.nan
    glob[9, 2] = np.inf
    ours = check_rhs_block(glob, model.n_dof)
    theirs = jax_check_rhs(glob, model.n_dof)
    assert [(c.name, c.status, c.detail) for c in ours] == \
        [(c.name, c.status, c.detail) for c in theirs]
    assert any(c.status == "fail" and "rhs 2 (2 non-finite)" in c.detail
               for c in ours)
    with pytest.raises(PreflightError, match=r"rhs 2 \(2 non-finite\)"):
        s.solve_many(glob)


@pytest.mark.parametrize("bad", ["rows", "ndim", "dtype", "spread"])
def test_check_rhs_block_matches_jax(bad):
    n = 30
    a = {"rows": np.ones((n + 1, 2)), "ndim": np.ones((n, 2, 1)),
         "dtype": np.ones((n, 2), np.int64),
         "spread": np.stack([np.ones(n), 1e-12 * np.ones(n)], -1)}[bad]
    assert [(c.name, c.status, c.detail) for c in check_rhs_block(a, n)] \
        == [(c.name, c.status, c.detail) for c in jax_check_rhs(a, n)]


@pytest.mark.parametrize("shape", ["vector", "columns", "stack"])
def test_normalize_rhs_block_shapes(shape):
    n, R = 12, 3
    cols = np.arange(n * R, dtype=float).reshape(n, R)
    a = {"vector": cols[:, 0], "columns": cols, "stack": cols.T}[shape]
    out = normalize_rhs_block(a, n, np.float64)
    np.testing.assert_array_equal(out, jax_normalize(a, n, np.float64))
    assert out.shape == ((n, 1) if shape == "vector" else (n, R))


def test_nrhs_is_metadata():
    """SolverConfig.nrhs no longer refuses: the width of the block passed
    to solve_many decides the run, as in the JAX package."""
    model = make_cube_model(4, 3, 3)
    s = Solver(model, RunConfig(solver=SolverConfig(nrhs=2)), device="cpu")
    r = s.solve_many(np.stack([model.F, model.F, model.F], -1))
    assert r.nrhs == 3 and (r.flags == 0).all()


def test_block_wider_than_the_indexing_raises(direct2, monkeypatch):
    model, s = direct2
    assert s.max_block_width() == (2**31 - 1) // (2 * s.pm.n_loc)
    monkeypatch.setattr(Solver, "max_block_width", lambda self: 2)
    with pytest.raises(ValueError, match="at most 2 columns"):
        s.solve_many(global_loads(model)[:, :3])

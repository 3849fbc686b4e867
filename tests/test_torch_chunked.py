"""The port's chunked dispatch path against its one-shot path and against
the JAX package's chunked path (CPU).

Direct f64: capped dispatches of the resumable ``pcg`` are bit for bit
the port's one-shot solve (flag, iterations, relres, x), under classic,
fused and pipelined; against the JAX package's chunked solve at the same
cap the flag is equal, the iterations within +-1 (reduction order alone
moves a deferred check across tol) and x within 1e-8 max|x|.  After k
capped calls the port's carry equals the JAX package's leaf by leaf:
integers exactly, floats within 1e-12 relative.  Mixed: the chunked
refinement loop (not ``pcg_mixed``) against the JAX package's at the
same cap, within the max(3, 5 %) window of the f32 inner dots' summation
order.  The budget holds in both modes."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcg_mpi_solver_tpu.config import RunConfig as JaxRunConfig
from pcg_mpi_solver_tpu.config import SolverConfig as JaxSolverConfig
from pcg_mpi_solver_tpu.models.synthetic import make_cube_model as jax_cube
from pcg_mpi_solver_tpu.ops.mg import fallback_operand as jax_fallback_operand
from pcg_mpi_solver_tpu.ops.precond import make_prec as jax_make_prec
from pcg_mpi_solver_tpu.parallel.mesh import make_mesh
from pcg_mpi_solver_tpu.parallel.structured import (
    StructuredOps as JaxStructuredOps, device_data_structured as jax_data,
    partition_structured as jax_partition)
from pcg_mpi_solver_tpu.solver.chunked import (
    auto_dispatch_cap as jax_auto_dispatch_cap)
from pcg_mpi_solver_tpu.solver.driver import Solver as JaxSolver
from pcg_mpi_solver_tpu.solver.pcg import cold_carry as jax_cold_carry
from pcg_mpi_solver_tpu.solver.pcg import pcg as jax_pcg
from pcg_mpi_solver_tpu.solver.pcg import select_best as jax_select_best
from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig
from pcg_mpi_solver_tpu_torch.models import make_cube_model
from pcg_mpi_solver_tpu_torch.ops.mg import fallback_operand, mg_apply
from pcg_mpi_solver_tpu_torch.ops.precond import make_prec
from pcg_mpi_solver_tpu_torch.parallel.structured import (
    StructuredOps, device_data_structured, partition_from_numpy)
from pcg_mpi_solver_tpu_torch.solver import Solver
from pcg_mpi_solver_tpu_torch.solver.chunked import auto_dispatch_cap
from pcg_mpi_solver_tpu_torch.solver.pcg import cold_carry, pcg, select_best

DIMS = (5, 4, 4)


@pytest.fixture(scope="module")
def models():
    return (jax_cube(*DIMS, heterogeneous=True),
            make_cube_model(*DIMS, heterogeneous=True))


def _solvers(models, cap, n_parts=1, **kw):
    kw.setdefault("tol", 1e-8)
    kw.setdefault("max_iter", 2000)
    jm, tm = models
    js = JaxSolver(jm, JaxRunConfig(solver=JaxSolverConfig(
        iters_per_dispatch=cap, **kw)), mesh=make_mesh(1), n_parts=n_parts)
    ts = Solver(tm, RunConfig(solver=SolverConfig(iters_per_dispatch=cap,
                                                  **kw)),
                n_parts=n_parts, device="cpu")
    return js, ts


def _run(s):
    r = s.step(1.0)
    return r, s.displacement_global()


@pytest.mark.parametrize("variant,n_parts,cap", [
    ("classic", 1, 12), ("fused", 1, 12), ("pipelined", 1, 12),
    ("classic", 2, 20)])
def test_direct_chunked_is_bitwise_one_shot_and_matches_jax(
        models, variant, n_parts, cap):
    js, ts = _solvers(models, cap, n_parts, pcg_variant=variant)
    assert ts._dispatch_cap == cap
    (rt, ut), (rj, uj) = _run(ts), _run(js)
    log = list(ts.dispatch_log)
    one = Solver(models[1], RunConfig(solver=SolverConfig(
        tol=1e-8, max_iter=2000, iters_per_dispatch=0,
        pcg_variant=variant)), n_parts=n_parts, device="cpu")
    assert one._dispatch_cap == 0 and one._engine is None
    r1, u1 = _run(one)
    assert (rt.flag, rt.iters, rt.relres) == (r1.flag, r1.iters, r1.relres)
    np.testing.assert_array_equal(ut, u1)
    # the dispatches: capped, summing to the iterations
    assert len(log) == -(-rt.iters // cap) and all(
        k == "cycle" and 0 < n <= cap for k, n, _f in log)
    assert sum(n for _k, n, _f in log) == rt.iters
    assert rt.flag == rj.flag == 0
    assert abs(rt.iters - rj.iters) <= 1
    np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-8 * np.abs(uj).max())


@pytest.mark.parametrize("variant", ["classic", "fused"])
def test_mixed_chunked_matches_jax_chunked(models, variant):
    """The chunked refinement loop: refinement cycles through capped f32
    calls that resume the f32 carry, against the JAX package's at the
    same cap; a cap no cycle reaches gives bitwise the same solve (the
    capped calls of a cycle are one long inner solve)."""
    kw = dict(precision_mode="mixed", pcg_variant=variant)
    js, ts = _solvers(models, 12, **kw)
    (rt, ut), (rj, uj) = _run(ts), _run(js)
    assert rt.flag == rj.flag == 0 and rt.relres <= 1e-8
    assert abs(rt.iters - rj.iters) <= max(3, 0.05 * rj.iters)
    np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-5 * np.abs(uj).max())
    cycles = [e for e in ts.dispatch_log if e[0] == "refine"]
    inner = [e for e in ts.dispatch_log if e[0] == "inner"]
    assert len(cycles) >= 2 and sum(e[2] for e in cycles) == rt.iters
    assert all(0 <= e[1] <= 12 for e in inner)
    big = Solver(models[1], RunConfig(solver=SolverConfig(
        tol=1e-8, max_iter=2000, iters_per_dispatch=2000, **kw)),
        device="cpu")
    rb, ub = _run(big)
    assert (rb.flag, rb.iters, rb.relres) == (rt.flag, rt.iters, rt.relres)
    np.testing.assert_array_equal(ub, ut)
    assert [e for e in big.dispatch_log if e[0] == "refine"] == cycles


@pytest.mark.parametrize("mode", ["direct", "mixed"])
def test_budget_is_never_exceeded(models, mode):
    kw = dict(max_iter=37)
    if mode == "mixed":
        kw.update(precision_mode="mixed", tol=1e-12)
    js, ts = _solvers(models, 16, **kw)
    (rt, _), (rj, _) = _run(ts), _run(js)
    assert rt.iters <= 37 and rj.iters <= 37
    assert sum(e[1] for e in ts.dispatch_log if e[0] != "refine") <= 37
    assert rt.flag == rj.flag == 1
    if mode == "direct":
        assert rt.iters == rj.iters == 37


def _operators():
    kw = dict(E=30e9, heterogeneous=True, seed=5, load="traction",
              load_value=1e6)
    spj = jax_partition(jax_cube(8, 4, 4, **kw), 1)
    sp = partition_from_numpy({f.name: getattr(spj, f.name)
                               for f in dataclasses.fields(spj)})
    jops = JaxStructuredOps.from_partition(spj, dot_dtype=jnp.float64)
    jdat = jax_data(spj, jnp.float64)
    tops = StructuredOps.from_partition(sp, dot_dtype=torch.float64)
    tdat = device_data_structured(sp, torch.float64, "cpu")
    fext = np.array(jdat["eff"] * (jdat["F"] - jops.matvec(jdat,
                                                           jdat["Ud"])))
    return sp, (jops, jdat), (tops, tdat), fext


@pytest.mark.parametrize("variant", ["classic", "fused", "pipelined"])
def test_carry_after_k_dispatches_matches_jax(variant):
    """Three capped calls of 4 iterations from the cold carry at x0 = 0
    in both packages: the carries agree leaf by leaf, and so does the
    min-residual selection on them.  (The f64 dots sum in another order
    than XLA's; CG amplifies that round-off in the shrinking residual by
    about 10x an iteration under pipelined, so the window is 12
    iterations.)"""
    sp, (jops, jdat), (tops, tdat), fext = _operators()
    w = np.asarray(jdat["weight"] * jdat["eff"])
    n0 = float(np.sqrt(np.sum(w * fext * fext)))
    zero = np.zeros_like(fext)
    cj = jax_cold_carry(jnp.asarray(zero), jnp.asarray(fext), n0,
                        jnp.float64, variant=variant)
    ct = cold_carry(torch.from_numpy(zero), torch.from_numpy(fext), n0,
                    torch.float64, variant=variant)
    assert set(ct) == set(cj)
    kw = dict(tol=1e-10, max_iter=4, glob_n_dof_eff=sp.glob_n_dof_eff,
              max_iter_nominal=1000, return_carry=True, variant=variant)
    pj = jax_make_prec(jops, jdat, "jacobi")
    pt = make_prec(tops, tdat, "jacobi")
    for _ in range(3):
        rj, cj = jax_pcg(jops, jdat, jnp.asarray(fext), cj["x"], pj,
                         carry_in=cj, **kw)
        rt, ct = pcg(tops, tdat, torch.from_numpy(fext), ct["x"], pt,
                     carry_in=ct, **kw)
        assert rt.flag == int(rj.flag) == 1
    assert set(ct) == set(cj)
    for k in sorted(cj):
        a = np.asarray(ct[k].numpy() if torch.is_tensor(ct[k]) else ct[k])
        b = np.asarray(cj[k])
        if b.dtype.kind == "i":
            assert int(a) == int(b), k
        else:
            scale = max(float(np.abs(b).max()), 1e-300)
            assert float(np.abs(a - b).max()) <= 1e-12 * scale, k
    lagged = variant != "classic"
    xj, relj = jax_select_best(jops, jdat, jnp.asarray(fext), cj,
                               always_min=lagged)
    xt, relt = select_best(tops, tdat, torch.from_numpy(fext), ct,
                           always_min=lagged)
    np.testing.assert_allclose(float(relt), float(relj), rtol=1e-12)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(xj)).max())


@pytest.mark.parametrize("ipd,n_dof,n_loc", [
    (-1, 3_999_999, 10 ** 6), (-1, 4_000_000, 10 ** 6),
    (-1, 10_328_853, 10_328_853), (-1, 6_440_067, 6_440_067),
    (-1, 5_670_981, 6_000_000), (-1, 4_000_000, 10 ** 9), (0, 10 ** 8, 1),
    (7, 10, 10), (500, 10 ** 7, 10 ** 7)])
def test_auto_dispatch_cap_matches_jax(ipd, n_dof, n_loc):
    sc = SolverConfig(iters_per_dispatch=ipd)
    jsc = JaxSolverConfig(iters_per_dispatch=ipd)
    assert auto_dispatch_cap(sc, n_dof, n_loc) == \
        jax_auto_dispatch_cap(jsc, n_dof, n_loc)


def test_mg_fallback_operand_demotes_to_scalar_jacobi():
    """The ladder's mg demotion: the operand keeps the mg shape with
    ``fb`` set, as the JAX package's, and the apply is the scalar Jacobi
    product instead of the V-cycle."""
    s = Solver(make_cube_model(8, 4, 4, h=0.5, nu=0.3, heterogeneous=True,
                               seed=0),
               RunConfig(solver=SolverConfig(precond="mg")), device="cpu")
    m = make_prec(s.ops, s.data, "mg")
    fb = fallback_operand(m["mg_diag"])
    jfb = jax_fallback_operand(np.asarray(m["mg_diag"]))
    assert set(fb) == set(jfb) and fb["fb"] == int(jfb["fb"]) == 1
    assert m["fb"] == 0
    r = torch.from_numpy(np.random.default_rng(1).standard_normal(
        m["mg_diag"].shape)) * s.data["eff"]
    assert torch.equal(mg_apply(s.ops, s.data, fb, r), m["mg_diag"] * r)
    assert not torch.equal(mg_apply(s.ops, s.data, m, r), m["mg_diag"] * r)
    assert s._fallback_prec()["fb"] == 1

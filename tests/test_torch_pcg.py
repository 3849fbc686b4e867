"""The port's classic PCG and mixed-precision refinement shell against the
JAX package's, on the same operator and the same inputs (CPU).

Direct f64: same flag, same iteration count, relres <= tol, solutions
within 1e-8 relative (two f64 solves of one system to tol <= 1e-8).  The
f64 dots are summed in another order than XLA's; on these cases that
moves no iteration count, so the counts must be equal.

Mixed: the inner dots are float32 sums whose order differs from XLA's,
which alone moves iteration counts by a few; the totals must agree within
max(3, 5 %) and the solutions within 1e-5 relative (both reach tol).
Accumulating the f32 dots in f64 would change the algorithm, so the
tests allow the spread instead."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcg_mpi_solver_tpu.models.synthetic import make_cube_model as jax_cube
from pcg_mpi_solver_tpu.ops.precond import make_prec as jax_make_prec
from pcg_mpi_solver_tpu.parallel.structured import (
    StructuredOps as JaxStructuredOps, device_data_structured as jax_data,
    partition_structured as jax_partition)
from pcg_mpi_solver_tpu.solver.pcg import pcg as jax_pcg
from pcg_mpi_solver_tpu.solver.pcg import pcg_mixed as jax_pcg_mixed
from pcg_mpi_solver_tpu.solver.pcg import refine_tol as jax_refine_tol
from pcg_mpi_solver_tpu_torch.ops.precond import make_prec
from pcg_mpi_solver_tpu_torch.parallel.structured import (
    StructuredOps, device_data_structured, partition_from_numpy)
from pcg_mpi_solver_tpu_torch.solver.pcg import pcg, pcg_mixed, refine_tol


def setup(dims=(8, 4, 4), n_parts=1, load="traction", heterogeneous=True):
    kw = dict(E=30e9, heterogeneous=heterogeneous, seed=5, load=load,
              load_value=1e6 if load == "traction" else 1e-3)
    spj = jax_partition(jax_cube(*dims, **kw), n_parts)
    sp = partition_from_numpy({f.name: getattr(spj, f.name)
                               for f in dataclasses.fields(spj)})
    jops = {d: JaxStructuredOps.from_partition(spj, dot_dtype=jd)
            for d, jd in (("64", jnp.float64), ("32", jnp.float32))}
    jdat = {"64": jax_data(spj, jnp.float64), "32": jax_data(spj, jnp.float32)}
    tops = {d: StructuredOps.from_partition(sp, dot_dtype=td)
            for d, td in (("64", torch.float64), ("32", torch.float32))}
    tdat = {d: device_data_structured(sp, td, "cpu")
            for d, td in (("64", torch.float64), ("32", torch.float32))}
    # the rhs with Dirichlet lifting, built once (JAX) and fed to both
    j64 = jdat["64"]
    fext = np.array(j64["eff"] * (j64["F"] - jops["64"].matvec(j64,
                                                               j64["Ud"])))
    return sp, (jops, jdat), (tops, tdat), fext


def run_both(sp, jax_side, port_side, fext, x0, tol, max_iter):
    (jops, jdat), (tops, tdat) = jax_side, port_side
    rj = jax_pcg(jops["64"], jdat["64"], jnp.asarray(fext), jnp.asarray(x0),
                 jax_make_prec(jops["64"], jdat["64"], "jacobi"), tol=tol,
                 max_iter=max_iter, glob_n_dof_eff=sp.glob_n_dof_eff)
    rt = pcg(tops["64"], tdat["64"], torch.from_numpy(fext),
             torch.from_numpy(x0),
             make_prec(tops["64"], tdat["64"], "jacobi"), tol=tol,
             max_iter=max_iter, glob_n_dof_eff=sp.glob_n_dof_eff)
    return rj, rt


@pytest.mark.parametrize("load,n_parts,warm", [
    ("traction", 1, False), ("dirichlet", 1, False), ("traction", 2, False),
    ("dirichlet", 2, True)])
def test_pcg_f64_matches_jax(load, n_parts, warm):
    sp, js, ts, fext = setup(n_parts=n_parts, load=load)
    # warm: a nonzero initial guess takes the r0 = fext - A.x0 path
    x0 = (np.random.default_rng(1).normal(size=fext.shape)
          * np.abs(fext).max() * 1e-12 * (fext != 0) if warm
          else np.zeros_like(fext))
    tol = 1e-8
    rj, rt = run_both(sp, js, ts, fext, x0, tol, 2000)
    assert int(rj.flag) == rt.flag == 0
    assert rt.iters == int(rj.iters)
    assert rt.relres <= tol and isinstance(rt.relres, np.float32)
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=0,
                               atol=1e-8 * np.abs(xj).max())


def test_pcg_budget_exit_matches_jax():
    """max_iter reached: flag 1 and MATLAB's failure finalize (the better
    of the last and the min-residual iterate, by true residual)."""
    sp, js, ts, fext = setup()
    rj, rt = run_both(sp, js, ts, fext, np.zeros_like(fext), 1e-10, 17)
    assert int(rj.flag) == rt.flag == 1
    assert rt.iters == int(rj.iters)
    np.testing.assert_allclose(rt.relres, float(rj.relres), rtol=1e-6)
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=0,
                               atol=1e-10 * np.abs(xj).max())


def test_pcg_tolerance_floor_matches_jax():
    """tol below f64 round-off: MoreSteps on failed true-residual checks,
    then flag 3 with the min-residual iterate.  At the round-off floor
    the residual history is noise in both reduction orders, and a flag-3
    exit reports the index of the min-residual iterate, so the test holds
    the exit flag and the floor both reach, not the iteration count."""
    sp, js, ts, fext = setup(dims=(6, 3, 3))
    max_iter = 250     # < n_eff - 5, so MATLAB's MoreSteps budget is 5
    rj, rt = run_both(sp, js, ts, fext, np.zeros_like(fext), 1e-17,
                      max_iter)
    assert int(rj.flag) == rt.flag == 3
    assert rt.iters < max_iter and int(rj.iters) < max_iter
    assert rt.relres < 1e-13 and float(rj.relres) < 1e-13


def test_pcg_f32_storage_stagnation_matches_jax():
    """f32 storage, f64 dots, tol far below the f32 floor: the updates fall
    under eps*||x||, MaxStagSteps fires, the deferred checks fail, the
    stag reset and MoreSteps rules run, and the solve ends with flag 3 on
    the min-residual iterate.  The f32 matvec rounds in another order than
    XLA's einsum, which can move the exit by one iteration: +-1."""
    spj = jax_partition(jax_cube(8, 4, 4, E=30e9, heterogeneous=True,
                                 seed=5, load_value=1e6), 1)
    sp = partition_from_numpy({f.name: getattr(spj, f.name)
                               for f in dataclasses.fields(spj)})
    jops = JaxStructuredOps.from_partition(spj, dot_dtype=jnp.float64)
    jd = jax_data(spj, jnp.float32)
    tops = StructuredOps.from_partition(sp, dot_dtype=torch.float64)
    td = device_data_structured(sp, torch.float32, "cpu")
    f = np.array(jd["eff"] * jd["F"])
    kw = dict(tol=1e-10, max_iter=200, glob_n_dof_eff=sp.glob_n_dof_eff)
    rj = jax_pcg(jops, jd, jnp.asarray(f), jnp.zeros_like(f),
                 jax_make_prec(jops, jd, "jacobi"), **kw)
    rt = pcg(tops, td, torch.from_numpy(f),
             torch.zeros(f.shape, dtype=torch.float32),
             make_prec(tops, td, "jacobi"), **kw)
    assert int(rj.flag) == rt.flag == 3
    assert abs(rt.iters - int(rj.iters)) <= 1
    assert rt.relres < 1e-4 and float(rj.relres) < 1e-4
    assert rt.x.dtype == torch.float32


def test_pcg_zero_rhs():
    sp, js, ts, fext = setup()
    zero = np.zeros_like(fext)
    rj, rt = run_both(sp, js, ts, zero, zero, 1e-8, 100)
    assert (rt.flag, rt.iters, float(rt.relres)) == (0, 0, 0.0)
    assert (int(rj.flag), int(rj.iters)) == (0, 0)
    assert not rt.x.any()


def test_pcg_return_carry_reports_executed_trips():
    sp, _js, (tops, tdat), fext = setup()
    res, carry = pcg(tops["64"], tdat["64"], torch.from_numpy(fext),
                     torch.zeros(fext.shape, dtype=torch.float64),
                     make_prec(tops["64"], tdat["64"], "jacobi"), tol=1e-8,
                     max_iter=2000, glob_n_dof_eff=sp.glob_n_dof_eff,
                     return_carry=True, x0_zero=True)
    assert res.flag == 0 and carry["exec"] == res.iters
    assert carry["normr_act"] <= carry["normrmin"] or res.flag == 0


def test_refine_tol_matches_jax():
    for tolb, normr in ((1e-3, 10.0), (5.0, 10.0), (1e-9, 1e6), (1.0, 0.0)):
        got = refine_tol(np.float64(tolb), np.float64(normr), 1e-5)
        want = jax_refine_tol(jnp.float64(tolb), jnp.float64(normr), 1e-5)
        assert isinstance(got, np.float32)
        assert got == np.float32(want)


@pytest.mark.parametrize("load", ["traction", "dirichlet"])
def test_pcg_mixed_matches_jax(load):
    """Each refinement cycle's f32 solve differs from XLA's at round-off,
    and the next cycle's rhs is the f64 residual of that iterate — mostly
    round-off itself — so totals drift between the two reduction orders.
    On these models the drift stays within max(3, 5 %); small models with
    inner cycles grinding at the f32 floor drift further, which is why
    test_mixed_inner_cycle_matches_jax_on_identical_input pins the cycle
    itself.  max_iter < n_eff - 5 keeps MATLAB's MoreSteps budget at 5,
    as at the flagship."""
    sp, (jops, jdat), (tops, tdat), fext = setup(dims=(16, 6, 6), load=load)
    tol = 1e-8
    assert sp.glob_n_dof_eff - 1000 >= 5
    rj = jax_pcg_mixed(jops["32"], jdat["32"], jops["64"], jdat["64"],
                       jnp.asarray(fext), jnp.zeros(fext.shape),
                       jax_make_prec(jops["32"], jdat["32"], "jacobi"),
                       tol=tol, max_iter=1000,
                       glob_n_dof_eff=sp.glob_n_dof_eff)
    rt = pcg_mixed(tops["32"], tdat["32"], tops["64"], tdat["64"],
                   torch.from_numpy(fext),
                   torch.zeros(fext.shape, dtype=torch.float64),
                   make_prec(tops["32"], tdat["32"], "jacobi"),
                   tol=tol, max_iter=1000, glob_n_dof_eff=sp.glob_n_dof_eff)
    assert int(rj.flag) == rt.flag == 0
    assert abs(rt.iters - int(rj.iters)) <= max(3, 0.05 * int(rj.iters))
    assert rt.relres <= tol
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=0,
                               atol=1e-5 * np.abs(xj).max())


@pytest.mark.parametrize("tol", [1e-5, 5.5e-4])
def test_mixed_inner_cycle_matches_jax_on_identical_input(tol):
    """One f32 inner cycle as pcg_mixed runs it (normalized rhs, x0 = 0,
    return_carry) on the same input in both packages: same flag, same
    executed trips, and norms and iterates equal up to f32 round-off
    (atol 1e-5 on the unit-norm rhs's residual; 1e-4 * max|x|).  The
    homogeneous cube keeps both tolerances above the f32 floor."""
    sp, (jops, jdat), (tops, tdat), fext = setup(dims=(12, 8, 8),
                                                 heterogeneous=False)
    w = np.asarray(jdat["64"]["weight"] * jdat["64"]["eff"])
    rhat = (fext / np.sqrt(np.sum(fext * fext * w))).astype(np.float32)
    kw = dict(max_iter=1000, glob_n_dof_eff=sp.glob_n_dof_eff,
              max_iter_nominal=1000, return_carry=True, x0_zero=True)
    rj, cj = jax_pcg(jops["32"], jdat["32"], jnp.asarray(rhat),
                     jnp.zeros(rhat.shape, jnp.float32),
                     jax_make_prec(jops["32"], jdat["32"], "jacobi"),
                     tol=jnp.float32(tol), **kw)
    rt, ct = pcg(tops["32"], tdat["32"], torch.from_numpy(rhat),
                 torch.zeros(rhat.shape, dtype=torch.float32),
                 make_prec(tops["32"], tdat["32"], "jacobi"),
                 tol=np.float32(tol), **kw)
    assert rt.flag == int(rj.flag) == 0
    assert ct["exec"] == int(cj["exec"])
    np.testing.assert_allclose(float(ct["normr_act"]),
                               float(cj["normr_act"]), rtol=0, atol=1e-5)
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=0,
                               atol=1e-4 * np.abs(xj).max())


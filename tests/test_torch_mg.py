"""The port's geometric multigrid preconditioner (``ops/mg.py``) and the
block3 and mg solves against the JAX package's, on the same seeded inputs
(CPU).

- Setup: ``plan_levels``, the replication cutoff (both with their
  errors), ``build_mg_host`` trees (integers exact, floats to 1e-12) at
  one and two parts and at non-default field values, ``_level_matvec``
  to 1e-12, ``estimate_fine_lam`` to 1e-10.
- The V-cycle: one ``mg_apply`` on a hierarchy carried across from the
  JAX package, against JAX's on the same r, to 1e-10 x max|z| in float64
  and 1e-5 in float32 (its sums run in another order); dense at 4^3 it is
  symmetric, PSD and repeatable to the bit.
- ``Solver`` (one and two parts): the same flag; direct float64
  iterations within +-1 (the f64 dots and the restriction's sums run in
  another order than XLA's, which can move a count sitting at the tol
  boundary by one), mixed within max(3, 5 %) (the f32 inner sums' order
  moves the refinement sequence); solutions within 1e-8 (direct) and
  1e-5 (mixed) of max|u|.  max_iter stays below n_eff - 5 (MATLAB's
  MoreSteps budget, ROADMAP queue 3 item 5).
- The mixed solves run ``inner_tol=1e-4``.  At the default 1e-5 the first
  f32 cycle's target sits at this model's f32 floor: the JAX package's
  first mg cycle ends on a stagnation exit (flag 3, true residual 4.1e-5
  after 16 iterations) where the port's converges (13, 7.3e-6), and the
  totals part by 3-4 (23 against 26-27), while both f32 V-cycles are
  within 1.1e-7 of the f64 one (held by
  ``test_f32_vcycle_is_as_accurate_as_jax``).  Above the floor the f32
  cycles end on their tolerance, where the window means what it says.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcg_mpi_solver_tpu import RunConfig as JaxRunConfig
from pcg_mpi_solver_tpu import SolverConfig as JaxSolverConfig
from pcg_mpi_solver_tpu import TimeHistoryConfig as JaxTimeHistoryConfig
from pcg_mpi_solver_tpu.models.synthetic import make_cube_model as jax_cube
from pcg_mpi_solver_tpu.ops import mg as jmg
from pcg_mpi_solver_tpu.ops.precond import make_prec as jax_make_prec
from pcg_mpi_solver_tpu.parallel.mesh import PARTS_AXIS, make_mesh
from pcg_mpi_solver_tpu.parallel.structured import (
    StructuredOps as JaxStructuredOps, device_data_structured as jax_data,
    partition_structured as jax_partition)
from pcg_mpi_solver_tpu.solver import Solver as JaxSolver
from pcg_mpi_solver_tpu.solver.driver import _data_specs
from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig, TimeHistoryConfig
from pcg_mpi_solver_tpu_torch.models import make_cube_model
from pcg_mpi_solver_tpu_torch.ops import mg
from pcg_mpi_solver_tpu_torch.ops.precond import make_prec
from pcg_mpi_solver_tpu_torch.parallel.structured import (
    StructuredOps, device_data_structured, partition_from_numpy,
    partition_structured)
from pcg_mpi_solver_tpu_torch.solver import Solver

DTYPES = {"float64": (jnp.float64, torch.float64),
          "float32": (jnp.float32, torch.float32)}
CUBE = dict(E=30e9, nu=0.3, heterogeneous=True, seed=5)


def assert_trees_match(got, ref, rtol=1e-12):
    """Two host trees of one structure: integer leaves equal, float leaves
    within rtol."""
    if isinstance(ref, dict):
        assert set(got) == set(ref)
        for k in ref:
            assert_trees_match(got[k], ref[k], rtol)
    elif isinstance(ref, list):
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            assert_trees_match(a, b, rtol)
    else:
        got, ref = np.asarray(got), np.asarray(ref)
        assert got.shape == ref.shape
        if np.issubdtype(ref.dtype, np.integer):
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, rtol=rtol,
                                       atol=rtol * np.abs(ref).max())


# ----------------------------------------------------------------------
# Host setup
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dims,n_levels", [
    ((8, 8, 8), 0), ((8, 4, 4), 0), ((150, 150, 150), 0),
    ((128, 128, 128), 0), ((16, 8, 8), 2), ((12, 8, 8), 0),
    ((7, 8, 8), 0), ((8, 4, 4), 3)])
def test_plan_levels_matches_jax(dims, n_levels):
    try:
        ref = jmg.plan_levels(dims, n_levels)
    except jmg.MGSetupError as e:
        with pytest.raises(mg.MGSetupError) as info:
            mg.plan_levels(dims, n_levels)
        assert str(info.value) == str(e)
        return
    assert mg.plan_levels(dims, n_levels) == ref


@pytest.mark.parametrize("dims,n_levels,cap", [
    ((128,) * 3, 0, 32_000_000), ((128,) * 3, 0, 300_000),
    ((128,) * 3, 0, 0), ((150,) * 3, 0, 1_000_000),
    ((128,) * 3, 5, 300_000), ((16, 8, 8), 2, 1_000)])
def test_replication_cutoff_matches_jax(dims, n_levels, cap):
    planned = mg.plan_levels(dims, n_levels)
    assert mg.level_replicated_dofs(planned) \
        == jmg.level_replicated_dofs(planned)
    try:
        ref = jmg.apply_replication_cutoff(planned, n_levels, cap)
    except jmg.MGSetupError as e:
        with pytest.raises(mg.MGSetupError) as info:
            mg.apply_replication_cutoff(planned, n_levels, cap)
        assert str(info.value) == str(e)
        return
    assert mg.apply_replication_cutoff(planned, n_levels, cap) == ref
    if dims == (128,) * 3 and cap == 32_000_000:
        # the 128^3 hierarchy the chip run measures: 6 levels, 949,068
        # coarse dofs
        assert len(ref) == 6 and sum(mg.level_replicated_dofs(ref)) \
            == 949_068


@pytest.fixture(scope="module", params=[1, 2], ids=["P1", "P2"])
def both(request):
    """An 8x4x4 heterogeneous cube (two coarse levels) partitioned by the
    JAX package into P slabs and carried across, with each package's
    hierarchy built from its own model and partition."""
    P = request.param
    jmodel = jax_cube(8, 4, 4, **CUBE)
    tmodel = make_cube_model(8, 4, 4, **CUBE)
    spj = jax_partition(jmodel, P)
    sp = partition_from_numpy({f.name: getattr(spj, f.name)
                               for f in dataclasses.fields(spj)})
    return dict(P=P, jmodel=jmodel, tmodel=tmodel, spj=spj, sp=sp,
                jsetup=jmg.build_mg_host(jmodel, spj),
                tsetup=mg.build_mg_host(tmodel, sp))


def test_build_mg_host_matches_jax(both):
    js, ts = both["jsetup"], both["tsetup"]
    assert_trees_match(ts.tree, js.tree)
    assert ts.meta == js.meta == {"levels": 2, "degree": 2,
                                  "dims": [8, 4, 4]}
    np.testing.assert_allclose(ts.coarse_lams, js.coarse_lams, rtol=1e-12)
    np.testing.assert_allclose(ts.lam_min_coarse, js.lam_min_coarse,
                               rtol=1e-12)
    assert mg.coarse_dofs(ts.meta) == jmg.coarse_dofs(js.meta) \
        == 3 * 5 * 3 * 3
    # the port's own partition gives the same fine transfer
    own = mg.build_mg_host(both["tmodel"],
                           partition_structured(both["tmodel"], both["P"]))
    assert_trees_match(own.tree["fine"], js.tree["fine"])


@pytest.mark.parametrize("kw", [dict(n_levels=1, degree=3),
                                dict(max_replicated_dofs=150)])
def test_build_mg_host_nondefault_matches_jax(both, kw):
    js = jmg.build_mg_host(both["jmodel"], both["spj"], **kw)
    ts = mg.build_mg_host(both["tmodel"], both["sp"], **kw)
    assert_trees_match(ts.tree, js.tree)
    assert ts.meta == js.meta and ts.meta["levels"] == 1


def test_restriction_gather_is_the_transpose(both):
    """R (the gather) equals P^T (the JAX package's scatter-add of the
    same stencil) on random vectors, to round-off of the sum order."""
    fine = both["tsetup"].tree["fine"]
    n_c = both["tsetup"].tree["levels"][0]["idiag"].shape[0]
    ridx, rw = mg.restriction_gather(fine["gidx"], fine["gw"], n_c)
    s = np.random.default_rng(3).normal(size=(fine["gidx"].size // 8, 3))
    ref = np.zeros((n_c, 3))
    np.add.at(ref, fine["gidx"].reshape(-1),
              (fine["gw"].reshape(-1, 8)[..., None] * s[:, None, :])
              .reshape(-1, 3))
    got = (rw[..., None] * s[ridx]).sum(axis=1)
    np.testing.assert_allclose(got, ref, rtol=1e-14, atol=1e-14)


def test_level_matvec_matches_jax(both):
    tree = both["tsetup"].tree
    lev = tree["levels"][0]
    x = np.random.default_rng(4).normal(size=lev["idiag"].shape)
    ref = np.asarray(jmg._level_matvec(jnp.asarray(tree["Ke"]),
                                       jnp.asarray(lev["ck"]),
                                       jnp.asarray(lev["eff"]),
                                       jnp.asarray(x)))
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    got = mg._level_matvec(t(tree["Ke"]), t(lev["ck"]), t(lev["eff"]),
                           t(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())


def jax_fine_lam(spj, jdat):
    jops = JaxStructuredOps.from_partition(spj, dot_dtype=jnp.float64)
    return jmg.estimate_fine_lam(jops, jdat, make_mesh(1),
                                 _data_specs(jdat),
                                 jax.sharding.PartitionSpec(PARTS_AXIS))


def test_estimate_fine_lam_matches_jax(both):
    ref = jax_fine_lam(both["spj"], jax_data(both["spj"], jnp.float64))
    ops = StructuredOps.from_partition(both["sp"])
    data = device_data_structured(both["sp"], torch.float64, "cpu")
    got = mg.estimate_fine_lam(ops, data)
    assert got == pytest.approx(ref, rel=1e-10)


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-10),
                                       ("float32", 1e-5)])
def test_mg_apply_matches_jax_on_carried_tree(both, dtype, tol):
    """The JAX package's hierarchy, carried across with
    ``tree_from_numpy``; the same lam vector on both sides."""
    jd, td = DTYPES[dtype]
    spj, sp, setup = both["spj"], both["sp"], both["jsetup"]
    jdat = jax_data(spj, jd)
    lam = np.asarray([jax_fine_lam(spj, jax_data(spj, jnp.float64))]
                     + setup.coarse_lams)
    jdat["mg"] = jax.tree.map(jnp.asarray, jmg.cast_tree(setup.tree, jd))
    jdat["mg"]["lam"] = jnp.asarray(lam, jd)
    jops = JaxStructuredOps.from_partition(spj, dot_dtype=jd)
    tdat = device_data_structured(sp, td, "cpu")
    tdat["mg"] = mg.tree_from_numpy(setup.tree, td, "cpu")
    tdat["mg"]["lam"] = lam.astype(dtype)
    tops = StructuredOps.from_partition(sp, dot_dtype=td)
    assert tdat["mg"]["fine"]["gidx"].dtype == torch.int64
    r = np.random.default_rng(5).normal(size=(sp.n_parts, sp.n_loc)) \
        * sp.eff
    ref = np.asarray(jops.apply_prec(jax_make_prec(jops, jdat, "mg"),
                                     jnp.asarray(r, jd), data=jdat))
    got = tops.apply_prec(make_prec(tops, tdat, "mg"),
                          torch.as_tensor(r, dtype=td), tdat)
    assert got.dtype == td
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=tol * np.abs(ref).max())


def test_f32_vcycle_is_as_accurate_as_jax(both):
    """The float32 V-cycle of each package against the float64 one on the
    same r: the port's error is within 2x of the JAX package's, and both
    are float32 round-off (below 1e-6 of |z|)."""
    spj, sp, setup = both["spj"], both["sp"], both["jsetup"]
    lam = np.asarray([jax_fine_lam(spj, jax_data(spj, jnp.float64))]
                     + setup.coarse_lams)
    r = np.random.default_rng(6).normal(size=(sp.n_parts, sp.n_loc)) \
        * sp.eff
    z = {}
    for name, (jd, td) in DTYPES.items():
        jdat = jax_data(spj, jd)
        jdat["mg"] = jax.tree.map(jnp.asarray,
                                  jmg.cast_tree(setup.tree, jd))
        jdat["mg"]["lam"] = jnp.asarray(lam, jd)
        jops = JaxStructuredOps.from_partition(spj, dot_dtype=jd)
        z[("jax", name)] = np.asarray(jops.apply_prec(
            jax_make_prec(jops, jdat, "mg"), jnp.asarray(r, jd),
            data=jdat), np.float64)
        tdat = device_data_structured(sp, td, "cpu")
        tdat["mg"] = mg.tree_from_numpy(setup.tree, td, "cpu")
        tdat["mg"]["lam"] = lam.astype(name)
        tops = StructuredOps.from_partition(sp, dot_dtype=td)
        z[("port", name)] = tops.apply_prec(
            make_prec(tops, tdat, "mg"), torch.as_tensor(r, dtype=td),
            tdat).numpy().astype(np.float64)
    ref = z[("jax", "float64")]
    err = {k: np.linalg.norm(z[(k, "float32")] - ref) / np.linalg.norm(ref)
           for k in ("jax", "port")}
    assert err["port"] <= 2 * err["jax"] and max(err.values()) < 1e-6, err


def test_vcycle_dense_symmetric_psd_and_repeatable():
    """Dense M^-1 of the V-cycle at 4^3 (every local basis vector through
    one apply): symmetric, PSD, positive on free dofs, zero on fixed ones,
    and two applies to the same vectors equal to the bit."""
    s = Solver(make_cube_model(4, 4, 4, nu=0.3, heterogeneous=True,
                               seed=1),
               RunConfig(solver=SolverConfig(precond="mg")), device="cpu")
    m = make_prec(s.ops, s.data, "mg")
    eye = torch.eye(s.pm.n_loc, dtype=torch.float64) * s.data["eff"]

    def dense():
        return torch.stack([s.ops.apply_prec(m, e[None], s.data)[0]
                            for e in eye], dim=1).numpy()

    M, M2 = dense(), dense()
    np.testing.assert_array_equal(M, M2)
    scale = np.abs(M).max()
    assert np.abs(M - M.T).max() / scale < 1e-12
    eigs = np.linalg.eigvalsh(0.5 * (M + M.T))
    assert eigs.min() >= -1e-12 * eigs.max()
    eff = s.pm.eff[0] > 0
    assert (np.diag(M)[eff] > 0).all()
    assert np.abs(M[~eff]).max() == 0.0 and np.abs(M[:, ~eff]).max() == 0.0


# ----------------------------------------------------------------------
# Solver
# ----------------------------------------------------------------------

DELTAS = (0.0, 0.5, 1.0)
SOLVE = dict(tol=1e-8, max_iter=500)        # n_eff = 600 at 8x4x4


def solve_both(sc: dict, n_parts: int, dims=(8, 4, 4), deltas=DELTAS):
    js = JaxSolver(jax_cube(*dims, **CUBE, load_value=1e6),
                   JaxRunConfig(solver=JaxSolverConfig(**sc),
                                time_history=JaxTimeHistoryConfig(
                                    time_step_delta=deltas,
                                    export_flag=False)),
                   mesh=make_mesh(n_parts), n_parts=n_parts)
    assert js.backend == "structured"
    ts = Solver(make_cube_model(*dims, **CUBE, load_value=1e6),
                RunConfig(solver=SolverConfig(**sc),
                          time_history=TimeHistoryConfig(
                              time_step_delta=deltas)),
                n_parts=n_parts, device="cpu")
    assert ts.pm.glob_n_dof_eff - sc["max_iter"] >= 5
    return js, js.solve(), ts, ts.solve()


@pytest.mark.parametrize("mode", ["direct", "mixed"])
@pytest.mark.parametrize("precond,n_parts", [("block3", 2), ("mg", 2),
                                             ("mg", 1)])
def test_solver_matches_jax(precond, n_parts, mode):
    sc = dict(SOLVE, precond=precond, precision_mode=mode,
              **(dict(inner_tol=1e-4) if mode == "mixed" else {}))
    js, rj, ts, rt = solve_both(sc, n_parts)
    assert len(rt) == len(rj) == 2
    for a, b in zip(rt, rj):
        assert a.flag == b.flag == 0
        assert a.relres <= sc["tol"]
        if mode == "direct":
            assert abs(a.iters - b.iters) <= 1
        else:
            assert abs(a.iters - b.iters) <= max(3, 0.05 * b.iters)
    uj, ut = js.displacement_global(), ts.displacement_global()
    rel = 1e-8 if mode == "direct" else 1e-5
    np.testing.assert_allclose(ut, uj, rtol=0, atol=rel * np.abs(uj).max())
    if precond == "mg":
        jlam = np.asarray((js.data["f64"] if mode == "mixed"
                           else js.data)["mg"]["lam"])
        np.testing.assert_allclose(ts.mg_lam, jlam, rtol=1e-10)
        if mode == "mixed":
            assert ts.data32["mg"]["lam"].dtype == np.float32
            assert ts.data32["mg"]["fine"]["gidx"].dtype == torch.int64


@pytest.mark.parametrize("field,value", [
    ("mg_levels", 1), ("mg_smooth_degree", 3),
    ("mg_max_replicated_dofs", 150)])
def test_nondefault_mg_fields_match_jax(field, value):
    sc = dict(SOLVE, precond="mg", **{field: value})
    js, rj, ts, rt = solve_both(sc, 2, deltas=(0.0, 1.0))
    (a,), (b,) = rt, rj
    assert a.flag == b.flag == 0 and abs(a.iters - b.iters) <= 1
    assert ts.mg_setup.meta == js._mg_meta
    assert ts.ops.mg_degree == js.ops.mg_degree
    np.testing.assert_allclose(ts.mg_lam, np.asarray(js.data["mg"]["lam"]),
                               rtol=1e-10)


@pytest.mark.parametrize("dims,field,value", [
    ((5, 4, 4), "mg_levels", 0), ((8, 4, 4), "mg_levels", 3),
    ((8, 4, 4), "mg_max_replicated_dofs", 100)])
def test_mg_setup_errors_match_jax(dims, field, value, monkeypatch):
    """Both Solvers raise MGSetupError with the same reason (both
    packages' preflight, which raises the same reasons earlier as
    PreflightError, off: tests/test_torch_mg_general.py holds that)."""
    monkeypatch.setenv("PCG_TPU_PREFLIGHT", "off")
    sc = dict(SOLVE, precond="mg", **{field: value})
    with pytest.raises(jmg.MGSetupError) as jinfo:
        JaxSolver(jax_cube(*dims, **CUBE),
                  JaxRunConfig(preflight="off",
                               solver=JaxSolverConfig(**sc)),
                  mesh=make_mesh(1), n_parts=1)
    with pytest.raises(mg.MGSetupError) as tinfo:
        Solver(make_cube_model(*dims, **CUBE),
               RunConfig(solver=SolverConfig(**sc)), device="cpu")
    assert str(tinfo.value) == str(jinfo.value)


def test_mg_cuts_iterations_5x_vs_jacobi():
    """The JAX package's headline (``tests/test_mg.py``) on the port:
    precond='mg' converges in >= 5x fewer PCG iterations than 'jacobi' at
    the same tolerance, to the same solution, on the heterogeneous
    golden-class 8^3 cube (151 -> 14 in the JAX package).  max_iter 1000
    keeps MATLAB's MoreSteps budget positive (n_eff = 1944)."""
    model = make_cube_model(8, 8, 8, h=0.5, nu=0.3, heterogeneous=True,
                            seed=0)
    runs = {}
    for pc in ("jacobi", "mg"):
        s = Solver(model, RunConfig(solver=SolverConfig(
            tol=1e-8, max_iter=1000, precond=pc)), n_parts=2, device="cpu")
        runs[pc] = (s.step(1.0), s.displacement_global())
    (rj, uj), (rm, um) = runs["jacobi"], runs["mg"]
    assert rj.flag == 0 and rm.flag == 0
    assert 5 * rm.iters <= rj.iters, (rm.iters, rj.iters)
    np.testing.assert_allclose(um, uj, rtol=1e-6,
                               atol=1e-7 * np.abs(uj).max())

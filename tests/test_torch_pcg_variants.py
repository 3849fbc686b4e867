"""The port's fused and pipelined PCG variants against the JAX package's,
on the same seeded inputs (CPU).

- ``pcg`` direct float64 under jacobi, block3 and mg (the JAX hierarchy
  carried across, one lam vector on both sides), one and two parts: the
  same flag and the same iteration count (one apart only where the JAX
  package's own solve on the other partition shows the reduction order
  alone moves it), relres <= tol, solutions within 1e-8 of max|x| (two
  f64 solves of one system to tol 1e-8).
- ``pcg_mixed`` and ``Solver`` in mixed precision: the same flag and
  iteration totals within max(3, 5 %), the window of ROADMAP.md's ground
  rules (the f32 inner dots are summed in another order than XLA's).
  Pipelined mixed under jacobi is a chain of f32 breakdowns in both
  packages: held as one inner cycle on the same input and as the stall
  both reach at 16x6x6; through ``Solver`` it runs under mg.
  ``Solver`` direct: the same flags and iterations within +-1 (a step
  starts from the previous step's solution, on which the packages agree
  only to tol).  The JAX Solver runs with ``iters_per_dispatch=0``, its
  one-shot step: a chunked JAX solve would route a flag 6 into the
  recovery ladder, which the port does not have yet.
- The pipelined replacement cadence: a direct solve of 68 iterations
  (two forced replacements) takes the same iterations and the same
  number of matvecs in both packages, counted by an ``Ops`` subclass on
  each side (``jax.debug.callback`` counts the JAX loop's executions).
- The lagged finalize (a budget exit returns the min-residual iterate,
  its index and its recomputed relres), the drift guard (an ``Ops``
  subclass whose five-dot reduction makes the recurrence norm lie by the
  same factor on both sides: flag 6 after 3 drifted checks under fused,
  2 under pipelined), MoreSteps at the f64 floor, the zero-rhs and
  initial-ok exits, and ``ValueError`` for an unknown variant.
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
from pcg_mpi_solver_tpu import TimeHistoryConfig as JaxTimeHistoryConfig
from pcg_mpi_solver_tpu.models.synthetic import make_cube_model as jax_cube
from pcg_mpi_solver_tpu.ops import mg as jmg
from pcg_mpi_solver_tpu.ops.precond import make_prec as jax_make_prec
from pcg_mpi_solver_tpu.parallel.mesh import make_mesh
from pcg_mpi_solver_tpu.parallel.structured import (
    StructuredOps as JaxStructuredOps, device_data_structured as jax_data,
    partition_structured as jax_partition)
from pcg_mpi_solver_tpu.solver import Solver as JaxSolver
from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig, TimeHistoryConfig
from pcg_mpi_solver_tpu_torch.models import make_cube_model
from pcg_mpi_solver_tpu_torch.ops import mg
from pcg_mpi_solver_tpu_torch.ops.precond import make_prec
from pcg_mpi_solver_tpu_torch.parallel.structured import (
    StructuredOps, device_data_structured, partition_from_numpy)
from pcg_mpi_solver_tpu_torch.solver import Solver

# the JAX package's solver/__init__ exports the function under the module's
# name
jax_pcg_mod = importlib.import_module("pcg_mpi_solver_tpu.solver.pcg")

LAGGED = ("fused", "pipelined")
DIMS = (8, 4, 4)            # n_eff 600: max_iter 500 keeps MoreSteps at 5
TOL, MAX_ITER = 1e-8, 500
CUBE = dict(E=30e9, nu=0.3, heterogeneous=True, seed=5, load="traction",
            load_value=1e6)
DTYPES = {"64": (jnp.float64, torch.float64), "32": (jnp.float32,
                                                     torch.float32)}


def build(dims=DIMS, n_parts=1, ops_cls=(JaxStructuredOps, StructuredOps),
          mg_tree=False, **model_kw):
    """Both packages' ops and data (float64 and float32) on the JAX
    package's partition carried across, the lifted rhs (built once and fed
    to both) and, with ``mg_tree``, the JAX hierarchy in both f64 trees."""
    jmodel = jax_cube(*dims, **dict(CUBE, **model_kw))
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
    if mg_tree:
        setup = jmg.build_mg_host(jmodel, spj)
        lam = np.asarray([mg.estimate_fine_lam(tops["64"], tdat["64"])]
                         + setup.coarse_lams)
        jdat["64"]["mg"] = jax.tree.map(jnp.asarray, jmg.cast_tree(
            setup.tree, jnp.float64))
        jdat["64"]["mg"]["lam"] = jnp.asarray(lam)
        tdat["64"]["mg"] = mg.tree_from_numpy(setup.tree, torch.float64,
                                              "cpu")
        tdat["64"]["mg"]["lam"] = lam
    j64 = jdat["64"]
    fext = np.array(j64["eff"] * (j64["F"] - jops["64"].matvec(j64,
                                                               j64["Ud"])))
    return dict(sp=sp, jops=jops, jdat=jdat, tops=tops, tdat=tdat,
                fext=fext)


@pytest.fixture(scope="module")
def cases():
    """The one- and two-part builds, shared by every test of the module."""
    return {P: build(n_parts=P, mg_tree=True) for P in (1, 2)}


@pytest.fixture(params=[1, 2], ids=["P1", "P2"])
def case(request, cases):
    return cases[request.param]


def run_both(b, variant, precond="jacobi", d="64", fext=None, x0=None,
             **kw):
    """One ``pcg`` call in each package on the same inputs."""
    fext = b["fext"] if fext is None else fext
    x0 = np.zeros_like(fext) if x0 is None else x0
    jd, td = DTYPES[d]
    kw = dict(dict(tol=TOL, max_iter=MAX_ITER,
                   glob_n_dof_eff=b["sp"].glob_n_dof_eff), **kw)
    jo, jdat = b["jops"][d], b["jdat"][d]
    to, tdat = b["tops"][d], b["tdat"][d]
    rj = jax_pcg_mod.pcg(jo, jdat, jnp.asarray(fext, jd),
                         jnp.asarray(x0, jd),
                         jax_make_prec(jo, jdat, precond),
                         variant=variant, **kw)
    rt = pcg_mod.pcg(to, tdat, torch.as_tensor(fext, dtype=td),
                     torch.as_tensor(x0, dtype=td),
                     make_prec(to, tdat, precond), variant=variant, **kw)
    return rj, rt


def test_constants_match_jax():
    for name in ("BREAKDOWN_FLAGS", "DRIFT_FLAG", "FUSED_DRIFT_FACTOR",
                 "FUSED_DRIFT_LIMIT", "PIPELINED_DRIFT_LIMIT",
                 "PIPELINED_REPLACE_EVERY", "VALID_PCG_VARIANTS",
                 "LAGGED_VARIANTS"):
        assert getattr(pcg_mod, name) == getattr(jax_pcg_mod, name), name
    for v in pcg_mod.VALID_PCG_VARIANTS:
        assert pcg_mod.drift_limit_for(v) == jax_pcg_mod.drift_limit_for(v)
    assert (pcg_mod.drift_limit_for("fused"),
            pcg_mod.drift_limit_for("pipelined")) == (3, 2)


@pytest.mark.parametrize("precond", ["jacobi", "block3", "mg"])
@pytest.mark.parametrize("variant", LAGGED)
@pytest.mark.parametrize("n_parts", [1, 2])
def test_pcg_direct_matches_jax(cases, n_parts, variant, precond):
    """The same iteration count, or one apart only where the reduction
    order alone moves it: then the JAX package's own solve of the same
    system on the other partition (another order of the same sums) takes
    the port's count (two parts under fused block3: JAX 71, the port and
    JAX's one-part solve 72)."""
    rj, rt = run_both(cases[n_parts], variant, precond)
    assert int(rj.flag) == rt.flag == 0
    if rt.iters != int(rj.iters):
        other, _ = run_both(cases[3 - n_parts], variant, precond)
        assert abs(rt.iters - int(rj.iters)) == 1
        assert int(other.iters) == rt.iters
    assert rt.relres <= TOL and isinstance(rt.relres, np.float32)
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=0,
                               atol=1e-8 * np.abs(xj).max())


class CountingJaxOps(JaxStructuredOps):
    """Counts the executions of the JAX loop's matvecs."""
    calls = [0]

    def matvec(self, data, x):
        jax.debug.callback(CountingJaxOps._tick)
        return super().matvec(data, x)

    @staticmethod
    def _tick():
        CountingJaxOps.calls[0] += 1


class CountingOps(StructuredOps):
    calls = [0]

    def matvec(self, data, x):
        CountingOps.calls[0] += 1
        return super().matvec(data, x)


def test_pipelined_replacement_cadence_matches_jax():
    """68 iterations: two forced replacements at 25 and 50, each a dropped
    trip, a check and a re-prime.  The same iterations and the same
    matvec count (the priming trips, every trip's stencil, the checks)."""
    b = build(ops_cls=(CountingJaxOps, CountingOps))
    CountingJaxOps.calls[0] = CountingOps.calls[0] = 0
    rj, rt = run_both(b, "pipelined")
    jax.effects_barrier()
    assert int(rj.flag) == rt.flag == 0
    assert rt.iters == int(rj.iters) >= 2 * pcg_mod.PIPELINED_REPLACE_EVERY \
        + 10
    n = CountingOps.calls[0]
    assert n == CountingJaxOps.calls[0]
    # at least the iterations, two priming trips and two checks a
    # replacement, and the first priming trip
    assert n >= rt.iters + 2 * 2 + 1


@pytest.mark.parametrize("variant", LAGGED)
def test_lagged_budget_exit_matches_jax(case, variant):
    """max_iter reached: flag 1, and the min-residual iterate returned
    unconditionally with its index and recomputed relres."""
    rj, rt = run_both(case, variant, tol=1e-12, max_iter=17)
    assert int(rj.flag) == rt.flag == 1
    assert rt.iters == int(rj.iters) <= 17
    np.testing.assert_allclose(rt.relres, float(rj.relres), rtol=1e-6)
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=0,
                               atol=1e-10 * np.abs(xj).max())
    # the relres is the returned iterate's true residual
    b = case
    eff, w = b["tdat"]["64"]["eff"], b["tdat"]["64"]["weight"]
    f = torch.as_tensor(b["fext"])
    r = f - eff * b["tops"]["64"].matvec(b["tdat"]["64"], rt.x)
    rel = np.sqrt(float((w * eff * r * r).sum()) / float(
        (w * eff * f * f).sum()))
    assert rt.relres == pytest.approx(rel, rel=1e-6)


LIE = 1e-20     # the recurrence's squared residual norm, scaled


class LyingJaxOps(JaxStructuredOps):
    """The five-dot reduction of the lagged bodies reports ||r||^2 x LIE."""

    def wdots(self, w, pairs, extra=()):
        out = super().wdots(w, pairs, extra)
        return out.at[2].multiply(LIE) if len(pairs) == 5 else out


class LyingOps(StructuredOps):
    def wdots(self, w, pairs, extra=()):
        out = super().wdots(w, pairs, extra)
        if len(pairs) == 5:
            out = out * torch.tensor([1, 1, LIE, 1, 1, 1], dtype=out.dtype)
        return out


@pytest.mark.parametrize("variant", LAGGED)
def test_drift_guard_exits_flag6_like_jax(variant):
    """Every candidate check finds a true residual far above the lying
    recurrence norm: a drift each, the fresh gate commits an update
    between checks, and the solve exits with flag 6 at the variant's
    limit (3 fused, 2 pipelined), before MoreSteps' budget of 5."""
    b = build(ops_cls=(LyingJaxOps, LyingOps))
    (rj, cj), (rt, ct) = run_both(b, variant, return_carry=True)
    limit = pcg_mod.drift_limit_for(variant)
    assert int(rj.flag) == rt.flag == pcg_mod.DRIFT_FLAG
    assert int(cj["drift"]) == ct["drift"] == limit
    assert int(cj["moresteps"]) == ct["moresteps"] == limit
    assert int(cj["exec"]) == ct["exec"] and rt.iters == int(rj.iters)
    assert ct["fresh"] == int(cj["fresh"]) == 0
    # without the carry: the finalize's min-residual iterate
    rj, rt = run_both(b, variant)
    assert int(rj.flag) == rt.flag == pcg_mod.DRIFT_FLAG
    assert rt.iters == int(rj.iters)
    np.testing.assert_allclose(rt.relres, float(rj.relres), rtol=1e-6)


@pytest.mark.parametrize("variant", LAGGED)
def test_moresteps_at_the_f64_floor(variant):
    """tol 3e-15 at 6^3, below what f64 round-off lets either package
    reach: failed true-residual checks count MoreSteps and the fresh gate
    commits an update between them.  At the floor the residual history is
    round-off in both reduction orders, so the test holds what both
    reach (an exit that is not a budget exit, with MoreSteps counted and
    relres at the floor), not the iteration count."""
    b = build(dims=(6, 6, 6))
    kw = dict(tol=3e-15, max_iter=500, return_carry=True)
    assert b["sp"].glob_n_dof_eff - kw["max_iter"] >= 5
    (rj, cj), (rt, ct) = run_both(b, variant, **kw)
    assert rt.flag == int(rj.flag) != 1
    assert ct["moresteps"] >= 1 and int(cj["moresteps"]) >= 1
    assert rt.iters < kw["max_iter"] and int(rj.iters) < kw["max_iter"]
    rj, rt = run_both(b, variant, **dict(kw, return_carry=False))
    assert rt.relres < 1e-13 and float(rj.relres) < 1e-13


@pytest.mark.parametrize("variant", LAGGED)
def test_zero_rhs_exit(case, variant):
    zero = np.zeros_like(case["fext"])
    rj, rt = run_both(case, variant, fext=zero)
    assert (rt.flag, rt.iters, float(rt.relres)) == (0, 0, 0.0)
    assert (int(rj.flag), int(rj.iters)) == (0, 0)
    assert not rt.x.any()


@pytest.mark.parametrize("variant", LAGGED)
def test_initial_ok_exit(case, variant):
    """x0 already meets tol: no trip runs, x0 comes back."""
    _, x0 = run_both(case, "classic", tol=1e-10)
    x0 = x0.x.numpy()
    rj, rt = run_both(case, variant, x0=x0)
    assert (rt.flag, rt.iters) == (int(rj.flag), int(rj.iters)) == (0, 0)
    # r0 = fext - A.x0 cancels to 1e-10 of ||fext||: the two matvecs'
    # round-off (~1e-16 of ||fext||) moves the relres by ~1e-15
    assert rt.relres <= TOL
    np.testing.assert_allclose(rt.relres, float(rj.relres), rtol=0,
                               atol=1e-13)
    np.testing.assert_array_equal(rt.x.numpy(), x0)


def test_unknown_variant_raises():
    with pytest.raises(ValueError, match="pcg_variant"):
        JaxSolverConfig(pcg_variant="bogus")
    with pytest.raises(ValueError, match="pcg_variant"):
        SolverConfig(pcg_variant="bogus")


def test_pcg_unknown_variant_raises(cases):
    b = cases[1]
    args = (TOL, 10, b["sp"].glob_n_dof_eff)
    with pytest.raises(ValueError, match="variant must be one of"):
        jax_pcg_mod.pcg(b["jops"]["64"], b["jdat"]["64"],
                        jnp.asarray(b["fext"]), jnp.zeros(b["fext"].shape),
                        jax_make_prec(b["jops"]["64"], b["jdat"]["64"],
                                      "jacobi"), *args, variant="bogus")
    with pytest.raises(ValueError, match="variant must be one of"):
        pcg_mod.pcg(b["tops"]["64"], b["tdat"]["64"],
                    torch.as_tensor(b["fext"]),
                    torch.zeros(b["fext"].shape, dtype=torch.float64),
                    make_prec(b["tops"]["64"], b["tdat"]["64"], "jacobi"),
                    *args, variant="bogus")


@pytest.fixture(scope="module")
def mixed_case():
    """16x6x6 (n_eff 2352), as the classic mixed test."""
    return build(dims=(16, 6, 6), nu=0.2)


@pytest.mark.parametrize("variant,precond,flag", [
    ("fused", "jacobi", 0), ("fused", "block3", 0),
    ("pipelined", "jacobi", 3)])
def test_pcg_mixed_matches_jax(mixed_case, variant, precond, flag):
    """tol 1e-8, max_iter 1000 < n_eff - 5.  Pipelined stalls in both
    packages on this model: its first f32 cycle ends on a flag-4
    breakdown of the GV recurrence (test_pipelined_inner_cycle_matches_jax)
    and the second fails to halve the f64 residual (flag 3); the same
    flag and totals within the window all the same."""
    b = mixed_case
    fext = b["fext"]
    args = dict(tol=TOL, max_iter=1000, glob_n_dof_eff=b["sp"].glob_n_dof_eff,
                variant=variant)
    assert b["sp"].glob_n_dof_eff - args["max_iter"] >= 5
    rj = jax_pcg_mod.pcg_mixed(
        b["jops"]["32"], b["jdat"]["32"], b["jops"]["64"], b["jdat"]["64"],
        jnp.asarray(fext), jnp.zeros(fext.shape),
        jax_make_prec(b["jops"]["32"], b["jdat"]["32"], precond), **args)
    rt = pcg_mod.pcg_mixed(
        b["tops"]["32"], b["tdat"]["32"], b["tops"]["64"], b["tdat"]["64"],
        torch.from_numpy(fext), torch.zeros(fext.shape, dtype=torch.float64),
        make_prec(b["tops"]["32"], b["tdat"]["32"], precond), **args)
    assert int(rj.flag) == rt.flag == flag
    assert abs(rt.iters - int(rj.iters)) <= max(3, 0.05 * int(rj.iters))
    if flag == 0:
        assert rt.relres <= TOL
        xj = np.asarray(rj.x)
        np.testing.assert_allclose(rt.x.numpy(), xj, rtol=0,
                                   atol=1e-5 * np.abs(xj).max())


@pytest.mark.parametrize("variant,flag", [("fused", 4), ("pipelined", 4)])
def test_inner_cycle_matches_jax(mixed_case, variant, flag):
    """One f32 inner cycle as pcg_mixed runs it (normalized rhs, x0 = 0,
    return_carry, tol 1e-5) on the same input in both packages: both
    recurrences break down in f32 before tol on this model (flag 4:
    <p, Ap> by recurrence goes non-positive), fused near 1e-5 and
    pipelined near 1e-4; the same flag, executed trips within the mixed
    window."""
    b = mixed_case
    w = np.asarray(b["jdat"]["64"]["weight"] * b["jdat"]["64"]["eff"])
    rhat = (b["fext"] / np.sqrt(np.sum(b["fext"] ** 2 * w))
            ).astype(np.float32)
    (rj, cj), (rt, ct) = run_both(
        b, variant, d="32", fext=rhat, tol=np.float32(1e-5), max_iter=1000,
        max_iter_nominal=1000, return_carry=True, x0_zero=True)
    assert rt.flag == int(rj.flag) == flag
    assert abs(ct["exec"] - int(cj["exec"])) <= max(3, 0.05 * int(cj["exec"]))


DELTAS = (0.0, 0.5, 1.0)


def solve_both(sc: dict, n_parts: int, dims=DIMS):
    js = JaxSolver(jax_cube(*dims, **CUBE),
                   JaxRunConfig(solver=JaxSolverConfig(
                       iters_per_dispatch=0, **sc),
                       time_history=JaxTimeHistoryConfig(
                           time_step_delta=DELTAS, export_flag=False)),
                   mesh=make_mesh(n_parts), n_parts=n_parts)
    assert js.backend == "structured"
    ts = Solver(make_cube_model(*dims, **CUBE),
                RunConfig(solver=SolverConfig(**sc),
                          time_history=TimeHistoryConfig(
                              time_step_delta=DELTAS)),
                n_parts=n_parts, device="cpu")
    assert ts.pm.glob_n_dof_eff - sc["max_iter"] >= 5
    return js, js.solve(), ts, ts.solve()


@pytest.mark.parametrize("variant,mode,precond,n_parts", [
    ("fused", "direct", "jacobi", 1), ("fused", "mixed", "jacobi", 2),
    ("fused", "mixed", "block3", 1), ("fused", "mixed", "mg", 1),
    ("pipelined", "direct", "block3", 2), ("pipelined", "mixed", "mg", 1),
    ("pipelined", "mixed", "mg", 2)])
def test_solver_matches_jax(variant, mode, precond, n_parts):
    """Two quasi-static steps through each package's Solver.  Mixed runs
    at tol 1e-7 and inner_tol 1e-4, above this model's f32 floor
    (tests/test_torch_mg.py says why).  Pipelined mixed runs under mg
    only: under jacobi and block3 every f32 GV cycle on this model ends
    on a flag-4 breakdown at an iteration set by round-off, so totals
    part by ~30 % between the JAX package's own one- and two-part solves
    (jacobi, two steps: 408 and 337 against 315 and 404); the cycle itself
    is held by test_inner_cycle_matches_jax, the stall by
    test_pcg_mixed_matches_jax."""
    sc = dict(tol=TOL if mode == "direct" else 1e-7, max_iter=MAX_ITER,
              precond=precond, precision_mode=mode, pcg_variant=variant,
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


def test_pipelined_mg_solves_repeat_bitwise():
    """Two pipelined mixed mg solves of one model give the same bits."""
    model = make_cube_model(*DIMS, **CUBE)
    cfg = RunConfig(solver=SolverConfig(
        tol=TOL, max_iter=MAX_ITER, precond="mg", precision_mode="mixed",
        pcg_variant="pipelined", inner_tol=1e-4))
    runs = []
    for _ in range(2):
        s = Solver(model, cfg, device="cpu")
        r = s.step(1.0)
        runs.append((r.flag, r.iters, r.relres, s.displacement_global()))
    assert runs[0][:3] == runs[1][:3] and runs[0][0] == 0
    np.testing.assert_array_equal(runs[0][3], runs[1][3])

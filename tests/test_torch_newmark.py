"""The port's implicit Newmark-beta (``NewmarkSolver``, ``MassShiftedOps``)
against the JAX package's, on the CPU (``device="cpu"``), on
``tests/test_newmark.py``'s models: ``DELTAS`` = [0.5, 1.0, 1.0, 0.7,
0.3], dt 0.2, damping 0.1, 4 parts unless said.

- Direct jacobi and block3 (tol 1e-12): flag 0 each step, iterations per
  step within +-1 of JAX's (the matvec sums in another order), u, v and
  w within 1e-9 of their max.  JAX's pinned golden (19, 19, 19, 18, 18;
  checksum 158.3225146267945) holds on the port.
- Mixed jacobi (tol 1e-10): total iterations within max(3, 5 %) of
  JAX's (the ground rules' mixed window), u within 1e-7 * max|u|.
- ``iters_per_dispatch=7`` against one-shot: direct, identical
  iterations and u within 1e-12 (relative); mixed, u within 1e-7 * max|u|
  (JAX's ``test_newmark_chunked_matches_one_shot``).
- The hybrid octree (``PCG_TPU_ENABLE_HYBRID=1``, 2 parts, dt 0.1):
  iterations within +-1 and u within 1e-9 * max|u| of JAX's hybrid.
- mg on the general backend: iterations per step within +-1 of JAX's, u
  within 1e-9; mg on hybrid raises ``ValueError``.
- The fused and pipelined variants (direct): iterations within +-1 a
  step of JAX's, u, v and w within 1e-9.
- ``init_accel_delta``: w initialised from the state as JAX does (1e-9).
- ``MassShiftedOps`` refuses its three ``*_local`` entries; the gamma
  checks; 50 x the explicit dt stays bounded.
"""

import numpy as np
import pytest
import torch

from pcg_mpi_solver_tpu.config import RunConfig as JaxRunConfig
from pcg_mpi_solver_tpu.config import SolverConfig as JaxSolverConfig
from pcg_mpi_solver_tpu.models import make_cube_model as jax_cube
from pcg_mpi_solver_tpu.models.octree import make_octree_model as jax_octree
from pcg_mpi_solver_tpu.parallel.mesh import make_mesh
from pcg_mpi_solver_tpu.solver.newmark import NewmarkSolver as JaxNewmark
from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig
from pcg_mpi_solver_tpu_torch.models import make_cube_model, make_octree_model
from pcg_mpi_solver_tpu_torch.solver import (
    MassShiftedOps, NewmarkSolver, stable_dt)

DELTAS = [0.5, 1.0, 1.0, 0.7, 0.3]
CUBE = ((4, 3, 3), dict(h=0.5, nu=0.3, heterogeneous=True, seed=0))
OCTREE = ((2, 2, 2), dict(max_level=2, n_incl=2, seed=3, load="traction",
                          load_value=1.0))
MG_CUBE = ((8, 4, 4), dict(h=0.5, nu=0.3, heterogeneous=True, seed=1))
GOLDEN = {"iters": [19, 19, 19, 18, 18], "checksum": 158.3225146267945}
CASES = {"direct": dict(tol=1e-12),
         "block3": dict(tol=1e-12, precond="block3"),
         "mixed": dict(tol=1e-10, precision_mode="mixed"),
         "mg": dict(tol=1e-10, precond="mg")}
_JAX = {}


def _sc(case, **kw):
    return dict(max_iter=3000, **CASES[case], **kw)


def _build(builder, spec):
    args, kw = spec
    return builder(*args, **kw)


@pytest.fixture(scope="module")
def cubes():
    return _build(jax_cube, CUBE), _build(make_cube_model, CUBE)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ("PCG_TPU_ENABLE_HYBRID", "PCG_TPU_FAULTS"):
        monkeypatch.delenv(k, raising=False)


def _jax(key, model, case, n_parts=4, dt=0.2, damping=0.1, backend="auto",
         init=None, **kw):
    """(iters, (u, v, w), backend) of JAX's NewmarkSolver, run once."""
    if key not in _JAX:
        s = JaxNewmark(model, JaxRunConfig(solver=JaxSolverConfig(
            **_sc(case, **kw))), mesh=make_mesh(n_parts), n_parts=n_parts,
            dt=dt, damping=damping, backend=backend)
        res = s.run(DELTAS, init_accel_delta=init)
        assert all(r.flag == 0 for r in res)
        _JAX[key] = ([r.iters for r in res], s.state_global(), s.backend)
    return _JAX[key]


def _port(model, case, n_parts=4, dt=0.2, damping=0.1, **kw):
    sc = {k: kw.pop(k) for k in list(kw)
          if k in ("iters_per_dispatch", "pcg_variant")}
    return NewmarkSolver(model, RunConfig(solver=SolverConfig(
        **_sc(case, **sc))), n_parts=n_parts, dt=dt, damping=damping,
        device="cpu", **kw)


def _state_close(got, want, rel):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=rel * np.abs(b).max())


@pytest.mark.parametrize("case", ["direct", "block3"])
def test_direct_matches_jax(cubes, case):
    it_j, st_j, _b = _jax(case, cubes[0], case)
    s = _port(cubes[1], case)
    assert s.backend == "general" and s._dispatch_cap == 0
    res = s.run(DELTAS)
    assert all(r.flag == 0 and r.relres <= CASES[case]["tol"] for r in res)
    its = [r.iters for r in res]
    assert all(abs(a - b) <= 1 for a, b in zip(its, it_j)), (its, it_j)
    _state_close(s.state_global(), st_j, 1e-9)
    if case == "direct":
        assert all(abs(a - b) <= 1 for a, b in zip(its, GOLDEN["iters"]))
        assert np.isclose(np.abs(s.state_global()[0]).sum(),
                          GOLDEN["checksum"], rtol=1e-8)


@pytest.mark.parametrize("variant", ["fused", "pipelined"])
def test_variants_match_jax(cubes, variant):
    """The recurrence variants on A: their loops reach only the assembled
    entries of ``MassShiftedOps`` (a ``*_local`` call would raise), with
    JAX's iterations (+-1 a step) and u, v, w within 1e-9."""
    it_j, st_j, _b = _jax(variant, cubes[0], "direct", pcg_variant=variant)
    s = _port(cubes[1], "direct", pcg_variant=variant)
    res = s.run(DELTAS)
    assert all(r.flag == 0 for r in res)
    its = [r.iters for r in res]
    assert all(abs(a - b) <= 1 for a, b in zip(its, it_j)), (its, it_j)
    _state_close(s.state_global(), st_j, 1e-9)


def test_mixed_matches_jax(cubes):
    it_j, st_j, _b = _jax("mixed", cubes[0], "mixed")
    s = _port(cubes[1], "mixed")
    res = s.run(DELTAS)
    assert all(r.flag == 0 and r.relres <= CASES["mixed"]["tol"]
               for r in res)
    tot, tot_j = sum(r.iters for r in res), sum(it_j)
    assert abs(tot - tot_j) <= max(3, 0.05 * tot_j), (tot, tot_j)
    u, u_j = s.displacement_global(), st_j[0]
    np.testing.assert_allclose(u, u_j, rtol=0, atol=1e-7 * np.abs(u_j).max())
    assert s.data32["diag_M"].dtype == torch.float32


@pytest.mark.parametrize("case", ["direct", "mixed"])
def test_chunked_matches_one_shot(cubes, case):
    one = _port(cubes[1], case)
    r1 = one.run(DELTAS)
    ch = _port(cubes[1], case, iters_per_dispatch=7)
    assert ch._dispatch_cap == 7
    r2 = ch.run(DELTAS)
    assert all(r.flag == 0 for r in r1 + r2)
    assert ch.dispatch_log
    u1, u2 = one.displacement_global(), ch.displacement_global()
    if case == "direct":
        assert [r.iters for r in r1] == [r.iters for r in r2]
        np.testing.assert_allclose(u2, u1, rtol=1e-12, atol=0)
    else:
        assert np.abs(u2 - u1).max() / np.abs(u1).max() < 1e-7


@pytest.mark.parametrize("case", ["direct", "mixed"])
def test_hybrid_octree_matches_jax(monkeypatch, case):
    monkeypatch.setenv("PCG_TPU_ENABLE_HYBRID", "1")
    it_j, st_j, b_j = _jax(f"hybrid-{case}", _build(jax_octree, OCTREE),
                           case, n_parts=2, dt=0.1, damping=0.0)
    s = _port(_build(make_octree_model, OCTREE), case, n_parts=2, dt=0.1,
              damping=0.0)
    assert s.backend == b_j == "hybrid"
    assert s.ops.level_dims and s.ops.combine == s.base_ops.combine
    res = s.run(DELTAS)
    assert all(r.flag == 0 for r in res)
    its = [r.iters for r in res]
    if case == "direct":
        assert all(abs(a - b) <= 1 for a, b in zip(its, it_j)), (its, it_j)
        _state_close(s.state_global(), st_j, 1e-9)
    else:
        assert abs(sum(its) - sum(it_j)) <= max(3, 0.05 * sum(it_j))
        np.testing.assert_allclose(s.displacement_global(), st_j[0], rtol=0,
                                   atol=1e-7 * np.abs(st_j[0]).max())


def test_mg_general_matches_jax():
    it_j, st_j, _b = _jax("mg", _build(jax_cube, MG_CUBE), "mg", n_parts=2)
    s = _port(_build(make_cube_model, MG_CUBE), "mg", n_parts=2)
    assert s.backend == "general" and s.mg_setup is not None
    res = s.run(DELTAS)
    its = [r.iters for r in res]
    assert all(r.flag == 0 for r in res)
    assert all(abs(a - b) <= 1 for a, b in zip(its, it_j)), (its, it_j)
    _state_close(s.state_global()[:1], st_j[:1], 1e-9)


def test_mg_on_hybrid_raises(monkeypatch):
    monkeypatch.setenv("PCG_TPU_ENABLE_HYBRID", "1")
    with pytest.raises(ValueError, match="general backend only"):
        _port(_build(make_octree_model, OCTREE), "mg", n_parts=1)


def test_init_accel_matches_jax(cubes):
    it_j, st_j, _b = _jax("init", cubes[0], "direct", init=0.5)
    s = _port(cubes[1], "direct")
    res = s.run(DELTAS, init_accel_delta=0.5)
    assert all(abs(r.iters - b) <= 1 for r, b in zip(res, it_j))
    _state_close(s.state_global(), st_j, 1e-9)


def test_mass_shifted_ops_blocks_partial_assembly(cubes):
    s = _port(cubes[1], "direct", n_parts=1)
    w = s.ops
    assert isinstance(w, MassShiftedOps) and w.c == s.a0 + s.a1 * 0.1
    with pytest.raises(NotImplementedError):
        w.matvec_local(s.data, s.u)
    for name in ("diag_local", "_node_block_local"):
        with pytest.raises(NotImplementedError):
            getattr(w, name)(s.data)
    # shift-invariant members delegate to the unshifted base
    assert w.wdot == w.base.wdot and w.n_loc == w.base.n_loc
    x = torch.ones_like(s.u) * s.data["eff"]
    shift = w.matvec(s.data, x) - w.base.matvec(s.data, x)
    torch.testing.assert_close(shift, w.c * s.data["diag_M"] * x)
    torch.testing.assert_close(w.diag(s.data) - w.base.diag(s.data),
                               w.c * s.data["diag_M"])


def test_gamma_validation():
    m = make_cube_model(2, 2, 2)
    with pytest.raises(ValueError, match="gamma"):
        NewmarkSolver(m, RunConfig(), device="cpu", gamma=0.0)
    with pytest.warns(UserWarning, match="unstable"):
        NewmarkSolver(m, RunConfig(), device="cpu", gamma=0.4)
    with pytest.warns(UserWarning, match="conditionally stable"):
        NewmarkSolver(m, RunConfig(), device="cpu", beta=0.2, gamma=0.6)
    for kw in (dict(beta=0.0), dict(dt=0.0)):
        with pytest.raises(ValueError):
            NewmarkSolver(m, RunConfig(), device="cpu", **kw)


def test_unconditional_stability():
    model = make_cube_model(3, 3, 3)
    s = NewmarkSolver(model, RunConfig(solver=SolverConfig(
        tol=1e-10, max_iter=3000)), n_parts=2, device="cpu",
        dt=50.0 * stable_dt(model))
    assert all(r.flag == 0 for r in s.run([1.0] * 20))
    u, v, w = s.state_global()
    assert np.abs(u).max() < 1e3 * (np.abs(model.F).max() / model.ck.min())
    assert np.isfinite(v).all() and np.isfinite(w).all()

"""mg on the general backend (``precond="mg"`` on octree lattices) against
the JAX package, on the CPU.

- ``fine_lattice`` on the octree: the dims and the per-node lattice
  coords from ``model.octree`` equal the JAX package's.
- ``build_mg_host`` on the 2^3/L2 octree, at one part and at two, each
  package on its own partition: the fine transfer (``gidx``, ``gw``),
  every level's ``ck``, ``eff``, ``idiag``, ``gidx`` and ``gw``, ``Ke`` and
  the coarse bounds; integer leaves equal, float leaves within 1e-12
  relative (the numpy is the JAX package's, so they come out bitwise).
- The fine-transfer rows follow ``Ops._as_node3``: each local node row
  of the general layout holds the dofs 3 * node_gid + c.
- ``Solver`` against the JAX Solver (``iters_per_dispatch=0``) on the
  2^3/L2 and 3^3/L2 octrees and on a 16x6x6 cube forced to the general
  backend, at one part and at two: direct float64 the same flag and iterations within +-1 (the
  element products and the restriction sum in another order than XLA's,
  which can move an exit at the tol boundary by one), mixed within
  max(3, 5 %), solutions within 1e-8 (direct) and 1e-5 (mixed) of
  max|u|; mg takes fewer iterations than jacobi, as JAX's
  ``tests/test_mg.py`` asserts, and the forced-general cube agrees with
  its structured mg solve within 2 iterations.
- An ``mg_levels`` past the lattice raises ``PreflightError`` naming
  ``mg_levels`` with the JAX package's message, on the octree and on a
  cube; with the preflight off, the builder's ``MGSetupError``; under
  ``warn``, the JAX package's warning and then that ``MGSetupError``.  mg on
  the hybrid backend stays refused, with the JAX package's ``ValueError``.
"""

import numpy as np
import pytest
import torch

from pcg_mpi_solver_tpu import RunConfig as JaxRunConfig
from pcg_mpi_solver_tpu import SolverConfig as JaxSolverConfig
from pcg_mpi_solver_tpu.models.octree import make_octree_model as jax_octree
from pcg_mpi_solver_tpu.models.synthetic import make_cube_model as jax_cube
from pcg_mpi_solver_tpu.ops import mg as jmg
from pcg_mpi_solver_tpu.parallel.mesh import make_mesh
from pcg_mpi_solver_tpu.parallel.partition import (
    partition_model as jax_partition_model)
from pcg_mpi_solver_tpu.solver import Solver as JaxSolver
from pcg_mpi_solver_tpu.validate import PreflightError as JaxPreflightError
from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig
from pcg_mpi_solver_tpu_torch.models import (
    make_cube_model, make_octree_model)
from pcg_mpi_solver_tpu_torch.ops import mg
from pcg_mpi_solver_tpu_torch.parallel.partition import partition_model
from pcg_mpi_solver_tpu_torch.solver import Solver
from pcg_mpi_solver_tpu_torch.validate import PreflightError

OCT = dict(n_incl=2, seed=3, load="traction", load_value=1.0)
CUBE = dict(E=30e9, nu=0.3, heterogeneous=True, seed=5, load_value=1e6)


def assert_trees_match(got, ref, rtol=1e-12):
    """Integer leaves equal, float leaves within ``rtol`` of the largest
    value."""
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
            scale = max(float(np.abs(ref).max(initial=0.0)), 1e-300)
            np.testing.assert_allclose(got, ref, rtol=0,
                                       atol=rtol * scale)


@pytest.fixture(scope="module", params=[1, 2], ids=["P1", "P2"])
def octree(request):
    P = request.param
    jm = jax_octree(2, 2, 2, max_level=2, **OCT)
    tm = make_octree_model(2, 2, 2, max_level=2, **OCT)
    jpm = jax_partition_model(jm, P)
    tpm = partition_model(tm, P)
    return dict(P=P, jm=jm, tm=tm, jpm=jpm, tpm=tpm,
                jsetup=jmg.build_mg_host(jm, jpm),
                tsetup=mg.build_mg_host(tm, tpm))


def test_fine_lattice_reads_the_octree_like_jax(octree):
    jdims, jlat = jmg.fine_lattice(octree["jm"])
    tdims, tlat = mg.fine_lattice(octree["tm"])
    assert tdims == jdims == (8, 8, 8)
    np.testing.assert_array_equal(tlat, jlat)


def test_build_mg_host_on_octree_matches_jax(octree):
    js, ts = octree["jsetup"], octree["tsetup"]
    assert_trees_match(ts.tree, js.tree)
    assert ts.meta == js.meta
    assert ts.meta["dims"] == [8, 8, 8] and ts.meta["levels"] >= 2
    np.testing.assert_allclose(ts.coarse_lams, js.coarse_lams, rtol=1e-12)
    np.testing.assert_allclose(ts.lam_min_coarse, js.lam_min_coarse,
                               rtol=1e-12)
    # the coarse levels rediscretize with the octree's brick type
    bt = octree["tm"].octree["brick_type"]
    np.testing.assert_array_equal(ts.tree["Ke"],
                                  octree["tm"].elem_lib[bt]["Ke"])


def test_fine_transfer_follows_the_general_node_rows(octree):
    """The fine transfer is laid out by ``pm.node_gid``; the general
    operator's ``_as_node3`` must read the same node in that row, i.e.
    its dofs are 3 * node_gid + c on every valid slot."""
    s = Solver(octree["tm"], RunConfig(solver=SolverConfig(
        precond="mg", max_iter=50)), n_parts=octree["P"], device="cpu")
    assert s.backend == "general" and s.pm.node_layout
    gid = torch.as_tensor(s.pm.dof_gid)
    rows = s.ops._as_node3(gid).numpy()
    ng = s.pm.node_gid
    valid = ng >= 0
    want = 3 * ng[..., None] + np.arange(3)
    np.testing.assert_array_equal(rows[valid], want[valid])
    np.testing.assert_array_equal(
        s.mg_setup.tree["fine"]["gidx"], octree["tsetup"].tree["fine"]["gidx"])


def _solve_both(jm, tm, sc, backend="general", n_parts=1):
    js = JaxSolver(jm, JaxRunConfig(solver=JaxSolverConfig(
        iters_per_dispatch=0, **sc)), mesh=make_mesh(n_parts),
        n_parts=n_parts, backend=backend)
    ts = Solver(tm, RunConfig(solver=SolverConfig(**sc)), n_parts=n_parts,
                device="cpu", backend=backend)
    assert ts.pm.glob_n_dof_eff - sc["max_iter"] >= 5
    return js, js.step(1.0), ts, ts.step(1.0)


MODELS = {
    "oct2": (lambda: jax_octree(2, 2, 2, max_level=2, **OCT),
             lambda: make_octree_model(2, 2, 2, max_level=2, **OCT)),
    "oct3": (lambda: jax_octree(3, 3, 3, max_level=2, **OCT),
             lambda: make_octree_model(3, 3, 3, max_level=2, **OCT)),
    "cube16": (lambda: jax_cube(16, 6, 6, **CUBE),
               lambda: make_cube_model(16, 6, 6, **CUBE)),
}


@pytest.mark.parametrize("n_parts", [1, 2], ids=["P1", "P2"])
@pytest.mark.parametrize("mode", ["direct", "mixed"])
@pytest.mark.parametrize("name", ["oct2", "oct3", "cube16"])
def test_solver_mg_general_matches_jax(name, mode, n_parts):
    jm, tm = (f() for f in MODELS[name])
    sc = dict(tol=1e-8, max_iter=400, precond="mg", precision_mode=mode,
              **(dict(inner_tol=1e-4) if mode == "mixed" else {}))
    js, rj, ts, rt = _solve_both(jm, tm, sc, n_parts=n_parts)
    assert ts.backend == js.backend == "general"
    assert ts.mg_setup.meta == js._mg_meta
    assert rt.flag == rj.flag == 0
    if mode == "direct":
        assert abs(rt.iters - rj.iters) <= 1, (rt.iters, rj.iters)
        tol_u = 1e-8
    else:
        assert abs(rt.iters - rj.iters) <= max(3, 0.05 * rj.iters), \
            (rt.iters, rj.iters)
        tol_u = 1e-5
    assert rt.relres <= 1e-8
    uj, ut = js.displacement_global(), ts.displacement_global()
    assert np.abs(ut - uj).max() <= tol_u * np.abs(uj).max()


def test_mg_beats_jacobi_on_the_octree():
    """JAX ``tests/test_mg.py::test_mg_octree_model_on_general_backend`` on
    the port: mg converges in fewer iterations than jacobi, to the same
    solution."""
    tm = make_octree_model(2, 2, 2, max_level=2, **OCT)
    out = {}
    for pc in ("jacobi", "mg"):
        s = Solver(tm, RunConfig(solver=SolverConfig(
            tol=1e-8, max_iter=400, precond=pc)), n_parts=2, device="cpu")
        out[pc] = (s.step(1.0), s.displacement_global())
    (rj, uj), (rm, um) = out["jacobi"], out["mg"]
    assert rj.flag == 0 and rm.flag == 0
    assert rm.iters < rj.iters, (rm.iters, rj.iters)
    np.testing.assert_allclose(um, uj, rtol=1e-4,
                               atol=1e-7 * np.abs(uj).max())


def test_general_cube_mg_matches_structured():
    """JAX ``test_mg_structured_backend_matches_general`` on the port: the
    one hierarchy through both backends' node layouts."""
    tm = make_cube_model(16, 6, 6, **CUBE)
    res = {}
    for be in ("general", "structured"):
        s = Solver(tm, RunConfig(solver=SolverConfig(
            tol=1e-8, max_iter=400, precond="mg")), n_parts=2,
            device="cpu", backend=be)
        res[be] = (s.step(1.0), s.displacement_global())
    (rg, ug), (rs, us) = res["general"], res["structured"]
    assert rg.flag == rs.flag == 0
    assert abs(rg.iters - rs.iters) <= 2
    np.testing.assert_allclose(us, ug, rtol=1e-6,
                               atol=1e-9 * np.abs(ug).max())


@pytest.mark.parametrize("which", ["octree", "cube"])
def test_overdeep_mg_levels_is_a_preflight_error_like_jax(which,
                                                          monkeypatch):
    if which == "octree":
        jm = jax_octree(2, 2, 2, max_level=2, **OCT)
        tm = make_octree_model(2, 2, 2, max_level=2, **OCT)
        levels = 4                  # the 8^3 lattice coarsens 3 times
    else:
        jm, tm = jax_cube(8, 4, 4, **CUBE), make_cube_model(8, 4, 4, **CUBE)
        levels = 3
    sc = dict(precond="mg", mg_levels=levels)
    with pytest.raises(JaxPreflightError, match="mg_levels") as jinfo:
        JaxSolver(jm, JaxRunConfig(solver=JaxSolverConfig(**sc)),
                  mesh=make_mesh(1), n_parts=1)
    with pytest.raises(PreflightError, match="mg_levels") as tinfo:
        Solver(tm, RunConfig(solver=SolverConfig(**sc)), device="cpu")
    assert str(tinfo.value) == str(jinfo.value)
    # the policy off: the hierarchy builder's own reason, as JAX's
    monkeypatch.setenv("PCG_TPU_PREFLIGHT", "off")
    with pytest.raises(jmg.MGSetupError) as jinfo:
        JaxSolver(jm, JaxRunConfig(solver=JaxSolverConfig(**sc)),
                  mesh=make_mesh(1), n_parts=1)
    with pytest.raises(mg.MGSetupError) as tinfo:
        Solver(tm, RunConfig(solver=SolverConfig(**sc)), device="cpu")
    assert str(tinfo.value) == str(jinfo.value)


def test_preflight_warn_policy_warns_then_the_builder_refuses_like_jax(
        monkeypatch):
    """Under ``PCG_TPU_PREFLIGHT=warn`` the failed check becomes a warning
    with the JAX package's message, and construction goes on to the
    hierarchy builder, which raises its own reason."""
    sc = dict(precond="mg", mg_levels=4)      # the 8^3 lattice: 3 at most
    monkeypatch.setenv("PCG_TPU_PREFLIGHT", "warn")
    with pytest.warns(UserWarning, match="mg_levels") as jw, \
            pytest.raises(jmg.MGSetupError) as jinfo:
        JaxSolver(jax_octree(2, 2, 2, max_level=2, **OCT),
                  JaxRunConfig(solver=JaxSolverConfig(**sc)),
                  mesh=make_mesh(1), n_parts=1)
    with pytest.warns(UserWarning, match="mg_levels") as tw, \
            pytest.raises(mg.MGSetupError) as tinfo:
        Solver(make_octree_model(2, 2, 2, max_level=2, **OCT),
               RunConfig(solver=SolverConfig(**sc)), device="cpu")
    pick = (lambda ws: [str(w.message) for w in ws
                        if "preflight rejected" in str(w.message)])
    assert pick(tw) == pick(jw) and len(pick(tw)) == 1
    assert str(tinfo.value) == str(jinfo.value)


def test_replication_cap_is_a_preflight_error_like_jax():
    sc = dict(precond="mg", mg_max_replicated_dofs=100)
    with pytest.raises(JaxPreflightError, match="mg_replication") as jinfo:
        JaxSolver(jax_octree(2, 2, 2, max_level=2, **OCT),
                  JaxRunConfig(solver=JaxSolverConfig(**sc)),
                  mesh=make_mesh(1), n_parts=1)
    with pytest.raises(PreflightError, match="mg_replication") as tinfo:
        Solver(make_octree_model(2, 2, 2, max_level=2, **OCT),
               RunConfig(solver=SolverConfig(**sc)), device="cpu")
    assert str(tinfo.value) == str(jinfo.value)


def test_mg_on_hybrid_stays_refused():
    tm = make_octree_model(2, 2, 2, max_level=2, **OCT)
    with pytest.raises(ValueError, match="precond='mg' is not supported "
                                         "on the hybrid"):
        Solver(tm, RunConfig(solver=SolverConfig(precond="mg")),
               device="cpu", backend="hybrid")

"""The frozen input generators against the port's, array for array, and the
seeded loads against themselves."""

import dataclasses
import json

import numpy as np
import pytest

from cardbench.inputs import build_model, model_key
from cardbench.inputs.cube import make_cube_model
from cardbench.inputs.loads import Loads, column_vector, pattern_vectors
from cardbench.inputs.octree import make_octree_model
from cardbench.registry import REPO


def _same(a, b, path="model"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path
    else:
        assert a == b, path


def _same_models(frozen, port):
    names = [f.name for f in dataclasses.fields(frozen)]
    assert names == [f.name for f in dataclasses.fields(port)]
    for n in names:
        _same(getattr(frozen, n), getattr(port, n), n)


@pytest.mark.parametrize("kw", [
    dict(nx=4, E=30e9, nu=0.2, load="traction", load_value=1e6,
         heterogeneous=True),
    dict(nx=5, ny=3, nz=2, load="dirichlet", load_value=0.01),
    dict(nx=22, E=30e9, nu=0.2, load="traction", load_value=1e6,
         heterogeneous=True),
])
def test_cube_matches_port(kw):
    from pcg_mpi_solver_tpu_torch.models import make_cube_model as port

    _same_models(make_cube_model(**kw), port(**kw))


@pytest.mark.parametrize("kw", [
    dict(nx0=3, ny0=3, nz0=3, max_level=2, n_incl=6, seed=2, E=30e9,
         nu=0.2, load="traction", load_value=1e6),
    dict(nx0=2, ny0=3, nz0=2, max_level=3, n_incl=2, seed=5),
    dict(nx0=2, ny0=2, nz0=2, max_level=2, load="dirichlet",
         canonicalize=False),
])
def test_octree_matches_port(kw):
    from pcg_mpi_solver_tpu_torch.models import octree

    _same_models(make_octree_model(**kw), octree.make_octree_model(**kw))


def test_model_cache_builds_once_and_loads_the_same(tmp_path):
    cfg = {"name": "oct", "generator": "octree", "cache_model": True,
           "params": dict(nx0=2, ny0=2, nz0=2, max_level=2, n_incl=2)}
    built = build_model(cfg, tmp_path)
    files = list(tmp_path.iterdir())
    assert [f.name for f in files] == [f"oct-{model_key(cfg)}.pkl"]
    _same_models(build_model(cfg, tmp_path), built)
    assert model_key(dict(cfg, params=dict(cfg["params"], seed=1))) \
        != model_key(cfg)


STEP = json.loads((REPO / "cardbench" / "traffic" / "step.json").read_text())
BLOCK = {"entry": "solve_many", "block": 3,
         "load": {"rule": "columns", "columns": [
             {"pattern": "x", "low": 0.5, "high": 2.0},
             {"pattern": "y", "low": -1.0, "high": 1.0},
             {"mix": ["x", "y", "z"], "low": -1.0, "high": 1.0}]}}


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 9 * 2**40])
def test_step_loads_repeat_per_seed(seed):
    a = [Loads(STEP, seed).case(k) for k in range(6)]
    b = [Loads(STEP, seed).case(k) for k in reversed(range(6))][::-1]
    assert a == b
    spec = STEP["load"]["columns"][0]
    for (col,) in a:
        assert sorted(col["factors"]) == ["x", "y", "z"]
        assert all(spec["low"] <= abs(f) < spec["high"]
                   for f in col["factors"].values())
    signs = {tuple(np.sign(list(c["factors"].values()))) for (c,) in a}
    assert len(signs) > 1
    assert a != [Loads(STEP, seed + 1).case(k) for k in range(6)]


def test_step_loads_are_linearly_independent_case_by_case():
    """No case's load is a multiple of an earlier one, nor a combination of
    earlier ones: six cases span six dimensions, though they mix three
    patterns."""
    m = make_cube_model(3, load="traction", load_value=2.0)
    pats = pattern_vectors(m.F)
    loads = Loads(STEP, 2**31 + 3)
    vs = np.stack([column_vector(loads.case(k)[0], pats) for k in range(6)])
    assert np.linalg.matrix_rank(vs) == 6
    np.testing.assert_array_equal(
        vs[4], column_vector(Loads(STEP, 2**31 + 3).case(4)[0], pats))
    # each node keeps the configuration's loaded support, within 25 %
    col = loads.case(0)[0]
    smooth = column_vector(dict(col, rough=0.0), pats)
    on = smooth != 0
    assert np.array_equal(vs[0] != 0, on)
    ratio = vs[0][on] / smooth[on]
    assert ratio.min() >= 0.75 and ratio.max() < 1.25 and ratio.std() > 0.05


def test_block_loads_repeat_and_follow_their_patterns():
    m = make_cube_model(3, load="traction", load_value=2.0)
    pats = pattern_vectors(m.F)
    np.testing.assert_array_equal(pats["x"], m.F)
    assert np.array_equal(pats["y"][1::3], m.F[0::3])
    assert not pats["z"][0::3].any() and not pats["z"][1::3].any()
    cols = Loads(BLOCK, 3).case(2)
    assert cols == Loads(BLOCK, 3).case(2)
    assert [sorted(c["factors"]) for c in cols] == [["x"], ["y"],
                                                     ["x", "y", "z"]]
    v = column_vector(cols[2], pats)
    np.testing.assert_allclose(
        v, sum(cols[2]["factors"][p] * pats[p] for p in "xyz"))


@pytest.mark.parametrize("bad", [
    {"entry": "serve", "load": {"rule": "columns"}},
    {"entry": "step", "load": {"rule": "pow2", "low": -8, "high": 8}},
    dict(STEP, block=2),
    dict(BLOCK, block=2),
    {"entry": "solve_many", "block": 1, "load": {
        "rule": "columns", "columns": [{"pattern": "w", "low": 0,
                                        "high": 1}]}},
    {"entry": "step", "block": 1, "load": {
        "rule": "columns", "columns": [{"pattern": "x", "low": 1,
                                        "high": 1}]}},
    {"entry": "step", "block": 1, "load": {
        "rule": "columns", "columns": [{"pattern": "x", "low": 0,
                                        "high": 1, "rough": 1.0}]}},
])
def test_loads_refuse_what_they_cannot_follow(bad):
    with pytest.raises((ValueError, KeyError)):
        Loads(bad, 0)


@pytest.mark.parametrize("iters_per_dispatch", [-1, 40])
def test_the_step_entry_solves_the_load_it_is_given(iters_per_dispatch):
    """The step entry puts each case's load where the port's step reads it,
    on the one-shot and on the chunked path: the answer solves that load
    by the reference, and the model's own load placed so is what the
    program holds."""
    from pcg_mpi_solver_tpu_torch.config import RunConfig, SolverConfig
    from pcg_mpi_solver_tpu_torch.solver.driver import Solver

    from cardbench.harness import port_model
    from cardbench.reference.judge import Judge
    from cardbench.reference.operator import ElementOperator
    from cardbench.registry import Registry

    entry = Registry().module("entries", "step")
    m = make_octree_model(2, 2, 2, max_level=2, n_incl=2, E=30e9,
                          load_value=1e6)
    s = Solver(port_model(m), RunConfig(solver=SolverConfig(
        tol=1e-7, max_iter=20000, precision_mode="mixed", precond="block3",
        iters_per_dispatch=iters_per_dispatch)), n_parts=1, device="cpu",
        backend="general")
    entry.prepare(s, m)
    pats = pattern_vectors(m.F)
    judge = Judge(m, ElementOperator(m))
    loads = Loads(STEP, 5)
    us = []
    for k in range(2):
        f = column_vector(loads.case(k)[0], pats)
        trips, flags, h = entry.solve(s, f[:, None])
        u = entry.answer(s, h)
        assert trips > 0 and flags == [0] and u.shape == (m.n_dof, 1)
        assert judge.relres(u[:, 0], f, entry.dirichlet(m)) <= 1e-7
        us.append(u[:, 0])
    assert not np.allclose(us[0], us[1])

"""The chunked blocked path of ``Solver.solve_many`` (capped resumable
``pcg_many`` calls, one recovery ladder a column, ``many_*.npz``
snapshots and ``resume=True``, column faults) against the JAX package's
``_solve_many_chunked``, on the CPU.

The model is JAX ``tests/test_pcg_many.py``'s heterogeneous 4x3x3 cube
at two parts (the structured slab; one case on the general backend), the
block [F, a random load on the effective dofs], direct float64,
``iters_per_dispatch=20`` on both sides (the same cap, so the same chunk
boundaries).

- Each variant against JAX's chunked block: per-column flags and
  iterations exact, ``recoveries`` and ``drift`` equal, x within 2e-9 of
  max|x|.  A window of 1e-12 cannot hold: the element products and the
  dots sum in another order than XLA's, and over ~70 CG iterations that
  moves x by 3.8e-10 (classic), 4.1e-10 (fused), 5.2e-11 (pipelined) and
  6.5e-11 (classic, general backend) of max|x| here; 2e-9 is five times
  the largest.  Against the port's own one-shot block: the same flags
  and iterations and x bit for bit.
- The chaos matrix of JAX ``tests/test_pcg_many.py:291-352``: ``nan``,
  ``inf`` and ``rho0`` at ``col:1`` give the same ``recovery`` events
  (action, trigger, column) and ``fault`` events as JAX's, flags 0; the
  healthy column's x and iterations are bit for bit a fault-free port
  block's (every variant); the poisoned column's iterations equal JAX's
  under classic and fused, and are within 1 under pipelined, whose
  recurrence amplifies the summation order after a restart (measured:
  107 against 108).  With ``max_recoveries=0`` the column is
  quarantined (flag 5, one ``rhs_quarantine`` event) in both packages.
- Under mg a column fault fired twice takes the ladder's fallback rung
  (the scalar-Jacobi operand, ``prec_sel``) with JAX's events; the
  restarted column's iterations are within 1 of JAX's (the port's mg
  window, ``tests/test_torch_mg.py``).
- The mirrors of JAX ``:208-284`` and ``:353-470``: kill-and-resume bit
  for bit, also after a recovery; a resume at another width or of other
  loads is a fingerprint mismatch naming ``nrhs`` or ``rhs_hash``;
  retention and ``latest`` of the ``many_*`` files; ``many_fallback`` in
  the fingerprint; the one-shot path's retry guard and a column fault
  that cannot land there; snapshot and resume requests on the one-shot
  path are noted, not refused.
- The port's blocked snapshot fingerprint equals JAX's
  ``SnapshotStore.for_many_solver`` dict, and its carry leaves, stored in
  the port's (R, P, n_loc) layout, equal JAX's (P, n_loc, R) leaves after
  a moveaxis, at the first boundary (20 iterations): integers exactly,
  floats within 1e-10 of each leaf's largest value (measured: 2e-12).
  Later the summation order's drift grows into the residual-sized leaves
  (3 % in the norms after 60 iterations), so the test stops at the first
  boundary.
"""

import glob
import os

import numpy as np
import pytest

from pcg_mpi_solver_tpu.cache.keys import array_hash as jax_array_hash
from pcg_mpi_solver_tpu.config import RunConfig as JaxRunConfig
from pcg_mpi_solver_tpu.config import SolverConfig as JaxSolverConfig
from pcg_mpi_solver_tpu.models.synthetic import make_cube_model as jax_cube
from pcg_mpi_solver_tpu.obs.metrics import MetricsRecorder as JaxRecorder
from pcg_mpi_solver_tpu.parallel.mesh import make_mesh
from pcg_mpi_solver_tpu.resilience import FaultPlan as JaxFaultPlan
from pcg_mpi_solver_tpu.resilience import SimulatedKill as JaxSimulatedKill
from pcg_mpi_solver_tpu.solver.driver import Solver as JaxSolver
from pcg_mpi_solver_tpu.utils.checkpoint import (
    SnapshotStore as JaxSnapshotStore)
from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig
from pcg_mpi_solver_tpu_torch.models import make_cube_model
from pcg_mpi_solver_tpu_torch.obs.metrics import MetricsRecorder
from pcg_mpi_solver_tpu_torch.resilience import FaultPlan, SimulatedKill
from pcg_mpi_solver_tpu_torch.solver import Solver
from pcg_mpi_solver_tpu_torch.utils.checkpoint import (
    SnapshotStore, array_hash)

VARIANTS = ["classic", "fused", "pipelined"]


class _Capture:
    def __init__(self):
        self.events = []

    def emit(self, ev):
        self.events.append(ev)

    def close(self):
        pass


@pytest.fixture(autouse=True)
def _fast_backoff(monkeypatch):
    monkeypatch.setenv("PCG_TPU_RETRY_BACKOFF_S", "0.01")


@pytest.fixture(scope="module")
def models():
    return (jax_cube(4, 3, 3, heterogeneous=True),
            make_cube_model(4, 3, 3, heterogeneous=True))


def _hard_load(model, seed=5):
    """JAX ``tests/test_pcg_many.py``'s rough load: a random field on the
    effective dofs."""
    rng = np.random.default_rng(seed)
    f = np.zeros(model.n_dof)
    eff = np.asarray(model.dof_eff)
    f[eff] = rng.standard_normal(eff.size)
    return f


def _block(model):
    return np.stack([np.asarray(model.F), _hard_load(model)], axis=-1)


def _cfgs(tmp_path, *, ipd=20, snap=0, maxrec=2, run_id="1", **kw):
    """(JAX RunConfig, port RunConfig) of one case."""
    kw = dict(dict(tol=1e-8, max_iter=2000, iters_per_dispatch=ipd,
                   max_recoveries=maxrec), **kw)
    out = []
    for rc, sc in ((JaxRunConfig, JaxSolverConfig),
                   (RunConfig, SolverConfig)):
        cfg = rc(scratch_path=str(tmp_path), run_id=run_id,
                 solver=sc(**kw))
        cfg.snapshot_every = snap
        out.append(cfg)
    return out


def _jax(model, cfg, fault=None, cap=None, backend="auto"):
    s = JaxSolver(model, cfg, mesh=make_mesh(2), n_parts=2, backend=backend,
                  recorder=JaxRecorder(sinks=[cap] if cap else []))
    if fault is not None:
        s.fault_plan = JaxFaultPlan(fault, recorder=s.recorder)
    return s


def _port(model, cfg, fault=None, cap=None, backend="auto"):
    s = Solver(model, cfg, n_parts=2, device="cpu", backend=backend,
               recorder=MetricsRecorder(sinks=[cap] if cap else []))
    if fault is not None:
        s.fault_plan = FaultPlan(fault, recorder=s.recorder)
    return s


def _x(res):
    return np.asarray(res.x)


def _events(cap, kind, keys):
    return [tuple(e[k] for k in keys) for e in cap.events
            if e["kind"] == kind]


@pytest.mark.parametrize("variant", VARIANTS)
def test_chunked_block_matches_jax_and_the_one_shot(models, tmp_path,
                                                    variant):
    jm, tm = models
    fb = _block(jm)
    jcfg, tcfg = _cfgs(tmp_path, pcg_variant=variant)
    js = _jax(jm, jcfg)
    ts = _port(tm, tcfg)
    assert ts._dispatch_cap == 20
    rj, rt = js.solve_many(fb), ts.solve_many(fb)
    assert list(rt.flags) == list(rj.flags) == [0, 0]
    np.testing.assert_array_equal(rt.iters, np.asarray(rj.iters))
    assert (rt.recoveries, rt.drift) == (rj.recoveries, rj.drift)
    assert max(rt.iters) > 40, "the block must span several dispatches"
    assert sum(1 for e in ts.dispatch_log if e[0] == "many") >= 3
    xj = js.displacement_global_many(rj.x)
    xt = ts.displacement_global_many(rt.x)
    assert np.abs(xt - xj).max() <= 2e-9 * np.abs(xj).max()
    assert (rt.relres <= 1e-8).all()
    # the port's one-shot block: the same iterations and x bit for bit
    _j, ocfg = _cfgs(tmp_path, ipd=0, pcg_variant=variant)
    ro = _port(tm, ocfg).solve_many(fb)
    assert list(ro.flags) == list(rt.flags)
    np.testing.assert_array_equal(ro.iters, rt.iters)
    np.testing.assert_array_equal(_x(ro), _x(rt))


def test_chunked_block_general_backend_matches_jax(models, tmp_path):
    jm, tm = models
    fb = _block(jm)
    jcfg, tcfg = _cfgs(tmp_path)
    js = _jax(jm, jcfg, backend="general")
    rj = js.solve_many(fb)
    ts = _port(tm, tcfg, backend="general")
    rt = ts.solve_many(fb)
    assert ts.backend == "general"
    assert list(rt.flags) == list(rj.flags) == [0, 0]
    np.testing.assert_array_equal(rt.iters, np.asarray(rj.iters))
    xj = js.displacement_global_many(rj.x)
    xt = ts.displacement_global_many(rt.x)
    assert np.abs(xt - xj).max() <= 2e-9 * np.abs(xj).max()


@pytest.mark.parametrize("variant", VARIANTS)
def test_column_fault_chaos_matrix_matches_jax(models, tmp_path, variant):
    jm, tm = models
    fb = _block(jm)
    jcfg, tcfg = _cfgs(tmp_path, pcg_variant=variant)
    ref = _port(tm, tcfg).solve_many(fb)
    jcap, tcap = _Capture(), _Capture()
    js, ts = _jax(jm, jcfg, cap=jcap), _port(tm, tcfg, cap=tcap)
    for mode in ("nan", "inf", "rho0"):
        spec = f"{mode}@col:1"
        js.fault_plan = JaxFaultPlan(spec, recorder=js.recorder)
        ts.fault_plan = FaultPlan(spec, recorder=ts.recorder)
        n_j, n_t = len(jcap.events), len(tcap.events)
        rj, rt = js.solve_many(fb), ts.solve_many(fb)
        jev = _Capture()
        jev.events, tev = jcap.events[n_j:], _Capture()
        tev.events = tcap.events[n_t:]
        keys = ("action", "trigger", "rhs")
        assert _events(tev, "recovery", keys) \
            == _events(jev, "recovery", keys) != [], mode
        assert _events(tev, "fault", ("mode", "point", "at")) \
            == _events(jev, "fault", ("mode", "point", "at")) \
            == [(mode, "col", 1)]
        assert list(rt.flags) == list(rj.flags) == [0, 0], mode
        assert rt.recoveries == rj.recoveries >= 1 and rt.quarantined == ()
        # fault isolation: the healthy column is the fault-free block's
        np.testing.assert_array_equal(_x(rt)[..., 0], _x(ref)[..., 0])
        assert rt.iters[0] == ref.iters[0] == rj.iters[0]
        window = 1 if variant == "pipelined" else 0
        assert abs(int(rt.iters[1]) - int(rj.iters[1])) <= window, \
            (mode, rt.iters, rj.iters)
    # the ladder off: the poisoned column is quarantined in both
    js.config.solver.max_recoveries = 0
    ts.config.solver.max_recoveries = 0
    js.fault_plan = JaxFaultPlan("nan@col:1", recorder=js.recorder)
    ts.fault_plan = FaultPlan("nan@col:1", recorder=ts.recorder)
    n_j, n_t = len(jcap.events), len(tcap.events)
    rj, rt = js.solve_many(fb), ts.solve_many(fb)
    assert list(rt.flags) == list(rj.flags) == [0, 5]
    assert rt.quarantined == tuple(rj.quarantined) == (1,)
    assert np.isfinite(rt.relres[1])
    keys = ("rhs", "trigger", "flag", "attempts")
    qj = [tuple(e[k] for k in keys) for e in jcap.events[n_j:]
          if e["kind"] == "rhs_quarantine"]
    qt = [tuple(e[k] for k in keys) for e in tcap.events[n_t:]
          if e["kind"] == "rhs_quarantine"]
    assert qt == qj == [(1, "nan_carry", 5, 0)]
    rhs = {e["rhs"]: e for e in tcap.events[n_t:] if e["kind"] == "rhs_solve"}
    assert rhs[1]["quarantined"] and not rhs[0]["quarantined"]
    np.testing.assert_array_equal(_x(rt)[..., 0], _x(ref)[..., 0])


def test_mg_column_fault_takes_the_fallback_rung_like_jax(tmp_path):
    """Under mg the ladder's second rung moves the column to the
    scalar-Jacobi fallback operand (``prec_sel``), as in JAX."""
    jm = jax_cube(8, 4, 4, heterogeneous=True, h=0.5, nu=0.3, seed=0)
    tm = make_cube_model(8, 4, 4, heterogeneous=True, h=0.5, nu=0.3, seed=0)
    fb = _block(jm)
    jcfg, tcfg = _cfgs(tmp_path, ipd=5, precond="mg")
    jcap, tcap = _Capture(), _Capture()
    spec = "rho0@col:1*2"
    rj = _jax(jm, jcfg, spec, jcap).solve_many(fb)
    rt = _port(tm, tcfg, spec, tcap).solve_many(fb)
    keys = ("action", "trigger", "rhs")
    assert _events(tcap, "recovery", keys) == _events(jcap, "recovery", keys)
    assert ("fallback_prec", "flag4", 1) in _events(tcap, "recovery", keys)
    assert list(rt.flags) == list(rj.flags) == [0, 0]
    # the healthy column exactly; the restarted one within 1, as the
    # port's mg solves against JAX's (tests/test_torch_mg.py: the
    # restriction sums in another order than XLA's scatter-add)
    assert rt.iters[0] == rj.iters[0]
    assert abs(int(rt.iters[1]) - int(rj.iters[1])) <= 1


def test_kill_and_resume_is_bitwise(models, tmp_path):
    jm, tm = models
    fb = _block(jm)
    ref = _port(tm, _cfgs(tmp_path, snap=1, run_id="ref")[1]).solve_many(fb)
    tcfg = _cfgs(tmp_path, snap=1)[1]
    with pytest.raises(SimulatedKill):
        _port(tm, tcfg, "kill@2").solve_many(fb)
    assert glob.glob(os.path.join(tcfg.checkpoint_path, "many_*.npz"))
    cap = _Capture()
    res = _port(tm, tcfg, cap=cap).solve_many(fb, resume=True)
    assert [e["op"] for e in cap.events if e["kind"] == "snapshot"][:1] \
        == ["restore"]
    assert list(res.flags) == [0, 0]
    np.testing.assert_array_equal(res.iters, ref.iters)
    np.testing.assert_array_equal(_x(res), _x(ref))
    # completion discards the snapshot
    assert not glob.glob(os.path.join(tcfg.checkpoint_path, "many_*.npz"))


def test_kill_and_resume_mid_recovery_is_bitwise(models, tmp_path):
    jm, tm = models
    fb = _block(jm)
    ref = _port(tm, _cfgs(tmp_path, snap=1, run_id="ref")[1],
                "rho0@col:1").solve_many(fb)
    assert list(ref.flags) == [0, 0] and ref.recoveries >= 1
    tcfg = _cfgs(tmp_path, snap=1)[1]
    with pytest.raises(SimulatedKill):
        _port(tm, tcfg, "rho0@col:1, kill@2").solve_many(fb)
    res = _port(tm, tcfg).solve_many(fb, resume=True)
    assert list(res.flags) == [0, 0] and res.recoveries == 0
    np.testing.assert_array_equal(res.iters, ref.iters)
    np.testing.assert_array_equal(_x(res), _x(ref))


def test_resume_of_another_width_or_other_loads_is_refused(models,
                                                           tmp_path):
    jm, tm = models
    F = np.asarray(tm.F)
    tcfg = _cfgs(tmp_path, snap=1)[1]
    with pytest.raises(SimulatedKill):
        _port(tm, tcfg, "kill@2").solve_many(np.stack([F, 0.5 * F], -1))
    s = _port(tm, tcfg)
    with pytest.raises(ValueError, match="nrhs"):
        s.solve_many(np.stack([F, 0.5 * F, 0.25 * F], -1), resume=True)
    with pytest.raises(ValueError, match="rhs_hash"):
        s.solve_many(np.stack([F, 0.25 * F], -1), resume=True)


def test_snapshot_leaves_and_fingerprint_match_jax(models, tmp_path):
    """Both packages killed at the first boundary leave a many_000001.npz:
    equal fingerprints, the same totals and per-column counts, and the
    same carry, the port's (R, P, n_loc) leaves against JAX's (P, n_loc,
    R) ones after a moveaxis."""
    jm, tm = models
    fb = _block(jm)
    jcfg, _ = _cfgs(tmp_path, snap=1, run_id="jax")
    _, tcfg = _cfgs(tmp_path, snap=1, run_id="port")
    with pytest.raises(JaxSimulatedKill):
        _jax(jm, jcfg, "kill@0").solve_many(fb)
    ts = _port(tm, tcfg, "kill@0")
    with pytest.raises(SimulatedKill):
        ts.solve_many(fb)
    h = array_hash(fb)
    assert h == jax_array_hash(fb)
    js = _jax(jm, jcfg)
    assert SnapshotStore.for_many_solver(ts, 2, rhs_hash=h).fingerprint \
        == JaxSnapshotStore.for_many_solver(js, 2, rhs_hash=h).fingerprint
    jst = JaxSnapshotStore.for_many_solver(js, 2, rhs_hash=h).load(1)
    tst = SnapshotStore.for_many_solver(ts, 2, rhs_hash=h).load(1)
    assert str(tst["kind"]) == str(jst["kind"]) == "many"
    assert int(tst["total"]) == int(jst["total"])
    np.testing.assert_array_equal(tst["iters_cols"], jst["iters_cols"])
    jc, tc = jst["carry"], tst["carry"]
    assert set(tc) == set(jc)
    for k in jc:
        a, b = np.asarray(tc[k]), np.asarray(jc[k])
        if b.ndim == 3:
            b = np.moveaxis(b, -1, 0)
        assert a.shape == b.shape, k
        if np.issubdtype(b.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(
                a, b, rtol=0, atol=1e-10 * float(np.abs(b).max()),
                err_msg=k)


def test_many_snapshot_retention_and_latest(models, tmp_path, monkeypatch):
    monkeypatch.setenv("PCG_TPU_SNAP_KEEP", "2")
    _, tm = models
    s = _port(tm, _cfgs(tmp_path, snap=1)[1])
    store = SnapshotStore.for_many_solver(s, 2, rhs_hash="h")
    other = SnapshotStore.for_solver(s)
    other.save(7, {"kind": "direct", "total": np.int64(1)})
    for t in (1, 2, 3, 4):
        store.save(t, {"kind": "many", "total": np.int64(t)})
    files = sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(store.path, "many_*.npz")))
    assert files == ["many_000003.npz", "many_000004.npz"]
    assert glob.glob(os.path.join(store.path, "snap_*.npz"))
    assert store.latest() == 4
    with open(store._file(4), "wb") as f:
        f.write(b"torn")
    assert store.latest() == 3
    with pytest.warns(UserWarning, match="unreadable"):
        assert store.load(4) is None


def test_many_snapshot_fingerprint_tracks_fallback_wiring(models,
                                                          tmp_path):
    _, tm = models
    s = _port(tm, _cfgs(tmp_path, precond="block3")[1])
    fp_on = SnapshotStore.for_many_solver(s, 2, rhs_hash="h").fingerprint
    assert fp_on["many_fallback"] is True
    s.config.solver.max_recoveries = 0
    fp_off = SnapshotStore.for_many_solver(s, 2, rhs_hash="h").fingerprint
    assert fp_off["many_fallback"] is False
    SnapshotStore(s.config.checkpoint_path, fp_on, prefix="many").save(
        1, {"kind": "many", "total": np.int64(0)})
    with pytest.raises(ValueError, match="many_fallback"):
        SnapshotStore(s.config.checkpoint_path, fp_off,
                      prefix="many").load(1)
    # a record older than the field reads as written without the fallback
    legacy = {k: v for k, v in fp_off.items() if k != "many_fallback"}
    SnapshotStore(s.config.checkpoint_path, legacy, prefix="many").save(
        2, {"kind": "many", "total": np.int64(0)})
    assert SnapshotStore(s.config.checkpoint_path, fp_off,
                         prefix="many").load(2)["kind"] == "many"


def test_one_shot_retry_guard_and_unlandable_column_fault(models,
                                                          tmp_path):
    """JAX ``tests/test_pcg_many.py:385-409``: the one-shot blocked solve
    (ipd=0) retries an injected device loss, and a column fault, which
    needs a chunk boundary, stays pending and unfired."""
    _, tm = models
    cap = _Capture()
    s = _port(tm, _cfgs(tmp_path, ipd=0)[1], "exc@0", cap)
    F = np.asarray(tm.F)
    fb = np.stack([F, 0.5 * F], axis=-1)
    res = s.solve_many(fb)
    assert list(res.flags) == [0, 0]
    assert [e["action"] for e in cap.events if e["kind"] == "recovery"] \
        == ["redispatch"]
    assert [f["mode"] for f in s.fault_plan.fired] == ["exc"]
    s.fault_plan = FaultPlan("nan@col:1", recorder=s.recorder)
    res = s.solve_many(fb)
    assert list(res.flags) == [0, 0] and res.quarantined == ()
    assert s.fault_plan.fired == [] and s.fault_plan.col_armed


def test_one_shot_notes_snapshot_and_resume_requests(models, tmp_path):
    """Mixed precision stays one-shot (as in JAX): a snapshot cadence or
    a resume is noted, not refused, and the block solves."""
    _, tm = models
    cap = _Capture()
    s = _port(tm, _cfgs(tmp_path, snap=2, precision_mode="mixed",
                        tol=1e-9)[1], cap=cap)
    r = s.solve_many(np.asarray(tm.F), resume=True)
    assert list(r.flags) == [0]
    notes = [e["msg"] for e in cap.events if e["kind"] == "note"]
    assert any("runs as ONE dispatch" in n for n in notes)
    assert not glob.glob(os.path.join(s.config.checkpoint_path, "*.npz"))

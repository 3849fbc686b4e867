"""Time-history resilience of the port on the CPU (``device="cpu"``):
``TimeHistoryGuard``, ``kinematic_state_io``, ``SnapshotStore.
for_time_solver`` (``step_*.npz``), the step fault domain (``mode@s:N``)
and the per-step recovery ladder of ``NewmarkSolver``, after
``tests/test_time_resilience.py``.

Every resume and rollback is held BIT for bit to the port's own
uninterrupted run; the ladder's events to the JAX package's on the same
faults; the time solvers' checkpoint fingerprint to the JAX package's,
and a ``step_*.npz`` written by the JAX package resumes in the port
(solution within 1e-9 * max|u| of JAX's uninterrupted run).
"""

import glob
import os

import numpy as np
import pytest
import torch

from pcg_mpi_solver_tpu.config import RunConfig as JaxRunConfig
from pcg_mpi_solver_tpu.config import SolverConfig as JaxSolverConfig
from pcg_mpi_solver_tpu.models.synthetic import make_cube_model as jax_cube
from pcg_mpi_solver_tpu.obs.metrics import MetricsRecorder as JaxRecorder
from pcg_mpi_solver_tpu.parallel.mesh import make_mesh
from pcg_mpi_solver_tpu.resilience import FaultPlan as JaxFaultPlan
from pcg_mpi_solver_tpu.resilience import SimulatedKill as JaxKill
from pcg_mpi_solver_tpu.solver.dynamics import DynamicsSolver as JaxDynamics
from pcg_mpi_solver_tpu.solver.newmark import NewmarkSolver as JaxNewmark
from pcg_mpi_solver_tpu.utils.checkpoint import _fingerprint as jax_fp
from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig
from pcg_mpi_solver_tpu_torch.models import make_cube_model
from pcg_mpi_solver_tpu_torch.obs.metrics import MetricsRecorder
from pcg_mpi_solver_tpu_torch.resilience import (
    FaultPlan, SimulatedKill, TimeHistoryGuard, kinematic_state_io)
from pcg_mpi_solver_tpu_torch.solver import (
    DynamicsSolver, NewmarkSolver, stable_dt)
from pcg_mpi_solver_tpu_torch.utils.checkpoint import (
    SnapshotStore, _fingerprint)

DELTAS = [0.5, 1.0, 1.0, 0.7, 0.3]
NM_CUBE = ((4, 3, 3), dict(heterogeneous=True))
DYN_CUBE = ((4, 3, 3), dict(E=100.0, nu=0.25, rho=1.0, load="traction",
                            load_value=1.0, heterogeneous=True))


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
    for k in ("PCG_TPU_FAULTS", "PCG_TPU_SNAP_KEEP"):
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(scope="module")
def model():
    args, kw = NM_CUBE
    return make_cube_model(*args, **kw)


@pytest.fixture(scope="module")
def dyn_model():
    args, kw = DYN_CUBE
    return make_cube_model(*args, **kw)


def _ncfg(tmp_path, run_id, ipd=0, snap=0, **kw):
    kw.setdefault("tol", 1e-10)
    cfg = RunConfig(scratch_path=str(tmp_path), run_id=run_id,
                    solver=SolverConfig(max_iter=2000,
                                        iters_per_dispatch=ipd, **kw))
    cfg.snapshot_every = snap
    return cfg


def _newmark(model, cfg, recorder=None):
    return NewmarkSolver(model, cfg, n_parts=2, dt=0.2, device="cpu",
                         recorder=recorder)


def _dcfg(tmp_path, run_id, snap=0):
    cfg = RunConfig(scratch_path=str(tmp_path), run_id=run_id)
    cfg.snapshot_every = snap
    return cfg


def _dynamics(dyn_model, cfg, probes=(6, 13), n_parts=4, recorder=None):
    return DynamicsSolver(dyn_model, cfg, n_parts=n_parts,
                          dt=stable_dt(dyn_model, safety=0.5), damping=0.05,
                          probe_dofs=probes, device="cpu",
                          recorder=recorder)


# ----------------------------------------------------------------------
# The step fault domain, the state transfers, the step store
# ----------------------------------------------------------------------

def test_step_domain_parse_and_fire():
    p = FaultPlan("kill@s:3, nan@s:5, exc@2")
    assert p.armed and p.step_armed
    assert p.next_step_fault(0) == 3
    assert p.next_step_fault(3) == 5
    assert p.next_step_fault(5) is None
    state = {"u": torch.tensor([1.0, 2.0]), "v": torch.tensor([0.0, 1.0])}
    assert torch.isfinite(p.at_step(1, dict(state))["u"]).all()
    out = p.at_step(5, dict(state))
    assert torch.isnan(out["u"]).all()
    assert out["v"] is state["v"] and torch.isfinite(state["u"]).all()
    with pytest.raises(SimulatedKill):
        p.at_step(3, dict(state))
    # absolute indexing: a consumed step fault never fires again
    assert torch.isfinite(p.at_step(5, dict(state))["u"]).all()
    assert not p.step_armed and p.armed        # exc@2 still pending
    inf = FaultPlan("inf@s:1").at_step(1, {"u": torch.tensor([0.0, 3.0])})
    assert inf["u"].tolist() == [0.0, float("inf")]
    with pytest.raises(ValueError, match="step-domain"):
        FaultPlan("exc@s:1")
    with pytest.raises(ValueError, match="bad fault term"):
        FaultPlan("kill@s:")


def test_kinematic_state_io_is_bitwise():
    fetch, put = kinematic_state_io(torch.device("cpu"), torch.float32,
                                    ("u",))
    u = torch.randn(2, 5, dtype=torch.float32)
    host = fetch({"u": u, "t": 3, "hist": [1.5]})
    assert isinstance(host["u"], np.ndarray) and host["t"] == 3
    back = put(dict(host, u=host["u"].astype(np.float64)))
    assert back["u"].dtype == torch.float32 and torch.equal(back["u"], u)
    assert back["hist"].tolist() == [1.5]


def test_guard_rollback_needs_a_snapshot():
    g = TimeHistoryGuard(max_recoveries=2)
    with pytest.raises(FloatingPointError, match="snapshot=no"):
        g.rollback(3)
    g = TimeHistoryGuard(snapshot_every=2, max_recoveries=1)
    assert g.boundary(1, lambda: {"u": 1}) is None
    g.boundary(2, lambda: {"u": np.ones(2)})
    assert g.rollback(3)[0] == 2
    with pytest.raises(FloatingPointError, match="recoveries=1/1"):
        g.rollback(3)


def test_step_store_retention(tmp_path, monkeypatch):
    store = SnapshotStore(str(tmp_path), {"v": 1}, prefix="step")
    for t in range(1, 7):
        store.save(t, {"u": np.full(3, float(t))})
    files = sorted(os.path.basename(p) for p in
                   glob.glob(str(tmp_path / "step_*.npz")))
    assert files == ["step_000005.npz", "step_000006.npz"]   # default 2
    assert store.latest() == 6
    monkeypatch.setenv("PCG_TPU_SNAP_KEEP", "4")
    for t in range(7, 10):
        store.save(t, {"u": np.full(3, float(t))})
    assert len(glob.glob(str(tmp_path / "step_*.npz"))) == 4
    # the two prefixes never cross
    assert SnapshotStore(str(tmp_path), None).latest() is None


# ----------------------------------------------------------------------
# Newmark
# ----------------------------------------------------------------------

@pytest.mark.parametrize("ipd", [0, 7])
def test_newmark_kill_and_resume_bit_identity(tmp_path, model, ipd):
    """``kill@s:2`` at snapshot_every=1, resumed in a new solver: the
    histories and the state bitwise the uninterrupted run's."""
    ref = _newmark(model, _ncfg(tmp_path, f"ref{ipd}", ipd=ipd))
    ref.run(DELTAS)
    kcfg = _ncfg(tmp_path, f"kill{ipd}", ipd=ipd, snap=1)
    k1 = _newmark(model, kcfg)
    k1.fault_plan = FaultPlan("kill@s:2")
    with pytest.raises(SimulatedKill):
        k1.run(DELTAS)
    snaps = sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(kcfg.checkpoint_path, "step_*.npz")))
    assert snaps == ["step_000001.npz", "step_000002.npz"]
    cap = _Capture()
    k2 = _newmark(model, kcfg, MetricsRecorder(sinks=[cap]))
    res = k2.run(DELTAS, resume=True)
    assert len(res) == 3                    # steps 3..5 only
    assert k2.flags == ref.flags and k2.iters == ref.iters
    assert k2.relres == ref.relres
    for a, b in zip(k2.state_global(), ref.state_global()):
        np.testing.assert_array_equal(a, b)
    assert [e["op"] for e in cap.events
            if e["kind"] == "step_snapshot"][0] == "restore"
    # retention keeps the newest two
    snaps = sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(kcfg.checkpoint_path, "step_*.npz")))
    assert snaps == ["step_000004.npz", "step_000005.npz"]


def test_newmark_resume_schedule_mismatch(tmp_path, model):
    cfg = _ncfg(tmp_path, "sched", snap=1)
    s = _newmark(model, cfg)
    s.fault_plan = FaultPlan("kill@s:2")
    with pytest.raises(SimulatedKill):
        s.run(DELTAS)
    with pytest.raises(ValueError, match="schedule mismatch"):
        _newmark(model, cfg).run([9.0] * 5, resume=True)


def test_newmark_resume_refuses_other_numerics(tmp_path, model):
    cfg = _ncfg(tmp_path, "fp", snap=1)
    s = _newmark(model, cfg)
    s.fault_plan = FaultPlan("kill@s:2")
    with pytest.raises(SimulatedKill):
        s.run(DELTAS)
    other = _ncfg(tmp_path, "fp", snap=1, tol=1e-9)
    with pytest.raises(ValueError, match="tol"):
        _newmark(model, other).run(DELTAS, resume=True)


def test_newmark_nan_rollback(tmp_path, model):
    """``nan@s:3`` poisons u after step 3; step 4 finds it, rolls back to
    the step-3 snapshot and runs again: bitwise the clean run."""
    ref = _newmark(model, _ncfg(tmp_path, "c0"))
    ref.run(DELTAS)
    cap = _Capture()
    s = _newmark(model, _ncfg(tmp_path, "c1", snap=1),
                 MetricsRecorder(sinks=[cap]))
    s.fault_plan = FaultPlan("nan@s:3", recorder=s.recorder)
    res = s.run(DELTAS)
    assert len(res) == 5 and all(r.flag == 0 for r in res)
    assert s.flags == ref.flags and s.iters == ref.iters
    for a, b in zip(s.state_global(), ref.state_global()):
        np.testing.assert_array_equal(a, b)
    rolls = [e for e in cap.events if e["kind"] == "recovery"
             and e["action"] == "rollback"]
    assert len(rolls) == 1 and rolls[0]["trigger"] == "nan_carry"
    assert (rolls[0]["step"], rolls[0]["to_step"]) == (4, 3)


def test_newmark_rollback_budget_exhausts(tmp_path, model):
    s = _newmark(model, _ncfg(tmp_path, "bud", snap=1, max_recoveries=2))
    s.fault_plan = FaultPlan("nan@s:1,nan@s:2,nan@s:3")
    with pytest.raises(FloatingPointError, match="non-finite"):
        s.run(DELTAS)


def test_newmark_unguarded_nonfinite_raises(tmp_path, model):
    """Without a snapshot there is nothing to roll back to: the poison
    of step 2 ends the run at step 3, loudly."""
    s = _newmark(model, _ncfg(tmp_path, "ung"))
    s.fault_plan = FaultPlan("nan@s:2")
    with pytest.raises(FloatingPointError,
                       match="after timestep 3.*snapshot=no"):
        s.run(DELTAS)
    assert len(s.flags) == 3 and not np.isfinite(s.relres[-1])


@pytest.mark.parametrize("case", ["restart", "fallback"])
def test_newmark_ladder_matches_jax(tmp_path, model, case):
    """A rho0 breakdown inside a chunked step recovers through the ladder
    on A: restart_minres (jacobi, ``rho0@1``), then the fallback
    preconditioner of A (block3, ``rho0@1,rho0@2`` at cap 3, tol 1e-13),
    with JAX's recovery events and iterations."""
    spec, kw = {"restart": ("rho0@1", dict(ipd=7)),
                "fallback": ("rho0@1,rho0@2",
                             dict(ipd=3, precond="block3",
                                  tol=1e-13))}[case]
    jcap = _Capture()
    args, mkw = NM_CUBE
    ipd = kw.pop("ipd")
    jcfg = JaxRunConfig(scratch_path=str(tmp_path), run_id="j",
                        solver=JaxSolverConfig(
                            max_iter=2000, iters_per_dispatch=ipd,
                            **{"tol": 1e-10, **kw}))
    j = JaxNewmark(jax_cube(*args, **mkw), jcfg, mesh=make_mesh(2),
                   n_parts=2, dt=0.2, recorder=JaxRecorder(sinks=[jcap]))
    j.fault_plan = JaxFaultPlan(spec, recorder=j.recorder)
    jres = j.run(DELTAS)
    cap = _Capture()
    s = _newmark(model, _ncfg(tmp_path, case, ipd=ipd, **kw),
                 MetricsRecorder(sinks=[cap]))
    s.fault_plan = FaultPlan(spec, recorder=s.recorder)
    res = s.run(DELTAS)
    assert all(r.flag == 0 for r in res + jres)

    def recs(events):
        return [(e["action"], e["trigger"], e["attempt"]) for e in events
                if e["kind"] == "recovery"]

    assert recs(cap.events) == recs(jcap.events) != []
    assert all(abs(a.iters - b.iters) <= 1 for a, b in zip(res, jres))


def test_time_fingerprints_match_jax(tmp_path, model, dyn_model):
    args, kw = NM_CUBE
    cfg = _ncfg(tmp_path, "f")
    jcfg = JaxRunConfig(scratch_path=str(tmp_path), run_id="f",
                        solver=JaxSolverConfig(max_iter=2000, tol=1e-10,
                                               iters_per_dispatch=0))
    j = JaxNewmark(jax_cube(*args, **kw), jcfg, mesh=make_mesh(2),
                   n_parts=2, dt=0.2)
    assert _fingerprint(_newmark(model, cfg)) == jax_fp(j)
    dargs, dkw = DYN_CUBE
    jd = JaxDynamics(jax_cube(*dargs, **dkw), JaxRunConfig(),
                     mesh=make_mesh(4), n_parts=4,
                     dt=stable_dt(dyn_model, safety=0.5))
    assert _fingerprint(_dynamics(dyn_model, RunConfig())) == jax_fp(jd)


def test_newmark_resumes_a_jax_step_snapshot(tmp_path, model):
    """A ``step_*.npz`` the JAX package wrote (``kill@s:2``) resumes in
    the port: steps 3..5 to flag 0, u within 1e-9 * max|u| of JAX's
    uninterrupted run."""
    args, kw = NM_CUBE

    def jcfg(run_id, snap):
        c = JaxRunConfig(scratch_path=str(tmp_path), run_id=run_id,
                         solver=JaxSolverConfig(max_iter=2000, tol=1e-10,
                                                iters_per_dispatch=0))
        c.snapshot_every = snap
        return c

    jm = jax_cube(*args, **kw)
    ref = JaxNewmark(jm, jcfg("ref", 0), mesh=make_mesh(2), n_parts=2,
                     dt=0.2)
    ref.run(DELTAS)
    jk = JaxNewmark(jm, jcfg("k", 1), mesh=make_mesh(2), n_parts=2, dt=0.2)
    jk.fault_plan = JaxFaultPlan("kill@s:2")
    with pytest.raises(JaxKill):
        jk.run(DELTAS)
    s = _newmark(model, _ncfg(tmp_path, "k", snap=1))
    res = s.run(DELTAS, resume=True)
    assert len(res) == 3 and all(r.flag == 0 for r in res)
    assert s.iters[:2] == [int(v) for v in jk.iters]
    u_ref = ref.displacement_global()
    np.testing.assert_allclose(s.displacement_global(), u_ref, rtol=0,
                               atol=1e-9 * np.abs(u_ref).max())


# ----------------------------------------------------------------------
# Explicit dynamics
# ----------------------------------------------------------------------

def test_dynamics_kill_and_resume_bit_identity(tmp_path, dyn_model):
    ref = _dynamics(dyn_model, _dcfg(tmp_path, "r")).run(25, export_every=5)
    kcfg = _dcfg(tmp_path, "k", snap=4)
    d1 = _dynamics(dyn_model, kcfg)
    d1.fault_plan = FaultPlan("kill@s:12")
    with pytest.raises(SimulatedKill):
        d1.run(25, export_every=5)
    snaps = sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(kcfg.checkpoint_path, "step_*.npz")))
    assert snaps == ["step_000008.npz", "step_000012.npz"]
    res = _dynamics(dyn_model, kcfg).run(25, export_every=5, resume=True)
    np.testing.assert_array_equal(res.probe_u, ref.probe_u)
    np.testing.assert_array_equal(res.u, ref.u)
    assert res.frame_times == ref.frame_times
    for a, b in zip(res.frames, ref.frames):
        np.testing.assert_array_equal(a, b)


def test_dynamics_nan_rollback_bit_identity(tmp_path, dyn_model):
    ref = _dynamics(dyn_model, _dcfg(tmp_path, "r2"),
                    probes=(6,)).run(25, export_every=5)
    cap = _Capture()
    d = _dynamics(dyn_model, _dcfg(tmp_path, "n2", snap=5), probes=(6,),
                  recorder=MetricsRecorder(sinks=[cap]))
    d.fault_plan = FaultPlan("nan@s:10", recorder=d.recorder)
    res = d.run(25, export_every=5)
    np.testing.assert_array_equal(res.probe_u, ref.probe_u)
    np.testing.assert_array_equal(res.u, ref.u)
    for a, b in zip(res.frames, ref.frames):
        np.testing.assert_array_equal(a, b)
    rolls = [e for e in cap.events if e["kind"] == "recovery"]
    assert [e["action"] for e in rolls] == ["rollback"]
    # the poison after step 10 shows at the end of the chunk 11..15,
    # which rolls back to the step-10 snapshot
    assert (rolls[0]["step"], rolls[0]["to_step"]) == (15, 10)


def test_dynamics_unguarded_nonfinite_raises(dyn_model):
    d = _dynamics(dyn_model, RunConfig(), n_parts=1)
    d.fault_plan = FaultPlan("nan@s:3")
    with pytest.raises(FloatingPointError, match="non-finite"):
        d.run(10)

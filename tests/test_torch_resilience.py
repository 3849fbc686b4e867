"""The port's resilience subsystem against the JAX package's (CPU).

Fault injection drives every recovery path of the chunked solve in both
packages on the same small cube (``iters_per_dispatch=12``): the ladder
must take the same (action, trigger) rungs, end at the same flag, and
count iterations within the windows of the ground rules (direct f64:
+-1, where reduction order alone moves a deferred check across tol;
mixed: max(3, 5 %)).  The guards are the port's own: a healthy solve is
bit for bit the same with the ladder armed or not, kill-and-resume is
bitwise, a snapshot is resumed only when asked, and a snapshot the JAX
package wrote resumes in the port.  Unit tests hold the fault grammar,
the device-loss classification, the ladder, the dispatch guard and the
stores to the JAX package's."""

import os

import numpy as np
import pytest
import torch

from pcg_mpi_solver_tpu.config import RunConfig as JaxRunConfig
from pcg_mpi_solver_tpu.config import SolverConfig as JaxSolverConfig
from pcg_mpi_solver_tpu.config import (
    TimeHistoryConfig as JaxTimeHistoryConfig)
from pcg_mpi_solver_tpu.models.synthetic import make_cube_model as jax_cube
from pcg_mpi_solver_tpu.obs.metrics import MetricsRecorder as JaxRecorder
from pcg_mpi_solver_tpu.parallel.mesh import make_mesh
from pcg_mpi_solver_tpu.resilience import FaultPlan as JaxFaultPlan
from pcg_mpi_solver_tpu.resilience import SimulatedKill as JaxSimulatedKill
from pcg_mpi_solver_tpu.resilience import faultinject as jax_faultinject
from pcg_mpi_solver_tpu.resilience import recovery as jax_recovery
from pcg_mpi_solver_tpu.solver.driver import Solver as JaxSolver
from pcg_mpi_solver_tpu.utils.checkpoint import _fingerprint as jax_fingerprint
from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig, TimeHistoryConfig
from pcg_mpi_solver_tpu_torch.models import make_cube_model
from pcg_mpi_solver_tpu_torch.obs.metrics import MetricsRecorder
from pcg_mpi_solver_tpu_torch.resilience import (
    DispatchGuard, FaultPlan, InjectedDispatchError, RecoveryLadder,
    SimulatedKill, breakdown_trigger, column_trigger, is_device_loss,
    retry_deadline_s)
from pcg_mpi_solver_tpu_torch.resilience import faultinject
from pcg_mpi_solver_tpu_torch.solver import Solver
from pcg_mpi_solver_tpu_torch.utils.checkpoint import (
    CheckpointManager, SnapshotStore, _fingerprint)

DIMS = (5, 4, 4)
MG_DIMS = (8, 4, 4)
MG_KW = dict(h=0.5, nu=0.3, seed=0)


class _Capture:
    """Metrics sink collecting events for assertions."""

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
    return {"cube": (jax_cube(*DIMS, heterogeneous=True),
                     make_cube_model(*DIMS, heterogeneous=True)),
            "mg": (jax_cube(*MG_DIMS, heterogeneous=True, **MG_KW),
                   make_cube_model(*MG_DIMS, heterogeneous=True, **MG_KW))}


def _configs(tmp_path, snapshot_every=0, checkpoint_every=0, run_id="1",
             deltas=(0.0, 1.0), **solver_kw):
    """(JAX RunConfig, port RunConfig) of one case."""
    solver_kw.setdefault("tol", 1e-8)
    solver_kw.setdefault("max_iter", 2000)
    solver_kw.setdefault("iters_per_dispatch", 12)
    out = []
    for rc, sc, th in ((JaxRunConfig, JaxSolverConfig, JaxTimeHistoryConfig),
                       (RunConfig, SolverConfig, TimeHistoryConfig)):
        cfg = rc(scratch_path=str(tmp_path), run_id=run_id,
                 solver=sc(**solver_kw),
                 time_history=th(time_step_delta=list(deltas)))
        cfg.snapshot_every = snapshot_every
        cfg.checkpoint_every = checkpoint_every
        out.append(cfg)
    return out


def _port(model, cfg, fault=None, cap=None):
    s = Solver(model, cfg, device="cpu",
               recorder=MetricsRecorder(sinks=[cap] if cap else []))
    if fault is not None:
        s.fault_plan = FaultPlan(fault, recorder=s.recorder)
    return s


def _jax(model, cfg, fault=None, cap=None):
    s = JaxSolver(model, cfg, mesh=make_mesh(1), n_parts=1,
                  recorder=JaxRecorder(sinks=[cap] if cap else []))
    if fault is not None:
        s.fault_plan = JaxFaultPlan(fault, recorder=s.recorder)
    return s


def _recoveries(cap):
    return [(e["action"], e["trigger"]) for e in cap.events
            if e["kind"] == "recovery"]


MIXED = dict(precision_mode="mixed", dtype="float32", tol=1e-9,
             max_iter=4000, inner_tol=0.1)

# (id, model, fault plan, snapshot_every, solver options, expected rungs)
LADDER = [
    ("nan1", "cube", "nan@1", 0, {}, [("restart_minres", "nan_carry")]),
    ("exc2", "cube", "exc@2", 0, {}, [("restart_minres", "device_loss")]),
    ("exc3_snap", "cube", "exc@3", 1, {}, [("redispatch", "device_loss")]),
    ("rho0_x6", "cube", ",".join(f"rho0@{i}" for i in range(1, 7)), 0,
     dict(max_recoveries=2),
     [("restart_minres", "flag4"), ("restart_minres", "flag4")]),
    ("rho0_report", "cube", "rho0@1", 0, dict(max_recoveries=0), []),
    ("block3", "cube", "rho0@1,rho0@2", 0, dict(precond="block3"),
     [("restart_minres", "flag4"), ("fallback_prec", "flag4")]),
    ("mixed_inf", "cube", "inf@0,inf@1", 0, dict(MIXED, max_recoveries=3),
     [("restart_minres", "nan_carry"), ("escalate_f64", "nan_carry")]),
    ("mg_fb", "mg", "rho0@1,rho0@2", 0,
     dict(precond="mg", iters_per_dispatch=5),
     [("restart_minres", "flag4"), ("fallback_prec", "flag4")]),
]


@pytest.mark.parametrize("name,model,fault,snap,kw,rungs", LADDER,
                         ids=[c[0] for c in LADDER])
def test_ladder_matches_jax(models, tmp_path, name, model, fault, snap, kw,
                            rungs):
    jm, tm = models[model]
    jcfg, tcfg = _configs(tmp_path, snapshot_every=snap, **kw)
    caps = _Capture(), _Capture()
    rj = _jax(jm, jcfg, fault, caps[0]).step(1.0)
    rt = _port(tm, tcfg, fault, caps[1]).step(1.0)
    assert _recoveries(caps[1]) == _recoveries(caps[0]) == rungs
    assert rt.flag == rj.flag
    window = max(3, 0.05 * rj.iters) if "precision_mode" in kw else 1
    assert abs(rt.iters - rj.iters) <= window, (rt, rj)
    if rj.flag == 0:
        assert rt.relres <= kw.get("tol", 1e-8)
    done = [e for e in caps[1].events if e["kind"] == "recovery_done"]
    assert len(done) == (1 if rungs and rungs[0][0] != "redispatch" else 0)


def test_redispatch_replays_the_clean_solve(models, tmp_path):
    """A device loss re-dispatched from the chunk-boundary snapshot
    replays the lost chunk exactly: iterations, relres and x are bitwise
    those of the clean solve."""
    _, tm = models["cube"]
    _, cfg = _configs(tmp_path, snapshot_every=1)
    cap = _Capture()
    s = _port(tm, cfg, "exc@3", cap)
    r = s.step(1.0)
    ref = _port(tm, _configs(tmp_path)[1])
    r_ref = ref.step(1.0)
    assert _recoveries(cap) == [("redispatch", "device_loss")]
    assert (r.flag, r.iters, r.relres) == (r_ref.flag, r_ref.iters,
                                           r_ref.relres)
    np.testing.assert_array_equal(s.displacement_global(),
                                  ref.displacement_global())


@pytest.mark.parametrize("mode", ["direct", "mixed"])
def test_healthy_solve_is_untouched_by_the_ladder(models, tmp_path, mode):
    """With the ladder armed and no faults, a chunked solve runs the
    same dispatches and gives bitwise the results of max_recoveries=0."""
    _, tm = models["cube"]
    kw = MIXED if mode == "mixed" else {}
    out = []
    for mr in (2, 0):
        s = _port(tm, _configs(tmp_path, max_recoveries=mr, **kw)[1])
        r = s.step(1.0)
        out.append((r.flag, r.iters, r.relres, s.displacement_global(),
                    list(s.dispatch_log)))
    assert out[0][0] == 0
    assert out[0][:3] == out[1][:3] and out[0][4] == out[1][4]
    np.testing.assert_array_equal(out[0][3], out[1][3])


@pytest.mark.parametrize("mode", ["direct", "mixed"])
def test_kill_and_resume_is_bitwise(models, tmp_path, mode):
    """A two-step chunked solve killed at a chunk boundary of step 2 and
    resumed in a new Solver reproduces the uninterrupted run bit for bit
    (step checkpoints carry step 1, the mid-step snapshot step 2), and
    the completed steps leave no snapshot behind."""
    _, tm = models["cube"]
    kw = MIXED if mode == "mixed" else {}

    def cfg(run_id):
        return _configs(tmp_path, snapshot_every=1, checkpoint_every=1,
                        run_id=run_id, deltas=(0.0, 0.5, 1.0), **kw)[1]

    # the uninterrupted run, counting the chunk boundaries of step 1
    sa = _port(tm, cfg("a"))
    sa.fault_plan = FaultPlan("")
    seen = {}
    sa.solve(on_step=lambda t, r: seen.setdefault(t, sa.fault_plan.boundaries))
    cb = cfg("b")
    # die at the second chunk boundary of step 2
    sk = _port(tm, cb, fault=f"kill@{seen[1] + 1}")
    with pytest.raises(SimulatedKill):
        sk.solve()
    snaps = [f for f in os.listdir(cb.checkpoint_path)
             if f.startswith("snap_")]
    assert snaps == ["snap_000002.npz"]
    cap = _Capture()
    sr = _port(tm, cb, cap=cap)
    ran = []
    sr.solve(resume=True, on_step=lambda t, r: ran.append(t))
    assert sr.flags == sa.flags and sr.iters == sa.iters
    assert sr.relres == sa.relres
    np.testing.assert_array_equal(sr.displacement_global(),
                                  sa.displacement_global())
    assert ran == [2]
    assert [e["op"] for e in cap.events if e["kind"] == "snapshot"
            ][:1] == ["restore"]
    assert not [f for f in os.listdir(cb.checkpoint_path)
                if f.startswith("snap_")]


def test_snapshot_resumes_only_when_asked(models, tmp_path):
    """A fresh solve never consumes a stale snapshot: without
    resume=True the persisted mid-step state is ignored, then discarded
    when the step completes."""
    _, tm = models["cube"]
    _, cfg = _configs(tmp_path, snapshot_every=1)
    with pytest.raises(SimulatedKill):
        _port(tm, cfg, "kill@1").solve()
    assert os.listdir(cfg.checkpoint_path) == ["snap_000001.npz"]
    cap = _Capture()
    s = _port(tm, cfg, cap=cap)
    r = s.solve()[0]
    ref = _port(tm, _configs(tmp_path)[1]).step(1.0)
    assert (r.flag, r.iters, r.relres) == (ref.flag, ref.iters, ref.relres)
    ops = [e["op"] for e in cap.events if e["kind"] == "snapshot"]
    assert ops and "restore" not in ops
    assert os.listdir(cfg.checkpoint_path) == []


def test_jax_snapshot_resumes_in_the_port(models, tmp_path):
    """A mid-step snap_*.npz the JAX Solver wrote under kill@1 (direct
    f64, structured, jacobi, classic) resumes in the port with
    solve(resume=True): the port's fingerprint equals the JAX package's,
    and the resumed solve ends at JAX's uninterrupted flag and
    iterations with x within 1e-10 max|x|."""
    jm, tm = models["cube"]
    jcfg, tcfg = _configs(tmp_path, snapshot_every=1)
    ref = _jax(jm, _configs(tmp_path, run_id="ref")[0])
    r_ref = ref.step(1.0)
    sj = _jax(jm, jcfg, "kill@1")
    with pytest.raises(JaxSimulatedKill):
        sj.solve()
    assert os.listdir(tcfg.checkpoint_path) == ["snap_000001.npz"]
    st = _port(tm, tcfg)
    assert _fingerprint(st) == jax_fingerprint(sj)
    cap = _Capture()
    st.recorder.sinks.append(cap)
    r = st.solve(resume=True)[0]
    assert [e["op"] for e in cap.events if e["kind"] == "snapshot"
            ][:1] == ["restore"]
    assert (r.flag, r.iters) == (r_ref.flag, r_ref.iters)
    uj = ref.displacement_global()
    np.testing.assert_allclose(st.displacement_global(), uj, rtol=0,
                               atol=1e-10 * np.abs(uj).max())


def test_fingerprint_mismatch_raises(models, tmp_path):
    _, tm = models["cube"]
    _, cfg = _configs(tmp_path, snapshot_every=1)
    with pytest.raises(SimulatedKill):
        _port(tm, cfg, "kill@1").solve()
    _, other = _configs(tmp_path, snapshot_every=1, tol=1e-9)
    with pytest.raises(ValueError, match="mismatch.*tol"):
        _port(tm, other).solve(resume=True)
    # step checkpoints: the same guard
    _, c2 = _configs(tmp_path, checkpoint_every=1, run_id="ck",
                     deltas=(0.0, 1.0))
    _port(tm, c2).solve()
    _, c3 = _configs(tmp_path, checkpoint_every=1, run_id="ck",
                     deltas=(0.0, 0.5))
    with pytest.raises(ValueError, match="checkpoint/solver mismatch"):
        _port(tm, c3).solve(resume=True)


def test_corrupt_checkpoint_falls_back_to_newest_valid(models, tmp_path):
    _, tm = models["cube"]
    _, cfg = _configs(tmp_path, checkpoint_every=1,
                      deltas=(0.0, 0.25, 0.5, 1.0))
    s = _port(tm, cfg)
    s.solve()
    mgr = CheckpointManager(cfg.checkpoint_path)
    assert mgr.latest_step() == 3
    latest = os.path.join(cfg.checkpoint_path, "ckpt_000003.npz")
    blob = open(latest, "rb").read()
    with open(latest, "wb") as f:
        f.write(blob[: len(blob) // 3])
    with pytest.warns(UserWarning, match="falling back"):
        assert mgr.latest_step() == 2
    s2 = _port(tm, cfg)
    ran = []
    with pytest.warns(UserWarning, match="falling back"):
        s2.solve(resume=True, on_step=lambda t, r: ran.append(t))
    assert ran == [3] and s2.flags == s.flags and s2.iters == s.iters
    np.testing.assert_array_equal(s2.displacement_global(),
                                  s.displacement_global())
    for f in os.listdir(cfg.checkpoint_path):
        os.remove(os.path.join(cfg.checkpoint_path, f))
    assert mgr.latest_step() is None


def test_snapshot_store_roundtrip_and_guards(tmp_path):
    fp = {"model_hash": "abc", "tol": 1e-8}
    store = SnapshotStore(str(tmp_path), fp)
    state = {"kind": "direct", "chunk": 3, "total": 36,
             "carry": {"x": np.arange(6.0).reshape(1, 6),
                       "rho": np.float32(2.5)}}
    store.save(1, state)
    got = SnapshotStore(str(tmp_path), fp).load(1)
    assert str(np.asarray(got["kind"])) == "direct"
    assert int(got["total"]) == 36
    np.testing.assert_array_equal(got["carry"]["x"], state["carry"]["x"])
    assert got["carry"]["rho"].dtype == np.float32
    with pytest.raises(ValueError, match="mismatch"):
        SnapshotStore(str(tmp_path), {"model_hash": "abc",
                                      "tol": 1e-4}).load(1)
    f = os.path.join(str(tmp_path), "snap_000001.npz")
    blob = open(f, "rb").read()
    with open(f, "wb") as fh:
        fh.write(blob[: len(blob) // 2])
    with pytest.warns(UserWarning, match="unreadable"):
        assert SnapshotStore(str(tmp_path), fp).load(1) is None
    assert store.load(7) is None
    for t in (2, 3, 4):
        store.save(t, state)
    assert sorted(os.listdir(tmp_path))[-2:] == ["snap_000003.npz",
                                                 "snap_000004.npz"]
    assert store.latest() == 4
    store.discard(4)
    assert store.load(4) is None and store.latest() == 3


# ----------------------------------------------------------------------
# Units against the JAX package's
# ----------------------------------------------------------------------

SPECS = ["exc@2*2, kill@5, rho0@1", "nan@s:3,inf@s:5*2", "kill@s:0",
         "nan@col:1, rho0@col:2*3", "inf@col:0", "exc@job:1,nan@job:0",
         "sleep@job:2", "kill@rank:1", "exc@rank:0:3*2", "sleep@rank:1:4",
         "rho0@rank:2:1", "", " ,sleep@0"]
BAD = ["frobnicate@1", "exc@", "exc@-1", "exc@1*0", "kill@col:1",
       "exc@col:0", "rho0@s:1", "kill@job:1", "exc@rank:1:2:3",
       "exc@rank:-1:0", "exc1"]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_grammar_parses_as_jax(spec):
    assert faultinject._parse(spec) == jax_faultinject._parse(spec)
    assert FaultPlan(spec).armed == JaxFaultPlan(spec).armed


@pytest.mark.parametrize("spec", BAD)
def test_fault_grammar_refuses_as_jax(spec):
    with pytest.raises(ValueError) as ours:
        FaultPlan(spec)
    with pytest.raises(ValueError) as theirs:
        JaxFaultPlan(spec)
    assert str(ours.value) == str(theirs.value)


def test_faultplan_counters_poison_and_kill(monkeypatch):
    p = FaultPlan("exc@2*2, kill@5, rho0@1, inf@0, exc@rank:0:4")
    p.dispatches = 2
    for _ in range(2):
        with pytest.raises(InjectedDispatchError):
            p.on_dispatch()
    p.on_dispatch()
    p.dispatches = 4
    with pytest.raises(InjectedDispatchError, match="rank domain"):
        p.on_dispatch()
    carry = {"r": torch.tensor([0.0, 2.0, -1.0]), "rho": np.float64(3.0)}
    c0 = p.at_boundary(dict(carry))
    assert torch.isinf(c0["r"][1:]).all() and c0["r"][0] == 0
    c1 = p.at_boundary(dict(carry))
    assert c1["rho"] == 0 and c1["rho"].dtype == np.float64
    assert carry["rho"] == 3.0 and torch.isfinite(carry["r"]).all()
    p.boundaries = 5
    with pytest.raises(SimulatedKill):
        p.at_boundary(dict(carry))
    assert [f["mode"] for f in p.fired] == ["exc", "exc", "exc", "inf",
                                            "rho0", "kill"]
    # rho0 on the mixed outer state (no rho) neither fires nor consumes
    p2 = FaultPlan("rho0@0")
    p2.at_boundary({"r": carry["r"]})
    assert p2.fired == [] and p2.armed
    # a rank fault aimed at another process stays pending, never fires
    p3 = FaultPlan("kill@rank:1:0")
    p3.at_boundary(dict(carry))
    assert p3.armed and p3.fired == []
    n = FaultPlan("nan@0").at_boundary(dict(carry))
    assert torch.isnan(n["r"]).all()
    monkeypatch.setenv("PCG_TPU_FAULTS", "exc@1")
    assert FaultPlan.from_env().armed
    monkeypatch.setenv("PCG_TPU_FAULTS", "")
    assert FaultPlan.from_env() is None


def test_device_loss_classification_matches_jax():
    class XlaRuntimeError(Exception):
        pass

    cases = [InjectedDispatchError("x"),
             RuntimeError("rpc failed: UNAVAILABLE: socket"),
             ValueError("shapes mismatch"), XlaRuntimeError("boom"),
             RuntimeError("CUDA error: an illegal memory access was "
                           "encountered"),
             RuntimeError("CUDA error: out of memory"),
             RuntimeError("nvcc failed: structured_matvec.cu")]
    got = [is_device_loss(e) for e in cases]
    assert got == [True, True, False, True, False, False, False]
    assert got[1:4] == [jax_recovery.is_device_loss(e) for e in cases[1:4]]


def test_triggers_ladder_and_guard_match_jax(monkeypatch):
    for flag, rel in ((2, 0.5), (4, 0.5), (6, 0.5), (1, float("nan")),
                      (0, float("inf")), (0, 1e-9), (1, 0.5), (3, 0.5)):
        assert breakdown_trigger(flag, rel) == \
            jax_recovery.breakdown_trigger(flag, rel)
        assert column_trigger(flag, rel) == \
            jax_recovery.column_trigger(flag, rel)
    for precond, mixed, n in (("block3", True, 6), ("jacobi", False, 3),
                              ("mg", False, 4), ("jacobi", True, 2)):
        ours = RecoveryLadder(precond=precond, mixed=mixed, max_recoveries=n
                              - 1)
        theirs = jax_recovery.RecoveryLadder(precond=precond, mixed=mixed,
                                             max_recoveries=n - 1)
        assert [ours.next_action("flag4") for _ in range(n)] == \
            [theirs.next_action("flag4") for _ in range(n)]
    g = DispatchGuard(retries=2)
    e = InjectedDispatchError("x")
    assert g.should_retry(e) and g.should_retry(e)
    assert not g.should_retry(e)
    assert not DispatchGuard(retries=5).should_retry(ValueError("no"))
    assert not DispatchGuard(retries=5, deadline_s=-1.0).should_retry(e)
    assert DispatchGuard(retries=5, deadline_s=3600.0).should_retry(e)
    monkeypatch.setenv("PCG_TPU_RETRY_DEADLINE_S", "2.5")
    assert retry_deadline_s() == 2.5
    monkeypatch.setenv("PCG_TPU_RETRY_DEADLINE_S", "soon")
    with pytest.warns(UserWarning):
        assert retry_deadline_s() is None


def test_cuda_error_is_not_retried(models, tmp_path, monkeypatch):
    """A CUDA error raised by a dispatch is not device loss: neither the
    guard (with a snapshot in hand) nor the ladder retries it; it
    reaches the caller as it was."""
    import pcg_mpi_solver_tpu_torch.solver.chunked as chunked

    _, tm = models["cube"]
    _, cfg = _configs(tmp_path, snapshot_every=1)
    s = _port(tm, cfg)
    real, calls = chunked.pcg, []

    def failing(*a, **k):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered")
        return real(*a, **k)

    monkeypatch.setattr(chunked, "pcg", failing)
    cap = _Capture()
    s.recorder.sinks.append(cap)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        s.step(1.0)
    assert len(calls) == 3 and _recoveries(cap) == []

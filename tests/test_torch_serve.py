"""The port's solve service (``pcg_mpi_solver_tpu_torch/serve``,
``obs/watch.py``, the ``job:`` fault domain and the mg setup telemetry)
against the JAX package's, on the CPU.

* The protocol modules (``serve.jobs``, ``journal``, ``packer``,
  ``admission``) and ``obs.watch`` load neither torch, numpy nor anything
  of the JAX package (a subprocess), and neither do the CLI's ``submit``
  and ``jobs``.
* ``pick_width``/``pack_block``, ``check_spec``, ``price_admission`` and
  ``AdmissionController``'s decisions, journal records and events equal
  JAX's on the same inputs; a journal written by either package replays
  to the same job states under the other, a torn tail included; the
  ``@job:`` faults fire and are consumed as JAX's are.
* ``ServeDaemon`` over the 4x3x3 cube at 2 parts on the general backend
  (``tests/test_serve.py``'s ``_cfg()``, direct float64): each served
  job's verdict, flag and iterations equal JAX's daemon over the same
  specs, and its u within 1e-9 of max|u| of JAX's (``SERVE_U_TOL``); a
  co-batched column is bit for bit its width-1 ``solve_many``;
  a ``nan@job:`` job fails alone, an ``exc@job:`` job and a block whose
  dispatch raises fail by name (no fallback); overload sheds by name;
  SIGTERM drains; a real ``cli serve --device cpu`` child SIGKILLed
  inside a block and restarted ends every job exactly once.
* ``watch_snapshot`` over a port-written serve journal and over a port
  telemetry stream equals JAX's (at the same ``now``).
* The ``mg_setup`` event and ``check_mg_interval`` match JAX's on the same
  model, a degenerate interval included.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
import warnings

import numpy as np
import pytest

from pcg_mpi_solver_tpu import RunConfig as JaxRunConfig
from pcg_mpi_solver_tpu import SolverConfig as JaxSolverConfig
from pcg_mpi_solver_tpu import TimeHistoryConfig as JaxTimeHistoryConfig
from pcg_mpi_solver_tpu.models.synthetic import make_cube_model as jax_cube
from pcg_mpi_solver_tpu.obs import watch as jax_watch
from pcg_mpi_solver_tpu.obs.metrics import MetricsRecorder as JaxRecorder
from pcg_mpi_solver_tpu.parallel.mesh import make_mesh
from pcg_mpi_solver_tpu.resilience import FaultPlan as JaxFaultPlan
from pcg_mpi_solver_tpu.resilience.faultinject import (
    InjectedDispatchError as JaxInjectedDispatchError)
from pcg_mpi_solver_tpu.serve import admission as jax_admission
from pcg_mpi_solver_tpu.serve import jobs as jax_jobs
from pcg_mpi_solver_tpu.serve import journal as jax_journal
from pcg_mpi_solver_tpu.serve import packer as jax_packer
from pcg_mpi_solver_tpu.serve.daemon import ServeDaemon as JaxServeDaemon
from pcg_mpi_solver_tpu.solver.driver import Solver as JaxSolver
from pcg_mpi_solver_tpu.validate import check_mg_interval as jax_check_mg
from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig, TimeHistoryConfig
from pcg_mpi_solver_tpu_torch.models import make_cube_model
from pcg_mpi_solver_tpu_torch.obs import watch
from pcg_mpi_solver_tpu_torch.obs.metrics import MetricsRecorder
from pcg_mpi_solver_tpu_torch.ops import mg as mgmod
from pcg_mpi_solver_tpu_torch.resilience import FaultPlan
from pcg_mpi_solver_tpu_torch.resilience.faultinject import (
    InjectedDispatchError)
from pcg_mpi_solver_tpu_torch.serve import admission, packer
from pcg_mpi_solver_tpu_torch.serve import jobs as sjobs
from pcg_mpi_solver_tpu_torch.serve import journal
from pcg_mpi_solver_tpu_torch.serve.daemon import ServeDaemon
from pcg_mpi_solver_tpu_torch.solver import NewmarkSolver, Solver
from pcg_mpi_solver_tpu_torch.validate import check_mg_interval

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX package's serve tests' cube (``pcg-tpu serve --synthetic 4,3,3``)
CUBE = dict(E=30e9, nu=0.2, load="traction", load_value=1e6,
            heterogeneous=True)
# served u against JAX's, x max|u|: the same iterations, so round-off
# apart; the JAX package's own one-part and two-part solves of these jobs
# differ by 4.6e-10 of max|u| (the port's from JAX's: 4.8e-10), so 1e-10
# would hold the port tighter than reduction order holds JAX itself
SERVE_U_TOL = 1e-9
# JSON fields that carry a clock
CLOCK = ("t", "t_mono", "now", "submit_t", "deadline_t", "admit_t")


def _cfg(package="torch"):
    """``tests/test_serve.py::_cfg`` in either package."""
    rc, sc, th = ((RunConfig, SolverConfig, TimeHistoryConfig)
                  if package == "torch" else
                  (JaxRunConfig, JaxSolverConfig, JaxTimeHistoryConfig))
    return rc(solver=sc(tol=1e-8, max_iter=2000, precision_mode="direct",
                        iters_per_dispatch=-1, pcg_variant="classic"),
              time_history=th(time_step_delta=[0.0, 1.0]))


class _Cap:
    """A metrics sink that keeps every event."""

    def __init__(self):
        self.events = []

    def emit(self, ev):
        self.events.append(ev)

    def close(self):
        pass

    def kinds(self, kind):
        return [e for e in self.events if e.get("kind") == kind]


class _StubJournal:
    def __init__(self):
        self.records = []

    def record(self, op, job=None, **fields):
        self.records.append((op, job, fields))


def _no_clock(ev):
    return {k: v for k, v in ev.items() if k not in CLOCK}


@pytest.fixture(scope="module")
def solver():
    return Solver(make_cube_model(4, 3, 3, **CUBE), _cfg(), n_parts=2,
                  backend="general", device="cpu")


@pytest.fixture(scope="module")
def jax_solver():
    return JaxSolver(jax_cube(4, 3, 3, **CUBE), _cfg("jax"),
                     mesh=make_mesh(2), n_parts=2, backend="general")


@pytest.fixture
def cap(solver):
    c = _Cap()
    solver.recorder.add_sink(c)
    yield c
    solver.recorder.remove_sink(c)


def _terminal_counts(path):
    counts = {}
    for ev in journal.read_journal(path)[0]:
        if ev.get("op") in journal.TERMINAL_OPS \
                and isinstance(ev.get("job"), str):
            counts[ev["job"]] = counts.get(ev["job"], 0) + 1
    return counts


# ----------------------------------------------------------------------
# the protocol's import graph
# ----------------------------------------------------------------------

LIGHT = r"""
import sys
import pcg_mpi_solver_tpu_torch.serve.jobs
import pcg_mpi_solver_tpu_torch.serve.journal
import pcg_mpi_solver_tpu_torch.serve.packer
import pcg_mpi_solver_tpu_torch.serve.admission
import pcg_mpi_solver_tpu_torch.obs.watch
print(",".join(sorted(m for m in sys.modules if m.split(".")[0] in
                      ("torch", "numpy", "jax", "pcg_mpi_solver_tpu"))))
"""

CLI_LIGHT = r"""
import sys
from pcg_mpi_solver_tpu_torch.cli import main
main(sys.argv[1:])
print(",".join(sorted(m for m in sys.modules if m.split(".")[0] in
                      ("torch", "jax", "pcg_mpi_solver_tpu"))))
"""


def _env():
    return {k: v for k, v in os.environ.items()
            if k not in ("PYTHONPATH", "JAX_PLATFORMS")}


def test_protocol_modules_load_no_torch_numpy_or_jax():
    out = subprocess.run([sys.executable, "-c", LIGHT], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "", out.stdout


@pytest.mark.parametrize("argv", [
    ["submit", "--spool", "{spool}", "--scale", "1.5", "--job-id", "a"],
    ["jobs", "--spool", "{spool}"],
])
def test_cli_submit_and_jobs_load_no_torch(tmp_path, argv):
    spool = str(tmp_path / "spool")
    if argv[0] == "jobs":
        sjobs.ensure_spool(spool)
        j = journal.JobJournal(sjobs.journal_path(spool))
        j.record("rejected", "x", reason="queue_full")
        j.close()
    out = subprocess.run(
        [sys.executable, "-c", CLI_LIGHT] + [a.format(spool=spool)
                                             for a in argv],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120,
        check=True)
    assert out.stdout.splitlines()[-1] == "", out.stdout


# ----------------------------------------------------------------------
# packer, spec checks, pricing, admission: JAX's decisions
# ----------------------------------------------------------------------

@pytest.mark.parametrize("widths", [(8, 2, 2), (), (0, -3, 4), (1, 2, 4, 8),
                                    (3,)])
def test_packer_matches_jax(widths):
    assert packer.normalize_widths(widths) == \
        jax_packer.normalize_widths(widths)
    for n in range(0, 12):
        assert packer.pick_width(n, widths or (1,)) == \
            jax_packer.pick_width(n, widths or (1,))
    order = [5, 0, 3, 1, 4, 2, 6]
    q, jq = ([{"job": f"j{o}", "ordinal": o} for o in order]
             for _ in range(2))
    while q or jq:
        assert packer.pack_block(q, widths or (1,)) == \
            jax_packer.pack_block(jq, widths or (1,))
        assert q == jq
    assert packer.STANDARD_WIDTHS == jax_packer.STANDARD_WIDTHS


SPECS = [
    {"job": "a", "scale": 1.0, "deadline_s": 60.0},
    {"job": "a", "rhs": "/x.npy"}, [1, 2], "spec",
    {"job": "a", "scale": 1.0, "priority": 9},
    {"job": "a"}, {"job": "a", "scale": 1.0, "rhs": "/x.npy"},
    {"job": "a", "scale": 1.0, "deadline_s": -5},
    {"job": "a", "scale": 1.0, "deadline_s": "soon"},
    {"job": "a", "rhs": ""}, {"job": "a", "scale": True},
    {"job": "a", "scale": 2, "deadline_s": 0}]


@pytest.mark.parametrize("spec", SPECS)
def test_check_spec_matches_jax(spec):
    assert sjobs.check_spec(spec) == jax_jobs.check_spec(spec)


def test_spool_is_shared_with_jax(tmp_path):
    """Specs submitted by the port list in the same order under JAX's
    ``list_incoming`` (and the reverse); results written by either read
    back under the other."""
    spool = str(tmp_path / "spool")
    sjobs.submit(spool, {"job": "b", "scale": 2.0}, submit_t=1.0)
    jax_jobs.submit(spool, {"job": "a", "scale": 1.0}, submit_t=0.0)
    generated = sjobs.submit(spool, {"scale": 3.0}, submit_t=2.0)
    with open(os.path.join(sjobs.incoming_dir(spool), "torn.json"),
              "w") as f:
        f.write('{"job": "to')
    assert len(generated) == 12
    assert sjobs.list_incoming(spool) == jax_jobs.list_incoming(spool)
    with pytest.raises(ValueError, match="exactly one"):
        sjobs.submit(spool, {"job": "x"})
    sjobs.write_result(spool, "j1", {"ok": True, "verdict": "converged"})
    jax_jobs.write_result(spool, "j2", {"ok": False, "verdict": "shed"})
    for j in ("j1", "j2"):
        assert sjobs.read_result(spool, j) == jax_jobs.read_result(spool, j)
    assert sjobs.read_result(spool, "nope") is None
    assert (sjobs.journal_path(spool), sjobs.solution_path(spool, "a")) == (
        jax_jobs.journal_path(spool), jax_jobs.solution_path(spool, "a"))


@pytest.mark.parametrize("ms,iters", [(None, 1000), (2.0, 500), (0.37, 0),
                                      (1e-3, 3334)])
def test_price_admission_matches_jax(ms, iters):
    assert admission.price_admission(ms, iters) == \
        jax_admission.price_admission(ms, iters)


# (spec, now) arrivals; the controller prices at 2 ms/iter x 500 = 1 s
ARRIVALS = [({"job": "slow", "scale": 1.0, "deadline_s": 0.5}, 100.0),
            ({"job": "j0", "scale": 1.0, "deadline_s": 5.0}, 100.0),
            ({"job": "j1", "scale": 1.0, "deadline_s": 5.0}, 100.0),
            ({"job": "full", "scale": 1.0, "deadline_s": 50.0}, 101.0),
            ({"job": "j3", "scale": 1.0, "deadline_s": 50.0}, 200.0),
            ("drain", None),
            ({"job": "late", "scale": 1.0, "deadline_s": 99.0}, 201.0)]


@pytest.mark.parametrize("ms", [2.0, None])
def test_admission_controller_matches_jax(ms):
    """The same arrivals through both controllers (queue_max 2, a
    requeued replay entry first): the same decisions, ordinals, queues,
    journal records, shed hooks and events."""
    out = {}
    for name, mod, rec_cls in (("torch", admission, MetricsRecorder),
                               ("jax", jax_admission, JaxRecorder)):
        cap, jn, shed = _Cap(), _StubJournal(), []
        ctl = mod.AdmissionController(
            2, pricer=lambda nrhs: ms, journal=jn,
            recorder=rec_cls(sinks=[cap]), expected_iters=500,
            price_width=4, ordinal0=3,
            on_shed=lambda e, r: shed.append((e["job"], r)))
        decisions = []
        for spec, now in ARRIVALS:
            if spec == "drain":
                ctl.draining = True
                continue
            decisions.append(ctl.admit(spec, now=now))
        out[name] = (decisions, ctl.queue, ctl.shed_count, ctl.depth_max,
                     jn.records, shed,
                     [_no_clock(e) for e in cap.events])
    assert out["torch"] == out["jax"]
    assert {admission.REJECT_DEADLINE, admission.REJECT_QUEUE_FULL,
            admission.REJECT_DRAINING, admission.SHED_PAST_DEADLINE} == {
        jax_admission.REJECT_DEADLINE, jax_admission.REJECT_QUEUE_FULL,
        jax_admission.REJECT_DRAINING, jax_admission.SHED_PAST_DEADLINE}


def test_requeue_keeps_ordinals_as_jax():
    out = {}
    for name, mod, rec_cls in (("torch", admission, MetricsRecorder),
                               ("jax", jax_admission, JaxRecorder)):
        jn = _StubJournal()
        ctl = mod.AdmissionController(4, pricer=lambda n: 1.0, journal=jn,
                                      recorder=rec_cls(), expected_iters=1)
        ctl.requeue({"job": "old", "spec": {"job": "old", "scale": 1.0},
                     "ordinal": 7, "deadline_t": 50.0, "admit_t": 0.0})
        v, entry = ctl.admit({"job": "new", "scale": 1.0,
                              "deadline_s": 99.0}, now=0.0)
        out[name] = (jn.records, ctl._next_ordinal, v, entry, ctl.queue)
    assert out["torch"] == out["jax"]
    assert out["torch"][3]["ordinal"] == 8


# ----------------------------------------------------------------------
# the journal: one file contract for both packages
# ----------------------------------------------------------------------

def _write_journal(mod, path, torn=False):
    j = mod.JobJournal(path)
    j.record("admitted", "a", spec={"job": "a", "scale": 1.0},
             ordinal=0, deadline_t=100.0)
    j.record("admitted", "b", spec={"job": "b", "scale": 2.0},
             ordinal=1, deadline_t=200.0)
    j.record("packed", None, block=0, jobs=["a", "b"], ordinals=[0, 1],
             width=2)
    j.record("dispatched", None, block=0, jobs=["a", "b"], width=2)
    j.record("done", "a", verdict="converged", block=0)
    j.record("rejected", "c", reason="queue_full")
    j.record("admitted", "d", spec={"job": "d", "rhs": "/x.npy"},
             ordinal=2, deadline_t=300.0)
    j.record("shed", "d", reason="past_deadline_backpressure", ordinal=2)
    if torn:
        j._fl.close()
        with open(path, "a") as f:
            f.write('{"kind": "flight", "op": "do')
    else:
        j.drain("test", jobs_done=1)
        j.close()


@pytest.mark.parametrize("torn", [False, True])
@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_journal_replays_under_either_package(tmp_path, writer, torn):
    path = str(tmp_path / "journal.jsonl")
    _write_journal(journal if writer == "torch" else jax_journal, path,
                   torn)
    ev, tr = journal.read_journal(path)
    jev, jtr = jax_journal.read_journal(path)
    assert tr == jtr == int(torn) and ev == jev
    states = journal.replay_jobs(ev)
    assert states == jax_journal.replay_jobs(ev)
    assert journal.next_ordinal(states) == \
        jax_journal.next_ordinal(states) == 3
    assert states["a"]["terminal"] and not states["b"]["terminal"]
    assert states["b"]["spec"] == {"job": "b", "scale": 2.0}
    assert states["c"]["ordinal"] is None and states["c"]["terminal"]
    assert all(e.get("journal") == jax_journal.SERVE_JOURNAL_SCHEMA
               for e in ev if e.get("op") in jax_journal.JOB_OPS)
    assert (journal.SERVE_JOURNAL_SCHEMA, journal.JOB_OPS,
            journal.TERMINAL_OPS, journal.DRAIN_OP) == (
        jax_journal.SERVE_JOURNAL_SCHEMA, jax_journal.JOB_OPS,
        jax_journal.TERMINAL_OPS, jax_journal.DRAIN_OP)


# ----------------------------------------------------------------------
# the @job: fault domain
# ----------------------------------------------------------------------

def _fire(plan, ordinals):
    out = []
    for o in ordinals:
        try:
            out.append(plan.at_job(o))
        except (InjectedDispatchError, JaxInjectedDispatchError) as e:
            out.append(("exc", str(e)))
    return out


@pytest.mark.parametrize("spec,ordinals,consumed", [
    ("sleep@job:0,nan@job:2,exc@job:1", [0, 2, 1, 1, 2, 0], []),
    ("nan@job:3,exc@job:3,sleep@job:3", [3, 3], []),
    ("exc@job:1*2", [1, 1, 1], []),
    ("exc@job:3,nan@job:4", [3, 4], [3]),
    ("sleep@job:0,nan@col:1", [0, 1], [0]),
])
def test_job_faults_fire_and_replay_as_jax(monkeypatch, spec, ordinals,
                                           consumed):
    monkeypatch.setenv("PCG_TPU_FAULT_SLEEP_S", "0.0")
    plan, jplan = FaultPlan(spec), JaxFaultPlan(spec)
    assert (plan.job_armed, plan.armed) == (jplan.job_armed, jplan.armed)
    for o in consumed:
        plan.replay_consume_job(o)
        jplan.replay_consume_job(o)
    assert _fire(plan, ordinals) == _fire(jplan, ordinals)
    assert plan.fired == jplan.fired
    assert (plan.job_armed, plan.armed) == (jplan.job_armed, jplan.armed)


@pytest.mark.parametrize("spec", ["kill@job:0", "inf@job:1", "rho0@job:2"])
def test_job_fault_spec_errors_match_jax(spec):
    with pytest.raises(ValueError) as ours:
        FaultPlan(spec)
    with pytest.raises(ValueError) as theirs:
        JaxFaultPlan(spec)
    assert str(ours.value) == str(theirs.value)


# ----------------------------------------------------------------------
# the daemon against JAX's
# ----------------------------------------------------------------------

SERVED = (("t0", 1.0), ("t1", 0.5), ("t2", 2.0), ("t3", -1.0))


def _serve(daemon_cls, solver, spool, faults, plan_cls, widths=(1, 2)):
    for i, (job, sc) in enumerate(SERVED):
        sjobs.submit(spool, {"job": job, "scale": sc}, submit_t=float(i))
    d = daemon_cls(solver, spool, queue_max=8, widths=widths,
                   fault_plan=plan_cls(faults), poll_s=0.001)
    reason = d.run(idle_exit_s=0.0, install_signals=False)
    return d, reason


def test_daemon_matches_jax(tmp_path, solver, jax_solver):
    """Four jobs and ``exc@job:1`` through both daemons (widths 1, 2:
    t0 alone once t1 fails, then t2 and t3 co-batched): the same
    verdicts, flags and iterations (direct solves of one operator on one
    partition; no +-1 was needed), u within ``SERVE_U_TOL`` of JAX's."""
    d, reason = _serve(ServeDaemon, solver, str(tmp_path / "t"),
                       "exc@job:1", FaultPlan)
    jd, jreason = _serve(JaxServeDaemon, jax_solver, str(tmp_path / "j"),
                         "exc@job:1", JaxFaultPlan)
    assert reason == jreason == "idle"
    assert (d.jobs_done, d.jobs_failed, d.blocks) == \
        (jd.jobs_done, jd.jobs_failed, jd.blocks) == (3, 1, 2)
    for job, _sc in SERVED:
        r = sjobs.read_result(str(tmp_path / "t"), job)
        jr = jax_jobs.read_result(str(tmp_path / "j"), job)
        keys = ("ok", "verdict", "flag", "iters", "block", "width")
        assert {k: r.get(k) for k in keys} == {k: jr.get(k) for k in keys}
        if r["ok"]:
            u = np.load(sjobs.solution_path(str(tmp_path / "t"), job))
            ju = np.load(jax_jobs.solution_path(str(tmp_path / "j"), job))
            assert np.abs(u - ju).max() <= SERVE_U_TOL * np.abs(ju).max()
    assert sjobs.read_result(str(tmp_path / "t"), "t1")["verdict"] \
        .startswith("injected:")
    # either package's replay folds the port's journal the same way
    ev, _ = journal.read_journal(sjobs.journal_path(str(tmp_path / "t")))
    ours, theirs = journal.replay_jobs(ev), jax_journal.replay_jobs(ev)
    assert ours == theirs and all(st["terminal"] for st in ours.values())


def test_cobatched_columns_are_their_width1_solves(tmp_path, solver, cap):
    """A width-4 block's columns are bit for bit their width-1
    ``solve_many`` (the CPU's sums do not depend on the block width)."""
    spool = str(tmp_path / "spool")
    d, _ = _serve(ServeDaemon, solver, spool, "", FaultPlan,
                  widths=(1, 4))
    assert d.blocks == 1 and d.jobs_done == 4
    F = np.asarray(solver._model.F, dtype=np.float64)
    for job, sc in SERVED:
        assert sjobs.read_result(spool, job)["width"] == 4
        ref = solver.solve_many(F * sc)
        u_ref = solver.displacement_global_many(ref.x)[:, 0]
        np.testing.assert_array_equal(
            np.load(sjobs.solution_path(spool, job)), u_ref)
    done = {e["job"]: e for e in cap.kinds("job_done")}
    assert set(done) == {j for j, _ in SERVED}
    assert [e["reason"] for e in cap.kinds("serve_drain")] == ["idle"]


def test_nan_poison_fails_alone_in_its_block(tmp_path, solver, cap):
    """``nan@job:0`` poisons the first job of a width-2 block: it fails
    ``rhs_nonfinite`` (a ``job_quarantine`` event) and its co-batched job
    converges bit for bit as its width-1 solve."""
    spool = str(tmp_path / "spool")
    sjobs.submit(spool, {"job": "bad", "scale": 1.0}, submit_t=0.0)
    sjobs.submit(spool, {"job": "good", "scale": 2.0}, submit_t=1.0)
    d = ServeDaemon(solver, spool, queue_max=8, widths=(1, 2),
                    fault_plan=FaultPlan("nan@job:0"), poll_s=0.001)
    d.run(idle_exit_s=0.0, install_signals=False)
    assert (d.jobs_done, d.jobs_failed) == (1, 1)
    bad = sjobs.read_result(spool, "bad")
    assert bad["ok"] is False and bad["verdict"] == "rhs_nonfinite"
    (q,) = cap.kinds("job_quarantine")
    assert q["job"] == "bad"
    good = sjobs.read_result(spool, "good")
    assert good["ok"] and good["verdict"] == "converged"
    ref = solver.solve_many(np.asarray(solver._model.F) * 2.0)
    np.testing.assert_array_equal(
        np.load(sjobs.solution_path(spool, "good")),
        solver.displacement_global_many(ref.x)[:, 0])


def test_bad_specs_rhs_and_dispatch_failures_are_named(tmp_path, solver,
                                                       cap, monkeypatch):
    """An unparseable file, an unknown key and a wrong-length rhs fail
    their job by name while a valid job solves; then a block whose
    dispatch raises fails every job of it ``dispatch_failed: ...``, and
    nothing solves it elsewhere."""
    spool = str(tmp_path / "spool")
    sjobs.ensure_spool(spool)
    inc = sjobs.incoming_dir(spool)
    with open(os.path.join(inc, "torn.json"), "w") as f:
        f.write('{"job": "to')
    sjobs.write_json_atomic(os.path.join(inc, "oddkey.json"),
                            {"job": "oddkey", "scale": 1.0, "nice": True})
    rhs = tmp_path / "short.npy"
    np.save(rhs, np.ones(3))
    sjobs.submit(spool, {"job": "shortrhs", "rhs": str(rhs)}, submit_t=0.0)
    sjobs.submit(spool, {"job": "fine", "scale": 1.0}, submit_t=1.0)
    d = ServeDaemon(solver, spool, queue_max=8, widths=(1, 2),
                    fault_plan=FaultPlan(""), poll_s=0.001)
    d.poll_once()
    d.serve_block()
    assert sjobs.read_result(spool, "torn")["verdict"].startswith(
        "rejected: bad_spec")
    assert "unknown key" in sjobs.read_result(spool, "oddkey")["verdict"]
    assert sjobs.read_result(spool, "shortrhs")["verdict"].startswith(
        "rhs_load_failed:")
    assert sjobs.read_result(spool, "fine")["ok"] is True
    assert not os.listdir(inc)

    calls = []

    def lost(fb, **kw):
        calls.append(fb.shape)
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(solver, "solve_many", lost)
    for i, job in enumerate(("x0", "x1")):
        sjobs.submit(spool, {"job": job, "scale": 1.0}, submit_t=2.0 + i)
    d.poll_once()
    d.serve_block()
    monkeypatch.undo()
    assert calls == [(solver._model.n_dof, 2)]
    for job in ("x0", "x1"):
        res = sjobs.read_result(spool, job)
        assert res["ok"] is False and res["verdict"] == (
            "dispatch_failed: RuntimeError: CUDA error: an illegal memory "
            "access")
        assert not os.path.exists(sjobs.solution_path(spool, job))
    d.run(idle_exit_s=0.0, install_signals=False)
    assert set(_terminal_counts(sjobs.journal_path(spool)).values()) == {1}


def test_overload_sheds_and_sigterm_drains(tmp_path, solver, cap):
    """JAX's overload drill: a full queue of lapsed jobs is shed by name,
    an infeasible deadline and a draining daemon reject by name, SIGTERM
    (the handler, called as the signal would) drains after the queue."""
    spool = str(tmp_path / "spool")
    t0 = 1000.0
    for i in range(2):
        sjobs.submit(spool, {"job": f"q{i}", "scale": 1.0,
                             "deadline_s": 0.5}, submit_t=float(i))
    d = ServeDaemon(solver, spool, queue_max=2, widths=(1,),
                    fault_plan=FaultPlan(""), poll_s=0.001)
    assert d.poll_once(now=t0) == 2
    sjobs.submit(spool, {"job": "q2", "scale": 1.0, "deadline_s": 500.0},
                 submit_t=2.0)
    assert d.poll_once(now=t0 + 50.0) == 1 and d.admission.shed_count == 2
    for job in ("q0", "q1"):
        assert sjobs.read_result(spool, job)["verdict"] == \
            f"shed: {admission.SHED_PAST_DEADLINE}"
    assert solver.predicted_ms_per_iter(1) is not None
    sjobs.submit(spool, {"job": "rush", "scale": 1.0, "deadline_s": 1e-9},
                 submit_t=3.0)
    d.poll_once(now=t0 + 51.0)
    assert sjobs.read_result(spool, "rush")["verdict"] == \
        f"rejected: {admission.REJECT_DEADLINE}"
    d.request_drain(signal.SIGTERM, None)
    sjobs.submit(spool, {"job": "late", "scale": 1.0}, submit_t=4.0)
    d.poll_once(now=t0 + 52.0)
    assert sjobs.read_result(spool, "late")["verdict"] == \
        f"rejected: {admission.REJECT_DRAINING}"
    assert d.run(install_signals=False) == "sigterm"
    assert sjobs.read_result(spool, "q2")["ok"] is True
    counts = _terminal_counts(sjobs.journal_path(spool))
    assert counts == {j: 1 for j in ("q0", "q1", "q2", "rush", "late")}
    snap = watch.watch_snapshot(sjobs.journal_path(spool))
    assert snap["status"] == "done" and snap["serve"]["drain_reason"] == \
        "sigterm"


def test_replay_completes_from_result_and_requeues(tmp_path, solver, cap):
    """Killed after job a's result file, before its terminal record:
    replay completes a from the result, queues b with its ordinal, drops
    a's second submission; an admitted record without its spec fails by
    name."""
    spool = str(tmp_path / "spool")
    sjobs.submit(spool, {"job": "a", "scale": 1.0}, submit_t=0.0)
    sjobs.submit(spool, {"job": "b", "scale": 2.0}, submit_t=1.0)
    d1 = ServeDaemon(solver, spool, queue_max=8, widths=(1,),
                     fault_plan=FaultPlan(""), poll_s=0.001)
    d1.poll_once()
    sjobs.write_result(spool, "a", {"ok": True, "verdict": "converged"})
    d1.journal.record("admitted", "ghost")
    d1.journal._fl.close()
    sjobs.submit(spool, {"job": "a", "scale": 1.0}, submit_t=2.0)
    d2 = ServeDaemon(solver, spool, queue_max=8, widths=(1,),
                     fault_plan=FaultPlan(""), poll_s=0.001)
    assert (d2.jobs_done, d2.jobs_failed) == (1, 1)
    assert [(e["job"], e["ordinal"]) for e in d2.admission.queue] == \
        [("b", 1)]
    assert sjobs.read_result(spool, "ghost")["verdict"].startswith(
        "replay_unrecoverable")
    assert [e["job"] for e in cap.kinds("job_done")
            if e.get("replayed")] == ["a"]
    assert d2.run(idle_exit_s=0.0, install_signals=False) == "idle"
    assert _terminal_counts(sjobs.journal_path(spool)) == \
        {"a": 1, "b": 1, "ghost": 1}


def test_sigkill_mid_block_restart_is_exactly_once(tmp_path, solver):
    """A real ``cli serve --device cpu`` child held inside its first
    block by ``sleep@job:0`` is SIGKILLed; a daemon started over the same
    spool replays both jobs with their ordinals and ends each exactly
    once, bit for bit their width-1 solves."""
    spool = str(tmp_path / "spool")
    sjobs.submit(spool, {"job": "k0", "scale": 1.0}, submit_t=0.0)
    sjobs.submit(spool, {"job": "k1", "scale": 2.0}, submit_t=1.0)
    env = dict(_env(), PCG_TPU_FAULTS="sleep@job:0",
               PCG_TPU_FAULT_SLEEP_S="600")
    proc = subprocess.Popen(
        [sys.executable, "-m", "pcg_mpi_solver_tpu_torch.cli", "serve",
         "--spool", spool, "--synthetic", "4,3,3", "--widths", "1,2",
         "--poll-s", "0.01", "--n-parts", "2", "--backend", "general",
         "--tol", "1e-8", "--max-iter", "2000", "--device", "cpu"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    path = sjobs.journal_path(spool)
    try:
        deadline = time.monotonic() + 120.0
        while not (os.path.exists(path) and any(
                ev.get("op") == "packed"
                for ev in journal.read_journal(path)[0])):
            if proc.poll() is not None:
                pytest.fail("serve exited before packing: "
                            + proc.communicate()[0][-2000:])
            assert time.monotonic() < deadline, "never packed"
            time.sleep(0.05)
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    events, _ = journal.read_journal(path)
    assert not any(ev.get("op") in journal.TERMINAL_OPS + ("drain",)
                   for ev in events)
    assert watch.watch_snapshot(path, stall_after_s=1e-6)["status"] == \
        "stalled"
    plan = FaultPlan("sleep@job:0")
    plan.sleep_s = 0.0
    d = ServeDaemon(solver, spool, queue_max=8, widths=(1, 2),
                    fault_plan=plan, poll_s=0.001)
    assert [e["ordinal"] for e in d.admission.queue] == [0, 1]
    assert d.run(idle_exit_s=0.0, install_signals=False) == "idle"
    assert (d.jobs_done, d.jobs_failed) == (2, 0)
    F = np.asarray(solver._model.F)
    for job, sc in (("k0", 1.0), ("k1", 2.0)):
        ref = solver.solve_many(F * sc)
        np.testing.assert_array_equal(
            np.load(sjobs.solution_path(spool, job)),
            solver.displacement_global_many(ref.x)[:, 0])
    assert _terminal_counts(path) == {"k0": 1, "k1": 1}


# ----------------------------------------------------------------------
# watch
# ----------------------------------------------------------------------

def _same_snapshot(path, **kw):
    ours = watch.watch_snapshot(path, **kw)
    theirs = jax_watch.watch_snapshot(path, **kw)
    assert ours == theirs
    assert watch.format_watch(ours) == jax_watch.format_watch(theirs)
    evs = {}
    for name, mod, rec_cls in (("torch", watch, MetricsRecorder),
                               ("jax", jax_watch, JaxRecorder)):
        c = _Cap()
        mod.emit_watch_events(rec_cls(sinks=[c]), ours)
        evs[name] = [_no_clock(e) for e in c.events]
    assert evs["torch"] == evs["jax"]
    return ours


def test_watch_matches_jax_on_a_serve_journal(tmp_path):
    path = str(tmp_path / "journal.jsonl")
    j = journal.JobJournal(path)
    j.record("admitted", "a", spec={"job": "a", "scale": 1.0},
             ordinal=0, deadline_t=9.0)
    j.record("admitted", "b", spec={"job": "b", "scale": 2.0},
             ordinal=1, deadline_t=9.0)
    j.record("packed", None, block=0, jobs=["a", "b"], width=2)
    j.record("done", "a", verdict="converged", block=0)
    now = time.time()
    snap = _same_snapshot(path, now=now)
    assert snap["serve"]["in_flight"] == ["b"]
    assert _same_snapshot(path, now=now + 1e4)["status"] == "stalled"
    j.record("done", "b", verdict="converged", block=0)
    j.drain("idle", jobs_done=2)
    j.close()
    assert _same_snapshot(path, now=now + 1e4)["status"] == "done"


def test_watch_matches_jax_on_a_telemetry_stream(tmp_path):
    """A port solve's JSONL stream (steps, dispatches, the cost model, the
    residual ring) watched by both packages at the same ``now``."""
    path = str(tmp_path / "run.jsonl")
    cfg = RunConfig(telemetry_path=path,
                    solver=SolverConfig(tol=1e-8, trace_resid=64))
    cfg.time_history.time_step_delta = [0.0, 0.5, 1.0]
    s = Solver(make_cube_model(4, 3, 3, **CUBE), cfg, device="cpu")
    s.solve()
    s.recorder.close()
    for tol in (1e-8, 1e-12):
        snap = _same_snapshot(path, now=time.time(), tol=tol)
        assert len(snap["steps"]) == 2 and snap["status"] == "done"
        assert snap["predicted_ms_per_iter"] is not None
        assert snap["rate_decades_per_iter"] < 0


# ----------------------------------------------------------------------
# the mg setup telemetry
# ----------------------------------------------------------------------

@pytest.mark.parametrize("lmin,lmax", [
    (1.0, 2.0), (1.0, 1.04), (0.0, 1.0), (-1.0, 3.0), (1.0, float("nan")),
    (1.0, 0.0), (2.0, float("inf")), (1.0, 1.05)])
def test_check_mg_interval_matches_jax(lmin, lmax):
    ours, theirs = check_mg_interval(lmin, lmax), jax_check_mg(lmin, lmax)
    assert (ours.name, ours.status, ours.detail) == \
        (theirs.name, theirs.status, theirs.detail)


MG_CUBE = dict(h=0.5, nu=0.3, heterogeneous=True)


def test_mg_setup_event_matches_jax():
    """The ``mg_setup`` event of both Solvers on the same model: levels,
    degree, dims, the interval's status and the cache flag equal, the
    bounds within 1e-10, ``wall_s`` a positive number; the ``mg.levels``
    gauge."""
    ev = {}
    for name in ("torch", "jax"):
        c = _Cap()
        if name == "torch":
            s = Solver(make_cube_model(8, 8, 8, **MG_CUBE), RunConfig(
                solver=SolverConfig(tol=1e-8, precond="mg")), n_parts=2,
                device="cpu", recorder=MetricsRecorder(sinks=[c]))
        else:
            s = JaxSolver(jax_cube(8, 8, 8, **MG_CUBE), JaxRunConfig(
                solver=JaxSolverConfig(tol=1e-8, precond="mg")),
                mesh=make_mesh(2), n_parts=2,
                recorder=JaxRecorder(sinks=[c]))
        (ev[name],) = c.kinds("mg_setup")
        assert s.recorder.snapshot()["gauges"]["mg.levels"] == \
            ev[name]["levels"]
    ours, theirs = ev["torch"], ev["jax"]
    for k in ("levels", "degree", "dims", "interval", "cached"):
        assert ours[k] == theirs[k], k
    np.testing.assert_allclose([ours["lam_fine"]] + ours["lam_coarse"],
                               [theirs["lam_fine"]] + theirs["lam_coarse"],
                               rtol=1e-10)
    assert ours["wall_s"] > 0 and ours["interval"] == "ok"


def test_mg_setup_reports_a_degenerate_interval_and_newmark_emits():
    """A coarsest interval narrower than 1.05 warns (never fails) and the
    event says ``warn``; ``NewmarkSolver``'s mg setup emits the event
    with ``cached`` False, as the JAX package's does."""
    c = _Cap()
    s = NewmarkSolver(make_cube_model(8, 8, 8, **MG_CUBE), RunConfig(
        solver=SolverConfig(tol=1e-8, precond="mg")), dt=0.2,
        device="cpu", recorder=MetricsRecorder(sinks=[c]))
    (ev,) = c.kinds("mg_setup")
    assert ev["cached"] is False and ev["levels"] == s.mg_setup.meta[
        "levels"]
    setup = dataclasses.replace(
        s.mg_setup, lam_min_coarse=s.mg_setup.coarse_lams[-1]
        / mgmod.MG_LAM_SAFETY / 1.01)
    c2 = _Cap()
    tree = {"mg": {"lam": np.zeros(len(setup.coarse_lams) + 1)}}
    with pytest.warns(UserWarning, match=r"\[mg_cheb_interval\] .*"
                                         r"degenerate"):
        lam = mgmod.install_lam_and_report(
            setup, 2.0, trees=[tree], recorder=MetricsRecorder(sinks=[c2]),
            wall_s=0.5, cached=True)
    (ev2,) = c2.kinds("mg_setup")
    assert ev2["interval"] == "warn" and ev2["cached"] is True
    assert ev2["wall_s"] == 0.5
    np.testing.assert_array_equal(tree["mg"]["lam"], lam)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        mgmod.install_lam_and_report(
            s.mg_setup, 2.0, trees=[], recorder=MetricsRecorder(),
            wall_s=0.0, cached=False)


def test_watch_cli_once_exits_3_on_a_stall(tmp_path, capsys):
    from pcg_mpi_solver_tpu_torch.cli import main

    path = str(tmp_path / "journal.jsonl")
    j = journal.JobJournal(path)
    j.record("admitted", "a", spec={"job": "a", "scale": 1.0},
             ordinal=0, deadline_t=9.0)
    j._fl.close()
    with pytest.raises(SystemExit) as e:
        main(["watch", path, "--once", "--stall-after", "1e-6"])
    assert e.value.code == 3
    assert "STALL" in capsys.readouterr().out
    rec = json.dumps(journal.read_journal(path)[0][-1])
    assert "admitted" in rec

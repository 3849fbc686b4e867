"""Distributed fault tolerance of the port (``resilience/distributed.py``,
``parallel/consensus.py``, the ``rank:`` fault domain): the single-process
cases of ``tests/test_distributed_ft.py`` against the port — group-
consistent snapshot epochs (two-phase commit markers), collective
deadline guards with dead-peer attribution off the flight shards,
group-agreed consensus verdicts and the ``rank:`` grammar — then one REAL
2-rank dead-peer drill and one 2 -> 1 elastic resume over gloo on the
CPU."""

import glob
import json
import os
import time

import numpy as np
import pytest

from pcg_mpi_solver_tpu_torch.obs.metrics import MetricsRecorder
from pcg_mpi_solver_tpu_torch.parallel.consensus import (
    agree, agree_flag, agree_trigger, agree_triggers, decode_trigger,
    encode_trigger)
from pcg_mpi_solver_tpu_torch.resilience import (
    DeadPeerError, FaultPlan, GroupSnapshotStore, GuardedComm,
    InjectedDispatchError, SimulatedKill, collective_deadline_s,
    is_device_loss, suspect_dead_rank)

from test_torch_distributed import make_mh_test_model, run_ranks


class _Cap:
    """Metrics sink collecting events for assertions."""

    def __init__(self):
        self.events = []

    def emit(self, ev):
        self.events.append(ev)

    def close(self):
        pass


def _kinds(cap, kind):
    return [e for e in cap.events if e["kind"] == kind]


# ----------------------------------------------------------------------
# Deadline knob + dead-peer attribution
# ----------------------------------------------------------------------

def test_collective_deadline_env(monkeypatch):
    monkeypatch.delenv("PCG_TPU_COLLECTIVE_DEADLINE_S", raising=False)
    assert collective_deadline_s() is None
    monkeypatch.setenv("PCG_TPU_COLLECTIVE_DEADLINE_S", "7.5")
    assert collective_deadline_s() == 7.5
    monkeypatch.setenv("PCG_TPU_COLLECTIVE_DEADLINE_S", "0")
    assert collective_deadline_s() is None
    monkeypatch.setenv("PCG_TPU_COLLECTIVE_DEADLINE_S", "soon")
    with pytest.warns(UserWarning, match="not a number"):
        assert collective_deadline_s() is None


def _write_shard(path, t, done=False):
    lines = [{"schema": 1, "t": t, "kind": "meta"}]
    if done:
        lines.append({"schema": 1, "t": t, "kind": "run_summary"})
    path.write_text("".join(json.dumps(ev) + "\n" for ev in lines))


def test_suspect_dead_rank_reads_peer_shard_tails(tmp_path):
    base = tmp_path / "fl.jsonl"
    now = time.time()
    _write_shard(tmp_path / "fl.p0.jsonl", now)          # self: excluded
    _write_shard(tmp_path / "fl.p1.jsonl", now - 45.0)   # silent 45s
    _write_shard(tmp_path / "fl.p2.jsonl", now - 5.0)
    rank, silent = suspect_dead_rank(str(base), self_index=0)
    assert rank == 1 and silent > 30.0
    # a peer that finished cleanly (run_summary) is not a suspect
    _write_shard(tmp_path / "fl.p1.jsonl", now - 45.0, done=True)
    rank, _ = suspect_dead_rank(str(base), self_index=0)
    assert rank == 2
    # nothing readable -> no verdict, never a raise
    assert suspect_dead_rank(str(tmp_path / "absent.jsonl"), 0) == (None,
                                                                    None)


class _HangComm:
    """HostComm stub whose collectives never come back (dead peer)."""

    n_procs = 2

    def allreduce(self, arr, op):
        time.sleep(300)


class _BoomComm:
    n_procs = 2

    def allreduce(self, arr, op):
        raise ValueError("boom")


def test_guardedcomm_deadline_names_suspect(tmp_path):
    base = tmp_path / "fl.jsonl"
    now = time.time()
    _write_shard(tmp_path / "fl.p0.jsonl", now)
    _write_shard(tmp_path / "fl.p1.jsonl", now - 45.0)
    cap = _Cap()
    rec = MetricsRecorder(sinks=[cap])
    g = GuardedComm(_HangComm(), deadline_s=0.3, recorder=rec,
                    flight_base=str(base), index=0)
    t0 = time.monotonic()
    with pytest.raises(DeadPeerError) as ei:
        g.barrier("chunk_boundary")
    assert time.monotonic() - t0 < 5.0          # bounded, not a hang
    msg = str(ei.value)
    assert "suspected dead peer: process 1" in msg
    assert "chunk_boundary" in msg
    # deliberately NOT device-loss shaped: the dispatch guard must
    # propagate a dead peer instead of burning retries on it
    assert not is_device_loss(ei.value)
    (ev,) = _kinds(cap, "collective_timeout")
    assert ev["label"] == "chunk_boundary" and ev["suspect"] == 1
    assert rec.counters["resilience.collective_timeout"] == 1


class _ResetComm:
    """A killed peer as gloo actually surfaces it: a FAST connection
    error out of the collective, not a hang."""

    n_procs = 2

    def allreduce(self, arr, op):
        raise RuntimeError("Gloo AllGather failed: [transport/tcp/pair.cc]"
                           " Read error: Connection reset by peer")


def test_guardedcomm_transport_failure_is_dead_peer(tmp_path):
    base = tmp_path / "fl.jsonl"
    _write_shard(tmp_path / "fl.p0.jsonl", time.time())
    _write_shard(tmp_path / "fl.p1.jsonl", time.time() - 1.0)
    cap = _Cap()
    g = GuardedComm(_ResetComm(), deadline_s=5.0,
                    recorder=MetricsRecorder(sinks=[cap]),
                    flight_base=str(base), index=0)
    with pytest.raises(DeadPeerError) as ei:
        g.barrier("chunk_boundary")
    assert "suspected dead peer: process 1" in str(ei.value)
    assert not is_device_loss(ei.value)          # must NOT burn retries
    assert isinstance(ei.value.__cause__, RuntimeError)
    (ev,) = _kinds(cap, "collective_timeout")
    assert ev["suspect"] == 1


def test_guardedcomm_transport_classified_without_deadline():
    """The transport-failure-to-DeadPeerError classification
    is a correctness concern, not a watchdog concern — a killed gloo
    peer's connection-reset error must get the dead-peer verdict even
    on a default-config run (PCG_TPU_COLLECTIVE_DEADLINE_S unset),
    instead of keeping its retryable-device-loss shape and burning
    dispatch-guard retries re-entering the dead group."""
    cap = _Cap()
    g = GuardedComm(_ResetComm(), deadline_s=None,
                    recorder=MetricsRecorder(sinks=[cap]), index=0)
    with pytest.raises(DeadPeerError) as ei:
        g.allreduce(np.ones(1), "min")
    assert not is_device_loss(ei.value)
    assert isinstance(ei.value.__cause__, RuntimeError)
    (ev,) = _kinds(cap, "collective_timeout")
    assert ev["deadline_s"] == 0.0          # verdict without a watchdog


def test_guardedcomm_passthrough_and_error_rethrow():
    # non-transport errors keep their own type, deadline armed or not
    g = GuardedComm(_BoomComm(), deadline_s=None, index=0)
    with pytest.raises(ValueError, match="boom"):
        g.allreduce(np.ones(1), "min")
    g = GuardedComm(_BoomComm(), deadline_s=5.0, index=0)
    with pytest.raises(ValueError, match="boom"):
        g.allreduce(np.ones(1), "min")


# ----------------------------------------------------------------------
# Consensus verdicts
# ----------------------------------------------------------------------

class _ScriptedComm:
    """HostComm-shaped stub: each allreduce pops the next scripted
    group result (None = lockstep-identical peers, pass through)."""

    def __init__(self, script=(), n_procs=2):
        self.n_procs = n_procs
        self.script = list(script)

    def allreduce(self, arr, op):
        out = np.asarray(arr, dtype=np.int64).copy()
        if self.script:
            nxt = self.script.pop(0)
            if nxt is not None:
                out[...] = np.asarray(nxt, dtype=np.int64)
        return out

    def allreduce_groups(self, groups):
        return [tuple(self.allreduce(a, op) for a in arrs)
                for arrs, op in groups]


def test_consensus_identity_without_group():
    assert agree(None, [3, 7], "min").tolist() == [3, 7]
    assert agree(_ScriptedComm(n_procs=1), [3], "max")[0] == 3
    assert agree_flag(None, True) is True
    assert agree_flag(None, 0) is False
    assert agree_trigger(None, "nan_carry") == "nan_carry"
    assert agree_trigger(None, None) is None
    assert agree_triggers(None, {1: "flag2"}, 4) == {1: "flag2"}


def test_trigger_codes_roundtrip():
    from pcg_mpi_solver_tpu.parallel import consensus as jax_consensus

    for t in (None, "device_loss", "nan_carry", "flag2", "flag4"):
        assert decode_trigger(encode_trigger(t)) == t
        # the JAX package's codes, so mixed-package readings agree
        assert encode_trigger(t) == jax_consensus.encode_trigger(t)
    with pytest.raises(ValueError):
        encode_trigger("meteor_strike")
    with pytest.raises(ValueError):
        decode_trigger(7)


def test_consensus_group_reduction():
    # a peer's alarm (device_loss=1) wins the max over this rank's None
    comm = _ScriptedComm(script=[encode_trigger("device_loss")])
    assert agree_trigger(comm, None) == "device_loss"
    # all-ranks-able: one peer's 0 vetoes the min
    assert agree_flag(_ScriptedComm(script=[0]), True) is False
    # packed per-column verdicts: only agreed columns come back
    comm = _ScriptedComm(script=[[0, encode_trigger("nan_carry"), 0,
                                  encode_trigger("flag4")]])
    assert agree_triggers(comm, {}, 4) == {1: "nan_carry", 3: "flag4"}


def test_collective_comm_real_group_without_deadline(monkeypatch):
    """``Solver._collective_comm`` returns a REAL guarded group on every
    multi-process run (the consensus agreements are correctness-critical
    whatever the configuration), the deadline watchdog layered on only
    when ``PCG_TPU_COLLECTIVE_DEADLINE_S`` is set; one process has
    none."""
    from pcg_mpi_solver_tpu_torch.parallel.mesh import Mesh
    from pcg_mpi_solver_tpu_torch.solver.driver import Solver

    monkeypatch.delenv("PCG_TPU_COLLECTIVE_DEADLINE_S", raising=False)
    s = Solver.__new__(Solver)
    s.mesh = Mesh()
    s._group_comm, s._setup_comm, s._rec = None, _ScriptedComm(), None
    assert s._collective_comm() is None
    s.mesh = Mesh(world=2, rank=0)
    comm = s._collective_comm()
    assert isinstance(comm, GuardedComm)
    assert comm.deadline_s is None and comm.n_procs == 2
    # consensus rounds genuinely reduce through the wrapped group
    assert agree(comm, [3], "max")[0] == 3
    # ... and the watchdog arms once the knob is set
    monkeypatch.setenv("PCG_TPU_COLLECTIVE_DEADLINE_S", "7")
    s._group_comm = None
    assert s._collective_comm().deadline_s == 7.0


# ----------------------------------------------------------------------
# @rank: fault domain
# ----------------------------------------------------------------------

def test_rank_fault_parse_and_single_process_semantics():
    p = FaultPlan("kill@rank:0:1, exc@rank:0")
    assert p.armed
    # exc@rank:0 == exc@rank:0:0 -> fires on dispatch 0 of THIS process
    with pytest.raises(InjectedDispatchError):
        p.on_dispatch()
    # kill@rank:0:1 -> boundary 1 of this process
    p.at_boundary({"x": np.ones(2)})
    with pytest.raises(SimulatedKill):
        p.at_boundary({"x": np.ones(2)})
    assert [f["point"] for f in p.fired] == ["rank-dispatch",
                                             "rank-boundary"]


def test_rank_fault_cannot_land_past_process_count():
    # single-process run: rank 1 does not exist -> the fault neither
    # fires nor is consumed/recorded (cannot-land contract)
    p = FaultPlan("kill@rank:1:0, nan@rank:1:0")
    carry = {"r": np.ones(3), "x": np.ones(3)}
    out = p.at_boundary(carry)
    assert np.all(np.isfinite(out["r"]))
    assert p.fired == []
    assert p._rank_faults["kill"] == {(1, 0): 1}     # still pending


def test_rank_fault_bad_specs_rejected():
    with pytest.raises(ValueError):
        FaultPlan("kill@rank:-1:2")
    with pytest.raises(ValueError):
        FaultPlan("kill@rank:")


# ----------------------------------------------------------------------
# Group-consistent snapshot epochs (two-phase commit)
# ----------------------------------------------------------------------

_FP2 = {"n_procs": 2, "tol": 1e-8}


def _pair_stores(path, fingerprint=None, recorder=None):
    fp = dict(_FP2 if fingerprint is None else fingerprint)
    mk = lambda idx, rng: GroupSnapshotStore(
        str(path), dict(fp), comm=None, index=idx, n_shards=2,
        part_range=rng, n_parts=8, recorder=recorder)
    return mk(0, (0, 4)), mk(1, (4, 8))


def _state(seed):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((8, 3)), "rho": np.float64(seed),
            "it": np.int64(seed * 10)}


def _reader(path, fingerprint=None, elastic=False, recorder=None,
            n_shards=1):
    fp = dict(_FP2 if fingerprint is None else fingerprint)
    return GroupSnapshotStore(str(path), fp, comm=None, index=0,
                              n_shards=n_shards, part_range=(0, 8),
                              n_parts=8, recorder=recorder,
                              elastic=elastic)


def test_two_phase_commit_and_join(tmp_path):
    s0, s1 = _pair_stores(tmp_path)
    a = _state(1)
    s1.save(1, a)
    # rank 1 wrote its shard but only rank 0 publishes the marker: the
    # epoch is not committed yet and readers must not see it
    assert glob.glob(str(tmp_path / "snap_e*.p1.npz"))
    assert not glob.glob(str(tmp_path / "snap_COMMIT_*.json"))
    assert _reader(tmp_path).load(1) is None
    s0.save(1, a)
    (marker,) = glob.glob(str(tmp_path / "snap_COMMIT_*.json"))
    meta = json.loads(open(marker).read())
    assert meta["step"] == 1 and meta["n_shards"] == 2
    got = _reader(tmp_path).load(1)
    np.testing.assert_array_equal(got["x"], a["x"])    # re-joined rows
    assert got["rho"] == a["rho"] and got["it"] == a["it"]
    assert _reader(tmp_path).latest() == 1


def test_torn_epoch_falls_back_to_older_committed(tmp_path):
    s0, s1 = _pair_stores(tmp_path)
    a, b = _state(1), _state(2)
    s1.save(1, a)
    s0.save(1, a)       # epoch 0 committed
    s1.save(1, b)
    s0.save(1, b)       # epoch 1 committed
    # tear epoch 1: corrupt rank 1's shard after the fact (disk rot /
    # lost NFS write) -- the join must fall back to epoch 0, not mix
    shard = tmp_path / "snap_e000001.p1.npz"
    shard.write_bytes(b"not a zipfile")
    with pytest.warns(UserWarning, match="falling back"):
        got = _reader(tmp_path).load(1)
    np.testing.assert_array_equal(got["x"], a["x"])


def test_truncated_shard_set_falls_back(tmp_path):
    """A shard set that tiles contiguously from part 0 but
    ends SHORT of the marker's n_parts (e.g. leftover shards of a
    shrunk fleet matching an old marker's n_shards) must not restore a
    truncated global array — same named fallback as a torn epoch."""
    mk = lambda idx, rng: GroupSnapshotStore(
        str(tmp_path), dict(_FP2), comm=None, index=idx, n_shards=2,
        part_range=rng, n_parts=8)
    s0, s1 = mk(0, (0, 4)), mk(1, (4, 6))    # rows 6:8 never written
    a = _state(4)
    s1.save(1, a)
    s0.save(1, a)       # commits: every shard LANDED, but the set is short
    with pytest.warns(UserWarning, match="tile only 6 of 8 part rows"):
        assert _reader(tmp_path).load(1) is None


def test_uncommitted_save_stays_invisible(tmp_path):
    s0, s1 = _pair_stores(tmp_path)
    a = _state(1)
    s1.save(1, a)
    s0.save(1, a)       # epoch 0 committed
    b = _state(2)
    # rank 0 saves epoch 1 but the group min-agree reports a peer's
    # failed write: no marker may be published
    s0.comm = _ScriptedComm(script=[None, 0])
    s0.save(1, b)
    assert len(glob.glob(str(tmp_path / "snap_COMMIT_*.json"))) == 1
    got = _reader(tmp_path).load(1)
    np.testing.assert_array_equal(got["x"], a["x"])


def test_retention_prunes_committed_epochs_only(tmp_path, monkeypatch):
    """Retention is routed through the commit markers.  With staggered writes — rank 1 already saved the
    next epoch while rank 0 has not committed it yet — rank 1's prune
    must keep both the newest COMMITTED epoch (the group's only agreed
    resume point) and its own in-flight shard, so pruning can never
    make two ranks resolve different newest snapshots."""
    monkeypatch.setenv("PCG_TPU_SNAP_KEEP", "1")
    s0, s1 = _pair_stores(tmp_path)
    a, b = _state(1), _state(2)
    s1.save(1, a)
    s0.save(1, a)                           # epoch 0 committed
    s1.save(1, b)                           # staggered: epoch 1 in flight
    # rank 1's prune ran with keep=1 while epoch 1 is uncommitted: the
    # committed epoch 0 AND the in-flight epoch-1 shard both survive
    assert os.path.exists(tmp_path / "snap_e000000.p1.npz")
    assert os.path.exists(tmp_path / "snap_e000001.p1.npz")
    assert _reader(tmp_path).load(1) is not None
    s0.save(1, b)                           # epoch 1 commits; 0 prunable
    assert not glob.glob(str(tmp_path / "snap_e000000.*"))
    assert not os.path.exists(tmp_path / "snap_COMMIT_e000000.json")
    got = _reader(tmp_path).load(1)
    np.testing.assert_array_equal(got["x"], b["x"])


def test_elastic_reader_named_event_and_refusal(tmp_path):
    s0, s1 = _pair_stores(tmp_path)
    a = _state(3)
    s1.save(1, a)
    s0.save(1, a)
    # a 1-process reader of the 2-process epoch: refused by default ...
    with pytest.raises(ValueError, match="n_procs"):
        _reader(tmp_path, {"n_procs": 1, "tol": 1e-8}).load(1)
    # ... but the armed elastic path re-joins it and names the event
    cap = _Cap()
    rec = MetricsRecorder(sinks=[cap])
    got = _reader(tmp_path, {"n_procs": 1, "tol": 1e-8}, elastic=True,
                  recorder=rec).load(1)
    np.testing.assert_array_equal(got["x"], a["x"])
    (ev,) = _kinds(cap, "elastic_resume")
    assert ev["from_procs"] == 2 and ev["to_procs"] == 1
    assert rec.counters["resilience.elastic_resume"] == 1
    # elastic only forgives the process count, nothing else
    with pytest.raises(ValueError):
        _reader(tmp_path, {"n_procs": 1, "tol": 1e-6},
                elastic=True).load(1)


def test_discard_drops_markers_then_shards(tmp_path):
    s0, s1 = _pair_stores(tmp_path)
    s1.save(1, _state(1))
    s0.save(1, _state(1))
    s0.discard(1)
    assert not glob.glob(str(tmp_path / "snap_COMMIT_*.json"))
    assert not glob.glob(str(tmp_path / "snap_e*.npz"))


def test_new_event_kinds_in_schema():
    from pcg_mpi_solver_tpu_torch.obs.schema import EVENT_KINDS

    assert EVENT_KINDS["collective_timeout"] == ("label", "deadline_s",
                                                 "suspect")
    assert EVENT_KINDS["snapshot_epoch"] == ("epoch", "step", "shards",
                                             "committed")
    assert EVENT_KINDS["elastic_resume"] == ("from_procs", "to_procs",
                                             "prefix")


# ----------------------------------------------------------------------
# real 2-rank runs: the dead-peer drill and the elastic resume
# ----------------------------------------------------------------------

_CHILD_KILL = r"""
import time
import numpy as np
from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig, TimeHistoryConfig
from pcg_mpi_solver_tpu_torch.resilience import DeadPeerError, SimulatedKill
from pcg_mpi_solver_tpu_torch.solver import Solver

scratch = sys.argv[4]
cfg = RunConfig(scratch_path=scratch, run_id="ft", snapshot_every=1,
                flight_path=os.path.join(scratch, "flight.jsonl"),
                solver=SolverConfig(tol=1e-8, max_iter=500,
                                    iters_per_dispatch=12),
                time_history=TimeHistoryConfig(time_step_delta=[0.0, 1.0]))
s = Solver(make_mh_test_model("general"), cfg, mesh=mesh, n_parts=8,
           backend="general", device="cpu")
t0 = time.monotonic()
try:
    res = s.solve()[-1]
    print(f"RESULT {pid} outcome=done flag={res.flag}", flush=True)
    sys.exit(0)
except SimulatedKill:
    # abrupt death, no shutdown handshake: the survivor must find out
    print(f"RESULT {pid} outcome=killed t={time.time():.6f} "
          f"ckpt={cfg.checkpoint_path}", flush=True)
    os._exit(0)
except DeadPeerError as e:
    print(f"RESULT {pid} outcome=deadpeer t={time.time():.6f} "
          f"waited={time.monotonic() - t0:.1f} msg={str(e)!r}", flush=True)
    os._exit(0)
"""

DEADLINE_S = 5.0


def test_dead_peer_named_then_elastic_resume_two_to_one(tmp_path):
    """``kill@rank:1:3`` under a 5 s deadline: rank 1 dies at its third
    chunk boundary, after the group committed that boundary's snapshot
    epoch; rank 0 raises ``DeadPeerError`` naming process 1 within the
    deadline.  Then ``Solver.resume_elastic`` on ONE process re-joins the
    committed 2-rank epoch, names the process-count change as an
    ``elastic_resume`` event, and converges with the uninterrupted
    solve's flag (iterations within one: the resumed trips sum in
    one-process order)."""
    from pcg_mpi_solver_tpu_torch import (
        RunConfig, SolverConfig, TimeHistoryConfig)
    from pcg_mpi_solver_tpu_torch.solver import Solver

    scratch = tmp_path / "s"
    res = run_ranks(tmp_path, _CHILD_KILL, 2, [scratch], env={
        "PCG_TPU_COLLECTIVE_DEADLINE_S": str(DEADLINE_S),
        "PCG_TPU_FLIGHT_HEARTBEAT_S": "0.2",
        "PCG_TPU_FAULTS": "kill@rank:1:3"})
    by = {int(r.split()[1]): r for r in res}
    assert "outcome=killed" in by[1], res
    assert "outcome=deadpeer" in by[0], res
    assert "suspected dead peer: process 1" in by[0]
    # detection: rank 0's raise less rank 1's kill, on the host's clock
    t = {r: float(by[r].split("t=")[1].split()[0]) for r in by}
    assert t[0] - t[1] <= DEADLINE_S, (t, res)
    ckpt = by[1].split("ckpt=")[1].strip()
    assert glob.glob(os.path.join(ckpt, "snap_COMMIT_e*.json"))

    model = make_mh_test_model("general")

    def cfg(run_id, snap):
        return RunConfig(scratch_path=str(tmp_path / "local"),
                         run_id=run_id, snapshot_every=snap,
                         solver=SolverConfig(tol=1e-8, max_iter=500,
                                             iters_per_dispatch=12),
                         time_history=TimeHistoryConfig(
                             time_step_delta=[0.0, 1.0]))

    sref = Solver(model, cfg("ref", 0), n_parts=8, device="cpu")
    ref = sref.solve()[-1]
    assert ref.flag == 0
    cap = _Cap()
    rec = MetricsRecorder(sinks=[cap])
    sel = Solver(model, cfg("el1", 1), n_parts=8, device="cpu",
                 recorder=rec)
    got = sel.resume_elastic(ckpt)[-1]
    assert got.flag == ref.flag == 0
    assert rec.counters["resilience.elastic_resume"] >= 1
    evs = _kinds(cap, "elastic_resume")
    assert evs and evs[0]["from_procs"] == 2 and evs[0]["to_procs"] == 1
    assert any(e.get("op") == "restore"
               for e in _kinds(cap, "snapshot_epoch"))
    assert abs(got.iters - ref.iters) <= 1
    np.testing.assert_allclose(sel.displacement_global(),
                               sref.displacement_global(),
                               rtol=1e-4, atol=1e-8)

"""The port's convergence-trace ring, telemetry stream and flight recorder
against the JAX package's, on the CPU, on the small heterogeneous cube of
``tests/test_obs.py``.

Traces: the same system, solved by each package's ``pcg`` (direct
float64) or ``Solver.step`` (mixed).  Wherever the iteration counts are
equal, ``n_recorded``, ``truncated``, ``flag`` and ``stag`` are equal;
``normr`` and ``rho`` agree within rtol 1e-6 over the first ten records
(1e-4 for the mixed shell's float32 records: their dots alone part by
~1e-6, and the pipelined recurrences carry that to ~2e-5 in ten
records).  Over the whole trace the two float64 recurrences part in their
low bits (the f64 dots are summed in another order than XLA's) and the
difference compounds once the residual nears its plateau: the median
record is held within 0.05 decades and every record within 0.5 decades,
the band of the JAX package's own trace against its numpy reference
(``tests/test_obs.py``).  Mixed totals agree within max(3, 5 %),
ROADMAP's ground rule for float32 sums in another order, and the band
holds over the first inner cycle (the later cycles start where each
package's float32 stagnation exit left them).  Mixed fused and
pipelined run on the 16x6x6 cube of ``tests/test_torch_pcg_variants.py``
(pipelined stalls there in both packages): on the 4x3x3 cube their f32
stagnation exits part the totals by 7 % and 14 % (139 against 129, 211
against 181), in both directions, from summation order alone.
"""

import json
import os
import signal
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcg_mpi_solver_tpu.config import RunConfig as JaxRunConfig
from pcg_mpi_solver_tpu.config import SolverConfig as JaxSolverConfig
from pcg_mpi_solver_tpu.models.synthetic import make_cube_model as jax_cube
from pcg_mpi_solver_tpu.obs import flight as jax_flight
from pcg_mpi_solver_tpu.obs import trace as jax_trace
from pcg_mpi_solver_tpu.obs.metrics import summarize_jsonl as jax_summarize
from pcg_mpi_solver_tpu.obs.schema import \
    validate_jsonl_text as jax_validate
from pcg_mpi_solver_tpu.ops.precond import make_prec as jax_make_prec
from pcg_mpi_solver_tpu.parallel.mesh import make_mesh
from pcg_mpi_solver_tpu.parallel.structured import (
    StructuredOps as JaxStructuredOps, device_data_structured as jax_data,
    partition_structured as jax_partition)
from pcg_mpi_solver_tpu.solver.driver import Solver as JaxSolver
from pcg_mpi_solver_tpu.solver.pcg import pcg as jax_pcg
from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig
from pcg_mpi_solver_tpu_torch.models import make_cube_model
from pcg_mpi_solver_tpu_torch.obs import flight, trace
from pcg_mpi_solver_tpu_torch.obs.metrics import (
    JsonlSink, MetricsRecorder, summarize_jsonl)
from pcg_mpi_solver_tpu_torch.obs.schema import (
    EVENT_KINDS, validate_jsonl_text)
from pcg_mpi_solver_tpu_torch.ops.precond import make_prec
from pcg_mpi_solver_tpu_torch.parallel.structured import (
    StructuredOps, device_data_structured, partition_from_numpy)
from pcg_mpi_solver_tpu_torch.solver import Solver
from pcg_mpi_solver_tpu_torch.solver.pcg import pcg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUBE = dict(h=0.5, nu=0.3, load="traction", heterogeneous=True)
# the mixed cases' models: (cells, make_cube_model keywords)
MIXED_MODEL = {
    "classic": ((4, 3, 3), CUBE),
    **{v: ((16, 6, 6), dict(E=30e9, nu=0.2, heterogeneous=True, seed=5,
                            load="traction", load_value=1e6))
       for v in ("fused", "pipelined")}}
VARIANTS = ("classic", "fused", "pipelined")
TOL = 1e-8
MAX_ITER = 4000


@pytest.fixture(scope="module")
def system():
    """The cube's partition, both packages' operators in f64 and f32, and
    the lifted rhs built once (JAX) and fed to both."""
    import dataclasses

    spj = jax_partition(jax_cube(4, 3, 3, **CUBE), 1)
    sp = partition_from_numpy({f.name: getattr(spj, f.name)
                               for f in dataclasses.fields(spj)})
    j = {k: (JaxStructuredOps.from_partition(spj, dot_dtype=d),
             jax_data(spj, d))
         for k, d in (("64", jnp.float64), ("32", jnp.float32))}
    t = {k: (StructuredOps.from_partition(sp, dot_dtype=d),
             device_data_structured(sp, d, "cpu"))
         for k, d in (("64", torch.float64), ("32", torch.float32))}
    ops, dat = j["64"]
    fext = np.array(dat["eff"] * (dat["F"] - ops.matvec(dat, dat["Ud"])))
    return sp, j, t, fext


_TRACES = {}


def traces(system, mode, variant, length=MAX_ITER):
    """(JAX result, JAX trace, port result, port trace) of one solve from
    x0 = 0, cached for the module: direct through each package's ``pcg``
    on the one lifted rhs, mixed through each package's ``Solver.step``
    (its mixed inner cycles run each package's own operator setup)."""
    key = (mode, variant, length)
    if key in _TRACES:
        return _TRACES[key]
    sp, j, t, fext = system
    if mode == "direct":
        x0 = np.zeros_like(fext)
        kw = dict(tol=TOL, max_iter=MAX_ITER,
                  glob_n_dof_eff=sp.glob_n_dof_eff, variant=variant)
        jo, jd = j["64"]
        rj, trj = jax_pcg(jo, jd, jnp.asarray(fext), jnp.asarray(x0),
                          jax_make_prec(jo, jd, "jacobi"),
                          trace_in=jax_trace.trace_init(length, jnp.float64),
                          **kw)
        rj = (int(rj.flag), int(rj.iters))
        trj = jax_trace.unpack_trace(trj)
        to, td = t["64"]
        ring = trace.trace_init(length, torch.float64)
        rt = pcg(to, td, torch.from_numpy(fext), torch.from_numpy(x0),
                 make_prec(to, td, "jacobi"), trace_in=ring, **kw)
        rt, trt = (rt.flag, rt.iters), trace.unpack_trace(ring)
    else:
        sc = dict(tol=TOL, max_iter=MAX_ITER, trace_resid=length,
                  precision_mode="mixed", pcg_variant=variant)
        cells, kw = MIXED_MODEL[variant]
        js = JaxSolver(jax_cube(*cells, **kw),
                       JaxRunConfig(solver=JaxSolverConfig(**sc)),
                       mesh=make_mesh(1), n_parts=1)
        r = js.step(1.0)
        rj, trj = (r.flag, r.iters), js.last_trace
        s = Solver(make_cube_model(*cells, **kw),
                   RunConfig(solver=SolverConfig(**sc)), device="cpu")
        r = s.step(1.0)
        rt, trt = (r.flag, r.iters), s.last_trace
    _TRACES[key] = (rj, trj, rt, trt)
    return _TRACES[key]


# ------------------------------------------------------------------ the ring
@pytest.mark.parametrize("length,max_iter", [(100, 50), (10, 50), (0, 50),
                                             (5, 0)])
def test_clamp_trace_len_matches_jax(length, max_iter):
    assert trace.clamp_trace_len(length, max_iter) == \
        jax_trace.clamp_trace_len(length, max_iter)


@pytest.mark.parametrize("length,n,scale", [(8, 5, None), (4, 7, None),
                                            (2, 1, 8.0), (1, 3, 2.0)])
def test_ring_unpacks_as_jax(length, n, scale):
    """The same records into both rings unpack to the same trace: order,
    wrap, truncation, the scale rescaling, the float32 cast."""
    jt = jax_trace.trace_init(length, jnp.float32)
    pt = trace.trace_init(length, torch.float32)
    for i in range(1, n + 1):
        nr = np.float32(0.1 * i)
        jt = jax_trace.trace_record(
            jt, normr=jnp.asarray(nr), rho=jnp.asarray(np.float32(3.0 * i)),
            stag=jnp.asarray(i % 3, jnp.int32),
            flag=jnp.asarray(1, jnp.int32),
            scale=None if scale is None else jnp.asarray(scale))
        trace.trace_record(pt, normr=nr, rho=np.float32(3.0 * i),
                           stag=i % 3, flag=1, scale=scale)
    a, b = jax_trace.unpack_trace(jt), trace.unpack_trace(pt)
    assert (a.n_recorded, a.truncated) == (b.n_recorded, b.truncated)
    for f in trace.TRACE_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.to_event_fields(3) == b.to_event_fields(3)


# ------------------------------------------------------------ trace parity
@pytest.mark.parametrize("mode", ["direct", "mixed"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_trace_parity_with_jax(system, mode, variant):
    (jflag, jiters), a, (tflag, titers), b = traces(system, mode, variant)
    assert jflag == tflag and a.flag[-1] == b.flag[-1]
    assert not a.truncated and not b.truncated
    assert (a.n_recorded, b.n_recorded) == (jiters, titers)
    n = min(a.n_recorded, b.n_recorded)
    if mode == "mixed":
        # float32 sums in another order: totals within max(3, 5 %)
        assert abs(jiters - titers) <= max(3, 0.05 * jiters)
        assert a.normr.dtype == b.normr.dtype == np.float32
        # the band over the first inner cycle: up to either side's first
        # record with an exit flag
        n = min(int(np.argmax(t.flag != 1)) + 1 for t in (a, b))
    else:
        assert jflag == 0 and a.flag[-1] == 0
    if jiters == titers:
        np.testing.assert_array_equal(a.flag, b.flag)
        np.testing.assert_array_equal(a.stag, b.stag)
    # float32 dots summed in another order part by ~1e-6 on their own,
    # and the pipelined recurrences carry it to ~2e-5 within ten records
    rtol = 1e-6 if mode == "direct" else 1e-4
    np.testing.assert_allclose(b.normr[:10], a.normr[:10], rtol=rtol)
    np.testing.assert_allclose(b.rho[:10], a.rho[:10], rtol=rtol)
    dev = np.abs(np.log10(b.normr[:n] / a.normr[:n]))
    assert np.median(dev) <= 0.05 and dev.max() <= 0.5, dev


@pytest.mark.parametrize("variant", VARIANTS)
def test_short_ring_wraps_as_jax(system, variant):
    """A ring shorter than the solve keeps the last records in order, as
    the JAX package's does: both packages' short rings are their full
    traces' tails, bit for bit."""
    length = 7
    _rj, a_full, _rt, b_full = traces(system, "direct", variant)
    _rj, a, _rt, b = traces(system, "direct", variant, length)
    for full, short in ((a_full, a), (b_full, b)):
        assert short.truncated and short.n_recorded == full.n_recorded
        for f in trace.TRACE_FIELDS:
            np.testing.assert_array_equal(getattr(short, f),
                                          getattr(full, f)[-length:])


# ------------------------------------------------- the dispatch and the ring
def _port_solver(tmp_path=None, **sc):
    run = {}
    if tmp_path is not None:
        run = dict(telemetry_path=str(tmp_path / "run.jsonl"),
                   flight_path=str(tmp_path / "flight.jsonl"))
    cfg = RunConfig(solver=SolverConfig(**dict(dict(
        tol=TOL, max_iter=MAX_ITER), **sc)), **run)
    return Solver(make_cube_model(4, 3, 3, **CUBE), cfg, device="cpu")


@pytest.mark.parametrize("mode,variant", [
    ("direct", "classic"), ("direct", "fused"), ("direct", "pipelined"),
    ("mixed", "classic")])
def test_chunked_trace_equals_one_shot(mode, variant):
    """The ring rides the capped dispatches (the engine owns it): a
    chunked solve's trace is its one-shot trace, bit for bit."""
    out = []
    for cap in (0, 20):
        s = _port_solver(precision_mode=mode, pcg_variant=variant,
                         trace_resid=MAX_ITER, iters_per_dispatch=cap)
        r = s.step(1.0)
        out.append((r, s.last_trace, len(s.dispatch_log)))
    (r0, t0, _), (r1, t1, n_disp) = out
    assert n_disp > 1 and r0.iters == r1.iters and r0.flag == r1.flag == 0
    assert t0.n_recorded == t1.n_recorded == r0.iters
    for f in trace.TRACE_FIELDS:
        np.testing.assert_array_equal(getattr(t0, f), getattr(t1, f))


@pytest.mark.parametrize("mode,cap", [("direct", 0), ("direct", 20),
                                      ("mixed", 0), ("mixed", 20)])
def test_ring_on_and_off_bitwise(mode, cap):
    """Tracing changes nothing of the solve: flag, iterations, relres and
    u are bitwise those of the untraced solve."""
    res = []
    for ring in (0, MAX_ITER):
        s = _port_solver(precision_mode=mode, trace_resid=ring,
                         iters_per_dispatch=cap)
        r = s.step(1.0)
        res.append((r, s.displacement_global(), s.last_trace))
    (ra, ua, ta), (rb, ub, tb) = res
    assert (ra.flag, ra.iters, ra.relres) == (rb.flag, rb.iters, rb.relres)
    np.testing.assert_array_equal(ua, ub)
    assert ta is None and tb.n_recorded == rb.iters


# -------------------------------------------------------------------- events
def test_event_kinds_are_jax_schema():
    from pcg_mpi_solver_tpu.obs.schema import EVENT_KINDS as JAX_KINDS

    assert EVENT_KINDS == JAX_KINDS


def test_solve_jsonl_passes_jax_schema(tmp_path):
    """Every event of a port solve's telemetry stream passes the JAX
    package's validator (and the port's); the stream holds the cost
    model, the preflight, the step, its residual trace and dispatches,
    and ends with the run summary."""
    s = _port_solver(tmp_path, precision_mode="mixed", trace_resid=64,
                     iters_per_dispatch=20)
    s.solve()
    s.recorder.close()
    text = (tmp_path / "run.jsonl").read_text()
    assert jax_validate(text) == [] and validate_jsonl_text(text) == []
    kinds = [json.loads(ln)["kind"] for ln in text.splitlines()]
    assert kinds[-1] == "run_summary"
    for k in ("cost_model", "preflight", "step", "resid_trace", "dispatch"):
        assert k in kinds, k
    rt = [json.loads(ln) for ln in text.splitlines()
          if '"resid_trace"' in ln][0]
    assert rt["truncated"] and rt["n_recorded"] == s.iters[0]
    assert len(rt["normr"]) == 64


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_summarize_jsonl_tables_agree(tmp_path, writer):
    """The two packages' offline summaries of one telemetry stream agree
    line for line, on a stream either package wrote."""
    if writer == "port":
        s = _port_solver(tmp_path, trace_resid=16, iters_per_dispatch=30)
        s.solve()
        s.recorder.close()
        paths = [tmp_path / "run.jsonl", tmp_path / "flight.jsonl"]
    else:
        cfg = JaxRunConfig(
            telemetry_path=str(tmp_path / "j.jsonl"),
            flight_path=str(tmp_path / "jf.jsonl"),
            solver=JaxSolverConfig(tol=TOL, max_iter=MAX_ITER,
                                   trace_resid=16, iters_per_dispatch=30))
        s = JaxSolver(jax_cube(4, 3, 3, **CUBE), cfg, mesh=make_mesh(1),
                      n_parts=1)
        s.solve()
        s.recorder.close()
        paths = [tmp_path / "j.jsonl", tmp_path / "jf.jsonl"]
    for p in paths:
        assert summarize_jsonl(str(p)) == jax_summarize(str(p))


# -------------------------------------------------------------------- flight
def _ev(op, name=None, seq=None, t=0.0, **kw):
    ev = {"schema": "pcg-tpu-telemetry/1", "t": t, "kind": "flight",
          "op": op, "mono": t}
    if name is not None:
        ev.update(name=name, seq=seq)
    ev.update(kw)
    return json.dumps(ev)


FLIGHT_CASES = {
    "clean": [_ev("meta", t=1.0), _ev("begin", "dispatch:cycle", 1, 2.0),
              _ev("end", "dispatch:cycle", 1, 3.0)],
    "failed": [_ev("begin", "dispatch:start", 1, 1.0),
               _ev("fail", "dispatch:start", 1, 2.0, error="E: x")],
    "died": [_ev("begin", "dispatch:cycle", 1, 1.0),
             _ev("heartbeat", t=6.0, in_flight=["dispatch:cycle"])],
    "expected_nested": [
        _ev("begin", "rung:big", 1, 1.0),
        _ev("begin", "dispatch:step", 2, 1.5),
        _ev("fail", "dispatch:step", 2, 2.0, error="OOM"),
        _ev("fail", "rung:big", 1, 2.5, error="OOM", expected=True)],
    "truncated_tail": [_ev("begin", "dispatch:cycle", 1, 1.0),
                       _ev("heartbeat", t=9.5,
                           in_flight=["dispatch:cycle"])[:48]],
    "not_flight": ['{"schema": "pcg-tpu-telemetry/1", "t": 1, '
                   '"kind": "step", "step": 1}', "", "garbage"],
}


@pytest.mark.parametrize("case", sorted(FLIGHT_CASES))
def test_flight_verdict_matches_jax(tmp_path, case):
    p = tmp_path / f"{case}.jsonl"
    p.write_text("\n".join(FLIGHT_CASES[case]) + "\n"
                 if case != "truncated_tail"
                 else "\n".join(FLIGHT_CASES[case]))
    assert flight.flight_verdict_path(str(p)) == \
        jax_flight.flight_verdict_path(str(p))
    assert flight.salvage_truncated_tail(str(p)) == \
        jax_flight.salvage_truncated_tail(str(p))
    assert flight.read_jsonl_tolerant(str(p)) == \
        jax_flight.read_jsonl_tolerant(str(p))


@pytest.mark.parametrize("align", [None, "collectives"])
def test_merge_shards_matches_jax(tmp_path, align):
    """Two process shards (one with a skewed clock and a cut last line)
    merge into the same stream and the same stats as the JAX package's;
    the merged flight verdict pairs brackets per shard."""
    paths = []
    for idx, skew in ((0, 0.0), (1, 5.0)):
        p = tmp_path / flight.shard_jsonl_path("run.jsonl", idx, 2)
        lines = []
        for k in range(3):
            lines.append(json.dumps({"schema": "pcg-tpu-telemetry/1",
                                     "t": 10.0 + k + skew,
                                     "kind": "dispatch", "name": "cycle",
                                     "wall_s": 0.1, "cold": k == 0}))
        lines.append(_ev("begin", "dispatch:cycle", 1, 14.0 + skew))
        text = "\n".join(lines) + ("\n" if idx == 0 else '\n{"t": 1')
        p.write_text(text)
        paths.append(str(p))
    out_p, out_j = str(tmp_path / "m.jsonl"), str(tmp_path / "mj.jsonl")
    sp = flight.merge_shards(paths, out_p, align=align)
    sj = jax_flight.merge_shards(paths, out_j, align=align)
    assert sp == sj
    assert open(out_p).read() == open(out_j).read()
    assert flight.flight_verdict_path(out_p)["in_flight"] == \
        ["dispatch:cycle", "dispatch:cycle"]


def test_shard_paths_and_find_shards_match_jax(tmp_path):
    for args in (("a/run.jsonl", 3, 4), ("run", 1, 2), ("run.jsonl", 0, 1)):
        assert flight.shard_jsonl_path(*args) == \
            jax_flight.shard_jsonl_path(*args)
    base = tmp_path / "run.jsonl"
    for name in ("run.jsonl", "run.p1.jsonl", "run.p0.jsonl", "runx.p2.jsonl"):
        (tmp_path / name).write_text("")
    assert flight.find_shards(str(base)) == jax_flight.find_shards(str(base))


def test_solver_flight_brackets_every_dispatch(tmp_path):
    """A chunked solve's flight file brackets every dispatch span and
    reads clean; a leftover file is ingested, named in a note and
    rotated to .prev."""
    (tmp_path / "flight.jsonl").write_text(
        _ev("begin", "dispatch:cycle", 1, 1.0) + "\n")
    s = _port_solver(tmp_path, iters_per_dispatch=20)
    s.solve()
    s.recorder.close()
    assert jax_flight.flight_verdict_path(
        str(tmp_path / "flight.jsonl.prev"))["verdict"] == "died"
    events, bad = flight.read_jsonl_tolerant(str(tmp_path / "flight.jsonl"))
    assert bad == 0 and events[0]["op"] == "meta"
    begins = [e["name"] for e in events if e["op"] == "begin"]
    stats = s.recorder.dispatch_stats()
    assert len(begins) == sum(d["calls"] for d in stats.values())
    assert "dispatch:cycle" in begins
    v = flight.flight_verdict_path(str(tmp_path / "flight.jsonl"))
    assert v["verdict"] == "clean" and not v["in_flight"]


def test_one_heartbeat_thread_across_brackets(tmp_path):
    """Brackets opened and closed in turn share one heartbeat thread,
    started by the first and ended by close (or by the recorder's
    collection); a bracket held open past the cadence gets heartbeats
    naming it, and no heartbeat names an empty set; the file reads
    clean in both packages."""
    import threading
    import time

    p = str(tmp_path / "hb.jsonl")

    def beating():
        return sum(t.name == f"flight-heartbeat {p}" and t.is_alive()
                   for t in threading.enumerate())

    fr = flight.FlightRecorder(p, heartbeat_s=0.05, fsync=False)
    assert beating() == 0
    for i in range(20):
        with fr.record(f"dispatch:{i}"):
            pass
        assert beating() == 1
    with fr.record("dispatch:long"):
        time.sleep(0.4)
    fr.close()
    deadline = time.time() + 10
    while beating() and time.time() < deadline:
        time.sleep(0.01)
    assert beating() == 0
    events, bad = flight.read_jsonl_tolerant(p)
    beats = [e for e in events if e["op"] == "heartbeat"]
    assert bad == 0 and all(len(e["in_flight"]) == 1 for e in beats)
    assert any(e["in_flight"] == ["dispatch:long"] for e in beats)
    for mod in (flight, jax_flight):
        assert mod.flight_verdict_path(p)["verdict"] == "clean"
    # an unclosed recorder's thread ends when the recorder is collected
    fr = flight.FlightRecorder(p, heartbeat_s=0.05, fsync=False)
    with fr.record("dispatch:again"):
        pass
    assert beating() == 1
    del fr
    deadline = time.time() + 10
    while beating() and time.time() < deadline:
        time.sleep(0.01)
    assert beating() == 0


_KILL_CHILD = """
import os, signal, sys
from pcg_mpi_solver_tpu_torch.obs.flight import FlightRecorder
fl = FlightRecorder(sys.argv[1], meta={"component": "solver"})
seq = fl.begin("dispatch:start")
fl.end(seq, "dispatch:start", wall_s=0.1)
fl.begin("dispatch:cycle", cold=True)
os.kill(os.getpid(), signal.SIGKILL)
"""


def test_killed_process_leaves_died_verdict(tmp_path, capsys):
    """A process killed inside a bracket leaves a file whose verdict, in
    both packages, is died, naming the dispatch in flight; the CLI's
    summary says so."""
    p = str(tmp_path / "killed.jsonl")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _KILL_CHILD, p], env=env,
                          timeout=120)
    assert proc.returncode == -signal.SIGKILL
    for mod in (flight, jax_flight):
        v = mod.flight_verdict_path(p)
        assert v["verdict"] == "died" and v["in_flight"] == [
            "dispatch:cycle"], v
    from pcg_mpi_solver_tpu_torch.cli import main

    main(["summary", p])
    out = capsys.readouterr().out
    assert "flight verdict: died" in out
    assert "in flight at death: dispatch:cycle" in out


def test_recorder_sinks_and_summary(tmp_path, capsys, monkeypatch):
    """The JSONL sink appends one object a line and survives reopening;
    the stderr sink is gated on PCG_TPU_VERBOSE per event; the summary
    table lists steps, dispatches, gauges and counters."""
    p = str(tmp_path / "r.jsonl")
    rec = MetricsRecorder.default(jsonl_path=p)
    monkeypatch.delenv("PCG_TPU_VERBOSE", raising=False)
    rec.note("quiet")
    monkeypatch.setenv("PCG_TPU_VERBOSE", "1")
    rec.note("loud")
    with rec.dispatch("cycle"):
        pass
    rec.event("step", step=1, flag=0, relres=1e-9, iters=7, wall_s=0.5)
    rec.gauge("g", 3)
    rec.inc("c", 2)
    snap = rec.emit_run_summary()
    rec.close()
    err = capsys.readouterr().err
    assert "loud" in err and "quiet" not in err
    MetricsRecorder(sinks=[JsonlSink(p)]).event("note", msg="again")
    lines = open(p).read().splitlines()
    assert len(lines) == 6 and jax_validate("\n".join(lines)) == []
    assert snap["counters"]["c"] == 2 and snap["dispatches"]["cycle"][
        "calls"] == 1
    table = rec.summary()
    for piece in ("cycle", "gauge g = 3", "counter c = 2", "1.000e-09"):
        assert piece in table


@pytest.mark.parametrize("mode,kill", [("direct", "kill@1"),
                                       ("mixed", "kill@0")])
def test_ring_resumes_from_a_snapshot(tmp_path, mode, kill):
    """The ring rides the chunked path's snapshots: a solve killed at a
    chunk boundary (mixed: its one refinement boundary) and resumed in a
    new Solver ends with the trace of the uninterrupted solve, bit for
    bit."""
    from pcg_mpi_solver_tpu_torch.resilience import FaultPlan, SimulatedKill

    def solver(run_id):
        return Solver(make_cube_model(4, 3, 3, **CUBE), RunConfig(
            scratch_path=str(tmp_path), run_id=run_id, snapshot_every=1,
            solver=SolverConfig(tol=TOL, max_iter=MAX_ITER,
                                precision_mode=mode, iters_per_dispatch=20,
                                trace_resid=MAX_ITER)), device="cpu")

    whole = solver("whole")
    whole.solve()
    killed = solver("killed")
    killed.fault_plan = FaultPlan(kill, recorder=killed.recorder)
    with pytest.raises(SimulatedKill):
        killed.solve()
    resumed = solver("killed")
    resumed.solve(resume=True)
    a, b = whole.last_trace, resumed.last_trace
    assert resumed.iters == whole.iters and b.n_recorded == a.n_recorded
    for f in trace.TRACE_FIELDS:
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))


@pytest.mark.parametrize("mode,exc", [("direct", "exc@1"),
                                      ("mixed", "exc@5")])
def test_ring_survives_a_redispatch(tmp_path, mode, exc):
    """A dispatch that fails once (after the first snapshot: mixed, in
    the second refinement cycle) is re-dispatched from the snapshot: the
    ring comes back with it, and the trace is the clean solve's, bit for
    bit."""
    from pcg_mpi_solver_tpu_torch.resilience import FaultPlan

    out = []
    for faults in (None, exc):
        s = Solver(make_cube_model(4, 3, 3, **CUBE), RunConfig(
            scratch_path=str(tmp_path), snapshot_every=1,
            solver=SolverConfig(tol=TOL, max_iter=MAX_ITER,
                                precision_mode=mode, iters_per_dispatch=20,
                                trace_resid=MAX_ITER)), device="cpu")
        if faults:
            s.fault_plan = FaultPlan(faults, recorder=s.recorder)
        s.solve()
        out.append((s.iters, s.last_trace, s.recorder.counters))
    (ia, a, _), (ib, b, counters) = out
    assert ia == ib and counters["resilience.recovery.redispatch"] == 1
    for f in trace.TRACE_FIELDS:
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))

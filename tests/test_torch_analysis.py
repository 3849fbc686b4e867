"""The port's contract lint (``pcg_mpi_solver_tpu_torch/analysis``), on
the CPU: every rule clean on the port's tree and firing on a seeded
violation, held to the JAX package's lint (its rule ids, its comm gauges
on the same model and partition, its verdicts on its own seeded
sources), the engine's semantics and exit codes.

The trip rules read one recording of a ten-program matrix by two gloo
ranks (a module fixture: one spawn, bounded by its timeout).
"""

import copy
import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from pcg_mpi_solver_tpu_torch.analysis import engine
from pcg_mpi_solver_tpu_torch.analysis import programs as ap
from pcg_mpi_solver_tpu_torch.analysis import rules_artifacts as rart
from pcg_mpi_solver_tpu_torch.analysis import rules_ast as rast
from pcg_mpi_solver_tpu_torch.analysis import rules_config as rcfg
from pcg_mpi_solver_tpu_torch.analysis import rules_trip as rtrip
from pcg_mpi_solver_tpu_torch.analysis.engine import Finding, apply_baseline
from pcg_mpi_solver_tpu_torch.config import PCG_VARIANTS

ROOT = Path(__file__).resolve().parents[1]

# the recorded matrix: every variant on one column and on a block of 8,
# the all-f32 program of both backends, a structured float64 program and
# a general mg program
SPECS = ([dict(backend="general", variant=v, nrhs=n, role="f64",
               precond="jacobi") for v in PCG_VARIANTS for n in (1, 8)]
         + [dict(backend="general", variant="classic", nrhs=1, role="f32",
                 precond="jacobi"),
            dict(backend="structured", variant="classic", nrhs=1,
                 role="f64", precond="jacobi"),
            dict(backend="structured", variant="classic", nrhs=1,
                 role="f32", precond="jacobi"),
            dict(backend="general", variant="classic", nrhs=1, role="f64",
                 precond="mg")])


@pytest.fixture(scope="module")
def progs():
    return ap.build_programs(device="cpu", specs=SPECS, timeout=300)


def _ctx(programs):
    ctx = engine.Context(fast=False, device="cpu")
    ctx.programs = lambda: programs
    return ctx


def _prog(programs, name, rank=0):
    return copy.deepcopy(next(p for p in programs
                              if p.name == name and p.rank == rank))


GEN_CLASSIC = "trip[general,classic,nrhs=1,f64]"
GEN_PIPE = "trip[general,pipelined,nrhs=1,f64]"


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

def test_rule_catalog_matches_jax():
    from pcg_mpi_solver_tpu.analysis import engine as jengine

    port = {r.id for r in engine.list_rules()}
    assert port == {r.id for r in jengine.list_rules()}
    assert port == set(engine.RULES) and len(port) == 15


@pytest.mark.parametrize("variant", PCG_VARIANTS)
def test_comm_estimate_matches_jax(variant):
    """The comm.* gauges: the same dict as the JAX package's
    Ops.comm_estimate on the same model and 2-part partition."""
    import jax.numpy as jnp

    from pcg_mpi_solver_tpu.models.synthetic import make_cube_model as jm
    from pcg_mpi_solver_tpu.ops.matvec import Ops as JOps
    from pcg_mpi_solver_tpu.parallel.partition import partition_model as jp
    from pcg_mpi_solver_tpu_torch.models import make_cube_model
    from pcg_mpi_solver_tpu_torch.ops.matvec import Ops
    from pcg_mpi_solver_tpu_torch.parallel.partition import partition_model

    jpm, pm = jp(jm(3, 3, 3), 2), partition_model(make_cube_model(3, 3, 3), 2)
    assert pm.n_iface == jpm.n_iface > 0
    jops = dataclasses.replace(JOps.from_model(jpm), mg_coarse_dofs=81)
    ops = dataclasses.replace(Ops.from_model(pm), mg_coarse_dofs=81)
    for precond in ("jacobi", "block3", "mg"):
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.float64, torch.float64)):
            assert ops.comm_estimate(tdt, variant, precond) == \
                jops.comm_estimate(jdt, variant, precond)
    with pytest.raises(KeyError):
        ops.comm_estimate(variant="frobnicate")


def test_trip_budgets_match_the_gauges_and_jax_body():
    """Two ranks: an iterate trip's all-reduces are the gauge's
    psums_per_iter; the blocked check trip is the JAX package's body
    budget; a one-process budget is all zeros."""
    from pcg_mpi_solver_tpu.ops.matvec import Ops as JOps
    from pcg_mpi_solver_tpu_torch.ops.matvec import Ops, trip_shape

    two = types.SimpleNamespace(world=2, rank=0)
    ops = Ops(n_loc=8, n_iface=4, group=two)
    jops = JOps(n_loc=8, n_iface=4, axis_name="parts")
    for variant in PCG_VARIANTS:
        for precond in ("jacobi", "mg"):
            gauge = ops.comm_estimate(variant=variant, precond=precond)
            it = ops.trip_collective_budget(variant, precond)
            assert it["all_reduce"] == gauge["psums_per_iter"]
            body = ops.body_collective_budget(variant, precond)
            assert body["all_reduce"] == \
                jops.body_collective_budget(variant, precond)["psum"]
            assert it == ops.trip_collective_budget(variant, precond,
                                                    blocked=True)
    assert Ops(n_loc=8, n_iface=4).trip_collective_budget("classic") == \
        {"all_reduce": 0, "halo": 0, "halo_msgs": 0}
    with pytest.raises(KeyError):
        trip_shape("classic", "prime")


# ---------------------------------------------------------------------------
# collective-budget
# ---------------------------------------------------------------------------

def test_collective_budget_clean_on_the_recorded_matrix(progs):
    ctx = _ctx(progs)
    assert rtrip.collective_budget_rule(ctx) == []
    assert ctx.counts["collective-budget"]["programs"] == 2 * len(SPECS)
    p = _prog(progs, GEN_CLASSIC)
    assert p.trips["iterate"].counts()["all_reduce"] == 4
    assert p.trips["check"].counts()["all_reduce"] == 2
    s = _prog(progs, "trip[structured,classic,nrhs=1,f32]")
    c = s.trips["iterate"].counts()
    assert (c["all_reduce"], c["halo"], c["halo_msgs"]) == (3, 1, 1)


def _extra(op, **n):
    return {"op": op, "in": [], "out": [], "dt": ["float64"], "sh": [[1]],
            "sc": ["pcg/reduce"], "n": n}


@pytest.mark.parametrize("seed", ["extra_all_reduce", "undercounted_budget",
                                  "undeclared_kind", "width_dependent"])
def test_collective_budget_fires_on_seeded_violations(progs, seed):
    p = _prog(progs, GEN_CLASSIC)
    if seed == "extra_all_reduce":
        p.trips["iterate"].ops.append(_extra("dist.all_reduce",
                                             all_reduce=1))
        found = rtrip.check_collective_budget(p)
        assert found and "'all_reduce': 5" in found[0].message
    elif seed == "undercounted_budget":
        p.budgets["iterate"]["all_reduce"] += 1
        assert rtrip.check_collective_budget(p)
    elif seed == "undeclared_kind":
        p.trips["check"].ops.append(_extra("dist.all_gather",
                                           all_gather=1))
        found = rtrip.check_collective_budget(p)
        assert found and "all_gather" in found[0].message
    else:
        wide = _prog(progs, "trip[general,classic,nrhs=8,f64]")
        wide.budgets["iterate"]["all_reduce"] += 1
        found = rtrip.check_width_independence([p, wide])
        assert found and "block width" in found[0].message


# ---------------------------------------------------------------------------
# psum-overlap
# ---------------------------------------------------------------------------

def test_psum_overlap_proves_pipelined_and_serialises_the_others(progs):
    ctx = _ctx(progs)
    assert rtrip.psum_overlap_rule(ctx) == []
    pipe = rtrip.reduction_dependence(_prog(progs, GEN_PIPE)
                                      .trips["iterate"])
    assert len(pipe) == 1 and not pipe[0]["reads_matvec"] \
        and not pipe[0]["feeds_matvec"] and pipe[0]["size"] == 6
    classic = rtrip.reduction_dependence(_prog(progs, GEN_CLASSIC)
                                         .trips["iterate"])
    assert [r["feeds_matvec"] or r["reads_matvec"] for r in classic] == \
        [True, True, True]
    fused = rtrip.reduction_dependence(
        _prog(progs, "trip[general,fused,nrhs=8,f64]").trips["iterate"])
    assert len(fused) == 1 and fused[0]["reads_matvec"]


def _matvec_out(trip):
    return next(s for o in trip.ops if "pcg/matvec" in o.get("sc", ())
                for s in o["out"])


@pytest.mark.parametrize("direction", ["reads", "feeds", "lost_edges"])
def test_psum_overlap_fires_on_seeded_violations(progs, direction):
    if direction == "lost_edges":
        # a walker that lost its edges: classic's reductions would look
        # independent, and the negative control reports it
        p = _prog(progs, GEN_CLASSIC)
        for o in p.trips["iterate"].ops:
            if o["op"] != "range":
                o["in"] = []
        found = rtrip.check_psum_overlap(p)
        assert found and "lost edges" in found[0].message
        return
    p = _prog(progs, GEN_PIPE)
    trip = p.trips["iterate"]
    red = next(o for o in trip.ops if o["op"] == "dist.all_reduce"
               and "pcg/reduce" in o["sc"])
    if direction == "reads":
        # the reduction reads what the matvec wrote (fused's order)
        idx = trip.ops.index(red)
        mv = _matvec_out(trip)
        trip.ops.insert(idx, trip.ops.pop(next(
            i for i, o in enumerate(trip.ops)
            if "pcg/matvec" in o.get("sc", ()) and o["out"])))
        red["in"] = red["in"] + [mv]
    else:
        # the matvec consumes the reduction's result (classic's order)
        mv_op = next(o for o in trip.ops if "pcg/matvec" in o.get("sc", ())
                     and o["op"] != "range")
        mv_op["in"] = mv_op["in"] + red["out"]
    found = rtrip.check_psum_overlap(p)
    assert found and "serialised" in found[0].message


# ---------------------------------------------------------------------------
# scope-labels
# ---------------------------------------------------------------------------

def test_scope_labels_clean_scalar_and_blocked(progs):
    assert rtrip.scope_labels_rule(_ctx(progs)) == []
    for name in (GEN_CLASSIC, "trip[general,pipelined,nrhs=8,f64]"):
        labels = _prog(progs, name).trips["iterate"].labels()
        assert {"pcg/matvec", "pcg/precond", "pcg/reduce",
                "pcg/axpy"} <= set(labels)


@pytest.mark.parametrize("seed", ["missing_label", "unknown_label",
                                  "parser_drops"])
def test_scope_labels_fire_on_seeded_violations(progs, seed):
    from pcg_mpi_solver_tpu_torch.obs.profview import PHASE_SCOPES

    p = _prog(progs, GEN_CLASSIC)
    if seed == "missing_label":
        found = rtrip.check_scope_labels(
            p, phase_scopes=dict(PHASE_SCOPES, **{"pcg/halo": "matvec"}))
        assert found and "pcg/halo" in found[0].message
    elif seed == "unknown_label":
        p.trips["iterate"].ops.append({"op": "range", "label": "pcg/ghost"})
        found = rtrip.check_scope_labels(p)
        assert found and "pcg/ghost" in found[0].message
    else:
        def drops(ops):
            return {"phases": {}, "other_us": 0.0, "other_events": 0,
                    "unknown_scopes": {}}

        assert len(rtrip.check_unknown_label_loudness(drops)) == 2
        assert rtrip.check_unknown_label_loudness() == []


# ---------------------------------------------------------------------------
# hot-loop-purity and dtype-discipline
# ---------------------------------------------------------------------------

def test_hot_loop_purity_clean(progs):
    assert rtrip.hot_loop_purity_rule(_ctx(progs)) == []
    pipe = _prog(progs, GEN_PIPE)
    assert pipe.trips["prime"].counts()["host_reads"] == 0
    assert pipe.trips["iterate"].counts()["host_reads"] == 1


def test_hot_loop_purity_fires_on_an_injected_read():
    """The seeded violation of chip_smoke.py phase 4o, on the CPU: one
    more ``_read`` a trip through the recorder's probe hook."""
    s = ap.build_solver("general", device="cpu", n_parts=1)
    spec = dict(backend="general", variant="classic", nrhs=1, role="f64",
                precond="jacobi")
    p = ap.record_program(s, spec, inject_read=True)
    found = rtrip.check_hot_loop_purity(p)
    assert found and "2 host reads" in found[0].message
    assert rtrip.check_hot_loop_purity(ap.record_program(s, spec)) == []


def test_hot_loop_purity_fires_on_an_upload(progs):
    p = _prog(progs, GEN_CLASSIC)
    p.trips["iterate"].ops.append(dict(_extra("aten.lift_fresh.default",
                                              uploads=1), up=5000))
    found = rtrip.check_hot_loop_purity(p)
    assert found and "5000" in found[0].message


def test_dtype_discipline_clean_and_fires_on_f64_leak(progs):
    ctx = _ctx(progs)
    assert rtrip.dtype_discipline_rule(ctx) == []
    assert ctx.counts["dtype-discipline"]["programs"] == 4
    p = _prog(progs, "trip[general,classic,nrhs=1,f32]")
    p.trips["iterate"].ops.append(_extra("aten.mul.Tensor", f64_ops=1))
    found = rtrip.check_dtype_discipline(p)
    assert found and "aten.mul.Tensor" in found[0].message
    # float64 programs are out of scope
    assert rtrip.check_dtype_discipline(_prog(progs, GEN_CLASSIC)) == []


# ---------------------------------------------------------------------------
# donation-integrity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("surface", ap.DONATION_SURFACES)
def test_donation_clean_and_fires_on_a_copied_carry(surface):
    calls = ap.donation_calls(surface)
    assert ap.check_donation(surface, calls) == []
    assert ap.donation_pairs(calls) > 0
    copied = ap.donation_calls(surface, copy_carry=True)
    found = ap.check_donation(surface, copied)
    assert found and "was copied" in found[0]


# ---------------------------------------------------------------------------
# fingerprint-completeness, partition keys, cost model
# ---------------------------------------------------------------------------

def test_fingerprint_completeness_clean_and_fires_on_omitted_field():
    fields = ["pcg_variant", "tol", "donate_carry"]
    assert rcfg.check_fingerprint_completeness(fields=fields) == []
    from pcg_mpi_solver_tpu_torch.utils.checkpoint import _fingerprint

    def fp_without_variant(s):
        d = dict(_fingerprint(s))
        d.pop("pcg_variant")
        return d

    found = rcfg.check_fingerprint_completeness(
        fields=["pcg_variant"], fp_fn=fp_without_variant)
    assert [f.loc for f in found] == ["field:SolverConfig.pcg_variant"]


def test_runconfig_fields_all_classified(monkeypatch):
    assert rcfg.check_runconfig_classified() == []
    monkeypatch.setattr(rcfg, "TRACE_NEUTRAL_RUNCONFIG",
                        rcfg.TRACE_NEUTRAL_RUNCONFIG - {"cache_dir"})
    found = rcfg.check_runconfig_classified()
    assert [f.loc for f in found] == ["field:RunConfig.cache_dir"]


def test_partition_key_components_clean_and_seeded():
    from pcg_mpi_solver_tpu_torch.cache import keys as ckeys

    assert rcfg.check_partition_key_components() == []

    def no_part_idx(fp, **kw):
        kw.pop("part_idx")
        return ckeys.partition_cache_key(fp, **kw)

    found = rcfg.check_partition_key_components(shard_key_fn=no_part_idx)
    assert "field:partition_shard_key.part_idx" in [f.loc for f in found]
    assert "probe:part_idx-range" in [f.loc for f in found]

    def no_code(fp, **kw):
        return json.dumps([fp, sorted(kw.items(), key=repr)], default=repr)

    found = rcfg.check_partition_key_components(shard_key_fn=no_code)
    assert "field:code_hash" in [f.loc for f in found]


def test_cost_model_completeness_clean_and_seeded():
    from pcg_mpi_solver_tpu_torch.obs import perf

    assert rcfg.check_cost_model_completeness() == []
    shape = perf.ProblemShape(n_dof=10_000, n_parts=4, n_iface=500,
                              elem_groups=((24, 3_000),))

    def real(v, p, r):
        return perf.cost_model(shape, v, p, r)

    def missing(v, p, r):
        if (v, p) == ("pipelined", "mg"):
            raise KeyError(p)
        return real(v, p, r)

    def zero(v, p, r):
        return {**real(v, p, r), "predicted_ms_per_iter": 0.0}

    def silent(v, p, r):
        try:
            return real(v, p, r)
        except KeyError:
            return real("classic", "jacobi", r)

    assert any("no entry" in f.message for f in
               rcfg.check_cost_model_completeness(model_fn=missing))
    assert any("degenerate" in f.message for f in
               rcfg.check_cost_model_completeness(model_fn=zero))
    assert {f.loc for f in rcfg.check_cost_model_completeness(
        model_fn=silent)} == {"probe:unknown-variant",
                              "probe:unknown-precond"}


# ---------------------------------------------------------------------------
# the AST rules: clean, seeded, and the JAX package's seeds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rule_fn", [
    rast.recovery_paths_rule, rast.recovery_coverage_rule,
    rast.consensus_coverage_rule, rast.serve_admission_events_rule])
def test_ast_rules_clean_on_the_port(rule_fn):
    ctx = _ctx([])
    assert rule_fn(ctx) == []
    assert ctx.counts and all(ctx.counts[next(iter(ctx.counts))].values())


BROAD_SEEDS = {
    "swallowed": "try:\n    f()\nexcept Exception:\n    pass\n",
    "reraised": "try:\n    f()\nexcept Exception:\n    raise\n",
    "recorded": "try:\n    f()\nexcept BaseException as e:\n"
                "    rec.event('x', err=str(e))\n",
    "justified": "try:\n    f()\nexcept Exception:  # noqa: BLE001\n"
                 "    pass\n",
    "bare": "try:\n    f()\nexcept:\n    x = 1\n",
    "narrow": "try:\n    f()\nexcept OSError:\n    pass\n",
}


@pytest.mark.parametrize("name", sorted(BROAD_SEEDS))
def test_recovery_paths_same_verdict_as_jax(name):
    from pcg_mpi_solver_tpu.analysis.rules_ast import check_source as jcheck

    src = BROAD_SEEDS[name]
    assert rast.check_source(src) == jcheck(src)
    assert bool(rast.check_source(src)) == (name in ("swallowed", "bare"))


def _locs(errs):
    return sorted(e.partition(": ")[0] for e in errs)


def _recovery_jax_seeds():
    rel = "pcg_mpi_solver_tpu/solver/driver.py"
    src = (
        "class Solver:\n"
        "    def step(self):\n"
        "        # recovery-exempt: test stub\n"
        "        self._step_fn()\n"
        "    def _step_chunked(self):\n"
        "        run_with_recovery()\n"
        "    def _solve_many_chunked(self):\n"
        "        run_many_with_recovery()\n"
        "    def solve_many(self):\n"
        "        return self._dispatch_with_retry('solve_many', f)\n"
        "    def sneaky_new_path(self):\n"
        "        with self._rec.dispatch('many_cycle'):\n"
        "            pass\n")
    return rel, [src, src.replace("run_with_recovery()", "pass"),
                 src.replace("        # recovery-exempt: test stub\n", ""),
                 "x = 1\n"]


def test_recovery_coverage_same_verdicts_as_jax():
    from pcg_mpi_solver_tpu.analysis import rules_ast as jast

    rel, seeds = _recovery_jax_seeds()
    for src in seeds:
        want = jast.check_recovery_coverage({rel: src})
        got = rast.check_recovery_coverage(
            {rel: src}, surfaces=jast.RECOVERY_SURFACES,
            oneshot=frozenset({"_step_fn"}))
        assert want and _locs(got) == _locs(want)


def test_recovery_coverage_seeded_on_port_names():
    rel = "pcg_mpi_solver_tpu_torch/solver/driver.py"
    path = ROOT / rel
    src = path.read_text()
    assert rast.check_recovery_coverage({rel: src}) == []
    errs = rast.check_recovery_coverage(
        {rel: src.replace("# recovery-exempt:", "# exempt:")})
    assert any("`step`" in e and "recovery-exempt" in e for e in errs)
    errs = rast.check_recovery_coverage(
        {rel: src + "\n\ndef sneaky(rec):\n"
                    "    with rec.dispatch('cycle'):\n        pass\n"})
    assert any("sneaky" in e and "not registered" in e for e in errs)


def _consensus_jax_seeds():
    rel = "pcg_mpi_solver_tpu/solver/driver.py"
    src = (
        "def _pallas_enabled():\n"
        "    # consensus-exempt: test stub\n"
        "    return process_allgather(x)\n"
        "class Solver:\n"
        "    def __init__(self):\n"
        "        ok = agree_flag(comm, ok)\n"
        "    def _exchange_export_glue(self):\n"
        "        # consensus-exempt: test stub\n"
        "        mh.process_allgather(i)\n"
        "    def solve(self):\n"
        "        # consensus-exempt: test stub\n"
        "        multihost_utils.sync_global_devices('prepared')\n"
        "    def warm_compile(self):\n"
        "        self.engine.warmup()\n"
        "    def sneaky_branch(self):\n"
        "        if comm.allreduce(v, 'min'):\n"
        "            pass\n")
    return rel, [src, src.replace("ok = agree_flag(comm, ok)", "pass"),
                 src.replace("        # consensus-exempt: test stub\n"
                             "        multihost_utils.sync_global_devices("
                             "'prepared')\n",
                             "        multihost_utils.sync_global_devices("
                             "'prepared')\n"), "x = 1\n"]


def test_consensus_coverage_same_verdicts_as_jax():
    from pcg_mpi_solver_tpu.analysis import rules_ast as jast

    rel, seeds = _consensus_jax_seeds()
    for src in seeds:
        want = jast.check_consensus_coverage({rel: src})
        got = rast.check_consensus_coverage(
            {rel: src}, sites=jast.CONSENSUS_SITES,
            call_names=jast.COLLECTIVE_CALL_NAMES)
        assert want and _locs(got) == _locs(want)


def test_consensus_coverage_seeded_on_port_names():
    rel = "pcg_mpi_solver_tpu_torch/solver/chunked.py"
    src = (ROOT / rel).read_text()
    assert rast.check_consensus_coverage({rel: src}) == []
    errs = rast.check_consensus_coverage(
        {rel: src.replace("resilience.sync_boundary()", "pass")})
    assert any("_run_direct" in e and "sync_boundary" in e for e in errs)
    errs = rast.check_consensus_coverage(
        {rel: src + "\n\ndef sneaky(group):\n    group.barrier()\n"})
    assert any("sneaky" in e and "not registered" in e for e in errs)


def test_serve_admission_events_same_verdicts_as_jax():
    from pcg_mpi_solver_tpu.analysis import rules_ast as jast
    from pcg_mpi_solver_tpu.obs.schema import EVENT_KINDS as JKINDS

    rel = "pcg_mpi_solver_tpu/serve/admission.py"
    src = (
        "class AdmissionController:\n"
        "    def admit(self, spec, now=None):\n"
        "        self._rec.event('job_admit', job=spec['job'])\n"
        "    def _reject(self, job, reason, **fields):\n"
        "        self._rec.event('job_reject', job=job, reason=reason)\n"
        "    def shed_past_deadline(self, now=None):\n"
        "        self._rec.event('job_shed', job='x', reason='r')\n")
    seeds = [src,
             src.replace("        self._rec.event('job_shed', job='x', "
                         "reason='r')\n", "        pass\n"),
             src.replace("def admit", "def admit_renamed"),
             src.replace("'job_admit'", "'job_done'")]
    for seed in seeds:
        want = jast.check_admission_events({rel: seed})
        got = rast.check_admission_events(
            {rel: seed}, sites=jast.ADMISSION_EVENT_SITES,
            kinds_known=JKINDS)
        assert _locs(got) == _locs(want)
    # on the port's names: a site that stops emitting goes silent
    prel = "pcg_mpi_solver_tpu_torch/serve/admission.py"
    psrc = (ROOT / prel).read_text()
    assert rast.check_admission_events({prel: psrc}) == []
    errs = rast.check_admission_events(
        {prel: psrc.replace('"job_shed"', '"job_gone"')})
    assert any("shed_past_deadline" in e and "`job_shed`" in e
               for e in errs)


# ---------------------------------------------------------------------------
# the artifact rules
# ---------------------------------------------------------------------------

def test_telemetry_schema_clean_and_seeded(tmp_path):
    ctx = _ctx([])
    assert rart.telemetry_schema_rule(ctx) == []
    assert ctx.counts["telemetry-schema"]["telemetry events"] > 0
    line = json.dumps({"schema": "pcg-tpu-telemetry/1", "t": 1.0,
                       "kind": "step", "step": 1})
    assert any("missing required field" in e
               for e in rart.check_jsonl_text(line))
    bad = tmp_path / "BENCH_bad.json"
    bad.write_text("[1, 2]")
    assert rart.check_bench_file(str(bad))
    assert rart.check_bench_file(str(ROOT / "BENCH_r05.json")) == []


def test_doc_schema_sync_clean_and_seeded():
    from pcg_mpi_solver_tpu.obs.schema import EVENT_KINDS as JKINDS
    from pcg_mpi_solver_tpu_torch.obs.schema import EVENT_KINDS

    assert set(EVENT_KINDS) == set(JKINDS) and len(EVENT_KINDS) == 37
    assert rart.doc_schema_sync_rule(_ctx([])) == []
    doc = (ROOT / "docs" / "OBSERVABILITY.md").read_text()
    cut = "\n".join(ln for ln in doc.splitlines()
                    if not ln.startswith("| `job_shed`"))
    errs = rart.check_doc_schema_sync(cut)
    assert len(errs) == 1 and "job_shed" in errs[0]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def test_fast_lint_clean_on_the_recorded_matrix(progs, monkeypatch):
    monkeypatch.setattr(engine.Context, "programs", lambda self: progs)
    report = engine.run_lint(fast=True, device="cpu")
    assert report.errors == []
    assert report.findings == [], "\n".join(map(str, report.findings))
    assert report.exit_code == 0 and len(report.rules_run) == 12
    assert all(report.checked[r] and all(report.checked[r].values())
               for r in report.rules_run)


def test_collectives_api(progs, monkeypatch):
    from pcg_mpi_solver_tpu_torch.analysis import collectives

    monkeypatch.setattr(collectives, "_programs",
                        lambda nrhs_set=(1, 8), device="cpu":
                        [p for p in progs if p.rank == 0])
    assert collectives.run_checks() == []
    assert collectives.EXPECTED_BODY_PSUMS == {"classic": 5, "fused": 3,
                                               "pipelined": 3}
    assert collectives.iteration_psum_count("classic") == 4


def test_vacuous_rule_is_a_finding(monkeypatch):
    monkeypatch.setitem(engine.RULES, "recovery-paths", engine.Rule(
        "recovery-paths", "ast", True, "stub", lambda ctx: []))
    report = engine.run_lint(rule_ids=["recovery-paths"])
    assert [f.loc for f in report.findings] == ["coverage"]
    assert report.exit_code == 1


def test_baseline_suppression_and_undocumented_entry():
    f1 = Finding(rule="r", loc="a", message="m")
    f2 = Finding(rule="r", loc="b", message="m")
    active, suppressed = apply_baseline(
        [f1, f2], [{"rule": "r", "loc": "a", "reason": "known"}])
    assert active == [f2] and suppressed == [f1]
    active, _ = apply_baseline([], [{"rule": "r", "loc": "x"}])
    assert len(active) == 1 and active[0].rule == "baseline"
    active, _ = apply_baseline(
        [], [{"rule": "r", "loc": "gone", "reason": "fixed long ago"}])
    assert len(active) == 1 and active[0].severity == "warn"


def test_shipped_baseline_is_empty_and_unknown_rule_raises():
    assert engine.load_baseline(engine.DEFAULT_BASELINE) == []
    with pytest.raises(ValueError, match="unknown rule"):
        engine.run_lint(rule_ids=["no-such-rule"])


def test_report_json_roundtrip():
    report = engine.run_lint(rule_ids=["doc-schema-sync"])
    doc = json.loads(json.dumps(report.to_dict()))
    assert doc["schema"] == "pcg-tpu-lint-report/1" and doc["clean"]
    assert doc["checked"]["doc-schema-sync"]["event kinds"] == 37


def _lint(*argv, env=None):
    e = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    e.update(env or {})
    return subprocess.run([sys.executable, "-m",
                           "pcg_mpi_solver_tpu_torch.analysis", *argv],
                          capture_output=True, text=True, cwd=ROOT, env=e,
                          timeout=300)


def test_cli_exit_codes(tmp_path):
    """0 clean, 1 findings (an undocumented baseline entry), 2 an
    unknown rule, and 2 for a trip rule with no card and no --device
    cpu: it never records on the CPU unasked."""
    out = tmp_path / "report.json"
    ok = _lint("--rules", "recovery-paths,doc-schema-sync", "--json",
               str(out))
    assert ok.returncode == 0, ok.stdout + ok.stderr
    assert json.loads(out.read_text())["clean"] is True
    base = tmp_path / "baseline.json"
    base.write_text(json.dumps({"schema": "pcg-tpu-lint-baseline/1",
                                "suppressions": [{"rule": "x",
                                                  "loc": "y"}]}))
    assert _lint("--rules", "doc-schema-sync", "--baseline",
                 str(base)).returncode == 1
    assert _lint("--rules", "no-such-rule").returncode == 2
    if not torch.cuda.is_available():
        nocard = _lint("--rules", "hot-loop-purity")
        assert nocard.returncode == 2
        assert "no CUDA device" in nocard.stdout

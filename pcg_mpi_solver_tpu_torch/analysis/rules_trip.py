"""Trip rules over the recorded program matrix.

The counterpart of the JAX package's ``analysis/rules_jaxpr.py``: the
same six rule ids, proven on recorded trips of the port's host-driven
loop (``analysis/trip.py``, ``analysis/programs.py``) instead of traced
loop bodies.  Each rule's checker takes one
:class:`~pcg_mpi_solver_tpu_torch.analysis.programs.Program` (or
donation surface), so the seeded-violation tests feed deliberately bad
programs through exactly the code the registered rule runs.

Where the surface differs from the JAX package's:

* ``collective-budget`` — the budget is a trip's, by kind
  (``ops/matvec.trip_collective_budget``): the port runs only the branch
  a trip takes, where a traced body holds every branch.  The recorded
  ``Group.counts`` increments (all-reduces, plane exchanges, messages)
  must equal it, no other collective kind may run in a trip, the slab
  kernel's launches must equal the declared ones (one a structured
  matvec on the card), and a trip of a block of 8 must run the
  collectives of a single column's;
* ``psum-overlap`` — data dependence over the recorded storages: the
  pipelined trip's one reduction all-reduce neither reads what the
  trip's matvec wrote nor feeds the matvec, and every classic and fused
  reduction is serialised against it (the negative controls);
* ``scope-labels`` — the ``torch.profiler`` ranges a trip entered, not
  named scopes of a jaxpr;
* ``hot-loop-purity`` — a trip's host reads equal the declared count
  (``solver/pcg.trip_host_reads``: one ``_read``) and it uploads nothing
  above ``trip.UPLOAD_THRESHOLD_ELEMS`` elements, where the JAX package
  forbids callbacks and folded constants in a loop body;
* ``dtype-discipline`` — no op of an all-f32 program's trips touches a
  float64 tensor (the host read, which widens on its way to the host,
  excepted);
* ``donation-integrity`` — the chunked dispatch surfaces hand their carry
  from one capped call to the next without a copy (the same storages),
  where the JAX package proves buffer aliasing in the compiled program.
"""

from __future__ import annotations

from typing import Dict, List

from pcg_mpi_solver_tpu_torch.analysis.engine import Finding, rule
from pcg_mpi_solver_tpu_torch.analysis.trip import (
    GROUP_COUNTERS, UPLOAD_THRESHOLD_ELEMS, dependence)

BUDGET_KEYS = ("all_reduce", "halo", "halo_msgs")


def _count_trips(ctx, rule_id, programs) -> None:
    if ctx is not None:
        ctx.checked(rule_id, "programs", len(programs))
        ctx.checked(rule_id, "trips", sum(len(p.trips) for p in programs))


# ---------------------------------------------------------------------------
# collective-budget
# ---------------------------------------------------------------------------

def check_collective_budget(prog) -> List[Finding]:
    """Each recorded trip's collectives EQUAL the declared budget: an
    extra all-reduce, an under-count (the gauges advertising collectives
    that do not run) and a collective kind the budget does not declare
    all fail; so does a slab-kernel launch count off the declared one."""
    out = []
    for kind, trip in prog.trips.items():
        loc = f"program:{prog.name}:rank{prog.rank}:{kind}"
        got = trip.counts()
        want = prog.budgets[kind]
        seen = {k: got[k] for k in BUDGET_KEYS}
        undeclared = {k: got[k] for k in GROUP_COUNTERS
                      if k not in BUDGET_KEYS and got[k]}
        if seen != {k: want[k] for k in BUDGET_KEYS} or undeclared:
            out.append(Finding(
                rule="collective-budget", loc=loc,
                message=f"trip collectives {seen}"
                        + (f" and undeclared {undeclared}"
                           if undeclared else "")
                        + f" != declared budget {want} "
                          "(Ops.trip_collective_budget / comm.* gauges): "
                          "a re-serialised reduction or an undeclared "
                          "collective is in the loop"))
        if got["launches"] != prog.launches[kind]:
            out.append(Finding(
                rule="collective-budget", loc=loc,
                message=f"{got['launches']} slab-kernel launches in the "
                        f"trip, {prog.launches[kind]} declared (one a "
                        "structured matvec on the card, none on the CPU)"))
    return out


def check_width_independence(programs) -> List[Finding]:
    """A block's iterate trip runs the collectives of a single column's:
    the budgets, and the recorded counts, are equal at nrhs 1 and 8."""
    by: Dict[tuple, dict] = {}
    for p in programs:
        key = (p.backend, p.variant, p.precond, p.role, p.rank)
        trip = p.trips["iterate"]
        by.setdefault(key, {})[p.nrhs] = (
            p.budgets["iterate"],
            {k: trip.counts()[k] for k in BUDGET_KEYS})
    out = []
    for key, widths in sorted(by.items()):
        if len(widths) < 2:
            continue
        vals = list(widths.values())
        if any(v != vals[0] for v in vals[1:]):
            out.append(Finding(
                rule="collective-budget",
                loc=f"program:{key[0]},{key[1]},{key[2]}:rank{key[4]}",
                message=f"the iterate trip's collectives depend on the "
                        f"block width: {widths} (budget, recorded) — a "
                        "block must carry every column in one collective"))
    return out


@rule("collective-budget", kind="trip", fast=True,
      doc="each recorded trip's all-reduces / plane exchanges / messages "
          "(Group.counts) equal the budget declared next to "
          "Ops.comm_estimate, for every variant x nrhs x backend program "
          "and trip kind, and are the same at nrhs 1 and 8")
def collective_budget_rule(ctx) -> List[Finding]:
    progs = ctx.programs()
    out = []
    for prog in progs:
        out.extend(check_collective_budget(prog))
    out.extend(check_width_independence(progs))
    _count_trips(ctx, "collective-budget", progs)
    return out


# ---------------------------------------------------------------------------
# psum-overlap
# ---------------------------------------------------------------------------

def reduction_dependence(trip) -> List[dict]:
    """One record a reduction all-reduce of the trip (an all-reduce in a
    ``pcg/reduce`` range, outside the matvec): ``reads_matvec`` (its
    inputs derive from what the trip's matvec wrote), ``feeds_matvec``
    (the matvec consumes its result), ``size`` (elements reduced)."""
    ops = trip.ops
    in_mv = [("pcg/matvec" in o.get("sc", ())) for o in ops]
    from_mv = dependence(ops, lambda i, o: in_mv[i])
    out = []
    for c, o in enumerate(ops):
        if o["op"] != "dist.all_reduce" or in_mv[c] \
                or "pcg/reduce" not in o.get("sc", ()):
            continue
        fed = dependence(ops, lambda i, _o, c=c: i == c)
        size = 1
        for d in (o["sh"][0] if o["sh"] else []):
            size *= d
        out.append({"index": c, "reads_matvec": from_mv[c],
                    "feeds_matvec": any(f and m for f, m in zip(fed, in_mv)),
                    "size": size})
    return out


def check_psum_overlap(prog) -> List[Finding]:
    """The latency-hiding claim of ``pcg_variant="pipelined"``, proven on
    the recorded iterate trip: its one reduction all-reduce is
    data-independent of the trip's matvec in both directions (queued
    before it, read back while it runs).  Classic and fused trips are
    the negative controls: each of their reductions reads the matvec or
    feeds it, so a dependence walker that lost edges fails here first."""
    loc = f"program:{prog.name}:rank{prog.rank}"
    trip = prog.trips["iterate"]
    if not any("pcg/matvec" in o.get("sc", ()) for o in trip.ops):
        return [Finding(rule="psum-overlap", loc=loc,
                        message="no op of the iterate trip ran in a "
                                "pcg/matvec range: the matvec cannot be "
                                "told apart, the overlap proof is vacuous")]
    recs = reduction_dependence(trip)
    if not recs:
        return [Finding(rule="psum-overlap", loc=loc,
                        message="no reduction all-reduce in the iterate "
                                "trip (a two-rank recording has one)")]
    indep = [r for r in recs if not r["reads_matvec"]
             and not r["feeds_matvec"]]
    if prog.variant == "pipelined":
        if len(indep) != 1 or len(recs) != 1:
            return [Finding(
                rule="psum-overlap", loc=loc,
                message=f"the pipelined trip must carry exactly ONE "
                        f"reduction, data-independent of the matvec; "
                        f"found {len(recs)} reduction(s), {len(indep)} "
                        f"independent ({recs}) — the reduction got "
                        "serialised and the latency-hiding claim fails")]
        limit = 16 * max(int(prog.nrhs), 1)
        if indep[0]["size"] > limit:
            return [Finding(
                rule="psum-overlap", loc=loc,
                message=f"the independent all-reduce reduces "
                        f"{indep[0]['size']} elements (> {limit}): a "
                        "vector, not the pipelined scalar reduction")]
    elif indep:
        return [Finding(
            rule="psum-overlap", loc=loc,
            message=f"{len(indep)} reduction(s) independent of the "
                    f"matvec in a {prog.variant} trip — every classic/"
                    "fused reduction is serialised against the matvec by "
                    "construction, so the dependence walk lost edges")]
    return []


@rule("psum-overlap", kind="trip", fast=False,
      doc="the pipelined trip's single reduction all-reduce is data-"
          "independent of the trip's matvec in both directions; classic/"
          "fused trips prove serialised, as negative controls")
def psum_overlap_rule(ctx) -> List[Finding]:
    progs = ctx.programs()
    out = []
    for prog in progs:
        out.extend(check_psum_overlap(prog))
    if ctx is not None:
        ctx.checked("psum-overlap", "programs", len(progs))
        ctx.checked("psum-overlap", "pipelined programs",
                    sum(p.variant == "pipelined" for p in progs))
    return out


# ---------------------------------------------------------------------------
# scope-labels
# ---------------------------------------------------------------------------

def check_scope_labels(prog, phase_scopes=None) -> List[Finding]:
    """Every range label ``obs/profview.py`` buckets on (PHASE_SCOPES)
    is entered in the recorded iterate trip of every program, scalar and
    blocked; a ``pcg/<x>`` range it does not know is reported (its time
    would bucket as unknown).  ``phase_scopes`` is the seeded hook."""
    from pcg_mpi_solver_tpu_torch.obs.profview import PHASE_SCOPES

    scopes = phase_scopes if phase_scopes is not None else PHASE_SCOPES
    loc = f"program:{prog.name}:rank{prog.rank}"
    found = prog.trips["iterate"].labels()
    out = []
    for label in scopes:
        if not found.get(label):
            out.append(Finding(
                rule="scope-labels", loc=loc,
                message=f"range {label!r} is absent from the recorded "
                        "trip: its phase's device time would bucket as "
                        "'other' in every parsed trace (obs/profview.py) "
                        f"— ranges found: {sorted(found)}"))
    for kind, trip in prog.trips.items():
        for label in trip.labels():
            if label.startswith("pcg/") and label not in scopes:
                out.append(Finding(
                    rule="scope-labels", loc=f"{loc}:{kind}",
                    message=f"range {label!r} is not a phase obs/"
                            "profview.py knows: its time would be counted "
                            "as an unknown scope"))
    return out


def check_unknown_label_loudness(bucket_fn=None) -> List[Finding]:
    """The parser half: a device op in no phase range is COUNTED (other)
    and a ``pcg/<x>`` label outside the four lands in
    ``unknown_scopes``, never dropped.  ``bucket_fn`` is the seeded
    hook."""
    from pcg_mpi_solver_tpu_torch.obs import profview

    fn = bucket_fn if bucket_fn is not None else profview.bucket_phases
    ops = [{"name": "mystery_kernel", "ts": 0.0, "dur": 5.0, "label": None},
           {"name": "dot_kernel", "ts": 10.0, "dur": 7.0,
            "label": "pcg/notaphase"},
           {"name": "gemm_kernel", "ts": 20.0, "dur": 3.0,
            "label": "pcg/matvec"}]
    try:
        b = fn([dict(o) for o in ops])
    except Exception as e:                              # noqa: BLE001
        return [Finding(rule="scope-labels", loc="probe:unknown-label",
                        message=f"bucket_phases crashed on an unbucketable "
                                f"op ({type(e).__name__}: {e})")]
    out = []
    total = sum(d["us"] for d in b["phases"].values()) + b["other_us"]
    if b["other_events"] < 2 or total < 15.0 - 1e-9:
        out.append(Finding(
            rule="scope-labels", loc="probe:unknown-label",
            message=f"bucket_phases DROPPED time (other_events="
                    f"{b['other_events']}, bucketed {total} of 15.0 us)"))
    if b["unknown_scopes"].get("notaphase", 0) != 1:
        out.append(Finding(
            rule="scope-labels", loc="probe:unknown-label",
            message=f"a pcg/<x> label outside the phases was not counted "
                    f"into unknown_scopes (got {b['unknown_scopes']})"))
    return out


@rule("scope-labels", kind="trip", fast=True,
      doc="every pcg/* range the trace consumer (obs/profview.py) buckets "
          "on is entered in the recorded trip of every variant (scalar + "
          "blocked), and the parser counts + reports unknown labels")
def scope_labels_rule(ctx) -> List[Finding]:
    progs = ctx.programs()
    out = []
    for prog in progs:
        out.extend(check_scope_labels(prog))
    out.extend(check_unknown_label_loudness())
    _count_trips(ctx, "scope-labels", progs)
    return out


# ---------------------------------------------------------------------------
# hot-loop-purity
# ---------------------------------------------------------------------------

def check_hot_loop_purity(prog, threshold_elems=None) -> List[Finding]:
    """Each trip reads the host exactly as often as it declares and
    uploads nothing above the threshold."""
    threshold = (UPLOAD_THRESHOLD_ELEMS if threshold_elems is None
                 else threshold_elems)
    out = []
    for kind, trip in prog.trips.items():
        loc = f"program:{prog.name}:rank{prog.rank}:{kind}"
        reads = trip.counts()["host_reads"]
        if reads != prog.host_reads[kind]:
            out.append(Finding(
                rule="hot-loop-purity", loc=loc,
                message=f"{reads} host reads in the trip, "
                        f"{prog.host_reads[kind]} declared "
                        "(solver/pcg.trip_host_reads): every extra read "
                        "stalls the host on the device once a trip"))
        big = [n for n in trip.uploads() if n > threshold]
        if big:
            out.append(Finding(
                rule="hot-loop-purity", loc=loc,
                message=f"host->device copies of {big} elements (> "
                        f"{threshold}) in the trip: a per-trip upload "
                        "(keep it on the device across trips)"))
    return out


@rule("hot-loop-purity", kind="trip", fast=True,
      doc="each recorded trip makes exactly its declared host reads (one "
          "_read) and no host->device copy above the size threshold")
def hot_loop_purity_rule(ctx) -> List[Finding]:
    progs = ctx.programs()
    out = []
    for prog in progs:
        out.extend(check_hot_loop_purity(prog))
    _count_trips(ctx, "hot-loop-purity", progs)
    return out


# ---------------------------------------------------------------------------
# dtype-discipline
# ---------------------------------------------------------------------------

def check_dtype_discipline(prog) -> List[Finding]:
    """No float64 tensor in any trip of an all-f32 program."""
    if prog.role != "f32":
        return []
    out = []
    for kind, trip in prog.trips.items():
        leaks = [o["op"] for o in trip.ops if o.get("n", {}).get("f64_ops")]
        if leaks:
            out.append(Finding(
                rule="dtype-discipline",
                loc=f"program:{prog.name}:rank{prog.rank}:{kind}",
                message=f"{len(leaks)} op(s) on a float64 tensor in an "
                        f"f32 trip (e.g. {sorted(set(leaks))[:4]}): an "
                        "f64 leak halves the card's rate and doubles the "
                        "all-reduce payloads"))
    return out


@rule("dtype-discipline", kind="trip", fast=True,
      doc="no float64 tensor in a trip of the all-f32 programs "
          "(dtype=float32, dot_dtype=float32); the host read excepted")
def dtype_discipline_rule(ctx) -> List[Finding]:
    progs = [p for p in ctx.programs() if p.role == "f32"]
    out = []
    for prog in progs:
        out.extend(check_dtype_discipline(prog))
    _count_trips(ctx, "dtype-discipline", progs)
    return out


# ---------------------------------------------------------------------------
# donation-integrity
# ---------------------------------------------------------------------------

@rule("donation-integrity", kind="trip", fast=False,
      doc="every donate_carry chunked dispatch surface hands its carry "
          "from one capped call to the next without a copy (the same "
          "storages); a surface that allocates by design is listed with "
          "its reason")
def donation_integrity_rule(ctx) -> List[Finding]:
    from pcg_mpi_solver_tpu_torch.analysis import programs as ap

    dev = ctx.device_type()
    out, pairs = [], 0
    for surface in ap.DONATION_SURFACES:
        calls = ap.donation_calls(surface, device=dev)
        pairs += ap.donation_pairs(calls)
        for err in ap.check_donation(surface, calls):
            out.append(Finding(rule="donation-integrity",
                               loc=f"surface:{surface}", message=err))
    ctx.checked("donation-integrity", "surfaces",
                len(ap.DONATION_SURFACES))
    ctx.checked("donation-integrity", "carry handoffs", pairs)
    ctx.checked("donation-integrity", "listed surfaces",
                len(ap.UNDONATED_SURFACES))
    return out

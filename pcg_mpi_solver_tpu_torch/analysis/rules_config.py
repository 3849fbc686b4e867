"""Config rules: fingerprint completeness, partition-key components, and
cost-model completeness.

Port of ``pcg_mpi_solver_tpu/analysis/rules_config.py``.

``fingerprint-completeness`` reflects over every ``SolverConfig`` field,
perturbs it on a small real CPU Solver, and records one step
(``programs.program_signature``: every trip's op names, dtypes, shapes
and counter increments, and the solution's bits).  A field that moves
that signature must move the snapshot fingerprint
(``utils/checkpoint._fingerprint``), else a resume would continue under
other numerics without a mismatch error; a field that moves the
partition's content must move the partition cache key
(``cache/keys.partition_cache_key``, as the driver assembles it).  The
JAX package's other surface, its AOT ``step_cache_key``, has no
counterpart: the port compiles no programs ahead of time, and its
kernels are keyed by a hash of their sources (``cache/keys.code_hash``).
:data:`KEY_SURFACES` says so.  New fields are forced through
classification: bool/int/float fields get an auto-derived perturbation,
string fields need a row in :data:`STRING_ALTERNATIVES`, RunConfig fields
must be declared trace-neutral.  ``fields`` / ``fp_fn`` / ``sig_fn``
are the seeded-violation hooks.
"""

from __future__ import annotations

import dataclasses
import tempfile
from typing import Callable, List, Optional

from pcg_mpi_solver_tpu_torch.analysis.engine import Finding, rule
from pcg_mpi_solver_tpu_torch.config import RunConfig, SolverConfig

#: the surfaces a trace-affecting field must move, and the one the port
#: has none of
KEY_SURFACES = {
    "snapshot_fingerprint": "utils/checkpoint._fingerprint",
    "partition_key": "cache/keys.partition_cache_key (where the field "
                     "reaches the partition)",
    "step_cache_key": None,    # no AOT program cache in the port
}

#: alternatives for string-typed SolverConfig fields.  ``pallas``: "on"
#: (the port refuses "off" and "interpret": it has no XLA path).
STRING_ALTERNATIVES = {
    "precision_mode": "mixed",
    "dtype": "float32",
    "dot_dtype": "float32",
    "precond": "block3",
    "pcg_variant": "fused",
    "pallas": "on",
}

#: fields probed on the MIXED base solver (they reach the loop only
#: through the f32/f64 refinement shell).
MIXED_SCOPE_FIELDS = ("inner_tol", "mixed_plateau_window",
                      "mixed_progress_window", "mixed_progress_ratio",
                      "mixed_progress_min_gain")

#: fields exempt from the SNAPSHOT fingerprint, each with its why.
RESUME_NEUTRAL = {
    "donate_carry": (
        "accepted and ignored: the port's carry is handed on by reference "
        "whatever its value (the donation-integrity rule), so a resume "
        "across the toggle is safe"),
    "iters_per_dispatch": (
        "the chunked path runs the same loop in capped resumable calls, "
        "bit for bit one long solve (tests/test_torch_chunked.py); its "
        "first trip continues the cold carry's direction recurrence "
        "(p = z + beta * 0: one op more, the same bits), and snapshots "
        "count their chunks themselves"),
}

#: RunConfig fields that never shape a trip: paths, host-side policies,
#: dispatch cadence (the JAX package's table).  ``solver`` is swept field
#: by field; ``time_history`` enters as step arguments and is
#: fingerprinted on its own.
TRACE_NEUTRAL_RUNCONFIG = frozenset({
    "scratch_path", "model_name", "run_id", "n_parts",
    "partition_method", "speed_test", "checkpoint_every",
    "snapshot_every", "preflight", "cache_dir", "telemetry_path",
    "flight_path", "telemetry_profile", "profile_dir", "comm_probe_iters",
    "solver", "time_history",
    # the sharded setup builds the same partition rows (bit identity:
    # tests/test_torch_setup_shard.py)
    "setup_shard",
})


def _auto_alternative(value):
    """Perturbation for bool/int/float values; None if underivable."""
    if isinstance(value, bool):
        return not value
    if isinstance(value, int):
        return value + 7
    if isinstance(value, float):
        return value * 3.0 if value else 0.5
    return None


def perturbation_for(field: dataclasses.Field, value):
    if field.name in STRING_ALTERNATIVES:
        alt = STRING_ALTERNATIVES[field.name]
        return alt if alt != value else None
    return _auto_alternative(value)


def _default_fp_fn():
    from pcg_mpi_solver_tpu_torch.utils.checkpoint import _fingerprint

    return _fingerprint


def _solver(**over):
    """A one-part general CPU Solver of the lint's 3^3 cube, with a
    partition cache of its own (so the driver assembles its key)."""
    from pcg_mpi_solver_tpu_torch.analysis.programs import build_solver

    cache = tempfile.mkdtemp(prefix="pcg_lint_fp_")
    return build_solver("general", device="cpu", n_parts=1,
                        run_overrides={"cache_dir": cache}, **over), cache


def check_fingerprint_completeness(fields: Optional[List[str]] = None,
                                   fp_fn: Optional[Callable] = None,
                                   sig_fn: Optional[Callable] = None,
                                   ctx=None) -> List[Finding]:
    """The perturbation sweep (module docstring).  ``fields`` restricts
    to named SolverConfig fields; ``fp_fn`` / ``sig_fn`` override the
    fingerprint and the signature (seeded-violation tests)."""
    import shutil

    from pcg_mpi_solver_tpu_torch.analysis import programs as ap

    fp_fn = fp_fn or _default_fp_fn()
    sig_fn = sig_fn or ap.program_signature
    out: List[Finding] = []
    bases, dirs = {}, []
    swept = moved = 0

    def base(mode: str):
        if mode not in bases:
            s, d = (_solver(precision_mode="mixed") if mode == "mixed"
                    else _solver())
            dirs.append(d)
            bases[mode] = (s, sig_fn(s), fp_fn(s), ap.partition_digest(s),
                           s._partition_cache_id)
        return bases[mode]

    try:
        for f in dataclasses.fields(SolverConfig):
            if fields is not None and f.name not in fields:
                continue
            loc = f"field:SolverConfig.{f.name}"
            mode = "mixed" if f.name in MIXED_SCOPE_FIELDS else "direct"
            base_s, base_sig, base_fp, base_part, base_key = base(mode)
            value = getattr(base_s.config.solver, f.name)
            alt = perturbation_for(f, value)
            if alt is None:
                out.append(Finding(
                    rule="fingerprint-completeness", loc=loc,
                    message=f"no perturbation known for SolverConfig."
                            f"{f.name} (= {value!r}): add a "
                            "STRING_ALTERNATIVES row (or make it auto-"
                            "derivable) so new config knobs stay provably "
                            "keyed"))
                continue
            over = {f.name: alt}
            if mode == "mixed":
                over["precision_mode"] = "mixed"
            pert, d = _solver(**over)
            dirs.append(d)
            swept += 1
            if ap.partition_digest(pert) != base_part \
                    and pert._partition_cache_id == base_key:
                out.append(Finding(
                    rule="fingerprint-completeness", loc=loc,
                    message=f"SolverConfig.{f.name} changes the partition "
                            f"({value!r} -> {alt!r}) but NOT its cache key "
                            "(cache/keys.partition_cache_key): a warm run "
                            "would load another configuration's "
                            "partition"))
            if sig_fn(pert) == base_sig:
                continue   # moves no trip and no bit: no obligation
            moved += 1
            if fp_fn(pert) == base_fp and f.name not in RESUME_NEUTRAL:
                out.append(Finding(
                    rule="fingerprint-completeness", loc=loc,
                    message=f"SolverConfig.{f.name} changes the recorded "
                            f"trips or the solution's bits ({value!r} -> "
                            f"{alt!r}) but NOT the snapshot _fingerprint "
                            "(utils/checkpoint.py): a resume would "
                            "continue under different numerics without a "
                            "mismatch error"))
    finally:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)
    if ctx is not None:
        ctx.checked("fingerprint-completeness", "fields perturbed", swept)
        ctx.checked("fingerprint-completeness", "fields moving a trip",
                    moved)
    return out


def check_runconfig_classified(ctx=None) -> List[Finding]:
    """Every RunConfig field is classified trace-neutral or swept."""
    out = []
    fields = dataclasses.fields(RunConfig)
    for f in fields:
        if f.name not in TRACE_NEUTRAL_RUNCONFIG:
            out.append(Finding(
                rule="fingerprint-completeness",
                loc=f"field:RunConfig.{f.name}",
                message=f"RunConfig.{f.name} is unclassified: add it to "
                        "TRACE_NEUTRAL_RUNCONFIG (with thought) or wire "
                        "it through the sweep like a solver knob"))
    if ctx is not None:
        ctx.checked("fingerprint-completeness", "RunConfig fields",
                    len(fields))
    return out


# ----------------------------------------------------------------------
# cost-model-completeness
# ----------------------------------------------------------------------

#: the synthetic geometry the completeness sweep models (the JAX
#: package's): multi-part, with a plausible interface payload.
_COST_MODEL_PROBE_SHAPE = dict(n_dof=30_000, n_parts=8, n_iface=2_000,
                               elem_groups=((24, 9_000),),
                               mg_coarse_dofs=4_000)


def check_cost_model_completeness(variants=None, preconds=None,
                                  model_fn=None, nrhs_set=(1, 8),
                                  ctx=None) -> List[Finding]:
    """Every ``config.PCG_VARIANTS`` x ``config.PRECONDS`` x nrhs
    combination gives a finite positive prediction with all four phases,
    and an unknown variant/precond raises ``KeyError``.  ``variants`` /
    ``preconds`` / ``model_fn`` are seeded-violation hooks."""
    from pcg_mpi_solver_tpu_torch import config as _cfg
    from pcg_mpi_solver_tpu_torch.obs import perf as _perf

    shape = _perf.ProblemShape(**_COST_MODEL_PROBE_SHAPE)
    variants = tuple(variants if variants is not None
                     else _cfg.PCG_VARIANTS)
    preconds = tuple(preconds if preconds is not None else _cfg.PRECONDS)
    if model_fn is None:
        def model_fn(v, p, r):
            return _perf.cost_model(shape, v, p, r)
    out: List[Finding] = []
    combos = 0
    for v in variants:
        for p in preconds:
            for r in nrhs_set:
                combos += 1
                loc = f"combo:{v}/{p}/nrhs{r}"
                try:
                    cm = model_fn(v, p, r)
                except Exception as e:                  # noqa: BLE001
                    out.append(Finding(
                        rule="cost-model-completeness", loc=loc,
                        message=f"cost model has no entry for "
                                f"(pcg_variant={v!r}, precond={p!r}, "
                                f"nrhs={r}): {type(e).__name__}: {e} — "
                                "every canonical combination must "
                                "predict"))
                    continue
                phases = (cm or {}).get("phases", {})
                missing = [ph for ph in _perf.PHASES if ph not in phases]
                pred = (cm or {}).get("predicted_ms_per_iter", 0)
                if missing or not (isinstance(pred, (int, float))
                                   and pred > 0):
                    out.append(Finding(
                        rule="cost-model-completeness", loc=loc,
                        message=f"cost model entry for ({v}, {p}, "
                                f"nrhs={r}) is degenerate: "
                                f"missing phases {missing}, "
                                f"predicted_ms_per_iter={pred!r} — a "
                                "zero/partial prediction reads as 'free' "
                                "on the measured-vs-model table"))
    for probe, loc in (((("__no_such_variant__", preconds[0])),
                        "probe:unknown-variant"),
                       (((variants[0], "__no_such_precond__")),
                        "probe:unknown-precond")):
        try:
            model_fn(probe[0], probe[1], 1)
        except KeyError:
            continue
        except Exception as e:                          # noqa: BLE001
            out.append(Finding(
                rule="cost-model-completeness", loc=loc,
                message=f"unknown name raised {type(e).__name__} "
                        "instead of KeyError — consumers catch KeyError "
                        "as the 'table out of sync' signal"))
            continue
        out.append(Finding(
            rule="cost-model-completeness", loc=loc,
            message="cost model silently accepted an unknown "
                    f"{'variant' if 'variant' in loc else 'precond'} "
                    "name — an out-of-sync name table would stamp "
                    "fabricated predictions instead of failing loudly"))
    if ctx is not None:
        ctx.checked("cost-model-completeness", "combinations", combos)
    return out


# ----------------------------------------------------------------------
# partition-key-components
# ----------------------------------------------------------------------

def check_partition_key_components(shard_key_fn=None, glue_key_fn=None,
                                   ctx=None) -> List[Finding]:
    """Every structural component of the shard-addressed partition keys
    (``cache/keys.py``) moves the digest alone — above all ``part_idx``,
    and the hash of the code that builds an entry (``code_hash``); the
    glue key differs from every part key; an out-of-range part_idx
    raises ``KeyError``.  ``shard_key_fn`` / ``glue_key_fn`` are the
    seeded-violation hooks."""
    from pcg_mpi_solver_tpu_torch.cache import keys as ckeys

    shard_key_fn = shard_key_fn or ckeys.partition_shard_key
    glue_key_fn = glue_key_fn or ckeys.partition_glue_key

    def k(**over):
        kw = dict(n_parts=8, part_idx=0, backend="general",
                  dtype="float64", method="rcb", elem_part_hash=None,
                  pad_multiple=8, extra={})
        kw.update(over)
        return shard_key_fn("<model_fp>", **kw)

    base = k()
    out: List[Finding] = []
    components = (("part_idx", {"part_idx": 3}),
                  ("n_parts", {"n_parts": 4, "part_idx": 0}),
                  ("backend", {"backend": "structured"}),
                  ("dtype", {"dtype": "float32"}),
                  ("method", {"method": "slab2"}),
                  ("elem_part_hash", {"elem_part_hash": "abc"}),
                  ("pad_multiple", {"pad_multiple": 16}),
                  ("extra", {"extra": {"slab2_slabs": 4}}))
    for name, over in components:
        if k(**over) == base:
            out.append(Finding(
                rule="partition-key-components",
                loc=f"field:partition_shard_key.{name}",
                message=f"structural component {name!r} does not change "
                        "the partition shard key — entries of different "
                        "shape would collide; a warm start could hand a "
                        "process another shard's rows"))
    # the code component: another hash of the building code must key
    # another entry
    orig = ckeys.code_hash
    ckeys.code_hash = lambda: "<other code>"
    try:
        other_code = k()
    finally:
        ckeys.code_hash = orig
    if other_code == base:
        out.append(Finding(
            rule="partition-key-components", loc="field:code_hash",
            message="the hash of the code that builds an entry does not "
                    "change the partition key — an entry built by older "
                    "code would load after the partitioner changed"))
    glue = glue_key_fn("<model_fp>", n_parts=8, backend="general",
                       dtype="float64", method="rcb")
    if glue == base:
        out.append(Finding(
            rule="partition-key-components",
            loc="field:partition_glue_key.kind",
            message="the glue key collides with a part entry key — the "
                    "glue must carry its own structural kind"))
    try:
        k(part_idx=99)
    except KeyError:
        pass
    else:
        out.append(Finding(
            rule="partition-key-components", loc="probe:part_idx-range",
            message="partition_shard_key accepted part_idx outside "
                    "[0, n_parts) — a key for a part that cannot exist "
                    "caches an unreachable entry instead of failing "
                    "loudly"))
    if ctx is not None:
        ctx.checked("partition-key-components", "components",
                    len(components) + 1)
    return out


@rule("partition-key-components", kind="config", fast=True,
      doc="every structural component of the shard-addressed partition "
          "cache keys (part_idx/n_parts/backend/dtype/method/"
          "elem_part_hash/pad_multiple/extra and the code hash) moves the "
          "digest alone, the glue key is kind-distinct, and out-of-range "
          "part_idx raises KeyError")
def partition_key_components_rule(ctx) -> List[Finding]:
    return check_partition_key_components(ctx=ctx)


@rule("cost-model-completeness", kind="config", fast=True,
      doc="the analytic per-iteration cost model (obs/perf.py) covers "
          "every config.PCG_VARIANTS x config.PRECONDS x nrhs combination "
          "with a positive all-phase prediction, and unknown names raise "
          "KeyError (never a silent default row)")
def cost_model_completeness_rule(ctx) -> List[Finding]:
    return check_cost_model_completeness(ctx=ctx)


@rule("fingerprint-completeness", kind="config", fast=False,
      doc="every SolverConfig field that moves a recorded trip or the "
          "solution's bits moves the snapshot _fingerprint, and the "
          "partition key where it reaches the partition (perturb-and-"
          "record on a CPU Solver; new fields must classify)")
def fingerprint_completeness_rule(ctx) -> List[Finding]:
    return (check_runconfig_classified(ctx=ctx)
            + check_fingerprint_completeness(ctx=ctx))

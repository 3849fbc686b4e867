"""AST-level source rules over the port's own files.

Port of ``pcg_mpi_solver_tpu/analysis/rules_ast.py``, with the port's
paths, surface names and call names:

* ``recovery-paths`` — every broad ``except`` in the solver, cache,
  resilience, validate, ops, parallel, obs and serve packages re-raises,
  records (a metrics ``event``/``inc``/``note``/``gauge``, a warning),
  or carries a ``# noqa: BLE001`` justification on its line;
* ``recovery-coverage`` — every Krylov dispatch surface of
  ``solver/driver.py``, ``solver/newmark.py`` and ``serve/daemon.py``
  is wrapped by the recovery harness or carries a documented
  ``recovery-exempt:`` comment.  The port's one-shot program is the
  ``_step_oneshot`` call (the JAX package's jitted ``_step_fn``);
* ``consensus-coverage`` — every host collective on the dispatch path
  (``driver.py``, ``chunked.py``, ``resilience/engine.py``) routes its
  verdict through ``parallel/consensus`` or carries a documented
  ``consensus-exempt:`` comment.  The collectives are the port's:
  ``parallel/distributed.Group``'s and ``HostComm``'s methods and
  ``resilience/distributed.GuardedComm``'s, in place of the JAX
  package's ``process_allgather`` / ``sync_global_devices``; the chunk
  loops are the engine's ``_run_direct`` and ``_run_mixed`` (the JAX
  package's ``run``);
* ``serve-admission-events`` — every admission and lifecycle outcome of
  ``serve/`` emits its schema-versioned event.

Each checker takes its registry as an argument (default: the port's), so
the tests feed the JAX package's seeded sources through the same code
with the JAX package's registry and compare verdicts.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, List, Optional

from pcg_mpi_solver_tpu_torch.analysis.engine import REPO, Finding, rule

PKG_NAME = "pcg_mpi_solver_tpu_torch"
PKG = os.path.join(REPO, PKG_NAME)

#: scanned packages (the JAX package's scope, in the port)
DEFAULT_SCOPE = tuple(os.path.join(PKG, d) for d in (
    "solver", "cache", "resilience", "validate", "ops", "parallel", "obs",
    "serve"))

# Exception names considered "broad" when caught.
_BROAD = {"Exception", "BaseException"}

# A call to any of these names inside the handler records the failure.
_LOG_CALLS = {"event", "inc", "note", "gauge", "warn", "warning",
              "exception", "_log"}


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:                            # bare `except:`
        return True
    names = []
    if isinstance(t, ast.Tuple):
        names = [e.id for e in t.elts if isinstance(e, ast.Name)]
    elif isinstance(t, ast.Name):
        names = [t.id]
    return any(n in _BROAD for n in names)


def _handler_ok(handler: ast.ExceptHandler, lines: List[str]) -> bool:
    line = lines[handler.lineno - 1]
    if "noqa" in line and "BLE001" in line:
        return True
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            f = node.func
            name = (f.attr if isinstance(f, ast.Attribute)
                    else getattr(f, "id", ""))
            if name in _LOG_CALLS:
                return True
    return False


def broad_handlers(source: str) -> int:
    """How many broad ``except`` handlers a source holds."""
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return 0
    return sum(1 for n in ast.walk(tree)
               if isinstance(n, ast.ExceptHandler) and _is_broad(n))


def check_source(source: str, path: str = "<source>") -> List[str]:
    """Violations in one python source blob (path used for labels)."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [f"{path}: unparseable ({e})"]
    lines = source.splitlines()
    errs = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler) and _is_broad(node) \
                and not _handler_ok(node, lines):
            errs.append(
                f"{path}:{node.lineno}: broad `except` neither re-raises, "
                "logs a metrics/warning event, nor carries a "
                "`# noqa: BLE001` justification")
    return errs


def check_file(path: str) -> List[str]:
    try:
        with open(path, encoding="utf-8") as f:
            source = f.read()
    except OSError as e:
        return [f"{path}: unreadable ({e})"]
    return check_source(source, path)


def iter_py_files(paths) -> List[str]:
    out = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, files in os.walk(p):
                if "__pycache__" in root:
                    continue
                out.extend(os.path.join(root, fn) for fn in sorted(files)
                           if fn.endswith(".py"))
        elif p.endswith(".py"):
            out.append(p)
    return out


@rule("recovery-paths", kind="ast", fast=True,
      doc="every broad `except` in solver/cache/resilience/validate/ops/"
          "parallel/obs/serve re-raises, records, or carries "
          "# noqa: BLE001")
def recovery_paths_rule(ctx) -> List[Finding]:
    findings = []
    files = iter_py_files(DEFAULT_SCOPE)
    handlers = 0
    for f in files:
        with open(f, encoding="utf-8") as fh:
            handlers += broad_handlers(fh.read())
        for err in check_file(f):
            loc, _, msg = err.partition(": ")
            findings.append(Finding(rule="recovery-paths",
                                    loc=os.path.relpath(loc, REPO),
                                    message=msg))
    if ctx is not None:
        ctx.checked("recovery-paths", "files", len(files))
        ctx.checked("recovery-paths", "broad handlers", handlers)
    return findings


def _read_sources(rule_id: str, rels: Iterable[str]):
    sources, errs = {}, []
    for rel in rels:
        try:
            with open(os.path.join(REPO, rel), encoding="utf-8") as f:
                sources[rel] = f.read()
        except OSError as e:
            errs.append(Finding(rule=rule_id, loc=rel,
                                message=f"unreadable ({e})"))
    return sources, errs


def _top_level_functions(tree: ast.Module):
    """Module-level functions and class methods (nested closures belong
    to — and are walked with — their enclosing definition)."""
    out = []
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            out.extend(n for n in node.body
                       if isinstance(n, ast.FunctionDef))
        elif isinstance(node, ast.FunctionDef):
            out.append(node)
    return out


def _call_name(node: ast.Call) -> str:
    f = node.func
    return f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")


def _calls_name(fn: ast.FunctionDef, name: str) -> bool:
    return any(isinstance(n, ast.Call) and _call_name(n) == name
               for n in ast.walk(fn))


def _registry_errors(rel, source, registry, sweep, marker, what,
                     unregistered_msg, dropped_msg) -> List[str]:
    """The shared walk of the coverage rules: functions ``sweep`` flags
    must be registered; registered ``calls:<name>`` functions must call
    it; ``exempt`` ones must carry ``marker``; registered names must
    exist."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [f"{rel}:0: unparseable ({e})"]
    lines = source.splitlines()
    errs: List[str] = []
    fns = _top_level_functions(tree)
    for fn in fns:
        req = registry.get((rel, fn.name))
        if sweep(fn) and req is None:
            errs.append(f"{rel}:{fn.lineno}: `{fn.name}` "
                        + unregistered_msg)
            continue
        if req is None:
            continue
        if req.startswith("calls:"):
            want = req.split(":", 1)[1]
            if not _calls_name(fn, want):
                errs.append(f"{rel}:{fn.lineno}: {what} `{fn.name}` no "
                            f"longer calls its registered `{want}` — "
                            + dropped_msg)
        elif req == "exempt":
            seg = "\n".join(lines[fn.lineno - 1:fn.end_lineno or fn.lineno])
            if marker not in seg:
                errs.append(f"{rel}:{fn.lineno}: {what} `{fn.name}` is "
                            f"registered exempt but carries no `{marker}` "
                            "comment — document why, or wrap it")
    names = {fn.name for fn in fns}
    for (f, name), _req in registry.items():
        if f == rel and name not in names:
            errs.append(f"{rel}:0: the registry names `{name}` but no such "
                        "function exists — update the registry")
    return errs


# ----------------------------------------------------------------------
# recovery-coverage
# ----------------------------------------------------------------------

COVERAGE_FILES = (f"{PKG_NAME}/solver/driver.py",
                  f"{PKG_NAME}/solver/newmark.py",
                  f"{PKG_NAME}/serve/daemon.py")

#: Krylov-terminal dispatch-span names (the JAX package's): a swept
#: function whose subtree opens ``<recorder>.dispatch("<one of these>")``
#: runs a solve to (partial) termination.
SOLVE_DISPATCH_NAMES = frozenset(
    {"step", "solve_many", "cycle", "inner_cycle", "many_cycle"})

#: calls that run the one-shot solve program (the JAX package's
#: ``_step_fn``)
ONESHOT_CALLS = frozenset({"_step_oneshot"})

#: (file, function) -> ``calls:<harness entry>`` or ``exempt`` (which
#: needs a ``recovery-exempt:`` comment saying why).  A swept surface
#: missing here is itself a finding.
RECOVERY_SURFACES = {
    (f"{PKG_NAME}/solver/driver.py", "_step_chunked"):
        "calls:run_with_recovery",
    (f"{PKG_NAME}/solver/driver.py", "_solve_many_chunked"):
        "calls:run_many_with_recovery",
    (f"{PKG_NAME}/solver/driver.py", "solve_many"):
        "calls:_dispatch_with_retry",
    (f"{PKG_NAME}/solver/driver.py", "step"): "exempt",
    (f"{PKG_NAME}/solver/newmark.py", "_step_chunked"):
        "calls:run_with_recovery",
    (f"{PKG_NAME}/solver/newmark.py", "step"): "exempt",
    # jobs reach the solver only through Solver.solve_many, the
    # per-column recovery and quarantine path
    (f"{PKG_NAME}/serve/daemon.py", "_dispatch_block"): "calls:solve_many",
}


def _is_dispatch_surface(fn: ast.FunctionDef, oneshot=ONESHOT_CALLS,
                         names=SOLVE_DISPATCH_NAMES) -> bool:
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "dispatch" \
                and node.args:
            a = node.args[0]
            if isinstance(a, ast.Constant) and a.value in names:
                return True
        if isinstance(f, ast.Attribute) and f.attr in oneshot:
            return True
    return False


def check_recovery_coverage(sources: Dict[str, str],
                            surfaces: Optional[dict] = None,
                            oneshot=ONESHOT_CALLS) -> List[str]:
    """Coverage violations for ``{relpath: source}`` against
    ``surfaces`` (default :data:`RECOVERY_SURFACES`)."""
    surfaces = RECOVERY_SURFACES if surfaces is None else surfaces
    errs: List[str] = []
    for rel, source in sources.items():
        errs.extend(_registry_errors(
            rel, source, surfaces,
            lambda fn: _is_dispatch_surface(fn, oneshot),
            "recovery-exempt:", "dispatch surface",
            "opens a Krylov-terminal dispatch but is not registered in "
            "RECOVERY_SURFACES — wrap it in the recovery harness "
            "(run_with_recovery / run_many_with_recovery / "
            "_dispatch_with_retry) and register it, or register a "
            "documented exemption",
            "the surface runs unprotected"))
    return errs


@rule("recovery-coverage", kind="ast", fast=True,
      doc="every Krylov dispatch surface in driver.py/newmark.py/"
          "daemon.py is wrapped by the recovery harness or carries a "
          "documented `recovery-exempt:` justification")
def recovery_coverage_rule(ctx) -> List[Finding]:
    sources, errs = _read_sources("recovery-coverage", COVERAGE_FILES)
    if errs:
        return errs
    if ctx is not None:
        ctx.checked("recovery-coverage", "files", len(sources))
        ctx.checked("recovery-coverage", "surfaces", len(RECOVERY_SURFACES))
    out = []
    for err in check_recovery_coverage(sources):
        loc, _, msg = err.partition(": ")
        out.append(Finding(rule="recovery-coverage", loc=loc, message=msg))
    return out


# ----------------------------------------------------------------------
# consensus-coverage
# ----------------------------------------------------------------------

CONSENSUS_COVERAGE_FILES = (
    f"{PKG_NAME}/solver/driver.py",
    f"{PKG_NAME}/solver/chunked.py",
    f"{PKG_NAME}/resilience/engine.py",
)

#: host-collective call names that pair blocking rounds across processes
#: (Group, HostComm and GuardedComm methods): a divergent branch around
#: any of these wedges the group.  Not ``warmup`` and not ``gather``
#: (unrelated names elsewhere).
COLLECTIVE_CALL_NAMES = frozenset(
    {"allreduce", "allreduce_many", "allreduce_groups", "allgather",
     "allgather_np", "gather_rows", "psum", "exchange_planes", "barrier"})

#: (file, function) -> ``calls:<consensus primitive>`` or ``exempt``
#: (which needs a ``consensus-exempt:`` comment saying why).
CONSENSUS_SITES = {
    # the sharded-setup engage decision gates collective code paths
    (f"{PKG_NAME}/solver/driver.py", "_setup_shard_engage"):
        "calls:agree_flag",
    # export-glue layout exchange: unconditional data movement
    (f"{PKG_NAME}/solver/driver.py", "_exchange_export_glue"): "exempt",
    # the comm-split probe's barriers: no verdict, every rank runs them
    (f"{PKG_NAME}/solver/driver.py", "measure_comm_split"): "exempt",
    # the run store's prepared barrier: no verdict
    (f"{PKG_NAME}/solver/driver.py", "solve"): "exempt",
    # the chunk loops open every chunk with the guarded liveness sync
    (f"{PKG_NAME}/solver/chunked.py", "_run_direct"):
        "calls:sync_boundary",
    (f"{PKG_NAME}/solver/chunked.py", "_run_mixed"):
        "calls:sync_boundary",
    # ladder triggers are group-agreed before branching
    (f"{PKG_NAME}/resilience/engine.py", "run_with_recovery"):
        "calls:agree_trigger",
    (f"{PKG_NAME}/resilience/engine.py", "run_many_with_recovery"):
        "calls:agree_triggers",
}


def _has_collective_call(fn: ast.FunctionDef,
                         names=COLLECTIVE_CALL_NAMES) -> bool:
    return any(isinstance(n, ast.Call) and _call_name(n) in names
               for n in ast.walk(fn))


def check_consensus_coverage(sources: Dict[str, str],
                             sites: Optional[dict] = None,
                             call_names=COLLECTIVE_CALL_NAMES) -> List[str]:
    """Coverage violations for ``{relpath: source}`` against ``sites``
    (default :data:`CONSENSUS_SITES`)."""
    sites = CONSENSUS_SITES if sites is None else sites
    errs: List[str] = []
    for rel, source in sources.items():
        errs.extend(_registry_errors(
            rel, source, sites,
            lambda fn: _has_collective_call(fn, call_names),
            "consensus-exempt:", "collective site",
            "calls a host-side collective but is not registered in "
            "CONSENSUS_SITES — route its verdict through "
            "parallel/consensus (agree / agree_flag / agree_trigger / "
            "agree_triggers) and register it, or register a documented "
            "exemption",
            "a divergent group verdict wedges the fleet"))
    return errs


@rule("consensus-coverage", kind="ast", fast=True,
      doc="every host-side collective call site on the dispatch path "
          "(driver.py / chunked.py / resilience engine) routes its group "
          "verdict through parallel/consensus or carries a documented "
          "`consensus-exempt:` justification")
def consensus_coverage_rule(ctx) -> List[Finding]:
    sources, errs = _read_sources("consensus-coverage",
                                  CONSENSUS_COVERAGE_FILES)
    if errs:
        return errs
    if ctx is not None:
        ctx.checked("consensus-coverage", "files", len(sources))
        ctx.checked("consensus-coverage", "sites", len(CONSENSUS_SITES))
    out = []
    for err in check_consensus_coverage(sources):
        loc, _, msg = err.partition(": ")
        out.append(Finding(rule="consensus-coverage", loc=loc, message=msg))
    return out


# ----------------------------------------------------------------------
# serve-admission-events
# ----------------------------------------------------------------------

ADMISSION_COVERAGE_FILES = (f"{PKG_NAME}/serve/admission.py",
                            f"{PKG_NAME}/serve/daemon.py")

#: (file, function) -> the event kinds it must emit through a
#: constant-first-argument ``.event("<kind>", ...)`` call; each kind
#: must be in the port's ``obs/schema.EVENT_KINDS``.
ADMISSION_EVENT_SITES = {
    (f"{PKG_NAME}/serve/admission.py", "admit"): ("job_admit",),
    (f"{PKG_NAME}/serve/admission.py", "_reject"): ("job_reject",),
    (f"{PKG_NAME}/serve/admission.py", "shed_past_deadline"):
        ("job_shed",),
    (f"{PKG_NAME}/serve/daemon.py", "_dispatch_block"):
        ("job_done", "job_quarantine"),
    (f"{PKG_NAME}/serve/daemon.py", "_finish_failed"): ("job_done",),
    (f"{PKG_NAME}/serve/daemon.py", "run"): ("serve_drain",),
}


def _emits_event(fn: ast.FunctionDef, kind: str) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and node.args \
                and _call_name(node) == "event":
            a = node.args[0]
            if isinstance(a, ast.Constant) and a.value == kind:
                return True
    return False


def check_admission_events(sources: Dict[str, str],
                           sites: Optional[dict] = None,
                           kinds_known=None) -> List[str]:
    """Violations for ``{relpath: source}`` against ``sites`` (default
    :data:`ADMISSION_EVENT_SITES`) and the schema's kinds."""
    if kinds_known is None:
        from pcg_mpi_solver_tpu_torch.obs.schema import EVENT_KINDS

        kinds_known = EVENT_KINDS
    sites = ADMISSION_EVENT_SITES if sites is None else sites
    errs: List[str] = []
    for rel, source in sources.items():
        try:
            tree = ast.parse(source)
        except SyntaxError as e:
            errs.append(f"{rel}:0: unparseable ({e})")
            continue
        fns = {fn.name: fn for fn in _top_level_functions(tree)}
        for (f, name), kinds in sorted(sites.items()):
            if f != rel:
                continue
            fn = fns.get(name)
            if fn is None:
                errs.append(
                    f"{rel}:0: ADMISSION_EVENT_SITES registers `{name}` "
                    "but no such function exists — update the registry")
                continue
            for kind in kinds:
                if kind not in kinds_known:
                    errs.append(
                        f"{rel}:{fn.lineno}: ADMISSION_EVENT_SITES "
                        f"requires `{name}` to emit `{kind}`, which is not "
                        "a schema EVENT_KINDS kind — fix the registry or "
                        "add the kind to obs/schema.py")
                    continue
                if not _emits_event(fn, kind):
                    errs.append(
                        f"{rel}:{fn.lineno}: admission-decision site "
                        f"`{name}` no longer emits the schema-versioned "
                        f"`{kind}` event — a service outcome would go "
                        "silent")
    return errs


@rule("serve-admission-events", kind="ast", fast=True,
      doc="every solve-service admission/lifecycle outcome (admit, "
          "reject, shed, done, quarantine, drain) emits its "
          "schema-versioned telemetry event — decisions are never silent")
def serve_admission_events_rule(ctx) -> List[Finding]:
    sources, errs = _read_sources("serve-admission-events",
                                  ADMISSION_COVERAGE_FILES)
    if errs:
        return errs
    if ctx is not None:
        ctx.checked("serve-admission-events", "sites",
                    len(ADMISSION_EVENT_SITES))
        ctx.checked("serve-admission-events", "events",
                    sum(len(k) for k in ADMISSION_EVENT_SITES.values()))
    out = []
    for err in check_admission_events(sources):
        loc, _, msg = err.partition(": ")
        out.append(Finding(rule="serve-admission-events", loc=loc,
                           message=msg))
    return out

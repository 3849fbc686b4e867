"""Contract-lint rule engine: registry, findings, baseline, reports.

Port of ``pcg_mpi_solver_tpu/analysis/engine.py``.  Rules declare
themselves into ``RULES`` through :func:`rule`; the trip rules record the
port's loop lazily, inside their run functions, so importing
``pcg_mpi_solver_tpu_torch.analysis`` loads neither torch nor JAX.

Severity: every violated invariant is an ``error`` (exit 1); ``warn``
findings are reported and do not fail the lint.  A baseline file
(``analysis/baseline.json``) suppresses known, documented findings by
exact (rule, loc) match; the shipped baseline is EMPTY.  Exit codes: 0
clean, 1 findings, 2 a rule or the engine crashed.

No rule is vacuous: each one reports what it checked through
:meth:`Context.checked` (programs, trips, files, fields, ...), the report
carries those counts, and a rule that checked nothing is a finding.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import traceback
from typing import Callable, Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: shipped (empty) baseline — the --baseline default.
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baseline.json")

BASELINE_SCHEMA = "pcg-tpu-lint-baseline/1"
REPORT_SCHEMA = "pcg-tpu-lint-report/1"


@dataclasses.dataclass
class Finding:
    """One rule violation.  ``loc`` is the stable anchor used for
    baseline matching: ``path:line`` for source rules, ``program:<name>``
    / ``surface:<name>`` / ``field:<name>`` for the recorded ones."""

    rule: str
    loc: str
    message: str
    severity: str = "error"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return f"[{self.rule}] {self.loc}: {self.message}"


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    kind: str          # "ast" | "artifact" | "trip" | "config"
    fast: bool         # included in --fast
    doc: str
    fn: Callable[["Context"], List[Finding]]


RULES: Dict[str, Rule] = {}


def rule(rule_id: str, *, kind: str, fast: bool, doc: str):
    """Register a rule.  ``fn(ctx) -> [Finding]``; an exception is
    converted into an engine error by the runner."""
    def deco(fn):
        RULES[rule_id] = Rule(rule_id, kind, fast, doc, fn)
        return fn
    return deco


class Context:
    """Per-run context handed to every rule: the mode, the device the
    trip rules record on (None: the card, ``solver/driver.resolve_device``
    raising without one), the lazily recorded program matrix, and the
    counts of what each rule checked."""

    def __init__(self, fast: bool = False, device: Optional[str] = None):
        self.fast = bool(fast)
        self.device = device
        self.repo = REPO
        self.counts: Dict[str, Dict[str, int]] = {}

    def checked(self, rule_id: str, what: str, n: int) -> None:
        """Record that ``rule_id`` checked ``n`` more ``what``."""
        d = self.counts.setdefault(rule_id, {})
        d[what] = d.get(what, 0) + int(n)

    def device_type(self) -> str:
        from pcg_mpi_solver_tpu_torch.solver.driver import resolve_device

        return resolve_device(self.device).type

    def programs(self):
        from pcg_mpi_solver_tpu_torch.analysis import programs as _p

        return _p.build_programs(fast=self.fast, device=self.device_type())


@dataclasses.dataclass
class Report:
    findings: List[Finding]
    suppressed: List[Finding]
    rules_run: List[str]
    errors: List[str]
    fast: bool
    wall_s: float
    checked: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)
    device: Optional[str] = None

    @property
    def clean(self) -> bool:
        return not self.errors and not any(
            f.severity == "error" for f in self.findings)

    @property
    def exit_code(self) -> int:
        if self.errors:
            return 2
        return 0 if self.clean else 1

    def to_dict(self) -> dict:
        return {
            "schema": REPORT_SCHEMA,
            "fast": self.fast,
            "device": self.device,
            "clean": self.clean,
            "rules_run": list(self.rules_run),
            "checked": {k: dict(v) for k, v in self.checked.items()},
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "errors": list(self.errors),
            "wall_s": round(self.wall_s, 3),
        }

    def render(self) -> str:
        lines = []
        for rid in self.rules_run:
            what = ", ".join(f"{n} {k}" for k, n in
                             sorted(self.checked.get(rid, {}).items()))
            lines.append(f"checked [{rid}]: {what or 'nothing'}")
        for f in self.findings:
            lines.append(str(f))
        for f in self.suppressed:
            lines.append(f"(baselined) {f}")
        for e in self.errors:
            lines.append(f"[engine-error] {e}")
        n_err = sum(1 for f in self.findings if f.severity == "error")
        mode = "fast" if self.fast else "full"
        lines.append(
            f"pcg-tpu lint ({mode}): {len(self.rules_run)} rule(s), "
            f"{n_err} error(s), {len(self.suppressed)} baselined, "
            f"{len(self.errors)} engine error(s) "
            f"[{self.wall_s:.1f}s]")
        return "\n".join(lines)


def load_baseline(path: Optional[str]) -> List[dict]:
    """Suppression entries from a baseline file; missing file => empty.
    Entry shape: {"rule": id, "loc": anchor, "reason": why} — reason is
    mandatory, an undocumented suppression is itself a finding."""
    if not path or not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if doc.get("schema") != BASELINE_SCHEMA:
        raise ValueError(f"{path}: expected baseline schema "
                         f"{BASELINE_SCHEMA!r}, got {doc.get('schema')!r}")
    return list(doc.get("suppressions", []))


def apply_baseline(findings: List[Finding], entries: List[dict],
                   ) -> tuple:
    """(active, suppressed): exact (rule, loc) match suppresses; entries
    without a reason become findings, and entries matching NO current
    finding surface as warn findings (a stale suppression would mask the
    same defect if it ever came back at that anchor)."""
    keys = {(e.get("rule"), e.get("loc")) for e in entries
            if e.get("reason")}
    active, suppressed, hit = [], [], set()
    for f in findings:
        if (f.rule, f.loc) in keys:
            suppressed.append(f)
            hit.add((f.rule, f.loc))
        else:
            active.append(f)
    for e in entries:
        if not e.get("reason"):
            active.append(Finding(
                rule="baseline", loc=str(e.get("loc")),
                message=f"baseline suppression for rule "
                        f"{e.get('rule')!r} carries no reason — document "
                        "it or delete it"))
        elif (e.get("rule"), e.get("loc")) not in hit:
            active.append(Finding(
                rule="baseline", loc=str(e.get("loc")), severity="warn",
                message=f"stale suppression: rule {e.get('rule')!r} no "
                        "longer reports here — delete the entry so a "
                        "future regression at this anchor is not "
                        "silently masked"))
    return active, suppressed


def _ensure_rules_registered() -> None:
    # imported for the registration side effect; every module is
    # import-light (torch only inside rule bodies)
    from pcg_mpi_solver_tpu_torch.analysis import (  # noqa: F401
        rules_artifacts, rules_ast, rules_config, rules_trip)


def run_lint(fast: bool = False, rule_ids: Optional[List[str]] = None,
             baseline_path: Optional[str] = DEFAULT_BASELINE,
             device: Optional[str] = None) -> Report:
    """Run the registered rules and return a :class:`Report`.

    ``fast`` runs the pre-window subset (source, artifact and config
    rules plus the trip proofs on the reduced matrix); ``rule_ids``
    restricts to specific rules (unknown id => ValueError); ``device``
    is where the trip rules record ("cpu" or "cuda"; None = the card).
    """
    _ensure_rules_registered()
    t0 = time.monotonic()
    if rule_ids:
        unknown = [r for r in rule_ids if r not in RULES]
        if unknown:
            raise ValueError(f"unknown rule id(s) {unknown}; have "
                             f"{sorted(RULES)}")
        selected = [RULES[r] for r in rule_ids]
    else:
        selected = [r for r in RULES.values() if r.fast or not fast]
    ctx = Context(fast=fast, device=device)
    findings: List[Finding] = []
    errors: List[str] = []
    rules_run: List[str] = []
    for r in sorted(selected, key=lambda r: (r.kind, r.id)):
        try:
            findings.extend(r.fn(ctx))
            rules_run.append(r.id)
        except Exception:  # noqa: BLE001 - reported as an engine error
            errors.append(f"rule {r.id} crashed:\n"
                          f"{traceback.format_exc()}")
            continue
        counts = ctx.counts.get(r.id, {})
        if not counts or not all(counts.values()):
            findings.append(Finding(
                rule=r.id, loc="coverage",
                message=f"the rule checked nothing ({counts}): a vacuous "
                        "pass proves no invariant"))
    entries = load_baseline(baseline_path)
    active, suppressed = apply_baseline(findings, entries)
    return Report(findings=active, suppressed=suppressed,
                  rules_run=rules_run, errors=errors, fast=fast,
                  wall_s=time.monotonic() - t0, checked=ctx.counts,
                  device=device)


def list_rules() -> List[Rule]:
    _ensure_rules_registered()
    return sorted(RULES.values(), key=lambda r: (r.kind, r.id))

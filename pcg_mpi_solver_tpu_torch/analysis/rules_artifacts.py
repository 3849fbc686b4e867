"""Artifact rules: telemetry validates against the port's versioned
contracts in ``obs/schema.py``, and every event kind is documented.

Port of ``pcg_mpi_solver_tpu/analysis/rules_artifacts.py``:

* ``telemetry-schema`` — a telemetry JSONL the port writes in a real CPU
  run (one quasi-static solve, ``RunConfig.telemetry_path``) validates
  line by line; each committed ``BENCH_*.json`` artifact must be a JSON
  object whose bench line validates (``validate_bench_text``).  Nothing
  is loosened to make a file pass;
* ``doc-schema-sync`` — every kind of the port's ``EVENT_KINDS`` has a
  row in ``docs/OBSERVABILITY.md``'s event table (read, never edited).
"""

from __future__ import annotations

import glob
import json
import os
import re
import tempfile
from typing import List

from pcg_mpi_solver_tpu_torch.analysis.engine import REPO, Finding, rule


def default_paths() -> list:
    """The committed bench artifacts."""
    return sorted(glob.glob(os.path.join(REPO, "BENCH_*.json")))


def check_bench_file(path: str) -> List[str]:
    """Errors of one committed bench artifact under the port's schema."""
    from pcg_mpi_solver_tpu_torch.obs import schema

    try:
        with open(path, encoding="utf-8") as f:
            text = f.read()
        doc = json.loads(text)
    except (OSError, ValueError) as e:
        return [f"unreadable ({e})"]
    if not isinstance(doc, dict):
        return [f"not a JSON object ({type(doc).__name__})"]
    return schema.validate_bench_text(text)


def telemetry_run_text() -> str:
    """The telemetry JSONL of one small quasi-static solve on the CPU."""
    from pcg_mpi_solver_tpu_torch.analysis.programs import build_solver

    with tempfile.TemporaryDirectory(prefix="pcg_lint_tel_") as tmp:
        path = os.path.join(tmp, "run.jsonl")
        s = build_solver("general", device="cpu", n_parts=1,
                         run_overrides={"telemetry_path": path,
                                        "scratch_path": tmp})
        s.solve()
        s.recorder.close()
        with open(path, encoding="utf-8") as f:
            return f.read()


def check_jsonl_text(text: str) -> List[str]:
    from pcg_mpi_solver_tpu_torch.obs.schema import validate_jsonl_text

    return validate_jsonl_text(text)


@rule("telemetry-schema", kind="artifact", fast=True,
      doc="a telemetry JSONL the port writes in a CPU run validates "
          "against obs/schema.py, and so does every committed "
          "BENCH_*.json artifact's bench line")
def telemetry_schema_rule(ctx) -> List[Finding]:
    findings = []
    text = telemetry_run_text()
    events = sum(1 for ln in text.splitlines() if ln.strip())
    for err in check_jsonl_text(text):
        findings.append(Finding(rule="telemetry-schema",
                                loc="telemetry:cpu-run", message=err))
    paths = default_paths()
    for p in paths:
        for err in check_bench_file(p):
            findings.append(Finding(rule="telemetry-schema",
                                    loc=os.path.relpath(p, REPO),
                                    message=err))
    if ctx is not None:
        ctx.checked("telemetry-schema", "telemetry events", events)
        ctx.checked("telemetry-schema", "bench files", len(paths))
    return findings


# -- doc-schema sync ------------------------------------------------------

EVENT_TABLE_DOC = os.path.join("docs", "OBSERVABILITY.md")


def documented_event_kinds(doc_text: str) -> set:
    """Event kinds documented in the doc's event table: the first
    backticked token of each table row (``| `kind` | ... |``)."""
    kinds = set()
    for line in doc_text.splitlines():
        m = re.match(r"^\|\s*`([a-z0-9_]+)`\s*\|", line)
        if m:
            kinds.add(m.group(1))
    return kinds


def check_doc_schema_sync(doc_text: str, kinds=None) -> List[str]:
    """One error a kind of ``EVENT_KINDS`` with no row in the doc's event
    table."""
    if kinds is None:
        from pcg_mpi_solver_tpu_torch.obs.schema import EVENT_KINDS

        kinds = EVENT_KINDS
    documented = documented_event_kinds(doc_text)
    return [f"event kind `{k}` (obs/schema.py EVENT_KINDS) has no row "
            f"in the event table"
            for k in kinds if k not in documented]


@rule("doc-schema-sync", kind="artifact", fast=True,
      doc="every event kind in the port's obs/schema.py EVENT_KINDS has a "
          "row in docs/OBSERVABILITY.md's event table")
def doc_schema_sync_rule(ctx) -> List[Finding]:
    from pcg_mpi_solver_tpu_torch.obs.schema import EVENT_KINDS

    path = os.path.join(REPO, EVENT_TABLE_DOC)
    try:
        with open(path, encoding="utf-8") as f:
            text = f.read()
    except OSError as e:
        return [Finding(rule="doc-schema-sync", loc=EVENT_TABLE_DOC,
                        message=f"unreadable ({e})")]
    if ctx is not None:
        ctx.checked("doc-schema-sync", "event kinds", len(EVENT_KINDS))
    return [Finding(rule="doc-schema-sync", loc=EVENT_TABLE_DOC,
                    message=msg)
            for msg in check_doc_schema_sync(text)]

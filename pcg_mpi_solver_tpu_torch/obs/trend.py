"""Bench-trend regression sentinel: mechanical before/after verdicts
over a series of bench artifacts (the committed ``BENCH_r*.json`` and
fresh lines of the port's ``bench.py``).

Port of ``pcg_mpi_solver_tpu/obs/trend.py``.  The sentinel:

* tolerantly extracts every bench line from each artifact (round
  wrapper ``parsed``, JSON lines embedded in ``tail``, or a raw
  one-line artifact), skipping the zero-value error sentinels and
  failed-round wrappers (rc != 0, parsed null);

* matches legs across rounds by SHAPE, CONFIGURATION AND PLATFORM —
  (metric, model, n_dof, mode, backend, pcg_variant, precond, nrhs,
  platform class, device) — so a 144^3 mg leg never compares against
  the 150^3 jacobi flagship, and pre-schema lines (no
  pcg_variant/precond fields) match under the historical defaults
  (classic/jacobi/nrhs=1);

* prints per-leg deltas with threshold-based verdicts — ``regressed``
  (new value < old * (1 - threshold)), ``improved``, ``flat`` — plus
  the unmatched singletons, and reports an exit code that reflects
  regressions (``python -m pcg_mpi_solver_tpu_torch.cli trend``).

One deliberate difference from the JAX package: :func:`leg_key` adds
the line's platform class (the first word of ``detail.platform``) and
``detail.device``.  Without them the port's flagship line on the card
would pair with a TPU round of the same shape and put a TPU number into
a verdict on the card.  Lines of one platform and device get the JAX
package's verdicts unchanged.

Higher-is-better is the contract of every ``value`` the bench emits
(dof*iter/s and jobs/s throughputs); a future lower-is-better metric
must be added to :data:`LOWER_IS_BETTER` or its verdicts would invert
silently.

Import-light: neither torch nor numpy.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List, Optional, Tuple

#: default relative-change threshold separating flat from
#: regressed/improved (10%: the JAX package's rounds showed
#: single-digit-% run-to-run noise; override with --threshold /
#: threshold=).
DEFAULT_THRESHOLD = 0.10

#: metrics where a SMALLER value is the better one.  Everything the
#: bench emits today is a throughput (higher-better); the set exists so
#: adding a latency metric is a one-line change, not a silent inversion.
LOWER_IS_BETTER = frozenset()


def iter_bench_lines(path: str) -> List[dict]:
    """Every parseable bench metric line in one artifact, deduplicated.
    Tolerates every committed artifact shape: the round wrapper (parsed
    + tail-embedded lines), a raw one-line metric file, and the failed
    rounds (rc != 0, parsed null) which simply contribute nothing."""
    try:
        with open(path, encoding="utf-8") as f:
            text = f.read()
    except OSError:
        return []
    lines: List[dict] = []

    def add(obj):
        if not isinstance(obj, dict) or "metric" not in obj:
            return
        try:
            value = float(obj.get("value", 0))
        except (TypeError, ValueError):
            return
        if value <= 0:
            return                  # the zero-value error sentinel
        if any(o is obj or (o.get("metric"), o.get("value")) ==
               (obj.get("metric"), obj.get("value")) for o in lines):
            return                  # tail often repeats the parsed line
        lines.append(obj)

    try:
        doc = json.loads(text)
    except ValueError:
        doc = None
    if isinstance(doc, dict):
        add(doc)                                    # raw one-line artifact
        if isinstance(doc.get("parsed"), dict):
            add(doc["parsed"])                      # round wrapper
        # a FAILED round's tail (rc != 0) may still carry provisional/
        # insurance lines emitted before the death — they are not that
        # round's measurement and must not become the leg's newest
        # value (the failed-round-contributes-nothing contract)
        tail = doc.get("tail", "") if doc.get("rc", 0) == 0 else ""
    else:
        tail = text                                 # JSONL-ish fallback
    for ln in str(tail).splitlines():
        ln = ln.strip()
        if not ln.startswith("{"):
            continue
        try:
            add(json.loads(ln))
        except ValueError:
            continue
    return lines


def platform_class(line: dict) -> str:
    """The first word of ``detail.platform``, lowercased ("tpu", "gpu",
    "cpu"; a CPU fallback's "cpu (CPU FALLBACK ...)" is "cpu"), "?" when
    the line names none."""
    words = str((line.get("detail") or {}).get("platform") or "").split()
    return words[0].lower() if words else "?"


def leg_key(line: dict) -> Tuple:
    """The cross-round matching identity of one bench line: shape +
    configuration + platform class + device.  Pre-schema lines (no
    variant/precond/nrhs fields) match under the historical defaults —
    BENCH_r01..r05 predate those knobs and all measured
    classic/jacobi/nrhs=1."""
    d = line.get("detail") or {}
    return (
        str(line.get("metric", "?")),
        str(d.get("model", "?")),
        int(d.get("n_dof", 0) or 0),
        str(d.get("mode", "?")),
        str(d.get("backend", "?")),
        str(d.get("pcg_variant") or "classic"),
        str(d.get("precond") or "jacobi"),
        int(d.get("nrhs", 1) or 1),
        platform_class(line),
        str(d.get("device") or "?"),
    )


def _key_label(key: Tuple) -> str:
    (metric, model, n_dof, mode, backend, variant, precond, nrhs,
     platform, device) = key
    return (f"{model}/{n_dof} {mode} {backend} {variant}+{precond}"
            + (f" nrhs={nrhs}" if nrhs != 1 else "")
            + f" [{platform}" + (f", {device}" if device != "?" else "")
            + "]")


def default_series(root: str = ".") -> List[str]:
    """The committed round artifacts, in round order."""
    return sorted(glob.glob(os.path.join(root, "BENCH_r*.json")))


def trend_report(paths: List[str], fresh: Optional[str] = None,
                 threshold: float = DEFAULT_THRESHOLD) -> Dict[str, Any]:
    """Match legs across the artifact series (plus an optional fresh
    artifact appended as the newest round) and compute per-leg deltas
    and verdicts.  Returns the report dict ``format_report`` renders;
    ``regressed`` > 0 is the non-zero-exit condition."""
    series: List[Tuple[str, dict]] = []
    sources: List[Dict[str, Any]] = []
    for p in list(paths) + ([fresh] if fresh else []):
        label = os.path.basename(p)
        lines = iter_bench_lines(p)
        sources.append({"path": p, "label": label, "lines": len(lines)})
        for ln in lines:
            series.append((label, ln))

    by_key: Dict[Tuple, List[Tuple[str, dict]]] = {}
    for label, ln in series:
        by_key.setdefault(leg_key(ln), []).append((label, ln))

    legs: List[Dict[str, Any]] = []
    counts = {"regressed": 0, "improved": 0, "flat": 0, "single": 0}
    for key in sorted(by_key):
        entries = by_key[key]
        # ONE representative per round: a round's artifact often carries
        # the final line NEXT TO insurance/salvage near-duplicates of
        # the same leg — comparing two lines of the same round would
        # shadow (and silently mask) the cross-round regression.  The
        # representative is the round's best value: the round's real
        # measurement, with its conservative insurance twins below it.
        per_round: Dict[str, dict] = {}
        order: List[str] = []
        for label, ln in entries:
            if label not in per_round:
                order.append(label)
                per_round[label] = ln
            elif float(ln["value"]) > float(per_round[label]["value"]):
                per_round[label] = ln
        if len(order) < 2:
            counts["single"] += 1
            label = order[0]
            legs.append({"leg": _key_label(key), "verdict": "single",
                         "old_round": None, "old_value": None,
                         "new_round": label,
                         "new_value": float(per_round[label]["value"]),
                         "delta_pct": None})
            continue
        old_label, new_label = order[-2], order[-1]
        old, new = per_round[old_label], per_round[new_label]
        ov, nv = float(old["value"]), float(new["value"])
        delta = (nv - ov) / ov if ov else 0.0
        better = -delta if key[0] in LOWER_IS_BETTER else delta
        verdict = ("regressed" if better < -threshold
                   else "improved" if better > threshold else "flat")
        counts[verdict] += 1
        legs.append({"leg": _key_label(key), "verdict": verdict,
                     "old_round": old_label, "old_value": ov,
                     "new_round": new_label, "new_value": nv,
                     "delta_pct": round(delta * 100.0, 2),
                     "rounds_seen": len(order)})
    return {"schema": "pcg-tpu-trend/1", "threshold": threshold,
            "sources": sources, "legs": legs, **counts}


def verdict_line(report: Dict[str, Any]) -> str:
    """One-line summary.  A zero-matched-leg
    series says so by NAME — a gate must be able to tell a vacuous pass
    from a genuinely flat comparison."""
    matched = (report["regressed"] + report["improved"] + report["flat"])
    head = ("REGRESSED" if report["regressed"]
            else "improved" if report["improved"]
            else "flat" if matched else "no matched legs")
    return (f"{head} — {matched} matched leg(s): "
            f"{report['regressed']} regressed, "
            f"{report['improved']} improved, {report['flat']} flat "
            f"({report['single']} unmatched singleton(s); "
            f"threshold {report['threshold']:.0%})")


def format_report(report: Dict[str, Any]) -> str:
    lines = []
    for s in report["sources"]:
        lines.append(f">{s['label']}: {s['lines']} bench line(s)")
    lines.append("")
    lines.append(f"{'leg':<60} {'old':>12} {'new':>12} {'delta':>8} "
                 f"verdict")
    for leg in report["legs"]:
        old = (f"{leg['old_value']:.3g}" if leg["old_value"] is not None
               else "-")
        delta = (f"{leg['delta_pct']:+.1f}%"
                 if leg["delta_pct"] is not None else "-")
        mark = {"regressed": " <-- REGRESSION", "improved": " (better)",
                }.get(leg["verdict"], "")
        lines.append(f"{leg['leg']:<60} {old:>12} "
                     f"{leg['new_value']:>12.3g} {delta:>8} "
                     f"{leg['verdict']}{mark}")
    lines.append("")
    lines.append("trend verdict: " + verdict_line(report))
    return "\n".join(lines)


def main_cli(paths: List[str], fresh: Optional[str] = None,
             threshold: float = DEFAULT_THRESHOLD) -> int:
    """The ``cli trend`` body: print the table, return the exit
    code — 1 = at least one regressed matched leg; 2 = nothing to
    compare at all (no artifacts, or no artifact carried a single
    bench line); 0 otherwise (including a series of unmatched
    singletons, which the verdict line names as 'no matched legs'
    rather than 'flat')."""
    if not paths:
        paths = default_series()
    if not paths:
        print("trend: no BENCH_r*.json artifacts found (pass paths, or "
              "run from the repo root)")
        return 2
    report = trend_report(paths, fresh=fresh, threshold=threshold)
    print(format_report(report))
    if all(s["lines"] == 0 for s in report["sources"]):
        print("trend: no bench lines in any artifact — nothing to "
              "compare")
        return 2
    return 1 if report["regressed"] else 0

"""analysis/ — the contract lint of the port's structural claims.

Port of ``pcg_mpi_solver_tpu/analysis``: the same sixteen rule ids,
proving the same contracts on the port's own surfaces.  The JAX package
proves its claims on traced jaxprs; the port's PCG loop is driven from
the host, so its loop-level rules read RECORDED TRIPS of real solves
(``trip.py``, ``programs.py``) on two gloo ranks, on the card or on the
CPU:

* ``engine``          — rule registry, findings, baseline, reports
* ``rules_trip``      — collective-budget, psum-overlap, scope-labels,
                        hot-loop-purity, dtype-discipline,
                        donation-integrity
* ``rules_config``    — fingerprint-completeness (perturb-and-record),
                        partition-key-components, cost-model-completeness
* ``rules_ast``       — recovery-paths, recovery-coverage,
                        consensus-coverage, serve-admission-events
* ``rules_artifacts`` — telemetry-schema, doc-schema-sync
* ``trip``            — the trip recorder (dispatch mode, collectives,
                        launches, host reads, profiler ranges)
* ``programs``        — the recorded program matrix (one two-rank spawn)
* ``collectives``     — the JAX package's collective-count API

Entry points: ``python -m pcg_mpi_solver_tpu_torch.analysis`` and
``python -m pcg_mpi_solver_tpu_torch.cli lint`` (``--fast`` / ``--json`` /
``--baseline`` / ``--rules`` / ``--list-rules`` / ``--device``).  The trip
rules record on the card unless ``--device cpu`` is given; without a card
they fail (exit 2) rather than run on the CPU unasked.

Import contract: importing this package loads neither torch nor JAX (and
nothing of the JAX package); torch loads when a rule that records runs.
"""

from pcg_mpi_solver_tpu_torch.analysis.engine import (
    DEFAULT_BASELINE, Finding, Report, Rule, RULES, list_rules, run_lint)

__all__ = [
    "DEFAULT_BASELINE",
    "Finding",
    "Report",
    "Rule",
    "RULES",
    "list_rules",
    "run_lint",
]

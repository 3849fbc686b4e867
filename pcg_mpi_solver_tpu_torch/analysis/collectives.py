"""The collective-count API of the JAX package's
``analysis/collectives.py`` (``EXPECTED_BODY_PSUMS``,
``iteration_psum_count``, ``run_checks``), over recorded trips.

The counts are derived from the tables ``Ops.comm_estimate`` and
``Ops.trip_collective_budget`` read (``obs/perf.py``:
``PCG_SCALAR_PSUMS``, ``PCG_DEFERRED_CHECK_PSUMS``), so the gauges, this
check and the collective-budget rule read one table.
On a two-part general partition (the interface all-reduce present):

* ``EXPECTED_TRIP_ALL_REDUCES`` — an iterate trip: the variant's scalar
  reductions + the matvec's interface all-reduce (classic 4, fused 2,
  pipelined 2), the same for one column and for a block;
* ``EXPECTED_BODY_PSUMS`` — the JAX package's loop-body count, every
  branch of the body (classic 5, fused 3, pipelined 3), which the port
  runs as a blocked check trip: a full trip with the deferred check.

The programs are recorded by one spawn of two gloo ranks
(``programs.build_programs``), on the CPU unless ``device`` says else.
"""

from __future__ import annotations

from pcg_mpi_solver_tpu_torch.obs.perf import (
    PCG_DEFERRED_CHECK_PSUMS, PCG_SCALAR_PSUMS)

EXPECTED_TRIP_ALL_REDUCES = {v: n + 1 for v, n in PCG_SCALAR_PSUMS.items()}
EXPECTED_BODY_PSUMS = {v: n + 1 + PCG_DEFERRED_CHECK_PSUMS
                       for v, n in PCG_SCALAR_PSUMS.items()}


def _specs(nrhs_set):
    return [dict(backend="general", variant=v, nrhs=n, role="f64",
                 precond="jacobi")
            for v in PCG_SCALAR_PSUMS for n in nrhs_set]


def _programs(nrhs_set=(1, 8), device: str = "cpu"):
    from pcg_mpi_solver_tpu_torch.analysis.programs import build_programs

    return [p for p in build_programs(device=device,
                                      specs=_specs(nrhs_set))
            if p.rank == 0]


def iteration_all_reduce_count(variant: str, nrhs: int = 1,
                               kind: str = "iterate",
                               device: str = "cpu") -> int:
    """All-reduces of one recorded ``kind`` trip of ``variant`` at
    ``nrhs`` columns, rank 0 of a two-part general partition."""
    for p in _programs(device=device):
        if p.variant == variant and p.nrhs == nrhs:
            return p.trips[kind].counts()["all_reduce"]
    raise KeyError(f"no recorded program {variant!r} nrhs={nrhs}")


def iteration_psum_count(variant: str, nrhs: int = 1,
                         device: str = "cpu") -> int:
    """The JAX package's name: the all-reduces of an iterate trip."""
    return iteration_all_reduce_count(variant, nrhs, device=device)


def run_checks(nrhs_batched: int = 8, device: str = "cpu") -> list:
    """Error strings (empty = the counts hold): every variant's iterate
    trip runs ``EXPECTED_TRIP_ALL_REDUCES`` at one column and at
    ``nrhs_batched``, its blocked check trip ``EXPECTED_BODY_PSUMS``, and
    fused saves exactly classic's two serialised reductions."""
    errs = []
    counts = {}
    for variant, want in EXPECTED_TRIP_ALL_REDUCES.items():
        got = counts[variant] = iteration_all_reduce_count(
            variant, 1, device=device)
        if got != want:
            errs.append(f"{variant}: {got} all-reduces a trip, documented "
                        f"count is {want}")
        got_b = iteration_all_reduce_count(variant, nrhs_batched,
                                           device=device)
        if got_b != want:
            errs.append(f"{variant} batched (nrhs={nrhs_batched}): {got_b} "
                        f"all-reduces a trip, must equal the nrhs=1 count "
                        f"{want}")
        body = iteration_all_reduce_count(variant, nrhs_batched, "check",
                                          device=device)
        if body != EXPECTED_BODY_PSUMS[variant]:
            errs.append(f"{variant}: the blocked check trip runs {body} "
                        f"all-reduces, the JAX package's body "
                        f"{EXPECTED_BODY_PSUMS[variant]}")
    if not errs and counts["fused"] != counts["classic"] - 2:
        errs.append(f"fused must save exactly the two serialised scalar "
                    f"reductions: classic={counts['classic']} "
                    f"fused={counts['fused']}")
    return errs

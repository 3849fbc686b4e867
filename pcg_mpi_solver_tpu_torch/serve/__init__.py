"""The solve service (port of ``pcg_mpi_solver_tpu/serve``): admission
control, backpressure, nrhs packing and crash-durable exactly-once jobs
over the blocked solve, ``Solver.solve_many``.

The service is a filesystem protocol, with no network:

* ``spool/incoming/<job>.json``: atomically submitted job specs
  (``submit``, :mod:`serve.jobs`);
* ``spool/results/<job>.json`` (+ ``.npy``): atomically written outcomes,
  always with a named verdict (done, failed, rejected or shed);
* ``spool/journal.jsonl``: the fsync'd job journal (:mod:`serve.journal`,
  on the flight recorder): ``admitted``/``packed``/``dispatched``/
  ``done``/``failed`` records whose replay gives exactly-once jobs across
  a daemon's death.

Layers: :mod:`serve.jobs` (spool IO), :mod:`serve.journal` (journal and
replay), :mod:`serve.admission` (cost-model pricing, bounded queue,
shedding), :mod:`serve.packer` (standard nrhs widths), :mod:`serve.daemon`
(the loop: signals, dispatch through ``Solver.solve_many``).  All but the
daemon import neither torch nor numpy; the package's ``ServeDaemon``
export loads the daemon module (which imports them only when it
dispatches).  A spool is a file contract shared with the JAX package:
either package reads the other's journal.
"""

from pcg_mpi_solver_tpu_torch.serve.admission import AdmissionController
from pcg_mpi_solver_tpu_torch.serve.daemon import ServeDaemon
from pcg_mpi_solver_tpu_torch.serve.journal import (
    JOB_OPS, SERVE_JOURNAL_SCHEMA, TERMINAL_OPS, JobJournal,
    read_journal, replay_jobs)
from pcg_mpi_solver_tpu_torch.serve.packer import STANDARD_WIDTHS, pack_block

__all__ = [
    "AdmissionController", "JobJournal", "JOB_OPS", "SERVE_JOURNAL_SCHEMA",
    "ServeDaemon", "TERMINAL_OPS", "STANDARD_WIDTHS", "pack_block",
    "read_journal", "replay_jobs",
]

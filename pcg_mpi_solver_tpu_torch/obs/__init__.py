"""Solver telemetry (port of ``pcg_mpi_solver_tpu/obs``): the metrics
recorder and its sinks, the event schema, the convergence-trace ring,
the flight recorder, the cost model, the phase probes, the profiler
trace reader and the live monitor (``obs/watch.py``).

The package itself imports neither torch nor numpy: the solve service's
protocol modules (``serve/jobs.py``, ``journal.py``, ``packer.py``,
``admission.py``) and ``obs/watch.py`` ride ``obs/flight.py`` and must
load on a machine without the accelerator environment.  The exports of
``obs/trace.py``, which imports torch, load on first use (module
``__getattr__``)."""

from pcg_mpi_solver_tpu_torch.obs.flight import (
    FlightRecorder, flight_verdict, merge_shards, read_jsonl_tolerant,
    shard_jsonl_path)
from pcg_mpi_solver_tpu_torch.obs.metrics import (
    JsonlSink, MetricsRecorder, StderrSink, summarize_jsonl)
from pcg_mpi_solver_tpu_torch.obs.schema import TELEMETRY_SCHEMA

# obs/trace.py's exports, imported when first asked for
_TRACE_EXPORTS = ("ConvergenceTrace", "clamp_trace_len", "empty_trace",
                  "trace_init", "trace_record", "unpack_trace")

__all__ = ["TELEMETRY_SCHEMA", "ConvergenceTrace", "FlightRecorder",
           "JsonlSink", "MetricsRecorder", "StderrSink", "clamp_trace_len",
           "empty_trace", "flight_verdict", "merge_shards",
           "read_jsonl_tolerant", "shard_jsonl_path", "summarize_jsonl",
           "trace_init", "trace_record", "unpack_trace"]


def __getattr__(name):
    if name in _TRACE_EXPORTS:
        from pcg_mpi_solver_tpu_torch.obs import trace

        return getattr(trace, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

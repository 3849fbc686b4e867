"""Solver telemetry (port of ``pcg_mpi_solver_tpu/obs``): the metrics
recorder and its sinks, the event schema, the convergence-trace ring,
the flight recorder, the cost model, the phase probes and the profiler
trace reader."""

from pcg_mpi_solver_tpu_torch.obs.flight import (
    FlightRecorder, flight_verdict, merge_shards, read_jsonl_tolerant,
    shard_jsonl_path)
from pcg_mpi_solver_tpu_torch.obs.metrics import (
    JsonlSink, MetricsRecorder, StderrSink, summarize_jsonl)
from pcg_mpi_solver_tpu_torch.obs.schema import TELEMETRY_SCHEMA
from pcg_mpi_solver_tpu_torch.obs.trace import (
    ConvergenceTrace, clamp_trace_len, empty_trace, trace_init,
    trace_record, unpack_trace)

__all__ = ["TELEMETRY_SCHEMA", "ConvergenceTrace", "FlightRecorder",
           "JsonlSink", "MetricsRecorder", "StderrSink", "clamp_trace_len",
           "empty_trace", "flight_verdict", "merge_shards",
           "read_jsonl_tolerant", "shard_jsonl_path", "summarize_jsonl",
           "trace_init", "trace_record", "unpack_trace"]

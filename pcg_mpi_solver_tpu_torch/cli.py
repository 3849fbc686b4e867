"""Command-line interface of the port: the reference's five entry-point
programs (read_input_model / run_metis / partition_mesh / pcg_solver /
export_vtk, orchestrated by examples/run_basic_script.bash) as one typed
CLI, the JAX package's ``pcg_mpi_solver_tpu/cli.py`` with its flags.

    python -m pcg_mpi_solver_tpu_torch.cli ingest    <archive.zip> <scratch>
    python -m pcg_mpi_solver_tpu_torch.cli partition <scratch> <n_parts>
    python -m pcg_mpi_solver_tpu_torch.cli solve     <scratch> <run_id> [options]
    python -m pcg_mpi_solver_tpu_torch.cli solve-many <scratch> <run_id> [options]
    python -m pcg_mpi_solver_tpu_torch.cli dynamics  <scratch> <run_id> --n-steps N [options]
    python -m pcg_mpi_solver_tpu_torch.cli newmark   <scratch> <run_id> --n-steps N [options]
    python -m pcg_mpi_solver_tpu_torch.cli export    <scratch> <run_id> <vars> <mode>
    python -m pcg_mpi_solver_tpu_torch.cli demo      [--nx ...] [--octree|--poisson]
    python -m pcg_mpi_solver_tpu_torch.cli cache-stats [--cache-dir D]
    python -m pcg_mpi_solver_tpu_torch.cli summary   <run.jsonl> [...]
    python -m pcg_mpi_solver_tpu_torch.cli telemetry-merge <run.jsonl> --out M.jsonl
    python -m pcg_mpi_solver_tpu_torch.cli perf-report [scratch] [--nx N] [options]
    python -m pcg_mpi_solver_tpu_torch.cli prof-report <trace or capture dir>
    python -m pcg_mpi_solver_tpu_torch.cli fleet-report <capture root>
    python -m pcg_mpi_solver_tpu_torch.cli validate  <scratch> [--preflight=]
    python -m pcg_mpi_solver_tpu_torch.cli warmup    [scratch] --cache-dir D [options]
    python -m pcg_mpi_solver_tpu_torch.cli watch     <run.jsonl> [--once]
    python -m pcg_mpi_solver_tpu_torch.cli serve     --spool DIR [scratch | --synthetic NX,NY,NZ] [options]
    python -m pcg_mpi_solver_tpu_torch.cli submit    --spool DIR --scale S | --rhs F.npy
    python -m pcg_mpi_solver_tpu_torch.cli jobs      --spool DIR
    python -m pcg_mpi_solver_tpu_torch.cli lint      [--fast] [--device cpu] [--json F] [--rules ID,...]
    python -m pcg_mpi_solver_tpu_torch.cli bench     (BENCH_* environment knobs, bench.py)
    python -m pcg_mpi_solver_tpu_torch.cli trend     [BENCH_rNN.json ...] [--fresh F] [--threshold T]

``solve``, ``solve-many``, ``dynamics``, ``newmark``, ``demo``,
``perf-report``, ``warmup``, ``serve`` and ``lint`` (its trip rules,
``analysis/``) run on the card unless ``--device cpu`` is given, and
``bench`` unless ``BENCH_FORCE_CPU=1`` is set; ``submit``, ``jobs``,
``watch`` and ``trend`` load no torch (they work on a machine without
the accelerator environment).
Settings come from ``--settings settings.json`` (the shape of the
reference's GlobSettings: TimeHistoryParam/SolverParam,
run_basic_script.bash:30-49) or per-flag overrides.  ``--cache-dir``
(else ``PCG_TPU_CACHE_DIR``) serves the partitions from the
content-addressed cache (``cache/``).  The per-run telemetry flags
(``--telemetry-out``, ``--trace-resid``, ``--flight-out``,
``--profile-spans``, ``--summary``, ``--preflight``, ``solve``'s
``--profile-dir``) are the JAX package's.  ``solve`` joins a
multi-process run when ``PCG_TPU_COORDINATOR``, ``PCG_TPU_NUM_PROCS``
and ``PCG_TPU_PROC_ID`` are set (``parallel/distributed.init_distributed``:
every rank runs the same command), and ``--resume-elastic`` continues a
run of another process count.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

def _load_settings(path, args):
    from pcg_mpi_solver_tpu_torch.config import (
        RunConfig, SolverConfig, TimeHistoryConfig)

    th, sp = {}, {}
    if path and os.path.exists(path):
        with open(path) as f:
            raw = json.load(f)
        th = raw.get("TimeHistoryParam", {})
        sp = raw.get("SolverParam", {})
    # default precision is "direct" (f64, reference parity): a reference
    # settings file without PrecisionMode must not change the numerics
    solver = SolverConfig(
        tol=float(getattr(args, "tol", None) or sp.get("Tol", 1e-7)),
        max_iter=int(getattr(args, "max_iter", None)
                     or sp.get("MaxIter", 10000)),
        precision_mode=(getattr(args, "precision", None)
                        or sp.get("PrecisionMode", "direct")),
        precond=getattr(args, "precond", None) or sp.get("Precond", "jacobi"),
        pcg_variant=(getattr(args, "pcg_variant", None)
                     or sp.get("PcgVariant", "classic")),
        # dispatch cap override (settings only; -1 = auto)
        iters_per_dispatch=int(sp.get("ItersPerDispatch", -1)),
    )
    time_history = TimeHistoryConfig(
        time_step_delta=th.get("TimeStepDelta", [0.0, 1.0]),
        export_flag=bool(th.get("ExportFlag", True)),
        export_frame_rate=int(th.get("ExportFrmRate", 1)),
        export_frames=th.get("ExportFrms", []),
        plot_flag=bool(th.get("PlotFlag", False)),
        export_vars=th.get("ExportVars", "U"),
    )
    cfg = RunConfig(solver=solver, time_history=time_history)
    _apply_telemetry_flags(cfg, args)
    return cfg


def _apply_telemetry_flags(cfg, args) -> None:
    """The JAX package's shared per-run flags into the RunConfig:
    --telemetry-out (JSONL sink), --flight-out, --trace-resid (the
    convergence ring), --profile-spans (profiler ranges around each
    dispatch), --cache-dir and the --preflight policy."""
    cfg.telemetry_path = getattr(args, "telemetry_out", None) or ""
    cfg.flight_path = getattr(args, "flight_out", None) or ""
    cfg.solver.trace_resid = int(getattr(args, "trace_resid", None) or 0)
    if getattr(args, "profile_spans", False):
        cfg.telemetry_profile = True
    cfg.cache_dir = _resolve_cache_dir(args)
    cfg.preflight = getattr(args, "preflight", None) or ""


def _resolve_cache_dir(args) -> str:
    """The JAX package's one rule for every subcommand: the --cache-dir
    flag, else the PCG_TPU_CACHE_DIR environment variable, else off."""
    return getattr(args, "cache_dir", None) or \
        os.environ.get("PCG_TPU_CACHE_DIR", "")


def _finish_telemetry(solver, args) -> None:
    """The end of a run's telemetry: the --summary table, then the
    recorder's sinks and flight file closed."""
    if getattr(args, "summary", False):
        print(solver.recorder.summary())
    if getattr(args, "telemetry_out", None):
        print(f">telemetry: {args.telemetry_out}")
    solver.recorder.close()


def _mdf_path(scratch: str) -> str:
    return os.path.join(scratch, "ModelData", "MDF")


def _elem_part(n_parts: int, scratch: str):
    """The scratch MeshPart_<n>.npy element->part map, if partitioned."""
    part_file = os.path.join(scratch, "ModelData", f"MeshPart_{n_parts}.npy")
    return np.load(part_file) if os.path.exists(part_file) else None


def cmd_ingest(args):
    from pcg_mpi_solver_tpu_torch.models.mdf import ingest_archive, read_mdf

    mdf = ingest_archive(args.archive, args.scratch)
    model = read_mdf(mdf)
    print(f">extracted to {mdf}")
    print(f">elements:  {model.n_elem}")
    print(f">nodes:     {model.n_node}")
    print(f">dofs:      {model.n_dof}")


def cmd_partition(args):
    from pcg_mpi_solver_tpu_torch.models.mdf import read_mdf
    from pcg_mpi_solver_tpu_torch.parallel.partition import make_elem_part

    model = read_mdf(_mdf_path(args.scratch))
    print(f">partitioning {model.n_elem} elements into {args.n_parts} parts "
          f"({args.method})..")
    part = make_elem_part(model, args.n_parts, method=args.method)
    out = os.path.join(args.scratch, "ModelData",
                       f"MeshPart_{args.n_parts}.npy")
    np.save(out, part)
    print(f">saved {out}")


def cmd_solve(args):
    from pcg_mpi_solver_tpu_torch.models.mdf import read_mdf
    from pcg_mpi_solver_tpu_torch.solver.driver import Solver
    from pcg_mpi_solver_tpu_torch.utils.io import RunStore

    from pcg_mpi_solver_tpu_torch.parallel.distributed import (
        init_distributed)

    # a multi-process run: every rank runs this command with
    # PCG_TPU_COORDINATOR / PCG_TPU_NUM_PROCS / PCG_TPU_PROC_ID set
    init_distributed()
    cfg = _load_settings(args.settings, args)
    cfg.scratch_path = args.scratch
    cfg.run_id = args.run_id
    cfg.speed_test = bool(args.speed_test)
    cfg.checkpoint_every = int(args.checkpoint_every or 0)
    cfg.snapshot_every = int(args.snapshot_every or 0)
    if args.max_recoveries is not None:
        cfg.solver.max_recoveries = int(args.max_recoveries)
    cfg.profile_dir = args.profile_dir or ""
    model = read_mdf(_mdf_path(args.scratch))
    cfg.time_history.dt = model.dt   # frame timestamps follow the model's dt
    n_parts = args.n_parts or 1
    print(f">solving on {args.device or 'cuda'}, {n_parts} parts "
          f"({cfg.solver.precision_mode} precision)..")
    s = Solver(model, cfg, n_parts=n_parts,
               elem_part=_elem_part(n_parts, args.scratch),
               backend=args.backend, device=args.device)
    print(f">backend: {s.backend}")
    store = RunStore(cfg.result_path, cfg.model_name)
    out_store = None if cfg.speed_test else store
    if args.resume_elastic is not None:
        # a committed epoch of a run on another process count
        res = s.resume_elastic(args.resume_elastic or None, store=out_store)
    else:
        res = s.solve(store=out_store, resume=bool(args.resume))
    # with --resume, earlier steps were restored: label the ones run
    t_first = len(s.flags) - len(res) + 1
    for t, r in enumerate(res, t_first):
        print(f">step {t}: flag={r.flag} iters={r.iters} "
              f"relres={r.relres:.3e} wall={r.wall_s:.2f}s")
    td = s.time_data()
    print(f">calculation time: {td['Mean_CalcTime']:.2f} sec")
    _finish_telemetry(s, args)
    print(">success!")


def cmd_solve_many(args):
    """A block of load cases against one partitioned operator
    (``Solver.solve_many``): ``--rhs loads.npy`` ((n_dof, nrhs) or (nrhs,
    n_dof)) or ``--scales "1.0,0.5"`` (columns = scale * the model's
    reference load F); per-column flags, relres and iterations printed,
    the solutions saved as ``u_many.npy`` under the run directory."""
    from pcg_mpi_solver_tpu_torch.models.mdf import read_mdf
    from pcg_mpi_solver_tpu_torch.solver.driver import (
        Solver, normalize_rhs_block)

    cfg = _load_settings(args.settings, args)
    cfg.scratch_path = args.scratch
    cfg.run_id = args.run_id
    cfg.snapshot_every = int(args.snapshot_every or 0)
    if args.max_recoveries is not None:
        cfg.solver.max_recoveries = int(args.max_recoveries)
    model = read_mdf(_mdf_path(args.scratch))
    if args.rhs:
        fb = normalize_rhs_block(np.load(args.rhs), model.n_dof)
    elif args.scales:
        try:
            scales = [float(v) for v in args.scales.split(",")
                      if v.strip()]
        except ValueError:
            raise SystemExit(f"solve-many: --scales {args.scales!r} is "
                             "not a comma-separated list of numbers")
        if not scales:
            raise SystemExit("solve-many: --scales parsed to zero load "
                             "cases; pass e.g. --scales \"1.0,0.5\"")
        fb = np.stack([np.asarray(model.F) * sc for sc in scales], axis=-1)
    else:
        raise SystemExit("solve-many: pass --rhs FILE.npy (columns = load "
                         "cases) or --scales \"1.0,0.5,...\"")
    cfg.solver.nrhs = fb.shape[1]
    n_parts = args.n_parts or 1
    print(f">solving {fb.shape[1]} load cases on {args.device or 'cuda'}, "
          f"{n_parts} parts ({cfg.solver.precision_mode} precision, "
          f"{cfg.solver.pcg_variant} variant)..")
    s = Solver(model, cfg, n_parts=n_parts,
               elem_part=_elem_part(n_parts, args.scratch),
               backend=args.backend, device=args.device)
    print(f">backend: {s.backend}  setup: {s.setup_s:.2f}s "
          f"({s.setup_cache} partition)")
    res = s.solve_many(fb, resume=bool(args.resume))
    for j in range(res.nrhs):
        tag = "  [QUARANTINED]" if j in res.quarantined else ""
        print(f">rhs {j}: flag={int(res.flags[j])} "
              f"iters={int(res.iters[j])} relres={res.relres[j]:.3e}{tag}")
    print(f">block wall: {res.wall_s:.2f}s ({res.nrhs} load cases, "
          f"one operator)")
    if res.quarantined:
        print(f">quarantined columns: {list(res.quarantined)} (flag 5, "
              f"their min-residual iterates)")
    out = os.path.join(cfg.result_path, "u_many")
    os.makedirs(cfg.result_path, exist_ok=True)
    np.save(out, s.displacement_global_many(res.x))
    print(f">solutions (n_dof, nrhs) -> {out}.npy")
    _finish_telemetry(s, args)
    print(">success!")


def _time_config(args):
    """The settings of a time-history run: the file and flags of
    ``_load_settings`` plus the run directory and resilience flags."""
    cfg = _load_settings(args.settings, args)
    cfg.scratch_path = args.scratch
    cfg.run_id = args.run_id
    cfg.snapshot_every = int(args.snapshot_every or 0)
    if args.max_recoveries is not None:
        cfg.solver.max_recoveries = int(args.max_recoveries)
    return cfg


def _save_result(cfg, name: str, arr) -> str:
    os.makedirs(cfg.result_path, exist_ok=True)
    out = os.path.join(cfg.result_path, name)
    np.save(out, arr)
    return out + ".npy"


def cmd_dynamics(args):
    """Explicit central-difference time history (``DynamicsSolver``):
    ``--snapshot-every N`` checkpoints the full state every N timesteps,
    ``--resume`` continues mid-history bit for bit."""
    from pcg_mpi_solver_tpu_torch.models.mdf import read_mdf
    from pcg_mpi_solver_tpu_torch.solver.dynamics import DynamicsSolver

    cfg = _time_config(args)
    model = read_mdf(_mdf_path(args.scratch))
    n_parts = args.n_parts or 1
    probe = tuple(int(d) for d in (args.probe_dofs or "").split(",") if d)
    print(f">explicit dynamics on {args.device or 'cuda'}, {n_parts} parts, "
          f"{args.n_steps} steps..")
    dyn = DynamicsSolver(model, cfg, n_parts=n_parts, dt=args.dt,
                         damping=args.damping, probe_dofs=probe,
                         backend=args.backend, device=args.device)
    print(f">backend: {dyn.backend}  dt={dyn.dt:.4e}")
    res = dyn.run(args.n_steps, export_every=args.export_every,
                  resume=bool(args.resume))
    print(f">integrated {args.n_steps} steps ({len(res.frames)} frames, "
          f"{res.probe_u.shape[0]} probes, {dyn.chunks} chunks)")
    print(f">final displacement -> {_save_result(cfg, 'u_dynamics', res.u)}")
    if probe:
        out = _save_result(cfg, "probe_dynamics", res.probe_u)
        print(f">probe series -> {out}")
    _finish_telemetry(dyn, args)
    print(">success!")


def cmd_newmark(args):
    """Implicit Newmark-beta time history (``NewmarkSolver``), one PCG
    solve a step: ``--snapshot-every N`` checkpoints the kinematic state
    every N timesteps, ``--resume`` continues mid-history bit for bit."""
    from pcg_mpi_solver_tpu_torch.models.mdf import read_mdf
    from pcg_mpi_solver_tpu_torch.solver.newmark import NewmarkSolver

    cfg = _time_config(args)
    model = read_mdf(_mdf_path(args.scratch))
    n_parts = args.n_parts or 1
    dt = args.dt if args.dt else (model.dt if model.dt > 0 else 1.0)
    print(f">Newmark dynamics on {args.device or 'cuda'}, {n_parts} parts, "
          f"{args.n_steps} steps, dt={dt:.4e}..")
    s = NewmarkSolver(model, cfg, n_parts=n_parts, dt=dt, beta=args.beta,
                      gamma=args.gamma, damping=args.damping,
                      backend=args.backend, device=args.device)
    print(f">backend: {s.backend}")
    res = s.run([1.0] * args.n_steps, resume=bool(args.resume))
    t_first = len(s.flags) - len(res) + 1
    for t, r in enumerate(res, t_first):
        print(f">step {t}: flag={r.flag} iters={r.iters} "
              f"relres={r.relres:.3e} wall={r.wall_s:.2f}s")
    out = _save_result(cfg, "u_newmark", s.displacement_global())
    print(f">final displacement -> {out}")
    _finish_telemetry(s, args)
    print(">success!")


def cmd_export(args):
    from pcg_mpi_solver_tpu_torch.config import RunConfig
    from pcg_mpi_solver_tpu_torch.models.mdf import read_mdf
    from pcg_mpi_solver_tpu_torch.utils.io import RunStore
    from pcg_mpi_solver_tpu_torch.vtk.export import export_vtk

    model = read_mdf(_mdf_path(args.scratch))
    cfg = RunConfig(scratch_path=args.scratch, run_id=args.run_id)
    store = RunStore(cfg.result_path, "model")
    files = export_vtk(model, store, args.vars.split(), args.mode)
    print(f">wrote {len(files)} vtu files to {store.vtk_path}")


def cmd_demo(args):
    from pcg_mpi_solver_tpu_torch.models import (
        make_cube_model, make_octree_model, make_poisson_model)
    from pcg_mpi_solver_tpu_torch.solver.driver import Solver
    from pcg_mpi_solver_tpu_torch.utils.io import RunStore
    from pcg_mpi_solver_tpu_torch.vtk.export import export_vtk

    cfg = _load_settings(args.settings, args)
    cfg.scratch_path = args.scratch
    cfg.time_history.export_vars = "U D ES PS PE"
    vtk_vars, vtk_mode = ["U", "PS1", "PS3", "ES"], "Full"
    if args.poisson:
        cfg.model_name = "demo_poisson"
        cfg.time_history.export_vars = "U"      # scalar class: U only
        vtk_vars, vtk_mode = ["U"], "Boundary"
        model = make_poisson_model(args.nx, args.ny or 0, args.nz or 0,
                                   heterogeneous=True, seed=1)
        print(f">demo poisson: {model.n_elem} elems / {model.n_dof} dofs "
              "(scalar diffusion)")
    elif args.octree:
        cfg.model_name = "demo_octree"
        model = make_octree_model(
            args.nx, args.ny or args.nx, args.nz or args.nx,
            max_level=args.max_level, n_incl=3, seed=1,
            E=30e9, nu=0.2, load="traction", load_value=1e6)
        print(f">demo octree: {model.n_elem} elems / {model.n_dof} dofs / "
              f"{len(model.elem_lib)} pattern types")
    else:
        cfg.model_name = "demo_cube"
        model = make_cube_model(args.nx, args.ny or 0, args.nz or 0,
                                E=30e9, nu=0.2, load="traction",
                                load_value=1e6, heterogeneous=True)
        print(f">demo model: {model.n_elem} elems / {model.n_dof} dofs")
    # the octree demo runs the hybrid level-grid backend, asked for by
    # name (auto selects it only under PCG_TPU_ENABLE_HYBRID=1)
    s = Solver(model, cfg, backend="hybrid" if args.octree else "auto",
               device=args.device)
    store = RunStore(cfg.result_path, cfg.model_name)
    res = s.solve(store=store)
    for t, r in enumerate(res, 1):
        print(f">step {t}: flag={r.flag} iters={r.iters} "
              f"relres={r.relres:.3e} wall={r.wall_s:.2f}s  "
              f"[{s.backend} backend]")
    files = export_vtk(model, store, vtk_vars, vtk_mode)
    print(f">wrote {len(files)} vtu files to {store.vtk_path}")
    _finish_telemetry(s, args)
    print(">success!")


def cmd_cache_stats(args):
    from pcg_mpi_solver_tpu_torch.cache.partition_cache import format_stats

    d = _resolve_cache_dir(args)
    if not d:
        raise SystemExit("cache-stats: pass --cache-dir DIR (or set "
                         "PCG_TPU_CACHE_DIR)")
    print(format_stats(d))


def cmd_summary(args):
    """Offline summary of on-disk telemetry/flight JSONL files, tolerant
    of a truncated last line; a base path a multi-process run sharded
    away (run.jsonl -> run.p<idx>.jsonl) falls back to its shards."""
    from pcg_mpi_solver_tpu_torch.obs.flight import find_shards
    from pcg_mpi_solver_tpu_torch.obs.metrics import summarize_jsonl

    first = True
    for path in args.files:
        if os.path.exists(path):
            targets = [path]
        else:
            targets = find_shards(path)
            if not targets:
                raise SystemExit(f"summary: {path}: no such file (and "
                                 "no .p<N>.jsonl shard siblings)")
            if not first:
                print()
            print(f">summary: {path}: sharded by a multi-process run — "
                  f"{len(targets)} per-process shard(s)")
            first = False
        for t in targets:
            if not first:
                print()
            first = False
            if len(targets) > 1:
                print(f"--- {t}")
            print(summarize_jsonl(t))


def cmd_telemetry_merge(args):
    """Per-process telemetry/flight shards merged into ONE time-ordered
    JSONL stream, each event tagged with its source shard; truncated
    lines are skipped and counted."""
    from pcg_mpi_solver_tpu_torch.obs.flight import find_shards, merge_shards

    paths = []
    for p in args.paths:
        shards = find_shards(p)
        for sh in (shards or ([p] if os.path.exists(p) else [])):
            if sh not in paths:
                paths.append(sh)
    if not paths:
        raise SystemExit("telemetry-merge: no shards found for "
                         f"{args.paths} (expected FILE.jsonl and/or "
                         "FILE.p<N>.jsonl siblings)")
    align = None if args.align == "none" else args.align
    stats = merge_shards(paths, args.out, align=align)
    for name in sorted(stats["shards"]):
        st = stats["shards"][name]
        print(f">shard {name}: {st['events']} event(s), "
              f"{st['truncated']} truncated line(s) skipped")
    al = stats.get("align")
    if al is not None:
        if al["matched_anchors"]:
            offs = "  ".join(f"{n}={v:+.6f}s"
                             for n, v in sorted(al["offsets_s"].items()))
            print(f">clock alignment ({al['mode']}): "
                  f"{al['matched_anchors']} matched anchor(s); "
                  f"offsets vs first shard: {offs}")
        else:
            print(">clock alignment: no matched dispatch anchors across "
                  "shards — falling back to raw t ordering")
    print(f">merged {stats['events']} event(s) from "
          f"{len(stats['shards'])} shard(s) -> {args.out}"
          + (f" ({stats['truncated_lines']} truncated line(s) skipped)"
             if stats["truncated_lines"] else ""))


def cmd_perf_report(args):
    """Measured-vs-model phase attribution: the matvec, precond,
    reduction and axpy phases of a live solver timed alone
    (``obs/phases.py``) beside the cost model's prediction
    (``obs/perf.py``), anchored by a real solve; with --profile-dir also
    a profiler capture of one warm solve read back
    (``obs/profview.py``)."""
    from pcg_mpi_solver_tpu_torch.obs import perf as _perf
    from pcg_mpi_solver_tpu_torch.obs.phases import run_phase_probe
    from pcg_mpi_solver_tpu_torch.solver.driver import Solver

    cfg = _load_settings(args.settings, args)
    if cfg.solver.precision_mode != "direct":
        raise SystemExit(
            "perf-report: phase probes need a direct-mode solver (one "
            "dtype, one loop) — drop --precision mixed")
    nrhs = max(1, int(args.nrhs))
    cfg.solver.nrhs = nrhs
    elem_part = None
    n_parts = args.n_parts or 1
    if args.scratch:
        from pcg_mpi_solver_tpu_torch.models.mdf import read_mdf

        cfg.scratch_path = args.scratch
        model = read_mdf(_mdf_path(args.scratch))
        elem_part = _elem_part(n_parts, args.scratch)
    else:
        from pcg_mpi_solver_tpu_torch.models import make_cube_model

        model = make_cube_model(args.nx, 0, 0, E=30e9, nu=0.2,
                                load="traction", load_value=1e6,
                                heterogeneous=True)
    print(f">perf-report: {model.n_elem} elems / {model.n_dof} dofs on "
          f"{args.device or 'cuda'}, {n_parts} parts "
          f"({cfg.solver.pcg_variant} variant, {cfg.solver.precond} "
          f"precond, nrhs={nrhs})..")
    s = Solver(model, cfg, n_parts=n_parts, elem_part=elem_part,
               backend=args.backend, device=args.device)
    print(f">backend: {s.backend}")
    cm = s._cost_model
    probe = run_phase_probe(s, reps=args.reps, nrhs=nrhs,
                            inner=args.inner)
    if args.profile_dir:
        from pcg_mpi_solver_tpu_torch.obs import profview

        cap = profview.capture_solve_profile(s, args.profile_dir,
                                             nrhs=nrhs, recorder=s.recorder)
        rep = profview.profile_report(cap["artifact"])
        profview.emit_prof_report(s.recorder, rep)
        print()
        print(profview.format_report(rep, predicted=cm,
                                     recorded=probe["phases"]))
        _finish_telemetry(s, args)
        return
    print()
    print(f"{'phase':<10} {'model_ms':>10} {'measured_ms':>12} "
          f"{'share':>7}")
    sum_ms = probe["sum_ms_per_iter"] or 0.0
    model_sum = 0.0
    for ph in _perf.PHASES:
        mm = cm["phases"][ph]["model_ms"]
        model_sum += mm
        meas = probe["phases"][ph]
        share = (meas / sum_ms) if sum_ms else 0.0
        print(f"{ph:<10} {mm:>10.4f} {meas:>12.4f} {share:>6.0%}")
    print(f"{'sum':<10} {model_sum:>10.4f} {sum_ms:>12.4f}")
    whole = probe.get("whole_ms_per_iter")
    if whole:
        print(f"\n>whole-iteration anchor: {whole:.4f} ms/iter "
              f"({probe.get('whole_iters', '?')} iters, real solve)")
        print(f">attribution (phase sum / whole): "
              f"{probe['attribution']:.2f}")
        if cm["predicted_ms_per_iter"]:
            print(f">model ratio (measured whole / predicted): "
                  f"{whole / cm['predicted_ms_per_iter']:.2f} "
                  f"(predicted {cm['predicted_ms_per_iter']:.4f} ms/iter, "
                  f"profile={cm['profile']})")
    _finish_telemetry(s, args)


def cmd_prof_report(args):
    """Offline device-trace report (``obs/profview.py``): a captured
    torch.profiler trace — the *.trace.json(.gz) itself, its run dir or a
    capture root — read back into per-phase device time, the busy share
    and the tolerant reader's verdict; a truncated file or missing
    device lanes give a NAMED verdict, never a crash.  With the capture's
    sidecar the cost model is rebuilt for the predicted column."""
    from pcg_mpi_solver_tpu_torch.obs import profview

    files = profview.find_trace_files(args.path)
    meta = profview.load_meta(files[0]) if files else None
    rep = profview.profile_report(files[0] if files else args.path,
                                  meta=meta, iters=args.iters)
    predicted = None
    try:
        predicted = profview.predicted_from_meta(meta or {})
    except KeyError as e:
        print(f">predicted column unavailable: unknown name {e} in the "
              "capture sidecar (name tables out of sync?)")
    if meta:
        print(f">profile: {meta.get('pcg_variant')} variant, "
              f"{meta.get('precond')} precond, nrhs={meta.get('nrhs')}, "
              f"{meta.get('backend')} backend, "
              f"{meta.get('n_dof')} dofs on "
              f"{meta.get('n_devices')} device(s) "
              f"[{meta.get('platform')}]")
    print(profview.format_report(rep, predicted=predicted))
    if args.telemetry_out:
        from pcg_mpi_solver_tpu_torch.obs.metrics import (
            JsonlSink, MetricsRecorder)

        rec = MetricsRecorder(sinks=[JsonlSink(args.telemetry_out)])
        profview.emit_prof_report(rec, rep)
        rec.close()
        print(f">telemetry: {args.telemetry_out}")


def cmd_serve(args):
    """Run the solve service (``serve/``): one partitioned operator on the
    card serving filesystem-submitted jobs exactly once.

    The daemon polls ``--spool``/incoming for specs (``submit``), prices
    each admission with the cost model against the job's deadline, packs
    jobs into standard nrhs widths and dispatches each block through
    ``Solver.solve_many`` (on the card one kernel launch over the block's
    slabs a matvec); a poisoned job fails alone while its co-batched jobs
    finish.  Every lifecycle step is an fsync'd record in
    ``spool/journal.jsonl``; a daemon started again over the same spool
    replays it (no job lost, none solved twice).  SIGTERM drains; watch
    the journal with ``watch spool/journal.jsonl``."""
    from pcg_mpi_solver_tpu_torch.serve.daemon import ServeDaemon
    from pcg_mpi_solver_tpu_torch.solver.driver import Solver

    cfg = _load_settings(args.settings, args)
    if args.synthetic:
        from pcg_mpi_solver_tpu_torch.models import make_cube_model

        try:
            dims = [int(v) for v in args.synthetic.split(",")]
        except ValueError:
            raise SystemExit(f"serve: --synthetic {args.synthetic!r} is "
                             "not NX[,NY,NZ]")
        dims += [0] * (3 - len(dims))
        model = make_cube_model(dims[0], dims[1], dims[2], E=30e9,
                                nu=0.2, load="traction", load_value=1e6,
                                heterogeneous=True)
    elif args.scratch:
        from pcg_mpi_solver_tpu_torch.models.mdf import read_mdf

        cfg.scratch_path = args.scratch
        model = read_mdf(_mdf_path(args.scratch))
    else:
        raise SystemExit("serve: pass a <scratch> dir or --synthetic NX")
    try:
        widths = sorted({int(v) for v in args.widths.split(",")})
    except ValueError:
        raise SystemExit(f"serve: --widths {args.widths!r} is not a "
                         "comma-separated list of ints")
    n_parts = args.n_parts or 1
    print(f">serve: building {model.n_dof} dofs on "
          f"{args.device or 'cuda'}, {n_parts} parts..", flush=True)
    s = Solver(model, cfg, n_parts=n_parts,
               elem_part=(_elem_part(n_parts, args.scratch)
                          if args.scratch and not args.synthetic else None),
               backend=args.backend, device=args.device)
    daemon = ServeDaemon(
        s, args.spool, queue_max=args.queue_max, widths=widths,
        expected_iters=args.expected_iters, poll_s=args.poll_s)
    print(f">serve: spool={args.spool} queue_max={args.queue_max} "
          f"widths={daemon.widths} backend={s.backend} (SIGTERM drains; "
          f"journal={daemon.journal.path})", flush=True)
    reason = daemon.run(max_blocks=args.max_blocks,
                        idle_exit_s=args.idle_exit_s)
    print(f">serve: drained ({reason}) — {daemon.jobs_done} done, "
          f"{daemon.jobs_failed} failed, "
          f"{daemon.admission.shed_count} shed, "
          f"{daemon.blocks} block(s)")
    _finish_telemetry(s, args)
    print(">success!")


def cmd_submit(args):
    """Submit one job to a spool (loads no torch).  Prints the job id;
    every submitted job gets ``spool/results/<job>.json`` with a named
    verdict."""
    from pcg_mpi_solver_tpu_torch.serve import jobs as sjobs

    spec = {"deadline_s": args.deadline_s}
    if args.job_id:
        spec["job"] = args.job_id
    if args.rhs is not None:
        spec["rhs"] = args.rhs
    if args.scale is not None:
        spec["scale"] = args.scale
    try:
        job = sjobs.submit(args.spool, spec)
    except ValueError as e:
        raise SystemExit(f"submit: {e}")
    print(f">submitted {job} -> {sjobs.result_path(args.spool, job)}")


def cmd_jobs(args):
    """The job table of a spool, folded from the journal (loads no
    torch): on a live daemon's spool (the journal is append-only and read
    tolerantly) and on a crashed one (what would replay)."""
    from pcg_mpi_solver_tpu_torch.serve import jobs as sjobs
    from pcg_mpi_solver_tpu_torch.serve.journal import (
        read_journal, replay_jobs)

    path = sjobs.journal_path(args.spool)
    if not os.path.exists(path):
        raise SystemExit(f"jobs: no journal at {path}")
    events, truncated = read_journal(path)
    states = replay_jobs(events)
    if truncated:
        print(f">warning: {truncated} torn journal line(s) skipped")
    print(f">{'job':12s} {'ordinal':>7s} {'state':12s} verdict")
    for st in sorted(states.values(),
                     key=lambda s: (s["ordinal"] is None,
                                    s["ordinal"] or 0)):
        o = "-" if st["ordinal"] is None else str(st["ordinal"])
        print(f">{st['job']:12s} {o:>7s} {st['op'] or '?':12s} "
              f"{st['verdict'] or ''}")
    n_term = sum(st["terminal"] for st in states.values())
    print(f">{len(states)} job(s), {n_term} terminal, "
          f"{len(states) - n_term} in flight")


def cmd_watch(args):
    """Live monitor (``obs/watch.py``, loads no torch): tail the flight or
    telemetry JSONL shards of a running solve or a serve journal:
    progress, the stall alarm (every shard silent past the threshold),
    the cost-model x observed-rate ETA.  ``--once`` prints one snapshot
    and exits (3 when it is a stall); otherwise it polls until done or
    interrupted.  It only reads the watched stream."""
    from pcg_mpi_solver_tpu_torch.obs import watch

    rec = None
    if args.telemetry_out:
        from pcg_mpi_solver_tpu_torch.obs.metrics import (
            JsonlSink, MetricsRecorder)

        rec = MetricsRecorder(sinks=[JsonlSink(args.telemetry_out)])
    stalled = False
    try:
        while True:
            snap = watch.watch_snapshot(args.path,
                                        stall_after_s=args.stall_after,
                                        tol=args.tol)
            print(watch.format_watch(snap), flush=True)
            if rec is not None:
                watch.emit_watch_events(rec, snap)
            stalled = snap["status"] == "stalled"
            if args.once or snap["status"] == "done":
                break
            try:
                time.sleep(args.interval)
            except KeyboardInterrupt:
                break
            print(flush=True)
    finally:
        if rec is not None:
            rec.close()
            print(f">telemetry: {args.telemetry_out}")
    if stalled and args.once:
        raise SystemExit(3)


def cmd_validate(args):
    """The preflight checks (``validate/``) against a scratch model, each
    reported: the dry run of the gate the solvers apply at construction.
    The --preflight policy sets the exit code as it sets the gate: fail
    (default) exits non-zero on a failed check, warn reports and exits 0,
    off checks nothing."""
    from pcg_mpi_solver_tpu_torch.models.mdf import read_mdf
    from pcg_mpi_solver_tpu_torch.validate import (
        preflight_checks, resolve_policy)

    pol = resolve_policy(getattr(args, "preflight", None))
    if pol == "off":
        print(">validate: preflight policy is off; nothing checked")
        return
    cfg = _load_settings(args.settings, args)
    model = read_mdf(_mdf_path(args.scratch))
    print(f">preflight: {model.n_elem} elems / {model.n_dof} dofs")
    results = preflight_checks(model, cfg, context={"kind": "validate"})
    n_fail = 0
    for r in results:
        tag = {"ok": "  ok ", "warn": " WARN", "fail": " FAIL"}[r.status]
        n_fail += r.status == "fail"
        print(f">[{tag}] {r.name}" + (f": {r.detail}" if r.detail else ""))
    if n_fail and pol == "fail":
        raise SystemExit(f"validate: {n_fail} failed check(s)")
    if n_fail:
        print(f">validate: {n_fail} failed check(s) (policy={pol}; "
              "exit 0)")
    else:
        print(">validate: all checks passed")


def cmd_warmup(args):
    """Pay a model's setup before the solve that needs it: the partitions
    (and the mg hierarchy) into the partition cache, the CUDA libraries
    the solve launches built or loaded, each operator applied once
    (``Solver.warmup``), so a later solve with the SAME --cache-dir
    starts warm."""
    from pcg_mpi_solver_tpu_torch.cache.partition_cache import format_stats
    from pcg_mpi_solver_tpu_torch.solver.driver import Solver

    cfg = _load_settings(args.settings, args)
    if not cfg.cache_dir:
        # a warmup into a dir the later solve does not read is worse than
        # none
        raise SystemExit(
            "warmup: pass --cache-dir DIR (or set PCG_TPU_CACHE_DIR) — "
            "and run the solve with the SAME dir to use the baked caches")
    if args.demo_nx:
        from pcg_mpi_solver_tpu_torch.models import make_cube_model

        model = make_cube_model(args.demo_nx, 0, 0, E=30e9, nu=0.2,
                                load="traction", load_value=1e6,
                                heterogeneous=True)
    elif args.scratch:
        from pcg_mpi_solver_tpu_torch.models.mdf import read_mdf

        cfg.scratch_path = args.scratch
        model = read_mdf(_mdf_path(args.scratch))
    else:
        raise SystemExit("warmup: pass a <scratch> dir or --demo-nx N")
    n_parts = args.n_parts or 1
    # the scratch MeshPart map belongs to the scratch model, never to a
    # --demo-nx cube
    elem_part = None if args.demo_nx else _elem_part(n_parts, args.scratch)
    print(f">warming {model.n_dof} dofs on {args.device or 'cuda'}, "
          f"{n_parts} parts ({cfg.solver.precision_mode} precision) into "
          f"{cfg.cache_dir} ..")
    s = Solver(model, cfg, n_parts=n_parts, elem_part=elem_part,
               backend=args.backend, device=args.device)
    print(f">backend: {s.backend}  setup: {s.setup_s:.2f}s "
          f"({s.setup_cache} partition)")
    t0 = time.perf_counter()
    s.warmup()
    print(f">warmup: {time.perf_counter() - t0:.2f}s (kernels, first "
          f"operator applications)")
    _finish_telemetry(s, args)
    print(format_stats(cfg.cache_dir))
    print(">warm path ready")


def cmd_fleet_report(args):
    """Cross-process collective-skew attribution (``obs/fleet.py``):
    align the per-rank capture subdirs (``p<idx>/``) of a multi-process
    solve's ``--profile-dir`` on matched collective ends, split each
    collective into transport and wait, and name the straggler per
    phase.  Offline; a single-process capture or a collective-free trace
    degrades to a named verdict."""
    from pcg_mpi_solver_tpu_torch.obs import fleet

    rep = fleet.fleet_report(args.path)
    print(fleet.format_fleet_report(rep))
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(rep, f, indent=1, sort_keys=True)
        print(f">json: {args.json}")
    if args.telemetry_out:
        from pcg_mpi_solver_tpu_torch.obs.metrics import (
            JsonlSink, MetricsRecorder)

        rec = MetricsRecorder(sinks=[JsonlSink(args.telemetry_out)])
        fleet.emit_fleet_report(rec, rep)
        rec.close()
        print(f">telemetry: {args.telemetry_out}")
    if rep["n_processes"] == 0:
        raise SystemExit(2)


def cmd_lint(args):
    """Contract lint (``analysis/``): prove the port's structural claims
    on recorded trips of real solves — collectives and host reads a
    trip, dtype discipline, the carry handoff, fingerprint and key
    completeness — plus the source and artifact lints; exit 0 = every
    invariant holds, 1 = findings, 2 = a rule could not run."""
    from pcg_mpi_solver_tpu_torch.analysis.__main__ import run

    rc = run(args)
    if rc:
        raise SystemExit(rc)


def cmd_bench(args):
    """The bench (``bench.py``): one JSON line on stdout, configured by
    its BENCH_* environment knobs."""
    from pcg_mpi_solver_tpu_torch.bench import main as bench_main

    bench_main()


def cmd_trend(args):
    """Bench-trend regression sentinel (``obs/trend.py``): match legs
    across round artifacts (plus an optional fresh one) by shape,
    configuration and platform, and print per-leg deltas with threshold
    verdicts.  Exit 1 = at least one matched leg regressed; exit 2 =
    nothing to compare."""
    from pcg_mpi_solver_tpu_torch.obs import trend

    thr = (args.threshold if args.threshold is not None
           else trend.DEFAULT_THRESHOLD)
    rc = trend.main_cli(list(args.artifacts), fresh=args.fresh,
                        threshold=thr)
    if rc:
        raise SystemExit(rc)


def _add_solver_flags(p, precision_default=None) -> None:
    from pcg_mpi_solver_tpu_torch.config import PCG_VARIANTS, PRECONDS

    p.add_argument("--settings", default=None)
    p.add_argument("--tol", type=float, default=None)
    p.add_argument("--max-iter", type=int, default=None)
    p.add_argument("--precision", choices=["direct", "mixed"],
                   default=precision_default)
    p.add_argument("--precond", choices=list(PRECONDS), default=None,
                   help="scalar Jacobi (reference parity), 3x3 node-block "
                        "Jacobi, or the mg V-cycle")
    p.add_argument("--pcg-variant", choices=list(PCG_VARIANTS),
                   default=None, dest="pcg_variant",
                   help="classic (the MATLAB-compatible loop, default), "
                        "fused (Chronopoulos-Gear) or pipelined "
                        "(Ghysels-Vanroose)")
    p.add_argument("--device", default=None,
                   help="torch device to solve on (default: the card, "
                        "'cuda'; 'cpu' runs the plain versions of the "
                        "kernels)")


def _add_cache_flag(p) -> None:
    p.add_argument("--cache-dir", default=None, metavar="DIR",
                   help="partition cache directory (cache/): the "
                        "partitions, the mg hierarchy and its fine bound "
                        "are served from a content-addressed on-disk "
                        "cache, so the second solve of the same model, "
                        "n_parts and backend skips them (env default: "
                        "PCG_TPU_CACHE_DIR)")


def _add_telemetry_flags(p) -> None:
    p.add_argument("--telemetry-out", default=None, metavar="FILE.jsonl",
                   help="append schema-versioned telemetry events (one "
                        "JSON object a line: steps, dispatch timings, "
                        "residual traces, the cost model, the run "
                        "summary) here")
    p.add_argument("--trace-resid", type=int, default=0, metavar="N",
                   help="record the last N per-iteration (normr, rho, "
                        "stag, flag) samples on the device and surface "
                        "them once a solve (0 = off; clamped to max_iter)")
    p.add_argument("--flight-out", default=None, metavar="FILE.jsonl",
                   help="crash-durable flight recorder: fsync'd "
                        "begin/end brackets and heartbeats around every "
                        "dispatch, so a killed run leaves a parseable "
                        "artifact (read it back with `summary`; env "
                        "default: PCG_TPU_FLIGHT)")
    p.add_argument("--summary", action="store_true",
                   help="print the per-step / per-dispatch telemetry "
                        "table after the run")
    p.add_argument("--profile-spans", action="store_true",
                   help="wrap each dispatch in a torch.profiler "
                        "record_function range (also "
                        "PCG_TPU_PROFILE_SPANS=1)")


def _add_preflight_flag(p) -> None:
    p.add_argument("--preflight", choices=["fail", "warn", "off"],
                   default=None,
                   help="preflight policy (default: PCG_TPU_PREFLIGHT, "
                        "else fail)")


def _add_run_flags(p) -> None:
    """The JAX package's telemetry, cache and preflight flags."""
    _add_telemetry_flags(p)
    _add_cache_flag(p)
    _add_preflight_flag(p)


def _add_resilience_flags(p, granularity: str) -> None:
    p.add_argument("--snapshot-every", type=int, default=0,
                   help=f"resumable snapshots every N {granularity} "
                        f"(0 = off)")
    p.add_argument("--max-recoveries", type=int, default=None,
                   help="recovery budget for breakdowns and NaN/Inf "
                        "corruption (default 2; 0 = report and stop)")
    p.add_argument("--resume", action="store_true",
                   help=f"continue from the latest snapshot/checkpoint "
                        f"of this run ({granularity} granularity)")


BACKENDS = ["auto", "structured", "hybrid", "general"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m pcg_mpi_solver_tpu_torch.cli",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("ingest", help="unpack a reference MDF model archive")
    p.add_argument("archive")
    p.add_argument("scratch")
    p.set_defaults(fn=cmd_ingest)

    p = sub.add_parser("partition", help="compute element->part map")
    p.add_argument("scratch")
    p.add_argument("n_parts", type=int)
    p.add_argument("--method", choices=["rcb", "slab2", "graph", "auto"],
                   default="auto",
                   help="rcb = coordinate bisection, slab2 = the two-level "
                        "split; graph = the native multilevel dual-graph "
                        "partitioner (METIS-equivalent, built with g++ at "
                        "first use); auto = graph unless PCG_TPU_NO_NATIVE "
                        "is set, then rcb")
    p.set_defaults(fn=cmd_partition)

    p = sub.add_parser("solve", help="run the PCG solve")
    p.add_argument("scratch")
    p.add_argument("run_id")
    p.add_argument("--n-parts", type=int, default=None)
    _add_solver_flags(p)
    p.add_argument("--speed-test", action="store_true",
                   help="disable all exports for clean timing "
                        "(reference SpeedTestFlag)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="write a solver checkpoint every N time steps")
    _add_resilience_flags(p, "mid-Krylov chunk boundaries")
    p.add_argument("--resume-elastic", default=None, metavar="DIR",
                   nargs="?", const="",
                   help="resume a run of another process count on this "
                        "one, from DIR (default: this config's checkpoint "
                        "dir)")
    p.add_argument("--backend", choices=BACKENDS, default="auto")
    p.add_argument("--profile-dir", default=None)
    _add_run_flags(p)
    p.set_defaults(fn=cmd_solve)

    p = sub.add_parser("solve-many",
                       help="many load cases against one partitioned "
                            "operator")
    p.add_argument("scratch")
    p.add_argument("run_id")
    p.add_argument("--rhs", default=None, metavar="FILE.npy")
    p.add_argument("--scales", default=None, metavar="S0,S1,...")
    p.add_argument("--n-parts", type=int, default=None)
    _add_solver_flags(p)
    p.add_argument("--backend", choices=BACKENDS, default="auto")
    _add_resilience_flags(p, "blocked-solve chunk boundaries")
    _add_run_flags(p)
    p.set_defaults(fn=cmd_solve_many)

    time_backends = ["auto", "hybrid", "general"]
    p = sub.add_parser("dynamics",
                       help="explicit central-difference time history "
                            "(timestep snapshots + --resume)")
    p.add_argument("scratch")
    p.add_argument("run_id")
    p.add_argument("--n-steps", type=int, required=True,
                   help="number of explicit timesteps to integrate")
    p.add_argument("--dt", type=float, default=None,
                   help="timestep (default: the model's dt, else the CFL "
                        "estimate; a value above the CFL bound is refused "
                        "by the preflight)")
    p.add_argument("--damping", type=float, default=0.0,
                   help="mass-proportional damping coefficient c_m")
    p.add_argument("--export-every", type=int, default=0,
                   help="displacement frames every k steps (0 = none)")
    p.add_argument("--probe-dofs", default="",
                   help="comma-separated dof ids sampled every step")
    p.add_argument("--settings", default=None)
    p.add_argument("--n-parts", type=int, default=None)
    p.add_argument("--backend", choices=time_backends, default="auto")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card, 'cuda')")
    _add_resilience_flags(p, "timesteps")
    _add_run_flags(p)
    p.set_defaults(fn=cmd_dynamics)

    p = sub.add_parser("newmark",
                       help="implicit Newmark-beta time history, one PCG "
                            "solve a step (timestep snapshots + --resume)")
    p.add_argument("scratch")
    p.add_argument("run_id")
    p.add_argument("--n-steps", type=int, required=True,
                   help="number of implicit timesteps to integrate")
    p.add_argument("--dt", type=float, default=None,
                   help="timestep (default: the model's dt; "
                        "unconditionally stable at beta=1/4 gamma=1/2, so "
                        "dt is a resolution choice, not a CFL bound)")
    p.add_argument("--beta", type=float, default=0.25)
    p.add_argument("--gamma", type=float, default=0.5)
    p.add_argument("--damping", type=float, default=0.0,
                   help="mass-proportional damping coefficient c_m")
    p.add_argument("--n-parts", type=int, default=None)
    _add_solver_flags(p)
    p.add_argument("--backend", choices=time_backends, default="auto")
    _add_resilience_flags(p, "timesteps")
    _add_run_flags(p)
    p.set_defaults(fn=cmd_newmark)

    p = sub.add_parser("export", help="export result frames to VTK")
    p.add_argument("scratch")
    p.add_argument("run_id")
    p.add_argument("vars", help='e.g. "U PS1 ES"')
    p.add_argument("mode", choices=["Full", "Boundary", "MidSlices",
                                    "Delaunay"])
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("demo", help="synthetic end-to-end demo")
    p.add_argument("--nx", type=int, default=16)
    p.add_argument("--ny", type=int, default=0)
    p.add_argument("--nz", type=int, default=0)
    p.add_argument("--scratch", default="./scratch")
    _add_solver_flags(p, precision_default="mixed")
    p.add_argument("--octree", action="store_true",
                   help="graded octree model with transition pattern types "
                        "(nx/ny/nz = base cells; solved on the hybrid "
                        "level-grid backend)")
    p.add_argument("--max-level", type=int, default=2,
                   help="octree refinement levels (with --octree)")
    p.add_argument("--poisson", action="store_true",
                   help="scalar Poisson/diffusion model (1 dof per node, "
                        "heterogeneous conductivity)")
    _add_run_flags(p)
    p.set_defaults(fn=cmd_demo)

    p = sub.add_parser("cache-stats", help="show the partition cache table")
    _add_cache_flag(p)
    p.set_defaults(fn=cmd_cache_stats)

    p = sub.add_parser("perf-report",
                       help="measured-vs-model phase attribution: the "
                            "matvec/precond/reduction/axpy phases of a "
                            "live solver timed beside the cost model's "
                            "prediction")
    p.add_argument("scratch", nargs="?", default=None,
                   help="scratch dir with an ingested MDF model "
                        "(default: a synthetic --nx cube)")
    p.add_argument("--nx", type=int, default=12,
                   help="synthetic heterogeneous cube size when no "
                        "scratch dir is given")
    p.add_argument("--settings", default=None)
    p.add_argument("--n-parts", type=int, default=None)
    p.add_argument("--tol", type=float, default=None)
    p.add_argument("--max-iter", type=int, default=None)
    from pcg_mpi_solver_tpu_torch.config import PCG_VARIANTS, PRECONDS

    p.add_argument("--precond", choices=list(PRECONDS), default=None)
    p.add_argument("--pcg-variant", choices=list(PCG_VARIANTS),
                   default=None, dest="pcg_variant")
    p.add_argument("--nrhs", type=int, default=1,
                   help="probe the blocked programs at this block width")
    p.add_argument("--inner", type=int, default=16,
                   help="applications a timed phase")
    p.add_argument("--reps", type=int, default=5,
                   help="interleaved measurement rounds")
    p.add_argument("--backend", choices=BACKENDS, default="general",
                   help="matvec backend of the probed solver")
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="also capture a profiler trace of one warm solve "
                        "into DIR and read it back: the table gains the "
                        "measured column")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card, 'cuda')")
    _add_run_flags(p)
    p.set_defaults(fn=cmd_perf_report)

    p = sub.add_parser("prof-report",
                       help="read a captured torch.profiler trace back "
                            "into per-phase device time (offline, "
                            "tolerant)")
    p.add_argument("path", help="the *.trace.json(.gz) file, its run "
                                "dir, or a capture root")
    p.add_argument("--iters", type=int, default=None,
                   help="iteration count for the per-iteration columns "
                        "(default: the capture sidecar's)")
    p.add_argument("--telemetry-out", default=None, metavar="FILE.jsonl",
                   help="also emit the prof_report event and prof.* "
                        "gauges here")
    p.set_defaults(fn=cmd_prof_report)

    p = sub.add_parser("summary",
                       help="offline summary of a telemetry/flight JSONL "
                            "file, tolerant of a truncated last line")
    p.add_argument("files", nargs="+", metavar="FILE.jsonl")
    p.set_defaults(fn=cmd_summary)

    p = sub.add_parser("telemetry-merge",
                       help="merge per-process telemetry shards "
                            "(FILE.p<N>.jsonl) into one time-ordered "
                            "stream")
    p.add_argument("paths", nargs="+", metavar="FILE.jsonl",
                   help="base path(s); on-disk .p<N> siblings are found "
                        "too")
    p.add_argument("--out", required=True, metavar="MERGED.jsonl")
    p.add_argument("--align", choices=["none", "collectives"],
                   default="none",
                   help="'collectives': clock-align the shards on matched "
                        "dispatch completions before ordering (events "
                        "gain t_aligned; t is kept)")
    p.set_defaults(fn=cmd_telemetry_merge)

    p = sub.add_parser("validate",
                       help="run the preflight checks against a scratch "
                            "model (dry run; no partition, no solve)")
    p.add_argument("scratch")
    p.add_argument("--settings", default=None)
    p.add_argument("--tol", type=float, default=None)
    p.add_argument("--max-iter", type=int, default=None)
    p.add_argument("--precision", choices=["direct", "mixed"], default=None)
    _add_preflight_flag(p)
    p.set_defaults(fn=cmd_validate)

    p = sub.add_parser("warmup",
                       help="pay a model's setup before a solve: the "
                            "partition cache filled, the kernels built, "
                            "the operators applied once")
    p.add_argument("scratch", nargs="?", default=None,
                   help="scratch dir with an ingested MDF model (or use "
                        "--demo-nx)")
    p.add_argument("--demo-nx", type=int, default=0,
                   help="warm a synthetic nx^3 cube instead of a scratch "
                        "model")
    p.add_argument("--n-parts", type=int, default=None)
    _add_solver_flags(p)
    p.add_argument("--backend", choices=BACKENDS, default="auto")
    _add_run_flags(p)
    p.set_defaults(fn=cmd_warmup)

    p = sub.add_parser("watch",
                       help="live run monitor: tail the flight/telemetry "
                            "JSONL shards of a running solve or a serve "
                            "journal: progress, stall alarm, cost-model x "
                            "observed-rate ETA")
    p.add_argument("path", metavar="FILE.jsonl",
                   help="base telemetry/flight path; on-disk .p<N> "
                        "shards are tailed together")
    p.add_argument("--once", action="store_true",
                   help="print one snapshot and exit (exit 3 when it is "
                        "a stall)")
    p.add_argument("--interval", type=float, default=5.0,
                   help="poll interval in seconds (default 5)")
    p.add_argument("--stall-after", type=float, default=None,
                   metavar="S",
                   help="flag a stall when ALL shards are silent this "
                        "long (default: 3x the flight heartbeat "
                        "cadence)")
    p.add_argument("--tol", type=float, default=1e-8,
                   help="convergence target the ETA aims the observed "
                        "rate at (the stream does not carry the run's "
                        "tol; default matches SolverConfig)")
    p.add_argument("--telemetry-out", default=None, metavar="FILE.jsonl",
                   help="emit watch/stall events here (never to the "
                        "watched stream)")
    p.set_defaults(fn=cmd_watch)

    p = sub.add_parser("serve",
                       help="solve service: admit filesystem-submitted "
                            "jobs against one operator on the card "
                            "(cost-model deadline pricing, bounded queue "
                            "with load shedding, nrhs packing, crash-"
                            "durable exactly-once journal)")
    p.add_argument("scratch", nargs="?", default=None,
                   help="scratch dir with an ingested model (or use "
                        "--synthetic)")
    p.add_argument("--spool", required=True, metavar="DIR",
                   help="service root: incoming/, results/, "
                        "journal.jsonl")
    p.add_argument("--synthetic", default=None, metavar="NX[,NY,NZ]",
                   help="serve a synthetic heterogeneous cube instead "
                        "of a scratch model")
    p.add_argument("--queue-max", type=int, default=16,
                   help="bounded admission queue depth (default 16); "
                        "arrivals beyond it shed past-deadline jobs or "
                        "are rejected queue_full")
    p.add_argument("--widths", default="1,2,4,8",
                   help="standard nrhs block widths jobs are packed "
                        "into (default 1,2,4,8)")
    p.add_argument("--expected-iters", type=int, default=None,
                   help="iteration count admission prices deadlines "
                        "against (default: the solver max_iter cap)")
    p.add_argument("--poll-s", type=float, default=0.05,
                   help="incoming-directory poll interval (default 0.05)")
    p.add_argument("--idle-exit-s", type=float, default=None,
                   help="drain after this long idle (default: serve "
                        "until SIGTERM)")
    p.add_argument("--max-blocks", type=int, default=None,
                   help="drain after dispatching N blocks")
    p.add_argument("--n-parts", type=int, default=None)
    _add_solver_flags(p)
    p.add_argument("--backend", choices=BACKENDS, default="auto")
    _add_run_flags(p)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("submit",
                       help="submit one job to a solve-service spool "
                            "(atomic drop; loads no torch)")
    p.add_argument("--spool", required=True, metavar="DIR")
    p.add_argument("--scale", type=float, default=None,
                   help="load case = scale * the model's reference "
                        "load F")
    p.add_argument("--rhs", default=None, metavar="FILE.npy",
                   help="load case = an (n_dof,) .npy column (exactly "
                        "one of --scale / --rhs)")
    p.add_argument("--deadline-s", type=float, default=3600.0,
                   help="relative deadline admission prices against "
                        "(default 3600)")
    p.add_argument("--job-id", default=None,
                   help="explicit job id (default: generated); a "
                        "consumed id submitted again is dropped")
    p.set_defaults(fn=cmd_submit)

    p = sub.add_parser("jobs",
                       help="job table of a solve-service spool, folded "
                            "from its journal (loads no torch)")
    p.add_argument("--spool", required=True, metavar="DIR")
    p.set_defaults(fn=cmd_jobs)

    p = sub.add_parser("fleet-report",
                       help="cross-process collective-skew attribution "
                            "over a multi-process capture root (p<idx>/ "
                            "subdirs): clock-align on matched collective "
                            "ends, split transport vs wait, name the "
                            "straggler per phase (offline)")
    p.add_argument("path", help="capture root holding the per-rank "
                                "p<idx>/ subdirs (the --profile-dir)")
    p.add_argument("--json", default=None, metavar="FILE.json",
                   help="also write the full report as JSON")
    p.add_argument("--telemetry-out", default=None, metavar="FILE.jsonl",
                   help="also emit the fleet_report event and fleet.* "
                        "gauges here")
    p.set_defaults(fn=cmd_fleet_report)

    p = sub.add_parser("lint",
                       help="contract lint (analysis/): collective budgets "
                            "a trip, host reads, dtype discipline, carry "
                            "handoff and fingerprint/key completeness on "
                            "recorded trips, plus source/artifact lints")
    # one option surface with `python -m pcg_mpi_solver_tpu_torch.analysis`
    # (analysis/ imports load no torch)
    from pcg_mpi_solver_tpu_torch.analysis.__main__ import add_lint_args

    add_lint_args(p)
    p.set_defaults(fn=cmd_lint)

    bench_help = ("benchmark harness (bench.py): prints one JSON line; "
                  "configured by BENCH_* environment variables, on the "
                  "card unless BENCH_FORCE_CPU=1")
    p = sub.add_parser("bench", help=bench_help, description=bench_help)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("trend",
                       help="bench-trend regression sentinel: match legs "
                            "across BENCH_r*.json round artifacts (by "
                            "shape/variant/precond/nrhs/platform/device) "
                            "and print threshold-based regressed/improved/"
                            "flat verdicts; exit 1 on a regression "
                            "(loads no torch)")
    p.add_argument("artifacts", nargs="*", metavar="BENCH_rNN.json",
                   help="round artifacts in round order (default: "
                        "./BENCH_r*.json sorted)")
    p.add_argument("--fresh", default=None, metavar="FILE.json",
                   help="a fresh artifact (raw bench line or round "
                        "wrapper) appended as the newest round")
    p.add_argument("--threshold", type=float, default=None,
                   help="relative change separating flat from "
                        "regressed/improved (default 0.10)")
    p.set_defaults(fn=cmd_trend)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])

"""Benchmark harness of the port: the PCG solve on the card against the
reference's per-rank hot loop.

Port of the measurement half of ``pcg_mpi_solver_tpu/bench.py``::

    python -m pcg_mpi_solver_tpu_torch.bench          # on the card
    BENCH_FORCE_CPU=1 python -m pcg_mpi_solver_tpu_torch.bench

Prints ONE JSON line on stdout, ``{"schema", "metric", "value", "unit",
"vs_baseline", "detail"}`` (``obs/schema.py``'s bench contract), and its
breadcrumbs on stderr.

Metric: sustained PCG iteration throughput (dof-iterations / second) of
the full solve on the card, measured on a converged quasi-static step
after a warm-up solve: the timed solve runs again from a zeroed state
(``Solver.reset_state``), so kernel builds and first launches are not in
it.  After the timed solve one stderr line ``# launches: {...}`` gives
the slab kernels' launch counters (``ops/structured_matvec.LAUNCHES``)
of that solve, by variant and dtype.

Baseline: ``NumpyRefSolver`` (``solver/numpy_ref.py``) re-implements the
reference's per-rank hot loop (type-grouped gather -> Ke@(ck*u) ->
bincount scatter, pcg_solver.py:277-300) in plain numpy; its cost per
(dof * iteration) is measured live, in a child process that runs numpy
only and sees no card, on the machine the bench runs on (on a model of
at most ``BENCH_REF_MAX_DOFS`` dofs, scaled per dof), and divided by 8
for an idealised perfect 8-rank scaling.  ``vs_baseline`` is always this
live number: there is no stored constant to fall back on.

Default model: ``make_cube_model(150, ...)``, 10,328,853 dofs, mixed
precision, classic PCG, scalar Jacobi, on the structured backend with
the v6 slab kernel (``PCG_TPU_PALLAS_V`` picks another), chunked at the
JAX package's automatic cap.

No fallback: the bench measures the card or fails.  Without a CUDA
device it fails unless ``BENCH_FORCE_CPU=1`` asks for the CPU (then
platform ``"cpu"`` and the small ``BENCH_CPU_NX`` / ``BENCH_CPU_OT_N``
rungs).  Any failure — no device, a kernel that does not build or
launch, the last ladder rung, the live baseline — prints the zero-value
error sentinel (``_error_line``) on stdout and exits 1.  Only the size
ladder steps down: when a rung fails to build, solve or converge, the
next smaller one runs, logged on stderr.

The line keeps the JAX package's keys, except that ``tpu_ms_per_iter``
is ``ms_per_iter``, ``detail.platform`` is ``"gpu"`` (``"cpu"`` when
asked for), and ``detail.device`` is the card's ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` line; it adds the
selected kernel (``kernel_variant``) and the timed solve's launch
counters (``launches``).

Env knobs: BENCH_NX/NY/NZ (cells; pinning one skips the ladder),
BENCH_LADDER (cube rungs, default "150,128,96"), BENCH_MODEL
(cube|octree), BENCH_OT_N, BENCH_OT_LEVEL (default 4), BENCH_OT_LADDER
(default "22,18,12"), BENCH_TOL (1e-7), BENCH_PARTS (1), BENCH_DTYPE
(float32), BENCH_MODE (mixed|direct), BENCH_BACKEND
(auto|structured|hybrid|general), BENCH_PCG_VARIANT
(classic|fused|pipelined), BENCH_PRECOND (jacobi|block3|mg), BENCH_NRHS
(the timed leg solves an nrhs-wide block of the load through
``Solver.solve_many``; detail.nrhs and detail.dof_iter_rhs_per_s),
BENCH_PLATEAU and BENCH_PROGRESS (the mixed shell's plateau and progress
windows), BENCH_PALLAS (auto|on), BENCH_CACHE_DIR (the partition cache;
off by default, so the setup is a cold one), BENCH_REF_ITERS (10),
BENCH_REF_MAX_DOFS (800000), BENCH_REF_TIMEOUT_S (900),
BENCH_MODEL_CACHE (1: models pickled under ``.bench_cache/``),
BENCH_MODEL_CACHE_GB (8), BENCH_FLIGHT (the flight recorder's JSONL,
default bench_flight.jsonl, 0 = off), BENCH_PROFILE=1 (one profiled warm
solve after the timed one, captured into BENCH_PROFILE_DIR, default
bench_profile/, and read back by ``obs/profview.py``: detail gains
measured_ms_per_iter_matvec and overlap_frac), BENCH_FORCE_CPU,
BENCH_CPU_NX (48), BENCH_CPU_OT_N (6); BENCH_SERVE=1 runs the
solve-service leg (``serve/bench.py``) and BENCH_SETUP_LADDER the setup
ladder (``setup_ladder.py``) instead; plus the solver's kernel knobs
PCG_TPU_PALLAS_V and PCG_TPU_PALLAS_PLANES.
"""

import json
import os
import subprocess
import sys
import time

# obs/ loads no torch: the live baseline's child imports this module
# and stays numpy-only
from pcg_mpi_solver_tpu_torch.obs.metrics import MetricsRecorder, StderrSink
from pcg_mpi_solver_tpu_torch.obs.schema import BENCH_SCHEMA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The bench's metrics registry: one logging path for the harness and the
# Solver it drives (constructed with recorder=_REC).  The stderr sink
# prefixes each line with [pcg-tpu HH:MM:SS]; phase spans land in the
# line's detail.phases.
_REC = MetricsRecorder(sinks=[StderrSink()])


def _log(msg):
    _REC.note(msg)


def _cpu_only_env():
    """Env of a child that must not touch the card: no CUDA device
    visible, the repository on its path."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    pp = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    if REPO not in pp:
        pp.insert(0, REPO)
    env["PYTHONPATH"] = os.pathsep.join(pp)
    return env


def device_label(platform):
    """``detail.device``: the card's ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` line (the power limit sets how
    fast a card runs under load), or "cpu"."""
    if platform == "cpu":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        import torch

        return (f"{torch.cuda.get_device_name(0)}, power limit not read "
                f"({type(e).__name__})")


def _model_cache_key(kind, gen_kwargs):
    """Cache key = the caller's FULL generator kwargs + a hash of the
    model-source files — so neither a generator code change, an edited
    call-site kwarg, nor a changed generator default can serve a stale
    model."""
    import hashlib

    import pcg_mpi_solver_tpu_torch.models as m

    h = hashlib.sha256()
    pkg = os.path.dirname(m.__file__)
    for fn in sorted(os.listdir(pkg)):
        if fn.endswith(".py"):
            with open(os.path.join(pkg, fn), "rb") as f:
                h.update(f.read())
    h.update(repr((kind, sorted(gen_kwargs.items()))).encode())
    return h.hexdigest()[:16]


def cached_model(kind, **gen_kwargs):
    """Build (or load from the on-disk cache ``.bench_cache/``) a model,
    keyed on the full kwargs + a models-source hash.  Disable with
    BENCH_MODEL_CACHE=0."""
    import pickle

    cache_dir = os.path.join(REPO, ".bench_cache")
    use_cache = os.environ.get("BENCH_MODEL_CACHE", "1") == "1"
    path = os.path.join(
        cache_dir, f"model_{_model_cache_key(kind, gen_kwargs)}.pkl")
    if use_cache:
        # orphans of a killed writer go on the read path too: if writes
        # keep failing (a full disk) the write-side sweep never runs
        _sweep_stale_tmps(cache_dir)
    if use_cache and os.path.exists(path):
        try:
            with open(path, "rb") as f:
                model = pickle.load(f)
        except Exception as e:                          # noqa: BLE001
            _log(f"# model cache read failed ({type(e).__name__}); rebuilding")
        else:
            try:
                os.utime(path)                          # LRU touch
            except OSError:
                pass
            return model

    if kind == "octree":
        from pcg_mpi_solver_tpu_torch.models.octree import make_octree_model

        model = make_octree_model(**gen_kwargs)
    else:
        from pcg_mpi_solver_tpu_torch.models import make_cube_model

        model = make_cube_model(**gen_kwargs)
    if use_cache:
        try:
            from pcg_mpi_solver_tpu_torch.utils.io import write_atomic

            os.makedirs(cache_dir, exist_ok=True)
            # streamed: a flagship pickle is hundreds of MB
            write_atomic(path, lambda f: pickle.dump(
                model, f, protocol=pickle.HIGHEST_PROTOCOL))
            _evict_model_cache(cache_dir, keep=path)
        except Exception as e:                          # noqa: BLE001
            _log(f"# model cache write failed ({type(e).__name__}); continuing")
    return model


def _build_model(kind, nx, ny, nz, ot_n, ot_level):
    if kind == "octree":
        return cached_model(kind, nx0=ot_n, ny0=ot_n, nz0=ot_n,
                            max_level=ot_level, n_incl=6, seed=2,
                            E=30e9, nu=0.2, load="traction",
                            load_value=1e6)
    return cached_model(kind, nx=nx, ny=ny, nz=nz, E=30e9, nu=0.2,
                        load="traction", load_value=1e6,
                        heterogeneous=True)


def _sweep_stale_tmps(cache_dir):
    """Remove model_*.tmp files older than an hour (orphans of a killed
    writer, which the size cap would never see); best-effort."""
    try:
        for fn in os.listdir(cache_dir):
            if fn.startswith("model_") and fn.endswith(".tmp"):
                p = os.path.join(cache_dir, fn)
                if time.time() - os.stat(p).st_mtime > 3600:
                    os.remove(p)
    except OSError:
        pass


def _evict_model_cache(cache_dir, keep, cap_bytes=None):
    """LRU-evict model pickles until the cache fits the size cap
    (BENCH_MODEL_CACHE_GB, default 8), never ``keep``: a source edit
    re-keys every entry and orphans the old generation.  The one
    eviction protocol of the port: ``cache/partition_cache.evict_lru``."""
    from pcg_mpi_solver_tpu_torch.cache.partition_cache import evict_lru

    if cap_bytes is None:
        cap_bytes = float(os.environ.get("BENCH_MODEL_CACHE_GB", 8)) * 2**30
    _sweep_stale_tmps(cache_dir)
    evict_lru(cache_dir, keep=keep, cap_bytes=cap_bytes, suffix=".pkl")


def measure_ref_ns(kind, n_dof, ref_max_dofs, n_ref_iters,
                   nx, ny, nz, ot_n, ot_level):
    """Measure the numpy reference hot-loop cost; prints ONE line
    ``REF_NS <ns> <note>`` on stdout.  Runs in a child process (numpy
    only, no card visible), so an OOM or a hang here cannot take the
    bench down after its timed solve."""
    from pcg_mpi_solver_tpu_torch.solver.numpy_ref import NumpyRefSolver

    if n_dof <= ref_max_dofs:
        ref_model = _build_model(kind, nx, ny, nz, ot_n, ot_level)
        note = "same model"
    elif kind == "octree":
        ref_model = _build_model(kind, 0, 0, 0, 8, 3)
        note = f"scaled per-dof from a {ref_model.n_dof}-dof octree"
    else:
        rn = max(8, int(round((ref_max_dofs / 3.1) ** (1 / 3))) - 1)
        ref_model = _build_model("cube", rn, rn, rn, 0, 0)
        note = f"scaled per-dof from {ref_model.n_dof} dofs"
    ref_per_iter = NumpyRefSolver(ref_model).time_per_iter(n_iters=n_ref_iters)
    print(f"REF_NS {ref_per_iter / ref_model.n_dof * 1e9:.4f} {note}",
          flush=True)


def _live_baseline(kind, n_dof, nx, ny, nz, ot_n, ot_level):
    """The live numpy baseline in a child process: (ref_ns, note), or
    None when it failed or timed out."""
    ref_max_dofs = int(os.environ.get("BENCH_REF_MAX_DOFS", 800_000))
    n_ref_iters = int(os.environ.get("BENCH_REF_ITERS", 10))
    # the timeout covers the model's build in the child too
    timeout_s = float(os.environ.get("BENCH_REF_TIMEOUT_S", 900))
    code = (
        "from pcg_mpi_solver_tpu_torch.bench import measure_ref_ns\n"
        f"measure_ref_ns({kind!r}, {n_dof}, {ref_max_dofs}, {n_ref_iters}, "
        f"{nx}, {ny}, {nz}, {ot_n}, {ot_level})\n")
    try:
        proc = subprocess.run([sys.executable, "-c", code],
                              env=_cpu_only_env(),
                              capture_output=True, text=True,
                              timeout=timeout_s)
    except subprocess.TimeoutExpired:
        _log(f"# live baseline timed out after {timeout_s:.0f}s")
        return None
    for line in (proc.stdout or "").splitlines():
        if line.startswith("REF_NS "):
            _, ns, note = line.split(" ", 2)
            return float(ns), note
    tail = (proc.stderr or "").strip().splitlines()[-4:]
    _log(f"# live baseline failed (rc={proc.returncode}): "
         + " | ".join(tail))
    return None


def _run_config_extra(solver, dtype, mode, pallas_on, n_parts, t_part,
                      platform, setup=None):
    """The run-configuration detail keys of the line.  ``setup`` carries
    the warm-path attribution fields (setup_s / setup_cache /
    time_to_first_iter_s)."""
    sc = solver.config.solver
    out = {
        "dtype": dtype,
        "mode": mode,
        "backend": solver.backend,
        "pcg_variant": sc.pcg_variant,
        "precond": sc.precond,
        # the hand-written slab kernels engaged (the card's structured
        # and hybrid backends); the CPU runs their plain versions
        "pallas": bool(pallas_on),
        "kernel_variant": getattr(solver, "kernel_variant", None),
        "matvec_form": getattr(solver.ops, "form", "n/a"),
        "combine": getattr(solver.ops, "combine", "n/a"),
        "nrhs": int(sc.nrhs or 1),
        "n_parts": n_parts,
        "partition_s": round(t_part, 2),
        "platform": platform,
        "device": device_label(platform),
    }
    out.update(setup or {})
    return out


class _FirstDispatchSink:
    """Metrics sink that records the wall-clock END of the first
    dispatch it sees — the bench's ``time_to_first_iter_s`` anchor (the
    dispatch event is emitted when its span closes)."""

    def __init__(self):
        self.t_end = None

    def emit(self, ev):
        if self.t_end is None and ev.get("kind") == "dispatch":
            self.t_end = ev.get("t")

    def close(self):
        pass


def _predict_ms_per_iter(detail):
    """Roofline-predicted ms/iter (``obs/perf.py``) of a line, from the
    line's own detail fields.  None (-> null) when the model cannot be
    built; an UNKNOWN variant/precond name still raises (a mislabeled
    line must not get a fabricated prediction)."""
    from pcg_mpi_solver_tpu_torch.obs import perf as _perf

    try:
        shape = _perf.shape_from_detail(detail)
        if shape is None:
            return None
        cm = _perf.cost_model(
            shape,
            str(detail.get("pcg_variant", "classic")),
            str(detail.get("precond", "jacobi")),
            int(detail.get("nrhs", 1) or 1),
            _perf.resolve_profile(str(detail.get("platform", "cpu"))))
        return cm["predicted_ms_per_iter"] or None
    except KeyError:
        raise
    except Exception as e:                              # noqa: BLE001
        _log(f"# cost model unavailable for this line "
             f"({type(e).__name__}: {e}); predicted_ms_per_iter=null")
        return None


def _result_json(model, kind, r1, iters, ref_ns, ref_note, extra):
    dof_iters_per_sec = model.n_dof * iters / r1.wall_s
    # idealized 8-rank reference: perfect 8x scaling of the measured hot loop
    baseline = 8.0 / (ref_ns * 1e-9)
    detail = {
        "n_dof": model.n_dof,
        "model": kind,
        "iters": int(iters),
        "flag": int(r1.flag),
        "relres": float(r1.relres),
        "solve_wall_s": round(r1.wall_s, 4),
        # wall to CONVERGED-at-tol; null when the solve did not converge
        "time_to_tol_s": round(r1.wall_s, 4) if r1.flag == 0 else None,
        "ms_per_iter": round(r1.wall_s / iters * 1e3, 4),
        "numpy_ref_ns_per_dof_iter": round(ref_ns, 4),
        "baseline_model": (
            "measured numpy re-impl of the reference per-rank hot loop "
            "/ 8 (ideal scaling; real mpi4py+OpenMPI not installable in "
            "this image)"),
        "ref_measured_on": ref_note,
    }
    detail.update(extra)
    # dof*iter*rhs/s: the primary value at nrhs=1, the blocked
    # amortization at nrhs>1 (the primary metric stays per column)
    nrhs = int(detail.get("nrhs", 1) or 1)
    detail["nrhs"] = nrhs
    detail["dof_iter_rhs_per_s"] = round(dof_iters_per_sec * nrhs, 1)
    # the analytic cost model's verdict on this line (obs/perf.py), from
    # the line's own fields; null when the model cannot be derived
    predicted = _predict_ms_per_iter(detail)
    detail["predicted_ms_per_iter"] = predicted
    detail["model_ratio"] = (
        round(detail["ms_per_iter"] / predicted, 3)
        if predicted else None)
    detail["phases"] = {k: round(v["total_s"], 3)
                       for k, v in _REC.span_stats().items()}
    return json.dumps({
        "schema": BENCH_SCHEMA,
        "metric": "pcg_dof_iterations_per_second",
        "value": round(dof_iters_per_sec, 1),
        "unit": "dof*iter/s",
        "vs_baseline": round(dof_iters_per_sec / baseline, 3),
        "detail": detail,
    })


def _launch_counts():
    """The slab kernels' launch counters as {"v6 float32": n, ...}."""
    from pcg_mpi_solver_tpu_torch.ops.structured_matvec import LAUNCHES

    return {f"{v} {d}": int(n) for (v, d), n in sorted(LAUNCHES.items())}


def _solve_once(kind, nx, ny, nz, ot_n, ot_level, backend, n_parts, tol,
                mode, dtype, device):
    """Build the model and solver, warm-solve, then the timed solve from
    a zeroed state.

    Returns (model, solver, r1, iters, t_part, pallas_on, setup_info,
    launches): ``launches`` the timed solve's kernel launch counters."""
    import numpy as np

    from pcg_mpi_solver_tpu_torch.config import (
        RunConfig, SolverConfig, TimeHistoryConfig)
    from pcg_mpi_solver_tpu_torch.ops.structured_matvec import (
        reset_launch_counts)
    from pcg_mpi_solver_tpu_torch.solver.driver import Solver, StepResult
    from pcg_mpi_solver_tpu_torch.validate import run_preflight

    t_gen0 = time.perf_counter()
    with _REC.span("model_gen", emit=True):
        model = _build_model(kind, nx, ny, nz, ot_n, ot_level)
    _log(f"# model: {model.n_elem} elems / {model.n_dof} dofs "
         f"(gen {time.perf_counter()-t_gen0:.1f}s); device={device} "
         f"parts={n_parts} dtype={dtype} mode={mode} backend={backend}")

    solver_kw = {}
    if "BENCH_PROGRESS" in os.environ:   # override the SolverConfig default
        solver_kw["mixed_progress_window"] = int(os.environ["BENCH_PROGRESS"])
    cfg = RunConfig(
        solver=SolverConfig(tol=tol, max_iter=20000, dtype=dtype,
                            dot_dtype="float64", precision_mode=mode,
                            pallas=os.environ.get("BENCH_PALLAS", "auto"),
                            # an unknown variant or preconditioner fails
                            # here, at config build
                            pcg_variant=os.environ.get(
                                "BENCH_PCG_VARIANT", "classic"),
                            nrhs=int(os.environ.get("BENCH_NRHS", "1")
                                     or 1),
                            precond=(os.environ.get("BENCH_PRECOND",
                                                    "jacobi")
                                     or "jacobi"),
                            mixed_plateau_window=int(
                                os.environ.get("BENCH_PLATEAU", 0)),
                            **solver_kw),
        time_history=TimeHistoryConfig(time_step_delta=[0.0, 1.0]),
    )
    # the partition cache: off by default, so the setup is a cold one
    cfg.cache_dir = os.environ.get("BENCH_CACHE_DIR", "")
    # the preflight gate, once, explicitly (the line's log carries its
    # verdict); the Solver then skips its own scan
    with _REC.span("preflight", emit=True):
        checks = run_preflight(model, cfg, recorder=_REC,
                               context={"kind": "quasi_static"})
    if checks:
        warned = sum(1 for c in checks if c.status == "warn")
        _log(f"# preflight: {len(checks)} checks ok"
             + (f" ({warned} warning(s))" if warned else ""))
        cfg.preflight = "off"
    t_part0 = time.perf_counter()
    # time_to_first_iter_s: solver construction start -> end of the
    # first dispatch (kernel builds and first launches included)
    fd_sink = _FirstDispatchSink()
    t_fd0 = time.time()                 # dispatch events carry time.time()
    _REC.add_sink(fd_sink)
    try:
        with _REC.span("partition_upload", emit=True):
            s = Solver(model, cfg, n_parts=n_parts, device=device,
                       backend=backend, recorder=_REC)
        t_part = time.perf_counter() - t_part0
        pallas_on = (s.device.type == "cuda"
                     and s.backend in ("structured", "hybrid"))
        _log(f"# partition+upload: {t_part:.2f}s (backend={s.backend}, "
             f"dispatch_cap={s._dispatch_cap}, kernel={s.kernel_variant}, "
             f"pallas={pallas_on})")
        with _REC.span("warm_solve", emit=True):
            r0 = s.step(1.0)
    finally:
        # detach the one-shot sink on every exit path: a leaked sink
        # would latch a later ladder rung's first dispatch
        _REC.remove_sink(fd_sink)
    _log(f"# warm solve: flag={r0.flag} iters={r0.iters} "
         f"relres={r0.relres:.3e} wall={r0.wall_s:.2f}s (incl. first "
         f"launches)")
    setup_info = {
        "setup_s": round(s.setup_s, 3),
        "setup_cache": s.setup_cache,
        "time_to_first_iter_s": (round(fd_sink.t_end - t_fd0, 3)
                                 if fd_sink.t_end is not None else None),
    }
    _log(f"# setup: {setup_info['setup_s']}s "
         f"({setup_info['setup_cache']} partition), first iter at "
         f"{setup_info['time_to_first_iter_s']}s")

    # the measured solve, from a zeroed state; the launch counters count
    # this solve alone
    s.reset_state()
    nrhs = int(cfg.solver.nrhs or 1)
    if nrhs > 1:
        # an nrhs-wide block of the load against the same operator
        # (Solver.solve_many: one lockstep Krylov loop); a warm block
        # first, so the timed one builds no blocked trees
        fblk = np.repeat(np.asarray(model.F)[:, None], nrhs, axis=1)
        with _REC.span("warm_solve_many", emit=True):
            s.solve_many(fblk)
        reset_launch_counts()
        with _REC.span("timed_solve", emit=True):
            mres = s.solve_many(fblk)
        # solve_wall_s excludes the per-call host rhs staging (validate +
        # global->local map + upload), which the scalar step never pays
        r1 = StepResult(flag=int(mres.flags.max(initial=0)),
                        relres=float(mres.relres.max(initial=0.0)),
                        iters=int(mres.iters.max(initial=0)),
                        wall_s=mres.solve_wall_s)
        setup_info["nrhs_quarantined"] = len(mres.quarantined)
        setup_info["nrhs_recoveries"] = int(mres.recoveries)
        _log(f"# timed blocked solve: nrhs={nrhs} "
             f"flags={mres.flags.tolist()} "
             f"iters={mres.iters.tolist()} wall={r1.wall_s:.3f}s "
             f"(+{mres.wall_s - mres.solve_wall_s:.3f}s rhs staging, "
             "excluded; quarantined="
             f"{list(mres.quarantined)} recoveries={mres.recoveries})")
    else:
        reset_launch_counts()
        with _REC.span("timed_solve", emit=True):
            r1 = s.step(1.0)
    launches = _launch_counts()
    iters = max(r1.iters, 1)
    _log(f"# timed solve: flag={r1.flag} iters={iters} "
         f"relres={r1.relres:.3e} wall={r1.wall_s:.3f}s "
         f"-> {r1.wall_s/iters*1e3:.3f} ms/iter")
    _log("# launches: " + json.dumps(launches))
    # BENCH_PROFILE=1: one profiled warm solve AFTER the timed one (the
    # timed number is never perturbed)
    setup_info.update(_capture_bench_profile(s, nrhs))
    return model, s, r1, iters, t_part, pallas_on, setup_info, launches


def _capture_bench_profile(solver, nrhs):
    """BENCH_PROFILE=1: capture and parse ONE profiled warm solve on the
    warm solver (``obs/profview.py``).  Returns the detail fields the
    capture measured — ``measured_ms_per_iter_matvec`` /
    ``overlap_frac``, and ``skew_frac`` / ``straggler_rank`` across
    processes — and {} otherwise: a line never carries a measurement
    that was not taken.  A failed capture logs and returns {}."""
    if os.environ.get("BENCH_PROFILE") != "1":
        return {}
    from pcg_mpi_solver_tpu_torch.obs import fleet, profview
    from pcg_mpi_solver_tpu_torch.parallel.distributed import process_index

    out = {}
    pdir = os.environ.get("BENCH_PROFILE_DIR", "bench_profile")
    try:
        with _REC.span("profile_capture", emit=True):
            cap = profview.capture_solve_profile(
                solver, pdir, nrhs=max(1, int(nrhs or 1)), recorder=_REC)
        rep = profview.profile_report(cap["artifact"])
        profview.emit_prof_report(_REC, rep)
        mv = (rep["phases"].get("matvec") or {}).get("ms_per_iter")
        if mv is not None:
            out["measured_ms_per_iter_matvec"] = mv
        if rep.get("overlap_frac") is not None:
            out["overlap_frac"] = round(rep["overlap_frac"], 6)
        _log(f"# profiled warm solve: artifact={cap['artifact']} "
             f"verdict={rep['verdict']} matvec_ms_per_iter={mv} "
             f"overlap_frac={rep.get('overlap_frac')} "
             "(read back: cli prof-report)")
        frep = fleet.fleet_report(pdir)
        fdet = fleet.bench_detail_fields(frep, process_index())
        if fdet:
            fleet.emit_fleet_report(_REC, frep)
            out.update(fdet)
            _log(f"# fleet skew: skew_frac={fdet['skew_frac']} "
                 f"straggler_rank={fdet['straggler_rank']} "
                 f"straggler=p{frep['straggler']} "
                 "(read back: cli fleet-report)")
    except Exception as e:                              # noqa: BLE001
        _log(f"# profile capture failed ({type(e).__name__}: {e}); "
             "continuing unprofiled")
    return out


def _ladder(kind, cpu_fallback):
    """Rungs of (nx, ny, nz, ot_n, ot_level), flagship first;
    ``cpu_fallback`` (BENCH_FORCE_CPU=1) takes the small CPU rung."""
    def ints(s):
        vals = [int(t) for t in (x.strip() for x in s.split(",")) if t]
        if not vals:
            raise ValueError(f"no sizes in ladder spec {s!r}")
        return vals

    ot_level = int(os.environ.get("BENCH_OT_LEVEL", 4))
    if kind == "octree":
        if cpu_fallback:
            rungs = os.environ.get("BENCH_CPU_OT_N", "6")
        elif "BENCH_OT_N" in os.environ:     # explicit pin wins, like BENCH_NX
            rungs = os.environ["BENCH_OT_N"]
        else:
            # flagship 22^3 base at level 4 ~= 5.7M dofs
            rungs = os.environ.get("BENCH_OT_LADDER", "22,18,12")
        return [(0, 0, 0, n, ot_level) for n in ints(rungs)]
    if cpu_fallback:
        n = int(os.environ.get("BENCH_CPU_NX", 48))
        return [(n, n, n, 0, 0)]
    if any(k in os.environ for k in ("BENCH_NX", "BENCH_NY", "BENCH_NZ")):
        n = int(os.environ.get("BENCH_NX", 150))
        return [(n, int(os.environ.get("BENCH_NY", n)),
                 int(os.environ.get("BENCH_NZ", n)), 0, 0)]
    return [(n, n, n, 0, 0)
            for n in ints(os.environ.get("BENCH_LADDER", "150,128,96"))]


def _attach_flight():
    """Crash-durable flight recorder around the bench run
    (``obs/flight.py``): every Solver dispatch is bracketed by fsync'd
    begin/end records (the Solver shares ``_REC``) and each ladder rung
    gets its own bracket, so a run killed mid-solve leaves a parseable
    artifact naming what was in flight.  A leftover artifact of an
    earlier run is ingested first (its verdict logged) and rotated to
    ``.prev``.  Disable with BENCH_FLIGHT=0."""
    path = os.environ.get("BENCH_FLIGHT", "bench_flight.jsonl")
    if not path or path == "0":
        return None
    from pcg_mpi_solver_tpu_torch.obs.flight import (
        FlightRecorder, ingest_and_rotate)

    path = ingest_and_rotate(path, _log,
                             label="# previous bench flight record")
    try:
        _REC.flight = FlightRecorder(path, meta={
            "component": "bench",
            "model": os.environ.get("BENCH_MODEL", "cube"),
            "pcg_variant": os.environ.get("BENCH_PCG_VARIANT", "classic"),
            "precond": os.environ.get("BENCH_PRECOND", "jacobi"),
            "nrhs": os.environ.get("BENCH_NRHS", "1")})
    except (OSError, ValueError) as e:
        _log(f"# flight recorder unavailable ({e}); continuing without")
        _REC.flight = None
    return _REC.flight


def _error_line(why):
    """The zero-value line of a failed run: clearly labeled, parseable,
    and impossible to mistake for a measurement."""
    return json.dumps({
        "schema": BENCH_SCHEMA,
        "metric": "pcg_dof_iterations_per_second",
        "value": 0.0,
        "unit": "dof*iter/s",
        "vs_baseline": 0.0,
        "detail": {"error": why,
                   "note": "the bench failed; this is a sentinel, not a "
                           "measurement"},
    })


def _require_device(force_cpu):
    """The device of the run: "cpu" when asked for, else the card, which
    must be there."""
    if force_cpu:
        return "cpu"
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; the bench "
                           "measures the card (BENCH_FORCE_CPU=1 asks "
                           "for the CPU)")
    return "cuda"


def main():
    if os.environ.get("BENCH_SETUP_LADDER"):
        # the weak-scaling setup ladder (its own lines and artifact)
        from pcg_mpi_solver_tpu_torch.setup_ladder import main as ladder_main

        sys.exit(ladder_main(["--device", "cpu"]
                             if os.environ.get("BENCH_FORCE_CPU") == "1"
                             else []))
    try:
        device = _require_device(os.environ.get("BENCH_FORCE_CPU") == "1")
        if os.environ.get("BENCH_SERVE"):
            # sustained solve-service throughput (serve/bench.py)
            from pcg_mpi_solver_tpu_torch.serve.bench import main as serve_main

            sys.exit(serve_main(device=device))
        _attach_flight()
        line = _run_bench(device)
    except Exception as e:                              # noqa: BLE001
        _log(f"# bench failed ({type(e).__name__}: {e})")
        print(_error_line(f"{type(e).__name__}: {e}"), flush=True)
        sys.exit(1)
    finally:
        fl = getattr(_REC, "flight", None)
        if fl is not None:
            fl.close()
            _REC.flight = None
    print(line, flush=True)


def _run_bench(device):
    """The bench body on ``device`` ("cuda" or "cpu"): the ladder's first
    rung that builds, solves and converges (the last rung's failure
    raises), then the live baseline.  Returns the line."""
    os.environ.setdefault("PCG_TPU_VERBOSE", "1")
    kind = os.environ.get("BENCH_MODEL", "cube")   # cube | octree
    tol = float(os.environ.get("BENCH_TOL", 1e-7))
    mode = os.environ.get("BENCH_MODE", "mixed")   # mixed | direct
    backend = os.environ.get("BENCH_BACKEND", "auto")
    dtype = os.environ.get("BENCH_DTYPE", "float32")
    n_parts = int(os.environ.get("BENCH_PARTS", 1))
    platform = "cpu" if device == "cpu" else "gpu"

    ladder = _ladder(kind, cpu_fallback=device == "cpu")
    # loop invariant: reaching the line below implies the LAST iteration
    # assigned all of these (every failure of the last rung raises)
    for rung_i, rung in enumerate(ladder):
        nx, ny, nz, ot_n, ot_level = rung
        last = rung_i == len(ladder) - 1
        failed = None
        # a flight bracket per rung: a killed run's artifact names the
        # size in flight, not just the dispatch
        fl = getattr(_REC, "flight", None)
        fl_seq = (fl.begin(f"rung:{rung_i}", nx=nx, ot_n=ot_n)
                  if fl is not None else None)
        try:
            (model, solver, r1, iters, t_part, pallas_on, setup_info,
             launches) = _solve_once(
                kind, nx, ny, nz, ot_n, ot_level, backend, n_parts, tol,
                mode, dtype, device)
            if fl is not None:
                fl.end(fl_seq, f"rung:{rung_i}", ok=True)
        except Exception as e:                      # noqa: BLE001
            if fl is not None:
                # stepping down is the ladder working by design: only
                # the last rung's failure fails the run
                fl.end(fl_seq, f"rung:{rung_i}", ok=False,
                       error=f"{type(e).__name__}: {e}",
                       expected=not last)
            if last:
                raise
            failed = f"{type(e).__name__}: {e}"
            model = solver = r1 = None
        # a non-converged timed solve is a failed rung too (a smaller
        # model that converges beats a flagship number at flag != 0)
        if failed is None and r1.flag != 0 and not last:
            failed = f"flag={r1.flag} after {iters} iters"
            model = solver = r1 = None
        if failed is None:
            break
        _log(f"# ladder rung {rung_i} failed ({failed}); stepping down")
        import gc

        gc.collect()                                # free device buffers
        if device == "cuda":
            import torch

            torch.cuda.empty_cache()

    extra = _run_config_extra(solver, dtype, mode, pallas_on, n_parts,
                              t_part, platform, setup=setup_info)
    extra["launches"] = {k: n for k, n in launches.items() if n}
    # the live baseline in a child process (numpy only, no card)
    with _REC.span("live_baseline", emit=True):
        live = _live_baseline(kind, model.n_dof, *rung)
    if live is None:
        raise RuntimeError("the live numpy baseline failed; no line is "
                           "printed without a measured baseline")
    ref_ns, ref_note = live
    _log(f"# numpy ref ({ref_note}): {ref_ns:.3f} ns/dof-iter")
    return _result_json(model, kind, r1, iters, ref_ns, ref_note,
                        dict(extra, baseline_source="measured-live"))


if __name__ == "__main__":
    main()

"""The port stands alone: importing every module of pcg_mpi_solver_tpu_torch
loads neither JAX nor any module of the JAX package, and chip_smoke.py
imports neither (checked by reading its source, without running it)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, pkgutil, sys
import pcg_mpi_solver_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "pcg_mpi_solver_tpu" or m.startswith("pcg_mpi_solver_tpu."))
print(len(names))
print(",".join(bad))
print(",".join(names))
"""

# the general backend's modules, the chunked path's and resilience
# subsystem's, and the hybrid backend's, which the walk above must reach
GENERAL_MODULES = ("pcg_mpi_solver_tpu_torch.models.octree",
                   "pcg_mpi_solver_tpu_torch.parallel.partition",
                   "pcg_mpi_solver_tpu_torch.ops.matvec")
CHUNKED_MODULES = tuple(f"pcg_mpi_solver_tpu_torch.{m}" for m in (
    "solver.chunked", "resilience.recovery", "resilience.faultinject",
    "resilience.engine", "utils.checkpoint", "obs.metrics",
    "validate.preflight", "ops.mg"))
# the hybrid level-grid backend
HYBRID_MODULES = ("pcg_mpi_solver_tpu_torch.parallel.hybrid",)
# the export path and the CLI
EXPORT_MODULES = tuple(f"pcg_mpi_solver_tpu_torch.{m}" for m in (
    "cli", "vtk.writer", "vtk.export", "utils.io", "utils.postproc",
    "models.mdf", "ops.stress", "ops.nonlocal_stress"))

# the time integrators
TIME_MODULES = tuple(f"pcg_mpi_solver_tpu_torch.solver.{m}" for m in (
    "backends", "dynamics", "newmark"))

# the native host library's binding and the partition cache
NATIVE_CACHE_MODULES = tuple(f"pcg_mpi_solver_tpu_torch.{m}" for m in (
    "native", "cache", "cache.keys", "cache.partition_cache"))

# the solve service and the live monitor
SERVE_MODULES = tuple(f"pcg_mpi_solver_tpu_torch.{m}" for m in (
    "serve", "serve.jobs", "serve.journal", "serve.packer",
    "serve.admission", "serve.daemon", "obs.watch"))

# multi-process sharding: the mesh, the collectives, the consensus, the
# shard cache, the dead-peer guard and group snapshots, the fleet report
# and the setup ladder
SHARD_MODULES = tuple(f"pcg_mpi_solver_tpu_torch.{m}" for m in (
    "parallel.mesh", "parallel.distributed", "parallel.consensus",
    "cache.shards", "resilience.distributed", "obs.fleet", "setup_ladder"))

# the contract lint
ANALYSIS_MODULES = tuple(f"pcg_mpi_solver_tpu_torch.analysis.{m}" for m in (
    "engine", "trip", "programs", "rules_trip", "rules_ast", "rules_config",
    "rules_artifacts", "collectives", "__main__"))

# importing the lint loads neither torch nor JAX: it is built before a
# rule decides to record
ANALYSIS_PROBE = r"""
import sys
import pcg_mpi_solver_tpu_torch.analysis
from pcg_mpi_solver_tpu_torch.analysis import (engine, rules_ast,
    rules_artifacts, rules_config, rules_trip, trip, programs, collectives)
from pcg_mpi_solver_tpu_torch.analysis.__main__ import build_parser
build_parser()
engine.list_rules()
print(",".join(sorted(m for m in sys.modules
                      if m.split(".")[0] in ("torch", "jax", "jaxlib",
                                             "pcg_mpi_solver_tpu"))))
"""

# what a spawned VTK export worker imports (vtk/export.py's pool): numpy
# only, so a worker never loads torch or initialises CUDA
WORKER_PROBE = r"""
import sys
import pcg_mpi_solver_tpu_torch.vtk.export
import pcg_mpi_solver_tpu_torch.utils.postproc
print(",".join(sorted(m for m in sys.modules
                      if m == "torch" or m.startswith("torch."))))
"""


def is_forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "pcg_mpi_solver_tpu")


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    lines = out.stdout.splitlines()
    n_modules, bad = int(lines[0]), lines[1]
    assert n_modules >= 12, out.stdout
    assert set(GENERAL_MODULES) <= set(lines[2].split(",")), lines[2]
    assert set(CHUNKED_MODULES) <= set(lines[2].split(",")), lines[2]
    assert set(HYBRID_MODULES) <= set(lines[2].split(",")), lines[2]
    assert set(EXPORT_MODULES) <= set(lines[2].split(",")), lines[2]
    assert set(TIME_MODULES) <= set(lines[2].split(",")), lines[2]
    assert set(NATIVE_CACHE_MODULES) <= set(lines[2].split(",")), lines[2]
    assert set(SERVE_MODULES) <= set(lines[2].split(",")), lines[2]
    assert set(SHARD_MODULES) <= set(lines[2].split(",")), lines[2]
    assert set(ANALYSIS_MODULES) <= set(lines[2].split(",")), lines[2]
    assert bad == "", f"importing the port loaded {bad}"


def test_analysis_imports_no_torch():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", ANALYSIS_PROBE], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "", out.stdout


def test_export_worker_imports_no_torch():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", WORKER_PROBE], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "", out.stdout


def test_chip_smoke_imports_no_jax():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    imported = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            imported.append(node.module)
    assert "pcg_mpi_solver_tpu_torch" in {m.split(".")[0] for m in imported}
    assert not [m for m in imported if is_forbidden(m)], imported
    assert "__import__" not in ast.dump(tree)

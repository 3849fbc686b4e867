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
    assert bad == "", f"importing the port loaded {bad}"


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

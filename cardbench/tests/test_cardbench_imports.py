"""What a run loads: no JAX and no JAX package anywhere, and nothing of the
port in the reference.  Each check runs in a fresh interpreter, and module
names are compared by their whole top-level name (the part before the
first dot), since the port's name begins with the JAX package's."""

import json
import subprocess
import sys

from cardbench.registry import REPO

FORBIDDEN = {"jax", "jaxlib", "pcg_mpi_solver_tpu"}


def _loaded_after(code: str) -> set:
    """Top-level names of every module loaded after ``code`` runs in a
    fresh interpreter at the repository's root."""
    prog = (f"import sys\nsys.path.insert(0, {str(REPO)!r})\n{code}\n"
            "import json\nprint(json.dumps(sorted({m.split('.', 1)[0] "
            "for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", prog], cwd=REPO,
                         capture_output=True, text=True, timeout=600,
                         check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_whole_run_loads_no_jax(tmp_path):
    code = (
        "from pathlib import Path\n"
        "from cardbench.tests.bench_copy import bench_copy\n"
        "import cardbench.harness as h, cardbench.control\n"
        f"root = bench_copy(Path({str(tmp_path)!r}), nx=4, octree=True)\n"
        "for cell in ('cube4.step', 'oct3.step'):\n"
        "    for tr in (False, True):\n"
        "        assert h.run(cell, 1, 0.1, tr, root=root,\n"
        "                     device='cpu')['correct']\n"
        "from cardbench.registry import Registry\n"
        "reg = Registry()\n"
        "for kind in ('end_to_end', 'per_layer'):\n"
        "    for m in reg.bench[kind]:\n"
        "        reg.reader(m['name'])\n"
        "assert not h.forbidden_modules()\n")
    loaded = _loaded_after(code)
    assert "pcg_mpi_solver_tpu_torch" in loaded      # the run drove the port
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    loaded = _loaded_after(
        "import cardbench.reference.judge, cardbench.reference.operator\n"
        "import cardbench.inputs, cardbench.inputs.loads\n"
        "from cardbench.inputs.cube import make_cube_model\n"
        "from cardbench.reference.operator import ElementOperator\n"
        "from cardbench.reference.judge import Judge\n"
        "m = make_cube_model(3)\n"
        "j = Judge(m, ElementOperator(m))\n"
        "assert j.relres(m.F * 0, m.F) == 1.0\n")
    assert "torch" in loaded
    assert not loaded & (FORBIDDEN | {"pcg_mpi_solver_tpu_torch"})


def test_forbidden_modules_compares_whole_top_level_names():
    from cardbench.harness import forbidden_modules

    assert forbidden_modules(["pcg_mpi_solver_tpu_torch.ops", "jaxtyping",
                              "numpy"]) == []
    assert forbidden_modules(["jax.numpy", "pcg_mpi_solver_tpu.solver",
                              "flax", "jaxlib"]) == [
        "flax", "jax.numpy", "jaxlib", "pcg_mpi_solver_tpu.solver"]

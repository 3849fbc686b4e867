"""Build and load the port's hand-written CUDA kernels.

Each source under ``pcg_mpi_solver_tpu_torch/csrc/`` is compiled by
``nvcc`` into a shared library with a plain C interface and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  Libraries are
built at first use, from the sources in the checkout only, into
``build/torch_kernels/`` at the repository root, keyed by a hash of the
source and the compiler flags: a changed source builds anew, an unchanged
one loads the existing library.

Nothing here runs when the module is imported; a machine without ``nvcc``
can import every module of the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

# Hopper only: the "a" target keeps wgmma/setmaxnreg available to later
# kernels; -Xptxas -v reports registers, shared memory and spills.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> source file under csrc/
KERNEL_SOURCES = {"structured_matvec": "structured_matvec.cu"}

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME (default
    /usr/local/cuda, the toolkit's standard install prefix)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "port's CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = CSRC / KERNEL_SOURCES[name]
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{key.hexdigest()[:16]}.so"


def build_kernels(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every named kernel (default: all) that is not built yet.
    Returns ``{name: {"seconds": wall, "log": compiler output}}`` for the
    kernels it compiled; raises if a compile failed."""
    names = list(KERNEL_SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        t0 = time.perf_counter()
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
             str(CSRC / KERNEL_SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
        # atomic publish: a concurrent build of the same source writes its
        # own tmp file and replaces with identical bytes
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0,
                        "log": proc.stdout}
    return report


def load_kernel(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed (once
    per process)."""
    lib = _LIBS.get(name)
    if lib is None:
        build_kernels([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib

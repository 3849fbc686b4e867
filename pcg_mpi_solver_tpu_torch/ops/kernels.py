"""Build and load the port's hand-written CUDA kernels.

Each source under ``pcg_mpi_solver_tpu_torch/csrc/`` is compiled by
``nvcc`` into a shared library with a plain C interface and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  Libraries are
built at first use, from the sources in the checkout only, into
``build/torch_kernels/`` at the repository root, keyed by a hash of the
source, the shared headers (``csrc/*.cuh``) and the compiler flags: a
changed source builds anew, an unchanged one loads the existing library.
The sources are compiled in parallel, one ``nvcc`` each.

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

# kernel name -> source file under csrc/; each is its own shared library
KERNEL_SOURCES = {"structured_matvec": "structured_matvec.cu",
                  "structured_matvec_v1": "structured_matvec_v1.cu",
                  "structured_matvec_v2": "structured_matvec_v2.cu",
                  "structured_matvec_v3": "structured_matvec_v3.cu",
                  "structured_matvec_v4": "structured_matvec_v4.cu",
                  "structured_matvec_v5": "structured_matvec_v5.cu",
                  "structured_matvec_v7": "structured_matvec_v7.cu",
                  "structured_matvec_v8": "structured_matvec_v8.cu",
                  "structured_matvec_v9": "structured_matvec_v9.cu"}

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
    key = hashlib.sha256((CSRC / KERNEL_SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{key.hexdigest()[:16]}.so"


def build_kernels(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every named kernel (default: all) that is not built yet, all
    at once.  Returns ``{name: {"seconds": wall, "log": compiler output}}``
    for the kernels it compiled; raises if a compile failed."""
    names = list(KERNEL_SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            proc = subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC / KERNEL_SOURCES[name])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            started[name] = (proc, tmp, out, time.perf_counter())
        report, failed = {}, []
        for name, (proc, tmp, out, t0) in started.items():
            log = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {name}:\n{log}")
                continue
            # atomic publish: a concurrent build of the same source writes
            # its own tmp file and replaces with identical bytes
            os.replace(tmp, out)
            report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    finally:
        for proc, _tmp, _out, _t0 in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("\n".join(failed))
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

"""The structured-slab block-stencil matvec: the CUDA kernels, their plain
version, the wrapper that picks between them by the device of its input,
and the variant selector.

    y[p] = sum_b shift_b( sum_a Ke[3b:3b+3, 3a:3a+3] . (ck[p] * x[p]_a) )

on node grids x, y (P, 3, nx+1, ny+1, nz+1), cell scales ck (P, nx, ny, nz)
and the (24, 24) unit element stiffness Ke — ``StructuredOps.matvec_local``
of the JAX package, one slab per part.

- :func:`structured_matvec` is the wrapper every structured matvec of the
  port calls.  On a CUDA tensor it launches a hand-written kernel, one
  launch over the leading part axis (the JAX package's per-part dispatch
  ``batched_structured_matvec``), and raises if the launch is refused.
  float32 goes to the kernel of the named variant, each replacing the
  TPU kernel of the same name in ``pcg_mpi_solver_tpu/ops/pallas_matvec.py``
  (:data:`VARIANTS`): v1 ``structured_matvec_pallas`` :214, v2
  ``structured_matvec_pallas_v2`` :324, v3 ``_v3`` :456, v4 ``_v4`` :774,
  v5 ``_v5`` :730, v6 ``_v6`` :940, v7 ``_v7`` :1094, v8 ``_v8`` :1227 and
  v9 ``_v9`` :1410 — every ``pallas_call`` of the JAX package has its
  CUDA kernel here.  float64 goes to the double instantiation of v6's
  kernel whatever the variant (the TPU kernels are float32 only, and the
  JAX package leaves float64 matvecs to XLA).  On a CPU tensor it runs the
  plain version.
- :func:`structured_matvec_plain` is the plain PyTorch version beside
  every kernel: all the variants compute this one function.  It is the gse
  form of ``pcg_mpi_solver_tpu/parallel/structured.py`` (:327-352,
  :428-453) in torch ops: eight slice-gathers, one (24, 24) einsum, a sum
  of eight zero-padded translates.  The CPU tests hold it against the JAX
  package and its Pallas kernels, and ``chip_smoke.py`` holds each kernel
  against it on the card.
- :func:`selected_variant` and :func:`pallas_planes` read the JAX
  package's knobs, ``PCG_TPU_PALLAS_V`` and ``PCG_TPU_PALLAS_PLANES``, with
  the same defaults and the same refusals, so a setting means the same in
  both packages.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch
import torch.nn.functional as F

from pcg_mpi_solver_tpu_torch.models.element import HEX_CORNERS
from pcg_mpi_solver_tpu_torch.ops.kernels import load_kernel

# (dx, dy, dz) offset of each hex corner, VTK order; element dof 3*a + comp
CORNERS = tuple(tuple(int(v) for v in c) for c in HEX_CORNERS)

# Variant -> (kernel library under csrc/, whether its launch takes
# pallas_planes()).  The TPU kernel each replaces, in pallas_matvec.py:
# v1 structured_matvec_pallas :214, v2 structured_matvec_pallas_v2 :324,
# v3 structured_matvec_pallas_v3 :456, v4 structured_matvec_pallas_v4 :774,
# v5 structured_matvec_pallas_v5 :730, v6 structured_matvec_pallas_v6 :940,
# v7 structured_matvec_pallas_v7 :1094, v8 structured_matvec_pallas_v8
# :1227, v9 structured_matvec_pallas_v9 :1410.
VARIANTS = {"v1": ("structured_matvec_v1", False),
            "v2": ("structured_matvec_v2", False),
            "v3": ("structured_matvec_v3", True),
            "v4": ("structured_matvec_v4", True),
            "v5": ("structured_matvec_v5", True),
            "v6": ("structured_matvec", False),
            "v7": ("structured_matvec_v7", True),
            "v8": ("structured_matvec_v8", True),
            "v9": ("structured_matvec_v9", True)}
F64_VARIANT = "v6"          # the one kernel with a double instantiation

# Launches per (variant, dtype): incremented where a kernel is launched and
# nowhere else, so a run can show which kernel its matvecs went through.
LAUNCHES = {**{(v, "float32"): 0 for v in VARIANTS},
            (F64_VARIANT, "float64"): 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

# The Ke each (library, device index, dtype) holds in its constant bank:
# the tensor itself (held, so its storage cannot be reused by another
# tensor) and its in-place version counter at staging time.  Each library
# has its own bank, so the key names the library.
_STAGED: dict = {}


def selected_variant() -> str:
    """The kernel variant ``PCG_TPU_PALLAS_V`` selects (default ``"6"``),
    as the JAX package's ``selected_variant`` (pallas_matvec.py:159-195)
    names it.  ``Solver`` reads it once, at construction: build a new
    Solver to switch.  A value the JAX package refuses raises ValueError."""
    v = os.environ.get("PCG_TPU_PALLAS_V", "6")
    if v not in tuple("123456789"):
        raise ValueError(
            f"PCG_TPU_PALLAS_V must be 1|2|3|4|5|6|7|8|9, got {v!r}")
    return f"v{v}"


def pallas_planes() -> int:
    """Resolved ``PCG_TPU_PALLAS_PLANES`` (default 8), the cell planes per
    chunk of the chunked variants, as the JAX package's ``pallas_planes``
    (pallas_matvec.py:141-156) reads it: not a multiple of 8 raises
    ValueError."""
    planes = int(os.environ.get("PCG_TPU_PALLAS_PLANES", "8"))
    if planes % 8 != 0:
        raise ValueError(
            f"PCG_TPU_PALLAS_PLANES must be a multiple of 8, "
            f"got {planes}")
    return planes


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def gather_cells(xg: torch.Tensor) -> torch.Tensor:
    """(P, 3, cx+1, cy+1, cz+1) -> (P, 24, cx, cy, cz) via 8 contiguous
    slices, in element-dof order 3*corner + comp."""
    cx, cy, cz = xg.shape[2] - 1, xg.shape[3] - 1, xg.shape[4] - 1
    return torch.cat([xg[:, :, dx:dx + cx, dy:dy + cy, dz:dz + cz]
                      for dx, dy, dz in CORNERS], dim=1)


def scatter_cells(v: torch.Tensor) -> torch.Tensor:
    """(P, 24, cx, cy, cz) -> (P, 3, cx+1, cy+1, cz+1): corner a's three
    channels land on the node grid as a zero-padded translate; the eight
    translates are summed in corner order."""
    y = None
    for a, (dx, dy, dz) in enumerate(CORNERS):
        t = F.pad(v[:, 3 * a:3 * a + 3],
                  (dz, 1 - dz, dy, 1 - dy, dx, 1 - dx))
        y = t if y is None else y + t
    return y


def structured_matvec_plain(xg: torch.Tensor, ck: torch.Tensor,
                            Ke: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of every variant's kernel (the JAX package's
    gse form)."""
    u = gather_cells(xg)
    v = torch.einsum("de,pexyz->pdxyz", Ke, ck[:, None] * u)
    return scatter_cells(v)


def _check(xg: torch.Tensor, ck: torch.Tensor, Ke: torch.Tensor) -> None:
    for name, t in (("xg", xg), ("ck", ck), ("Ke", Ke)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if xg.dim() != 5 or xg.shape[1] != 3 or min(xg.shape[2:]) < 2:
        raise ValueError(f"xg must be (P, 3, nx+1, ny+1, nz+1) with every "
                         f"cell count >= 1, got {tuple(xg.shape)}")
    P, _, nxn, nyn, nzn = xg.shape
    if tuple(ck.shape) != (P, nxn - 1, nyn - 1, nzn - 1):
        raise ValueError(f"ck must be {(P, nxn - 1, nyn - 1, nzn - 1)} for "
                         f"xg {tuple(xg.shape)}, got {tuple(ck.shape)}")
    if tuple(Ke.shape) != (24, 24):
        raise ValueError(f"Ke must be (24, 24), got {tuple(Ke.shape)}")
    if not (xg.dtype == ck.dtype == Ke.dtype) or xg.dtype not in _SUFFIX:
        raise TypeError(f"xg, ck and Ke must share one dtype, float32 or "
                        f"float64; got {xg.dtype}, {ck.dtype}, {Ke.dtype}")
    if not (xg.device == ck.device == Ke.device):
        raise ValueError(f"xg, ck and Ke must be on one device; got "
                         f"{xg.device}, {ck.device}, {Ke.device}")
    if not (xg.is_contiguous() and ck.is_contiguous()
            and Ke.is_contiguous()):
        raise ValueError("xg, ck and Ke must be contiguous")
    if xg.numel() >= 2**31:
        raise ValueError(f"xg has {xg.numel()} entries; the kernel indexes "
                         f"with 32-bit integers (< 2^31)")


def _library(variant: str) -> ctypes.CDLL:
    name, chunked = VARIANTS[variant]
    lib = load_kernel(name)
    err_fn = getattr(lib, f"{name}_error_string")
    if err_fn.restype is not ctypes.c_char_p:
        sfxs = ("f32", "f64") if variant == F64_VARIANT else ("f32",)
        for sfx in sfxs:
            stage = getattr(lib, f"{name}_stage_{sfx}")
            stage.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            stage.restype = ctypes.c_int
            fn = getattr(lib, f"{name}_{sfx}")
            # x, ck, y; P, nx, ny, nz[, planes], device; stream
            fn.argtypes = [ctypes.c_void_p] * 3 \
                + [ctypes.c_int] * (6 if chunked else 5) + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        err_fn.argtypes = [ctypes.c_int]
        err_fn.restype = ctypes.c_char_p
    return lib


def _raise_on(lib: ctypes.CDLL, name: str, err: int, what: str,
              xg: torch.Tensor):
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} {what} failed on {xg.device} for xg "
                           f"{tuple(xg.shape)} {xg.dtype}: CUDA error "
                           f"{err} ({msg})")


def structured_matvec(xg: torch.Tensor, ck: torch.Tensor, Ke: torch.Tensor,
                      variant: str = "v6",
                      planes: Optional[int] = None) -> torch.Tensor:
    """y = K_slab . x per part.  CUDA tensors launch the kernel of
    ``variant`` in float32, v6's double kernel in float64 (or raise); CPU
    tensors run :func:`structured_matvec_plain`.  ``planes`` is the chunk
    of the chunked variants (v3, v4, v5, v7, v8, v9); None reads
    :func:`pallas_planes`."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {sorted(VARIANTS)}, got "
                         f"{variant!r}")
    _check(xg, ck, Ke)
    if xg.device.type == "cpu":
        return structured_matvec_plain(xg, ck, Ke)
    if xg.device.type != "cuda":
        raise ValueError(f"structured_matvec runs on cuda or cpu tensors, "
                         f"got {xg.device}")
    if xg.dtype == torch.float64:
        variant = F64_VARIANT
    name, chunked = VARIANTS[variant]
    lib = _library(variant)
    sfx = _SUFFIX[xg.dtype]
    dev = xg.device.index
    stream = torch.cuda.current_stream(xg.device).cuda_stream
    key = (name, dev, xg.dtype)
    held = _STAGED.get(key)
    if held is None or held[0] is not Ke or held[1] != Ke._version:
        err = getattr(lib, f"{name}_stage_{sfx}")(Ke.data_ptr(), dev, stream)
        _raise_on(lib, name, err, "Ke staging", xg)
        _STAGED[key] = (Ke, Ke._version)
    y = torch.empty_like(xg)
    P, _, nxn, nyn, nzn = xg.shape
    extra = (pallas_planes() if planes is None else planes,) if chunked \
        else ()
    err = getattr(lib, f"{name}_{sfx}")(
        xg.data_ptr(), ck.data_ptr(), y.data_ptr(),
        P, nxn - 1, nyn - 1, nzn - 1, *extra, dev, stream)
    _raise_on(lib, name, err, "kernel launch", xg)
    LAUNCHES[(variant, str(xg.dtype).removeprefix("torch."))] += 1
    return y

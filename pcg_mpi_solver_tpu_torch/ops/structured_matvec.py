"""The structured-slab block-stencil matvec: CUDA kernel, plain version,
and the wrapper that picks between them by the device of its input.

    y[p] = sum_b shift_b( sum_a Ke[3b:3b+3, 3a:3a+3] . (ck[p] * x[p]_a) )

on node grids x, y (P, 3, nx+1, ny+1, nz+1), cell scales ck (P, nx, ny, nz)
and the (24, 24) unit element stiffness Ke — ``StructuredOps.matvec_local``
of the JAX package, one slab per part.

- :func:`structured_matvec` is the wrapper every structured matvec of the
  port calls.  On a CUDA tensor it launches the hand-written kernel in
  ``csrc/structured_matvec.cu`` (float or double), which replaces
  ``pcg_mpi_solver_tpu/ops/pallas_matvec.py::structured_matvec_pallas_v6``
  and its per-part dispatch ``batched_structured_matvec`` with one launch
  over the leading part axis; a refused launch raises.  On a CPU tensor it
  runs the plain version.
- :func:`structured_matvec_plain` is the gse form of
  ``pcg_mpi_solver_tpu/parallel/structured.py`` (:327-352, :428-453) in
  torch ops: eight slice-gathers, one (24, 24) einsum, a sum of eight
  zero-padded translates.  The CPU tests hold it against the JAX package,
  and ``chip_smoke.py`` holds the kernel against it on the card.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from pcg_mpi_solver_tpu_torch.models.element import HEX_CORNERS
from pcg_mpi_solver_tpu_torch.ops.kernels import load_kernel

# (dx, dy, dz) offset of each hex corner, VTK order; element dof 3*a + comp
CORNERS = tuple(tuple(int(v) for v in c) for c in HEX_CORNERS)

# Launches of the CUDA kernel per dtype: incremented where the kernel is
# launched and nowhere else, so a run can show its matvecs went through it.
LAUNCHES = {"float32": 0, "float64": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

# The Ke each (device index, dtype) holds in its constant bank: the tensor
# itself (held, so its storage cannot be reused by another tensor) and its
# in-place version counter at staging time.
_STAGED: dict = {}


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
    """Plain PyTorch version of the kernel (the JAX package's gse form)."""
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


def _library() -> ctypes.CDLL:
    lib = load_kernel("structured_matvec")
    if lib.structured_matvec_error_string.restype is not ctypes.c_char_p:
        for sfx in _SUFFIX.values():
            stage = getattr(lib, f"structured_matvec_stage_{sfx}")
            stage.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            stage.restype = ctypes.c_int
            fn = getattr(lib, f"structured_matvec_{sfx}")
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.structured_matvec_error_string.argtypes = [ctypes.c_int]
        lib.structured_matvec_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib: ctypes.CDLL, err: int, what: str, xg: torch.Tensor):
    if err != 0:
        msg = lib.structured_matvec_error_string(err).decode()
        raise RuntimeError(f"structured_matvec {what} failed on {xg.device} "
                           f"for xg {tuple(xg.shape)} {xg.dtype}: CUDA "
                           f"error {err} ({msg})")


def structured_matvec(xg: torch.Tensor, ck: torch.Tensor,
                      Ke: torch.Tensor) -> torch.Tensor:
    """y = K_slab . x per part.  CUDA tensors launch the kernel (or raise);
    CPU tensors run :func:`structured_matvec_plain`."""
    _check(xg, ck, Ke)
    if xg.device.type == "cpu":
        return structured_matvec_plain(xg, ck, Ke)
    if xg.device.type != "cuda":
        raise ValueError(f"structured_matvec runs on cuda or cpu tensors, "
                         f"got {xg.device}")
    lib = _library()
    sfx = _SUFFIX[xg.dtype]
    dev = xg.device.index
    stream = torch.cuda.current_stream(xg.device).cuda_stream
    key = (dev, xg.dtype)
    held = _STAGED.get(key)
    if held is None or held[0] is not Ke or held[1] != Ke._version:
        err = getattr(lib, f"structured_matvec_stage_{sfx}")(
            Ke.data_ptr(), dev, stream)
        _raise_on(lib, err, "Ke staging", xg)
        _STAGED[key] = (Ke, Ke._version)
    y = torch.empty_like(xg)
    P, _, nxn, nyn, nzn = xg.shape
    err = getattr(lib, f"structured_matvec_{sfx}")(
        xg.data_ptr(), ck.data_ptr(), y.data_ptr(),
        P, nxn - 1, nyn - 1, nzn - 1, dev, stream)
    _raise_on(lib, err, "kernel launch", xg)
    LAUNCHES[str(xg.dtype).removeprefix("torch.")] += 1
    return y

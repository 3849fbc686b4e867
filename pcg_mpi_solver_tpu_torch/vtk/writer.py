"""Minimal VTK XML UnstructuredGrid (.vtu) writer, raw-appended binary.

Fills the role of the reference's vendored pyevtk (src/data/evtk/, ~1480 LoC:
``unstructuredGridToVTK`` hl.py:587-653, ``VtkFile`` vtk.py:181-491) with a
fresh ~130-line implementation of exactly the subset the exporter needs:
points + connectivity/offsets/types + scalar/vector point and cell data,
binary appended encoding readable by ParaView.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np

# VTK cell type ids (subset; full table in VTK spec)
VTK_VERTEX = 1
VTK_LINE = 3
VTK_TRIANGLE = 5
VTK_POLYGON = 7
VTK_QUAD = 9
VTK_TETRA = 10
VTK_HEXAHEDRON = 12

_VTK_TYPE_NAMES = {
    np.dtype(np.float32): "Float32",
    np.dtype(np.float64): "Float64",
    np.dtype(np.int8): "Int8",
    np.dtype(np.uint8): "UInt8",
    np.dtype(np.int16): "Int16",
    np.dtype(np.int32): "Int32",
    np.dtype(np.int64): "Int64",
    np.dtype(np.uint64): "UInt64",
}

FieldValue = Union[np.ndarray, Sequence[np.ndarray]]


def _as_components(val: FieldValue):
    """Normalize a field to (ncomp, data2d) with data2d shape (n, ncomp)."""
    if isinstance(val, (tuple, list)):
        comps = [np.ascontiguousarray(v) for v in val]
        data = np.stack(comps, axis=1)
        return len(comps), data
    arr = np.ascontiguousarray(val)
    if arr.ndim == 1:
        return 1, arr[:, None]
    return arr.shape[1], arr


def write_vtu(
    path: str,
    points: np.ndarray,                      # (n_pts, 3) or (x, y, z) tuple
    connectivity: np.ndarray,                # flat node ids
    offsets: np.ndarray,                     # 1-based end offsets per cell
    cell_types: np.ndarray,                  # VTK type id per cell
    point_data: Optional[Dict[str, FieldValue]] = None,
    cell_data: Optional[Dict[str, FieldValue]] = None,
) -> str:
    if isinstance(points, (tuple, list)):
        points = np.stack([np.asarray(p) for p in points], axis=1)
    points = np.ascontiguousarray(points, dtype=np.float64)
    n_pts = len(points)
    n_cells = len(cell_types)

    conn = np.ascontiguousarray(connectivity, dtype=np.int64)
    offs = np.ascontiguousarray(offsets, dtype=np.int64)
    ctys = np.ascontiguousarray(cell_types, dtype=np.uint8)

    blocks = []   # (xml descriptor, raw bytes)
    offset = 0
    xml_arrays = {}

    def add_array(section, name, arr, ncomp):
        nonlocal offset
        raw = arr.tobytes()
        dtype_name = _VTK_TYPE_NAMES[arr.dtype]
        xml_arrays.setdefault(section, []).append(
            f'<DataArray type="{dtype_name}" Name="{name}" '
            f'NumberOfComponents="{ncomp}" format="appended" offset="{offset}"/>'
        )
        blocks.append(raw)
        offset += 8 + len(raw)  # 8-byte UInt64 size header per block

    add_array("points", "Points", points, 3)
    add_array("cells", "connectivity", conn, 1)
    add_array("cells", "offsets", offs, 1)
    add_array("cells", "types", ctys, 1)
    for section, fields in (("pdata", point_data or {}), ("cdata", cell_data or {})):
        n_expected = n_pts if section == "pdata" else n_cells
        for name, val in fields.items():
            ncomp, data = _as_components(val)
            if len(data) != n_expected:
                raise ValueError(
                    f"field {name!r}: {len(data)} values for {n_expected} "
                    f"{'points' if section == 'pdata' else 'cells'}")
            add_array(section, name, np.ascontiguousarray(data), ncomp)

    if not path.endswith(".vtu"):
        path += ".vtu"
    with open(path, "wb") as f:
        f.write(b'<?xml version="1.0"?>\n')
        f.write(
            b'<VTKFile type="UnstructuredGrid" version="1.0" '
            b'byte_order="LittleEndian" header_type="UInt64">\n'
        )
        f.write(b"<UnstructuredGrid>\n")
        f.write(f'<Piece NumberOfPoints="{n_pts}" NumberOfCells="{n_cells}">\n'.encode())
        f.write(b"<Points>\n")
        f.write((xml_arrays["points"][0] + "\n").encode())
        f.write(b"</Points>\n<Cells>\n")
        for x in xml_arrays["cells"]:
            f.write((x + "\n").encode())
        f.write(b"</Cells>\n")
        if xml_arrays.get("pdata"):
            f.write(b"<PointData>\n")
            for x in xml_arrays["pdata"]:
                f.write((x + "\n").encode())
            f.write(b"</PointData>\n")
        if xml_arrays.get("cdata"):
            f.write(b"<CellData>\n")
            for x in xml_arrays["cdata"]:
                f.write((x + "\n").encode())
            f.write(b"</CellData>\n")
        f.write(b"</Piece>\n</UnstructuredGrid>\n")
        f.write(b'<AppendedData encoding="raw">\n_')
        for raw in blocks:
            f.write(np.uint64(len(raw)).tobytes())
            f.write(raw)
        f.write(b"\n</AppendedData>\n</VTKFile>\n")
    return path


def read_vtu_arrays(path: str) -> dict:
    """Parse a .vtu written by write_vtu back into arrays (for tests)."""
    import re

    with open(path, "rb") as f:
        content = f.read()
    header, _, appended = content.partition(b'<AppendedData encoding="raw">')
    appended = appended.split(b"_", 1)[1]
    inv_types = {v: k for k, v in _VTK_TYPE_NAMES.items()}
    out = {}
    for m in re.finditer(
        rb'<DataArray type="(\w+)" Name="(\w+)" NumberOfComponents="(\d+)" '
        rb'format="appended" offset="(\d+)"/>', header
    ):
        tname, name, ncomp, off = m.groups()
        dt = inv_types[tname.decode()]
        off = int(off)
        nbytes = int(np.frombuffer(appended[off:off + 8], np.uint64)[0])
        arr = np.frombuffer(appended[off + 8:off + 8 + nbytes], dt)
        ncomp = int(ncomp)
        if ncomp > 1:
            arr = arr.reshape(-1, ncomp)
        out[name.decode()] = arr
    return out

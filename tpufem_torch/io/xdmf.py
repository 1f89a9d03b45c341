"""XDMF writer and reader (XML + heavy data), ParaView-compatible; pure
NumPy, a copy of ``tpufem.io.xdmf``.

Equivalent of dolfinx's XDMFFile HDF5 output (FEniCSx/mechanic2d/
asym_elasto_damage_model.cc:946-981). Heavy data goes to one HDF5 file
written without h5py (tpufem_torch.io.hdf5), or to raw ``.bin`` sidecar
files referenced as Binary items -- the XDMF spec's second heavy-data
format, also readable by ParaView.
"""

from __future__ import annotations

import functools as _functools
import os
from typing import Dict, Optional

import numpy as np

from tpufem_torch.mesh.mesh import CellType, Mesh

_XDMF_TOPO = {
    CellType.triangle: "Triangle",
    CellType.quad: "Quadrilateral",
    CellType.tetra: "Tetrahedron",
    CellType.hexahedron: "Hexahedron",
}

# XDMF expects VTK-style hexahedron ordering; ours is tensor (x fastest)
_HEX_TO_VTK = [0, 1, 3, 2, 4, 5, 7, 6]
_QUAD_TO_VTK = [0, 1, 3, 2]


def write_xdmf(
    path: str,
    mesh: Mesh,
    point_data: Optional[Dict[str, np.ndarray]] = None,
    cell_data: Optional[Dict[str, np.ndarray]] = None,
    heavy: str = "hdf5",
) -> None:
    """``heavy``: "hdf5" (default — one ``<stem>.h5`` via the pure-NumPy
    writer in tpufem_torch.io.hdf5, the reference's XDMF/HDF5 pairing) or
    "binary" (one raw ``.bin`` sidecar per array)."""
    base = os.path.splitext(path)[0]
    stem = os.path.basename(base)
    cells = np.asarray(mesh.cells, dtype=np.int64)
    if mesh.cell_type == CellType.hexahedron:
        cells = cells[:, _HEX_TO_VTK]
    elif mesh.cell_type == CellType.quad:
        cells = cells[:, _QUAD_TO_VTK]
    pts = np.asarray(mesh.x, dtype=np.float64)
    gdim = pts.shape[1]
    geom_type = "XYZ" if gdim == 3 else "XY"
    if heavy not in ("hdf5", "binary"):
        raise ValueError(f"heavy={heavy!r}: 'hdf5' or 'binary'")
    h5_data: Dict[str, np.ndarray] = {}

    def binref(dsname, arr, dtype, prec):
        # dsname is the storage key (dataset path / sidecar file stem);
        # readers follow it from the XML, so it need not equal the
        # Attribute name — point/cell fields are namespaced below so a
        # field sharing a name across centers (or named 'geometry'/
        # 'topology') cannot silently collide (ADVICE r4)
        if dsname in h5_data:
            raise ValueError(f"duplicate heavy-data name {dsname!r}")
        dims = " ".join(map(str, arr.shape))
        num = "Float" if "float" in str(dtype) else "Int"
        if heavy == "hdf5":
            h5_data[dsname] = np.ascontiguousarray(arr, dtype=dtype)
            return (
                f'<DataItem Dimensions="{dims}" NumberType="{num}" '
                f'Precision="{prec}" Format="HDF">'
                f"{stem}.h5:/{dsname}</DataItem>"
            )
        h5_data[dsname] = None  # duplicate tracking for the binary path
        fn = f"{stem}_{dsname}.bin"
        np.ascontiguousarray(arr, dtype=dtype).tofile(
            os.path.join(os.path.dirname(path) or ".", fn)
        )
        return (
            f'<DataItem Dimensions="{dims}" NumberType="{num}" '
            f'Precision="{prec}" Format="Binary">{fn}</DataItem>'
        )

    attrs = []
    for name, arr in (point_data or {}).items():
        arr = np.asarray(arr)
        atype = "Vector" if arr.ndim == 2 and arr.shape[1] > 1 else "Scalar"
        if arr.ndim == 2 and arr.shape[1] == 2:  # pad 2D vectors for tools
            arr = np.concatenate([arr, np.zeros((len(arr), 1))], axis=1)
        attrs.append(
            f'<Attribute Name="{name}" AttributeType="{atype}" Center="Node">'
            + binref(f"point_{name}", arr, np.float64, 8)
            + "</Attribute>"
        )
    for name, arr in (cell_data or {}).items():
        arr = np.asarray(arr)
        atype = "Vector" if arr.ndim == 2 and arr.shape[1] > 1 else "Scalar"
        attrs.append(
            f'<Attribute Name="{name}" AttributeType="{atype}" Center="Cell">'
            + binref(f"cell_{name}", arr, np.float64, 8)
            + "</Attribute>"
        )

    xml = f"""<?xml version="1.0"?>
<!DOCTYPE Xdmf SYSTEM "Xdmf.dtd" []>
<Xdmf Version="3.0">
<Domain>
<Grid Name="mesh" GridType="Uniform">
<Topology TopologyType="{_XDMF_TOPO[mesh.cell_type]}" NumberOfElements="{len(cells)}">
{binref("topology", cells, np.int64, 8)}
</Topology>
<Geometry GeometryType="{geom_type}">
{binref("geometry", pts, np.float64, 8)}
</Geometry>
{''.join(attrs)}
</Grid>
</Domain>
</Xdmf>
"""
    if heavy == "hdf5":
        from tpufem_torch.io.hdf5 import write_hdf5

        write_hdf5(
            os.path.join(os.path.dirname(path) or ".", f"{stem}.h5"),
            h5_data,
        )
    with open(path, "w") as fh:
        fh.write(xml)


# -- reading -------------------------------------------------------------------

_TOPO_TO_CELL = {v.lower(): k for k, v in _XDMF_TOPO.items()}
_VTK_TO_HEX = np.argsort(_HEX_TO_VTK)
_VTK_TO_QUAD = np.argsort(_QUAD_TO_VTK)


@_functools.lru_cache(maxsize=4)
def _load_h5(path: str, _mtime: float):
    from tpufem_torch.io.hdf5 import read_hdf5

    return read_hdf5(path)


def _read_h5_cached(path: str):
    """One parse per (path, mtime): several DataItems share the .h5."""
    return _load_h5(os.path.abspath(path), os.path.getmtime(path))


def _read_dataitem(item, base_dir: str) -> np.ndarray:
    """Load one <DataItem> — Binary sidecar or inline XML text.

    The read half of the mesh-ingest contract (the reference reads its
    meshes back through XDMFFile::read_mesh, FEniCSx/mechanic2d/
    asym_elasto_damage_model.cc:152-164; ours round-trips the
    XDMF+binary files write_xdmf produces)."""
    dims = tuple(int(d) for d in item.get("Dimensions", "").split())
    num = item.get("NumberType", "Float").lower()
    prec = int(item.get("Precision", "8"))
    if num.startswith("int"):
        dtype = {4: np.int32, 8: np.int64}[prec]
    else:
        dtype = {4: np.float32, 8: np.float64}[prec]
    fmt = item.get("Format", "XML").lower()
    if fmt == "binary":
        fn = (item.text or "").strip()
        arr = np.fromfile(os.path.join(base_dir, fn), dtype=dtype)
    elif fmt in ("hdf", "hdf5"):
        ref = (item.text or "").strip()
        fn, _, dset = ref.partition(":")
        arr = _read_h5_cached(os.path.join(base_dir, fn))[
            dset.lstrip("/")
        ].astype(dtype)
    elif fmt == "xml":
        arr = np.array((item.text or "").split(), dtype=dtype)
    else:
        raise NotImplementedError(f"XDMF heavy-data format {fmt!r}")
    return arr.reshape(dims) if dims else arr


def read_xdmf(path: str):
    """Read an XDMF file (XML + Binary sidecars) back into
    (Mesh, point_data, cell_data).

    Inverse of :func:`write_xdmf` (VTK node-order permutations undone);
    also reads third-party XDMF with inline-XML data items.
    """
    import xml.etree.ElementTree as ET

    base_dir = os.path.dirname(os.path.abspath(path))
    root = ET.parse(path).getroot()
    grid = root.find(".//Grid")
    topo = grid.find("Topology")
    geom = grid.find("Geometry")
    ttype = topo.get("TopologyType").lower()
    if ttype not in _TOPO_TO_CELL:
        raise NotImplementedError(f"XDMF topology {ttype!r}")
    cell_type = _TOPO_TO_CELL[ttype]
    cells = _read_dataitem(topo.find("DataItem"), base_dir)
    n_el = int(topo.get("NumberOfElements", len(cells)))
    cells = np.asarray(cells, dtype=np.int64).reshape(n_el, -1)
    if cell_type == CellType.hexahedron:
        cells = cells[:, _VTK_TO_HEX]
    elif cell_type == CellType.quad:
        cells = cells[:, _VTK_TO_QUAD]
    pts = _read_dataitem(geom.find("DataItem"), base_dir)
    gtype = geom.get("GeometryType", "XYZ").upper()
    ncomp = 2 if gtype == "XY" else 3
    pts = np.asarray(pts, dtype=np.float64).reshape(-1, ncomp)

    point_data, cell_data = {}, {}
    for attr in grid.findall("Attribute"):
        arr = _read_dataitem(attr.find("DataItem"), base_dir)
        name = attr.get("Name")
        if attr.get("Center", "Node").lower() == "node":
            point_data[name] = arr
        else:
            cell_data[name] = arr
    mesh = Mesh(x=pts, cells=cells.astype(np.int32), cell_type=cell_type)
    return mesh, point_data, cell_data

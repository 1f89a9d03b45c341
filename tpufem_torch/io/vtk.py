"""VTU (VTK XML unstructured grid) writer (ASCII).

Equivalent of the reference's VTK output path (USE_VTK_FOR_OUTPUT,
FEniCSx/mechanic2d/asym_elasto_damage_model.cc:983-1001). Writes point
fields (P1) and cell fields (DG0).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from tpufem_torch.mesh.mesh import CellType, Mesh

_VTK_CELL_TYPES = {
    CellType.interval: 3,
    CellType.triangle: 5,
    CellType.quad: 8,  # pixel ordering (x fastest) matches our tensor order
    CellType.tetra: 10,
    CellType.hexahedron: 11,  # voxel ordering matches tensor order
}


def write_vtu(
    path: str,
    mesh: Mesh,
    point_data: Optional[Dict[str, np.ndarray]] = None,
    cell_data: Optional[Dict[str, np.ndarray]] = None,
) -> None:
    pts = np.asarray(mesh.x, dtype=np.float64)
    if pts.shape[1] < 3:
        pts = np.concatenate(
            [pts, np.zeros((len(pts), 3 - pts.shape[1]))], axis=1
        )
    cells = np.asarray(mesh.cells)
    n_pts, n_cells = len(pts), len(cells)
    vtk_type = _VTK_CELL_TYPES[mesh.cell_type]

    def data_array(name, arr, n_expected):
        arr = np.asarray(arr, dtype=np.float64)
        if arr.ndim == 1:
            arr = arr[:, None]
        assert arr.shape[0] == n_expected, (name, arr.shape, n_expected)
        ncomp = arr.shape[1]
        body = " ".join(f"{v:.17g}" for v in arr.ravel())
        return (
            f'<DataArray type="Float64" Name="{name}" '
            f'NumberOfComponents="{ncomp}" format="ascii">{body}</DataArray>'
        )

    conn = " ".join(map(str, cells.ravel()))
    offs = " ".join(map(str, (np.arange(1, n_cells + 1) * cells.shape[1])))
    types = " ".join([str(vtk_type)] * n_cells)

    pd = "".join(
        data_array(k, v, n_pts) for k, v in (point_data or {}).items()
    )
    cd = "".join(
        data_array(k, v, n_cells) for k, v in (cell_data or {}).items()
    )
    xml = f"""<?xml version="1.0"?>
<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">
<UnstructuredGrid>
<Piece NumberOfPoints="{n_pts}" NumberOfCells="{n_cells}">
<Points>{data_array("Points", pts, n_pts)}</Points>
<Cells>
<DataArray type="Int64" Name="connectivity" format="ascii">{conn}</DataArray>
<DataArray type="Int64" Name="offsets" format="ascii">{offs}</DataArray>
<DataArray type="UInt8" Name="types" format="ascii">{types}</DataArray>
</Cells>
<PointData>{pd}</PointData>
<CellData>{cd}</CellData>
</Piece>
</UnstructuredGrid>
</VTKFile>
"""
    with open(path, "w") as fh:
        fh.write(xml)

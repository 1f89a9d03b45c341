"""The port's output and comparison modules against tpufem (pure NumPy on
both sides): the VTU, XDMF and HDF5 writers write byte-identical files for
the same arrays, the readers give the arrays back, and the IN_COMP
comparison harness (``cases/compare.py``) behaves as the reference's
(cases copied from tests/test_compare.py)."""

import filecmp
import os

import numpy as np
import pytest

import tpufem.cases.compare as j_compare
import tpufem.io.hdf5 as j_hdf5
import tpufem.io.vtk as j_vtk
import tpufem.io.xdmf as j_xdmf
import tpufem.mesh as j_mesh
import tpufem_torch.cases.compare as t_compare
import tpufem_torch.mesh as t_mesh
from tpufem_torch.io import (read_hdf5, read_xdmf, write_hdf5, write_vtu,
                             write_xdmf)
from test_torch_memory import release_memory  # noqa: F401 (autouse)


def _meshes(kind):
    if kind == "triangle":
        return t_mesh.unit_square(4), j_mesh.unit_square(4)
    return t_mesh.box(2, 3, 2), j_mesh.box(2, 3, 2)


def _fields(mesh, dtype):
    """Point and cell fields of ``dtype``: vectors, tensors and scalars."""
    rng = np.random.default_rng(7)
    gdim = mesh.x.shape[1]

    def arr(shape):
        if np.issubdtype(dtype, np.integer):
            return rng.integers(-50, 50, shape).astype(dtype)
        return rng.normal(size=shape).astype(dtype)

    point = {"u": arr((mesh.n_nodes, gdim)), "d": arr(mesh.n_nodes)}
    cell = {"E": arr(mesh.n_cells), "strain": arr((mesh.n_cells, 3)),
            "energy": arr(mesh.n_cells)}
    return point, cell


def _same_files(a, b):
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for f in os.listdir(a):
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f),
                           shallow=False), f


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int64])
@pytest.mark.parametrize("kind", ["triangle", "hexahedron"])
def test_writers_are_byte_identical(tmp_path, kind, dtype):
    tm, jm = _meshes(kind)
    point, cell = _fields(tm, dtype)
    for sub in ("t", "j"):
        (tmp_path / sub).mkdir()
    write_vtu(str(tmp_path / "t/out.vtu"), tm, point_data=point,
              cell_data=cell)
    j_vtk.write_vtu(str(tmp_path / "j/out.vtu"), jm, point_data=point,
                    cell_data=cell)
    for heavy in ("hdf5", "binary"):
        write_xdmf(str(tmp_path / f"t/{heavy}.xdmf"), tm, point_data=point,
                   cell_data=cell, heavy=heavy)
        j_xdmf.write_xdmf(str(tmp_path / f"j/{heavy}.xdmf"), jm,
                          point_data=point, cell_data=cell, heavy=heavy)
    _same_files(tmp_path / "t", tmp_path / "j")
    assert len(os.listdir(tmp_path / "t")) == 4 + 2 + len(point) + len(cell)


@pytest.mark.parametrize("heavy", ["hdf5", "binary"])
@pytest.mark.parametrize("kind", ["triangle", "hexahedron"])
def test_xdmf_round_trip(tmp_path, kind, heavy):
    tm, _ = _meshes(kind)
    point, cell = _fields(tm, np.float64)
    p = str(tmp_path / "out.xdmf")
    write_xdmf(p, tm, point_data=point, cell_data=cell, heavy=heavy)
    mesh, pd, cd = read_xdmf(p)
    assert mesh.cell_type == tm.cell_type
    np.testing.assert_array_equal(mesh.x, tm.x)
    np.testing.assert_array_equal(mesh.cells, tm.cells)
    gdim = tm.x.shape[1]
    # 2D vectors are padded to 3 components for the viewers
    np.testing.assert_array_equal(pd["u"][:, :gdim], point["u"])
    np.testing.assert_array_equal(pd["d"], point["d"])
    for name, v in cell.items():
        np.testing.assert_array_equal(cd[name].reshape(v.shape), v)
    _, jpd, jcd = j_xdmf.read_xdmf(p)
    for name in pd:
        np.testing.assert_array_equal(pd[name], jpd[name])
    for name in cd:
        np.testing.assert_array_equal(cd[name], jcd[name])


def test_hdf5_many_dtypes_byte_identical_and_round_trip(tmp_path):
    rng = np.random.default_rng(1)
    ds = {
        "f64": rng.normal(size=(31, 3)),
        "f32": rng.normal(size=(7,)).astype(np.float32),
        "i64": rng.integers(-5, 99, (50, 4)).astype(np.int64),
        "i32": rng.integers(0, 9, (6,)).astype(np.int32),
        "u32": np.arange(11, dtype=np.uint32),
    }
    write_hdf5(str(tmp_path / "t.h5"), ds)
    j_hdf5.write_hdf5(str(tmp_path / "j.h5"), ds)
    assert filecmp.cmp(tmp_path / "t.h5", tmp_path / "j.h5", shallow=False)
    back = read_hdf5(str(tmp_path / "t.h5"))
    assert sorted(back) == sorted(ds)
    for k, v in ds.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape
        np.testing.assert_array_equal(back[k], v)


def test_match_by_coordinates_permuted():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(200, 2))
    perm = rng.permutation(200)
    idx = t_compare.match_by_coordinates(a, a[perm])
    np.testing.assert_array_equal(perm[idx], np.arange(200))
    np.testing.assert_array_equal(
        idx, j_compare.match_by_coordinates(a, a[perm]))


def test_match_raises_on_missing():
    a = np.array([[0.0, 0.0], [5.0, 5.0]])
    b = np.array([[0.0, 0.0], [1.0, 1.0]])
    with pytest.raises(ValueError):
        t_compare.match_by_coordinates(a, b)


def test_dump_load_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    coords = rng.normal(size=(50, 2))
    u = rng.normal(size=(50, 2))
    p = str(tmp_path / "disp.bin")
    t_compare.dump_displacements(p, coords, u)
    j_compare.dump_displacements(str(tmp_path / "j.bin"), coords, u)
    assert filecmp.cmp(p, tmp_path / "j.bin", shallow=False)
    c2, u2 = t_compare.load_displacements(p)
    np.testing.assert_array_equal(c2, coords)
    np.testing.assert_array_equal(u2, u)


def test_compare_fields_matches_reference():
    """The IN_COMP report on a permuted, perturbed copy: the same norms
    and energy error as the reference's harness."""
    rng = np.random.default_rng(3)
    coords = rng.random((80, 2))
    u = rng.normal(size=(80, 2))
    perm = rng.permutation(80)
    u_b = u[perm] + 1e-7 * rng.normal(size=(80, 2))
    ea, eb = rng.random(30), rng.random(30)
    t = t_compare.compare_fields(coords, u, coords[perm], u_b, ea, eb)
    j = j_compare.compare_fields(coords, u, coords[perm], u_b, ea, eb)
    np.testing.assert_array_equal(t.l2_per_component, j.l2_per_component)
    np.testing.assert_array_equal(t.linf_per_component, j.linf_per_component)
    assert t.energy_error == j.energy_error
    assert 0 < t.l2_per_component.max() < 1e-5

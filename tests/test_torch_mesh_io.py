"""The port's mesh ingest and refinement against tpufem (pure NumPy on
both sides, so every field must be exactly equal): ``read_gmsh`` /
``write_gmsh`` on the bundled square.msh, ``refine_uniform`` on all four
cell types with their tags, ``refine_marked``, and the port's own copy of
the bundled mesh."""

import copy
import filecmp

import numpy as np
import pytest

import tpufem.config as j_config
import tpufem.mesh as j_mesh
import tpufem_torch.config as t_config
import tpufem_torch.mesh as t_mesh
from tpufem.mesh.mesh import MeshTags as JMeshTags
from tpufem_torch.mesh.mesh import MeshTags as TMeshTags
from test_torch_memory import release_memory  # noqa: F401 (autouse)


def assert_same_mesh(t, j):
    """Every field of two meshes exactly equal, dtypes included."""
    assert t.cell_type == j.cell_type
    for name in ("x", "cells"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    if j.cell_tags is None:
        assert t.cell_tags is None
    else:
        assert t.cell_tags.dtype == j.cell_tags.dtype
        np.testing.assert_array_equal(t.cell_tags, j.cell_tags)
    assert sorted(t.entity_tags) == sorted(j.entity_tags)
    for dim, jt in j.entity_tags.items():
        tt = t.entity_tags[dim]
        assert tt.dim == jt.dim
        for name in ("entities", "values"):
            a, b = getattr(tt, name), getattr(jt, name)
            assert a.dtype == b.dtype, (dim, name)
            np.testing.assert_array_equal(a, b, err_msg=f"{dim} {name}")


@pytest.fixture(scope="module")
def squares():
    return (t_mesh.read_gmsh(t_config.data_path("square.msh")),
            j_mesh.read_gmsh(j_config.data_path("square.msh")))


def test_bundled_square_is_a_byte_identical_copy():
    assert filecmp.cmp(t_config.data_path("square.msh"),
                       j_config.data_path("square.msh"), shallow=False)


def test_read_gmsh_square_field_exact(squares):
    t, j = squares
    assert_same_mesh(t, j)
    assert t.n_nodes == 62 and 1 in t.entity_tags


@pytest.mark.parametrize("r", [0, 2])
def test_write_gmsh_round_trip(tmp_path, squares, r):
    """``write_gmsh`` -> ``read_gmsh`` gives the port's mesh back exactly
    (what ``polycrystal.run(gmsh_roundtrip=True)`` relies on), tagged
    points included. The reference's writer raises on those points and
    keeps 16 significant digits: its round trip (points dropped) equals
    the port's in every field but x, which it moves by up to an ulp."""
    t, j = squares
    for _ in range(r):
        t, j = t_mesh.refine_uniform(t), j_mesh.refine_uniform(j)
    t_mesh.write_gmsh(str(tmp_path / "t.msh"), t)
    back = t_mesh.read_gmsh(str(tmp_path / "t.msh"))
    assert_same_mesh(back, t)
    assert (0 in t.entity_tags) == (r == 0)  # refinement drops points
    if r == 0:
        with pytest.raises(KeyError):
            j_mesh.gmsh.write_gmsh(str(tmp_path / "j.msh"), j)
        j = copy.deepcopy(j)
        del j.entity_tags[0], back.entity_tags[0]
    j_mesh.gmsh.write_gmsh(str(tmp_path / "j.msh"), j)
    j_back = j_mesh.read_gmsh(str(tmp_path / "j.msh"))
    np.testing.assert_array_max_ulp(back.x, j_back.x, maxulp=1)
    back.x = j_back.x
    assert_same_mesh(back, j_back)


@pytest.mark.parametrize("r", [1, 2, 3])
def test_refine_uniform_triangles_with_tags(squares, r):
    t, j = squares
    for _ in range(r):
        t, j = t_mesh.refine_uniform(t), j_mesh.refine_uniform(j)
    assert_same_mesh(t, j)
    assert len(t.entity_tags[1].values) == 2 ** r * len(
        squares[0].entity_tags[1].values)


def _tagged(mod, tags_cls, mesh):
    """``mesh`` with cell tags and a few tagged edges (each package's own
    MeshTags), the same on both sides."""
    mesh.cell_tags = (np.arange(mesh.n_cells) % 5).astype(np.int32)
    edges, _ = mod.build_entities(mesh, 1)
    pick = np.arange(0, len(edges), 3)
    mesh.entity_tags[1] = tags_cls(
        dim=1, entities=np.sort(edges[pick], axis=1).astype(np.int32),
        values=(pick % 7 + 1).astype(np.int32))
    return mesh


@pytest.mark.parametrize("kind", ["quad", "tetra", "hexahedron"])
def test_refine_uniform_other_cells_with_tags(kind):
    def make(mod):
        if kind == "quad":
            return mod.unit_square(3, cell_type=mod.CellType.quad)
        return mod.box(2, 2, 1, cell_type=getattr(mod.CellType, kind))

    t = _tagged(t_mesh, TMeshTags, make(t_mesh))
    j = _tagged(j_mesh, JMeshTags, make(j_mesh))
    assert_same_mesh(t, j)
    for _ in range(2):
        t, j = t_mesh.refine_uniform(t), j_mesh.refine_uniform(j)
        assert_same_mesh(t, j)


def test_refine_marked_square(squares):
    t, j = squares
    marked = np.zeros(t.n_cells, dtype=bool)
    marked[np.arange(0, t.n_cells, 4)] = True
    rt = t_mesh.refine_marked(t, marked)
    rj = j_mesh.refine_marked(j, marked)
    assert_same_mesh(rt, rj)
    assert t.n_cells < rt.n_cells < 4 * t.n_cells
    assert_same_mesh(t_mesh.refine_marked(rt, np.flatnonzero(marked)),
                     j_mesh.refine_marked(rj, np.flatnonzero(marked)))

"""The constant-stencil matvec of 3D linear elasticity on a hex lattice
(K8): CUDA for Hopper, beside its plain PyTorch version.

For constant-coefficient isotropic linear elasticity on a uniform hex
lattice the stiffness operator is a 27-point stencil of constant 3x3
blocks; the only spatial variation is at the boundary, where fewer cells
are incident. Both are exact in one pass. The constants come from the
analytic float64 element matrix (:func:`_cell_matrix`, host NumPy as in
the reference), in two forms:

- boundary nodes (on a face of the lattice): K[delta][chi] (node pair
  offset delta, incident cell chi; :func:`_stencil_constants`) rounded to
  float32, a cell counting only where it lies in the lattice (a per-axis
  test), added in the reference's order: delta outer, chi, b, a inner;
- interior nodes (all eight incident cells present): the pre-summed
  blocks S[delta] = sum_chi K[delta][chi], summed in float64 and rounded
  once (:func:`_interior_stencil`), added delta outer, b, a inner. An
  off-diagonal entry (a != b) whose delta is 0 along axis a or axis b is
  zero by symmetry; it is set to exactly 0 and skipped (153 of the 243
  entries remain), after the host has checked that its float64 residue is
  rounding noise.

``y = K x`` with NO boundary-condition treatment: the caller applies the
free-mask sandwich (M K M + (I - M)), as ``make_grid_solver`` and
``mg3d.vcycle`` do. The matvec computes in float32 and returns ``x``'s
dtype, as the TPU kernel does.

For a CUDA tensor :func:`lattice_matvec3d` launches the kernel built from
``tpufem_torch/csrc/lattice_matvec3d.cu`` or raises, and adds one to its
``launches`` attribute exactly where it launches; for a CPU tensor -- and
only because the tensor lies on the CPU -- it runs
:func:`linear_matvec_plain`, which adds in the kernel's order in both
classes of nodes. The library is built without fused multiply-adds, so
the two are bit-equal. The launch geometry (interior tiles, z chunks,
face blocks) is computed here (:func:`matvec3d_geometry`) and checked by
the C entry point.
"""

from __future__ import annotations

import ctypes
from itertools import product

import numpy as np
import torch
import torch.nn.functional as tF

from tpufem_torch.lane import _build
from tpufem_torch.lane.kernels import _check, _raise_on, _stream
from tpufem_torch.structured.grid3d import _CORNERS, StructuredGrid3D

N_TERMS = 64  # (delta, chi) pairs with both nodes in the cell


def _cell_matrix(grid: StructuredGrid3D, E: float, nu: float) -> np.ndarray:
    """Ke (8, 3, 8, 3) of one uniform isotropic-elastic hex, computed
    analytically in NumPy float64: Ke = sum_q w_q B^T D B."""
    lam = E * nu / ((1 + nu) * (1 - 2 * nu))
    mu = E / (2 * (1 + nu))
    dN = np.asarray(grid._dN, dtype=np.float64)  # (q, 8, 3)
    w = np.asarray(grid._w, dtype=np.float64)
    Ke = np.zeros((8, 3, 8, 3))
    for q in range(len(w)):
        g = dN[q]  # (8, 3)
        for k in range(8):
            for l in range(8):
                gg = g[k] @ g[l]  # sum_j dN_kj dN_lj
                for a in range(3):
                    for b in range(3):
                        Ke[k, a, l, b] += w[q] * (
                            lam * g[k, a] * g[l, b]
                            + mu * ((a == b) * gg + g[k, b] * g[l, a])
                        )
    return Ke


def _cell_blocks(Ke: np.ndarray, delta):
    """[(chi, Ke block (3, 3) float64)] for node-pair offset delta in
    {-1,0,1}^3 and each incident-cell origin chi in {-1,0}^3 (relative to
    the node) that holds both nodes: corner a = -chi of the cell is our
    node, corner b = a + delta the neighbour."""
    out = []
    for chi in product((-1, 0), repeat=3):
        a = tuple(-c for c in chi)
        b = tuple(ai + di for ai, di in zip(a, delta))
        if all(v in (0, 1) for v in b):
            out.append((chi, Ke[_CORNERS.index(a), :, _CORNERS.index(b), :]))
    return out


def _stencil_constants(Ke: np.ndarray):
    """K[delta][chi] (3,3) float32 for every node-pair offset delta and
    incident cell chi (:func:`_cell_blocks`)."""
    return {delta: [(chi, K.astype(np.float32))
                    for chi, K in _cell_blocks(Ke, delta)]
            for delta in product((-1, 0, 1), repeat=3)}


# the interior stencil: node-pair offsets delta in {-1,0,1}^3 (z, y, x; z
# slowest), the order of its blocks in the kernel and the plain version
DELTAS = tuple(product((-1, 0, 1), repeat=3))
# relative bound on the float64 residue of an entry that is zero by symmetry
RESIDUE_RTOL = 1e-9


def _structural(delta, a: int, b: int) -> bool:
    """Is entry (a, b) of the interior block of offset ``delta`` not zero
    by symmetry? Component a moves along axis 2 - a of (z, y, x); an
    off-diagonal entry needs the offset to be nonzero along both axes."""
    return a == b or (delta[2 - a] != 0 and delta[2 - b] != 0)


# (delta index, b, a) of the 153 entries the interior sum adds, in order
INTERIOR_ENTRIES = tuple((d, b, a) for d, delta in enumerate(DELTAS)
                         for b in range(3) for a in range(3)
                         if _structural(delta, a, b))


def _interior_stencil(Ke: np.ndarray) -> np.ndarray:
    """S (27, 3, 3) float32: S[delta] = sum over the eight incident cells
    of K[delta][chi], summed in float64 and rounded once, with the entries
    that are zero by symmetry set to exactly 0. Raises NotImplementedError
    if such an entry's float64 residue exceeds RESIDUE_RTOL * max|Ke|
    (then the element matrix is not the symmetric one the pattern
    assumes)."""
    tol = RESIDUE_RTOL * float(np.abs(Ke).max())
    S = np.zeros((len(DELTAS), 3, 3))
    for d, delta in enumerate(DELTAS):
        for _chi, K in _cell_blocks(Ke, delta):
            S[d] += K
        for a in range(3):
            for b in range(3):
                if _structural(delta, a, b):
                    continue
                if abs(S[d, a, b]) > tol:
                    raise NotImplementedError(
                        f"K8: interior block {delta} entry ({a}, {b}) is "
                        f"{S[d, a, b]:.3e}, not zero by symmetry (bound "
                        f"{tol:.3e}); K8 serves the symmetric element "
                        "matrix of isotropic linear elasticity only")
                S[d, a, b] = 0.0
    return S.astype(np.float32)


class StencilConsts:
    """The lattice size and the constants of both classes of nodes: the 64
    (delta, chi, K) boundary terms in the order the kernel and the plain
    version add them, and the 27 interior blocks ``S`` (27, 3, 3)."""

    def __init__(self, nx, ny, nz, Ke: np.ndarray):
        self.nx, self.ny, self.nz = int(nx), int(ny), int(nz)
        self.terms = [(delta, chi, K) for delta, ts in
                      _stencil_constants(Ke).items() for chi, K in ts]
        self.S = _interior_stencil(Ke)
        vals = np.concatenate([K.ravel() for _d, _c, K in self.terms]
                              + [self.S.ravel()])
        self._packed = (ctypes.c_float * vals.size)(*vals.astype(np.float32))
        geo = matvec3d_geometry(self.nx, self.ny, self.nz)
        # the C entry point's geometry arguments
        self.launch = (geo["tiles_x"], geo["tiles_y"], geo["z_chunk"],
                       geo["n_face"])

    def packed(self):
        """64 x 9 then 27 x 9 float32: the boundary blocks in term order,
        then the interior blocks, each row-major ([a][b])."""
        return self._packed


# -- launch geometry (mirrors csrc/lattice_matvec3d.cu) ----------------------

TILE_X, TILE_Y = 32, 8  # interior nodes of a block in x and y
Z_CHUNK = 16  # interior planes a block marches through
FACE_THREADS = 256  # boundary nodes of a face block


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def matvec3d_geometry(nx: int, ny: int, nz: int) -> dict:
    """The launch of K8: interior blocks (tiles of TILE_Y x TILE_X nodes of
    the interior (ny-1) x (nx-1) plane, each marching through at most
    Z_CHUNK interior planes) then face blocks (FACE_THREADS boundary nodes
    each, in :func:`face_nodes` order)."""
    tiles_x, tiles_y = _cdiv(nx - 1, TILE_X), _cdiv(ny - 1, TILE_Y)
    z_chunks = _cdiv(nz - 1, Z_CHUNK)
    n_face = (2 * (ny + 1) * (nx + 1)
              + (nz - 1) * (2 * (nx + 1) + 2 * (ny - 1)))
    interior = tiles_x * tiles_y * z_chunks
    return dict(tiles_x=tiles_x, tiles_y=tiles_y, z_chunk=Z_CHUNK,
                z_chunks=z_chunks, interior_blocks=interior, n_face=n_face,
                face_blocks=_cdiv(n_face, FACE_THREADS),
                blocks=interior + _cdiv(n_face, FACE_THREADS))


def face_nodes(f, nx: int, ny: int, nz: int):
    """(iz, iy, ix) of boundary node number ``f`` (an int array): the
    faces z = 0 and z = nz whole, then per interior plane the rows y = 0
    and y = ny, then the columns x = 0 and x = nx between them."""
    f = np.asarray(f, np.int64)
    W, NP = nx + 1, (ny + 1) * (nx + 1)
    Q = 2 * W + 2 * (ny - 1)
    zf = f < 2 * NP
    g = np.where(zf, 0, f - 2 * NP)
    h = g % Q
    row = h < 2 * W
    h2 = h - 2 * W
    iz = np.where(zf, np.where(f < NP, 0, nz), 1 + g // Q)
    iy = np.where(zf, (f % NP) // W,
                  np.where(row, np.where(h < W, 0, ny), 1 + h2 // 2))
    ix = np.where(zf, (f % NP) % W,
                  np.where(row, h % W, np.where(h2 % 2 == 1, nx, 0)))
    return iz, iy, ix


def matvec3d_cover(nx: int, ny: int, nz: int) -> np.ndarray:
    """How many times the launch of :func:`matvec3d_geometry` writes each
    node (nz+1, ny+1, nx+1): the interior blocks' tiles and chunks, as the
    kernel maps them, then the face blocks' nodes."""
    geo = matvec3d_geometry(nx, ny, nz)

    def axis(tiles, width, n):  # nodes 1 + t * width + lane, up to n - 1
        c = np.zeros(n + 1, np.int64)
        i = 1 + np.arange(tiles * width)
        np.add.at(c, i[i <= n - 1], 1)
        return c

    cz = np.zeros(nz + 1, np.int64)
    for k in range(geo["z_chunks"]):
        z0 = 1 + k * geo["z_chunk"]
        cz[z0: min(z0 + geo["z_chunk"], nz)] += 1
    cover = (cz[:, None, None] * axis(geo["tiles_y"], TILE_Y, ny)[:, None]
             * axis(geo["tiles_x"], TILE_X, nx))
    f = np.arange(geo["face_blocks"] * FACE_THREADS)
    iz, iy, ix = face_nodes(f[f < geo["n_face"]], nx, ny, nz)
    np.add.at(cover, (iz, iy, ix), 1)
    return cover


# -- plain version ------------------------------------------------------------


def _interior_mask(shape, dev):
    """True at nodes 1 <= i <= n - 1 along every axis (all eight incident
    cells present)."""
    m = None
    for dim, size in enumerate(shape):
        i = torch.arange(size, device=dev)
        view = [1, 1, 1]
        view[dim] = size
        mi = ((i >= 1) & (i <= size - 2)).view(view)
        m = mi if m is None else m & mi
    return m


def _boundary_sum(x, p, consts: StencilConsts):
    """Every node in the boundary order: delta outer, chi, b, a inner,
    zero entries skipped, absent cells masked."""
    nx, ny, nz = consts.nx, consts.ny, consts.nz
    shape = x.shape[-3:]
    dev = x.device

    def axis_mask(n, size, chi_c, dim):
        c = torch.arange(size, device=dev) + chi_c
        m = ((c >= 0) & (c < n)).to(x.dtype)
        view = [1, 1, 1]
        view[dim] = size
        return m.view(view)

    mz = {c: axis_mask(nz, shape[0], c, 0) for c in (-1, 0)}
    my = {c: axis_mask(ny, shape[1], c, 1) for c in (-1, 0)}
    mx = {c: axis_mask(nx, shape[2], c, 2) for c in (-1, 0)}
    acc = [None, None, None]
    xb, cur = None, None
    for delta, chi, Kab in consts.terms:
        if delta != cur:
            cur = delta
            xb = _shifted(p, delta, shape)
        m = mz[chi[0]] * my[chi[1]]
        m = m * mx[chi[2]]
        for b in range(3):
            mxb = m * xb[b]
            for a in range(3):
                ka = float(Kab[a, b])
                if ka != 0.0:
                    t = ka * mxb
                    acc[a] = t if acc[a] is None else acc[a] + t
    return torch.stack(acc)


def _shifted(p, delta, shape):
    """x[b](n + delta) for every node n, from x padded by one node."""
    return [p[(b,) + tuple(slice(1 + o, 1 + o + n)
                           for o, n in zip(delta, shape))] for b in range(3)]


def _interior_sum(p, consts: StencilConsts, shape):
    """Every node in the interior order: delta outer, b, a inner, the 153
    entries of INTERIOR_ENTRIES (right only where all cells are present)."""
    acc = [None, None, None]
    xb, cur = None, None
    for d, b, a in INTERIOR_ENTRIES:
        if d != cur:
            cur = d
            xb = _shifted(p, DELTAS[d], shape)
        t = float(consts.S[d, a, b]) * xb[b]
        acc[a] = t if acc[a] is None else acc[a] + t
    return torch.stack(acc)


def linear_matvec_plain(x, consts: StencilConsts):
    """Plain version of :func:`lattice_matvec3d`: x (3, nz+1, ny+1, nx+1)
    float32 -> K x, float32; interior nodes in the interior order, the
    others in the boundary order."""
    shape = x.shape[-3:]
    p = tF.pad(x, (1, 1, 1, 1, 1, 1))
    return torch.where(_interior_mask(shape, x.device)[None],
                       _interior_sum(p, consts, shape),
                       _boundary_sum(x, p, consts))


def lattice_matvec3d(x, consts: StencilConsts):
    """K8: K x for x (3, nz+1, ny+1, nx+1) float32 on the card."""
    if x.device.type != "cuda":
        return linear_matvec_plain(x, consts)
    dev = x.device
    shp = (3, consts.nz + 1, consts.ny + 1, consts.nx + 1)
    _check("x", x, device=dev, dtypes=(torch.float32,), shape=shp)
    out = torch.empty_like(x)
    lib = _build.load()
    code = lib.lattice_matvec3d(x.data_ptr(), out.data_ptr(), consts.nx,
                                consts.ny, consts.nz, consts.packed(),
                                *consts.launch, _stream(dev))
    _raise_on(code, "lattice_matvec3d")
    lattice_matvec3d.launches += 1
    return out


def _prove_linear_law(grid: StructuredGrid3D, Ke: np.ndarray) -> None:
    """The stencil stands for ``grid``'s law only if that law is isotropic
    linear elasticity with these E and nu: its cell Hessian (float64, on
    the host) must equal the analytic Ke at zero and at a random state."""
    if grid.field_kinds:
        raise NotImplementedError(
            "make_linear_matvec: the grid's law has coefficient fields; K8 "
            "serves constant-coefficient isotropic linear elasticity only "
            "(ROADMAP.md Q1 item 6: other laws on the structured 3D path)")
    energy = grid._cell_energy_with_coeffs()
    rng = np.random.default_rng(0)
    ref = torch.as_tensor(Ke.reshape(24, 24))
    for u0 in (np.zeros((8, 3)), 1e-3 * rng.standard_normal((8, 3))):
        H = torch.autograd.functional.hessian(
            lambda w: energy(w, {}), torch.as_tensor(u0, dtype=torch.float64),
            vectorize=True).reshape(24, 24)
        if float((H - ref).abs().max()) > 1e-9 * float(ref.abs().max()):
            raise NotImplementedError(
                "make_linear_matvec: the grid's energy is not isotropic "
                "linear elasticity with the given E and nu; K8 serves that "
                "law only (ROADMAP.md Q1 item 6: other laws on the "
                "structured 3D path)")


def make_linear_matvec(grid: StructuredGrid3D, E: float = None,
                       nu: float = None):
    """Returns matvec(x (3, nz+1, ny+1, nx+1)) -> K x on K8 (float32
    inside, ``x``'s dtype out); it runs where ``x`` lies.

    Isotropic linear elasticity only: E and nu are required, and the
    grid's energy must be that law (checked on its cell Hessian)."""
    if E is None or nu is None:
        raise NotImplementedError(
            "make_linear_matvec requires explicit E and nu: K8 serves "
            "isotropic linear elasticity only (ROADMAP.md Q1 item 6: other "
            "laws on the structured 3D path)")
    Ke = _cell_matrix(grid, E, nu)
    _prove_linear_law(grid, Ke)
    consts = StencilConsts(grid.nx, grid.ny, grid.nz, Ke)

    def matvec(x):
        return lattice_matvec3d(x.to(torch.float32), consts).to(x.dtype)

    matvec.consts = consts
    return matvec


def _wrappers():
    return (lattice_matvec3d,)


def reset_launch_counts() -> None:
    for fn in _wrappers():
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _wrappers()}


reset_launch_counts()

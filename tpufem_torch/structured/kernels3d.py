"""The constant-stencil matvec of 3D linear elasticity on a hex lattice
(K8): CUDA for Hopper, beside its plain PyTorch version.

For constant-coefficient isotropic linear elasticity on a uniform hex
lattice the stiffness operator is a 27-point stencil of constant 3x3
blocks; the only spatial variation is at the boundary, where fewer cells
are incident. Both are exact in one pass: the constants K[delta][chi] (node
pair offset delta, incident cell chi) come from the analytic float64
element matrix (:func:`_cell_matrix`, :func:`_stencil_constants`, host
NumPy as in the reference) rounded to float32, and the incidence is a
per-axis test of the cell's coordinates.

``y = K x`` with NO boundary-condition treatment: the caller applies the
free-mask sandwich (M K M + (I - M)), as ``make_grid_solver`` and
``mg3d.vcycle`` do. The matvec computes in float32 and returns ``x``'s
dtype, as the TPU kernel does.

For a CUDA tensor :func:`lattice_matvec3d` launches the kernel built from
``tpufem_torch/csrc/lattice_matvec3d.cu`` or raises, and adds one to its
``launches`` attribute exactly where it launches; for a CPU tensor -- and
only because the tensor lies on the CPU -- it runs
:func:`linear_matvec_plain`, which adds in the kernel's (and the
reference's) order: delta outer, chi, b, a inner, zero entries skipped.
The library is built without fused multiply-adds, so the two are
bit-equal.
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


def _stencil_constants(Ke: np.ndarray):
    """K[delta][chi] (3,3) float32 for node-pair offset delta in {-1,0,1}^3
    and incident-cell origin chi in {-1,0}^3 (relative to the node):
    corner a = -chi of the cell is our node, corner b = a + delta the
    neighbour."""
    cidx = {c: k for k, c in enumerate(_CORNERS)}
    out = {}
    for delta in product((-1, 0, 1), repeat=3):
        terms = []
        for chi in product((-1, 0), repeat=3):
            a = tuple(-c for c in chi)
            b = tuple(ai + di for ai, di in zip(a, delta))
            if all(v in (0, 1) for v in b):
                terms.append(
                    (chi, Ke[cidx[a], :, cidx[b], :].astype(np.float32))
                )
        out[delta] = terms
    return out


class StencilConsts:
    """The lattice size and the 64 (delta, chi, K) terms, in the order the
    kernel and the plain version add them."""

    def __init__(self, nx, ny, nz, stencil):
        self.nx, self.ny, self.nz = int(nx), int(ny), int(nz)
        self.terms = [(delta, chi, K) for delta, ts in stencil.items()
                      for chi, K in ts]
        vals = np.concatenate([K.ravel() for _d, _c, K in self.terms])
        self._packed = (ctypes.c_float * vals.size)(*vals.astype(np.float32))

    def packed(self):
        """64 x 9 float32: the blocks row-major ([a][b]) in term order."""
        return self._packed


def linear_matvec_plain(x, consts: StencilConsts):
    """Plain version of :func:`lattice_matvec3d`: x (3, nz+1, ny+1, nx+1)
    float32 -> K x, float32."""
    nx, ny, nz = consts.nx, consts.ny, consts.nz
    shape = x.shape[-3:]
    p = tF.pad(x, (1, 1, 1, 1, 1, 1))
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
            xb = [p[(b,) + tuple(slice(1 + o, 1 + o + n)
                                 for o, n in zip(delta, shape))]
                  for b in range(3)]
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
                                _stream(dev))
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
    consts = StencilConsts(grid.nx, grid.ny, grid.nz, _stencil_constants(Ke))

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

"""Fused lattice kernels of the 2D structured asym-damage model: CUDA for
Hopper, each beside its plain PyTorch version.

- K6 :func:`lattice_residual` (built by :func:`make_residual_kernel`):
  r = F(u) -- per triangle the strain from the three vertices, the
  asymmetric elasto-damage stress, B^T sigma added to the vertices; one
  read of u and d, one write of r;
- K7 :func:`lattice_tangent` (built by :func:`make_tangent_kernel`):
  J(u) . v -- the same pass with the hand-derived directional derivative
  of the stress: the CG operator of the structured Newton-Krylov solve.

The lattice is ``StructuredGrid2D``'s: nodes (ny+1, nx+1), x fastest, each
cell split into a lower (v00, v10, v11) and an upper (v00, v11, v01)
triangle; the damage of a triangle is the mean of its vertex values; the
modulus is one scalar E. Float32 on the card, as the TPU kernels.

For a CUDA tensor a wrapper launches the kernel built from
``tpufem_torch/csrc/lattice_{residual,tangent}.cu`` (on PyTorch's current
stream) or raises, and adds one to its ``launches`` attribute exactly where
it launches; for a CPU tensor -- and only because the tensor lies on the
CPU -- it runs the plain version (:func:`residual_plain`,
:func:`tangent_plain`), which is also what the kernels are held against on
the card. The plain versions spell the kernels' operations in the kernels'
order (the order of ``tpufem/structured/pallas2d.py``): float32 geometry
constants, the damage mean as a true division by 3, contributions added
to a node lower vertices 0, 1, 2 then upper 0, 1, 2. The library is built
without fused multiply-adds, so kernel and plain version are bit-equal.

The launch geometry is computed here (:func:`lattice2d_geometry`): strips
of STRIP_NODES node columns, walked top to bottom one after another, cut
into as many equal segments as the card holds blocks at once;
:func:`lattice2d_walk` lists the tiles each block walks, as
``csrc/lattice2d.cuh`` does.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as tF

from tpufem_torch.forms.potentials import (asym_damage_stress_components,
                                           asym_damage_stress_jvp_components,
                                           lame_parameters)
from tpufem_torch.lane import _build
from tpufem_torch.lane.kernels import _check, _raise_on, _stream

# lattice offsets per orientation (dy, dx), element dof order -- must match
# tpufem_torch.structured.grid2d
_LOWER = ((0, 0), (0, 1), (1, 1))
_UPPER = ((0, 0), (1, 1), (1, 0))


def _phys_grads(hx: float, hy: float):
    """{'lo'|'up': (dN (3, 2) float32, w float32)} -- the basis gradients
    and the weight of each orientation, rounded to float32 as the kernels
    use them."""
    dN_ref = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
    out = {}
    for tag, x_e in (
        ("lo", np.array([[0.0, 0.0], [hx, 0.0], [hx, hy]])),
        ("up", np.array([[0.0, 0.0], [hx, hy], [0.0, hy]])),
    ):
        J = x_e.T @ dN_ref
        out[tag] = (
            (dN_ref @ np.linalg.inv(J)).astype(np.float32),
            np.float32(0.5 * abs(np.linalg.det(J))),
        )
    return out


# The stress of the asymmetric elasto-damage law and its directional
# derivative, elementwise. forms.potentials spells them in the operation
# order of the reference's pallas2d._stress / _stress_jvp, and the CUDA
# header csrc/asym_damage.cuh repeats that order for K4, K6 and K7.
_stress = asym_damage_stress_components
_stress_jvp = asym_damage_stress_jvp_components


class LatticeConsts:
    """What K6 and K7 need besides the fields: the lattice size, the
    float32 basis gradients and weights of both orientations (``dN`` and
    ``w``: lower, upper) and the Lame parameters (Python floats, rounded to
    float32 where they are used, as the reference's weakly typed scalars
    are)."""

    def __init__(self, nx, ny, hx, hy, E, nu):
        self.nx, self.ny = int(nx), int(ny)
        self.lam, self.mu = (float(v) for v in lame_parameters(E, nu))
        g = _phys_grads(hx, hy)
        self.dN = (g["lo"][0], g["up"][0])
        self.w = (g["lo"][1], g["up"][1])
        # the 16 float32 values the kernels take, in their order: dN of the
        # lower then the upper triangle, the two weights, lam, mu
        vals = np.concatenate([self.dN[0].ravel(), self.dN[1].ravel(),
                               np.array([*self.w, self.lam, self.mu],
                                        np.float32)])
        self._packed = (ctypes.c_float * 16)(*vals.astype(np.float32))
        self._launch = {}  # (kernel, device index) -> (strips, blocks)

    def packed(self):
        return self._packed

    def launch(self, lib, name: str, dev):
        """(strips, blocks) of kernel ``name`` on ``dev``: the launch
        geometry at the blocks the card holds at once, computed once."""
        key = (name, dev.index)
        if key not in self._launch:
            per_sm = ctypes.c_int(0)
            _raise_on(getattr(lib, name + "_occupancy")(
                ctypes.byref(per_sm)), name + "_occupancy")
            geo = lattice2d_geometry(
                self.nx, self.ny, per_sm.value
                * torch.cuda.get_device_properties(dev).multi_processor_count)
            self._launch[key] = (geo["strips"], geo["blocks"])
        return self._launch[key]


# -- plain versions ---------------------------------------------------------


def _cell_views(f, offsets, ny, nx):
    return [f[..., dy: dy + ny, dx: dx + nx] for dy, dx in offsets]


def _grad(vals, dN, col):
    """sum_q vals[q] * dN[q, col], q ascending."""
    return (vals[0] * float(dN[0, col]) + vals[1] * float(dN[1, col])
            + vals[2] * float(dN[2, col]))


def _damage_mean(dv):
    """(d0 + d1 + d2) / 3 as a true division (a Python divisor would be a
    multiplication by its reciprocal on the card)."""
    s = dv[0] + dv[1] + dv[2]
    return s / torch.full((), 3.0, dtype=s.dtype, device=s.device)


def _lattice_pass(u, d, v, k: LatticeConsts):
    """The plain pass of both kernels: ``v`` None gives F(u), else
    J(u) . v."""
    nx, ny = k.nx, k.ny
    acc = None
    for o, offsets in enumerate((_LOWER, _UPPER)):
        dN, w = k.dN[o], float(k.w[o])
        ux = _cell_views(u[0], offsets, ny, nx)
        uy = _cell_views(u[1], offsets, ny, nx)
        e11, e22 = _grad(ux, dN, 0), _grad(uy, dN, 1)
        e12 = 0.5 * (_grad(ux, dN, 1) + _grad(uy, dN, 0))
        dc = _damage_mean(_cell_views(d, offsets, ny, nx))
        if v is None:
            s11, s22, s12 = _stress(e11, e22, e12, dc, k.lam, k.mu)
        else:
            vx = _cell_views(v[0], offsets, ny, nx)
            vy = _cell_views(v[1], offsets, ny, nx)
            t12 = 0.5 * (_grad(vx, dN, 1) + _grad(vy, dN, 0))
            s11, s22, s12 = _stress_jvp(e11, e22, e12, _grad(vx, dN, 0),
                                        _grad(vy, dN, 1), t12, dc, k.lam,
                                        k.mu)
        for q, (dy, dx) in enumerate(offsets):
            a, b = float(dN[q, 0]), float(dN[q, 1])
            f = torch.stack([w * (s11 * a + s12 * b), w * (s12 * a + s22 * b)])
            f = tF.pad(f, (dx, 1 - dx, dy, 1 - dy))
            acc = f if acc is None else acc + f
    return acc


def residual_plain(u, d, consts: LatticeConsts):
    """Plain version of :func:`lattice_residual`."""
    return _lattice_pass(u, d, None, consts)


def tangent_plain(u, d, v, consts: LatticeConsts):
    """Plain version of :func:`lattice_tangent`."""
    return _lattice_pass(u, d, v, consts)


# -- launch geometry (mirrors csrc/lattice2d.cuh) -----------------------------

STRIP_NODES = 31  # node columns of a strip (a tile is 32 cell columns)
TILE_ROWS = 8  # cell rows of a tile (one cell per thread of 256)


def lattice2d_geometry(nx: int, ny: int, slots: int) -> dict:
    """Strips, the walk's length in node rows, and the blocks: ``slots``
    (the blocks the card holds at once), but no more than the walk has
    rows."""
    strips = -(-(nx + 1) // STRIP_NODES)
    walk = strips * (ny + 1)
    return dict(strips=strips, walk=walk, blocks=max(1, min(slots, walk)))


def lattice2d_walk(nx: int, ny: int, blocks: int):
    """Yields (block, strip, ra, rb, c0) for every tile in the order the
    kernel walks them: block b's segment [b W / G, (b+1) W / G) of the walk
    cut into pieces of one strip each (node rows ra .. rb-1), each piece
    into tiles of cell rows c0 .. c0 + TILE_ROWS - 1 from c0 = ra - 1."""
    H = ny + 1
    walk = lattice2d_geometry(nx, ny, blocks)["walk"]
    for b in range(blocks):
        pos, end = b * walk // blocks, (b + 1) * walk // blocks
        while pos < end:
            s, ra = divmod(pos, H)
            rb = min(H, ra + (end - pos))
            c0 = ra - 1
            while True:
                yield b, s, ra, rb, c0
                if c0 + TILE_ROWS > rb - 1:
                    break
                c0 += TILE_ROWS
            pos += rb - ra


def lattice2d_cover(nx: int, ny: int, blocks: int):
    """What the walk does: how many times each node (ny+1, nx+1) is
    gathered, how many times each cell (ny, nx) is computed, and the
    tiles of each block."""
    gathers = np.zeros((ny + 1, nx + 1), np.int64)
    cells = np.zeros((ny, nx), np.int64)
    tiles = np.zeros(blocks, np.int64)
    for b, s, ra, rb, c0 in lattice2d_walk(nx, ny, blocks):
        tiles[b] += 1
        j0 = s * STRIP_NODES
        # lanes 1..31 gather node columns j0 .. j0 + 30 of rows ra .. rb-1
        rows = slice(max(c0, ra), min(c0 + TILE_ROWS, rb))
        gathers[rows, j0: min(j0 + STRIP_NODES, nx + 1)] += 1
        # every lane computes its cell: columns j0 - 1 .., rows c0 .. rb-1
        cells[max(c0, 0): min(c0 + TILE_ROWS, rb, ny),
              max(j0 - 1, 0): min(j0 + STRIP_NODES, nx)] += 1
    return gathers, cells, tiles


# -- kernels ------------------------------------------------------------------


def lattice_residual(u, d, consts: LatticeConsts):
    """K6: F(u) (2, ny+1, nx+1) of u (2, ny+1, nx+1) and the vertex damage
    d (ny+1, nx+1), float32 on the card."""
    if u.device.type != "cuda":
        return residual_plain(u, d, consts)
    dev = u.device
    shp = (2, consts.ny + 1, consts.nx + 1)
    _check("u", u, device=dev, dtypes=(torch.float32,), shape=shp)
    _check("d", d, device=dev, dtypes=(torch.float32,), shape=shp[1:])
    out = torch.empty_like(u)
    lib = _build.load()
    code = lib.lattice_residual(u.data_ptr(), d.data_ptr(), out.data_ptr(),
                                consts.nx, consts.ny, consts.packed(),
                                *consts.launch(lib, "lattice_residual", dev),
                                _stream(dev))
    _raise_on(code, "lattice_residual")
    lattice_residual.launches += 1
    return out


def lattice_tangent(u, d, v, consts: LatticeConsts):
    """K7: J(u) . v (2, ny+1, nx+1) for u, v (2, ny+1, nx+1) and the vertex
    damage d (ny+1, nx+1), float32 on the card."""
    if u.device.type != "cuda":
        return tangent_plain(u, d, v, consts)
    dev = u.device
    shp = (2, consts.ny + 1, consts.nx + 1)
    _check("u", u, device=dev, dtypes=(torch.float32,), shape=shp)
    _check("v", v, device=dev, dtypes=(torch.float32,), shape=shp)
    _check("d", d, device=dev, dtypes=(torch.float32,), shape=shp[1:])
    out = torch.empty_like(u)
    lib = _build.load()
    code = lib.lattice_tangent(u.data_ptr(), d.data_ptr(), v.data_ptr(),
                               out.data_ptr(), consts.nx, consts.ny,
                               consts.packed(),
                               *consts.launch(lib, "lattice_tangent", dev),
                               _stream(dev))
    _raise_on(code, "lattice_tangent")
    lattice_tangent.launches += 1
    return out


def make_residual_kernel(nx: int, ny: int, hx: float, hy: float,
                         E: float, nu: float):
    """Returns residual(u (2, ny+1, nx+1), d (ny+1, nx+1)) -> same shape as
    u: K6, the fused version of StructuredGrid2D.residual for the
    asym-damage law with scalar E. It runs where its tensors lie."""
    consts = LatticeConsts(nx, ny, hx, hy, E, nu)

    def residual(u, d):
        return lattice_residual(u, d, consts)

    residual.consts = consts
    return residual


def make_tangent_kernel(nx: int, ny: int, hx: float, hy: float,
                        E: float, nu: float):
    """Returns jvp(u, d, v) -> (dF/du)[v]: K7, the fused CG operator of
    the asym-damage structured residual."""
    consts = LatticeConsts(nx, ny, hx, hy, E, nu)

    def jvp(u, d, v):
        return lattice_tangent(u, d, v, consts)

    jvp.consts = consts
    return jvp


def _wrappers():
    return (lattice_residual, lattice_tangent)


def reset_launch_counts() -> None:
    for fn in _wrappers():
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _wrappers()}


reset_launch_counts()

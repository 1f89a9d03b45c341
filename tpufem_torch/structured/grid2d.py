"""2D structured-grid (right-diagonal P1 triangulation) fast path.

Matches ``tpufem_torch.mesh.generate.rectangle(nx, ny, diagonal="right")``:
nodes on an (ny+1, nx+1) lattice (row-major, x fastest), each cell split
into lower (v00, v10, v11) and upper (v00, v11, v01) triangles. All
lower cells are congruent and all upper cells are congruent, so the
geometry map is two constants; dof movement is shifted slices;
accumulation is slice-adds -- no gathers.

LAYOUT: the lattice in the two minor axes -- displacement is
(bs, ny+1, nx+1), coefficient fields are (ny+1, nx+1) per vertex or
(2, ny, nx) per (orientation, cell).

The element physics runs on whole lattices at once: the integrand sees
``SMat`` containers whose entries are (ny, nx) tensors (the lane engine's
reduced-variable idiom), and ``torch.func.grad`` / ``jvp`` of the summed
energy give the residual, the tangent action and the element matrices.

The operator a multigrid cycle applies is linear and frozen, so it is
linearized once (:meth:`StructuredGrid2D.linearize`: per-cell,
per-orientation (3 bs)^2 element matrices) and assembled into a 7-point
stencil (:class:`LatticeOperator`); one application is then a pad, a
stack of seven shifted views, one multiply and one sum -- four kernels,
independent of the law. The reference re-runs ``jax.jvp`` of the
residual per application, which ``jit`` makes free there; eager PyTorch
would replay the AD machinery on the host every time.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as tF
from torch.func import grad, jvp

from tpufem_torch.forms.smat import SMat

# vertex lattice offsets (dy, dx) per orientation, in element dof order
_LOWER = ((0, 0), (0, 1), (1, 1))  # v00, v10, v11
_UPPER = ((0, 0), (1, 1), (1, 0))  # v00, v11, v01
_ORIENTATIONS = (("lower", _LOWER), ("upper", _UPPER))

# node-to-node offsets (dy, dx) that two vertices of one triangle can
# have: the stencil of the assembled operator; (0, 0) first
STENCIL_OFFSETS = ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0), (1, 1),
                   (-1, -1))


def _tri_geometry(hx: float, hy: float, orientation: str) -> np.ndarray:
    if orientation == "lower":
        return np.array([[0.0, 0.0], [hx, 0.0], [hx, hy]])
    return np.array([[0.0, 0.0], [hx, hy], [0.0, hy]])


def _shifts(arr, offsets):
    """Views of ``arr`` padded by one node on every side of its last
    ``len(offset)`` axes, shifted by each offset: entry [i, j] of view k
    (2D) is arr[i+dy, j+dx], 0 outside the lattice."""
    nd = len(offsets[0])
    shape = arr.shape[-nd:]
    p = tF.pad(arr, (1, 1) * nd)
    return [p[(Ellipsis,) + tuple(slice(1 + o, 1 + o + n)
                                  for o, n in zip(off, shape))]
            for off in offsets]


class LatticeOperator:
    """A linear operator on (..., bs, *lattice) vectors as a stencil of
    bs x bs blocks: ``S`` (K, bs, bs, *lattice) and its node offsets
    (K tuples, (0, ..., 0) first). In 2D (``STENCIL_OFFSETS``, 7 points)

      y[c, i, j] = sum_k sum_e S[k, c, e, i, j] * v[e, i + dy_k, j + dx_k]

    with v = 0 off the lattice; in 3D the same with 27 offsets
    (``grid3d.STENCIL_OFFSETS_3D``). Leading batch dimensions of ``v`` are
    kept (the dense coarse operator is built from one batched application
    to unit vectors)."""

    def __init__(self, S: torch.Tensor, offsets=STENCIL_OFFSETS):
        self.S = S
        self.offsets = tuple(offsets)

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        nd = len(self.offsets[0])
        U = torch.stack(_shifts(v, self.offsets), dim=-(nd + 2))
        return (self.S * U.unsqueeze(-(nd + 2))).sum(
            dim=(-(nd + 3), -(nd + 1)))

    def diagonal(self) -> torch.Tensor:
        """(bs, *lattice): the operator's diagonal."""
        return torch.diagonal(self.S[0], dim1=0, dim2=1).movedim(-1, 0)

    def constrained(self, free: torch.Tensor) -> "LatticeOperator":
        """The operator v -> A(v * free) * free + v * (1 - free) (identity
        rows and columns at constrained dofs), as one stencil."""
        fn = torch.stack(_shifts(free, self.offsets))
        S = self.S * free[None, :, None]
        S *= fn[:, None, :]
        bs = free.shape[0]
        idx = torch.arange(bs, device=S.device)
        S[0, idx, idx] = S[0, idx, idx] + (1.0 - free)
        return LatticeOperator(S, self.offsets)


@dataclasses.dataclass
class StructuredGrid2D:
    """Gather-free assembly for a 2D lattice triangulation.

    ``energy_density(grad_u, coeffs)`` -> energy density; ``grad_u`` is
    an ``SMat`` (bs, 2) of (ny, nx) tensors and ``coeffs`` maps declared
    field names to their centroid values. Fields:
    - 'vertex': (ny+1, nx+1) nodal (P1 value at centroid = vertex mean),
    - 'cell': (2, ny, nx) per (orientation, cell).
    1-point (centroid) quadrature -- the reference's stiffness-term rule
    (asym_ufl.py:78-79).
    """

    nx: int
    ny: int
    hx: float
    hy: float
    bs: int
    energy_density: Callable
    field_kinds: Dict[str, str]  # name -> 'vertex' | 'cell'

    def __post_init__(self):
        dN_ref = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
        for tag, orientation in (("lo", "lower"), ("up", "upper")):
            x_e = _tri_geometry(self.hx, self.hy, orientation)
            J = x_e.T @ dN_ref
            setattr(self, f"_dN_{tag}", dN_ref @ np.linalg.inv(J))
            setattr(self, f"_w_{tag}", 0.5 * abs(np.linalg.det(J)))

    # -- shape helpers ---------------------------------------------------------

    def flatten(self, u_grid) -> torch.Tensor:
        """(bs, ny+1, nx+1) -> byVDIM flat dof vector (matches the
        unstructured numbering of generate.rectangle)."""
        return torch.movedim(u_grid, 0, -1).reshape(-1)

    def unflatten(self, u_flat) -> torch.Tensor:
        """byVDIM flat vector -> (bs, ny+1, nx+1)."""
        g = u_flat.reshape(self.ny + 1, self.nx + 1, self.bs)
        return torch.movedim(g, -1, 0)

    def vertex_grid(self, v_flat) -> torch.Tensor:
        """Scalar nodal vector -> (ny+1, nx+1)."""
        return v_flat.reshape(self.ny + 1, self.nx + 1)

    # -- data movement (all static slices) -------------------------------------

    def _slices(self, arr, offsets):
        """Shifted (..., ny, nx) views of a (..., ny+1, nx+1) field."""
        ny, nx = self.ny, self.nx
        return [arr[..., dy: dy + ny, dx: dx + nx] for (dy, dx) in offsets]

    def _geometry(self, orientation: str):
        tag = orientation[:2]
        return getattr(self, f"_dN_{tag}"), getattr(self, f"_w_{tag}")

    def _grad_u(self, u_e, dN):
        """SMat (bs, 2) of the cell gradient from the element dofs
        ``u_e`` (3*bs tensors, row v*bs+c)."""
        bs = self.bs
        return SMat([[u_e[c] * float(dN[0][d]) + u_e[bs + c] * float(dN[1][d])
                      + u_e[2 * bs + c] * float(dN[2][d]) for d in range(2)]
                     for c in range(bs)])

    def _coeffs_at_cells(self, fields, orientation_idx, offsets):
        out = {}
        for name, kind in self.field_kinds.items():
            f = fields[name]
            if kind == "vertex":
                out[name] = sum(self._slices(f, offsets)) / 3.0
            else:
                out[name] = f[orientation_idx]
        return out

    def _element_dofs(self, u, offsets):
        """3*bs (ny, nx) views, row v*bs+c."""
        return [s[c] for s in self._slices(u, offsets) for c in range(self.bs)]

    def _scatter(self, rows, offsets):
        """Element rows (3*bs tensors (ny, nx), row v*bs+c) -> nodal
        (bs, ny+1, nx+1) sums, functionally (padding, no in-place add,
        so ``torch.func`` transforms pass through)."""
        bs = self.bs
        out = None
        for v, (dy, dx) in enumerate(offsets):
            blk = torch.stack(rows[v * bs:(v + 1) * bs])
            t = tF.pad(blk, (dx, 1 - dx, dy, 1 - dy))
            out = t if out is None else out + t
        return out

    # -- assembled quantities ---------------------------------------------------

    def _cell_energy(self, orientation: str, coeffs):
        dN, w = self._geometry(orientation)
        density = self.energy_density

        def energy(*u_e):
            return density(self._grad_u(u_e, dN), coeffs) * w

        return energy

    def residual(self, u, fields):
        """F(u): (bs, ny+1, nx+1), gather-free."""
        r = None
        nd = 3 * self.bs
        for oi, (orientation, offsets) in enumerate(_ORIENTATIONS):
            coeffs = self._coeffs_at_cells(fields, oi, offsets)
            e = self._cell_energy(orientation, coeffs)
            g = grad(lambda *a: torch.sum(e(*a)), argnums=tuple(range(nd)))(
                *self._element_dofs(u, offsets))
            t = self._scatter(list(g), offsets)
            r = t if r is None else r + t
        return r

    def load_residual(self, f):
        """Constant -int f.u contribution (total residual = residual -
        load_residual), 1-pt rule."""
        r = None
        for orientation, offsets in _ORIENTATIONS:
            _, w = self._geometry(orientation)
            f_c = sum(self._slices(f, offsets)) / 3.0  # (bs, ny, nx)
            contrib = (w / 3.0) * f_c
            rows = [contrib[c] for _ in range(3) for c in range(self.bs)]
            t = self._scatter(rows, offsets)
            r = t if r is None else r + t
        return r

    def tangent_action(self, u, fields, v):
        """Matrix-free J(u).v -- jvp of the gather-free residual (AD on
        every call; :meth:`linearize` + :meth:`operator` is the form to
        apply repeatedly)."""
        return jvp(lambda w: self.residual(w, fields), (u,), (v,))[1]

    def linearize(self, u, fields) -> torch.Tensor:
        """Element matrices at the state ``u``: (2, 3*bs, 3*bs, ny, nx),
        orientation-leading, rows and columns v*bs+c. The Hessian of the
        density w.r.t. the 2*bs gradient components is taken by JVPs along
        unit directions, then chained to the dofs through the constant
        basis gradients: K = w B^T H B."""
        bs = self.bs
        nG = 2 * bs
        out = []
        for oi, (orientation, offsets) in enumerate(_ORIENTATIONS):
            dN, w = self._geometry(orientation)
            coeffs = self._coeffs_at_cells(fields, oi, offsets)
            G = self._grad_u(self._element_dofs(u, offsets), dN)
            a = tuple(G[c, d] for c in range(bs) for d in range(2))
            density = self.energy_density

            def energy_sum(*a_):
                return torch.sum(density(SMat(
                    [[a_[c * 2 + d] for d in range(2)] for c in range(bs)]),
                    coeffs))

            gfn = grad(energy_sum, argnums=tuple(range(nG)))
            one, zero = torch.ones_like(a[0]), torch.zeros_like(a[0])
            cols = [jvp(gfn, a, tuple(one if i == j else zero
                                      for i in range(nG)))[1]
                    for j in range(nG)]
            H = torch.stack([torch.stack([cols[j][i] for j in range(nG)])
                             for i in range(nG)])  # (nG, nG, ny, nx)
            B = np.zeros((nG, 3 * bs))
            for v in range(3):
                for c in range(bs):
                    for d in range(2):
                        B[c * 2 + d, v * bs + c] = dN[v][d]
            Bt = torch.as_tensor(w * B, dtype=H.dtype, device=H.device)
            Bt0 = torch.as_tensor(B, dtype=H.dtype, device=H.device)
            out.append(torch.einsum("ia,ijyx,jb->abyx", Bt, H, Bt0))
        return torch.stack(out)

    def element_matrices_to_stencil(self, Ke) -> torch.Tensor:
        """Assemble element matrices (2, 3bs, 3bs, ny, nx) into the
        operator's 7-point stencil (7, bs, bs, ny+1, nx+1)."""
        bs, ny, nx = self.bs, self.ny, self.nx
        S = Ke.new_zeros((len(STENCIL_OFFSETS), bs, bs, ny + 1, nx + 1))
        for oi, (_o, offsets) in enumerate(_ORIENTATIONS):
            for a, (ay, ax) in enumerate(offsets):
                for b, (by, bx) in enumerate(offsets):
                    k = STENCIL_OFFSETS.index((by - ay, bx - ax))
                    S[k, :, :, ay: ay + ny, ax: ax + nx] += Ke[
                        oi, a * bs:(a + 1) * bs, b * bs:(b + 1) * bs]
        return S

    def operator(self, u, fields, free: Optional[torch.Tensor] = None
                 ) -> LatticeOperator:
        """J(u) as a :class:`LatticeOperator`; with ``free`` the
        constrained operator v -> J(v*free)*free + v*(1-free)."""
        op = LatticeOperator(
            self.element_matrices_to_stencil(self.linearize(u, fields)))
        return op if free is None else op.constrained(free)

    def diagonal(self, u, fields):
        """Jacobian diagonal for Jacobi/Chebyshev preconditioning."""
        Ke = self.linearize(u, fields)
        d = None
        for oi, (_o, offsets) in enumerate(_ORIENTATIONS):
            ed = torch.diagonal(Ke[oi], dim1=0, dim2=1).movedim(-1, 0)
            t = self._scatter(list(ed), offsets)
            d = t if d is None else d + t
        return d

    def energy(self, u, fields) -> torch.Tensor:
        """Total stored energy Pi(u)."""
        total = torch.zeros((), dtype=u.dtype, device=u.device)
        for oi, (orientation, offsets) in enumerate(_ORIENTATIONS):
            coeffs = self._coeffs_at_cells(fields, oi, offsets)
            e = self._cell_energy(orientation, coeffs)
            total = total + torch.sum(e(*self._element_dofs(u, offsets)))
        return total

"""3D structured-grid (Q1 hex lattice) fast path.

Matches ``tpufem_torch.mesh.generate.box(nx, ny, nz, cell_type=hexahedron)``
numbering: nodes on an (nz+1, ny+1, nx+1) lattice (x fastest), one
trilinear hex per lattice cell. Axis-aligned boxes make the geometry map
affine (J = diag(hx, hy, hz)), so the physical shape-function gradients at
the 2x2x2 Gauss points are constants; dof movement is shifted slices and
accumulation slice-adds -- no gathers, the design of grid2d.

Displacement is (bs, nz+1, ny+1, nx+1), bs = 3. ``energy_density(grad_u,
coeffs)`` sees an ``SMat`` (bs, 3) whose entries are (nz, ny, nx) tensors
(one value per cell at one quadrature point) and the coefficients at that
point: 'vertex' fields (nz+1, ny+1, nx+1) are interpolated trilinearly,
'cell' fields (nz, ny, nx) are taken as they are.

The residual is the stress at each quadrature point (``torch.func.grad``
of the density with respect to the displacement gradient) pulled back
through the constant basis gradients; the tangent action is its JVP. The
operator a multigrid level applies is linear and frozen, so
:meth:`StructuredGrid3D.linearize` stores it once as a 27-point stencil of
bs x bs blocks (:class:`~tpufem_torch.structured.grid2d.LatticeOperator`),
from the density's Hessian at each quadrature point; the reference
re-runs ``jax.jvp`` per application, which ``jit`` makes free there and
which eager PyTorch would replay on the host every time.
"""

from __future__ import annotations

import dataclasses
from itertools import product
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as tF
from torch.func import grad, jvp

from tpufem_torch.elements.lagrange import element as make_element
from tpufem_torch.elements.quadrature import quadrature
from tpufem_torch.forms.smat import SMat
from tpufem_torch.mesh.mesh import CellType
from tpufem_torch.structured.grid2d import LatticeOperator

# vertex lattice offsets (dz, dy, dx) in tensor dof order (x fastest) --
# matches CELL_INFO[hexahedron] / generate.box
_CORNERS = tuple(
    (dz, dy, dx) for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)
)

# node-to-node offsets of the assembled operator, (0, 0, 0) first
STENCIL_OFFSETS_3D = ((0, 0, 0),) + tuple(
    o for o in product((-1, 0, 1), repeat=3) if o != (0, 0, 0))


def _smat(G, bs):
    """SMat (bs, 3) of the entries of a (bs, 3, ...) tensor."""
    return SMat([[G[c, d] for d in range(3)] for c in range(bs)])


@dataclasses.dataclass
class StructuredGrid3D:
    """Gather-free assembly for a Q1 hex lattice.

    ``energy_density(grad_u, coeffs)`` -> energy density; fields are
    'vertex' ((nz+1, ny+1, nx+1)) or 'cell' ((nz, ny, nx)). 2x2x2 Gauss
    quadrature (exact for Q1 stiffness on affine boxes).
    """

    nx: int
    ny: int
    nz: int
    hx: float
    hy: float
    hz: float
    bs: int
    energy_density: Callable
    field_kinds: Dict[str, str]

    def __post_init__(self):
        el = make_element(CellType.hexahedron, 1)
        qpts, qwts = quadrature(CellType.hexahedron, 2)  # 2x2x2
        dN_ref = el.tabulate_grad(qpts)  # (8, 8, 3) [q, dof, dim]
        N_ref = el.tabulate(qpts)  # (8, 8)
        Jinv = np.diag([1.0 / self.hx, 1.0 / self.hy, 1.0 / self.hz])
        detJ = self.hx * self.hy * self.hz
        self._dN = (dN_ref @ Jinv).astype(np.float64)  # (q, dof, dim)
        self._N = N_ref.astype(np.float64)
        self._w = (qwts * detJ).astype(np.float64)
        self._nq = len(qwts)

    # -- shape helpers ----------------------------------------------------------

    def flatten(self, u_grid) -> torch.Tensor:
        """(bs, nz+1, ny+1, nx+1) -> byVDIM flat vector (box() numbering)."""
        return torch.movedim(u_grid, 0, -1).reshape(-1)

    def unflatten(self, u_flat) -> torch.Tensor:
        g = u_flat.reshape(self.nz + 1, self.ny + 1, self.nx + 1, self.bs)
        return torch.movedim(g, -1, 0)

    def vertex_grid(self, v_flat) -> torch.Tensor:
        return v_flat.reshape(self.nz + 1, self.ny + 1, self.nx + 1)

    # -- data movement ------------------------------------------------------------

    def _slices(self, arr):
        nz, ny, nx = self.nz, self.ny, self.nx
        return [
            arr[..., dz: dz + nz, dy: dy + ny, dx: dx + nx]
            for (dz, dy, dx) in _CORNERS
        ]

    def _scatter(self, contrib):
        """Corner contributions (8, bs, nz, ny, nx) -> nodal (bs, nz+1,
        ny+1, nx+1) sums, functionally (padding, no in-place add, so
        ``torch.func`` transforms pass through)."""
        out = None
        for k, (dz, dy, dx) in enumerate(_CORNERS):
            t = tF.pad(contrib[k], (dx, 1 - dx, dy, 1 - dy, dz, 1 - dz))
            out = t if out is None else out + t
        return out

    def _const(self, a, like):
        return torch.as_tensor(a, dtype=like.dtype, device=like.device)

    def _coeffs_at_qp(self, fields, q, like):
        """Coefficients at quadrature point q of every cell."""
        out = {}
        for name, kind in self.field_kinds.items():
            f = fields[name]
            if kind == "vertex":
                acc = None
                for k, s in enumerate(self._slices(f)):
                    t = s * float(self._N[q, k])
                    acc = t if acc is None else acc + t
                out[name] = acc
            else:
                out[name] = f
        return out

    def _grad_at_qp(self, u, q):
        """Displacement gradient (bs, 3, nz, ny, nx) at quadrature point q:
        sum_k u_k dN[q, k]."""
        u_cells = torch.stack(self._slices(u))  # (8, bs, nz, ny, nx)
        return torch.einsum("kb...,kd->bd...", u_cells,
                            self._const(self._dN[q], u))

    def _stress_fn(self, coeffs):
        """G (bs, 3, cells) -> d psi / d G at one quadrature point."""
        bs, density = self.bs, self.energy_density
        return grad(lambda G: torch.sum(density(_smat(G, bs), coeffs)))

    # -- assembled quantities --------------------------------------------------

    def residual(self, u, fields):
        """F(u): (bs, nz+1, ny+1, nx+1), gather-free."""
        contrib = None
        for q in range(self._nq):
            sig = self._stress_fn(self._coeffs_at_qp(fields, q, u))(
                self._grad_at_qp(u, q))
            t = torch.einsum("kd,bd...->kb...", self._const(
                self._w[q] * self._dN[q], u), sig)
            contrib = t if contrib is None else contrib + t
        return self._scatter(contrib)

    def tangent_action(self, u, fields, v):
        """Matrix-free J(u).v -- jvp of the residual (AD on every call;
        :meth:`operator` is the form to apply repeatedly)."""
        return jvp(lambda w: self.residual(w, fields), (u,), (v,))[1]

    def _hessians(self, u, fields):
        """Per quadrature point q: (q, H) with H (bs, 3, bs, 3, nz, ny, nx)
        the Hessian of the density with respect to the displacement
        gradient, H[c, d, e, f] = d sigma_cd / d G_ef: the backward pass
        through the stress batched over its bs*3 components (every cell
        at once; the cells are independent)."""
        bs = self.bs
        with torch.enable_grad():
            for q in range(self._nq):
                G = self._grad_at_qp(u, q).detach().requires_grad_(True)
                psi = torch.sum(self.energy_density(
                    _smat(G, bs), self._coeffs_at_qp(fields, q, u)))
                (sig,) = torch.autograd.grad(psi, G, create_graph=True)
                # row k of the batch seeds component k of sigma
                seeds = torch.eye(bs * 3, dtype=G.dtype, device=G.device)
                seeds = seeds.reshape((bs * 3, bs, 3) + (1,) * (G.dim() - 2))
                (H,) = torch.autograd.grad(
                    sig, G, grad_outputs=seeds.expand((bs * 3,) + G.shape),
                    is_grads_batched=True, materialize_grads=True)
                # (bs*3, bs, 3, cells)
                yield q, H.detach().reshape((bs, 3, bs, 3) + H.shape[3:])

    def diagonal(self, u, fields):
        """Jacobian diagonal: sum_q w_q dN_k^T H_q[c, :, c, :] dN_k per
        corner k and component c."""
        contrib = None
        for q, H in self._hessians(u, fields):
            Hcc = torch.diagonal(H, dim1=0, dim2=2)  # (3, 3, cells, bs)
            dN = self._const(self._dN[q], u)
            t = float(self._w[q]) * torch.einsum(
                "kd,de...c,ke->kc...", dN, Hcc, dN)
            contrib = t if contrib is None else contrib + t
        return self._scatter(contrib)

    def linearize(self, u, fields) -> torch.Tensor:
        """J(u) as a 27-point stencil (27, bs, bs, nz+1, ny+1, nx+1) over
        ``STENCIL_OFFSETS_3D``: the block coupling corner a of a cell with
        corner b is sum_q w_q dN_a^T H_q dN_b, added at a's node under the
        offset b - a."""
        bs, nz, ny, nx = self.bs, self.nz, self.ny, self.nx
        S = u.new_zeros((len(STENCIL_OFFSETS_3D), bs, bs, nz + 1, ny + 1,
                         nx + 1))
        for q, H in self._hessians(u, fields):
            dN = self._const(self._dN[q], u)
            for a, ca in enumerate(_CORNERS):
                # all eight blocks of corner a: (8, bs, bs, cells)
                Ka = torch.einsum("d,cdef...,bf->bce...",
                                  float(self._w[q]) * dN[a], H, dN)
                az, ay, ax = ca
                for b, cb in enumerate(_CORNERS):
                    k = STENCIL_OFFSETS_3D.index(
                        tuple(pb - pa for pa, pb in zip(ca, cb)))
                    S[k, :, :, az: az + nz, ay: ay + ny, ax: ax + nx] += Ka[b]
        return S

    def operator(self, u, fields, free: Optional[torch.Tensor] = None
                 ) -> LatticeOperator:
        """J(u) as a :class:`LatticeOperator`; with ``free`` the
        constrained operator v -> J(v*free)*free + v*(1-free)."""
        op = LatticeOperator(self.linearize(u, fields), STENCIL_OFFSETS_3D)
        return op if free is None else op.constrained(free)

    def load_residual(self, f):
        """-int f.u with f trilinear (vertex field), 2x2x2 rule: corner k
        gets sum_q w_q N_q[k] (N_q . f)."""
        f_cells = torch.stack(self._slices(f))  # (8, bs, nz, ny, nx)
        contrib = None
        for q in range(self._nq):
            Nq = self._const(self._N[q], f)
            f_q = torch.einsum("k,kb...->b...", Nq, f_cells)
            t = float(self._w[q]) * torch.einsum("k,b...->kb...", Nq, f_q)
            contrib = t if contrib is None else contrib + t
        return self._scatter(contrib)

    def energy(self, u, fields):
        """Total stored energy Pi(u)."""
        total = torch.zeros((), dtype=u.dtype, device=u.device)
        for q in range(self._nq):
            e = self.energy_density(_smat(self._grad_at_qp(u, q), self.bs),
                                    self._coeffs_at_qp(fields, q, u))
            total = total + float(self._w[q]) * torch.sum(e)
        return total

    def _cell_energy_with_coeffs(self):
        """energy(u_e (8, bs), coeffs) of ONE cell, where a vertex
        coefficient is its (8,) corner values, interpolated at each
        quadrature point (the single-cell form the reference
        differentiates, e.g. for the K8 cell matrix)."""
        dN, N, w, nq = self._dN, self._N, self._w, self._nq
        density, kinds, bs = self.energy_density, self.field_kinds, self.bs

        def energy(u_e, coeffs):
            total = torch.zeros((), dtype=u_e.dtype, device=u_e.device)
            for q in range(nq):
                G = u_e.T @ self._const(dN[q], u_e)  # (bs, 3)
                cq = {name: (self._const(N[q], u_e) @ val
                             if kinds[name] == "vertex" else val)
                      for name, val in coeffs.items()}
                total = total + density(_smat(G, bs), cq) * float(w[q])
            return total

        return energy

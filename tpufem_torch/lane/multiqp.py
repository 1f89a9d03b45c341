"""The lane engine's multi-quadrature-point physics: P2 triangles and
tetrahedra, Q1 / Q2 quadrilaterals and hexahedra, and P1 under a
quadrature rule above degree 1 or with several cell terms; the cell terms
of a functional (all of one quadrature degree) fold into one integrand.

Host side, :func:`host_tables` (the reference's
``tpufem/lane/engine.py:_try_specialize_multiqp``): per lane cell and
quadrature point, float64 physical basis gradients dN (nq, nv, gd, M),
weights w (nq, M) and points xq (nq, gd, M), and the static basis values
Nf (nq, nv) and, per coefficient, Nc (nq, nvc) (None for a P0
coefficient, whose one value is used as it is).

Device side, :class:`MultiQPPhysics` (the reference's
``_make_reduced_fns_mq``): the energy is differentiated with respect to
its reduced variables, nr = bs * (gd + 1) per quadrature point -- the
bs * gd gradient components (row c * gd + d) and the bs values (row
bs * gd + c) -- each a (nq, M) tensor that holds every quadrature point of
every lane cell at once: the integrands are elementwise in the SMat / SVec
components, so one evaluation covers all points (the reference loops q in
Python under ``jit``, where XLA fuses the loop; in eager PyTorch that loop
would be launches per point). The gradients, chained back to the nd =
nv * bs dof rows, are the element vectors.

The contractions between dofs and reduced variables run on the engine's
device as batched matrix products: dN is stored once, cells leading, as
``D`` (M, nv, nq * gd) -- D[m, v, q * gd + d] = dN[q, v, d, m] -- so that
u -> gradients is one ``bmm`` (M, bs, nv) x (M, nv, nq * gd) and its
transpose one ``bmm`` back, each reading D once; the values go through Nf
as plain matrix products. The per-cell linearization is block-diagonal in
q (the energy at a point reads only that point's variables): it is kept
as H (nr, nr, nq, M), H[j, i] = d g_i / d a_j, from nr JVPs, each along
component j at every point at once, and applied with one broadcast
multiply-sum. The Jacobi diagonal is the closed form sum_q b^T H_q b over
each dof's column b of the reduced map.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import grad, jvp

from tpufem_torch.elements.lagrange import element
from tpufem_torch.elements.quadrature import quadrature
from tpufem_torch.forms.form import QP
from tpufem_torch.forms.smat import SMat, SVec
from tpufem_torch.mesh.mesh import CellType

MQ_CELLS = (CellType.triangle, CellType.tetra, CellType.quad,
            CellType.hexahedron)


def fold_terms(functional) -> Tuple[Optional[Callable], Optional[int],
                                    Optional[str]]:
    """(integrand, quadrature degree, None) of the functional's cell terms
    folded into one integrand, or (None, None, why) where the multi-qp path
    does not take it."""
    terms = functional.terms
    if not terms:
        return None, None, "the functional has no cell term"
    if any(t.needs_coeff_grads for t in terms):
        return None, None, "a term needs coefficient gradients"
    qdeg = terms[0].degree
    if any(t.degree != qdeg for t in terms[1:]):
        return None, None, ("its terms have quadrature degrees "
                            f"{sorted({t.degree for t in terms})}")
    if len(terms) == 1:
        return terms[0].integrand, qdeg, None
    fns = [t.integrand for t in terms]

    def integrand(qp):
        acc = fns[0](qp)
        for fn in fns[1:]:
            acc = acc + fn(qp)
        return acc

    return integrand, qdeg, None


def host_tables(space, safe_order: np.ndarray, qdeg: int,
                coefficients, coeff_dofmaps) -> Dict:
    """The float64 host tables of the multi-qp path for the lane cells
    ``safe_order`` (mesh cell of each lane cell, padding as cell 0):
    dN (nq, nv, gd, M), w (nq, M), xq (nq, gd, M), Nf (nq, nv) and Nc
    (name -> (nq, nvc) or None). The reference's construction
    (``tpufem/lane/engine.py:653-760``), zeros skipped the same way."""
    mesh = space.mesh
    felem = space.element
    qpts, qw = quadrature(mesh.cell_type, qdeg)
    nq = len(qw)
    Nf = np.asarray(felem.tabulate(qpts), np.float64)  # (nq, nv)
    dNf = np.asarray(felem.tabulate_grad(qpts), np.float64)
    gelem = element(mesh.cell_type, 1)
    Ng = np.asarray(gelem.tabulate(qpts), np.float64)  # (nq, nvg)
    dNg = np.asarray(gelem.tabulate_grad(qpts), np.float64)
    simplex = mesh.cell_type in (CellType.triangle, CellType.tetra)
    nv = Nf.shape[1]

    x = mesh.x.astype(np.float64)
    gcells = np.asarray(mesh.cells)[safe_order]  # (M, nvg)
    nvg = gcells.shape[1]
    gdim = x.shape[1]
    dim = qpts.shape[1]
    M = len(gcells)
    xv = [[x[gcells[:, v], d] for d in range(gdim)] for v in range(nvg)]

    def inv_det(J):
        """Adjugate inverse of J[d][i] = dx_d / dxi_i (lists of (M,)
        arrays): (Ji[i][d] = dxi_i / dx_d, det J)."""
        if dim == 2:
            a, b = J[0][0], J[0][1]
            c, d2 = J[1][0], J[1][1]
            det = a * d2 - b * c
            r = 1.0 / det
            return [[d2 * r, -b * r], [-c * r, a * r]], det
        a, b, c = J[0][0], J[0][1], J[0][2]
        d3, e3, f3 = J[1][0], J[1][1], J[1][2]
        g, h, i = J[2][0], J[2][1], J[2][2]
        A = e3 * i - f3 * h
        B = f3 * g - d3 * i
        C = d3 * h - e3 * g
        det = a * A + b * B + c * C
        r = 1.0 / det
        return [
            [A * r, (c * h - b * i) * r, (b * f3 - c * e3) * r],
            [B * r, (a * i - c * g) * r, (c * d3 - a * f3) * r],
            [C * r, (b * g - a * h) * r, (a * e3 - b * d3) * r],
        ], det

    def lin(get, weights, n):
        """sum_k weights[k] * get(k), zero weights skipped, unit ones
        not multiplied."""
        acc = None
        for k in range(n):
            wk = float(weights[k])
            if wk == 0.0:
                continue
            t = get(k) if wk == 1.0 else wk * get(k)
            acc = t if acc is None else acc + t
        return np.zeros(M) if acc is None else acc

    dN = np.empty((nq, nv, gdim, M))
    w = np.empty((nq, M))
    xq = np.empty((nq, gdim, M))
    Ji = det = None
    for q in range(nq):
        if Ji is None or not simplex:  # simplex: J is cell-constant
            J = [[lin(lambda v: xv[v][d], dNg[q, :, i], nvg)
                  for i in range(dim)] for d in range(gdim)]
            Ji, det = inv_det(J)
        w[q] = np.abs(det) * float(qw[q])
        for v in range(nv):
            for j in range(gdim):
                dN[q, v, j] = lin(lambda i: Ji[i][j], dNf[q, v], dim)
        for d in range(gdim):
            xq[q, d] = lin(lambda v: xv[v][d], Ng[q], nvg)
    Nc = {}
    for c in coefficients:
        ndofc = coeff_dofmaps[c.name].shape[1] // c.space.bs
        Nc[c.name] = None if ndofc == 1 else np.asarray(
            c.space.element.tabulate(qpts), np.float64)
    return dict(nq=nq, nv=nv, dN=dN, w=w, xq=xq, Nf=Nf, Nc=Nc)


def cells_leading(dN: np.ndarray) -> np.ndarray:
    """dN (nq, nv, gd, M) -> D (M, nv, nq * gd), D[m, v, q * gd + d] =
    dN[q, v, d, m]: the layout the batched products read."""
    nq, nv, gd, M = dN.shape
    return np.ascontiguousarray(dN.transpose(3, 1, 0, 2)).reshape(
        M, nv, nq * gd)


class MultiQPPhysics:
    """Residual, energy, linearization, tangent application and Jacobi
    diagonal of the multi-qp path on (nd, M) cells-minor element data
    (module docstring). ``Nf`` / ``Nc`` are the host tables of
    :func:`host_tables`; ``coeff_meta`` lists (name, dofs per cell,
    components) of each coefficient; ``device`` is where the small
    constant tables live."""

    def __init__(self, integrand: Callable, Nf: np.ndarray,
                 Nc: Dict[str, Optional[np.ndarray]], bs: int, gd: int,
                 coeff_meta: List[Tuple[str, int, int]], device):
        self.integrand = integrand
        self.nq, self.nv = Nf.shape
        self.bs, self.gd = bs, gd
        self.nG = bs * gd  # gradient rows; the bs value rows follow
        self.nr = bs * (gd + 1)
        self.nd = self.nv * bs
        self.coeff_meta = coeff_meta
        self._Nf = torch.as_tensor(Nf, dtype=torch.float64, device=device)
        self._Nc = {k: None if v is None else torch.as_tensor(
            v, dtype=torch.float64, device=device) for k, v in Nc.items()}

    # -- contractions between dofs and reduced variables ---------------------

    def reduced_args(self, u_cells: torch.Tensor,
                     D: torch.Tensor) -> torch.Tensor:
        """(nd, M) dof values (row v * bs + c) -> (nr, nq, M) reduced
        variables: gradients by one batched product with D, values by
        one product with Nf per component."""
        nv, bs, gd, nq, nG = self.nv, self.bs, self.gd, self.nq, self.nG
        M = u_cells.shape[-1]
        U = u_cells.reshape(nv, bs, M)
        A = u_cells.new_empty((self.nr, nq, M))
        G = torch.bmm(U.permute(2, 1, 0), D)  # (M, bs, nq * gd)
        A[:nG].view(bs, gd, nq, M).copy_(
            G.view(M, bs, nq, gd).permute(1, 3, 2, 0))
        Nf = self._Nf.to(u_cells.dtype)
        for c in range(bs):
            torch.matmul(Nf, U[:, c], out=A[nG + c])
        return A

    def chain_back(self, g: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
        """(nr, nq, M) derivatives with respect to the reduced variables
        -> (nd, M) element vectors (row v * bs + c): the transpose of
        :meth:`reduced_args`."""
        nv, bs, gd, nq, nG = self.nv, self.bs, self.gd, self.nq, self.nG
        M = g.shape[-1]
        gT = g[:nG].view(bs, gd, nq, M).permute(3, 2, 1, 0).reshape(
            M, nq * gd, bs)
        out = torch.bmm(D, gT).permute(1, 2, 0).contiguous()  # (nv, bs, M)
        NfT = self._Nf.to(g.dtype).T  # (nv, nq)
        for c in range(bs):
            out[:, c] = torch.addmm(out[:, c], NfT, g[nG + c])
        return out.view(self.nd, M)

    def cvals(self, coeffs) -> dict:
        """Coefficient values at the quadrature points: (nq, M) each, or
        the (M,) cell value of a P0 coefficient."""
        out = {}
        for name, ndofc, cb in self.coeff_meta:
            ce = coeffs[name]  # (ndofc * cb, M)
            if ndofc == 1:
                comps = [ce[j] for j in range(cb)]
            else:
                Nc = self._Nc[name].to(ce.dtype)  # (nq, ndofc)
                ce3 = ce.reshape(ndofc, cb, ce.shape[-1])
                comps = [Nc @ ce3[:, j] for j in range(cb)]
            out[name] = comps[0] if cb == 1 else SVec(comps)
        return out

    # -- the physics ----------------------------------------------------------

    def _density(self, coeffs, w, xq):
        """a_0, ..., a_{nr-1} (each (nq, M)) -> integrand * w, (nq, M)."""
        bs, gd, nG = self.bs, self.gd, self.nG
        cvals = self.cvals(coeffs)
        x = SVec([xq[:, d] for d in range(gd)])
        integrand = self.integrand

        def density(*a):
            grad_u = SMat([[a[c * gd + d] for d in range(gd)]
                           for c in range(bs)])
            uq = a[nG] if bs == 1 else SVec(a[nG:nG + bs])
            return integrand(QP(grad_u, uq, x, cvals, {})) * w

        return density

    def _grad_fn(self, coeffs, w, xq):
        density = self._density(coeffs, w, xq)
        return grad(lambda *a: torch.sum(density(*a)),
                    argnums=tuple(range(self.nr)))

    def residual(self, u_cells, coeffs, D, w, xq) -> torch.Tensor:
        A = self.reduced_args(u_cells, D)
        g = self._grad_fn(coeffs, w, xq)(*A.unbind(0))
        return self.chain_back(torch.stack(g), D)

    def energy(self, u_cells, coeffs, D, w, xq) -> torch.Tensor:
        """Per-lane-cell energies (M,)."""
        A = self.reduced_args(u_cells, D)
        return self._density(coeffs, w, xq)(*A.unbind(0)).sum(0)

    def linearize(self, u_cells, coeffs, D, w, xq) -> torch.Tensor:
        """H (nr, nr, nq, M) at a frozen state, H[j, i] = d g_i / d a_j:
        column j from one JVP of the reduced gradient along component j
        at every point at once (each point's gradient reads only that
        point's variables)."""
        nr = self.nr
        a = self.reduced_args(u_cells, D).unbind(0)
        gfn = self._grad_fn(coeffs, w, xq)
        one, zero = torch.ones_like(a[0]), torch.zeros_like(a[0])
        H = a[0].new_empty((nr, nr) + tuple(a[0].shape))
        for j in range(nr):
            col = jvp(gfn, a, tuple(one if i == j else zero
                                    for i in range(nr)))[1]
            torch.stack(col, out=H[j])
        return H

    @staticmethod
    def hess_apply(H: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
        """dg_i = sum_j H[j, i] * A[j] at every point: (nr, nq, M)."""
        return (H * A.unsqueeze(1)).sum(0)

    def apply(self, H, v_cells, D) -> torch.Tensor:
        """Tangent element vectors from a stored linearization:
        chain_back(H . reduced_args(v))."""
        return self.chain_back(
            self.hess_apply(H, self.reduced_args(v_cells, D)), D)

    def diagonal(self, H, D) -> torch.Tensor:
        """Diagonals of the element matrices, (nd, M): for dof (v, c),
        sum_q b^T H_q b with b its column of the reduced map -- dN[q, v, :]
        in the gradient rows of component c, Nf[q, v] in its value row."""
        nv, bs, gd, nq, nG = self.nv, self.bs, self.gd, self.nq, self.nG
        M = D.shape[0]
        Nf = self._Nf.to(D.dtype)
        B = torch.cat([D.view(M, nv, nq, gd),
                       Nf.T.reshape(1, nv, nq, 1).expand(M, nv, nq, 1)],
                      dim=3)  # (M, nv, nq, gd + 1)
        out = D.new_empty((nv, bs, M))
        for c in range(bs):
            rows = torch.as_tensor([c * gd + d for d in range(gd)]
                                   + [nG + c], device=D.device)
            Hc = H[rows][:, rows].permute(3, 2, 0, 1)  # (M, nq, j, i)
            out[:, c] = torch.einsum("mvqj,mqji,mvqi->vm", B, Hc, B)
        return out.view(self.nd, M)

"""EnergyFunctional: turn an energy density into element kernels.

The analog of the ffcx compile pipeline (SURVEY.md section 3.4): where
the reference runs ``ffcx asym_*.py`` at build time to emit C
``tabulate_tensor`` kernels (FEniCSx/mechanic2d/Makefile:13-15), here a
Python element-energy function is differentiated by ``torch.func``:
``grad`` of it is the element residual kernel (the ffcx "vector
kernel"), ``hessian`` the element matrix kernel (the "matrix kernel"),
and ``jvp`` of the gradient the matrix-free tangent action; ``vmap``
batches it over all cells.

Element dof values arrive as (ndof, bs) blocks; coefficients are
evaluated at quadrature points from their own (possibly different-degree)
spaces, mirroring the coefficient packing dolfinx does per form
(FEniCSx/...cc:672-675).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence

import numpy as np
import torch

from tpufem_torch.config import DEFAULT_DTYPE, resolve_device
from tpufem_torch.elements.geometry import det as small_det, inv as small_inv
from tpufem_torch.elements.lagrange import element as make_element
from tpufem_torch.elements.quadrature import quadrature
from tpufem_torch.spaces.space import FunctionSpace


@dataclasses.dataclass(frozen=True)
class Coefficient:
    """A field entering the integrand, with its own space."""

    name: str
    space: FunctionSpace  # space the coefficient lives in


class QP:
    """Per-quadrature-point context handed to integrands."""

    def __init__(self, grad_u, u, x, coeffs, coeff_grads):
        self.grad_u = grad_u  # (bs, gdim) physical gradient of u
        self.u = u  # (bs,) value of u
        self.x = x  # (gdim,) physical position
        self._c = coeffs  # name -> value ((,) scalar or (bs_c,))
        self._cg = coeff_grads  # name -> (bs_c, gdim) if requested

    @property
    def eps(self):
        """Symmetric gradient (small strain), (bs, gdim)."""
        return 0.5 * (self.grad_u + self.grad_u.T)

    def coeff(self, name):
        return self._c[name]

    def coeff_grad(self, name):
        return self._cg[name]


@dataclasses.dataclass(frozen=True)
class Term:
    """Integral of integrand(qp) dX over all cells, at given quadrature
    degree.

    The reference forces degree 1 on the stiffness term and the default
    degree on the load term (asym_ufl.py:78-81); one Term each.
    """

    integrand: Callable[[QP], torch.Tensor]
    degree: int
    needs_coeff_grads: Sequence[str] = ()


class FacetQP:
    """Per-quadrature-point context on an exterior facet."""

    def __init__(self, u, x, normal, coeffs):
        self.u = u  # (bs,) value of u at the point
        self.x = x  # (gdim,) position
        self.normal = normal  # (gdim,) outward unit normal
        self._c = coeffs

    def coeff(self, name):
        return self._c[name]


@dataclasses.dataclass(frozen=True)
class FacetTerm:
    """Integral of integrand(fqp) dGamma over a set of exterior facets.

    Equivalent of the reference's ``ds(0)`` surface-load term and its
    exterior_facet subdomain machinery (USE_SURF,
    FEniCSx/mechanic2d/asym_elasto_damage_model.cc:589-608; the traction
    ``dot(t*n, delta_u)*ds(0)`` sketched at asym_ufl.py:74-81). The energy
    form of a traction t is -integral t.u dGamma.
    """

    integrand: Callable[[FacetQP], torch.Tensor]
    degree: int
    facets: np.ndarray  # indices into the mesh facet table


def _scalar_det_inv(J):
    """det + inverse of a small square matrix given as nested lists of
    scalars/tensors (closed-form adjugate; no linalg, no arrays).
    J indexed [row][col]; returns (det, inv) with inv[i][j]."""
    n = len(J)
    if n == 1:
        det = J[0][0]
        return det, [[1.0 / det]]
    if n == 2:
        a, b = J[0]
        c, d = J[1]
        det = a * d - b * c
        r = 1.0 / det
        return det, [[d * r, -b * r], [-c * r, a * r]]
    if n == 3:
        a, b, c = J[0]
        d, e, f = J[1]
        g, h, i = J[2]
        A = e * i - f * h
        B = f * g - d * i
        C = d * h - e * g
        det = a * A + b * B + c * C
        r = 1.0 / det
        return det, [
            [A * r, (c * h - b * i) * r, (b * f - c * e) * r],
            [B * r, (a * i - c * g) * r, (c * d - a * f) * r],
            [C * r, (b * g - a * h) * r, (a * e - b * d) * r],
        ]
    raise NotImplementedError(f"{n}x{n} geometry Jacobian")


class EnergyFunctional:
    """Pi(u) = sum_terms integral integrand dX; residual F = dPi/du,
    Jacobian d2Pi/du2.

    Equivalent of the (F, J=derivative(F)) form pair created at
    FEniCSx/...cc:679-685, for hyperelastic-type F (F = DPi).

    ``device``/``dtype``: where the static per-cell and per-facet tables
    live (default CUDA / float32).

    Facet (ds-measure) terms: per term the facet dofmap, vertex
    coordinates and outward unit normals, built on the host in float64 as
    ``tpufem.forms.form`` builds them. The normal is turned outward by the
    owner cell's centroid. A facet reads the dofs of its vertices, and on
    a 2D degree-2 space also its edge dof (``n_nodes + facet id``) with a
    degree-2 interval basis, which ``elements.lagrange`` does not have: a
    facet term on a 2D degree-2 space raises ``NotImplementedError`` there,
    as in the reference. On a 3D degree-2 space the facet reads its vertex
    dofs only, with the degree-1 facet basis (the reference's rule: the
    total load is exact, its split over the dofs is P1's).
    """

    def __init__(
        self,
        space: FunctionSpace,
        terms: Sequence[Term],
        coefficients: Sequence[Coefficient] = (),
        facet_terms: Sequence = (),
        *,
        device=None,
        dtype: torch.dtype = DEFAULT_DTYPE,
    ):
        self.space = space
        self.terms = list(terms)
        self.facet_terms = list(facet_terms)
        self.coefficients = list(coefficients)
        self.device = resolve_device(device)
        self.dtype = dtype
        mesh = space.mesh
        self.geom_element = make_element(mesh.cell_type, 1)
        # static per-cell geometry (host -> device once), cells in the
        # MINOR (last) dimension: every per-cell scalar of the batched
        # kernels is then one contiguous (nc,) vector
        from tpufem_torch.utils.hostops import cells_minor_coords

        self._x_cells = torch.as_tensor(
            cells_minor_coords(mesh.x, mesh.cells), dtype=dtype,
            device=self.device,
        )  # (nvg, gdim, nc)
        vdm = space.vector_dofmap()
        self._vec_dofmap = vdm  # (nc, ndof*bs) host-side (plan building)
        self._vec_dofmap_T = torch.as_tensor(
            np.ascontiguousarray(vdm.T), dtype=torch.int64,
            device=self.device,
        )  # (ndof*bs, nc) -- gather directly into cells-minor layout
        self._coeff_dofmaps_T = {
            c.name: torch.as_tensor(
                np.ascontiguousarray(c.space.vector_dofmap().T),
                dtype=torch.int64, device=self.device,
            )
            for c in self.coefficients
        }
        # tabulations per term (host constants)
        self._tabs = []
        for t in self.terms:
            qpts, qwts = quadrature(mesh.cell_type, t.degree)
            tab = {
                "qw": qwts,
                "N_geom": self.geom_element.tabulate(qpts),  # (nq, nvg)
                "dN_geom": self.geom_element.tabulate_grad(qpts),
                "N_u": space.element.tabulate(qpts),  # (nq, ndof)
                "dN_u": space.element.tabulate_grad(qpts),  # (nq,ndof,dim)
                "N_c": {
                    c.name: c.space.element.tabulate(qpts)
                    for c in self.coefficients
                },
                "dN_c": {
                    c.name: c.space.element.tabulate_grad(qpts)
                    for c in self.coefficients
                },
            }
            self._tabs.append(tab)
        self._facet_static = []  # host tables per (non-empty) facet term
        self._facet_arrays = []  # (dofmap, x_f, nrm) on the device
        if self.facet_terms:
            self._build_facet_tables()

    def _build_facet_tables(self):
        """Facet dofmap, coordinates, normals and tabulations per facet
        term (``tpufem/forms/form.py:198-262``, the same host arithmetic)."""
        from tpufem_torch.mesh.mesh import CELL_INFO
        from tpufem_torch.mesh.topology import build_entities, facet_to_cells

        space = self.space
        mesh = space.mesh
        facets, _ = build_entities(mesh, mesh.dim - 1)
        indptr, cell_ids = facet_to_cells(mesh)
        facet_type = CELL_INFO[mesh.cell_type]["facet"]
        f_el = make_element(facet_type, 1)
        for ft in self.facet_terms:
            fidx = np.asarray(ft.facets, dtype=np.int64)
            if fidx.size == 0:
                continue  # a term over an empty facet set contributes 0
            fverts = facets[fidx]  # (nf, nvf) vertex indices
            x_f = mesh.x[fverts]  # (nf, nvf, gdim)
            # outward normal per facet from the owning cell's centroid
            owner = cell_ids[indptr[fidx]]
            cc = mesh.x[mesh.cells[owner]].mean(axis=1)
            fc = x_f.mean(axis=1)
            if mesh.dim == 2:
                tang = x_f[:, 1] - x_f[:, 0]
                nrm = np.stack([tang[:, 1], -tang[:, 0]], axis=1)
            else:
                nrm = np.cross(x_f[:, 1] - x_f[:, 0], x_f[:, 2] - x_f[:, 0])
            flip = np.sum(nrm * (fc - cc), axis=1) < 0
            nrm[flip] *= -1.0
            nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
            fd = fverts.astype(np.int64)
            if space.element.degree == 2 and mesh.dim == 2:
                # the facet IS an edge: edge dof index = n_nodes + edge id
                fd = np.concatenate([fd, (mesh.n_nodes + fidx)[:, None]],
                                    axis=1)
                f_el_deg = make_element(facet_type, 2)
            else:
                f_el_deg = f_el
            fd_vec = (fd[..., None] * space.bs
                      + np.arange(space.bs)).reshape(len(fidx), -1)
            qpts, qwts = quadrature(facet_type, ft.degree)
            self._facet_static.append(dict(
                term=ft,
                qw=qwts,
                N_u=f_el_deg.tabulate(qpts),  # (nq, ndof_f)
                N_geom=f_el.tabulate(qpts),  # (nq, nvf)
                dN_geom=f_el.tabulate_grad(qpts),  # (nq, nvf, dim-1)
                dofmap=fd_vec.astype(np.int64),  # host copies
                x_f=np.asarray(x_f, np.float64),
                nrm=nrm,
            ))
            self._facet_arrays.append((
                torch.as_tensor(fd_vec.astype(np.int64), device=self.device),
                torch.as_tensor(x_f, dtype=self.dtype, device=self.device),
                torch.as_tensor(nrm, dtype=self.dtype, device=self.device),
            ))

    def _tab_tensors(self, dtype, device):
        """The tabulations as tensors at (dtype, device). Built per call:
        tensors created inside a ``torch.func`` transform belong to that
        transform's level and must not be kept for a later one; the
        tables are a few dozen numbers."""
        def conv(v):
            if isinstance(v, dict):
                return {k: conv(x) for k, x in v.items()}
            return torch.as_tensor(np.asarray(v), dtype=dtype, device=device)

        return [conv(tab) for tab in self._tabs]

    # -- element kernels ---------------------------------------------------

    def element_energy_fn(self) -> Callable:
        """Returns fn(u_e (ndof*bs,), x_e (nvg,gdim), coeff_es dict) -> scalar.

        This single scalar function is what torch.func.grad / hessian
        differentiate -- the analog of the ffcx-generated tabulate_tensor
        bodies (~260-970 C lines each, doc.tex:2322-2325) for *all*
        variants at once.
        """
        space = self.space
        bs = space.bs
        ndof = space.element.ndof
        terms = self.terms
        coeff_bs = {c.name: c.space.bs for c in self.coefficients}
        coeff_ndof = {c.name: c.space.element.ndof for c in self.coefficients}

        def energy(u_e, x_e, coeff_es):
            tabs = self._tab_tensors(u_e.dtype, u_e.device)
            u = u_e.reshape(ndof, bs)
            total = torch.zeros((), dtype=u_e.dtype, device=u_e.device)
            for t, tab in zip(terms, tabs):
                nq = tab["qw"].shape[0]
                for q in range(nq):  # static unroll; nq is tiny (1-8)
                    J = x_e.T @ tab["dN_geom"][q]  # (gdim, dim)
                    detJ = small_det(J)
                    Jinv = small_inv(J)  # (dim, gdim)
                    dN = tab["dN_u"][q] @ Jinv
                    grad_u = u.T @ dN  # (bs, gdim)
                    u_q = tab["N_u"][q] @ u  # (bs,)
                    x_q = tab["N_geom"][q] @ x_e  # (gdim,)
                    cvals = {}
                    cgrads = {}
                    for name, ce in coeff_es.items():
                        cb = coeff_bs[name]
                        cv = ce.reshape(coeff_ndof[name], cb)
                        val = tab["N_c"][name][q] @ cv
                        cvals[name] = val[0] if cb == 1 else val
                        if name in t.needs_coeff_grads:
                            dNc = tab["dN_c"][name][q] @ Jinv
                            cgrads[name] = cv.T @ dNc
                    qp = QP(grad_u, u_q[0] if bs == 1 else u_q, x_q,
                            cvals, cgrads)
                    total = total + (
                        t.integrand(qp) * tab["qw"][q] * torch.abs(detJ)
                    )
            return total

        return energy

    def element_energy_fn_elementwise(self) -> Callable:
        """Scalarized variant of :meth:`element_energy_fn`.

        Same math, but every small contraction (J = x_e^T dN_geom, J^-1,
        reference->physical gradient push, N.u, N_c.c) is unrolled into
        scalar arithmetic with the basis weights as host constants --
        zero entries skipped. Under a cells-minor ``vmap`` every
        intermediate is then a single (n_cells,) vector op instead of a
        batch of micro-matmuls.
        """
        space = self.space
        bs = space.bs
        ndof = space.element.ndof
        gdim = space.mesh.x.shape[1]
        terms = self.terms
        tabs = self._tabs
        coeff_meta = [
            (c.name, c.space.element.ndof, c.space.bs)
            for c in self.coefficients
        ]

        def lin(get, w, zero):
            """sum_i w[i]*get(i) with host-constant weights, zeros skipped."""
            acc = None
            for i, wi in enumerate(w):
                wi = float(wi)
                if wi == 0.0:
                    continue
                term = get(i) if wi == 1.0 else wi * get(i)
                acc = term if acc is None else acc + term
            return zero if acc is None else acc

        def energy(u_e, x_e, coeff_es):
            u = u_e.reshape(ndof, bs)
            zero = torch.zeros((), dtype=u_e.dtype, device=u_e.device)
            total = zero
            for t, tab in zip(terms, tabs):
                nq = tab["qw"].shape[0]
                for q in range(nq):
                    dNg = np.asarray(tab["dN_geom"][q], np.float64)
                    dim = dNg.shape[1]
                    if dim != gdim:
                        raise NotImplementedError(
                            "elementwise path needs volume cells (dim == gdim)"
                        )
                    J = [
                        [
                            lin(lambda v: x_e[v, g], dNg[:, d], zero)
                            for d in range(dim)
                        ]
                        for g in range(gdim)
                    ]
                    detJ, Jinv = _scalar_det_inv(J)
                    # reference gradient of u, then push to physical
                    dNu = np.asarray(tab["dN_u"][q], np.float64)
                    gref = [
                        [lin(lambda v: u[v, c], dNu[:, d], zero)
                         for d in range(dim)]
                        for c in range(bs)
                    ]
                    grad_u = torch.stack(
                        [
                            torch.stack(
                                [
                                    sum(gref[c][d] * Jinv[d][g]
                                        for d in range(dim))
                                    for g in range(gdim)
                                ]
                            )
                            for c in range(bs)
                        ]
                    )
                    Nu = np.asarray(tab["N_u"][q], np.float64)
                    u_q = [lin(lambda v: u[v, c], Nu, zero) for c in range(bs)]
                    Ng = np.asarray(tab["N_geom"][q], np.float64)
                    x_q = torch.stack(
                        [lin(lambda v: x_e[v, g], Ng, zero)
                         for g in range(gdim)]
                    )
                    cvals = {}
                    cgrads = {}
                    for name, ndc, cb in coeff_meta:
                        cv = coeff_es[name].reshape(ndc, cb)
                        Nc = np.asarray(tab["N_c"][name][q], np.float64)
                        vals = [lin(lambda v: cv[v, cc], Nc, zero)
                                for cc in range(cb)]
                        cvals[name] = (vals[0] if cb == 1
                                       else torch.stack(vals))
                        if name in t.needs_coeff_grads:
                            dNc = np.asarray(tab["dN_c"][name][q], np.float64)
                            cgr = [
                                [lin(lambda v: cv[v, cc], dNc[:, d], zero)
                                 for d in range(dim)]
                                for cc in range(cb)
                            ]
                            cgrads[name] = torch.stack(
                                [
                                    torch.stack(
                                        [
                                            sum(cgr[cc][d] * Jinv[d][g]
                                                for d in range(dim))
                                            for g in range(gdim)
                                        ]
                                    )
                                    for cc in range(cb)
                                ]
                            )
                    qp = QP(
                        grad_u, u_q[0] if bs == 1 else torch.stack(u_q),
                        x_q, cvals, cgrads,
                    )
                    w = float(tab["qw"][q])
                    total = total + t.integrand(qp) * (w * torch.abs(detJ))
            return total

        return energy

    def facet_energy_fns(self):
        """Per facet term: (energy(u_f (ndf,), x_f (nvf, gdim), normal
        (gdim,)) -> scalar, dofmap (nf, ndf), x_f (nf, nvf, gdim), normals
        (nf, gdim)), the arrays on the functional's device. ``energy`` is
        a function of one facet, for ``torch.func.vmap`` / ``grad`` /
        ``hessian``; the surface measure is the column norm of the facet
        Jacobian (2D edge) or the norm of the cross product of its two
        columns (3D facet).

        Coefficient fields on facets are not supported: traction terms
        close over constants (as the reference's surface load is a
        Constant t, asym_ufl.py:74-75)."""
        out = []
        bs = self.space.bs
        for blk, arrs in zip(self._facet_static, self._facet_arrays):
            host = (blk["qw"], blk["N_u"], blk["dN_geom"], blk["N_geom"])
            ndof_f = blk["N_u"].shape[1]

            def energy(u_f, x_f, nrm, host=host, ndof_f=ndof_f,
                       term=blk["term"]):
                # the tables as tensors per call (see _tab_tensors)
                qw, N_u, dNg, Ng = (torch.as_tensor(
                    np.asarray(a), dtype=u_f.dtype, device=u_f.device)
                    for a in host)
                u = u_f.reshape(ndof_f, bs)
                total = torch.zeros((), dtype=u_f.dtype, device=u_f.device)
                for q in range(qw.shape[0]):
                    J = x_f.T @ dNg[q]  # (gdim, dim - 1)
                    if J.shape[1] == 1:
                        ds = torch.sqrt(torch.sum(J[:, 0] * J[:, 0]))
                    else:
                        a, b = J[:, 0], J[:, 1]
                        c = torch.stack([a[1] * b[2] - a[2] * b[1],
                                         a[2] * b[0] - a[0] * b[2],
                                         a[0] * b[1] - a[1] * b[0]])
                        ds = torch.sqrt(torch.sum(c * c))
                    u_q = N_u[q] @ u
                    x_q = Ng[q] @ x_f
                    fqp = FacetQP(u_q[0] if bs == 1 else u_q, x_q, nrm, {})
                    total = total + term.integrand(fqp) * qw[q] * ds
                return total

            out.append((energy,) + tuple(arrs))
        return out

    # -- gathered per-cell inputs (cells-minor layout) -----------------------

    def gather(self, u: torch.Tensor):
        """Per-cell dof blocks for u: (ndof*bs, nc)."""
        return u[self._vec_dofmap_T]

    def gather_coeffs(self, coeff_values: Dict[str, torch.Tensor]):
        """Per-cell blocks per coefficient: name -> (ndof_c*bs_c, nc)."""
        return {
            name: coeff_values[name][dm]
            for name, dm in self._coeff_dofmaps_T.items()
        }

    @property
    def x_cells(self):
        """(nvg, gdim, nc) -- cells minor."""
        return self._x_cells

    @property
    def vec_dofmap(self):
        """(nc, ndof*bs) row-major dofmap (host-side plan building)."""
        return self._vec_dofmap

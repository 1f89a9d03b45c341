"""Smoothed-aggregation AMG preconditioner with rigid-body-mode nullspace
(``tpufem.la.amg``).

The reference study rides hypre BoomerAMG with elasticity tuning and
near-nullspace rigid-body modes (FEniCSx/mechanic2d/
asym_elasto_damage_model.cc:720-813, the RBM vectors at :750-798).

- **Set-up on the host** (NumPy/SciPy, once per solver): strength graph on
  the node-block matrix, greedy Vanek aggregation (the native three-phase
  pass, or NumPy rounds of independent-set seeding without the library),
  tentative prolongator from per-aggregate QR of the rigid-body modes,
  Jacobi-smoothed P, Galerkin RAP coarse operators, per-level lambda_max
  estimates, a dense pseudo-inverse of the coarsest operator. The code is
  the reference's, line for line: the same matrix gives the same tables.
- **Apply on the device**: every level operator, prolongator and
  restriction is an ``EllMatrix`` (int32 columns, ``(width, n)`` layout)
  whose product is the assembler's (one ``index_select``, one sum over the
  width: no sparse library, no atomics, bit-reproducible run to run); the
  smoother is ``chebyshev_iterate``; the coarse solve one dense product.

The preconditioner is symmetric positive definite by construction
(symmetric V(nu, nu)-cycle with polynomial smoothing), so plain CG stays
valid.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tpufem_torch.assemble.pattern import EllMatrix
from tpufem_torch.config import INDEX_DTYPE
from tpufem_torch.la.precond import check_matmul_precision, chebyshev_iterate

# =============================================================================
# host-side set-up
# =============================================================================


# Jacobi prolongator-smoothing weight as a fraction of 1/lambda_max(D^-1 A)
# (the classical 4/3 * 1/lmax), and the most levels a hierarchy has
SMOOTH_OMEGA = 4.0 / 3.0
MAX_LEVELS = 12


@dataclasses.dataclass
class AMGOptions:
    """Set-up knobs (defaults tuned for P1/Q1 elasticity).

    theta: strength-of-connection drop tolerance on the node graph
      (|s_ij| >= theta*sqrt(s_ii*s_jj)); 0 keeps all connections
      (Vanek's SA default for elasticity).
    coarse_size: stop coarsening at <= this many dofs; solve dense.
    """

    theta: float = 0.0
    coarse_size: int = 512


def rigid_body_modes(coords: np.ndarray, bs: int,
                     free_mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Near-nullspace B (n_dofs, k) for byVDIM vector fields.

    bs=1 -> constants (k=1); bs=2 -> 2 translations + in-plane rotation
    (k=3, the reference's RBM set, FEniCSx/...cc:750-798); bs=3 -> 3
    translations + 3 rotations (k=6). Rows at Dirichlet dofs are zeroed
    (their matrix rows are identity; coupling them into aggregates would
    pollute the coarse space).
    """
    n_nodes = coords.shape[0]
    n = n_nodes * bs
    x = coords[:, 0] if coords.shape[1] > 0 else np.zeros(n_nodes)
    y = coords[:, 1] if coords.shape[1] > 1 else np.zeros(n_nodes)
    z = coords[:, 2] if coords.shape[1] > 2 else np.zeros(n_nodes)
    # center/scale for conditioning of the per-aggregate QR
    xc = x - x.mean() if n_nodes else x
    yc = y - y.mean() if n_nodes else y
    zc = z - z.mean() if n_nodes else z

    if bs == 1:
        B = np.ones((n, 1))
    elif bs == 2:
        B = np.zeros((n, 3))
        B[0::2, 0] = 1.0
        B[1::2, 1] = 1.0
        B[0::2, 2] = -yc
        B[1::2, 2] = xc
    elif bs == 3:
        B = np.zeros((n, 6))
        for i in range(3):
            B[i::3, i] = 1.0
        B[1::3, 3] = -zc
        B[2::3, 3] = yc
        B[0::3, 4] = zc
        B[2::3, 4] = -xc
        B[0::3, 5] = -yc
        B[1::3, 5] = xc
    else:
        raise ValueError(f"unsupported block size {bs}")
    if free_mask is not None:
        B = B * np.asarray(free_mask, dtype=B.dtype)[:, None]
    return B


def _node_strength_graph(A, bs: int, theta: float):
    """Condense the dof matrix to a node graph (block Frobenius norms),
    drop weak couplings, remove the diagonal. Returns symmetric CSR."""
    import scipy.sparse as sp

    coo = A.tocoo()
    n = A.shape[0] // bs
    ni = coo.row // bs
    nj = coo.col // bs
    S = sp.coo_matrix((coo.data * coo.data, (ni, nj)), shape=(n, n)).tocsr()
    S.sum_duplicates()
    S.data = np.sqrt(S.data)
    if theta > 0.0:
        d = S.diagonal()
        coo = S.tocoo()
        scale = np.sqrt(np.abs(d[coo.row] * d[coo.col]))
        keep = np.abs(coo.data) >= theta * scale
        S = sp.coo_matrix(
            (coo.data[keep], (coo.row[keep], coo.col[keep])), shape=(n, n)
        ).tocsr()
    S.setdiag(0.0)
    S.eliminate_zeros()
    # symmetrize (strength may be asymmetric after filtering)
    S = S.maximum(S.T).tocsr()
    return S


def aggregate(S) -> Tuple[np.ndarray, int]:
    """Greedy Vanek aggregation. S: symmetric CSR strength graph with
    zero diagonal. Returns (agg[node] -> aggregate id, count).

    Uses the native C++ three-phase Vanek pass (``amg_aggregate`` of
    ``csrc/tpufem_native.cpp``) when the library builds; otherwise the
    vectorized NumPy rounds of independent-set seeding +
    strongest-neighbor attachment below. The two give different (each
    valid) aggregations."""
    from tpufem_torch import native

    res = native.amg_aggregate(S.indptr, S.indices, S.data)
    if res is not None:
        return res
    n = S.shape[0]
    indptr, indices, data = S.indptr, S.indices, S.data
    deg = np.diff(indptr)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    cols = indices.astype(np.int64)

    agg = np.full(n, -1, dtype=np.int64)
    n_agg = 0
    for _ in range(200):  # safety bound; converges in a handful of rounds
        un = agg < 0
        if not un.any():
            break
        # nodes with at least one aggregated neighbor
        has_aggd = np.zeros(n, dtype=bool)
        e_to_aggd = agg[cols] >= 0
        has_aggd[rows[e_to_aggd]] = True
        cand = un & ~has_aggd
        if cand.any():
            # deterministic independent set: drop the larger endpoint of
            # every candidate-candidate edge
            sel = cand.copy()
            both = cand[rows] & cand[cols]
            sel[rows[both & (cols < rows)]] = False
            # seed aggregates: seed + its unaggregated neighbors
            seeds = np.nonzero(sel)[0]
            ids = np.arange(len(seeds), dtype=np.int64) + n_agg
            agg[seeds] = ids
            seed_id = np.full(n, -1, dtype=np.int64)
            seed_id[seeds] = ids
            # edges from a seed to an unaggregated node: first seed wins
            e = (seed_id[rows] >= 0) & (agg[cols] < 0)
            if e.any():
                tgt = cols[e]
                src = seed_id[rows[e]]
                order = np.lexsort((src, tgt))
                tgt, src = tgt[order], src[order]
                first = np.ones(len(tgt), dtype=bool)
                first[1:] = tgt[1:] != tgt[:-1]
                agg[tgt[first]] = src[first]
            n_agg += len(seeds)
        else:
            # attach round: join the strongest aggregated neighbor
            e = un[rows] & (agg[cols] >= 0)
            src, tgt, w = rows[e], agg[cols[e]], data[e]
            order = np.lexsort((-w, src))
            src, tgt = src[order], tgt[order]
            first = np.ones(len(src), dtype=bool)
            first[1:] = src[1:] != src[:-1]
            agg[src[first]] = tgt[first]
    if not (agg >= 0).all():
        raise RuntimeError("aggregation did not cover all nodes")
    return agg, n_agg


def _tentative_prolongator(agg: np.ndarray, n_agg: int, B: np.ndarray,
                           bs: int):
    """P_t (n_dofs x n_agg*k) from per-aggregate QR of the near-nullspace.

    Within each aggregate a, P_t[dofs(a), a*k:(a+1)*k] = Q where
    B[dofs(a)] = Q R; the coarse-level nullspace rows become R."""
    import scipy.sparse as sp

    n_dofs, k = B.shape
    nc = n_agg * k
    order = np.argsort(agg, kind="stable")
    counts = np.bincount(agg, minlength=n_agg)
    starts = np.zeros(n_agg + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])

    Bc = np.zeros((nc, k))
    P_rows = np.empty(n_dofs * k, dtype=np.int64)
    P_cols = np.empty(n_dofs * k, dtype=np.int64)
    P_vals = np.empty(n_dofs * k)
    nnz = 0
    # batch aggregates by size so the QR runs stacked
    for size in np.unique(counts):
        if size == 0:
            continue
        which = np.nonzero(counts == size)[0]
        # (m, size) node ids per aggregate
        nodes = order[starts[which][:, None] + np.arange(size)[None, :]]
        # (m, size*bs) dof ids (byVDIM)
        dofs = (nodes[:, :, None] * bs + np.arange(bs)[None, None, :]).reshape(
            len(which), size * bs
        )
        Bloc = B[dofs]  # (m, size*bs, k)
        Q, R = np.linalg.qr(Bloc)  # Q: (m, d, r), R: (m, r, k), r=min(d,k)
        r = Q.shape[2]
        # scrub near-zero columns (rank-deficient aggregates, e.g. a
        # fully-Dirichlet aggregate whose B rows were zeroed)
        col_norm = np.abs(R[:, np.arange(r), np.arange(r)])
        dead = col_norm < 1e-12
        Q = np.where(dead[:, None, :], 0.0, Q)
        Rz = np.where(dead[:, :, None], 0.0, R)
        Bc[(which[:, None] * k + np.arange(r)[None, :]).ravel()] = Rz.reshape(
            -1, k
        )
        m, d = dofs.shape
        rr = np.broadcast_to(dofs[:, :, None], (m, d, r))
        cc = np.broadcast_to(
            (which[:, None] * k + np.arange(r)[None, :])[:, None, :], (m, d, r)
        )
        cnt = m * d * r
        P_rows[nnz: nnz + cnt] = rr.ravel()
        P_cols[nnz: nnz + cnt] = cc.ravel()
        P_vals[nnz: nnz + cnt] = Q.ravel()
        nnz += cnt
    P = sp.coo_matrix(
        (P_vals[:nnz], (P_rows[:nnz], P_cols[:nnz])), shape=(n_dofs, nc)
    ).tocsr()
    P.eliminate_zeros()
    return P, Bc


def _power_lambda_max(A, inv_d: np.ndarray, iters: int = 25) -> float:
    """lambda_max(D^-1 A) by deterministic power iteration (host)."""
    n = A.shape[0]
    v = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
    v /= np.linalg.norm(v)
    lam = 1.0
    for _ in range(iters):
        w = inv_d * (A @ v)
        nw = np.linalg.norm(w)
        if nw == 0.0:
            return 1.0
        lam = float(v @ w)
        v = w / nw
    return max(lam, 1e-30)


def _csr_to_ell(A) -> Tuple[np.ndarray, np.ndarray]:
    """CSR -> padded ELL in the (width, n_rows) rows-minor layout of
    ``EllMatrix`` (pad column 0, value 0; int32 columns)."""
    n = A.shape[0]
    counts = np.diff(A.indptr)
    w = int(counts.max()) if len(counts) and counts.max() > 0 else 1
    cols = np.zeros((n, w), dtype=INDEX_DTYPE)
    vals = np.zeros((n, w), dtype=A.data.dtype if A.nnz else np.float64)
    rows_of = np.repeat(np.arange(n, dtype=np.int64), counts)
    within = np.arange(A.nnz, dtype=np.int64) - np.repeat(
        A.indptr[:-1].astype(np.int64), counts
    )
    cols[rows_of, within] = A.indices
    vals[rows_of, within] = A.data
    return np.ascontiguousarray(cols.T), np.ascontiguousarray(vals.T)


# =============================================================================
# the hierarchy (tensors on one device)
# =============================================================================


def _ell_to(m: EllMatrix, device) -> EllMatrix:
    return EllMatrix(n_rows=m.n_rows, cols=m.cols.to(device),
                     vals=m.vals.to(device))


class AMGLevel(NamedTuple):
    a: EllMatrix  # (n, n) level operator
    inv_d: torch.Tensor  # (n,) 1/diag (guarded)
    p: EllMatrix  # (n, nc) prolongator rows (index the coarse vector)
    r: EllMatrix  # (nc, n) restriction rows (index the fine vector)
    lmax: float  # lambda_max(D^-1 A) estimate, rounded to the level dtype

    def to(self, device) -> "AMGLevel":
        return AMGLevel(a=_ell_to(self.a, device),
                        inv_d=self.inv_d.to(device),
                        p=_ell_to(self.p, device), r=_ell_to(self.r, device),
                        lmax=self.lmax)


class AMGHierarchy(NamedTuple):
    levels: Tuple[AMGLevel, ...]
    coarse_inv: torch.Tensor  # (nc, nc) dense pseudo-inverse

    @property
    def n_levels(self) -> int:
        return len(self.levels) + 1

    def to(self, device) -> "AMGHierarchy":
        """The same hierarchy with every tensor on ``device``."""
        return AMGHierarchy(levels=tuple(L.to(device) for L in self.levels),
                            coarse_inv=self.coarse_inv.to(device))

    def nbytes(self) -> int:
        """Bytes of every tensor of the hierarchy."""
        ts = [self.coarse_inv]
        for L in self.levels:
            ts += [L.a.cols, L.a.vals, L.inv_d, L.p.cols, L.p.vals,
                   L.r.cols, L.r.vals]
        return sum(t.numel() * t.element_size() for t in ts)

    def shapes(self) -> list:
        """Per level: rows and the ELL widths of A, P and R; then the
        dense coarse size."""
        out = [dict(n=L.a.n_rows, width_a=int(L.a.cols.shape[0]),
                    width_p=int(L.p.cols.shape[0]),
                    width_r=int(L.r.cols.shape[0])) for L in self.levels]
        out.append(dict(coarse=int(self.coarse_inv.shape[0])))
        return out


def _numpy_dtype(dtype):
    return None if dtype is None else torch.empty(0, dtype=dtype).numpy().dtype


def build_hierarchy(
    A,
    coords: np.ndarray,
    bs: int,
    *,
    free_mask: Optional[np.ndarray] = None,
    B: Optional[np.ndarray] = None,
    opts: Optional[AMGOptions] = None,
    dtype: Optional[torch.dtype] = None,
) -> AMGHierarchy:
    """Host-side SA-AMG set-up from a SciPy sparse matrix.

    A: (n, n) SPD fine operator (Dirichlet rows/cols already eliminated
    to identity, as Assembler.matrix produces). coords: (n_nodes, gdim)
    node coordinates for the RBMs. free_mask: per *scalar dof* 1/0 free
    mask (bc dofs zeroed out of the nullspace). ``dtype``: of the level
    values (the matrix's own without it). The tensors stay on the host;
    ``AMGHierarchy.to`` puts them on the card.
    """
    import scipy.sparse as sp

    opts = opts or AMGOptions()
    A = sp.csr_matrix(A)
    if B is None:
        fm = None
        if free_mask is not None:
            fm = np.asarray(free_mask, dtype=np.float64)
        B = rigid_body_modes(np.asarray(coords), bs, fm)
    np_dtype = _numpy_dtype(dtype)

    def cast(x):
        return x if np_dtype is None else x.astype(np_dtype)

    def tensor(x):
        return torch.as_tensor(np.ascontiguousarray(x))

    def ell(M, n_rows):
        cols, vals = _csr_to_ell(M)
        return EllMatrix(n_rows=n_rows, cols=tensor(cols),
                         vals=tensor(cast(vals)))

    levels = []
    level_bs = bs
    theta = opts.theta
    while (
        A.shape[0] > opts.coarse_size and len(levels) < MAX_LEVELS - 1
    ):
        diag = A.diagonal()
        inv_d = np.where(diag != 0.0, 1.0 / np.where(diag == 0.0, 1.0, diag),
                         1.0)
        S = _node_strength_graph(A, level_bs, theta)
        agg, n_agg = aggregate(S)
        if n_agg * B.shape[1] >= A.shape[0]:
            break  # no coarsening achieved; stop here
        Pt, Bc = _tentative_prolongator(agg, n_agg, B, level_bs)
        lmax = _power_lambda_max(A, inv_d)
        # Jacobi-smoothed prolongator: P = (I - omega D^-1 A) P_t
        omega = SMOOTH_OMEGA / lmax
        Dinv = sp.diags(inv_d)
        P = (Pt - omega * (Dinv @ (A @ Pt))).tocsr()
        P.eliminate_zeros()
        R = P.T.tocsr()
        Ac = (R @ A @ P).tocsr()
        Ac.sum_duplicates()

        levels.append(AMGLevel(
            a=ell(A, A.shape[0]), inv_d=tensor(cast(inv_d)),
            p=ell(P, P.shape[0]), r=ell(R, R.shape[0]),
            lmax=float(cast(np.asarray(lmax))),
        ))
        A = Ac
        B = Bc
        # coarse levels: one "node" per aggregate, block size = k
        level_bs = B.shape[1]
        theta = theta * 0.5

    Ad = A.toarray()
    # guard exactly-zero rows (dead coarse dofs from rank-deficient
    # aggregates) so the dense solve stays well-posed
    zero_rows = np.abs(Ad).sum(axis=1) == 0.0
    Ad[zero_rows, zero_rows] = 1.0
    coarse_inv = np.linalg.pinv(Ad, rcond=1e-12, hermitian=True)
    return AMGHierarchy(levels=tuple(levels),
                        coarse_inv=tensor(cast(coarse_inv)))


def assembler_hierarchy(asm, A, cfg, *, dtype) -> AMGHierarchy:
    """The host hierarchy the solvers build: of ``A`` (a SciPy copy of an
    ``Assembler.matrix`` of ``asm``), with the rigid-body modes of
    ``asm``'s space, its Dirichlet dofs zeroed, and the strength drop
    tolerance and coarse size of ``cfg`` (a ``SolverConfig``)."""
    V = asm.space
    return build_hierarchy(
        A, V.dof_coords, V.bs,
        free_mask=asm.free_mask(torch.float64).cpu().numpy(),
        opts=AMGOptions(theta=cfg.amg_theta, coarse_size=cfg.amg_coarse_size),
        dtype=dtype)


def ell_to_scipy(mat: EllMatrix):
    """EllMatrix -> SciPy CSR (host; one copy off the device)."""
    import scipy.sparse as sp

    cols = mat.cols.cpu().numpy()  # (w, n)
    vals = mat.vals.cpu().numpy()
    w, n = cols.shape
    rows = np.broadcast_to(np.arange(n, dtype=np.int64)[None, :], (w, n))
    A = sp.coo_matrix(
        (vals.ravel(), (rows.ravel(), cols.ravel())), shape=(n, n)
    ).tocsr()
    A.sum_duplicates()
    A.eliminate_zeros()
    return A


# =============================================================================
# device-side apply
# =============================================================================


def vcycle(hier: AMGHierarchy, b: torch.Tensor, *,
           degree: int = 2) -> torch.Tensor:
    """One symmetric V(degree, degree)-cycle: Chebyshev pre-smoothing from
    zero, the residual restricted, the coarse correction prolonged,
    Chebyshev post-smoothing; the coarsest level one dense product. A
    level applies its operator 2 * degree times."""

    def level(i, b):
        if i == len(hier.levels):
            check_matmul_precision(hier.coarse_inv)
            return hier.coarse_inv @ b
        L = hier.levels[i]
        x = chebyshev_iterate(L.a.matvec, L.inv_d, L.lmax, b, None,
                              degree=degree)
        res = b - L.a.matvec(x)
        xc = level(i + 1, L.r.matvec(res))
        x = x + L.p.matvec(xc)
        return chebyshev_iterate(L.a.matvec, L.inv_d, L.lmax, b, x,
                                 degree=degree)

    return level(0, b)


def amg_preconditioner(hier: AMGHierarchy, *, degree: int = 2) -> Callable:
    """M(r) ~= A^-1 r as one V-cycle (SPD; safe inside plain CG)."""

    def M(r):
        return vcycle(hier, r, degree=degree)

    return M

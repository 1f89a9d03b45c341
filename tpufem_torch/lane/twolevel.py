"""Two-level (lattice-coarse) preconditioner for the lane engine.

The unstructured analog of the reference study's BoomerAMG role
(FEniCSx/mechanic2d/asym_elasto_damage_model.cc:720-813): instead of an
algebraic hierarchy of sparse operators, the coarse space is a
*structured lattice* over the mesh's bounding box. Then

- restriction / prolongation are bilinear-interpolation quadruples,
  applied with the weighted lane kernel ``lane_gather_weighted`` (K5)
  and a one-hot column selector (a plain matrix product),
- the coarse problem is rediscretized on the lattice and solved with one
  geometric-MG V-cycle (``structured.mg2d``: stored slice stencils),
- fine-level smoothing is Chebyshev on the lane tangent.

The cycle is symmetric (Chebyshev pre/post + exact-adjoint transfers in
the owned-weighted inner product), so plain CG stays valid. Coarse
coefficient fields are nearest-neighbour samples of the fine fields --
a preconditioner-grade approximation, not a discretization claim.

The host tables are built exactly as ``tpufem.lane.twolevel`` builds
them (NumPy, field-exact). Not ported (each raises
``NotImplementedError`` naming its ROADMAP.md item): the on-disk artifact
cache, the sharded build and its hooks, the cross-device coarse
reduction and rigid-body deflation of :func:`precondition_with`.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from tpufem_torch.la.precond import (check_matmul_precision,
                                     chebyshev_iterate, inverse_diagonal,
                                     power_lambda_max)
from tpufem_torch.lane.kernels import lane_gather_weighted
from tpufem_torch.lane.plan import N_LANES

_SHARDED = ("the sharded two-level build is not ported "
            "(ROADMAP.md: distribution, lane/sharded.py)")


def _round_up(x, m):
    return -(-int(x) // m) * m


class TwoLevelData(NamedTuple):
    # transfers
    S: torch.Tensor  # (ncx+1, SC*128) one-hot column selector
    p_starts: torch.Tensor  # (G,)
    p_idx: torch.Tensor  # (G, 4, wg, 128) into the view window
    p_wts: torch.Tensor
    r_starts: torch.Tensor  # (Gc,)
    r_idx: torch.Tensor  # (Gc, VR, Kc, 128) into fine-row windows
    r_wts: torch.Tensor
    # teleported-copy slots excluded from the windowed prolong;
    # refreshed from their owner slot instead (flat row*128+lane ids)
    o_dst: torch.Tensor  # (n_outlier,)
    o_src: torch.Tensor  # (n_outlier,)
    # fine smoother
    inv_d: torch.Tensor  # (bs, R, 128)
    lmax: float
    # coarse solve (geometric MG on the lattice)
    mg_data: object  # mg2d.MGData
    coarse_free: torch.Tensor  # (bs, ncy+1, ncx+1)


class TwoLevelStatic(NamedTuple):
    SC: int
    WRp: int
    WRr: int
    Kc: int
    ncx: int
    ncy: int
    Rv: int  # padded view rows = Gc*Kc
    degree: int


def rigid_body_modes_lane(eng, *, center=None, scale=None, free=None):
    raise NotImplementedError(
        "rigid_body_modes_lane (deflation of the distributed two-level "
        "cycle) is not ported (ROADMAP.md: distribution, lane/sharded.py)")


def _sample_coarse_fields(functional, mesh, free_flat, fine_coeffs, *,
                          x0, y0, hx, hy, ncx, ncy, bs):
    """HOST stage of the coarse build: nearest-neighbour-sample the fine
    coefficient fields and the free mask onto the lattice (pure NumPy and
    SciPy)."""
    from scipy.spatial import cKDTree

    field_kinds = {}
    coarse_fields = {}
    gx = x0 + np.arange(ncx + 1) * hx
    gy = y0 + np.arange(ncy + 1) * hy
    GX, GY = np.meshgrid(gx, gy, indexing="xy")
    lat_pts = np.stack([GX.ravel(), GY.ravel()], axis=1)
    node_tree = cKDTree(mesh.x[:, :2])
    inear = None
    cell_tree = None
    for c in functional.coefficients:
        vals = fine_coeffs[c.name]
        if isinstance(vals, torch.Tensor):
            vals = vals.detach().cpu().numpy()
        vals = np.asarray(vals)
        if c.space.element.degree == 0:
            if cell_tree is None:
                from tpufem_torch.utils.hostops import cell_centroids
                cent = cell_centroids(mesh.x, mesh.cells)[:, :2]
                cell_tree = cKDTree(cent)
            # centroids of the two lattice triangles per cell
            cyx = np.stack(
                [GX[:-1, :-1].ravel(), GY[:-1, :-1].ravel()], axis=1
            )
            lo_c = cyx + np.array([2 * hx / 3, hy / 3])
            up_c = cyx + np.array([hx / 3, 2 * hy / 3])
            _, ilo = cell_tree.query(lo_c)
            _, iup = cell_tree.query(up_c)
            arr = np.stack(
                [vals[ilo].reshape(ncy, ncx), vals[iup].reshape(ncy, ncx)]
            )
            field_kinds[c.name] = "cell"
            coarse_fields[c.name] = arr
        else:
            if inear is None:
                _, inear = node_tree.query(lat_pts)
            field_kinds[c.name] = "vertex"
            coarse_fields[c.name] = vals[inear].reshape(ncy + 1, ncx + 1)

    # coarse free mask: a lattice node is constrained when its nearest
    # fine node is (per component)
    if inear is None:
        _, inear = node_tree.query(lat_pts)
    cf = np.asarray(free_flat).reshape(-1, bs)[inear].T.reshape(
        bs, ncy + 1, ncx + 1
    )
    coarse_free = (cf > 0.5).astype(np.float64)
    return field_kinds, coarse_fields, coarse_free


def lattice_grid(functional, bs, field_kinds, *, hx, hy, ncx, ncy):
    """The coarse lattice discretization of ``functional``'s (single)
    cell term."""
    from tpufem_torch.forms.form import QP
    from tpufem_torch.structured.grid2d import StructuredGrid2D

    term = functional.terms[0]

    def density(grad_u, cvals):
        return term.integrand(QP(grad_u, None, None, cvals, {}))

    return StructuredGrid2D(
        nx=ncx, ny=ncy, hx=hx, hy=hy, bs=bs,
        energy_density=density, field_kinds=dict(field_kinds),
    )


def _coarse_mg_from_fields(functional, bs, field_kinds, coarse_fields,
                           coarse_free, *, hx, hy, ncx, ncy,
                           device=None, dtype=torch.float64):
    """DEVICE stage: rediscretize on the lattice (linearized at u_c = 0
    with the sampled coefficient fields) and build the lattice-MG
    hierarchy."""
    from tpufem_torch.structured import mg2d

    grid = lattice_grid(functional, bs, field_kinds, hx=hx, hy=hy,
                        ncx=ncx, ncy=ncy)
    coarse_fields = {k: torch.as_tensor(np.asarray(v), dtype=dtype,
                                        device=device)
                     for k, v in coarse_fields.items()}
    coarse_free = torch.as_tensor(np.asarray(coarse_free), dtype=dtype,
                                  device=device)
    u_c = torch.zeros((bs, ncy + 1, ncx + 1), dtype=dtype, device=device)
    _, mg_data = mg2d.build_mg2d(grid, u_c, coarse_fields, coarse_free)
    return mg_data, coarse_free


def _build_coarse(functional, mesh, bs, free_flat, fine_coeffs, *,
                  x0, y0, hx, hy, ncx, ncy, device=None,
                  dtype=torch.float64):
    """Coarse lattice rediscretization of ``functional`` + lattice-MG
    hierarchy: coefficient fields nearest-neighbour-sampled from
    ``fine_coeffs`` onto the (ncx, ncy) lattice over [x0,..]x[y0,..],
    operator linearized at u_c = 0, free mask from the nearest fine
    node's ``free_flat``. Returns (mg_data, coarse_free)."""
    field_kinds, coarse_fields, coarse_free = _sample_coarse_fields(
        functional, mesh, free_flat, fine_coeffs,
        x0=x0, y0=y0, hx=hx, hy=hy, ncx=ncx, ncy=ncy, bs=bs,
    )
    return _coarse_mg_from_fields(
        functional, bs, field_kinds, coarse_fields, coarse_free,
        hx=hx, hy=hy, ncx=ncx, ncy=ncy, device=device, dtype=dtype,
    )


def transfer_tables(plan, *, x0, y0, hx, hy, ncx, ncy):
    """The host transfer tables of the two-level cycle (NumPy, exactly
    the reference's): the one-hot column selector S, the prolongation
    plan (p_starts, p_idx, p_wts), the restriction plan (r_starts,
    r_idx, r_wts), the owner-refresh table (o_dst, o_src) of excluded
    teleported-copy slots, and the static dims (SC, WRp, WRr, Kc, Rv)."""
    p = plan
    # --- per-lane coarse-column sets + one-hot selector ----------------------
    lo = p.strip_x[:, 0] - hx
    hi = p.strip_x[:, 1] + hx
    ix_min = np.clip(np.floor((lo - x0) / hx).astype(np.int64), 0, ncx)
    ix_max = np.clip(np.ceil((hi - x0) / hx).astype(np.int64), 0, ncx)
    SC = int((ix_max - ix_min + 1).max())
    cols = np.minimum(ix_min[:, None] + np.arange(SC)[None, :], ncx)
    S = np.zeros((ncx + 1, SC * N_LANES), dtype=np.float64)
    S[cols.T.reshape(-1), np.arange(SC * N_LANES)] = 1.0
    # note: clipped duplicate columns create duplicate view copies; the
    # R plan writes each triple to exactly one slot so sums stay exact.

    # --- interpolation weights per fine slot ----------------------------------
    sx, sy = p.slot_x, p.slot_y  # (R, 128), nan at padding
    valid = np.isfinite(sx)
    fx = np.clip((np.nan_to_num(sx) - x0) / hx, 0, ncx - 1e-12)
    fy = np.clip((np.nan_to_num(sy) - y0) / hy, 0, ncy - 1e-12)
    ix = fx.astype(np.int64)
    iy = fy.astype(np.int64)
    tx = fx - ix
    ty = fy - iy
    lane_grid = np.broadcast_to(np.arange(N_LANES)[None, :], sx.shape)
    # teleported cells (plan._spill_pass stage 2) may place a copy slot in
    # a lane/bin far from the node's position; interpolating it in place
    # would blow the per-lane column set SC and the row window WRp. Such
    # slots are left out of the windowed plan and refreshed from their
    # owner slot after the windowed prolong (o_dst/o_src below). Owned
    # slots always lie inside their strip.
    pcx = ix - ix_min[lane_grid]
    ok = valid & (pcx >= 0) & (pcx + 1 < SC)
    # view row of parent (a, b): (iy+b)*SC + (ix+a - ix_min[lane])
    parents = []  # (view_row (R,128), weight (R,128)) x4
    for b in (0, 1):
        for a in (0, 1):
            pc = np.clip(ix + a - ix_min[lane_grid], 0, SC - 1)
            vrow = (iy + b) * SC + pc
            wab = (np.where(a == 1, tx, 1 - tx)
                   * np.where(b == 1, ty, 1 - ty))
            parents.append((vrow, np.where(ok, wab, 0.0)))

    G, wg = p.G, p.wg
    vrows = np.stack([pr[0] for pr in parents])  # (4, R, 128)
    # y-direction outliers: copies whose parent rows fall far outside the
    # OWNED rows of their bin would inflate WRp the same way
    own_bin = np.asarray(p.owned_mask).reshape(G, wg, N_LANES)
    vr_b = vrows.reshape(4, G, wg, N_LANES)
    big_v = (ncy + 2) * SC + 10
    o_lo = np.where(own_bin[None], vr_b, big_v).min(axis=(0, 2, 3))
    o_hi = np.where(own_bin[None], vr_b, -1).max(axis=(0, 2, 3))
    o_lo = np.where(o_lo >= big_v, 0, o_lo)  # (G,)
    margin = 2 * SC
    vmin = vrows.min(axis=0)
    vmax = vrows.max(axis=0)
    glo = np.repeat(o_lo, wg).reshape(G * wg)[:, None] - margin
    ghi = np.repeat(o_hi, wg).reshape(G * wg)[:, None] + margin
    ok &= (vmin >= glo) & (vmax <= ghi)
    parents = [(v, np.where(ok, w, 0.0)) for (v, w) in parents]

    # --- P plan (fine bins -> view windows) ------------------------------------
    val_bin = np.broadcast_to(ok, vrows.shape[1:]).reshape(G, wg, N_LANES)
    big = (ncy + 1) * SC + 10
    masked = np.where(val_bin[None], vr_b, big)
    starts_p = masked.min(axis=(0, 2, 3))  # (G,)
    starts_p = np.where(starts_p >= big, 0, starts_p)
    masked_hi = np.where(val_bin[None], vr_b, -1)
    span = masked_hi.max(axis=(0, 2, 3)) - starts_p + 1
    WRp = _round_up(max(int(span.max()), 8), 8)
    Rv_needed = (ncy + 1) * SC
    Kc = 16
    Gc = -(-Rv_needed // Kc)
    Rv = Gc * Kc
    starts_p = np.minimum(starts_p, max(Rv - WRp, 0)).astype(np.int32)
    p_idx = np.where(
        val_bin[None],
        vr_b - starts_p[None, :, None, None],
        -1,
    ).astype(np.int8 if WRp < 127 else np.int32)
    p_idx = np.ascontiguousarray(p_idx.transpose(1, 0, 2, 3))  # (G,4,wg,128)
    p_wts = np.stack(
        [pr[1].reshape(G, wg, N_LANES) for pr in parents], axis=1
    )  # (G, 4, wg, 128)

    # --- R plan (coarse view bins -> fine-row windows) --------------------------
    # owned fine slots only (each node counted once)
    owned = np.asarray(p.owned_mask).astype(bool)
    fine_rows = np.broadcast_to(np.arange(p.R)[:, None], owned.shape)
    tr_v, tr_lane, tr_frow, tr_w = [], [], [], []
    for (vrow, w) in parents:
        sel = owned & (w > 0)
        tr_v.append(vrow[sel])
        tr_lane.append(lane_grid[sel])
        tr_frow.append(fine_rows[sel])
        tr_w.append(w[sel])
    tr_v = np.concatenate(tr_v)
    tr_lane = np.concatenate(tr_lane)
    tr_frow = np.concatenate(tr_frow)
    tr_w = np.concatenate(tr_w)
    # rank within (view_row, lane)
    key = tr_v * N_LANES + tr_lane
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    first = np.searchsorted(key_s, key_s)
    rank = np.arange(len(key_s)) - first
    VR = _round_up(max(int(rank.max()) + 1 if len(rank) else 1, 1), 1)
    v_s, lane_s, frow_s, w_s = (
        tr_v[order], tr_lane[order], tr_frow[order], tr_w[order]
    )
    # fine-row window per coarse bin gc = view rows [gc*Kc, (gc+1)*Kc)
    gc_of = v_s // Kc
    r_start = np.full(Gc, p.R, dtype=np.int64)
    r_end = np.zeros(Gc, dtype=np.int64)
    np.minimum.at(r_start, gc_of, frow_s)
    np.maximum.at(r_end, gc_of, frow_s)
    r_start = np.where(r_start >= p.R, 0, r_start)
    WRr = _round_up(max(int((r_end - r_start + 1).max()), 8), 8)
    r_start = np.minimum(r_start, max(p.R - WRr, 0)).astype(np.int32)
    ridt = np.int8 if WRr < 127 else np.int32
    r_idx = np.full((Gc, VR, Kc, N_LANES), -1, dtype=ridt)
    r_wts = np.zeros((Gc, VR, Kc, N_LANES))
    r_idx[gc_of, rank, v_s % Kc, lane_s] = (
        frow_s - r_start[gc_of]
    ).astype(ridt)
    r_wts[gc_of, rank, v_s % Kc, lane_s] = w_s

    # --- owner-refresh table for excluded (teleported-copy) slots -------------
    out_mask = valid & ~ok
    if out_mask.any():
        dst_key = (
            np.asarray(p.copy_dst_rows, np.int64) * N_LANES
            + np.asarray(p.copy_dst_lanes, np.int64)
        )
        src_key = (
            np.asarray(p.copy_src_rows, np.int64) * N_LANES
            + np.asarray(p.copy_src_lanes, np.int64)
        )
        o_flat = np.nonzero(out_mask.ravel())[0]
        sorter = np.argsort(dst_key, kind="stable")
        pos = np.searchsorted(dst_key[sorter], o_flat)
        idx = sorter[np.clip(pos, 0, len(sorter) - 1)]
        if not (dst_key[idx] == o_flat).all():
            raise AssertionError(
                "excluded two-level slot is not a copy slot"
            )
        o_dst = o_flat.astype(np.int32)
        o_src = src_key[idx].astype(np.int32)
    else:
        o_dst = np.zeros(0, np.int32)
        o_src = np.zeros(0, np.int32)
    tables = dict(S=S, p_starts=starts_p, p_idx=p_idx, p_wts=p_wts,
                  r_starts=np.ascontiguousarray(r_start), r_idx=r_idx,
                  r_wts=r_wts, o_dst=o_dst, o_src=o_src)
    dims = dict(SC=SC, WRp=WRp, WRr=WRr, Kc=Kc, Rv=Rv)
    return tables, dims


def upload_tables(eng, tables):
    """Host transfer tables -> device tensors: weights and the selector
    in the engine's float dtype (once, not at every application),
    indices as built, the owner-refresh ids as int64."""
    out = {}
    for k, v in tables.items():
        v = np.asarray(v)
        if k in ("S", "p_wts", "r_wts"):
            out[k] = eng._store(v)
        elif k in ("o_dst", "o_src"):
            out[k] = torch.as_tensor(v.astype(np.int64), device=eng.device)
        else:
            out[k] = torch.as_tensor(np.ascontiguousarray(v),
                                     device=eng.device)
    return out


def build_twolevel_geo(eng, fine_coeffs, *, nc=None, degree=2,
                       lattice=None, coarse=None, owned=None, force=None):
    """Set-up of everything state-INDEPENDENT: transfer tables, one-hot
    selector, coarse lattice fields and operator (linearized at u_c = 0
    with the frozen coefficient fields) and the lattice-MG hierarchy.
    Build once per solve; the per-Newton-step part is
    :func:`refresh_twolevel`.

    ``fine_coeffs``: dict name -> flat fine coefficient vector (for
    lattice sampling). ``nc``: lattice cells per side (default ~ the
    mesh's own resolution, sqrt(n_nodes)/2 rounded to even). The tables
    and the lattice-MG hierarchy live in the engine's dtype. The
    sharded-build hooks (``lattice``, ``coarse``, ``owned``, ``force``)
    and the artifact cache (``TPUFEM_ARTIFACT_CACHE``) are not ported and
    raise."""
    if any(h is not None for h in (lattice, coarse, owned, force)):
        raise NotImplementedError(
            "build_twolevel_geo(lattice=, coarse=, owned=, force=): "
            + _SHARDED)
    if os.environ.get("TPUFEM_ARTIFACT_CACHE"):
        raise NotImplementedError(
            "TPUFEM_ARTIFACT_CACHE is set, but the on-disk artifact cache "
            "of the two-level build is not ported (ROADMAP.md: remaining "
            "modules, utils/artifacts.py); unset it")
    p = eng.plan
    bs = eng.bs
    mesh = eng.space.mesh
    x = mesh.x
    x0, y0 = x[:, 0].min(), x[:, 1].min()
    x1, y1 = x[:, 0].max(), x[:, 1].max()
    if nc is None:
        nc = max(8, _round_up(int(np.sqrt(p.n_nodes)) // 2, 2))
    ncx = ncy = int(nc)
    hx = (x1 - x0) / ncx
    hy = (y1 - y0) / ncy

    tables, dims = transfer_tables(p, x0=x0, y0=y0, hx=hx, hy=hy,
                                   ncx=ncx, ncy=ncy)
    mg_data, coarse_free = _build_coarse(
        eng.functional, mesh, bs, eng.from_lane(eng.free_lane),
        fine_coeffs, x0=x0, y0=y0, hx=hx, hy=hy, ncx=ncx, ncy=ncy,
        device=eng.device, dtype=eng.dtype,
    )
    static = TwoLevelStatic(ncx=ncx, ncy=ncy, degree=degree, **dims)
    geo = dict(upload_tables(eng, tables), mg_data=mg_data,
               coarse_free=coarse_free)
    return static, geo


def _smoother_data(eng, u_lane, coeff_cells, *, power_iters=12,
                   inv_d=None, A=None):
    """Per-linearization smoother data: Jacobi inverse diagonal +
    power-iteration lambda_max of D^-1 J at the CURRENT iterate (the asym
    law's branch pattern moves with u, so a stale Chebyshev interval lets
    CG stall; the coarse lattice operator stays frozen). ``inv_d`` and
    ``A`` (the constrained tangent) may be passed in by a caller that
    has them already (the solver: its Jacobi diagonal and CG operator)."""
    free = eng.free_lane.to(u_lane.dtype)
    if inv_d is None:
        d = eng.diagonal(u_lane, coeff_cells)
        d = d * free + (1.0 - free)
        inv_d = inverse_diagonal(d)
    if A is None:
        Araw = eng.make_tangent(u_lane, coeff_cells)

        def A(v):
            return Araw(v * free) * free + v * (1.0 - free)

    return inv_d, power_lambda_max(A, inv_d, free, power_iters)


def refresh_twolevel(eng, static, geo, u_lane, coeff_cells, *,
                     power_iters=12, inv_d=None, A=None):
    """Per-Newton-step update: recompute the fine Chebyshev smoother data
    at the current linearization state (no host planning, no uploads)."""
    inv_d, lmax = _smoother_data(eng, u_lane, coeff_cells,
                                 power_iters=power_iters, inv_d=inv_d, A=A)
    return TwoLevelData(inv_d=inv_d, lmax=lmax, **geo)


def build_twolevel_geo_sharded(sle, fine_coeffs, **kwargs):
    raise NotImplementedError("build_twolevel_geo_sharded: " + _SHARDED)


def build_twolevel(eng, u_lane, coeff_cells, fine_coeffs, *, nc=None,
                   degree=2, power_iters=12):
    """One-shot set-up (geo + smoother data); prefer build_twolevel_geo +
    refresh_twolevel inside Newton loops."""
    static, geo = build_twolevel_geo(eng, fine_coeffs, nc=nc, degree=degree)
    data = refresh_twolevel(eng, static, geo, u_lane, coeff_cells,
                            power_iters=power_iters)
    return static, data


def restrict(eng, static, data, r):
    """fine (bs, R, 128) -> coarse (bs, ncy+1, ncx+1) = P^T r (owned)."""
    dt = r.dtype
    view = lane_gather_weighted(
        r, data.r_starts, data.r_idx, data.r_wts.to(dt), wr=static.WRr,
    )  # (Gc, bs, Kc, 128), channel-leading storage
    view = view.permute(1, 0, 2, 3).reshape(eng.bs, static.Rv, N_LANES)
    v3 = view[:, : (static.ncy + 1) * static.SC, :].reshape(
        eng.bs, static.ncy + 1, static.SC * N_LANES)
    check_matmul_precision(v3)
    return torch.matmul(v3, data.S.to(dt).T)


def prolong(eng, static, data, c):
    """coarse (bs, ncy+1, ncx+1) -> consistent fine (bs, R, 128) = P c."""
    dt = c.dtype
    check_matmul_precision(c)
    v3 = torch.matmul(c, data.S.to(dt))  # (bs, ncy+1, SC*128)
    view = v3.reshape(eng.bs, (static.ncy + 1) * static.SC, N_LANES)
    pad = static.Rv - view.shape[1]
    if pad > 0:
        view = torch.cat([view, view.new_zeros((eng.bs, pad, N_LANES))], 1)
    out = lane_gather_weighted(
        view, data.p_starts, data.p_idx, data.p_wts.to(dt), wr=static.WRp,
    )  # (G, bs, wg, 128), channel-leading storage
    p = eng.plan
    res = out.permute(1, 0, 2, 3).reshape(eng.bs, p.R, N_LANES)
    if data.o_dst.numel():
        # teleported-copy slots sit outside their lane's window; give
        # them their owner's freshly prolonged value instead
        flat = res.reshape(eng.bs, -1)
        flat[:, data.o_dst] = flat[:, data.o_src]
    return res


def precondition(eng, static, data, u_lane, coeff_cells, free, r):
    """Symmetric two-level cycle: Chebyshev fine smoothing + lattice-MG
    coarse correction. SPD in the owned-weighted inner product. The fine
    operator is the engine's ``make_tangent`` at ``u_lane`` (the fused
    kernel in Hessian-vector mode, or the stored per-cell Hessian of the
    staged engine); the reference passes gathered cells ``u_cells`` and
    re-differentiates per application."""
    Araw = eng.make_tangent(u_lane, coeff_cells)

    def A(v):
        return Araw(v * free) * free + v * (1.0 - free)

    return precondition_with(eng, static, data, free, r, A)


def precondition_with(eng, static, data, free, r, A, coarse_reduce=None,
                      defl=None):
    """The two-level cycle against a caller-supplied constrained tangent
    operator ``A``. ``coarse_reduce`` and ``defl`` (the distributed
    path's cross-device reduction and rigid-body deflation) are not
    ported and raise."""
    from tpufem_torch.structured import mg2d

    if coarse_reduce is not None or defl is not None:
        raise NotImplementedError(
            "precondition_with(coarse_reduce=, defl=): " + _SHARDED)
    kw = dict(degree=static.degree, lmin_ratio=1.0 / 8.0)
    inv_d = data.inv_d.to(r.dtype)
    x = chebyshev_iterate(A, inv_d, data.lmax, r, None, **kw)
    res = (r - A(x)) * free * eng.owned_w.to(r.dtype)
    cfree = data.coarse_free.to(r.dtype)
    rc = restrict(eng, static, data, res) * cfree
    xc = mg2d.vcycle(data.mg_data, rc) * cfree
    x = x + prolong(eng, static, data, xc) * free
    return chebyshev_iterate(A, inv_d, data.lmax, r, x, **kw)

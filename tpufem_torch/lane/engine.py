"""LaneEngine: unstructured residual / tangent-action / solve on the
lane-partitioned layout.

The staged pipeline per evaluation (all static shapes):

  u (bs, R, 128)
    -> lane_gather_cm (per-cell dof values, window = one bin)      [CUDA]
    -> reduced-variable physics: torch.func.grad of the summed cell
       energy w.r.t. the per-cell gradient components, chained back
       to the dof rows (flat (M,) tensors, no per-cell vmap)        [torch]
    -> lane_scatter_cm (cell contributions -> bin-partial sums)     [CUDA]
    -> lane_pass_update head=True  (copy partials -> home slots)    [CUDA]
    -> lane_pass_update head=False (home totals -> copy slots)      [CUDA]
  r (bs, R, 128), consistent at every slot

The tangent action runs the identical movement around the element-level
tangent (gathers/scatters are linear, so differentiating the physics alone
is exact); the physics is linearized once per Newton step
(``linearize``) and applied with multiply-adds in every CG iteration.
This is the staged P1 path of ``tpufem.lane.engine``.

``fused=True`` replaces gather -> physics -> scatter by ONE kernel,

  u [, v] (bs, R, 128) + geometry rows + coefficient rows
    -> lane_fused_elem / lane_fused_gen (element gradient /
       Hessian-vector product)                                      [CUDA]
    -> lane_pass_update head=True, head=False                       [CUDA]

for the residual and for J(u) v alike: the tangent action recomputes the
stress derivative from the frozen ``u`` in every application and no
per-cell Hessian is stored. Two routes serve the P1 single-point path.
Where the integrand is one of the kernel's hand-written laws
(``lane.kernels.FusedLaw``: found by the laws' tags and proved on probe
cells at construction), ``lane_fused_elem`` runs it. Every other
integrand that path takes -- triangles or tetrahedra, 1-3 components,
x-using or not -- gets physics generated from the integrand
(``lane.fused_gen``: its AD graphs traced and emitted as C), run by
``lane_fused_gen``; an operation the emitter has no C form for raises
``NotImplementedError``. On the multi-quadrature-point path the folded
integrand's point graphs are generated the same way
(``lane.fused_gen.GenPhysicsMQ``) and ``lane_fused_gen_mq`` sums them
over the points; the Jacobi diagonal still comes from the staged
linearization, once a Newton step.

The physics is specialized on the host in one of three ways. A single
degree-1 cell term on P1 simplices takes the P1 path: one quadrature
point per cell, (M,) reduced variables. Every other functional on
triangles, tetrahedra, quadrilaterals or hexahedra whose cell terms share
one quadrature degree and read no coefficient gradient takes the
multi-quadrature-point path (``lane.multiqp``: P2, Q1, Q2, P1 under a
higher rule, several terms folded into one integrand): per-point tables,
(nq, M) reduced variables, the same gather / scatter / pass kernels
around it. Everything else -- cell terms of several quadrature degrees
(the reference study's own functional), coefficient gradients, no cell
term -- takes the generic element path (``lane.generic``): AD of the
scalarized element energy over the gathered cells, the element matrices
stored once per Newton step. The generic path runs staged only:
``fused=True`` on it raises ``NotImplementedError`` (the reference runs
such an engine staged without a word, ``tpufem/lane/engine.py:163``).

Facet (ds-measure) terms ride every path (``_build_facet_data``): the
facet values are read at the owner slots of the facet dofs (or from the
gathered cells), differentiated per facet by ``torch.func``, and added
at the owner slot and every copy slot of each dof by a fixed-order
gather-sum (``assemble.scatter.SubsetSumPlan``) after the cell
pipeline's owner-sum and refresh, so the state stays consistent. The
facet Hessians are taken in ``linearize`` with the cell part.

``make_solver`` preconditions CG with Jacobi or with the two-level
lattice cycle (``lane.twolevel``); either way the CG operator is
``make_tangent``. ``make_mixed_solver`` runs the same inner solves in
float32 under a float64 Newton loop whose residuals come from the flat
``Assembler``, and also takes the SA-AMG cycle (``la.amg``) in the flat
layout. Both run on either specialization.
"""

from __future__ import annotations

import hashlib
import math
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch.func import grad, hessian, jvp, vmap

from tpufem_torch.assemble.assembler import ElementTangent
from tpufem_torch.assemble.scatter import SubsetSumPlan
from tpufem_torch.config import DEFAULT_DTYPE, SolverConfig, resolve_device
from tpufem_torch.forms.form import QP, EnergyFunctional
from tpufem_torch.forms.potentials import record_fused_laws
from tpufem_torch.forms.smat import SMat, SVec
from tpufem_torch.la.amg import vcycle
from tpufem_torch.la.cg import pcg_chunk
from tpufem_torch.lane.fused_gen import GenPhysics, GenPhysicsMQ
from tpufem_torch.lane.kernels import (FusedLaw, fused_elem_vectors,
                                       lane_fused_elem, lane_fused_gen,
                                       lane_gather_cm, lane_pass_update,
                                       lane_scatter_cm, scatter_cm_table)
from tpufem_torch.lane.generic import GenericPhysics, x_lane_host
from tpufem_torch.lane.multiqp import (MQ_CELLS, MultiQPPhysics,
                                       cells_leading, fold_terms,
                                       host_tables)
from tpufem_torch.lane.plan import LanePlan, N_LANES, build_lane_plan
from tpufem_torch.mesh.mesh import CellType
from tpufem_torch.spaces.bc import DirichletBC, combine_bcs

# cells per slab of the mixed solver's float64 outer residual (Assembler)
_F64_BATCH = 65536


def _inv_diagonal(eng, u, coeffs, free, lin):
    """Jacobi: 1 / diag(J) on free dofs, 1 on constrained ones and where
    the diagonal is 0."""
    d = eng.diagonal(u, coeffs, lin)
    d = d * free + (1.0 - free)
    one = torch.ones_like(d)
    return torch.where(d != 0, 1.0 / torch.where(d == 0, one, d), one)


def _linear_system(eng, u, coeffs, free):
    """The Jacobi inverse diagonal and the constrained CG operator of one
    Newton step, both from one linearization at ``u``."""
    lin = eng.linearize(u, coeffs)
    dinv = _inv_diagonal(eng, u, coeffs, free, lin)
    Araw = eng.make_tangent(u, coeffs, lin)
    del lin  # staged: Araw holds it; fused: free it before CG

    def A(v):
        av = Araw(v * free)
        return av * free + v * (1.0 - free)

    return dinv, A


def _chunked_pcg(eng, A, M, b, z0, tol, maxit, chunk):
    """Preconditioned CG on A x = b from x = 0 (``z0`` = M(b)) to
    |r| <= tol, in chunks of ``chunk`` iterations between two host reads;
    the tolerance is tested every iteration on the device, so the exit
    iteration does not depend on ``chunk``. Stall guard: after four chunks
    in a row that each end above 0.9 x the best residual so far, it stops
    and returns the partial solution (CG on a branch-switched tangent can
    plateau; Newton corrects a partial step). Returns (x, iterations,
    iterations enqueued)."""
    state = (torch.zeros_like(b), b, z0, z0, eng.dot(b, z0), eng.dot(b, b),
             torch.zeros((), dtype=torch.int64, device=b.device))
    tol2 = torch.as_tensor(tol * tol, dtype=b.dtype, device=b.device)
    k = enq = stall = 0
    best_rr = float("inf")
    while k < maxit:
        nsteps = min(chunk, maxit - k)
        state = pcg_chunk(A, M, eng.dot, nsteps, state, tol2)
        enq += nsteps
        rr = math.sqrt(float(state[5]))  # blocks on the device
        kd = int(state[6]) - k  # iterations run this chunk
        k += kd
        if rr < tol or kd < nsteps:
            break
        if rr > 0.9 * best_rr:
            stall += 1
            if stall >= 4:
                break
        else:
            stall = 0
        best_rr = min(best_rr, rr)
    return state[0], k, enq


def _twolevel(eng, tl, fine_coeffs, nc, u, coeffs, free, dinv, A):
    """The two-level preconditioner of one Newton step: its geometry built
    at the first call and kept in ``tl`` (:func:`_twolevel_geo`), its
    smoother data refreshed from this step's Jacobi diagonal ``dinv`` and
    CG operator ``A``. Returns M."""
    from tpufem_torch.lane import twolevel as tlmod

    _twolevel_geo(eng, tl, fine_coeffs, nc)
    data = tlmod.refresh_twolevel(eng, tl["static"], tl["geo"], u, coeffs,
                                  inv_d=dinv, A=A)

    def M(r):
        return tlmod.precondition_with(eng, tl["static"], data, free, r, A)

    return M


def _twolevel_geo(eng, tl, fine_coeffs, nc):
    """Build the two-level geometry into ``tl`` unless it holds one."""
    from tpufem_torch.lane import twolevel as tlmod

    if "geo" not in tl:
        tl["static"], tl["geo"] = tlmod.build_twolevel_geo(
            eng, fine_coeffs, nc=nc)


def _fingerprint(config, arrays) -> str:
    """sha256 of ``config`` (a tuple of plain values) and of each named
    array of ``arrays`` whole: its name, shape, dtype and every byte."""
    h = hashlib.sha256()
    h.update(repr(config).encode())
    for k in sorted(arrays):
        a = np.ascontiguousarray(_host(arrays[k]))
        h.update(k.encode())
        h.update(repr((a.shape, a.dtype.str)).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


def _sync(device):
    """Wait for the device, so that a host clock reads its work too."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class LaneEngine:
    def __init__(
        self,
        functional: EnergyFunctional,
        bcs: Sequence[DirichletBC] = (),
        *,
        wg_own: int = 32,
        plan: Optional[LanePlan] = None,
        fused: bool = False,
        device=None,
        dtype: torch.dtype = DEFAULT_DTYPE,
    ):
        space = functional.space
        if space.element.degree < 1:
            raise NotImplementedError("lane engine needs degree >= 1")
        self.functional = functional
        self.space = space
        self.bs = space.bs
        self.device = resolve_device(device)
        self.dtype = dtype  # of the float device state (geometry, masks)
        # plan over scalar-dof "nodes" (P1: the mesh vertices); a pure
        # function of (dof coords, dofmap, wg_own)
        if plan is not None:
            self.plan = plan
        else:
            self.plan = build_lane_plan(
                space.dof_coords, np.asarray(space.dofmap), wg_own=wg_own
            )
        p = self.plan

        # padded lane cells get cell 0's data -- their contributions are
        # dropped by the idx = -1 sentinel, so they only need to be
        # NaN-free
        order = np.asarray(p.cell_order)
        self._safe_order = np.where(order >= 0, order, 0)
        self._coeff_dofmaps = {
            c.name: c.space.vector_dofmap() for c in functional.coefficients
        }

        # specialized physics, geometry precomputed on host (f64): the
        # P1-simplex 1-point-quadrature path first, else the
        # multi-quadrature-point path, else the generic element path
        self.geom_dN = self.geom_w = self.geom_xq = None
        self.x_lane = None  # (nvg, gdim, M) vertex coordinates: generic
        self._mq = None  # lane.multiqp.MultiQPPhysics of the multi-qp path
        self._gen = None  # lane.generic.GenericPhysics of the generic path
        self._red_diag = None
        if self._try_specialize_p1():
            self.path = "p1"
            (self._red_res, self._red_energy, self._red_linearize,
             self._red_apply) = self._make_reduced_fns()
        elif self._multiqp_takes() is None:
            self.path = "multiqp"
            mq = self._mq = self._specialize_multiqp()
            (self._red_res, self._red_energy, self._red_linearize,
             self._red_apply, self._red_diag) = (
                mq.residual, mq.energy, mq.linearize, mq.apply, mq.diagonal)
        else:
            self.path = "generic"
            gen = self._gen = GenericPhysics(
                functional, [c.name for c in functional.coefficients])
            self.x_lane = self._store(x_lane_host(space.mesh,
                                                  self._safe_order))
            (self._red_res, self._red_energy, self._red_linearize,
             self._red_apply, self._red_diag) = (
                gen.residual, gen.energy, gen.linearize, gen.apply,
                gen.diagonal)

        # fused element kernel: on the P1 path the hand-written law the
        # integrand is (proved on probe cells), else -- there and on the
        # multi-qp path -- the physics generated from the integrand (traced
        # now: an operation the emitter lacks raises NotImplementedError,
        # never a quiet switch to the staged path); and the static geometry
        # rows (G, Dg, kc, 128) the kernel streams, the reference's layout:
        # dN[q][v][d] at row (q*nv+v)*gd+d, the nq weights, then the nq*gd
        # quadrature-point rows where the physics reads x (P1: nq = 1)
        self._fused = bool(fused)
        self.fused_law = self.fused_geom = None
        self._gen_phys = {}  # dtype -> lane.fused_gen.GenPhysics
        if self._fused and self.path == "generic":
            raise NotImplementedError(
                "LaneEngine(fused=True): the fused kernel takes the P1 "
                "single-point and the multi-quadrature-point paths (a "
                "hand-written law, or K4, kernel source generated from the "
                "elementwise energy); a functional on the generic element "
                "path runs staged (fused=False) -- the reference runs such "
                "an engine staged without a word, "
                "tpufem/lane/engine.py:163")
        if self._fused:
            if self.path == "p1":
                self.fused_law = self._resolve_fused_law()
            dN_h, w_h, xq_h = self._geom_host
            M = dN_h.shape[-1]
            parts = [dN_h.reshape(-1, M), w_h.reshape(-1, M)]
            if self.fused_law is None and self.fused_gen(self.dtype).x_rows:
                parts.append(xq_h.reshape(-1, M))
            self.fused_geom = self._store(self._bin_rows(parts))
        self._geom_host = None

        # device plans; index streams in int8 when the window allows --
        # the gather/scatter kernels are partly index-bandwidth-bound
        idt = np.int8 if p.wg < 127 else np.int32
        dev = self.device
        self.gather_idx = torch.as_tensor(
            np.ascontiguousarray(p.gather_idx.astype(idt)), device=dev
        )  # (G, nv, kc, 128)
        # its inverse, which K2 walks on the card (one thread per output row)
        self.scatter_table = scatter_cm_table(self.gather_idx, p.wg)
        self.gather_starts = torch.as_tensor(
            np.asarray(p.gather_starts, dtype=np.int32), device=dev
        )

        def pass_tables(passes):
            if not passes:
                return (), (), None, None
            shifts = tuple(int(s[0]) for s in passes)
            wrs = tuple(int(s[4]) for s in passes)
            starts = torch.as_tensor(
                np.stack([s[3] for s in passes]).astype(np.int32),
                device=dev,
            )  # (P, G)
            idx = torch.as_tensor(
                np.ascontiguousarray(
                    np.stack([s[2][:, 0] for s in passes]).astype(idt)
                ),
                device=dev,
            )  # (P, G, K, 128)
            return shifts, wrs, starts, idx

        (self.owner_shifts, self.owner_wrs, self._owner_starts,
         self._owner_idx) = pass_tables(p.owner_passes)
        (self.refresh_shifts, self.refresh_wrs, self._refresh_starts,
         self._refresh_idx) = pass_tables(p.refresh_passes)
        self._build_tail_tables()

        # BCs
        self.bcs = list(bcs)
        if self.bcs:
            bc_dofs, bc_vals, bc_mask = combine_bcs(self.bcs, space.n_dofs)
        else:
            bc_dofs = np.zeros(0, dtype=np.int64)
            bc_vals = np.zeros(0)
            bc_mask = np.zeros(space.n_dofs, dtype=bool)
        self.free_lane = self._store(
            p.to_lane((~bc_mask).astype(np.float64), self.bs)
        )
        bcv = np.zeros(space.n_dofs)
        bcv[bc_dofs] = bc_vals
        self.bc_lane = self._store(p.to_lane(bcv, self.bs))
        self.owned_w = self._store(
            p.owned_mask.astype(np.float64)[None, :, :]
        )  # (1, R, 128) dot weights
        self._lmaps = None

        # facet (ds-measure) terms: small tables, a torch.func AD per facet
        # and a fixed-order gather-sum into the owner and copy slots
        self._facet_fns = []
        self.facet_arrays = []
        self._facet_plan = None
        if functional.facet_terms:
            self._build_facet_data()

    def _build_facet_data(self):
        """Facet-term plan (``tpufem/lane/engine.py:326-424``, the same
        host tables): per facet term, ``upos`` the lane slot (component x
        R x 128 + owner slot) of every facet dof, ``spos`` / ``ssrc`` the
        slots each facet-vector entry is added to (the owner slot, then
        every copy slot of its dof) and the entry it comes from, and
        ``ucpos``, where every facet dof lies in its owner cell, the
        position of each facet dof in the gathered cell block (row v * bs
        + c, cells minor). The adds of all terms go through one
        ``SubsetSumPlan`` over the distinct slots of ``spos``."""
        from tpufem_torch.mesh.topology import facet_to_cells

        p = self.plan
        bs = self.bs
        FL = p.R * N_LANES
        owner_slot = p.node_row.astype(np.int64) * N_LANES + p.node_lane
        have_copies = (p.copy_src_rows is not None
                       and len(p.copy_src_rows) > 0)
        if have_copies:
            inv = np.full(FL, -1, dtype=np.int64)
            inv[owner_slot] = np.arange(p.n_nodes)
            node_of_copy = inv[p.copy_src_rows.astype(np.int64) * N_LANES
                               + p.copy_src_lanes]
            copy_slot = (p.copy_dst_rows.astype(np.int64) * N_LANES
                         + p.copy_dst_lanes)
            order = np.argsort(node_of_copy, kind="stable")
            cn_sorted = node_of_copy[order]
            cs_sorted = copy_slot[order]
        # lane-cell index of every mesh cell (tangent_from_cells reads the
        # facet state from the already gathered u_cells)
        inv_order = np.full(p.n_cells, -1, dtype=np.int64)
        corder = np.asarray(p.cell_order)
        valid_c = corder >= 0
        inv_order[corder[valid_c]] = np.nonzero(valid_c)[0]
        M = p.G * p.kc * N_LANES
        mesh = self.space.mesh
        dofmap = np.asarray(self.space.dofmap)
        indptr, cell_ids = facet_to_cells(mesh)
        fblocks = self.functional.facet_energy_fns()
        all_spos, all_ssrc, off = [], [], 0
        dev = self.device
        for blk_i, (fn, _dm, _x, _n) in enumerate(fblocks):
            st = self.functional._facet_static[blk_i]
            fd = st["dofmap"]  # (nf, ndf) global vector dofs
            nodes = (fd // bs).astype(np.int64)
            comp = (fd % bs).astype(np.int64)
            upos = comp * FL + owner_slot[nodes]
            src = np.arange(fd.size, dtype=np.int64)
            spos_list = [comp.ravel() * FL + owner_slot[nodes.ravel()]]
            ssrc_list = [src]
            if have_copies:
                lo = np.searchsorted(cn_sorted, nodes.ravel(), "left")
                hi = np.searchsorted(cn_sorted, nodes.ravel(), "right")
                cnt = hi - lo
                tot = int(cnt.sum())
                if tot:
                    # ragged ranges [lo_i, hi_i)
                    idx = (np.repeat(lo, cnt) + np.arange(tot)
                           - np.repeat(np.cumsum(cnt) - cnt, cnt))
                    spos_list.append(
                        np.repeat(comp.ravel(), cnt) * FL + cs_sorted[idx])
                    ssrc_list.append(np.repeat(src, cnt))
            ft = np.asarray(st["term"].facets, np.int64)
            ucpos = None
            if ft.size == fd.shape[0]:
                owner = cell_ids[indptr[ft]]
                mcell = inv_order[owner]  # (nf,) lane cell
                # local slot of each facet node within its owner cell
                eq = dofmap[owner][:, None, :] == nodes[:, :, None]
                vloc = eq.argmax(axis=2)  # (nf, ndf)
                if bool(eq.any(axis=2).all()):
                    ucpos = (vloc * bs + comp) * M + mcell[:, None]
            spos = np.concatenate(spos_list)
            ssrc = np.concatenate(ssrc_list)
            all_spos.append(spos)
            all_ssrc.append(ssrc + off)
            off += fd.size
            self._facet_fns.append(fn)
            arrs = dict(
                upos=torch.as_tensor(upos, device=dev),
                spos=torch.as_tensor(spos, device=dev),
                ssrc=torch.as_tensor(ssrc, device=dev),
                x_f=self._store(st["x_f"]),
                nrm=self._store(st["nrm"]))
            if ucpos is not None:
                arrs["ucpos"] = torch.as_tensor(ucpos, device=dev)
            self.facet_arrays.append(arrs)
        if self.facet_arrays:
            self._facet_plan = SubsetSumPlan.build(
                np.concatenate(all_spos), np.concatenate(all_ssrc), off,
                device=dev)

    def _facet_states(self, u_lane=None, u_cells=None):
        """Per facet term, the state at its facet dofs (nf, ndf): from the
        gathered cells through ``ucpos`` where both are at hand, else from
        the lane state through ``upos``."""
        out = []
        for arrs in self.facet_arrays:
            if u_cells is not None and "ucpos" in arrs:
                out.append(u_cells.reshape(-1)[arrs["ucpos"]])
            elif u_lane is not None:
                out.append(u_lane.reshape(-1)[arrs["upos"]])
            else:
                raise NotImplementedError(
                    "facet linearization state unavailable: no ucpos "
                    "plan and no u_lane")
        return out

    def _facet_geom(self, arrs, dtype):
        return arrs["x_f"].to(dtype), arrs["nrm"].to(dtype)

    def facet_hessians(self, u_lane=None, u_cells=None):
        """Per facet term, the facet Hessians (nf, ndf, ndf) at the state
        (``_facet_states``)."""
        states = self._facet_states(u_lane, u_cells)
        return tuple(
            vmap(hessian(fn))(uf, *self._facet_geom(arrs, uf.dtype))
            for fn, arrs, uf in zip(self._facet_fns, self.facet_arrays,
                                    states))

    def _facet_add(self, out, values):
        """``out`` (a consistent lane array this engine made) with the
        facet entries ``values`` (every term's (nf, ndf), in order) added
        at the owner and copy slots of their dofs, in place; ``out`` as it
        is without facet terms."""
        if not values:
            return out
        flat = torch.cat([v.reshape(-1) for v in values])
        return self._facet_plan.add_into(out, flat.to(out.dtype),
                                         inplace=True)

    def _facet_grad(self, out, u_lane):
        states = self._facet_states(u_lane)
        return self._facet_add(out, [
            vmap(grad(fn))(uf, *self._facet_geom(arrs, uf.dtype))
            for fn, arrs, uf in zip(self._facet_fns, self.facet_arrays,
                                    states)])

    def _facet_apply(self, out, facets, v_lane):
        """out + the facet Hessians ``facets`` applied to v."""
        vf = v_lane.reshape(-1)
        return self._facet_add(out, [
            torch.bmm(H, vf[arrs["upos"]].unsqueeze(-1))
            for H, arrs in zip(facets, self.facet_arrays)])

    def _facet_diag(self, out, facets):
        return self._facet_add(out, [torch.diagonal(H, dim1=1, dim2=2)
                                     for H in facets])

    def _build_tail_tables(self):
        """Rare-copy tail (copies left out of the dense pass kernels, see
        plan.py pass_min_frac) as deterministic device tables.

        Owner-sum: several tail copies may feed one owner slot. A
        scatter-add on the device would use float atomics and change
        from run to run, so the sum is transposed on the host into a
        padded gather table (the GatherSumPlan idiom): for every distinct
        owner slot the list of its copy slots, padded with the index of
        an appended zero. Refresh: copy slots are distinct, a plain
        indexed store."""
        p = self.plan
        self._tail_copy = self._tail_owner = None
        self._tail_owner_u = self._tail_sum_idx = None
        if p.tail_copy_slot is None or not len(p.tail_copy_slot):
            return
        tc = np.asarray(p.tail_copy_slot, dtype=np.int64)
        to = np.asarray(p.tail_owner_slot, dtype=np.int64)
        keep = (tc >= 0) & (to >= 0)  # -1 entries are padding
        tc, to = tc[keep], to[keep]
        if not len(tc):
            return
        from tpufem_torch.assemble.scatter import GatherSumPlan

        FL = p.R * N_LANES
        owners, inv = np.unique(to, return_inverse=True)
        table = GatherSumPlan.build_table(inv, len(owners))  # (K, n_u)
        pad = table == len(tc)
        table = np.where(pad, FL, tc[np.where(pad, 0, table)])
        dev = self.device
        self._tail_copy = torch.as_tensor(tc, device=dev)
        self._tail_owner = torch.as_tensor(to, device=dev)
        self._tail_owner_u = torch.as_tensor(owners, device=dev)
        self._tail_sum_idx = torch.as_tensor(
            np.ascontiguousarray(table), dtype=torch.int64, device=dev
        )

    def _store(self, a) -> torch.Tensor:
        """Upload a host float array at the engine dtype."""
        return torch.as_tensor(
            np.asarray(a), dtype=self.dtype, device=self.device
        )

    def _bin_rows(self, parts) -> np.ndarray:
        """The (n, M) host arrays ``parts`` stacked as rows and re-blocked
        per bin, (G, rows, kc, 128): the fused kernel's cell-data layout,
        written in one pass."""
        p = self.plan
        n = sum(a.shape[0] for a in parts)
        out = np.empty((p.G, n, p.kc, N_LANES), dtype=parts[0].dtype)
        o = 0
        for a in parts:
            out[:, o:o + a.shape[0]] = a.reshape(
                a.shape[0], p.G, p.kc, N_LANES).transpose(1, 0, 2, 3)
            o += a.shape[0]
        return out

    def _try_specialize_p1(self):
        """If the functional is a single degree-1 cell term on a simplex
        with P1/P0 coefficients and no coefficient gradients, precompute
        the per-cell geometry of the elementwise fast path (physical
        basis gradients, quadrature weight, centroid) and return True;
        else False."""
        f = self.functional
        mesh = self.space.mesh
        if mesh.cell_type not in (CellType.triangle, CellType.tetra):
            return False
        if self.space.element.degree != 1:
            return False
        if len(f.terms) != 1:
            return False
        term = f.terms[0]
        if term.degree != 1 or term.needs_coeff_grads:
            return False
        for c in f.coefficients:
            if c.space.element.degree > 1:
                return False

        # host f64 geometry: physical gradients + weight + centroid,
        # computed per scalar component (1-D gathers + 1-D arithmetic,
        # results written straight into the final cells-minor layouts)
        p = self.plan
        x = mesh.x.astype(np.float64)
        cells = np.asarray(self.space.dofmap)[self._safe_order]  # (M, nv)
        nv = p.nv
        gdim = x.shape[1]
        dim = nv - 1
        M = len(cells)

        # per-component vertex coords and edge vectors (J columns)
        xv = [[x[cells[:, v], d] for d in range(gdim)] for v in range(nv)]
        E = [[xv[v + 1][d] - xv[0][d] for d in range(gdim)]
             for v in range(dim)]
        # adjugate inverse, rows Ji[i][j] = Jinv[i, j] as 1-D arrays
        if dim == 2:
            a, b = E[0][0], E[1][0]
            c, dd = E[0][1], E[1][1]
            detJ = a * dd - b * c
            r = 1.0 / detJ
            Ji = [[dd * r, -b * r], [-c * r, a * r]]
        else:
            a, b, c = E[0][0], E[1][0], E[2][0]
            d3, e3, f3 = E[0][1], E[1][1], E[2][1]
            g, h, i = E[0][2], E[1][2], E[2][2]
            A = e3 * i - f3 * h
            B = f3 * g - d3 * i
            C = d3 * h - e3 * g
            detJ = a * A + b * B + c * C
            r = 1.0 / detJ
            Ji = [
                [A * r, (c * h - b * i) * r, (b * f3 - c * e3) * r],
                [B * r, (a * i - c * g) * r, (c * d3 - a * f3) * r],
                [C * r, (b * g - a * h) * r, (a * e3 - b * d3) * r],
            ]
        # dN_ref = [-1...; eye] -> dN[0] = -sum_i Jinv[i], dN[v>0] = Jinv[v-1]
        dN_t = np.empty((nv, gdim, M))  # final (nv, gdim, M) layout
        for j in range(gdim):
            s = Ji[0][j].copy()
            for i_ in range(1, dim):
                s += Ji[i_][j]
            dN_t[0, j] = -s
            for v in range(1, nv):
                dN_t[v, j] = Ji[v - 1][j]
        w = np.abs(detJ) / math.factorial(dim)  # (M,)
        xq_t = np.empty((gdim, M))  # final (gdim, M) layout
        for d in range(gdim):
            s = xv[0][d].copy()
            for v in range(1, nv):
                s += xv[v][d]
            xq_t[d] = s / nv
        self.geom_dN = self._store(dN_t)
        self.geom_w = self._store(w)
        self.geom_xq = self._store(xq_t)
        self._geom_host = (dN_t, w, xq_t)  # for the fused kernel's rows
        return True

    def _multiqp_takes(self) -> Optional[str]:
        """None where the multi-qp path takes the functional, else why
        not (then the generic path does)."""
        _, _, why = fold_terms(self.functional)
        if self.space.mesh.cell_type not in MQ_CELLS:
            why = f"{self.space.mesh.cell_type} cells"
        return why

    def _specialize_multiqp(self) -> MultiQPPhysics:
        """The multi-quadrature-point path (the reference's
        ``_try_specialize_multiqp``): the cell terms folded into one
        integrand, the float64 host tables (``lane.multiqp.host_tables``)
        stored once on the device at the engine dtype -- dN cells leading
        (M, nv, nq * gd), w (nq, M), xq (nq, gd, M) -- and the physics.
        The functional is one that :meth:`_multiqp_takes` takes."""
        f = self.functional
        mesh = self.space.mesh
        integrand, qdeg, _ = fold_terms(f)
        tabs = host_tables(self.space, self._safe_order, qdeg,
                           f.coefficients, self._coeff_dofmaps)
        self.geom_dN = self._store(cells_leading(tabs["dN"]))
        self.geom_w = self._store(tabs["w"])
        self.geom_xq = self._store(tabs["xq"])
        # (nq, nv, gd, M), (nq, M), (nq, gd, M): the fused kernel's rows
        self._geom_host = (tabs.pop("dN"), tabs.pop("w"), tabs.pop("xq"))
        coeff_meta = []
        for c in f.coefficients:
            n = self._coeff_dofmaps[c.name].shape[1]
            coeff_meta.append((c.name, n // c.space.bs, c.space.bs))
        return MultiQPPhysics(integrand, tabs["Nf"], tabs["Nc"], self.bs,
                              mesh.gdim, coeff_meta, self.device)

    def _make_reduced_fns(self):
        """Residual / energy / linearization element kernels via
        reduced-variable AD.

        E(u) = sum_cells w * psi(grad_u, u_q, x_q, coeffs) with grad_u
        an affine function of the dofs; differentiate w.r.t. the bs*gd
        gradient components + bs value components (all (M,) tensors,
        SMat/SVec carry the matrix structure), then chain back to the
        nd dof rows through the known linear maps. Exact same math as
        grad of the element energy; every operand is a flat (M,) tensor,
        so ``torch.func.grad`` of the summed energy needs no ``vmap``."""
        p = self.plan
        mesh = self.space.mesh
        bs = self.bs
        nv, gd = p.nv, mesh.gdim
        integrand = self.functional.terms[0].integrand
        coeff_meta = []  # (name, ndofc, cb)
        for c in self.functional.coefficients:
            n = self._coeff_dofmaps[c.name].shape[1]
            cb = c.space.bs
            coeff_meta.append((c.name, n // cb, cb))
        nG = bs * gd
        inv_nv = 1.0 / nv

        def make_cell_energy(cvals, xq, w):
            def cell_energy(*a):
                grad_u = SMat(
                    [[a[c * gd + d] for d in range(gd)]
                     for c in range(bs)]
                )
                uq = a[nG] if bs == 1 else SVec(a[nG: nG + bs])
                qp = QP(grad_u, uq, SVec([xq[d] for d in range(gd)]),
                        cvals, {})
                return integrand(qp) * w

            return cell_energy

        # multiply-adds go through torch.addcmul: one kernel (and one
        # pass over memory) instead of a multiply and an add
        def reduced_args(u_cells, dN):
            a = []
            for c in range(bs):
                for d in range(gd):
                    acc = u_cells[c] * dN[0, d]
                    for v in range(1, nv):
                        acc = torch.addcmul(acc, u_cells[v * bs + c],
                                            dN[v, d])
                    a.append(acc)
            for c in range(bs):
                acc = None
                for v in range(nv):
                    t = u_cells[v * bs + c]
                    acc = t if acc is None else acc + t
                a.append(acc * inv_nv)
            return tuple(a)

        def cell_cvals(coeffs):
            cvals = {}
            for nm, ndofc, cb in coeff_meta:
                ce = coeffs[nm]  # (ndofc*cb, M)
                comps = []
                for j in range(cb):
                    if ndofc == 1:
                        comps.append(ce[j])
                    else:
                        acc = None
                        for i in range(ndofc):
                            t = ce[i * cb + j]
                            acc = t if acc is None else acc + t
                        comps.append(acc / ndofc)
                cvals[nm] = comps[0] if cb == 1 else SVec(comps)
            return cvals

        argnums = tuple(range(nG + bs))

        def chain_back(g, dN):
            rows = []
            for v in range(nv):
                for c in range(bs):
                    acc = g[nG + c] * inv_nv
                    for d in range(gd):
                        acc = torch.addcmul(acc, g[c * gd + d], dN[v, d])
                    rows.append(acc)
            return torch.stack(rows)

        def grad_fn(coeffs, w, xq):
            ce = make_cell_energy(cell_cvals(coeffs), xq, w)
            return grad(lambda *a: torch.sum(ce(*a)), argnums=argnums)

        def red_residual(u_cells, coeffs, dN, w, xq):
            g = grad_fn(coeffs, w, xq)(*reduced_args(u_cells, dN))
            return chain_back(g, dN)

        def red_energy(u_cells, coeffs, dN, w, xq):
            ce = make_cell_energy(cell_cvals(coeffs), xq, w)
            return ce(*reduced_args(u_cells, dN))  # (M,)

        nR = nG + bs

        def red_linearize(u_cells, coeffs, dN, w, xq):
            """Per-cell Hessian of the cell energy w.r.t. the reduced
            variables at a frozen state, as an nR x nR table of (M,)
            tensors: column j is the JVP of the reduced gradient along
            the j-th unit direction."""
            gfn = grad_fn(coeffs, w, xq)
            a = reduced_args(u_cells, dN)
            one, zero = torch.ones_like(a[0]), torch.zeros_like(a[0])
            cols = [
                jvp(gfn, a, tuple(one if i == j else zero
                                  for i in range(nR)))[1]
                for j in range(nR)
            ]
            return [[cols[j][i] for j in range(nR)] for i in range(nR)]

        def red_apply(H, v_cells, dN):
            """Tangent element vectors from a stored linearization:
            chain_back(H . reduced_args(v)) -- multiply-adds only."""
            da = reduced_args(v_cells, dN)
            dg = []
            for i in range(nR):
                acc = H[i][0] * da[0]
                for j in range(1, nR):
                    acc = torch.addcmul(acc, H[i][j], da[j])
                dg.append(acc)
            return chain_back(dg, dN)

        return red_residual, red_energy, red_linearize, red_apply

    # -- fused kernel: law of the integrand -------------------------------------

    def _probe_qp(self, x):
        """A quadrature-point context of distinct 0-dim float64 tensors
        (one evaluation of the integrand on it tells what it reads)."""
        bs, gd = self.bs, self.space.mesh.gdim

        def s(val):
            return torch.tensor(val, dtype=torch.float64)

        grad_u = SMat([[s(0.01 * (1 + i * gd + j)) for j in range(gd)]
                       for i in range(bs)])
        u = SVec([s(0.001 * (i + 1)) for i in range(bs)])
        cvals = {}
        for c in self.functional.coefficients:
            cb = c.space.bs
            cvals[c.name] = s(0.5) if cb == 1 else SVec(
                [s(0.5) for _ in range(cb)])
        return QP(grad_u, u, x, cvals, {}), cvals

    def _integrand_uses_x(self) -> bool:
        """True iff the cell integrand reads qp.x: it is evaluated once
        with a poison object in every x component, and any operation on
        the poison marks x as used."""

        class _Touched(Exception):
            pass

        class _Poison:
            def _no(self, *a, **k):
                raise _Touched()

            for _op in ("add", "radd", "sub", "rsub", "mul", "rmul",
                        "truediv", "rtruediv", "pow", "rpow", "mod",
                        "rmod", "lt", "le", "gt", "ge", "eq", "ne",
                        "neg", "pos", "abs", "float", "index", "bool",
                        "matmul", "rmatmul", "getitem", "iter"):
                locals()[f"__{_op}__"] = _no
            del _op

        gd = self.space.mesh.gdim
        qp, _ = self._probe_qp(SVec([_Poison() for _ in range(gd)]))
        try:
            for term in self.functional.terms:
                term.integrand(qp)
        except _Touched:
            return True
        return False

    def _resolve_fused_law(self) -> Optional[FusedLaw]:
        """The hand-written law of the fused kernel that this engine's
        integrand evaluates, or None (the generated physics then serves).

        The energies of ``forms.potentials`` that the kernel has a law
        for are tagged: one evaluation of the integrand under
        ``record_fused_laws`` names the law and shows what is passed for
        the damage, the modulus and the Poisson ratio (a coefficient, by
        identity with the probe's value, or a constant). That is only a
        claim; :meth:`_prove_fused_law` holds it against AD of the
        integrand itself. The laws are written for the P1 triangle with
        two components and read no qp.x."""
        mesh = self.space.mesh
        if (mesh.cell_type != CellType.triangle or mesh.gdim != 2
                or self.bs != 2 or self._integrand_uses_x()):
            return None
        qp, cvals = self._probe_qp(SVec([torch.zeros((), dtype=torch.float64)
                                         for _ in range(mesh.gdim)]))
        with record_fused_laws() as calls:
            self.functional.terms[0].integrand(qp)
        if len(calls) != 1:
            return None
        name, args = calls[0]
        rows, off = {}, 0  # coefficient name -> (first row, rows) of _cd
        for c in self.functional.coefficients:
            n = self._coeff_dofmaps[c.name].shape[1]
            if c.space.bs == 1:
                rows[c.name] = (off, n)
            off += n

        def source(arg):
            for cname, val in cvals.items():
                if arg is val and cname in rows:
                    return rows[cname]
            return float(arg)  # a constant (derived values fail the proof)

        if name == "asym_damage":
            _eps, d, E, nu = args
            law = FusedLaw(name, float(nu), E=source(E), d=source(d))
        else:
            _eps, E, nu = args
            law = FusedLaw(name, float(nu), E=source(E))
        return law if self._prove_fused_law(law, off) else None

    def _prove_fused_law(self, law: FusedLaw, n_coeff_rows: int,
                         n_probe: int = 384, rtol: float = 1e-9) -> bool:
        """Hold the hand-written physics of ``law`` against AD of the
        actual integrand (``torch.func.grad`` / ``jvp`` through the
        staged element functions) on random probe cells in float64,
        including zero strain, spherical strain (``delta == 0``), both
        signs of the eigenvalues, and damage 0 and 1. False on
        disagreement: the integrand is then not the law it names (scaled,
        shifted, other arguments)."""
        M = n_probe
        rng = np.random.default_rng(20240229)
        dN = 10.0 * rng.standard_normal((3, 2, M))
        w = rng.uniform(1e-4, 1e-3, M)
        u = 1e-3 * rng.standard_normal((6, M))
        v = rng.standard_normal((6, M))
        q = M // 8
        u[:, :q] = 0.0  # zero strain
        # exactly spherical strain a*I on the reference triangle,
        # tension and compression
        dN[:, :, q:2 * q] = np.array(
            [[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])[:, :, None]
        a = np.ldexp(rng.integers(1, 64, q).astype(np.float64), -16)
        a[::2] *= -1.0
        u[:, q:2 * q] = 0.0
        u[2, q:2 * q] = a  # vertex 1, x
        u[5, q:2 * q] = a  # vertex 2, y
        cd = rng.uniform(0.0, 1.0, (max(n_coeff_rows, 1), M))
        cd[:, ::5] = 1.0  # fully damaged
        cd[:, 1::5] = 0.0  # sound
        if isinstance(law.E, tuple):  # moduli of realistic size
            o, n = law.E
            cd[o:o + n] = rng.uniform(1e5, 1e7, (n, M))

        def t(x):
            return torch.as_tensor(x, dtype=torch.float64,
                                   device=self.device)

        coeffs, off = {}, 0
        for c in self.functional.coefficients:
            n = self._coeff_dofmaps[c.name].shape[1]
            coeffs[c.name] = t(cd[off:off + n])
            off += n
        dN_t, w_t, xq_t = t(dN), t(w), t(np.zeros((2, M)))
        u_t, v_t = t(u), t(v)
        cds = (torch.cat([dN_t.reshape(6, M), w_t[None]]), t(cd))
        H = self._red_linearize(u_t, coeffs, dN_t, w_t, xq_t)
        pairs = {
            "gradient": (fused_elem_vectors(law, (u_t,), cds),
                         self._red_res(u_t, coeffs, dN_t, w_t, xq_t)),
            "Hessian-vector product": (
                fused_elem_vectors(law, (u_t, v_t), cds),
                self._red_apply(H, v_t, dN_t)),
        }
        for hand, ad in pairs.values():
            err = float((hand - ad).abs().max())
            if not (np.isfinite(err)
                    and err <= rtol * float(ad.abs().max())):
                return False
        return True

    def fused_gen(self, dtype) -> GenPhysics:
        """The fused kernel's physics generated from the integrand at
        ``dtype``, traced at the first call for that dtype: a
        ``lane.fused_gen.GenPhysics`` on the P1 path, a ``GenPhysicsMQ``
        of the folded integrand and the element's basis values on the
        multi-qp path."""
        if dtype not in self._gen_phys:
            coeff_meta = []
            for c in self.functional.coefficients:
                n = self._coeff_dofmaps[c.name].shape[1]
                coeff_meta.append((c.name, n // c.space.bs, c.space.bs))
            kw = dict(bs=self.bs, gd=self.space.mesh.gdim, nv=self.plan.nv,
                      coeff_meta=coeff_meta, dtype=dtype)
            mq = self._mq
            if mq is not None:
                self._gen_phys[dtype] = GenPhysicsMQ(
                    mq.integrand, Nf=mq._Nf.cpu().numpy(),
                    Nc={k: None if v is None else v.cpu().numpy()
                        for k, v in mq._Nc.items()}, **kw)
            else:
                self._gen_phys[dtype] = GenPhysics(
                    self.functional.terms[0].integrand, **kw)
        return self._gen_phys[dtype]

    def _fused_cds(self, coeff_cells, dtype):
        cds = (self.fused_geom.to(dtype),)
        if self._coeff_dofmaps:
            if "_cd" not in coeff_cells:
                raise KeyError(
                    "the fused engine needs the '_cd' coefficient block: "
                    "pass what this engine's prepare_coeffs returned")
            cds = cds + (coeff_cells["_cd"].to(dtype),)
        return cds

    def _fused_apply(self, states, coeff_cells):
        """Element gradient (one state) or Hessian-vector product (u, v)
        through the fused kernel (the hand-written law, or the physics
        generated at the states' dtype), then owner-sum and refresh. The
        kernel stores its (G, bs, wg, 128) result channel-leading, so the
        transpose to (bs, G, wg, 128) is a view."""
        p = self.plan
        dt = states[0].dtype
        cds = self._fused_cds(coeff_cells, dt)
        if self.fused_law is not None:
            part = lane_fused_elem(states, self.gather_starts,
                                   self.gather_idx, cds, self.fused_law,
                                   wr=p.wg, nv=p.nv)
        else:
            part = lane_fused_gen(states, self.gather_starts,
                                  self.gather_idx, cds, self.fused_gen(dt),
                                  wr=p.wg, nv=p.nv)
        return self._owner_refresh(part.permute(1, 0, 2, 3))

    # -- layout ---------------------------------------------------------------

    def to_lane(self, u_flat):
        """Flat byVDIM host vector -> (bs, R, 128) device tensor with
        copies filled (host layout conversion + one upload)."""
        if isinstance(u_flat, torch.Tensor):
            u_flat = u_flat.detach().cpu().numpy()
        return torch.as_tensor(
            self.plan.to_lane(np.asarray(u_flat), self.bs),
            dtype=self.dtype, device=self.device,
        )

    def from_lane(self, u_lane) -> np.ndarray:
        return self.plan.from_lane(
            u_lane.detach().cpu().numpy(), self.bs
        )

    def _lane_maps_dev(self):
        """Device-resident plan.to_lane/from_lane index tables (lazy)."""
        if self._lmaps is None:
            p = self.plan

            def ix(a):
                return torch.as_tensor(np.asarray(a, dtype=np.int64),
                                       device=self.device)

            maps = dict(row=ix(p.node_row), lane=ix(p.node_lane))
            if p.copy_dst_rows is not None and len(p.copy_dst_rows):
                maps.update(
                    cdr=ix(p.copy_dst_rows), cdl=ix(p.copy_dst_lanes),
                    csr=ix(p.copy_src_rows), csl=ix(p.copy_src_lanes),
                )
            self._lmaps = maps
        return self._lmaps

    def to_lane_dev(self, u_flat: torch.Tensor) -> torch.Tensor:
        """plan.to_lane, device-side (flat byVDIM -> (bs, R, 128) with
        copies filled) -- no host roundtrip."""
        m = self._lane_maps_dev()
        u = u_flat.reshape(self.plan.n_nodes, self.bs).T
        out = torch.zeros((self.bs, self.plan.R, N_LANES), dtype=u.dtype,
                          device=u.device)
        out[:, m["row"], m["lane"]] = u
        if "cdr" in m:
            out[:, m["cdr"], m["cdl"]] = out[:, m["csr"], m["csl"]]
        return out

    def from_lane_dev(self, u_lane: torch.Tensor) -> torch.Tensor:
        """plan.from_lane, device-side ((bs, R, 128) -> flat byVDIM)."""
        m = self._lane_maps_dev()
        return u_lane[:, m["row"], m["lane"]].T.reshape(-1)

    def prepare_coeffs(self, coeffs: Dict[str, np.ndarray]):
        """Pre-gather coefficient values per cell in lane-cell order
        (frozen during a solve -- the quadrature cache of MFEM/...cc:
        1317-1324). The gather runs on the host; values may be numpy
        arrays or tensors. A fused engine adds the entry ``_cd``: the
        coefficient rows, in the order of ``functional.coefficients``,
        re-blocked per bin (G, Dc, kc, 128) for the fused kernel."""
        host = {}
        for name, dm in self._coeff_dofmaps.items():
            c = coeffs[name]
            if isinstance(c, torch.Tensor):
                c = c.detach().cpu().numpy()
            per_cell = np.asarray(c)[dm]  # (nc, ndc)
            host[name] = np.ascontiguousarray(
                per_cell[self._safe_order].T
            )  # (ndc, M)
        out = {k: self._store(v) for k, v in host.items()}
        if host and self._fused:
            p = self.plan
            cdc = np.concatenate(
                [host[c.name] for c in self.functional.coefficients], axis=0)
            cdc = cdc.reshape(-1, p.G, p.kc, N_LANES).transpose(1, 0, 2, 3)
            out["_cd"] = self._store(np.ascontiguousarray(cdc))
        return out

    # -- movement pieces --------------------------------------------------------

    def _gather_cells(self, u_lane):
        """(bs, R, 128) -> per-cell dof values (nd, M) cells-minor."""
        p = self.plan
        g = lane_gather_cm(
            u_lane, self.gather_starts, self.gather_idx, wr=p.wg,
            n_ch=p.nv * self.bs,
        )  # (nd, G, kc, 128) -- dof row v*bs+c, free reshape to (nd, M)
        return g.reshape(p.nv * self.bs, p.G * p.kc * N_LANES)

    def _scatter_cells(self, ev):
        """Element vectors (nd, M) -> consistent nodal (bs, R, 128)."""
        p = self.plan
        bs = self.bs
        src = ev.reshape(p.nv * bs, p.G, p.kc, N_LANES).contiguous()
        part = lane_scatter_cm(
            src, self.gather_idx, k_out=p.wg, n_ch=bs,
            table=self.scatter_table,
        )  # (bs, G, wg, 128)
        return self._owner_refresh(part)

    def _owner_refresh(self, part):
        """Bin partials (bs, G, wg, 128) -> consistent nodal state:
        owner-sum the copy partials, then refresh copy slots. Both
        stages run as ONE multi-pass kernel each. ``part`` is consumed
        (the tail update may write into it)."""
        p = self.plan
        bs = part.shape[0]
        flat = part.reshape(bs, p.R, N_LANES)
        if self._owner_idx is not None:
            flat = lane_pass_update(
                flat, self._owner_starts, self._owner_idx,
                wrs=self.owner_wrs, wg=p.wg, shifts=self.owner_shifts,
                head=True,
            ).reshape(bs, p.R, N_LANES)
        if self._tail_copy is not None:
            # tail owner-sum: copy partials (untouched by the dense
            # kernel) added into their owner slots, in table order
            f2 = flat.reshape(bs, p.R * N_LANES)
            ext = torch.cat([f2, f2.new_zeros((bs, 1))], dim=1)
            add = ext[:, self._tail_sum_idx[0]]
            for k in range(1, self._tail_sum_idx.shape[0]):
                add = add + ext[:, self._tail_sum_idx[k]]
            f2[:, self._tail_owner_u] = f2[:, self._tail_owner_u] + add
        return self.refresh_copies(flat)

    def refresh_copies(self, total):
        """Overwrite copy slots with home-slot totals (scatter_fwd within
        the chip). Returns a new tensor."""
        p = self.plan
        bs = total.shape[0]
        fresh = False
        if self._refresh_idx is not None:
            total = lane_pass_update(
                total, self._refresh_starts, self._refresh_idx,
                wrs=self.refresh_wrs, wg=p.wg,
                shifts=tuple(-s for s in self.refresh_shifts),
                head=False,
            ).reshape(bs, p.R, N_LANES)
            fresh = True
        if self._tail_copy is not None:
            # tail refresh: copy slots (zeroed by the dense kernel's
            # full-tail write) set from their owner slots
            if not fresh:
                total = total.clone()
            f2 = total.reshape(bs, p.R * N_LANES)
            f2[:, self._tail_copy] = f2[:, self._tail_owner]
        return total

    # -- assembled quantities ------------------------------------------------------

    def _geom(self, dtype):
        """The path's static cell tables at ``dtype``: (dN, w, xq) for the
        P1 and multi-qp paths, (x_lane,) for the generic one."""
        if self._gen is not None:
            return (self.x_lane.to(dtype),)
        return (self.geom_dN.to(dtype), self.geom_w.to(dtype),
                self.geom_xq.to(dtype))

    def _apply_geom(self, dtype):
        """What the tangent application and the diagonal read besides the
        linearization: dN (None on the generic path)."""
        return None if self.geom_dN is None else self.geom_dN.to(dtype)

    def residual(self, u_lane, coeff_cells) -> torch.Tensor:
        if self._fused:
            r = self._fused_apply((u_lane,), coeff_cells)
        else:
            u_cells = self._gather_cells(u_lane)
            ev = self._red_res(u_cells, coeff_cells,
                               *self._geom(u_lane.dtype))
            r = self._scatter_cells(ev)
        return self._facet_grad(r, u_lane)

    def linearize_cells(self, u_cells, coeff_cells,
                        u_lane=None) -> ElementTangent:
        """The physics linearized at an already gathered state: the
        per-cell Hessian of the path (the P1 path's nR x nR table of (M,)
        tensors, the multi-qp path's (nr, nr, nq, M), the generic path's
        element matrices (nd, nd, M)) and the facet Hessians, read from
        the cells through ``ucpos`` (or from ``u_lane``). Everything
        linear in the state --
        tangent actions, the diagonal -- is multiply-adds on it.

        The reference re-differentiates per application (a JVP under
        ``jit`` costs nothing extra there); in eager PyTorch a JVP per CG
        iteration replays the whole AD machinery on the host, so the
        differentiation is hoisted out of the iteration."""
        H = self._red_linearize(u_cells, coeff_cells,
                                *self._geom(u_cells.dtype))
        return ElementTangent(H, self.facet_hessians(u_lane, u_cells))

    def linearize(self, u_lane, coeff_cells) -> ElementTangent:
        """J(u) taken once, from the gathered state."""
        return self.linearize_cells(self._gather_cells(u_lane), coeff_cells,
                                    u_lane)

    def tangent_action(self, u_lane, coeff_cells, v_lane) -> torch.Tensor:
        """J(u) v -- element-level tangent between the (linear) movements."""
        return self.make_tangent(u_lane, coeff_cells)(v_lane)

    def make_tangent(self, u_lane, coeff_cells, lin=None):
        """v -> J(u) v closure for a frozen linearization state. Staged:
        every application is gather -> multiply-adds on the stored
        per-cell Hessian -> scatter (``lin``: a ``linearize`` result to
        reuse). Fused: every application is the fused kernel on
        ``(u, v)``; the cell part of ``lin`` is not read. The facet
        Hessians (of ``lin``, or taken here) are applied after either."""
        if self._fused:
            facets = (lin.facets if lin is not None
                      else self.facet_hessians(u_lane=u_lane))

            def apply_fused(v_lane):
                y = self._fused_apply((u_lane, v_lane), coeff_cells)
                return self._facet_apply(y, facets, v_lane)

            return apply_fused
        lin = self.linearize(u_lane, coeff_cells) if lin is None else lin
        return self._lin_apply(lin, self._apply_geom(u_lane.dtype))

    def _lin_apply(self, lin: ElementTangent, dN):
        def apply(v_lane):
            v_cells = self._gather_cells(v_lane)
            y = self._scatter_cells(self._red_apply(lin.cells, v_cells, dN))
            return self._facet_apply(y, lin.facets, v_lane)

        return apply

    def tangent_from_cells(self, u_cells, coeff_cells, v_lane):
        """J(u) v with the linearization state already gathered."""
        lin = self.linearize_cells(u_cells, coeff_cells)
        return self._lin_apply(lin, self._apply_geom(v_lane.dtype))(v_lane)

    def diagonal(self, u_lane, coeff_cells, lin=None) -> torch.Tensor:
        """Jacobian diagonal (Jacobi PC) in lane layout: the diagonals of
        the per-cell element matrices (row i of the tangent applied to
        the i-th unit element vector; in closed form on the multi-qp and
        generic paths), scattered like a residual, and the facet
        Hessians' diagonals."""
        lin = self.linearize(u_lane, coeff_cells) if lin is None else lin
        H = lin.cells
        dN = self._apply_geom(u_lane.dtype)
        if self._red_diag is not None:  # multi-qp / generic: closed form
            d = self._scatter_cells(self._red_diag(H, dN))
        else:
            nd = self.plan.nv * self.bs
            rows = []
            for i in range(nd):
                e_i = torch.zeros((nd, dN.shape[-1]), dtype=dN.dtype,
                                  device=dN.device)
                e_i[i] = 1.0
                rows.append(self._red_apply(H, e_i, dN)[i])
            d = self._scatter_cells(torch.stack(rows))
        return self._facet_diag(d, lin.facets)

    def cell_energies(self, u_lane, coeff_cells) -> torch.Tensor:
        """Per-lane-cell energies (M,), zero at padded cells."""
        u_cells = self._gather_cells(u_lane)
        e = self._red_energy(u_cells, coeff_cells,
                             *self._geom(u_lane.dtype))
        valid = torch.as_tensor(np.asarray(self.plan.cell_valid),
                                device=e.device)
        return torch.where(valid, e, torch.zeros_like(e))

    def dot(self, a, b) -> torch.Tensor:
        """Inner product counting every node once (copies weighted 0)."""
        return torch.sum(a * b * self.owned_w.to(a.dtype))

    # -- solver -------------------------------------------------------------------

    def make_solver(self, cfg: Optional[SolverConfig] = None, *,
                    cg_chunk: int = 100, fine_coeffs=None, twolevel_nc=None,
                    const_residual=None):
        """Chunked Newton-Krylov on the lane layout.

        ``cg_chunk`` CG iterations are enqueued between two reads of the
        device state; the tolerance is tested EVERY iteration on the
        device (a flag that freezes the state once it is met, and a
        device iteration counter), so the exit iteration is set by the
        math and does not depend on ``cg_chunk``.

        ``cfg.preconditioner``: ``'jacobi'`` or ``'twolevel'`` -- the
        lattice-coarse two-level cycle (``lane.twolevel``), which needs
        ``fine_coeffs`` (flat coefficient vectors, for lattice sampling)
        and takes ``twolevel_nc`` lattice cells per side. Its geometry is
        built once per solver; its smoother data once per Newton step,
        from that step's Jacobi diagonal and CG operator.

        The CG operator (and, under ``'twolevel'``, the smoother's) is
        ``make_tangent``: the fused kernel in Hessian-vector mode on the
        frozen ``u`` for a fused engine, the stored per-cell Hessian for
        a staged one. The reference applies the staged element JVP under
        ``'twolevel'``, the same operator to rounding. The Jacobi
        diagonal comes from one ``linearize`` per Newton step."""
        cfg = cfg or SolverConfig()
        eng = self
        use_tl = cfg.preconditioner == "twolevel"
        if cfg.preconditioner not in ("jacobi", "twolevel"):
            raise ValueError(
                f"preconditioner={cfg.preconditioner!r}: the lane solver "
                "runs 'jacobi' and 'twolevel' (the reference's make_solver "
                "runs Jacobi for any other name without a word, "
                "tpufem/lane/engine.py:1620; 'amg' runs in "
                "make_mixed_solver)"
            )
        if use_tl and fine_coeffs is None:
            raise ValueError("twolevel needs fine_coeffs")
        _tl = {}  # two-level geometry, built at the first Newton step
        _cr = None if const_residual is None else torch.as_tensor(
            const_residual, device=eng.device
        )

        def rhs(u, coeffs, free):
            r = eng.residual(u, coeffs)
            if _cr is not None:
                r = r + _cr.to(u.dtype)
            b = -r * free
            return b, torch.sqrt(eng.dot(b, b))

        def solve(u0_lane, coeff_cells):
            free = eng.free_lane.to(u0_lane.dtype)
            u = torch.where(free > 0, u0_lane,
                            eng.bc_lane.to(u0_lane.dtype))
            r0 = None
            total_cg = 0
            cg_seconds = 0.0  # wall time of the CG loops (device included)
            tl_seconds = 0.0  # two-level set-up: geometry + smoother data
            cg_iters = []  # per-Newton MATHEMATICAL exit iterations
            cg_enqueued = []  # per-Newton iterations enqueued (frozen tail too)
            residuals = []  # |b| at every Newton residual check
            it = 0
            for it in range(1, cfg.newton_maxit + 1):
                b, bnorm = rhs(u, coeff_cells, free)
                bnorm = float(bnorm)
                residuals.append(bnorm)
                if r0 is None:
                    r0 = bnorm
                if bnorm < max(cfg.newton_rtol * r0, cfg.newton_atol):
                    it -= 1
                    break
                dinv, A = _linear_system(eng, u, coeff_cells, free)
                if use_tl:
                    t_tl = time.perf_counter()
                    M = _twolevel(eng, _tl, fine_coeffs, twolevel_nc, u,
                                  coeff_cells, free, dinv, A)
                    tl_seconds += time.perf_counter() - t_tl
                else:
                    def M(r):
                        return dinv * r

                z0 = M(b)
                tol = max(cfg.cg_rtol * bnorm, cfg.cg_atol)
                _sync(b.device)  # the set-up above must not count as CG time
                t_cg = time.perf_counter()
                x, k, enq = _chunked_pcg(eng, A, M, b, z0, tol, cfg.cg_maxit,
                                         cg_chunk)
                cg_seconds += time.perf_counter() - t_cg
                # backtracking damping: the asym damage law is only
                # piecewise-smooth (branch flips on eigenvalue signs),
                # and full Newton steps can overshoot; halve until the
                # residual norm does not increase (<=6 halvings)
                step = x * free
                alpha = 1.0
                for _ in range(6):
                    _, bn_new = rhs(u + alpha * step, coeff_cells, free)
                    if float(bn_new) <= bnorm * (1.0 + 1e-12):
                        break
                    alpha *= 0.5
                u = u + alpha * step
                total_cg += k
                cg_iters.append(k)
                cg_enqueued.append(enq)
                if cfg.verbose:
                    print(
                        f"lane Newton {it}: |r| = {bnorm:.6e} (cg {k}"
                        + (f", damping {alpha}" if alpha < 1.0 else "")
                        + ")", flush=True
                    )
            b, bnorm = rhs(u, coeff_cells, free)
            bnorm = float(bnorm)
            converged = bnorm < max(cfg.newton_rtol * (r0 or bnorm or 1.0),
                                    cfg.newton_atol)
            return u, dict(
                newton_iters=it, total_cg_iters=total_cg,
                cg_iters=cg_iters, cg_enqueued=cg_enqueued,
                residuals=residuals,
                cg_seconds=cg_seconds, twolevel_setup_seconds=tl_seconds,
                final_residual=bnorm, r0=r0 or bnorm, converged=converged,
            )

        return solve

    def make_mixed_solver(self, cfg: Optional[SolverConfig] = None, *,
                          cg_chunk: int = 20, fine_coeffs=None,
                          checkpoint_path: Optional[str] = None,
                          const_residual=None):
        """Mixed-precision defect-correction Newton-Krylov.

        The outer loop runs in float64: every Newton step takes one
        residual through the flat ``Assembler`` (in cell slabs of
        ``_F64_BATCH`` cells) plus ``const_residual`` (a flat float64
        vector added to every residual: the constant load vector), tests it
        against r0 and applies the step to the float64 iterate. Every CG
        solve runs on this engine, in its dtype (float32 as ``run`` builds
        it), against the right-hand side normalized by ``scale = |b|``, to
        ``max(cg_rtol, cg_atol / scale)``. So the iterate converges to the
        float64 root, which the inner dtype alone cannot reach (float32
        lane solves stop near 1e-6 * r0). The functional must be float64
        (its geometry feeds the outer residual).

        Returns ``solve(u0_flat, coeffs_flat, coeff_cells) -> (u, stats)``:
        ``u0_flat`` the (n_dofs,) byVDIM start (its Dirichlet entries are
        overwritten), ``coeffs_flat`` the flat coefficient vectors (also
        the two-level lattice sampling source unless ``fine_coeffs`` is
        given), ``coeff_cells`` what :meth:`prepare_coeffs` returned; ``u``
        a float64 tensor. ``stats`` has the reference's keys
        (``newton_iters``, ``total_cg_iters``, ``cg_iters``,
        ``final_residual``, ``r0``, ``converged``, ``phase_s``: seconds
        per stage, each ending on a device sync) and ``residuals`` (|b|
        at every Newton check) and ``cg_enqueued`` (CG iterations
        enqueued per Newton step).

        ``cfg.preconditioner``: ``'jacobi'``, ``'twolevel'`` (geometry
        built once per solver, smoother data every Newton step) or
        ``'amg'`` (the SA-AMG hierarchy of ``la.amg``, built once per
        solver on the host from the flat ``Assembler.matrix`` assembled in
        the engine's dtype at the first iterate, and frozen; one V-cycle
        per application in the flat layout, through ``from_lane_dev`` /
        ``to_lane_dev``; its set-up goes to ``phase_s["tl_setup"]``, split
        in ``stats["amg"]`` with the levels' shapes and bytes), with
        :meth:`make_solver`'s CG loop and operator (``make_tangent``).
        ``cg_chunk``: CG iterations between two host reads (the
        reference's callers pass 20 under two-level, 200 under Jacobi);
        the stall guard reads chunk boundaries, so the chunk size is part
        of the CG counts. Line search: inner-dtype residual norms
        at alpha = 1, 1/2, ..., 1/64, taking the first within (1 + 1e-4)
        of the current norm (1/64 if none is).

        ``checkpoint_path``: after every Newton step the float64 iterate,
        the step's number, r0 and the CG total go atomically to that file
        (``io.checkpoint``), with a sha256 fingerprint of the configuration
        and of every coefficient and ``const_residual``, each whole; a
        later solve with the same fingerprint resumes after that step, any
        other ignores the file. A converged solve deletes it."""
        from tpufem_torch.assemble.assembler import Assembler
        from tpufem_torch.io.checkpoint import load_checkpoint, save_checkpoint

        cfg = cfg or SolverConfig()
        if cfg.preconditioner not in ("jacobi", "twolevel", "amg"):
            raise ValueError(
                f"preconditioner={cfg.preconditioner!r}: the mixed solver "
                "runs 'jacobi', 'twolevel' and 'amg' (the reference's "
                "make_mixed_solver runs Jacobi for any other name without "
                "a word, tpufem/lane/engine.py:2045-2046)")
        if self.functional.dtype != torch.float64:
            raise ValueError(
                "make_mixed_solver: the outer residual runs through the flat "
                "Assembler in float64; build the functional with "
                f"dtype=torch.float64 (it has {self.functional.dtype})")
        use_tl = cfg.preconditioner == "twolevel"
        use_amg = cfg.preconditioner == "amg"
        idt = self.dtype
        asm = Assembler(self.functional, self.bcs)
        dev, f64 = self.device, torch.float64
        bc_dofs, bc_vals, _ = combine_bcs(self.bcs, self.space.n_dofs)
        bc_dofs = torch.as_tensor(bc_dofs.astype(np.int64), device=dev)
        bc_vals = torch.as_tensor(bc_vals, dtype=f64, device=dev)
        free64 = asm.free_mask(f64)
        free_in = self.free_lane
        cr64 = None if const_residual is None else torch.as_tensor(
            const_residual, dtype=f64, device=dev)
        cr_in = None if cr64 is None else self.to_lane_dev(cr64.to(idt))
        _tl = {}  # two-level geometry or AMG hierarchy, at the first step

        def amg_setup(u, coeffs64):
            """The hierarchy from the flat matrix in the inner dtype at
            ``u``, timed in its parts; on the engine's device."""
            from tpufem_torch.la.amg import assembler_hierarchy, ell_to_scipy

            parts = {}
            t0 = time.perf_counter()
            mat = asm.matrix(u.to(idt),
                             {k: v.to(idt) for k, v in coeffs64.items()},
                             batch=_F64_BATCH)
            _sync(dev)
            parts["matrix"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            A = ell_to_scipy(mat)
            del mat
            parts["to_host"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            hier = assembler_hierarchy(asm, A, cfg, dtype=idt)
            del A
            parts["hierarchy"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            hier = hier.to(dev)
            _sync(dev)
            parts["upload"] = time.perf_counter() - t0
            return hier, dict(setup_s=parts, levels=hier.shapes(),
                              device_bytes=hier.nbytes())

        def rhs64(u, coeffs64):
            r = asm.residual(u, coeffs64, batch=_F64_BATCH)
            if cr64 is not None:
                r = r + cr64
            b = -r * free64
            return b, float(torch.sqrt(torch.dot(b, b)))

        def norm_in(u_in, coeffs_in):
            r = self.residual(u_in, coeffs_in)
            if cr_in is not None:
                r = r + cr_in
            b = r * free_in
            return float(torch.sqrt(self.dot(b, b)))

        def fingerprint(coeffs_flat):
            arrays = dict(coeffs_flat)
            if const_residual is not None:
                arrays["const_residual"] = const_residual
            return _fingerprint((
                int(self.space.n_dofs), int(self.bs),
                cfg.newton_rtol, cfg.newton_atol, cfg.newton_maxit,
                cfg.cg_rtol, cfg.cg_atol, cfg.cg_maxit,
                cfg.preconditioner, str(idt).replace("torch.", ""),
            ), arrays)

        def solve(u0_flat, coeffs_flat, coeff_cells):
            ph = dict(rhs=0.0, diag=0.0, tl_setup=0.0, tl_refresh=0.0,
                      z0=0.0, cg=0.0, linesearch=0.0, transfer=0.0,
                      checkpoint=0.0)
            coeffs64 = {k: torch.as_tensor(_host(v), dtype=f64, device=dev)
                        for k, v in coeffs_flat.items()}
            coeffs_in = {k: v.to(idt) for k, v in coeff_cells.items()}
            fine_c = {k: _host(v) for k, v in (
                fine_coeffs if fine_coeffs is not None else coeffs_flat
            ).items()}
            u = torch.as_tensor(u0_flat, dtype=f64, device=dev).clone()
            u[bc_dofs] = bc_vals
            r0 = None
            total_cg = 0
            cg_iters, cg_enqueued, residuals = [], [], []
            it = 0
            it0 = 1
            fp = None
            if checkpoint_path is not None:
                fp = fingerprint(coeffs_flat)
                if os.path.exists(checkpoint_path):
                    ck = load_checkpoint(checkpoint_path)
                    ck_fp = str(ck["fingerprint"]) if "fingerprint" in ck \
                        else None
                    if ck_fp != fp:
                        print(f"mixed Newton: checkpoint {checkpoint_path} "
                              "has a different problem/config fingerprint "
                              "-- ignoring it (fresh solve)", flush=True)
                    else:
                        u = torch.as_tensor(ck["u"], dtype=f64, device=dev)
                        r0 = float(ck["r0"])
                        total_cg = int(ck["total_cg"])
                        it0 = int(ck["it"]) + 1
                        # a run that used up newton_maxit leaves the loop
                        # below empty: report the checkpoint's count
                        it = it0 - 1
                        print(f"mixed Newton: resumed from {checkpoint_path}"
                              f" (after iteration {int(ck['it'])})",
                              flush=True)
            for it in range(it0, cfg.newton_maxit + 1):
                t0 = time.perf_counter()
                b64, bnorm = rhs64(u, coeffs64)
                ph["rhs"] += time.perf_counter() - t0
                residuals.append(bnorm)
                if r0 is None:
                    r0 = bnorm
                if bnorm < max(cfg.newton_rtol * r0, cfg.newton_atol):
                    it -= 1
                    break
                scale = bnorm if bnorm > 0 else 1.0
                t0 = time.perf_counter()
                # cast first, so the lane scatters run in the inner dtype
                u_in = self.to_lane_dev(u.to(idt))
                b_in = self.to_lane_dev((b64 * (1.0 / scale)).to(idt))
                _sync(dev)
                ph["transfer"] += time.perf_counter() - t0
                t0 = time.perf_counter()
                dinv, A = _linear_system(self, u_in, coeffs_in, free_in)
                _sync(dev)
                ph["diag"] += time.perf_counter() - t0
                if use_tl:
                    t0 = time.perf_counter()
                    _twolevel_geo(self, _tl, fine_c, None)
                    _sync(dev)
                    ph["tl_setup"] += time.perf_counter() - t0
                    t0 = time.perf_counter()
                    M = _twolevel(self, _tl, fine_c, None, u_in, coeffs_in,
                                  free_in, dinv, A)
                    _sync(dev)
                    ph["tl_refresh"] += time.perf_counter() - t0
                elif use_amg:
                    if "hier" not in _tl:
                        t0 = time.perf_counter()
                        _tl["hier"], _tl["amg"] = amg_setup(u, coeffs64)
                        ph["tl_setup"] += time.perf_counter() - t0

                    def M(r, hier=_tl["hier"]):
                        return self.to_lane_dev(vcycle(
                            hier, self.from_lane_dev(r),
                            degree=cfg.amg_degree))
                else:
                    def M(r):
                        return dinv * r
                t0 = time.perf_counter()
                z0 = M(b_in)
                _sync(dev)
                ph["z0"] += time.perf_counter() - t0
                # the inner tolerance is relative to the normalized rhs
                tol = max(cfg.cg_rtol, cfg.cg_atol / scale)
                t0 = time.perf_counter()
                x, k, enq = _chunked_pcg(self, A, M, b_in, z0, tol,
                                         cfg.cg_maxit, cg_chunk)
                ph["cg"] += time.perf_counter() - t0
                # backtracking damping on inner-dtype residual norms: the
                # first alpha in 1, 1/2, ..., 1/64 whose norm does not
                # exceed the current one by more than 1e-4 (rounding
                # noise: near the root the full step ties and is taken;
                # the next float64 residual decides convergence)
                step_in = x * free_in
                t0 = time.perf_counter()
                r_cur = norm_in(u_in, coeffs_in)
                sc_in = torch.as_tensor(scale, dtype=idt, device=dev)
                for j in range(7):
                    alpha = 0.5 ** j
                    if norm_in(u_in + (sc_in * alpha) * step_in,
                               coeffs_in) <= r_cur * (1.0 + 1e-4):
                        break
                ph["linesearch"] += time.perf_counter() - t0
                u = u + (alpha * scale) * self.from_lane_dev(step_in).to(f64)
                total_cg += k
                cg_iters.append(k)
                cg_enqueued.append(enq)
                if cfg.verbose:
                    print(
                        f"mixed Newton {it}: |r| = {bnorm:.6e} (cg {k}"
                        + (f", damping {alpha}" if alpha < 1.0 else "")
                        + ")", flush=True
                    )
                if checkpoint_path is not None:
                    # atomic: a crash mid-write leaves the last complete
                    # file in place
                    t0 = time.perf_counter()
                    tmp = checkpoint_path + ".tmp.npz"
                    save_checkpoint(tmp, dict(
                        u=u.cpu().numpy(), it=it, total_cg=total_cg, r0=r0,
                        fingerprint=fp))
                    os.replace(tmp, checkpoint_path)
                    ph["checkpoint"] += time.perf_counter() - t0
            _, bnorm = rhs64(u, coeffs64)
            converged = bnorm < max(cfg.newton_rtol * (r0 or bnorm or 1.0),
                                    cfg.newton_atol)
            if checkpoint_path is not None and converged:
                # a converged solve's checkpoint must not seed the next run
                for path in (checkpoint_path, checkpoint_path + ".tmp.npz"):
                    if os.path.exists(path):
                        os.remove(path)
            stats = dict(
                newton_iters=it, total_cg_iters=total_cg,
                cg_iters=cg_iters, cg_enqueued=cg_enqueued,
                residuals=residuals, final_residual=bnorm, r0=r0 or bnorm,
                converged=converged, phase_s=ph,
            )
            if "amg" in _tl:
                stats["amg"] = _tl["amg"]
            return u, stats

        return solve

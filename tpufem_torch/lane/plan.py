"""Host-side planner for the lane-partitioned unstructured layout.

Nodes are split into 128 vertical strips (equal node count, by x), each
strip sorted by y and chopped into *bins* of ``wg_own`` nodes; bin g of
lane j occupies rows [g*wg, g*wg + wg) of column j in every (R, 128)
state array (wg = wg_own + copy rows). Cells are assigned to the home
bin of their first node; any cell node whose home is a different bin
gets a *copy slot* inside the cell's bin, so every per-cell access is a
row offset inside one bin window — the shape the measured-fast windowed
select kernels need (benchmarks/gather_kernel_probe4.py).

This is the owner/ghost construction of the reference's IndexMap
(FEniCSx/mechanic2d/asym_elasto_damage_model.cc:325-344) applied at
vector-lane granularity: owned rows = size_local, copy rows = ghosts,
owner-sum = scatter_rev(add), copy refresh = scatter_fwd.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

N_LANES = 128


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class LanePlan:
    n_nodes: int
    n_cells: int
    nv: int  # nodes per cell
    wg_own: int
    wg: int  # bin window rows (own + copies, 8-aligned)
    G: int  # bins per lane
    kc: int  # padded cells per bin
    R: int  # total rows = G * wg

    # node <-> slot maps (home slots)
    node_row: np.ndarray  # (n_nodes,) home row in [0, R)
    node_lane: np.ndarray  # (n_nodes,)
    owned_mask: np.ndarray  # (R, 128) bool — true at home slots

    # cell order: lane cell column m = (g*kc + k)*128 + j  -> global cell
    cell_order: np.ndarray  # (G*kc*128,) global cell id or -1
    cell_valid: np.ndarray  # (G*kc*128,) bool

    # kernel plans
    gather_idx: np.ndarray  # (G, nv, kc, 128) int32 in [-1, wg)
    gather_starts: np.ndarray  # (G,) int32 = g*wg
    # owner-sum passes: (p, q, idx, start, wr) — idx (G, 1, wg_own, 128)
    # holds GROUP-RELATIVE source ranks in [-1, wr); start (G,) is the
    # absolute source-window row per owner bin row; wr is the static
    # window height (max group span over bins). Copies are sorted by
    # (bin, (p, q)) so each pass's source rows sit in a narrow window —
    # the pass kernels loop wr rows instead of the whole copy region
    # (8 passes x full wg_copy was 62% of the fused poly residual).
    owner_passes: List[Tuple[int, int, np.ndarray, np.ndarray, int]]
    # refresh passes: (p, q, idx, start, wr) — idx (G, 1, wg_copy, 128)
    # holds source rows relative to the pass's own-window start
    refresh_passes: List[Tuple[int, int, np.ndarray, np.ndarray, int]]
    # tail copies: rare (p, q) combinations (below pass_min_frac of all
    # copies) excluded from the dense kernels; handled as flat-slot
    # gather/scatter pairs (copy slot <-> owner slot, row*128+lane)
    tail_copy_slot: np.ndarray = None  # (n_tail,) int64
    tail_owner_slot: np.ndarray = None  # (n_tail,) int64

    @property
    def wg_copy(self) -> int:
        return self.wg - self.wg_own

    # -- layout conversions (host) --------------------------------------------

    def to_lane(self, u_flat: np.ndarray, bs: int) -> np.ndarray:
        """byVDIM flat (n_nodes*bs,) -> (bs, R, 128) with copies filled."""
        u = np.asarray(u_flat).reshape(self.n_nodes, bs)
        out = np.zeros((bs, self.R, N_LANES), dtype=u.dtype)
        out[:, self.node_row, self.node_lane] = u.T
        # fill copies so the result is consistent without a device refresh
        if len(self.copy_dst_rows):
            out[:, self.copy_dst_rows, self.copy_dst_lanes] = out[
                :, self.copy_src_rows, self.copy_src_lanes
            ]
        return out

    def from_lane(self, u_lane: np.ndarray, bs: int) -> np.ndarray:
        u_lane = np.asarray(u_lane)
        out = u_lane[:, self.node_row, self.node_lane].T  # (n_nodes, bs)
        return out.reshape(-1)

    # copy slots (vectorized fill tables), set by the builder
    copy_dst_rows: np.ndarray = None
    copy_dst_lanes: np.ndarray = None
    copy_src_rows: np.ndarray = None
    copy_src_lanes: np.ndarray = None
    # per-lane strip extents [min_x, max_x] (for transfer operators)
    strip_x: np.ndarray = None  # (128, 2)
    # node coordinates per slot (slot-indexed convenience views)
    slot_x: np.ndarray = None  # (R, 128) x or nan at padding
    slot_y: np.ndarray = None


def _spill_pass(cand: np.ndarray, cur: np.ndarray, n_keys: int,
                target: int, *, max_rounds: int = 8,
                max_depth: int = 12) -> np.ndarray:
    """Force the balance's overloaded tail down to ``target``. Returns
    the final bin KEY per cell (not a candidate index — see teleports).

    The round/quota balance (native and NumPy) only moves cells into
    candidate bins of MAXIMAL residency — right for the bulk (copies
    stay shared), but it strands a tail of bins a few cells over
    target (measured: 1711 of 16512 bins at 33-40 on a 524k-cell
    jittered polycrystal with target 32), and the worst bin alone sets
    the padded kc for the whole grid — 26% dead cell slots in every
    fused kernel launch. Direct moves can't fix it: ~75% of bins sit
    exactly AT target, so an overloaded cell's candidates are full.

    Stage 1 routes the excess along augmenting paths, vectorized as a
    pressure cascade: per round, a bin-level BFS labels every bin with
    its distance phi to a bin with room (edges = "some cell homed in u
    has v as a candidate"), then a single sweep from the deepest level
    down pushes excess cells strictly downhill (phi[dest] ==
    phi[src] - 1, preferring high residency then low load),
    overfilling intermediate bins whose own excess is pushed onward
    later in the same sweep — one unit of excess travels its whole
    path per round.

    Stage 2 (teleports) handles the locally-infeasible leftovers (a
    few cells whose candidate-graph neighborhood is saturated): they
    are homed in the nearest bin with room even though NONE of their
    nodes live there — legal by construction (all nv nodes become
    copy slots; rare distant copies ride the flat-gather tail path),
    and it makes max load == target unconditional, since total
    capacity n_keys*target >= nc. Runs identically for the native and
    NumPy balance paths (plan parity stays field-exact).

    ``cur`` holds the current bin KEY per cell (copied and returned).
    """
    nc, nv = cand.shape
    cur = np.asarray(cur).copy()
    loads = np.bincount(cur, minlength=n_keys)
    if loads.max() <= target:
        return cur
    # residency of each candidate (copy-cost tie-break, cheap: nv<=8)
    resident = (cand[:, :, None] == cand[:, None, :]).sum(
        axis=2, dtype=np.int8
    )
    big = np.int32(max_depth + 1)
    for _ in range(max_rounds):
        if loads.max() <= target:
            break
        # --- bin-level BFS: phi = hops to a bin with room ------------------
        # relax on the deduplicated bin graph (u -> v when some cell
        # homed in u has v as a candidate): identical phi to per-cell
        # relaxation, ~10x cheaper at millions of cells
        upair = np.unique(
            cur[:, None] * np.int64(n_keys) + cand
        )
        eu = (upair // n_keys).astype(np.int64)
        ev = (upair % n_keys).astype(np.int64)
        phi = np.where(loads < target, np.int32(0), big)
        for _ in range(max_depth):
            new = phi.copy()
            np.minimum.at(new, eu, phi[ev] + np.int32(1))
            if (new == phi).all():
                break
            phi = new
        # --- drain the excess down the phi gradient ------------------------
        # One sweep from the highest level to 1: excess moved into a
        # level-(d-1) bin is pushed onward when that level is processed,
        # so a unit of excess travels its whole path to a room bin in a
        # single round (one hop per round converges ~5x slower).
        dmax = int(phi[loads > target].max())
        if dmax > max_depth:
            dmax = int(
                phi[(loads > target) & (phi <= max_depth)].max()
            ) if ((loads > target) & (phi <= max_depth)).any() else 0
        moved_any = False
        for d in range(dmax, 0, -1):
            src_over = (loads[cur] > target) & (phi[cur] == d)
            movers = np.nonzero(src_over)[0]
            if len(movers) == 0:
                continue
            pc = phi[cand[movers]]  # (m, nv)
            down = pc == (d - 1)
            hasd = down.any(axis=1)
            movers, down = movers[hasd], down[hasd]
            if len(movers) == 0:
                continue
            # best downhill candidate: max residency, then min load
            key = np.where(
                down,
                resident[movers].astype(np.int64) * (nc + 1)
                - loads[cand[movers]],
                np.int64(np.iinfo(np.int64).min),
            )
            best = key.argmax(axis=1)
            dest = cand[movers, best]
            # per-source quota: only the excess may leave (stable order)
            srcb = cur[movers]
            order_m = np.argsort(srcb, kind="stable")
            sb = srcb[order_m]
            rank_src = np.arange(len(sb)) - np.searchsorted(sb, sb)
            go = rank_src < (loads[sb] - target)
            movers, dest = movers[order_m][go], dest[order_m][go]
            # per-dest quota into ROOM bins (phi==0): cap by room so
            # they never flip overloaded; intermediates may overfill
            # (they drain at the next level iteration)
            is_room = phi[dest] == 0
            order_d = np.argsort(dest, kind="stable")
            db = dest[order_d]
            rank_d = np.arange(len(db)) - np.searchsorted(db, db)
            cap = np.where(
                is_room[order_d], (target - loads[db]).clip(min=0),
                np.int64(nc),
            )
            keep = rank_d < cap
            movers, dest = movers[order_d][keep], dest[order_d][keep]
            if len(movers) == 0:
                continue
            np.subtract.at(loads, cur[movers], 1)
            np.add.at(loads, dest, 1)
            cur[movers] = dest
            moved_any = True
        if not moved_any:
            break
    # --- stage 2: teleport the stubborn leftovers --------------------------
    over = np.nonzero(loads > target)[0]
    if len(over):
        room_bins = np.nonzero(loads < target)[0]
        room = (target - loads[room_bins]).astype(np.int64)
        order_c = np.argsort(cur, kind="stable")
        cs = cur[order_c]
        bstart = np.searchsorted(cs, np.arange(n_keys + 1))
        for b in over:
            members = order_c[bstart[b] : bstart[b + 1]]
            # move the least-shared members (fewest nodes homed in b)
            res_b = (cand[members] == b).sum(axis=1).astype(np.int64)
            members = members[np.argsort(res_b, kind="stable")]
            n_move = int(loads[b] - target)
            # nearest room bins: same lane first, then bin distance
            d_lane = np.abs((room_bins % N_LANES) - (b % N_LANES))
            d_bin = np.abs((room_bins // N_LANES) - (b // N_LANES))
            pref = np.argsort(d_bin * 4 + d_lane, kind="stable")
            moved = 0
            for p in pref:
                while room[p] > 0 and moved < n_move:
                    cur[members[moved]] = room_bins[p]
                    room[p] -= 1
                    moved += 1
                if moved >= n_move:
                    break
            loads[b] -= moved
    return cur


def _evict_copy_tail(cells, cell_key, node_key, row_in_bin, bin_of,
                     lane_of, n_keys, target, cap, *,
                     max_moves: int = 4096):
    """Move a few cells out of bins whose UNIQUE-copy count exceeds
    ``cap`` so the global copy window (wg_copy = padded max copies per
    bin) drops a tier. The worst bin alone sets wg_copy for the whole
    grid, and the fused gather/scatter and refresh kernels all scan
    rows proportional to it — on a jittered polycrystal the max (33)
    sits far above p99 (25), so one 8-row tier is bought by relocating
    a handful of cells. Unlike the round-2 whole-tail squeeze (which
    chased the mean and diverged), this only shaves the extreme tail:
    destinations must have BOTH cell-load room (max load stays ==
    target) and copy room (stay <= cap), so no new over-cap bin can
    appear and the loop terminates. Returns the updated cell_key (a
    copy) or None if the cap is infeasible within ``max_moves``."""
    nc, nv = cells.shape
    cell_key = np.asarray(cell_key).copy()
    loads = np.bincount(cell_key, minlength=n_keys)
    # per-(bin, foreign node) reference counts, via a sorted pair list
    ck = np.repeat(cell_key, nv)
    nd = cells.ravel()
    foreign = node_key[nd] != ck
    pair = ck[foreign] * np.int64(len(node_key)) + nd[foreign]
    upair, pcount = np.unique(pair, return_counts=True)
    # refcounts via sorted-array lookups + a small overlay for pairs
    # created by moves — a Python dict of the full pair set costs
    # minutes on this VM's slow first-touch page faults at 12M cells
    pcount = pcount.astype(np.int64)
    overlay: dict = {}

    def refget(p):
        if p in overlay:
            return overlay[p]
        i = np.searchsorted(upair, p)
        if i < len(upair) and upair[i] == p:
            return int(pcount[i])
        return 0

    def refadd(p, dv):
        if p in overlay:
            overlay[p] += dv
            return overlay[p]
        i = np.searchsorted(upair, p)
        if i < len(upair) and upair[i] == p:
            pcount[i] += dv
            return int(pcount[i])
        overlay[p] = dv
        return dv

    cpb = np.bincount(
        (upair // len(node_key)), minlength=n_keys
    )
    over = np.nonzero(cpb > cap)[0]
    if len(over) == 0:
        return cell_key
    # candidate destinations: cell room AND copy room
    n_total = len(node_key)

    def copies_of(cell, b):
        """this cell's foreign (b, node) pairs."""
        out = []
        for v in range(nv):
            n_ = cells[cell, v]
            if node_key[n_] != b:
                out.append(b * np.int64(n_total) + n_)
        return out

    moves = [0]

    def find_dest(cell, b):
        """Bin with cell-load room and copy room for ``cell``. Local
        candidates first (shared copies); falls back to ANY room bin —
        utilization sits near 99.8% after the spill, so local load
        room is scarce, and distant homes are legal (their copies ride
        the flat tail path exactly like spill teleports)."""
        cands = [int(node_key[cells[cell, v]]) for v in range(nv)]
        cands += [
            int(k) for k in range(max(0, b - 2 * N_LANES),
                                  min(n_keys, b + 2 * N_LANES + 1))
        ]
        cands += np.nonzero(loads < target)[0].tolist()
        for d in cands:
            if d == b or loads[d] >= target:
                continue
            added = sum(
                1 for p_ in copies_of(cell, d) if refget(p_) == 0
            )
            if cpb[d] + added <= cap:
                return d
        return None

    def apply_move(cell, b, dest):
        for p in copies_of(cell, b):
            if refadd(p, -1) == 0:
                cpb[b] -= 1
        for p in copies_of(cell, dest):
            if refadd(p, 1) == 1:
                cpb[dest] += 1
        loads[b] -= 1
        loads[dest] += 1
        cell_key[cell] = dest
        moves[0] += 1

    order_c = np.argsort(cell_key, kind="stable")
    cs = cell_key[order_c]
    bstart = np.searchsorted(cs, np.arange(n_keys + 1))
    for b in over:
        members = list(order_c[bstart[b] : bstart[b + 1]])
        stuck = False
        while cpb[b] > cap and members and not stuck:
            # best cell to evict: most exclusive copies removed
            best, best_gain = None, -1
            for cell in members:
                gain = sum(
                    1 for p in copies_of(cell, b) if refget(p) == 1
                )
                if gain > best_gain:
                    best, best_gain = cell, gain
            if best is not None and best_gain > 0:
                members.remove(best)
                dest = find_dest(best, b)
                if dest is None:
                    continue  # try a different member
                apply_move(best, b, dest)
                if moves[0] > max_moves:
                    return None
                continue
            # group move: every remaining copy is SHARED by >=2 homed
            # cells, so no single move sheds a unique. Pick the foreign
            # node with the fewest referencing cells and move them ALL
            # (each to its own destination) — the copy disappears when
            # the last reference leaves.
            lo = np.searchsorted(upair, b * np.int64(n_total))
            hi = np.searchsorted(upair, (b + 1) * np.int64(n_total))
            cand_nodes = sorted(
                [(int(pcount[i]), int(upair[i] % n_total))
                 for i in range(lo, hi) if pcount[i] > 0]
                + [(v, int(k % n_total))
                   for k, v in overlay.items()
                   if v > 0 and k // n_total == b]
            )
            stuck = True
            for rc, nd_ in cand_nodes:
                if rc > 4:
                    break  # moving >4 cells for one copy isn't worth it
                movers = [
                    c for c in members
                    if any(cells[c, v] == nd_ for v in range(nv))
                ]
                if len(movers) != rc:
                    continue
                dests = []
                ok = True
                for c in movers:
                    d = find_dest(c, b)
                    if d is None:
                        ok = False
                        break
                    # apply immediately so the next mover's feasibility
                    # sees updated counts (rolled back is not needed:
                    # each individual move keeps all invariants)
                    apply_move(c, b, d)
                    dests.append((c, d))
                    members.remove(c)
                if ok and moves[0] <= max_moves:
                    stuck = False
                    break
                if moves[0] > max_moves:
                    return None
        if cpb[b] > cap:
            return None
    return cell_key


def build_lane_plan(mesh_x: np.ndarray, cells: np.ndarray, *,
                    wg_own: int = 32, min_G: int = 0, min_kc: int = 0,
                    min_wg_copy: int = 0,
                    pass_min_frac: float = 0.0005) -> LanePlan:
    """Build the plan from node coordinates (n, gdim) and the (nc, nv)
    P1 cell->node table.

    ``min_G``/``min_kc``/``min_wg_copy`` force lower bounds on the bin
    count, cells-per-bin and copy-window dims so plans built for
    different subdomains share static shapes (the multi-device
    composition stacks per-device plans along a shard axis)."""
    import os
    import time as _time

    _dbg = bool(os.environ.get("TPUFEM_PLAN_DEBUG"))
    _t = [_time.perf_counter()]

    def _tick(label):
        if _dbg:
            now = _time.perf_counter()
            print(f"  plan[{label}]: {now - _t[0]:.2f}s", flush=True)
            _t[0] = now

    x = np.asarray(mesh_x)
    cells = np.asarray(cells)
    n, nc = len(x), len(cells)
    nv = cells.shape[1]
    if wg_own % 8 != 0:
        raise ValueError("wg_own must be a multiple of 8 (sublane tiling)")

    # --- node strips and bins -------------------------------------------------
    # 2D: 128 equal-count x-strips. 3D: 16x8 (x, y) tiles — pure
    # x-strips of a box are thin 2D slabs whose neighborhoods spray
    # copies across many bins (measured 3.05x copies / 52 passes on a
    # 2M-DoF tet box vs 0.5x / 8 with tiles).
    lane_of = np.empty(n, dtype=np.int64)
    if x.shape[1] > 2:
        nx_t, ny_t = 16, 8
        by_x = np.argsort(x[:, 0], kind="stable")
        xb = np.linspace(0, n, nx_t + 1).astype(np.int64)
        for ix in range(nx_t):
            strip = by_x[xb[ix] : xb[ix + 1]]
            by_y = strip[np.argsort(x[strip, 1], kind="stable")]
            yb = np.linspace(0, len(by_y), ny_t + 1).astype(np.int64)
            for iy in range(ny_t):
                lane_of[by_y[yb[iy] : yb[iy + 1]]] = ix * ny_t + iy
    else:
        by_x = np.argsort(x[:, 0], kind="stable")
        bounds = np.linspace(0, n, N_LANES + 1).astype(np.int64)
        for j in range(N_LANES):
            lane_of[by_x[bounds[j] : bounds[j + 1]]] = j
    # rank within lane by (z,) y, then x for ties — spatially coherent
    # bins along the strip/tile column. (A Morton/Z-order intra-lane
    # key was tried for 3D — cube-ish bins DO cut total copies ~13%,
    # but they scramble the (lane-shift, bin-shift) structure the pass
    # kernels rely on: 49 -> 72 passes and 2.7x the owner window rows
    # on the 2M-DoF tet box. Scanline order stays.)
    keys = (x[:, 0], x[:, 1]) + ((x[:, 2],) if x.shape[1] > 2 else ())
    order = np.lexsort(keys + (lane_of,))
    rank = np.empty(n, dtype=np.int64)
    # position within each lane
    lane_sorted = lane_of[order]
    starts = np.searchsorted(lane_sorted, np.arange(N_LANES))
    rank[order] = np.arange(n) - starts[lane_sorted]
    bin_of = rank // wg_own
    row_in_bin = rank % wg_own
    G = max(int(bin_of.max()) + 1, min_G)

    _tick("strips")
    # --- cells -> home bins -----------------------------------------------------
    # a cell may live in the home bin of ANY of its nodes; balance the
    # choice so the per-bin cell count (kc = padded max) stays near the
    # mean. First-node assignment is fine on regular triangulations but
    # measured 1.51x slot padding on jittered-Delaunay polycrystals.
    node_key_all = (bin_of * N_LANES + lane_of).astype(np.int64)
    cand = node_key_all[cells]  # (nc, nv) candidate bin keys
    n_keys = G * N_LANES
    rows_nc = np.arange(nc)
    # balance objective (both paths): start from the first node's bin —
    # regular meshes group same-bin cells so their foreign nodes
    # coincide (shared copies; ANY reshuffle measurably spreads them,
    # 0.56x -> 0.81x copies on the structured triangulation) — then
    # move cells out of bins loaded past the padded-mean target, only
    # into candidate bins of maximal residency (number of the cell's
    # nodes homed there: fewer copy slots — load-only balancing
    # measured copies 0.57x -> 1.09x on a jittered polycrystal).
    target = target0 = _round_up(max(-(-nc // n_keys), 1), 8)
    from tpufem_torch import native

    choice = native.lane_balance(cand, n_keys, target)
    if choice is None:
        # NumPy fallback: capacity-targeted rounds with per-target
        # room quotas (herd damping); raise the target on stall
        resident = (cand[:, :, None] == cand[:, None, :]).sum(
            axis=2, dtype=np.int8
        )
        res_def = resident.max(axis=1, keepdims=True) - resident
        _tick("home-bins/resident")
        choice = np.zeros(nc, dtype=np.int64)
        allowed = res_def == 0  # only move among maximal-residency bins
        for _ in range(16):
            cur = cand[rows_nc, choice]
            loads = np.bincount(cur, minlength=n_keys)
            if loads.max() <= target:
                break
            cand_loads = np.where(
                allowed, loads[cand], np.iinfo(np.int64).max
            )
            best = np.argmin(cand_loads, axis=1)
            cur_load = loads[cur]
            best_load = cand_loads[rows_nc, best]
            move = (cur_load > target) & (best_load < target)
            if not move.any():
                target += 8
                continue
            tgt = cand[rows_nc, best]
            order_m = np.argsort(tgt[move], kind="stable")
            movers = np.nonzero(move)[0][order_m]
            tgt_m = tgt[movers]
            first_pos = np.searchsorted(tgt_m, np.arange(n_keys))
            rank_in_tgt = np.arange(len(movers)) - first_pos[tgt_m]
            room = target - loads
            keep = rank_in_tgt < room[tgt_m]
            if not keep.any():
                target += 8
                continue
            choice[movers[keep]] = best[movers[keep]]
    _tick("home-bins/balance")
    # spill/teleport works on bin KEYS (a teleported cell's home bin
    # holds none of its nodes); target0, not the possibly-raised
    # fallback target, so native and NumPy paths stay field-exact
    cell_key = _spill_pass(
        cand, cand[rows_nc, choice], n_keys, target0
    )
    _tick("home-bins/spill")
    # NOTE a copy-tail eviction pass (squeezing the per-bin unique-
    # copy max down to the padded mean so wg_copy drops 24 -> 16 on
    # jittered meshes) was tried and REMOVED: with load<=target held
    # invariant the copy tail refuses to converge (chains or spill
    # reruns re-break a residual tail forever) — the ~14-copy mean
    # sits too close to the 16 cap for the bin geometry. See git
    # history (round 2) before re-attempting.
    cell_lane = cell_key % N_LANES
    cell_bin = cell_key // N_LANES
    cpos = native.rank_by_key(cell_key, n_keys)
    if cpos is None:
        csort = np.argsort(cell_key, kind="stable")
        key_sorted = cell_key[csort]
        kstart = np.searchsorted(key_sorted, np.arange(G * N_LANES))
        cpos = np.empty(nc, dtype=np.int64)
        cpos[csort] = np.arange(nc) - kstart[key_sorted]
    kc = max(_round_up(max(int(np.bincount(cell_key).max()), 1), 8), min_kc)

    _tick("home-bins")
    # --- copies -----------------------------------------------------------------
    # (cell-bin-key, node) pairs where the node's home differs. Both
    # paths produce: the per-(cell, v) gather offsets ``off`` (own ->
    # row_in_bin, foreign -> wg_own + copy rank), and the unique copies
    # sorted by (bin, node): ``ubin``/``un``/``copy_rank``. Wrapped in
    # a tier-down loop: when only an extreme tail of bins holds more
    # copies than the next-lower 8-row tier, _evict_copy_tail relocates
    # those few cells and the copies are recomputed — every kernel that
    # scans the copy window (fused gather/scatter, refresh) pays per
    # wg_copy row.
    node_key = bin_of * N_LANES + lane_of  # home bin key per node
    # tiers beyond the first measured within the schedule-noise band
    # (wg 56 vs 64: 2.35 vs 2.18-2.31 ms on the 2.1M polycrystal) but
    # cost minutes of host time at 12M cells — one tier by default
    _evict_tiers = int(os.environ.get("TPUFEM_EVICT_TIERS", "1"))
    for _tier in range(1 + _evict_tiers):
        copies = native.lane_copies(cells, cell_key, node_key,
                                    row_in_bin, wg_own)
        if copies is not None:
            off, ubin, un, copy_rank, max_per_bin = copies
            wg_copy = _round_up(max(int(max_per_bin), 8), 8)
            _tick("copies/native")
        else:
            ck = np.repeat(cell_key, nv)
            nd = cells.ravel()
            foreign = node_key[nd] != ck
            # unique (cell-bin-key, node) pairs via a scalar int64 key —
            # the axis=0 unique on a 2-column array is a void-dtype sort
            # and is ~100x slower at millions of pairs
            pair_key = ck[foreign] * np.int64(n) + nd[foreign]
            _tick("copies/pairkey")
            ukey, pair_inv_f = np.unique(pair_key, return_inverse=True)
            _tick("copies/unique")
            ubin = ukey // n
            un = ukey % n
            # rank of each unique copy within its bin
            ustart = np.searchsorted(ubin, np.arange(G * N_LANES))
            copy_rank = np.arange(len(ubin)) - ustart[ubin]
            copies_per_bin = np.bincount(ubin, minlength=G * N_LANES)
            wg_copy = _round_up(
                max(int(copies_per_bin.max()) if len(ubin) else 8, 8), 8
            )
            # local offset per (cell, v): own row_in_bin, wg_own+copy_rank
            off = np.empty(nc * nv, dtype=np.int64)
            own_sel = ~foreign
            off[own_sel] = row_in_bin[nd[own_sel]]
            off[foreign] = wg_own + copy_rank[pair_inv_f]
            off = off.reshape(nc, nv)
        if _tier >= _evict_tiers:
            break  # last iteration recomputes copies only (an eviction
            # here would leave off/ubin stale vs the moved cells)
        cap = wg_copy - 8
        if cap < 8 or wg_copy <= min_wg_copy or len(ubin) == 0:
            break
        cpb_now = np.bincount(ubin, minlength=n_keys)
        excess = int(np.maximum(cpb_now - cap, 0).sum())
        if excess == 0 or excess > max(64, int(0.002 * len(ubin))):
            break  # tier already met, or not a tail — don't chase it
        new_key = _evict_copy_tail(
            cells, cell_key, node_key, row_in_bin, bin_of, lane_of,
            n_keys, target0, cap,
        )
        if new_key is None:
            break
        cell_key = new_key
        cell_lane = cell_key % N_LANES
        cell_bin = cell_key // N_LANES
        cpos = native.rank_by_key(cell_key, n_keys)
        if cpos is None:
            csort = np.argsort(cell_key, kind="stable")
            key_sorted = cell_key[csort]
            kstart = np.searchsorted(key_sorted, np.arange(n_keys))
            cpos = np.empty(nc, dtype=np.int64)
            cpos[csort] = np.arange(nc) - kstart[key_sorted]
        _tick("copies/evict")
    wg_copy = max(wg_copy, min_wg_copy)
    wg = wg_own + wg_copy
    R = G * wg

    # node home rows (global)
    node_row = bin_of * wg + row_in_bin
    owned_mask = np.zeros((R, N_LANES), dtype=bool)
    owned_mask[node_row, lane_of] = True

    # --- group copies by (p, q) -------------------------------------------------
    # Re-sort the unique copies within each bin by their (lane-shift,
    # bin-shift) combo so every dense pass occupies a CONTIGUOUS rank
    # range per bin. The pass kernels then DMA and loop only that
    # group's row span (per-pass static wr, per-bin dynamic start)
    # instead of the whole copy window — on the jittered polycrystal
    # the 8 owner passes each scanned all wg_copy=40 rows (62% of the
    # fused residual time); grouped, each scans ~its own copies.
    if len(ubin):
        gc0 = ubin // N_LANES
        jc0 = ubin % N_LANES
        p0 = (lane_of[un] - jc0).astype(np.int64)
        q0 = (bin_of[un] - gc0).astype(np.int64)
        p_min0, q_min0 = int(p0.min()), int(q0.min())
        q_span0 = int(q0.max()) - q_min0 + 1
        pq_copy = (p0 - p_min0) * q_span0 + (q0 - q_min0)
        resort = np.lexsort((pq_copy, ubin))
        if not np.array_equal(resort, np.arange(len(ubin))):
            ustart_old = np.searchsorted(ubin, np.arange(n_keys + 1))
            inv_pos = np.empty(len(ubin), dtype=np.int64)
            inv_pos[resort] = np.arange(len(ubin))
            # new rank (within bin) of each OLD copy id
            new_rank = inv_pos - ustart_old[ubin]
            # remap the per-(cell, v) gather offsets: foreign entries
            # reference the old within-bin rank
            fmask = off >= wg_own
            ck_f = np.broadcast_to(cell_key[:, None], off.shape)[fmask]
            old_global = ustart_old[ck_f] + (off[fmask] - wg_own)
            off[fmask] = wg_own + new_rank[old_global]
            ubin = ubin[resort]
            un = un[resort]
            pq_copy = pq_copy[resort]
            copy_rank = np.arange(len(ubin)) - ustart_old[ubin]
    _tick("copies")
    # --- gather idx --------------------------------------------------------------

    g_arr = cell_bin
    j_arr = cell_lane
    filled = native.lane_gather_fill(g_arr, j_arr, cpos, off, kc, G)
    if filled is not None:
        gather_idx, cell_order = filled
    else:
        gather_idx = np.full((G, nv, kc, N_LANES), -1, dtype=np.int32)
        for v in range(nv):
            gather_idx[g_arr, v, cpos, j_arr] = off[:, v]
        cell_order = np.full(G * kc * N_LANES, -1, dtype=np.int64)
        cell_order[(g_arr * kc + cpos) * N_LANES + j_arr] = np.arange(nc)
    gather_starts = (np.arange(G) * wg).astype(np.int32)
    cell_valid = cell_order >= 0

    _tick("gather-idx")
    # --- owner-sum / refresh passes -----------------------------------------------
    # copy slot: bin (gc, jc), row wg_own+i ; source: home slot of node
    gc = ubin // N_LANES
    jc = ubin % N_LANES
    gh = bin_of[un]
    jh = lane_of[un]
    p_arr = (jh - jc).astype(np.int64)  # lane shift src - dst
    q_arr = (gh - gc).astype(np.int64)

    owner_passes = []
    refresh_passes = []
    # rare (p, q) combos -> flat tail pairs, not a full dense pass each
    # (a jittered polycrystal spreads 2% of its copies over 2x more
    # (p, q) combos than hold the other 98%)
    tail_mask = np.zeros(len(ubin), dtype=bool)
    min_count = max(int(pass_min_frac * len(ubin)), 1)
    # group copies by (p, q) with one sort — scanning the full copy list
    # per combo is O(combos x copies) and dominated plan build at 4M cells
    if len(ubin):
        p_min, q_min = int(p_arr.min()), int(q_arr.min())
        q_span = int(q_arr.max()) - q_min + 1
        pq_key = (p_arr - p_min) * q_span + (q_arr - q_min)
        pq_order = np.argsort(pq_key, kind="stable")
        pq_sorted = pq_key[pq_order]
        pq_ukeys, pq_starts, pq_counts = np.unique(
            pq_sorted, return_index=True, return_counts=True
        )
    else:
        p_min = q_min = 0
        q_span = 1
        pq_order = np.zeros(0, dtype=np.int64)
        pq_ukeys = pq_starts = pq_counts = np.zeros(0, dtype=np.int64)
    gi = np.arange(G)
    big32 = np.int64(np.iinfo(np.int32).max)
    for pq_k, pq_s, pq_c in zip(pq_ukeys, pq_starts, pq_counts):
        sel = pq_order[pq_s : pq_s + pq_c]
        p = int(pq_k // q_span) + p_min
        q = int(pq_k % q_span) + q_min
        if pq_c < min_count:
            tail_mask[sel] = True
            continue
        # owner-sum: dst owner (gh, row_in_bin, jh) <- copy partial
        # at bin gh-q (==gc), lane jh-p (==jc). Copies are (bin, pq)-
        # sorted, so this pass's ranks are contiguous per bin; the
        # window is [min rank over the source row's lanes, max) —
        # idx = rank - min, start = source copy region + min.
        # V handling: multiple copies of the same owner in the SAME
        # (p, q) pass cannot happen (a node has at most one copy per
        # bin, and (p,q) fixes the bin) -> V=1
        mn = np.full(G, big32)
        mx = np.zeros(G, dtype=np.int64)
        np.minimum.at(mn, gc[sel], copy_rank[sel])
        np.maximum.at(mx, gc[sel], copy_rank[sel] + 1)
        empty = mx == 0
        mn[empty] = 0
        mx[empty] = 1
        owr = int((mx - mn).max())
        # absolute-row window start per SOURCE bin row, clipped into
        # [0, R - owr]; idx values are relative to the clipped start so
        # they stay exact even when the clip shifts the window (last
        # bin rows)
        st_o = np.clip(gi * wg + wg_own + mn, 0, R - owr)
        oidx = np.full((G, 1, wg_own, N_LANES), -1, dtype=np.int32)
        oidx[gh[sel], 0, row_in_bin[un[sel]], jh[sel]] = (
            gc[sel] * wg + wg_own + copy_rank[sel] - st_o[gc[sel]]
        )
        ostart = st_o[np.clip(gi - q, 0, G - 1)].astype(np.int32)
        owner_passes.append((int(p), int(q), oidx, ostart, owr))
        # refresh: dst copy (gc, wg_own+i, jc) <- src owned row in bin
        # gc+q, lane jc+p. Source rows of this pass cluster (q != 0
        # copies source from the bin edge facing them); the window is
        # [min source row over the row's copies, max).
        rmn = np.full(G, big32)
        rmx = np.zeros(G, dtype=np.int64)
        np.minimum.at(rmn, gh[sel], row_in_bin[un[sel]])
        np.maximum.at(rmx, gh[sel], row_in_bin[un[sel]] + 1)
        rempty = rmx == 0
        rmn[rempty] = 0
        rmx[rempty] = 1
        rwr = int((rmx - rmn).max())
        st_r = np.clip(gi * wg + rmn, 0, R - rwr)
        ridx = np.full((G, 1, wg_copy, N_LANES), -1, dtype=np.int32)
        ridx[gc[sel], 0, copy_rank[sel], jc[sel]] = (
            gh[sel] * wg + row_in_bin[un[sel]] - st_r[gh[sel]]
        )
        rstart = st_r[np.clip(gi + q, 0, G - 1)].astype(np.int32)
        refresh_passes.append((int(p), int(q), ridx, rstart, rwr))

    _tick("passes")
    tail_copy_slot = (
        (gc[tail_mask] * wg + wg_own + copy_rank[tail_mask]) * N_LANES
        + jc[tail_mask]
    )
    tail_owner_slot = node_row[un[tail_mask]] * N_LANES + jh[tail_mask]
    plan = LanePlan(
        n_nodes=n, n_cells=nc, nv=nv, wg_own=wg_own, wg=wg, G=G, kc=kc,
        R=R, node_row=node_row, node_lane=lane_of, owned_mask=owned_mask,
        cell_order=cell_order, cell_valid=cell_valid,
        gather_idx=gather_idx, gather_starts=gather_starts,
        owner_passes=owner_passes, refresh_passes=refresh_passes,
        tail_copy_slot=tail_copy_slot, tail_owner_slot=tail_owner_slot,
    )
    _tick("tail")
    # host copy-fill tables (vectorized)
    plan.copy_dst_rows = gc * wg + wg_own + copy_rank
    plan.copy_dst_lanes = jc
    plan.copy_src_rows = node_row[un]
    plan.copy_src_lanes = jh
    # strip extents + slot coordinate views (transfer-operator planning)
    # (segmented min/max — the per-lane boolean-mask loop was 128 full
    # passes over x)
    strip_x = np.zeros((N_LANES, 2))
    if n:
        order_l = np.argsort(lane_of, kind="stable")
        lx = x[order_l, 0]
        cnt = np.bincount(lane_of, minlength=N_LANES)
        bnds = np.zeros(N_LANES + 1, dtype=np.int64)
        np.cumsum(cnt, out=bnds[1:])
        ne = cnt > 0
        starts = bnds[:-1][ne]
        if len(starts):
            strip_x[ne, 0] = np.minimum.reduceat(lx, starts)
            strip_x[ne, 1] = np.maximum.reduceat(lx, starts)
    plan.strip_x = strip_x
    slot_x = np.full((R, N_LANES), np.nan)
    slot_y = np.full((R, N_LANES), np.nan)
    slot_x[node_row, lane_of] = x[:, 0]
    slot_y[node_row, lane_of] = x[:, 1]
    slot_x[plan.copy_dst_rows, jc] = x[un, 0]
    slot_y[plan.copy_dst_rows, jc] = x[un, 1]
    plan.slot_x = slot_x
    plan.slot_y = slot_y
    return plan

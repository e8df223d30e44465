"""Target-sharded global hypothesis selection with explicit collectives
(counterpart of pymht_tpu/parallel/distributed_select.py).

The target axis is split over the ranks of an ``Axis`` (collectives.py,
normally the 'cluster' dimension of a ``DeviceMesh``): each rank holds
its own [T / size] targets of the forest, decodes them against shared
dual prices, and the traffic between ranks is the reduction of the slot
usage counts (the Lagrangian subgradient), of the objectives and bounds,
and the per-slot min reductions of the repair's keep decision.  The dual
update reads only reduced values, so the prices stay equal on every rank
without a broadcast, and every loop exit and branch is read on the host
from a reduced value: all ranks take the same one.

Two implementations, as in the JAX package:

* ``distributed_select_compact`` (production): the tier-0 fast path (one
  psum'd dense usage count), then the compact contested-slot Lagrangian
  of core/select.py with the axis (``_compact_lagrangian(axis=...)``),
  whose collectives are [CAP]-sized, then the contested-cap overflow
  guard.  Tiers 1-2 of the single-device hybrid (exact enumeration of
  small clusters) are not part of it, in either package.
* ``distributed_lagrangian`` (kept for A/B and parity): the full-slot
  formulation, scatter-built usage counts and [n_slots] psum / pmin per
  iteration.

``make_distributed_select`` returns the function of one rank's share of
the state; ``parallel/sharded_tracker.shard_state`` cuts that share from
a whole forest.
"""
from __future__ import annotations

import torch

from .. import sync
from ..core import select as sel_mod
from ..core.config import TrackerParams, TrackerShapes
from ..core.select import (INF, _compact_lagrangian, _contested_leaf_usage,
                           _hist_usage, _slot_index, leaf_scores)
from .collectives import Axis


def _local_tables(state, shapes: TrackerShapes):
    """This rank's slot ids per (target, leaf, window column and family):
    ([T, L, 2W], n_slots)."""
    slots, n_slots = _slot_index(state, shapes)
    T, L, W, _ = slots.shape
    return slots.reshape(T, L, W * 2), n_slots


def distributed_lagrangian(state, shapes: TrackerShapes,
                           params: TrackerParams, axis: Axis,
                           iters: int = 60, theta: float = 1.5,
                           patience: int = 6, repair_rounds: int = 8,
                           repair_cadence: int = 2, lam0=None,
                           force_iters: bool = False):
    """The full-slot distributed Lagrangian on this rank's targets.
    ``force_iters`` runs exactly ``iters`` bodies, without the
    convergence and patience exits (A/B instrumentation only).

    Returns (sel [T_local], obj, lower bound, feasible — all three
    global —, lam [n_slots]: the final duals, equal on every rank, for
    the next scan's warm start)."""
    slots_flat, n_slots = _local_tables(state, shapes)
    T, L = state.leaf_mask.shape
    dev = state.leaf_mask.device
    f = leaf_scores(state, params)
    tb = torch.arange(T, device=dev)
    gidx = axis.index * T + tb                       # global target ids
    T_g = axis.size * T
    tgt = state.tgt_mask
    zero1 = torch.zeros((1,), dtype=torch.float32, device=dev)
    false1 = torch.zeros((1,), dtype=torch.bool, device=dev)
    ar_L = torch.arange(L, device=dev)

    def reduced_cost(lam):
        return f + torch.cat([lam, zero1])[slots_flat].sum(dim=2)

    def decode(lam):
        rc = reduced_cost(lam)
        local_min = torch.where(tgt, rc.amin(dim=1), 0.0).sum()
        return rc.argmin(dim=1), axis.psum(local_min) - lam.sum()

    def own_slots(sel):
        return torch.where(tgt[:, None], slots_flat[tb, sel], n_slots)

    def per_slot(own, vals, fill, reduce):
        out = torch.full((n_slots + 1,), fill, dtype=vals.dtype, device=dev)
        out.scatter_reduce_(0, own.reshape(-1), vals.reshape(-1), reduce,
                            include_self=True)
        return out

    def usage_of(sel):
        s = own_slots(sel).reshape(-1)
        cnt = torch.zeros((n_slots + 1,), dtype=torch.float32, device=dev)
        cnt.index_add_(0, s, torch.ones_like(s, dtype=torch.float32))
        return axis.psum(cnt[:n_slots])     # global usage

    def obj_of(sel):
        return axis.psum(torch.where(tgt, f[tb, sel], 0.0).sum())

    # per-(target, column) unavoidability: every live leaf agrees on the
    # column's slot (a slot's column is part of its identity, so no
    # [T, n_slots] table is needed)
    eff = state.leaf_mask & tgt[:, None]
    sf = torch.where(eff[..., None], slots_flat, -1)
    rep = sf.amax(dim=1)
    same = ((sf == rep[:, None, :]) | ~eff[..., None]).all(dim=1)
    unav_cols = (same & (rep >= 0) & (rep < n_slots)
                 & (eff.sum(dim=1) > 0)[:, None]).float()

    def repair_round(rc, carry):
        """Keep-best-per-slot over all ranks: claim keys and owners are
        pmin'd per slot; losers repick locally.  Spine priority ends the
        rounds at the globally feasible all-spines assignment."""
        sel, banned, _ = carry
        over_pad = torch.cat([usage_of(sel) > 1.5, false1])
        own = own_slots(sel)
        on_spine = (sel == state.spine_leaf).float()
        key = (f[tb, sel][:, None] - 1e8 * unav_cols
               - 5e7 * on_spine[:, None])
        over_own = over_pad[own]
        claim = torch.where(over_own, key, INF)
        slot_min = axis.pmin(per_slot(own, claim, INF, 'amin'))
        in_conf = over_own.any(dim=1) & tgt
        min_own = slot_min[own]
        is_min = over_own & (key <= min_own + 1e-5 * (1.0 + min_own.abs()))
        cand = torch.where(is_min, gidx[:, None], T_g)
        slot_owner = axis.pmin(per_slot(own, cand, T_g, 'amin'))
        keeper = (~over_own | (slot_owner[own] == gidx[:, None])).all(dim=1)
        loser = in_conf & ~keeper
        any_conf = axis.psum(in_conf.any()) > 0
        banned = banned | (loser[:, None] & (ar_L[None, :] == sel[:, None]))
        pen = over_pad[slots_flat].sum(dim=2).float()
        rcb = torch.where(banned, INF, rc + 1e3 * pen)
        sel = torch.where(loser, rcb.argmin(dim=1), sel)
        return sel, banned, any_conf

    def repair(sel, lam):
        rc = reduced_cost(lam)
        sel = sync.while_loop(
            lambda c: c[2], lambda c, _: repair_round(rc, c),
            (sel, torch.zeros((T, L), dtype=torch.bool, device=dev), None),
            max_iters=repair_rounds, test_first=False)[0]
        return sel, ~(usage_of(sel) > 1.5).any()

    def step(c, _active):
        it, lam, best_sel, best_obj, best_feas, best_lb, stale = c
        sel, lb = decode(lam)
        best_lb = torch.maximum(best_lb, lb)
        cnt = usage_of(sel)
        # used rows raise prices; slack rows that still carry a price
        # decay (without the decay the duals diverge)
        g = torch.where((cnt > 0) | (lam > 0), cnt - 1.0, 0.0)
        feas = ~(cnt > 1.5).any()
        sel_c, feas_c = sel, feas
        if it % repair_cadence == 0:
            sel_c, feas_c = sync.cond(~feas, lambda: repair(sel, lam),
                                      lambda: (sel, feas))
        obj = torch.where(feas_c, obj_of(sel_c), INF)
        better = feas_c & ((obj < best_obj - 1e-6) | ~best_feas)
        material = feas_c & ((obj < best_obj
                              - 1e-4 * (1.0 + best_obj.abs()))
                             | ~best_feas)
        best_sel = torch.where(better, sel_c, best_sel)
        best_obj = torch.where(better, obj, best_obj)
        best_feas = best_feas | feas_c
        stale = torch.where(material, 0, stale + 1)
        gnorm2 = torch.clamp(torch.dot(g, g), min=1e-6)
        gap_est = torch.where(
            best_feas,
            torch.minimum(torch.clamp(best_obj - lb, min=1e-3),
                          1.0 + 0.25 * best_obj.abs()),
            1.0)
        lam = torch.clamp(lam + theta * gap_est / gnorm2 * g, min=0.0)
        return (it + 1, lam, best_sel, best_obj, best_feas, best_lb, stale)

    def go_on(c):
        _, _, _, best_obj, best_feas, best_lb, stale = c
        gap = best_obj - best_lb
        scale = 1.0 + best_obj.abs()
        converged = best_feas & (gap <= 2e-4 * scale)
        patience_out = best_feas & (stale >= patience) & (gap <= 1e-3 * scale)
        return ~converged & ~patience_out

    lam_init = (torch.zeros((n_slots,), dtype=torch.float32, device=dev)
                if lam0 is None else lam0)
    sel_seed, lb_seed = decode(lam_init)
    sel_seed, feas_seed = repair(sel_seed, lam_init)
    obj_seed = torch.where(feas_seed, obj_of(sel_seed), INF)
    c = (0, lam_init, sel_seed, obj_seed, feas_seed, lb_seed,
         torch.zeros((), dtype=torch.int64, device=dev))
    _, lam, best_sel, best_obj, best_feas, best_lb, _ = sync.while_loop(
        None if force_iters else go_on, step, c, max_iters=iters)
    return best_sel, best_obj, best_lb, best_feas, lam


def _dist_selection_feasible(state, shapes: TrackerShapes, sel, axis: Axis):
    """Global feasibility of a per-target selection under target
    sharding: dense local (window column, label) counts, ONE psum of the
    two (twin of the JAX package's ``_dist_selection_feasible``)."""
    T = state.hist_meas.shape[0]
    M, A = shapes.max_meas, shapes.max_ais
    dev = state.hist_meas.device
    tb = torch.arange(T, device=dev)
    act = state.tgt_mask[:, None]
    sm = torch.where(act, state.hist_meas[tb, sel], -1)              # [T,W]
    sa = torch.where(act, state.hist_ais[tb, sel], 0)
    cm = (sm[..., None] == torch.arange(1, M + 1, device=dev)).sum(dim=0)
    ca = (sa[..., None] == torch.arange(1, A + 1, device=dev)).sum(dim=0)
    cnt = axis.psum(torch.cat([cm, ca], dim=-1).int())          # [W, M+A]
    return ~(cnt > 1).any()


def distributed_select_compact(state, shapes: TrackerShapes,
                               params: TrackerParams, axis: Axis,
                               iters: int = 60, theta: float = 1.5,
                               patience: int = 4, repair_rounds: int = 8,
                               repair_cadence: int = 4,
                               contested_cap: int = 256, lam0=None,
                               fast_path: bool = True,
                               force_iters: bool = False):
    """Production distributed selection on this rank's targets: the
    fast path, the compact contested-slot Lagrangian with [CAP]-sized
    collectives, then core/select.select_hybrid's contested-cap overflow
    guard (a spine retreat keeps the selection feasible; the dual bound
    stays valid, since dualising a subset of the constraints only
    loosens it).  The contested set is built densely (one psum of the
    per-slot target counts) below ``core.select._INT32_WALL`` elements of
    the local [T, n_slots], and from min/max global-target-id scatters
    with one pmin / pmax pair from the wall on.  ``force_iters`` runs
    the Lagrangian for exactly ``iters`` bodies (A/B instrumentation).

    Returns (sel [T_local], obj, lower bound, feasible — all three
    global —, lam [n_slots]: the final duals, equal on every rank)."""
    T, L, W = state.hist_meas.shape
    M, A = shapes.max_meas, shapes.max_ais
    S = W * (M + A)
    dev = state.hist_meas.device
    tb = torch.arange(T, device=dev)
    f = leaf_scores(state, params)
    lam_full0 = state.lam if lam0 is None else lam0
    tm = state.tgt_mask

    # tier 0: the independent optima, one psum'd feasibility check
    sel0 = f.argmin(dim=1)
    obj0 = axis.psum(torch.where(tm, f.amin(dim=1), 0.0).sum())

    def fast():
        return sel0, obj0, obj0, torch.ones((), dtype=torch.bool,
                                            device=dev), lam_full0

    def slow():
        usage = (_hist_usage(state, shapes)
                 if T * S < sel_mod._INT32_WALL else None)
        CAP = min(contested_cap, S)
        Uc, col_slot, col_ok, n_cont, eff_leaf = _contested_leaf_usage(
            state, shapes, tm, CAP, usage, axis=axis)
        # the columns come from the reduced contested set: the same on
        # every rank, no broadcast needed
        lam_pad0 = torch.cat([lam_full0, lam_full0.new_zeros((1,))])
        lam_c0 = torch.where(col_ok, lam_pad0[col_slot.clamp(0, S)], 0.0)
        sel_b, feas_b, obj_b, lb_b, lam_c = _compact_lagrangian(
            f, Uc, lam_c0, state.spine_leaf, tm, eff_leaf, 0.0,
            iters=iters, theta=theta, patience=patience,
            repair_rounds=repair_rounds, repair_cadence=repair_cadence,
            axis=axis, force_iters=force_iters)
        lam_full = torch.zeros((S + 1,), dtype=torch.float32, device=dev)
        lam_full.scatter_add_(0, torch.where(col_ok, col_slot, S),
                              torch.where(col_ok, lam_c, 0.0))

        # contested-cap overflow guard (core/select.select_hybrid twin)
        ok = _dist_selection_feasible(state, shapes, sel_b, axis)
        need_fb = (n_cont > CAP) & ~ok
        spine = state.spine_leaf.long().clamp(0, L - 1)
        sel_fin = torch.where(need_fb & tm, spine, sel_b)
        obj_fb = axis.psum(torch.where(tm, f[tb, spine], 0.0).sum())
        obj_fin = torch.where(need_fb, obj_fb, obj_b)
        feas_fin = torch.where(
            need_fb, _dist_selection_feasible(state, shapes, sel_fin, axis),
            feas_b & ok)
        return sel_fin, obj_fin, lb_b, feas_fin, lam_full[:S]

    if not fast_path:
        return slow()
    feas0 = _dist_selection_feasible(state, shapes, sel0, axis)
    return sync.cond(feas0, fast, slow)


def make_distributed_select(axis: Axis, shapes: TrackerShapes,
                            params: TrackerParams, iters: int = 60,
                            impl: str = 'compact', **impl_kw):
    """``run(state) -> (sel, obj, lb, feasible, lam)`` on this rank's
    share of a forest whose ``shapes.max_targets`` targets are split
    evenly over ``axis``.  ``impl``: 'compact' (production, [CAP]
    collectives) or 'full' (the full-slot formulation, kept for A/B and
    parity)."""
    if impl not in ('compact', 'full'):
        raise ValueError(f"unknown distributed select {impl!r}")
    fn = (distributed_select_compact if impl == 'compact'
          else distributed_lagrangian)

    def run(state):
        T = state.tgt_mask.shape[0]
        if T * axis.size != shapes.max_targets:
            raise ValueError(f"make_distributed_select: {T} targets per "
                             f"rank x {axis.size} ranks is not "
                             f"{shapes.max_targets}")
        return fn(state, shapes, params, axis, iters=iters, **impl_kw)

    return run

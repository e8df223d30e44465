"""Global hypothesis selection (counterpart of
pymht_tpu/core/select.py).

Pick one leaf per target minimising total score subject to single-use
(window column, measurement) slots.  The production solver
(``method='lagrangian'``) is a tiered hybrid:

* tier 0 — if the per-target independent optima are conflict-free they
  are the global optimum; no solver runs;
* tier 1 — singleton clusters take their argmin leaf;
* tier 2 — clusters of 2..4 targets are solved exactly by batched
  enumeration over each member's top-C leaves;
* tier 3 — larger clusters run the compact contested-slot Lagrangian,
  warm-started from the duals carried across scans.

Two further solvers are kept for parity and cross-checks:

* ``'ipm'``             — dense assembly + interior-point LP with
                          truncated branch-and-bound (ops/lp.py);
* ``'lagrangian_pure'`` — a gather/scatter Lagrangian over ALL slots,
                          applied to the whole forest.

The usage tensors have two formulations that give identical results:
dense compares, and scatter builds that never materialise a
[T, n_slots] tensor.  ``_USAGE_DENSE_LIMIT`` and ``_INT32_WALL`` (module
attributes, so a test can set them small) choose by problem size.  Where
JAX branches or exits a loop on a device value, the port reads it on the
host (``sync.flag``); loop bodies are functions from carry to carry.
"""
from __future__ import annotations

import itertools
import math
from typing import NamedTuple, Optional

import torch

from .. import sync
from ..batch import lead_index
from ..ops import lp as lp_ops
from ..sync import pmax, pmin, psum
from .config import TrackerShapes, TrackerParams
from .grow import smallest_k
from .state import TrackerState

BIG = 1e4
K_ENUM = 4
C_ENUM = 16

# Formulation switches, at the JAX package's sizes (select.py:109,263,
# 979).  Up to _USAGE_DENSE_LIMIT virtual elements ``_hist_usage`` and
# ``_selection_feasible`` compare densely, above it they scatter.  Below
# _INT32_WALL elements of [T, n_slots] ``cluster`` and ``select_hybrid``
# build contestedness and the compact usage from the dense usage tensor;
# from the wall on (strictly: T * n_slots == _INT32_WALL already takes
# the scatter build) from min/max-target-id scatters.  On an H100 the
# dense builds are the faster ones at the bench shape (PERF.md, Select
# build), so the constants stand.
_USAGE_DENSE_LIMIT = 1 << 29
_INT32_WALL = 1 << 31
CLUSTER_COMPACT_CAP = 2048

INF = float("inf")


class SelectionResult(NamedTuple):
    sel: torch.Tensor        # [T] selected leaf per target
    feasible: torch.Tensor   # [] bool
    obj: torch.Tensor        # [] selected total score
    bound: torch.Tensor      # [] lower bound (gap certificate)
    labels: torch.Tensor     # [T] cluster label per target
    n_clusters: torch.Tensor  # [] number of clusters
    lam: torch.Tensor        # [S] final dual prices


# ----------------------------------------------------------------------
# Usage encoding
# ----------------------------------------------------------------------

def _batch_offset(idx, lead, stride):
    """Flat indices of one scenario per leading position moved to that
    scenario's block of ``stride`` entries (no-op without batch axes)."""
    if not lead:
        return idx
    off = torch.arange(math.prod(lead), device=idx.device).reshape(
        *lead, *(1,) * (idx.dim() - len(lead)))
    return idx + off * stride


def _slot_index(state: TrackerState, shapes: TrackerShapes):
    """Global single-use slot id of each (leaf, window column): radar
    measurement m at column w -> w*(M+A) + m, AIS message a ->
    w*(M+A) + M + a, none -> n_slots.  Returns ([T,L,W,2], n_slots)."""
    W = state.hist_meas.shape[-1]
    M, A = shapes.max_meas, shapes.max_ais
    per_col = M + A
    n_slots = W * per_col
    w_ids = torch.arange(W, device=state.hist_meas.device)[None, None, :]
    radar = torch.where(state.hist_meas >= 1,
                        w_ids * per_col + (state.hist_meas - 1), n_slots)
    ais = torch.where(state.hist_ais >= 1,
                      w_ids * per_col + M + (state.hist_ais - 1), n_slots)
    return torch.stack([radar, ais], dim=-1), n_slots


def _hist_usage(state: TrackerState, shapes: TrackerShapes, tgt_filter=None):
    """[T, W, M+A] bool: does any live leaf of target t use radar
    measurement m (block [0, M)) or AIS message a (block [M, M+A)) at
    window column w?  Dense compares up to _USAGE_DENSE_LIMIT virtual
    elements, one scatter of the T*L*W labels per family above."""
    *lead, T, L, W = state.hist_meas.shape
    M, A = shapes.max_meas, shapes.max_ais
    dev = state.hist_meas.device
    live = state.leaf_mask
    if tgt_filter is not None:
        live = live & tgt_filter[..., None]
    if T * L * W * (M + A) <= _USAGE_DENSE_LIMIT:
        live4 = live[..., None, None]
        um = ((state.hist_meas[..., None]
               == torch.arange(1, M + 1, device=dev)) & live4).any(dim=-3)
        ua = ((state.hist_ais[..., None]
               == torch.arange(1, A + 1, device=dev)) & live4).any(dim=-3)
        return torch.cat([um, ua], dim=-1)
    P = M + A
    n = T * W * P
    base = ((torch.arange(T, device=dev)[:, None, None] * W
             + torch.arange(W, device=dev)[None, None, :]) * P)    # [T,1,W]
    live3 = live[..., None]
    mi = torch.where((state.hist_meas >= 1) & live3,
                     base + state.hist_meas - 1, n)                # [T,L,W]
    ai = torch.where((state.hist_ais >= 1) & live3,
                     base + M + state.hist_ais - 1, n)
    out = torch.zeros((math.prod(lead) * (n + 1),), dtype=torch.bool,
                      device=dev)
    # int64 indices: n cannot overflow; the value is a device scalar (a
    # Python one would be copied from the host, which a capture refuses)
    one = torch.ones((), dtype=torch.bool, device=dev)
    out[_batch_offset(mi, lead, n + 1).reshape(-1)] = one
    out[_batch_offset(ai, lead, n + 1).reshape(-1)] = one
    return out.view(*lead, n + 1)[..., :n].reshape(*lead, T, W, P)


def target_usage(state: TrackerState, shapes: TrackerShapes):
    """([T, n_slots] bool: does any live leaf of target t use slot s?,
    n_slots)."""
    use = _hist_usage(state, shapes)
    *lead, T, W, P = use.shape
    return use.reshape(*lead, T, W * P), W * P


def _slot_flat_labels(state: TrackerState, shapes: TrackerShapes):
    """Flat slot id per (leaf, window column) for radar and AIS labels:
    w*(M+A) + (m-1) and w*(M+A) + M + (a-1); no label or dead leaf -> n
    (= W*(M+A)).  Small [T, L, W] int64 tensors, never [T, n_slots]."""
    W = state.hist_meas.shape[-1]
    M, A = shapes.max_meas, shapes.max_ais
    P = M + A
    n = W * P
    base = torch.arange(W, device=state.hist_meas.device)[None, None, :] * P
    live3 = state.leaf_mask[..., None]
    mi = torch.where((state.hist_meas >= 1) & live3,
                     base + state.hist_meas - 1, n)                # [T,L,W]
    ai = torch.where((state.hist_ais >= 1) & live3,
                     base + M + state.hist_ais - 1, n)
    return mi, ai, n


def _filtered_flat_labels(state, shapes, tgt_filter):
    mi, ai, n = _slot_flat_labels(state, shapes)
    if tgt_filter is not None:
        keep = tgt_filter[..., None, None]
        mi = torch.where(keep, mi, n)
        ai = torch.where(keep, ai, n)
    return mi, ai, n


def _contested_minmax(state: TrackerState, shapes: TrackerShapes,
                      tgt_filter=None, axis=None):
    """Exact per-slot contestedness without a [T, n_slots] tensor: scatter
    the smallest and the largest target id using each slot into [n_slots]
    buffers; a slot is used by two distinct targets iff min < max.  Masked
    entries go to the dump index n.  With an ``axis`` (targets split over
    its ranks) the ids are global and the buffers are pmin'd / pmax'd.
    Returns (contested, used), both [n_slots] bool."""
    *lead, T = state.hist_meas.shape[:-2]
    mi, ai, n = _filtered_flat_labels(state, shapes, tgt_filter)
    dev = mi.device
    T_g = T if axis is None else T * axis.size
    tid = torch.arange(T, dtype=torch.int32, device=dev)[:, None, None] \
        .expand(mi.shape).reshape(-1)
    if axis is not None:
        tid = tid + axis.index * T
    nb = math.prod(lead)
    mn = torch.full((nb * (n + 1),), T_g, dtype=torch.int32, device=dev)
    mx = torch.full((nb * (n + 1),), -1, dtype=torch.int32, device=dev)
    for idx in (mi, ai):
        f = _batch_offset(idx, lead, n + 1).reshape(-1)
        mn.scatter_reduce_(0, f, tid, 'amin', include_self=True)
        mx.scatter_reduce_(0, f, tid, 'amax', include_self=True)
    mn = pmin(axis, mn.view(*lead, n + 1)[..., :n])
    mx = pmax(axis, mx.view(*lead, n + 1)[..., :n])
    return mn < mx, mx >= 0


def _compact_rank(contested, cap):
    """[S+1] map: flat slot id -> compact column (< cap), or the dump
    column ``cap`` (uncontested, beyond the cap, or the invalid id S)."""
    r = torch.cumsum(contested.int(), -1) - 1
    rank = torch.where(contested & (r < cap), r, cap)
    return torch.cat([rank, rank.new_full((*rank.shape[:-1], 1), cap)],
                     dim=-1)


def _compact_usage(state: TrackerState, shapes: TrackerShapes, rank_pad,
                   cap, tgt_filter=None):
    """[T, cap] f32: does any live leaf of target t use compact contested
    column c?  One 2-D scatter of a constant per label family (duplicate
    writes of the same value), never a [T, n_slots] tensor."""
    *lead, T = state.hist_meas.shape[:-2]
    mi, ai, _ = _filtered_flat_labels(state, shapes, tgt_filter)
    dev = mi.device
    bi = lead_index(lead, dev, extra=1)
    tids = torch.arange(T, device=dev)[:, None, None].expand(mi.shape) \
        .reshape(*lead, -1)
    uc = torch.zeros((*lead, T, cap + 1), dtype=torch.float32, device=dev)
    one = torch.ones((), device=dev)
    for idx in (mi, ai):
        uc[(*bi, tids, rank_pad[(*bi, idx.reshape(*lead, -1))])] = one
    return uc[..., :cap]


# ----------------------------------------------------------------------
# Clustering
# ----------------------------------------------------------------------

def _propagate_labels(adj, carry):
    """One round of min-label propagation with pointer jumping."""
    labels, _ = carry
    *lead, T = labels.shape
    neigh = torch.where(adj, labels[..., None, :], T)
    new = torch.minimum(labels, neigh.amin(dim=-1))
    lab_pad = torch.cat([new, new.new_full((*lead, 1), T)], dim=-1)
    new = torch.minimum(
        new, lab_pad[(*lead_index(lead, adj.device, extra=1),
                      new.clamp(0, T))])
    return new, (new != labels).any(dim=-1)


def cluster(state: TrackerState, shapes: TrackerShapes, usage=None):
    """Connected components of the target-measurement sharing graph.
    Returns (labels [T], n_clusters []).  The adjacency is built over the
    contested slots only.  Below _INT32_WALL elements of [T, n_slots]
    they come from the dense usage tensor (at most CLUSTER_COMPACT_CAP of
    them, else the full usage matrix); from the wall on, from the
    min/max-target-id scatters, truncated to the first
    CLUSTER_COMPACT_CAP contested slots (clusters can then split, never
    merge)."""
    *lead, T, L, W = state.hist_meas.shape
    M, A = shapes.max_meas, shapes.max_ais
    S = W * (M + A)
    dev = state.hist_meas.device
    CAPc = min(CLUSTER_COMPACT_CAP, S)
    if T * S < _INT32_WALL:
        use = _hist_usage(state, shapes) if usage is None else usage
        useb = use.reshape(*lead, T, -1)                      # [T, S]
        contested = useb.sum(dim=-2) >= 2
        n_cont = contested.sum(dim=-1)
        slot_ids = torch.where(contested, torch.arange(S, device=dev), S)
        idx = torch.sort(slot_ids).values[..., :CAPc]
        uc = (torch.gather(useb, -1, idx.clamp(0, S - 1)[..., None, :]
                           .expand(*lead, T, CAPc))
              & (idx < S)[..., None, :]).float()

        def dense_full():
            usef = useb.float()
            return (usef @ usef.mT) > 0

        adj = sync.cond(n_cont <= CAPc, lambda: (uc @ uc.mT) > 0, dense_full)
    else:
        contested, _ = _contested_minmax(state, shapes)
        uc = _compact_usage(state, shapes, _compact_rank(contested, CAPc),
                            CAPc)                             # [T, CAPc]
        adj = (uc @ uc.mT) > 0
    tm = state.tgt_mask
    adj = adj & tm[..., :, None] & tm[..., None, :]
    adj = adj | (torch.eye(T, dtype=torch.bool, device=dev)
                 & tm[..., :, None])

    tids = torch.arange(T, device=dev)
    # the JAX loop's first test is always true
    labels, _ = sync.while_loop(
        lambda c: c[1], lambda c, _: _propagate_labels(adj, c),
        (torch.where(tm, tids, T), torch.ones_like(tm[..., 0])),
        test_first=False)
    is_root = tm & (labels == tids)
    return labels.int(), is_root.sum(dim=-1).int()


def cluster_sizes(labels, tgt_mask):
    """[T] member count of each target's cluster (0 for inactive)."""
    same = ((labels[..., :, None] == labels[..., None, :])
            & tgt_mask[..., None, :])
    return torch.where(tgt_mask, same.sum(dim=-1).int(), 0)


def leaf_scores(state: TrackerState, params: TrackerParams):
    f = (state.leaf_cnllr - state.tgt_root_cnllr[..., None]) / params.N
    return torch.where(state.leaf_mask, f, BIG)


# ----------------------------------------------------------------------
# Dense IPM path
# ----------------------------------------------------------------------

def select_ipm(state: TrackerState, shapes: TrackerShapes,
               params: TrackerParams, budget: int = 8) -> SelectionResult:
    """The whole forest as one dense 0/1 program, solved by
    ``ops/lp.solve_ilp``: usage rows ``A_in [n_slots, T*L]`` scattered
    from the label histories, one equality row per target.  Takes a batch
    of forests too (leading scenario axes): one program per scenario,
    solved together."""
    *lead, T, L, W = state.hist_meas.shape
    lead = tuple(lead)
    dev = state.hist_meas.device
    slots, n_slots = _slot_index(state, shapes)
    n = T * L

    # A_in [n_slots, n]: leaf uses slot.  A scatter, not a one-hot (a
    # dense one-hot over slots is O(T*L*W*S) memory); int64 flat indices.
    s = torch.where(state.leaf_mask[..., None, None], slots, n_slots)
    col = torch.arange(n, device=dev).reshape(T, L)[..., None, None]
    flat_idx = _batch_offset(col * (n_slots + 1) + s, lead,
                             n * (n_slots + 1)).reshape(-1)
    A_in = torch.zeros((math.prod(lead) * n * (n_slots + 1),),
                       dtype=torch.float32, device=dev)
    A_in[flat_idx] = 1.0
    A_in = A_in.reshape(*lead, n, n_slots + 1)[..., :n_slots].mT.contiguous()
    # Keep every slot used by at least one leaf: within-target conflicts
    # across the window matter too (a measurement may be claimed by two
    # different targets' histories at different tree depths).
    in_mask = A_in.sum(dim=-1) > 0.5

    A_eq = (torch.arange(T, device=dev)[:, None]
            == (torch.arange(n, device=dev) // L)[None, :]).float()
    f = leaf_scores(state, params).reshape(*lead, n)
    # Inactive targets: the equality row must stay satisfiable, so their
    # leaf 0 is allowed as a dummy with zero cost.
    dummy = ((~state.tgt_mask)[..., None]
             & (torch.arange(L, device=dev) == 0)).reshape(*lead, n)
    var_mask = state.leaf_mask.reshape(*lead, n) | dummy
    f = torch.where(dummy, 0.0, f)

    ones_T = torch.ones((T,), dtype=torch.bool, device=dev)
    # tgt_mask is passed all-true so the dummy leaves keep their rows
    # feasible; inactive targets score 0 and do not move the objective.
    sel, feas, obj, bound = lp_ops.solve_ilp(
        f, A_eq, ones_T.float(), A_in,
        torch.ones((n_slots,), dtype=torch.float32, device=dev),
        var_mask, ones_T, in_mask, T, L, ones_T, budget=budget)
    labels, n_clusters = cluster(state, shapes)
    return SelectionResult(sel=sel.int(), feasible=feas, obj=obj,
                           bound=bound, labels=labels,
                           n_clusters=n_clusters, lam=state.lam)


# ----------------------------------------------------------------------
# Tier 2: batched exact enumeration of small clusters
# ----------------------------------------------------------------------

def _candidate_sets(state: TrackerState, f, C: int):
    """Top-C leaves per target by score (JAX top_k tie order), with the
    spine leaf forced into the set, and ``excl_lb`` [T]: a lower bound on
    the score of every leaf outside the set (+inf without truncation)."""
    L = f.shape[-1]
    topv, topi = smallest_k(f, C)
    spine = state.spine_leaf.long().clamp(0, L - 1)
    in_set = (topi == spine[..., None]).any(dim=-1)
    topi = topi.clone()
    topi[..., C - 1] = torch.where(in_set, topi[..., C - 1], spine)
    n_live = state.leaf_mask.sum(dim=-1)
    excl_lb = torch.where(n_live > C, topv[..., C - 1], INF)
    return topi, excl_lb


def _enum_buckets(bf, bs, n_slots):
    """Exhaustive C^K enumeration for a block of buckets (K = 4).
    bf [b,K,C], bs [b,K,C,W2] -> (best combo index [b], value [b])."""
    C = bf.shape[-1]
    K = K_ENUM
    conf = {}
    for i in range(K):
        for j in range(i + 1, K):
            a, b = bs[..., i, :, :], bs[..., j, :, :]          # [b,C,W2]
            eq = a[..., :, None, :, None] == b[..., None, :, None, :]
            valid = a[..., :, None, :, None] < n_slots
            conf[(i, j)] = (eq & valid).flatten(-2).any(dim=-1)  # [b,C,C]
    score = (bf[..., 0, :][..., :, None, None, None]
             + bf[..., 1, :][..., None, :, None, None]
             + bf[..., 2, :][..., None, None, :, None]
             + bf[..., 3, :][..., None, None, None, :])
    ok = (~conf[(0, 1)][..., :, :, None, None]
          & ~conf[(0, 2)][..., :, None, :, None]
          & ~conf[(0, 3)][..., :, None, None, :]
          & ~conf[(1, 2)][..., None, :, :, None]
          & ~conf[(1, 3)][..., None, :, None, :]
          & ~conf[(2, 3)][..., None, None, :, :])
    total = torch.where(ok, score, INF).flatten(-4)             # [b, C^K]
    return total.argmin(dim=-1), total.amin(dim=-1)


def _enum_small_clusters(state: TrackerState, f, slots_flat, n_slots: int,
                         labels, small, C: int = C_ENUM):
    """Exact batched solve of all clusters with 2..K_ENUM members over
    each member's top-C leaves.  Returns (sel_enum [T], obj_small [],
    bound_small []), the bound sound under candidate truncation."""
    *lead, T, L, W2 = slots_flat.shape
    lead = tuple(lead)
    C = min(C, L)
    K = K_ENUM
    B = max(T // 2, 1)
    dev = f.device
    tidx = torch.arange(T, device=dev)
    bi1 = lead_index(lead, dev, extra=1)
    bi2 = lead_index(lead, dev, extra=2)

    same = small[..., None, :] & (labels[..., :, None] == labels[..., None, :])
    rank = (same & (tidx[None, :] < tidx[:, None])).sum(dim=-1)     # [T]
    is_root = small & (labels == tidx)
    bid_of_root = torch.cumsum(is_root.int(), -1) - 1
    bucket_of = torch.where(
        small, bid_of_root[(*bi1, labels.long().clamp(0, T - 1))], B)
    hit = (small[..., None, None, :]
           & (bucket_of[..., None, None, :]
              == torch.arange(B, device=dev)[:, None, None])
           & (rank[..., None, None, :]
              == torch.arange(K, device=dev)[None, :, None]))
    members = torch.where(hit.any(dim=-1), hit.int().argmax(dim=-1),
                          T)                                        # [B,K]

    cand_idx, excl_lb = _candidate_sets(state, f, C)
    cand_f = torch.gather(f, -1, cand_idx)                            # [T,C]
    cand_slots = torch.gather(
        slots_flat, -2, cand_idx[..., None].expand(*lead, T, C, W2))
    cand_f = torch.cat([cand_f, cand_f.new_zeros((*lead, 1, C))], -2)
    cand_slots = torch.cat(
        [cand_slots, cand_slots.new_full((*lead, 1, C, W2), n_slots)], -3)
    bf = cand_f[(*bi2, members)]                                      # [B,K,C]
    bs = cand_slots[(*bi2, members)]                               # [B,K,C,W2]

    # Chunk buckets so the [b, C^K] tensor stays <= B_CHUNK * C^K floats
    # (over all scenarios).
    chunk = max(256 // math.prod(lead), 1)
    parts = [_enum_buckets(bf[..., i:i + chunk, :, :],
                           bs[..., i:i + chunk, :, :, :], n_slots)
             for i in range(0, B, chunk)]
    best = torch.cat([p[0] for p in parts], -1)
    best_val = torch.cat([p[1] for p in parts], -1)
    c_of = torch.stack([best // C ** 3, (best // C ** 2) % C,
                        (best // C) % C, best % C], dim=-1)           # [B,K]
    chosen = c_of[(*bi1, bucket_of.clamp(0, B - 1), rank.clamp(0, K - 1))]
    sel_enum = cand_idx[(*bi1, tidx, chosen)]
    finite = torch.isfinite(best_val)
    obj_small = torch.where(finite, best_val, 0.0).sum(dim=-1)

    min_incl = torch.cat([cand_f[..., :T, :].amin(dim=-1),
                          f.new_zeros((*lead, 1))], -1)
    excl_pad = torch.cat([excl_lb, excl_lb.new_full((*lead, 1), INF)], -1)
    b_min, b_excl = min_incl[(*bi2, members)], excl_pad[(*bi2, members)]
    indep = b_min.sum(dim=-1)
    swap_pen = (b_excl - b_min).amin(dim=-1)
    lb_outside = torch.where(torch.isfinite(swap_pen), indep + swap_pen, INF)
    lb_bucket = torch.minimum(torch.where(finite, best_val, INF), lb_outside)
    bound_small = torch.where(torch.isfinite(lb_bucket), lb_bucket,
                              0.0).sum(dim=-1)
    return sel_enum, obj_small, bound_small


# ----------------------------------------------------------------------
# The gather/scatter Lagrangian over all slots ('lagrangian_pure')
# ----------------------------------------------------------------------

def _on_cadence(feas, it_dev, it_host: int, cadence: int, active):
    """The scenarios whose iteration repairs (infeasible, on the
    cadence, still running), or None on an iteration off the cadence.
    Under capture one body serves every iteration, so the cadence is
    tested on the device's count ``it_dev`` and the branch is entered
    every iteration; eagerly the host's count ``it_host`` (the same
    number) skips the branch, and its host read, off the cadence."""
    if sync.captured(feas):
        need = ~feas & (it_dev % cadence == 0)
    elif it_host % cadence == 0:
        need = ~feas
    else:
        return None
    return need if active is None else need & active


class _PureCarry(NamedTuple):
    it: torch.Tensor          # [] i64: iterations run (a device value, so
                              # that a captured body tests its cadence)
    lam: torch.Tensor
    best_sel: torch.Tensor
    best_obj: torch.Tensor
    best_feas: torch.Tensor
    best_lb: torch.Tensor
    last_sel: torch.Tensor
    stale: torch.Tensor


def select_lagrangian(state: TrackerState, shapes: TrackerShapes,
                      params: TrackerParams, iters: int = 60,
                      theta: float = 1.0,
                      participate: Optional[torch.Tensor] = None,
                      obj_offset=0.0,
                      lam0: Optional[torch.Tensor] = None,
                      patience: int = 6,
                      repair_rounds: int = 8,
                      repair_cadence: int = 4,
                      with_clusters: bool = True) -> SelectionResult:
    """Subgradient ascent with gather/scatter duals, no matrices.

    Dual price lam[s] per single-use slot; the reduced cost of a leaf is
    its score plus the prices of every slot in its history (one gather).
    The decode is an argmin per target; usage counts come from a
    scatter-add of the decoded selection.  Feasible incumbents are
    maintained with a conflict-repair sweep.

    ``participate`` restricts the solve to a subset of targets (their
    clusters must be disjoint from the rest: guaranteed when the subset
    is a union of connected components).  ``obj_offset`` is the exact
    objective of the already-solved remainder, used only to scale the
    relative convergence tolerance.  Two host reads per iteration (the
    loop test and the repair branch, taken on the cadence), one per
    repair round after the first.
    Takes a batch of forests too (leading scenario axes): the loops then
    run while any scenario continues (``sync.while_loop``).
    """
    *lead, T, L, W = state.hist_meas.shape
    lead = tuple(lead)
    nb = math.prod(lead)
    dev = state.hist_meas.device
    eff_tgt = state.tgt_mask if participate is None \
        else (state.tgt_mask & participate)
    eff_leaf = state.leaf_mask & eff_tgt[..., None]
    slots, n_slots = _slot_index(state, shapes)                 # [T,L,W,2]
    f = leaf_scores(state, params)                              # [T,L]
    slots_flat = slots.reshape(*lead, T, L, W * 2)
    lam_init = state.lam if lam0 is None else lam0
    tb = torch.arange(T, device=dev)
    bi1 = lead_index(lead, dev, extra=1)      # [..., T] picks
    bi2 = lead_index(lead, dev, extra=2)      # [..., T, K] picks of slots
    bi3 = lead_index(lead, dev, extra=3)      # [..., T, L, K] picks
    zero1 = torch.zeros((*lead, 1), dtype=torch.float32, device=dev)
    false1 = torch.zeros((*lead, 1), dtype=torch.bool, device=dev)

    def reduced_cost(lam):
        lam_pad = torch.cat([lam, zero1], dim=-1)
        return f + lam_pad[(*bi3, slots_flat)].sum(dim=-1)

    def decode(lam):
        rc = reduced_cost(lam)
        lb = (torch.where(eff_tgt, rc.amin(dim=-1), 0.0).sum(dim=-1)
              - lam.sum(dim=-1))
        return rc.argmin(dim=-1), lb

    def own_slots(sel):
        return torch.where(eff_tgt[..., None], slots_flat[(*bi1, tb, sel)],
                           n_slots)

    def per_slot(own, vals, fill, reduce):
        """``vals`` reduced into a [..., n_slots + 1] table at the slots
        ``own`` (one flat scatter for every scenario)."""
        out = torch.full((nb * (n_slots + 1),), fill, dtype=vals.dtype,
                         device=dev)
        out.scatter_reduce_(0, _batch_offset(own, lead,
                                             n_slots + 1).reshape(-1),
                            vals.reshape(-1), reduce, include_self=True)
        return out.view(*lead, n_slots + 1)

    def usage_of(sel):
        s = _batch_offset(own_slots(sel), lead, n_slots + 1).reshape(-1)
        cnt = torch.zeros((nb * (n_slots + 1),), dtype=torch.float32,
                          device=dev)
        cnt.index_add_(0, s, torch.ones_like(s, dtype=torch.float32))
        return cnt.view(*lead, n_slots + 1)[..., :n_slots]

    # Per-(target, column) unavoidability: a slot is unavoidable for t if
    # EVERY live leaf of t uses it (a shared within-window prefix).  An
    # unavoidable claimant must win the keep decision: by grow's spine
    # invariant at most one target can unavoidably claim a slot.  A
    # slot's window column is part of its identity, so the test is a
    # [T, W*2] all-live-leaves-agree test per column, not a [T, n_slots]
    # table.  Loop-invariant.
    sf = torch.where(eff_leaf[..., None], slots_flat, -1)        # [T,L,K]
    rep = sf.amax(dim=-2)                                        # [T,K]
    agree = ((sf == rep[..., None, :]) | ~eff_leaf[..., None]).all(dim=-2)
    unav_cols = (agree & (rep >= 0) & (rep < n_slots)
                 & (eff_leaf.sum(dim=-1) > 0)[..., None]).float()  # [T,K]
    ar_L = torch.arange(L, device=dev)

    def repair_round(rc, carry):
        """Keep-best-per-slot conflict resolution: every over-used slot
        keeps its best claimant (unavoidable claimants first, then
        spine holders, then score; lowest index within tolerance); all
        other conflicted targets ban their current leaf and repick by
        reduced cost plus a penalty on still-contested slots.  A spine
        holder never loses its slot, so the repair ends at the
        all-spines assignment in the worst case."""
        sel, banned, _ = carry
        over_pad = torch.cat([usage_of(sel) > 1.5, false1], dim=-1)
        own = own_slots(sel)                                      # [T,K]
        on_spine = (sel == state.spine_leaf).float()
        key = (f[(*bi1, tb, sel)][..., None] - 1e8 * unav_cols
               - 5e7 * on_spine[..., None])
        over_own = over_pad[(*bi2, own)]
        claim = torch.where(over_own, key, INF)
        slot_min = per_slot(own, claim, INF, 'amin')
        in_conf = over_own.any(dim=-1) & eff_tgt
        # The keeper of a slot is the LOWEST-INDEX claimant within
        # tolerance of the slot's best key (an epsilon added to the key
        # itself would vanish in f32 next to the priority offsets).
        min_own = slot_min[(*bi2, own)]
        is_min = over_own & (key <= min_own + 1e-5 * (1.0 + min_own.abs()))
        cand = torch.where(is_min, tb[:, None], T)
        slot_owner = per_slot(own, cand, T, 'amin')
        keeper = (~over_own
                  | (slot_owner[(*bi2, own)] == tb[:, None])).all(dim=-1)
        loser = in_conf & ~keeper
        banned = banned | (loser[..., None] & (ar_L == sel[..., None]))
        # Conflict-aware repick: penalise leaves that touch any slot
        # currently over-used so losers prefer clean leaves.
        pen = over_pad[(*bi3, slots_flat)].sum(dim=-1).float()
        rcb = torch.where(banned, INF, rc + 1e3 * pen)
        sel = torch.where(loser, rcb.argmin(dim=-1), sel)
        return sel, banned, in_conf.any(dim=-1)

    def repair(sel, lam, active=None):
        """Repair rounds until no target (of the ``active`` scenarios) is
        in conflict; the JAX loop starts with had_conf = True, so round 0
        is not tested."""
        rc = reduced_cost(lam)

        def go_on(carry):
            return carry[2] if active is None else carry[2] & active

        sel = sync.while_loop(
            go_on, lambda c, _: repair_round(rc, c),
            (sel, torch.zeros((*lead, T, L), dtype=torch.bool, device=dev),
             torch.ones_like(eff_tgt[..., 0])),
            max_iters=repair_rounds, test_first=False)[0]
        return sel, ~(usage_of(sel) > 1.5).any(dim=-1)

    def obj_of(sel):
        return torch.where(eff_tgt, f[(*bi1, tb, sel)], 0.0).sum(dim=-1)

    def step(c: _PureCarry, active) -> _PureCarry:
        """One subgradient iteration: decode, (on cadence) repair into a
        feasible incumbent, fixed-theta Polyak step."""
        sel, lb = decode(c.lam)
        best_lb = torch.maximum(c.best_lb, lb)
        cnt = usage_of(sel)
        # Subgradient of the dualised <=1 rows over rows in play: used
        # rows push prices up, slack rows that still carry a price decay
        # back toward 0.
        g = torch.where((cnt > 0) | (c.lam > 0), cnt - 1.0, 0.0)
        feas = ~(cnt > 1.5).any(dim=-1)
        need = _on_cadence(feas, c.it, next(rounds), repair_cadence, active)
        sel_c, feas_c = sel, feas
        if need is not None:
            sel_c, feas_c = sync.cond(
                need,
                lambda: repair(sel, c.lam, need if need.dim() else None),
                lambda: (sel, feas))
        obj = torch.where(feas_c, obj_of(sel_c), INF)
        better = feas_c & ((obj < c.best_obj - 1e-6) | ~c.best_feas)
        # Patience resets only on a MATERIAL improvement (>= 0.01 % of
        # the pre-update incumbent).
        material = feas_c & ((obj < c.best_obj
                              - 1e-4 * (1.0 + c.best_obj.abs()))
                             | ~c.best_feas)
        best_sel = torch.where(better[..., None], sel_c, c.best_sel)
        best_obj = torch.where(better, obj, c.best_obj)
        best_feas = c.best_feas | feas_c
        same = (sel == c.last_sel).all(dim=-1)
        stale = torch.where(material, 0, c.stale + 1)
        stale = torch.where(feas & same, stale + 3, stale)
        gnorm2 = torch.clamp(_sq_norm(g), min=1e-6)
        gap_est = torch.where(
            best_feas,
            torch.minimum(torch.clamp(best_obj - lb, min=1e-3),
                          1.0 + 0.25 * best_obj.abs()),
            1.0)
        lam = torch.clamp(c.lam + (theta * gap_est / gnorm2)[..., None] * g,
                          min=0.0)
        return _PureCarry(c.it + 1, lam, best_sel, best_obj, best_feas,
                          best_lb, sel, stale)

    def go_on(c: _PureCarry):
        gap = c.best_obj - c.best_lb
        # Convergence is judged against the GLOBAL objective (exact part
        # + this subproblem).  The patience exit only fires once the
        # certified gap is inside the 0.1 % contract.
        scale = 1.0 + (obj_offset + c.best_obj).abs()
        converged = c.best_feas & (gap <= 2e-4 * scale)
        patience_out = (c.best_feas & (c.stale >= patience)
                        & (gap <= 1e-3 * scale))
        return ~converged & ~patience_out

    # Seed a feasible incumbent by repairing the warm-started decode.
    sel_seed, lb_seed = decode(lam_init)
    sel_seed, feas_seed = repair(sel_seed, lam_init)
    obj_seed = torch.where(feas_seed, obj_of(sel_seed), INF)
    zero_i = torch.zeros(lead, dtype=torch.int64, device=dev)
    c = _PureCarry(zero_i, lam_init, sel_seed, obj_seed, feas_seed, lb_seed,
                   sel_seed, zero_i)
    rounds = itertools.count()          # the host's iteration count
    c = sync.while_loop(go_on, step, c, max_iters=iters)

    if with_clusters:
        labels, n_clusters = cluster(state, shapes)
    else:
        labels = torch.zeros((*lead, T), dtype=torch.int32, device=dev)
        n_clusters = torch.full(lead, -1, dtype=torch.int32, device=dev)
    return SelectionResult(sel=c.best_sel.int(), feasible=c.best_feas,
                           obj=c.best_obj, bound=c.best_lb, labels=labels,
                           n_clusters=n_clusters, lam=c.lam)


# ----------------------------------------------------------------------
# Tier 3: Lagrangian over the contested slots
# ----------------------------------------------------------------------

class _Compact(NamedTuple):
    """Loop-invariant data of the compact Lagrangian.  With ``axis`` the
    targets are this rank's share of a forest split over the axis's
    ranks: usage counts, objectives and bounds are psums, and the repair
    keys and owners are pmins over global target ids."""
    f: torch.Tensor          # [T, L] leaf scores
    Uc: torch.Tensor         # [T, L, CAP] contested-slot usage (0/1)
    spine: torch.Tensor      # [T]
    eff_tgt: torch.Tensor    # [T] bool — participating targets
    unavoid: torch.Tensor    # [T, CAP] bool — every live leaf uses slot
    axis: Optional[object] = None   # parallel.collectives.Axis


def _rc_of(cp: _Compact, lam):
    return cp.f + torch.einsum('...tlc,...c->...tl', cp.Uc, lam)


def _usel_of(cp: _Compact, sel):
    ix = lead_index(sel.shape, sel.device)
    return cp.Uc[(*ix, sel)]                                          # [T,CAP]


def _usage_count(cp: _Compact, sel):
    """[CAP] global number of targets whose leaf ``sel`` uses each
    column."""
    return psum(cp.axis, _usel_of(cp, sel).sum(dim=-2))


def _decode(cp: _Compact, lam):
    rc = _rc_of(cp, lam)
    lb = (psum(cp.axis, torch.where(cp.eff_tgt, rc.amin(dim=-1),
                                    0.0).sum(dim=-1))
          - lam.sum(dim=-1))
    return rc.argmin(dim=-1), lb


def _obj_of(cp: _Compact, sel):
    ix = lead_index(sel.shape, sel.device)
    return psum(cp.axis,
                torch.where(cp.eff_tgt, cp.f[(*ix, sel)], 0.0).sum(dim=-1))


def _sq_norm(g):
    """g . g over the last axis (``torch.dot`` for one problem)."""
    return torch.dot(g, g) if g.dim() == 1 else (g * g).sum(dim=-1)


def _repair_round(cp: _Compact, rc, carry):
    """Keep-best-per-slot conflict resolution: each over-used slot keeps
    its best claimant (unavoidable claimants first, then spine holders,
    then score; lowest global index within tolerance); the others ban
    their current leaf and repick by reduced cost plus a contested
    penalty."""
    sel, banned, _ = carry
    *lead, T, L = cp.f.shape
    dev = sel.device
    tb = torch.arange(T, device=dev)
    gidx, T_g = tb, T                    # global target ids
    if cp.axis is not None:
        gidx, T_g = tb + cp.axis.index * T, T * cp.axis.size
    usel = _usel_of(cp, sel)
    over = psum(cp.axis, usel.sum(dim=-2)) > 1.5                     # [CAP]
    on_spine = (sel == cp.spine).float()
    keyc = (cp.f[(*lead_index(lead, dev, extra=1), tb, sel)][..., None]
            - 5e7 * on_spine[..., None] - 1e8 * cp.unavoid.float())
    claiming = (usel > 0.5) & over[..., None, :]
    slot_min = pmin(cp.axis, torch.where(claiming, keyc, INF).amin(dim=-2))
    in_conf = claiming.any(dim=-1) & cp.eff_tgt
    tol = 1e-5 * (1.0 + slot_min.abs())
    is_min = claiming & (keyc <= (slot_min + tol)[..., None, :])
    owner = pmin(cp.axis,
                 torch.where(is_min, gidx[:, None], T_g).amin(dim=-2))
    keeper = (~claiming | (owner[..., None, :] == gidx[:, None])).all(dim=-1)
    loser = in_conf & ~keeper
    banned = banned | (loser[..., None]
                       & (torch.arange(L, device=dev)[None, :]
                          == sel[..., None]))
    pen = torch.einsum('...tlc,...c->...tl', cp.Uc, over.float())
    rcb = torch.where(banned, INF, rc + 1e3 * pen)
    sel = torch.where(loser, rcb.argmin(dim=-1), sel)
    any_conf = in_conf.any(dim=-1)
    if cp.axis is not None:
        any_conf = cp.axis.psum(any_conf) > 0
    return sel, banned, any_conf


def _repair(cp: _Compact, sel, lam, repair_rounds, active=None):
    """Repair rounds until no target is in conflict (of the ``active``
    scenarios); the JAX loop starts with had_conf = True, so round 0 is
    not tested."""
    rc = _rc_of(cp, lam)

    def go_on(carry):
        return carry[2] if active is None else carry[2] & active

    sel = sync.while_loop(
        go_on, lambda c, _: _repair_round(cp, rc, c),
        (sel, torch.zeros_like(cp.f, dtype=torch.bool),
         torch.ones_like(cp.eff_tgt[..., 0])),
        max_iters=repair_rounds, test_first=False)[0]
    return sel, ~(_usage_count(cp, sel) > 1.5).any(dim=-1)


class _LagCarry(NamedTuple):
    it: torch.Tensor          # [] i64: iterations run (a device value, so
                              # that a captured body tests its cadence)
    lam: torch.Tensor
    best_sel: torch.Tensor
    best_obj: torch.Tensor
    best_feas: torch.Tensor
    best_lb: torch.Tensor
    stale: torch.Tensor
    th: torch.Tensor
    lb_stale: torch.Tensor


def _lagrangian_step(cp: _Compact, repair_rounds, repair_cadence,
                     c: _LagCarry, active=None, it: int = 0) -> _LagCarry:
    """One subgradient iteration: decode, (on cadence) repair into a
    feasible incumbent, Held-Karp step-size halving, dual update.
    ``active``: the scenarios whose loop still runs (None: all); ``it``:
    the iteration, counted on the host (``_on_cadence``).  Under an axis
    every value the update reads is reduced, so the duals stay equal on
    every rank without a broadcast."""
    sel, lb = _decode(cp, c.lam)
    lb_up = lb > c.best_lb + 1e-6 * (1.0 + c.best_lb.abs())
    best_lb = torch.maximum(c.best_lb, lb)
    cnt = _usage_count(cp, sel)
    g = torch.where((cnt > 0) | (c.lam > 0), cnt - 1.0, 0.0)
    feas = ~(cnt > 1.5).any(dim=-1)
    need = _on_cadence(feas, c.it, it, repair_cadence, active)
    sel_c, feas_c = sel, feas
    if need is not None:
        sel_c, feas_c = sync.cond(
            need, lambda: _repair(cp, sel, c.lam, repair_rounds,
                                  need if need.dim() else None),
            lambda: (sel, feas))
    obj = torch.where(feas_c, _obj_of(cp, sel_c), INF)
    better = feas_c & ((obj < c.best_obj - 1e-6) | ~c.best_feas)
    material = feas_c & ((obj < c.best_obj
                          - 1e-4 * (1.0 + c.best_obj.abs()))
                         | ~c.best_feas)
    best_sel = torch.where(better[..., None], sel_c, c.best_sel)
    best_obj = torch.where(better, obj, c.best_obj)
    best_feas = c.best_feas | feas_c
    stale = torch.where(material, 0, c.stale + 1)
    lb_stale = torch.where(lb_up, 0, c.lb_stale + 1)
    halve = lb_stale >= 3
    th = torch.where(halve, torch.clamp(c.th * 0.5, min=0.05), c.th)
    lb_stale = torch.where(halve, 0, lb_stale)
    gnorm2 = torch.clamp(_sq_norm(g), min=1e-6)
    gap_est = torch.where(
        best_feas,
        torch.minimum(torch.clamp(best_obj - lb, min=1e-3),
                      1.0 + 0.25 * best_obj.abs()),
        1.0)
    lam = torch.clamp(c.lam + (th * gap_est / gnorm2)[..., None] * g,
                      min=0.0)
    return _LagCarry(c.it + 1, lam, best_sel, best_obj, best_feas, best_lb,
                     stale, th, lb_stale)


def _lagrangian_continue(c: _LagCarry, obj_offset, patience):
    gap = c.best_obj - c.best_lb
    scale = 1.0 + (obj_offset + c.best_obj).abs()
    converged = c.best_feas & (gap <= 2e-4 * scale)
    patience_out = c.best_feas & (c.stale >= patience) & (gap <= 1e-3 * scale)
    return ~converged & ~patience_out


def _compact_lagrangian(f, Uc, lam0, spine, eff_tgt, eff_leaf, obj_offset,
                        iters=60, theta=1.5, patience=4, repair_rounds=8,
                        repair_cadence=4, axis=None, force_iters=False):
    """Subgradient ascent over the CAP contested slots only.  ``Uc [T, L,
    CAP]`` is the 0/1 usage of contested slot c by leaf (t, l), masked to
    live leaves of participating targets.  With ``axis`` the same loop
    runs on this rank's targets of a forest split over the axis (the
    JAX function's ``axis_name``): 2 x [CAP] values reduced per iteration
    (+ 2 x [CAP] pmins per repair round), every loop exit read on a
    reduced, hence replicated, value.  ``force_iters`` runs exactly
    ``iters`` bodies, without the convergence and patience exits and so
    without a host read of them (A/B instrumentation, never set in
    production).  Returns (sel, feasible, obj, lower bound, lam)."""
    dev = f.device
    lead = f.shape[:-2]
    n_live = eff_leaf.sum(dim=-1).float()
    unavoid = ((Uc.sum(dim=-2) >= n_live[..., None] - 0.5)
               & (n_live[..., None] > 0.5))
    cp = _Compact(f, Uc, spine.long(), eff_tgt, unavoid, axis)

    sel_seed, lb_seed = _decode(cp, lam0)
    sel_seed, feas_seed = _repair(cp, sel_seed, lam0, repair_rounds)
    obj_seed = torch.where(feas_seed, _obj_of(cp, sel_seed), INF)
    zero_i = torch.zeros(lead, dtype=torch.int64, device=dev)
    c = _LagCarry(zero_i, lam0, sel_seed, obj_seed, feas_seed, lb_seed, zero_i,
                  torch.full(lead, theta, dtype=torch.float32, device=dev),
                  zero_i)
    rounds = itertools.count()          # the host's iteration count
    c = sync.while_loop(
        None if force_iters
        else lambda c: _lagrangian_continue(c, obj_offset, patience),
        lambda c, active: _lagrangian_step(cp, repair_rounds,
                                           repair_cadence, c, active,
                                           next(rounds)),
        c, max_iters=iters)
    return c.best_sel, c.best_feas, c.best_obj, c.best_lb, c.lam


def _contested_leaf_usage(state: TrackerState, shapes: TrackerShapes, big,
                          CAP: int, usage=None, axis=None):
    """The compact Lagrangian's columns: the first CAP slots used by two
    or more distinct ``big`` targets, and each live leaf's 0/1 usage of
    them.  With the dense ``usage`` [T, W, M+A] both come from compares;
    with ``usage=None`` from the min/max-target-id scatters and one
    scatter of each leaf's labels (no [T, n_slots] tensor).  With an
    ``axis`` the targets are this rank's share: contestedness is then
    global (one psum of the dense counts, or a pmin / pmax pair), hence
    the same columns on every rank.  Returns (Uc [T, L, CAP] f32,
    col_slot [CAP], col_ok [CAP], n_cont [], eff_leaf [T, L]: the live
    leaves of the ``big`` targets)."""
    *lead, T, L, W = state.hist_meas.shape
    M, A = shapes.max_meas, shapes.max_ais
    P = M + A
    S = W * P
    dev = state.hist_meas.device
    if usage is not None:
        n_use = (usage & big[..., None, None]).sum(dim=-3)
        if axis is not None:
            n_use = axis.psum(n_use.int())
        contested = (n_use >= 2).reshape(*lead, S)
    else:
        contested, _ = _contested_minmax(state, shapes, tgt_filter=big,
                                         axis=axis)
    n_cont = contested.sum(dim=-1)
    s_ids = torch.where(contested, torch.arange(S, device=dev), S)
    col_slot = torch.sort(s_ids).values[..., :CAP]
    col_ok = col_slot < S
    eff_leaf = state.leaf_mask & big[..., None]
    if usage is not None:
        cs = torch.where(col_ok, col_slot, 0)
        cw = torch.where(col_ok, cs // P, 0)
        off = cs % P
        cais = col_ok & (off >= M)
        # cval > 0 guards empty columns: hist_meas == 0 is the
        # zero-hypothesis code, not a slot.
        cval = torch.where(col_ok,
                           torch.where(off >= M, off - M + 1, off + 1), 0)

        def per_leaf(v):          # [CAP] against [T, L, W, CAP]
            return v[..., None, None, None, :]

        wids = torch.arange(W, device=dev)[None, None, :, None]
        m_match = ((state.hist_meas[..., None] == per_leaf(cval))
                   & ~per_leaf(cais) & per_leaf(cval > 0))
        a_match = ((state.hist_ais[..., None] == per_leaf(cval))
                   & per_leaf(cais))
        use_c = ((m_match | a_match) & (wids == per_leaf(cw))).any(dim=-2)
        Uc = (use_c & eff_leaf[..., None]).float()                  # [T,L,CAP]
    else:
        rank_pad = _compact_rank(contested, CAP)                    # [S+1]
        mi, ai, _ = _filtered_flat_labels(state, shapes, big)
        bi = lead_index(lead, dev, extra=1)
        tlids = torch.arange(T * L, device=dev)[:, None] \
            .expand(*lead, T * L, W).reshape(*lead, -1)
        Uc2 = torch.zeros((*lead, T * L, CAP + 1), dtype=torch.float32,
                          device=dev)
        one = torch.ones((), device=dev)
        for idx in (mi, ai):
            Uc2[(*bi, tlids, rank_pad[(*bi, idx.reshape(*lead, -1))])] = one
        Uc = Uc2[..., :CAP].reshape(*lead, T, L, CAP)
    return Uc, col_slot, col_ok, n_cont, eff_leaf


# ----------------------------------------------------------------------
# The tiered hybrid (production path)
# ----------------------------------------------------------------------

def select_hybrid(state: TrackerState, shapes: TrackerShapes,
                  params: TrackerParams, iters: int = 60,
                  theta: float = 1.5, enum_cands: int = C_ENUM,
                  patience: int = 4, contested_cap: int = 256,
                  labels_in=None) -> SelectionResult:
    """Cluster-decomposed selection: exact tiers 1-2 for clusters of up
    to K_ENUM targets, compact contested-slot Lagrangian for the rest.
    Takes a batch of forests too (leading scenario axes): tier 3 then
    runs where any scenario has a big cluster and is selected per
    scenario, and the dense/scatter switches decide on one scenario's
    size, as under ``jax.vmap``."""
    *lead, T, L, W = state.hist_meas.shape
    lead = tuple(lead)
    M, A = shapes.max_meas, shapes.max_ais
    S = W * (M + A)
    dev = state.hist_meas.device
    slots, n_slots = _slot_index(state, shapes)
    slots_flat = slots.reshape(*lead, T, L, W * 2)
    f = leaf_scores(state, params)
    tb = torch.arange(T, device=dev)
    bi = lead_index(lead, dev, extra=1)

    dense_ok = T * S < _INT32_WALL
    usage = _hist_usage(state, shapes) if dense_ok else None
    labels, n_clusters = (cluster(state, shapes, usage=usage)
                          if labels_in is None else labels_in)
    csize = cluster_sizes(labels, state.tgt_mask)
    tm = state.tgt_mask
    singleton = tm & (csize == 1)
    small = tm & (csize >= 2) & (csize <= K_ENUM)
    big = tm & (csize > K_ENUM)

    sel0 = f.argmin(dim=-1)
    obj_single = torch.where(singleton, f.amin(dim=-1), 0.0).sum(dim=-1)
    sel_enum, obj_small, bound_small = _enum_small_clusters(
        state, f, slots_flat, n_slots, labels, small, C=enum_cands)
    exact_obj = obj_single + obj_small
    exact_bound = obj_single + bound_small

    # Tier 3 over the slots used by >= 2 distinct big-cluster targets.
    CAP = min(contested_cap, S)
    Uc, col_slot, col_ok, n_cont, eff_leaf = _contested_leaf_usage(
        state, shapes, big, CAP, usage)
    lam_pad0 = torch.cat([state.lam, state.lam.new_zeros((*lead, 1))], -1)
    lam_c0 = torch.where(col_ok, lam_pad0[(*bi, col_slot.clamp(0, S))], 0.0)

    def tier3():
        sel_big, feas_big, obj_big, bound_big, lam_out = _compact_lagrangian(
            f, Uc, lam_c0, state.spine_leaf, big, eff_leaf, exact_obj,
            iters=iters, theta=theta, patience=patience)
        lam = torch.zeros((*lead, S + 1), dtype=torch.float32, device=dev)
        lam.scatter_add_(-1, torch.where(col_ok, col_slot, S),
                         torch.where(col_ok, lam_out, 0.0))
        return sel_big, feas_big, obj_big, bound_big, lam[..., :S]

    def no_tier3():
        zero = torch.zeros(lead, dtype=torch.float32, device=dev)
        return (sel0, torch.ones(lead, dtype=torch.bool, device=dev), zero,
                zero, torch.zeros_like(state.lam))

    sel_big, feas_big, obj_big, bound_big, lam = sync.cond(
        big.any(dim=-1), tier3, no_tier3)

    sel = torch.where(singleton, sel0, torch.where(small, sel_enum, sel_big))

    # Overflow guard: with more than CAP contested slots the compact
    # solver cannot see every conflict — verify in the full slot space
    # and retreat big-cluster targets to their spines if needed.
    ok = _selection_feasible(state, shapes, sel)
    need_fb = (n_cont > CAP) & ~ok
    spine = state.spine_leaf.long().clamp(0, L - 1)
    sel = torch.where(need_fb[..., None] & big, spine, sel)
    obj_fb = torch.where(big, f[(*bi, tb, spine)], 0.0).sum(dim=-1)
    obj_big = torch.where(need_fb, obj_fb, obj_big)
    feas = torch.where(need_fb, _selection_feasible(state, shapes, sel),
                       feas_big & ok)
    return SelectionResult(sel=sel.int(), feasible=feas,
                           obj=exact_obj + obj_big,
                           bound=exact_bound + bound_big,
                           labels=labels, n_clusters=n_clusters, lam=lam)


def _independent_best(state: TrackerState, shapes: TrackerShapes,
                      params: TrackerParams):
    """Per-target best leaf, its objective, and whether that joint
    choice is conflict-free (then it is the global optimum)."""
    f = leaf_scores(state, params)
    sel = f.argmin(dim=-1)
    obj = torch.where(state.tgt_mask, f.amin(dim=-1), 0.0).sum(dim=-1)
    return sel, obj, _selection_feasible(state, shapes, sel)


def _selection_feasible(state: TrackerState, shapes: TrackerShapes, sel):
    """True iff ``sel`` uses every (window column, measurement/AIS) slot
    at most once.  Dense compares up to _USAGE_DENSE_LIMIT virtual
    elements, scatter-add counts above (T*W writes against T*W*(M+A)
    compares)."""
    *lead, T, L, W = state.hist_meas.shape
    lead = tuple(lead)
    M, A = shapes.max_meas, shapes.max_ais
    dev = state.hist_meas.device
    ix = (*lead_index(lead, dev, extra=1), torch.arange(T, device=dev))
    act = state.tgt_mask[..., None]
    sm = torch.where(act, state.hist_meas[(*ix, sel.long())], -1)    # [T,W]
    sa = torch.where(act, state.hist_ais[(*ix, sel.long())], 0)
    if T * W * (M + A) <= _USAGE_DENSE_LIMIT:
        cm = (sm[..., None] == torch.arange(1, M + 1, device=dev)) \
            .sum(dim=-3)
        ca = (sa[..., None] == torch.arange(1, A + 1, device=dev)) \
            .sum(dim=-3)
        return ~((cm > 1).flatten(-2).any(dim=-1)
                 | (ca > 1).flatten(-2).any(dim=-1))
    P = M + A
    n = W * P
    base_w = torch.arange(W, device=dev)[None, :] * P                # [1,W]
    smi = torch.where(sm >= 1, base_w + sm - 1, n)                   # [T,W]
    sai = torch.where(sa >= 1, base_w + M + sa - 1, n)
    # index_add_, not bincount: on a CUDA tensor bincount reads the
    # largest index on the host
    idx = _batch_offset(torch.cat([smi.flatten(-2), sai.flatten(-2)], -1),
                        lead, n + 1).reshape(-1)
    cnt = torch.zeros((math.prod(lead) * (n + 1),), dtype=torch.int32,
                      device=dev)
    cnt.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return ~(cnt.view(*lead, n + 1)[..., :n] > 1).any(dim=-1)


def select(state: TrackerState, shapes: TrackerShapes,
           params: TrackerParams, method: str = 'ipm',
           fast_path: bool = True, compute_clusters: bool = True,
           **kw) -> SelectionResult:
    """Global hypothesis selection.  ``'ipm'`` (the default, as in the
    JAX package) is the dense interior-point solve with truncated
    branch-and-bound, ``'lagrangian'`` the tiered hybrid (what the
    benchmark and production run), ``'lagrangian_pure'`` the
    gather/scatter Lagrangian on the whole forest, ``'greedy'`` the
    per-target independent best with its feasibility reported honestly.
    With ``fast_path`` no solver runs when the independent optima are
    conflict-free (they are then the global optimum).  Every method
    also takes a batch of forests (leading scenario axes): the solver
    then runs when any scenario conflicts, and the fast result is kept
    where a scenario's independent optima are conflict-free."""
    solver = {'ipm': select_ipm, 'lagrangian': select_hybrid,
              'lagrangian_pure': select_lagrangian}
    if method not in solver and method != 'greedy':
        raise ValueError(f"unknown selection method {method!r}")
    *lead, T = state.tgt_mask.shape
    lead = tuple(lead)
    if not fast_path and method != 'greedy':
        return solver[method](state, shapes, params, **kw)

    sel0, obj0, feas0 = _independent_best(state, shapes, params)
    dev = state.tgt_mask.device
    if compute_clusters:
        labels, n_clusters = cluster(state, shapes)
        if method == 'lagrangian':
            kw = dict(kw, labels_in=(labels, n_clusters))
    else:
        # cluster labels are observability, not needed for selection
        labels = torch.zeros((*lead, T), dtype=torch.int32, device=dev)
        n_clusters = torch.full(lead, -1, dtype=torch.int32, device=dev)
    fast = SelectionResult(sel=sel0.int(), feasible=feas0, obj=obj0,
                           bound=obj0, labels=labels, n_clusters=n_clusters,
                           lam=state.lam)
    if method == 'greedy':
        return fast

    def solve():
        res = solver[method](state, shapes, params, **kw)
        if method != 'lagrangian':
            res = res._replace(labels=labels, n_clusters=n_clusters)
        return res

    return sync.cond(feas0,
                     lambda: fast._replace(feasible=torch.ones_like(feas0)),
                     solve)

"""Auction assignment with exact maximum-cardinality completion
(counterpart of pymht_tpu/ops/assignment.py).

Same three stages and the same numerics: a single-phase Jacobi auction
under an iteration cap, a cost-aware greedy completion, then
alternating-path augmentation until no augmenting path exists (Berge),
so cardinality always equals the Hungarian oracle's and cost is within
n*eps on instances the auction resolves inside its cap.

Every loop keeps JAX's ``lax.while_loop`` semantics by reading its exit
condition on the host (``sync.flag``).  Each body is a function from
carry to carry, so a fixed-trip device loop can replace the host loop
without touching the arithmetic.
"""
from __future__ import annotations

import torch

from .. import sync

NEG = -1e9
INF = 1e9


def _auction_round(value, eps, carry):
    """One Jacobi bidding round: every unassigned row with a profitable
    column bids for its best column; each column goes to its highest
    bidder and displaces its previous owner."""
    price, owner, row_of = carry
    R, C = value.shape
    rows = torch.arange(R, device=value.device)
    cols = torch.arange(C, device=value.device)
    unassigned = row_of < 0
    net = value - price[None, :]
    best_col = net.argmax(dim=1)
    best_val = net.amax(dim=1)
    onehot_best = cols[None, :] == best_col[:, None]
    second_val = torch.clamp(
        torch.where(onehot_best, NEG, net).amax(dim=1), min=0.0)
    wants = unassigned & (best_val > 0.0)
    bid_price = price[best_col] + best_val - second_val + eps
    bid_matrix = torch.where(wants[:, None] & onehot_best,
                             bid_price[:, None], NEG)
    col_best_bid = bid_matrix.amax(dim=0)
    col_winner = bid_matrix.argmax(dim=0)
    col_has_bid = col_best_bid > NEG * 0.5
    displaced = col_has_bid & (owner >= 0)
    row_displaced = ((rows[:, None] == owner[None, :])
                     & displaced[None, :]).any(dim=1)
    win_matrix = (rows[:, None] == col_winner[None, :]) & col_has_bid[None, :]
    row_won = win_matrix.any(dim=1)
    row_new_col = win_matrix.int().argmax(dim=1)
    row_of = torch.where(row_won, row_new_col,
                         torch.where(row_displaced, -1, row_of))
    owner = torch.where(col_has_bid, col_winner, owner)
    price = torch.where(col_has_bid, col_best_bid, price)
    return price, owner, row_of


def _can_bid(value, carry):
    price, _, row_of = carry
    net = value - price[None, :]
    return ((row_of < 0) & (net.amax(dim=1) > 0.0)).any()


def _greedy_round(c, carry):
    """Unassigned rows claim their cheapest FREE valid column (no
    displacement); ties between rows go to the cheaper bid."""
    row_of, owner = carry
    R, C = c.shape
    rows = torch.arange(R, device=c.device)
    cols = torch.arange(C, device=c.device)
    cc = torch.where((owner >= 0)[None, :], INF, c)
    best_c = cc.argmin(dim=1)
    best_v = cc.amin(dim=1)
    wants = (row_of < 0) & (best_v < INF * 0.5)
    bid = torch.where(wants[:, None] & (cols[None, :] == best_c[:, None]),
                      c, INF)
    win_r = bid.argmin(dim=0)
    has = bid.amin(dim=0) < INF * 0.5
    win_matrix = (rows[:, None] == win_r[None, :]) & has[None, :]
    row_won = win_matrix.any(dim=1)
    row_of = torch.where(row_won, win_matrix.int().argmax(dim=1), row_of)
    owner = torch.where(has, win_r, owner)
    return row_of, owner


def _greedy_open(c, carry):
    row_of, owner = carry
    return ((~(owner >= 0))[None, :] & (c < INF * 0.5)
            & (row_of < 0)[:, None]).any()


def auction_assign(cost, valid, max_iters: int = 4000):
    """Min-cost bipartite matching with unassignment allowed.

    cost: [R, C] f32; valid: [R, C] bool (gated pairs).
    Returns row_to_col [R] int32 (-1 = unassigned)."""
    R, C = cost.shape
    dev = cost.device
    cmax = torch.where(valid, cost, 0.0).amax()
    cmin = torch.where(valid, cost, cmax).amin()
    span = torch.clamp(cmax - cmin, min=1.0)
    K = cmax + span * (R + 1)
    value = torch.where(valid, K - cost, NEG)
    n = max(R, C)
    eps = span / float(2.0 * (n + 1) * (n + 1))

    carry = (torch.zeros((C,), dtype=torch.float32, device=dev),
             torch.full((C,), -1, dtype=torch.int64, device=dev),
             torch.full((R,), -1, dtype=torch.int64, device=dev))
    it = 0
    while it < max_iters and sync.flag(_can_bid(value, carry)):
        carry = _auction_round(value, eps, carry)
        it += 1
    _, _, row_of = carry

    # Safety: never return an invalid pair (possible only at iteration
    # caps with pathological ties).
    rows = torch.arange(R, device=dev)
    ok = valid[rows, row_of.clamp(0, max(C - 1, 0))] & (row_of >= 0)
    row_of = torch.where(ok, row_of, -1)
    owner = torch.full((C + 1,), -1, dtype=torch.int64, device=dev)
    owner[torch.where(row_of >= 0, row_of, C)] = rows
    owner = owner[:C]

    c = torch.where(valid, cost, INF)
    carry = (row_of, owner)
    it = 0
    while it < R and sync.flag(_greedy_open(c, carry)):
        carry = _greedy_round(c, carry)
        it += 1
    row_of, owner = carry
    return _augment_to_max_cardinality(valid, row_of, owner).int()


def _bfs_layer(valid, owner, carry):
    """Expand the BFS frontier one (valid edge -> matched edge) layer."""
    vis_rows, vis_cols, col_parent, frontier = carry
    R = valid.shape[0]
    fv = frontier[:, None] & valid
    new_cols = fv.any(dim=0) & ~vis_cols
    col_parent = torch.where(new_cols, fv.int().argmax(dim=0), col_parent)
    vis_cols = vis_cols | new_cols
    rows = torch.arange(R, device=valid.device)
    nr = ((rows[:, None] == owner[None, :])
          & (new_cols & (owner >= 0))[None, :]).any(dim=1)
    new_rows = nr & ~vis_rows
    return vis_rows | new_rows, vis_cols, col_parent, new_rows


def _bfs(valid, row_of, owner, max_layers):
    """One BFS from every unassigned row.  Returns
    (found, free_col, col_parent)."""
    C = valid.shape[1]
    dev = valid.device
    vis_rows = row_of < 0
    carry = (vis_rows, torch.zeros((C,), dtype=torch.bool, device=dev),
             torch.full((C,), -1, dtype=torch.int64, device=dev), vis_rows)
    it = 0
    while it < max_layers:
        _, vis_cols, _, frontier = carry
        free_hit = (vis_cols & (owner < 0)).any()
        if not sync.flag(~free_hit & frontier.any()):
            break
        carry = _bfs_layer(valid, owner, carry)
        it += 1
    _, vis_cols, col_parent, _ = carry
    free_cols = vis_cols & (owner < 0)
    return free_cols.any(), free_cols.int().argmax(), col_parent


def _flip(row_of, owner, end_col, col_parent):
    """Flip the augmenting path ending at free column ``end_col``."""
    row_of, owner = row_of.clone(), owner.clone()
    c = end_col
    while sync.flag(c >= 0):
        r = col_parent[c]
        c_prev = row_of[r]           # -1 once r is a source row
        row_of[r] = c
        owner[c] = r
        c = c_prev
    return row_of, owner


def _augment_to_max_cardinality(valid, row_of, owner):
    """Alternating-path augmentation to exact maximum cardinality: BFS
    from all unassigned rows, flip one augmenting path per round, until
    no augmenting path exists."""
    R, C = valid.shape
    max_layers = min(R, C) + 1
    while True:
        found, end_col, col_parent = _bfs(valid, row_of, owner, max_layers)
        if not sync.flag(found):
            return row_of
        row_of, owner = _flip(row_of, owner, end_col, col_parent)

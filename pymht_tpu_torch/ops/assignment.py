"""Auction assignment with exact maximum-cardinality completion
(counterpart of pymht_tpu/ops/assignment.py).

Same three stages and the same numerics: a single-phase Jacobi auction
under an iteration cap, a cost-aware greedy completion, then
alternating-path augmentation until no augmenting path exists (Berge),
so cardinality always equals the Hungarian oracle's and cost is within
n*eps on instances the auction resolves inside its cap.

Every loop keeps JAX's ``lax.while_loop`` semantics through
``sync.while_loop``: its exit is read on the host eagerly, and tested on
the device in a captured graph.  Each body is a function from carry to
carry that makes the same operations every time it runs and reads no
value on the host.  Cost matrices may carry leading
scenario axes ([..., R, C]): each scenario's loops then run as under
``jax.vmap``, a scenario that is done waiting unchanged for the others.
"""
from __future__ import annotations

import torch

from .. import sync
from ..batch import lead_index

NEG = -1e9
INF = 1e9


def _auction_round(value, eps, carry):
    """One Jacobi bidding round: every unassigned row with a profitable
    column bids for its best column; each column goes to its highest
    bidder and displaces its previous owner."""
    price, owner, row_of = carry
    R, C = value.shape[-2:]
    rows = torch.arange(R, device=value.device)
    cols = torch.arange(C, device=value.device)
    unassigned = row_of < 0
    net = value - price[..., None, :]
    best_col = net.argmax(dim=-1)
    best_val = net.amax(dim=-1)
    onehot_best = cols == best_col[..., None]
    second_val = torch.clamp(
        torch.where(onehot_best, NEG, net).amax(dim=-1), min=0.0)
    wants = unassigned & (best_val > 0.0)
    bi = lead_index(value.shape[:-2], value.device, extra=1)
    bid_price = price[(*bi, best_col)] + best_val - second_val + eps
    bid_matrix = torch.where(wants[..., None] & onehot_best,
                             bid_price[..., None], NEG)
    col_best_bid = bid_matrix.amax(dim=-2)
    col_winner = bid_matrix.argmax(dim=-2)
    col_has_bid = col_best_bid > NEG * 0.5
    displaced = col_has_bid & (owner >= 0)
    row_displaced = ((rows[:, None] == owner[..., None, :])
                     & displaced[..., None, :]).any(dim=-1)
    win_matrix = ((rows[:, None] == col_winner[..., None, :])
                  & col_has_bid[..., None, :])
    row_won = win_matrix.any(dim=-1)
    row_new_col = win_matrix.int().argmax(dim=-1)
    row_of = torch.where(row_won, row_new_col,
                         torch.where(row_displaced, -1, row_of))
    owner = torch.where(col_has_bid, col_winner, owner)
    price = torch.where(col_has_bid, col_best_bid, price)
    return price, owner, row_of


def _can_bid(value, carry):
    price, _, row_of = carry
    net = value - price[..., None, :]
    return ((row_of < 0) & (net.amax(dim=-1) > 0.0)).any(dim=-1)


def _greedy_round(c, carry):
    """Unassigned rows claim their cheapest FREE valid column (no
    displacement); ties between rows go to the cheaper bid."""
    row_of, owner = carry
    R, C = c.shape[-2:]
    rows = torch.arange(R, device=c.device)
    cols = torch.arange(C, device=c.device)
    cc = torch.where((owner >= 0)[..., None, :], INF, c)
    best_c = cc.argmin(dim=-1)
    best_v = cc.amin(dim=-1)
    wants = (row_of < 0) & (best_v < INF * 0.5)
    bid = torch.where(wants[..., None] & (cols == best_c[..., None]),
                      c, INF)
    win_r = bid.argmin(dim=-2)
    has = bid.amin(dim=-2) < INF * 0.5
    win_matrix = (rows[:, None] == win_r[..., None, :]) & has[..., None, :]
    row_won = win_matrix.any(dim=-1)
    row_of = torch.where(row_won, win_matrix.int().argmax(dim=-1), row_of)
    owner = torch.where(has, win_r, owner)
    return row_of, owner


def _greedy_open(c, carry):
    row_of, owner = carry
    return ((~(owner >= 0))[..., None, :] & (c < INF * 0.5)
            & (row_of < 0)[..., None]).flatten(-2).any(dim=-1)


def auction_assign(cost, valid, max_iters: int = 4000):
    """Min-cost bipartite matching with unassignment allowed.

    cost: [..., R, C] f32; valid: [..., R, C] bool (gated pairs).
    Returns row_to_col [..., R] int32 (-1 = unassigned)."""
    R, C = cost.shape[-2:]
    lead = cost.shape[:-2]
    dev = cost.device
    cmax = torch.where(valid, cost, 0.0).flatten(-2).amax(dim=-1)
    cmin = torch.where(valid, cost, cmax[..., None, None]) \
        .flatten(-2).amin(dim=-1)
    span = torch.clamp(cmax - cmin, min=1.0)
    K = cmax + span * (R + 1)
    value = torch.where(valid, K[..., None, None] - cost, NEG)
    n = max(R, C)
    eps = span / float(2.0 * (n + 1) * (n + 1))

    carry = (torch.zeros((*lead, C), dtype=torch.float32, device=dev),
             torch.full((*lead, C), -1, dtype=torch.int64, device=dev),
             torch.full((*lead, R), -1, dtype=torch.int64, device=dev))
    _, _, row_of = sync.while_loop(
        lambda c: _can_bid(value, c),
        lambda c, _: _auction_round(value, eps[..., None], c), carry,
        max_iters=max_iters)

    # Safety: never return an invalid pair (possible only at iteration
    # caps with pathological ties).
    rows = torch.arange(R, device=dev)
    bi = lead_index(lead, dev, extra=1)
    ok = valid[(*bi, rows, row_of.clamp(0, max(C - 1, 0)))] & (row_of >= 0)
    row_of = torch.where(ok, row_of, -1)
    owner = torch.full((*lead, C + 1), -1, dtype=torch.int64, device=dev)
    owner[(*bi, torch.where(row_of >= 0, row_of, C))] = rows
    owner = owner[..., :C]

    c = torch.where(valid, cost, INF)
    row_of, owner = sync.while_loop(
        lambda cr: _greedy_open(c, cr),
        lambda cr, _: _greedy_round(c, cr), (row_of, owner), max_iters=R)
    return _augment_to_max_cardinality(valid, row_of, owner).int()


def _bfs_layer(valid, owner, carry):
    """Expand the BFS frontier one (valid edge -> matched edge) layer."""
    vis_rows, vis_cols, col_parent, frontier = carry
    R = valid.shape[-2]
    fv = frontier[..., None] & valid
    new_cols = fv.any(dim=-2) & ~vis_cols
    col_parent = torch.where(new_cols, fv.int().argmax(dim=-2), col_parent)
    vis_cols = vis_cols | new_cols
    rows = torch.arange(R, device=valid.device)
    nr = ((rows[:, None] == owner[..., None, :])
          & (new_cols & (owner >= 0))[..., None, :]).any(dim=-1)
    new_rows = nr & ~vis_rows
    return vis_rows | new_rows, vis_cols, col_parent, new_rows


def _bfs(valid, row_of, owner, max_layers, active=None):
    """One BFS from every unassigned row (of the ``active`` scenarios).
    Returns (found, free_col, col_parent)."""
    C = valid.shape[-1]
    lead = valid.shape[:-2]
    dev = valid.device
    vis_rows = row_of < 0
    carry = (vis_rows, torch.zeros((*lead, C), dtype=torch.bool, device=dev),
             torch.full((*lead, C), -1, dtype=torch.int64, device=dev),
             vis_rows)

    def go_on(carry):
        _, vis_cols, _, frontier = carry
        free_hit = (vis_cols & (owner < 0)).any(dim=-1)
        p = ~free_hit & frontier.any(dim=-1)
        return p if active is None else p & active

    _, vis_cols, col_parent, _ = sync.while_loop(
        go_on, lambda c, _: _bfs_layer(valid, owner, c), carry,
        max_iters=max_layers)
    free_cols = vis_cols & (owner < 0)
    return free_cols.any(dim=-1), free_cols.int().argmax(dim=-1), col_parent


def _flip(row_of, owner, end_col, col_parent, active=None):
    """Flip the augmenting path ending at free column ``end_col`` (in the
    ``active`` scenarios).  The path's reads and writes are gathers and
    scatters of one element per scenario (an index that is a 0-d tensor
    would be read on the host); an index of -1, in a scenario that is
    done, wraps as Python indexing does and rewrites what is there."""
    R, C = row_of.shape[-1], col_parent.shape[-1]

    def step(carry, running):
        row_of, owner, c = carry
        ci = (c % C)[..., None]
        r = col_parent.gather(-1, ci)
        ri = r % R
        c_prev = row_of.gather(-1, ri)   # -1 once r is a source row
        if running is None:
            row_of.scatter_(-1, ri, c[..., None])
            owner.scatter_(-1, ci, r)
        else:                            # scenarios that are done keep theirs
            run = running[..., None]
            row_of.scatter_(-1, ri, torch.where(run, c[..., None], c_prev))
            owner.scatter_(-1, ci, torch.where(run, r, owner.gather(-1, ci)))
        return row_of, owner, c_prev[..., 0]

    def go_on(carry):
        p = carry[2] >= 0
        return p if active is None else p & active

    row_of, owner, _ = sync.while_loop(
        go_on, step, (row_of.clone(), owner.clone(), end_col))
    return row_of, owner


def _augment_to_max_cardinality(valid, row_of, owner):
    """Alternating-path augmentation to exact maximum cardinality: BFS
    from all unassigned rows, flip one augmenting path per round, until
    no augmenting path exists."""
    R, C = valid.shape[-2:]
    max_layers = min(R, C) + 1

    def round_(carry, active):
        row_of, owner, _, end_col, col_parent = carry
        row_of, owner = _flip(row_of, owner, end_col, col_parent, active)
        return (row_of, owner, *_bfs(valid, row_of, owner, max_layers,
                                     active))

    carry = (row_of, owner, *_bfs(valid, row_of, owner, max_layers))
    return sync.while_loop(lambda c: c[2], round_, carry)[0]

"""Track lifecycle: N-scan pruning and termination (counterpart of
pymht_tpu/core/lifecycle.py).

N-scan pruning: after selection the window root advances so at most N
scans of branching remain; leaves that disagree with the selected leaf
on the confirmed columns die, those columns are blanked, and their
labels are emitted as the newly confirmed track segment.

Termination: a selected track dies when it leaves radar range, its
windowed score rate exceeds the limit, or its cumulative NLLR exceeds
the hard limit.

Both take a state with leading scenario axes too.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..batch import lead_index
from .config import TrackerShapes, TrackerParams
from .state import TrackerState


class PruneOutputs(NamedTuple):
    state: TrackerState
    confirmed_mask: torch.Tensor   # [T, W] bool
    confirmed_x: torch.Tensor      # [T, W, 4] f32
    confirmed_meas: torch.Tensor   # [T, W] i32
    confirmed_ais: torch.Tensor    # [T, W] i32
    confirmed_mmsi: torch.Tensor   # [T, W] i32
    confirmed_cnllr: torch.Tensor  # [T, W] f32


def n_scan_prune(state: TrackerState, shapes: TrackerShapes,
                 params: TrackerParams) -> PruneOutputs:
    *lead, T, L, W = state.hist_meas.shape
    dev = state.hist_meas.device
    sel = state.sel_leaf.long()
    ix = lead_index((*lead, T), dev)

    depth = state.tgt_depth
    ncut = torch.clamp(depth - state.tgt_window, min=0)             # [T]
    w_ids = torch.arange(W, device=dev)[None, :]
    col_valid = w_ids >= (W - depth)[..., None]
    col_cut = col_valid & (w_ids < (W - depth + ncut)[..., None])    # [T, W]

    sel_meas = state.hist_meas[(*ix, sel)]                           # [T, W]
    sel_ais = state.hist_ais[(*ix, sel)]
    sel_mmsi = state.hist_mmsi[(*ix, sel)]
    sel_cnllr = state.hist_cnllr[(*ix, sel)]
    sel_x = state.hist_x[(*ix, sel)]                               # [T, W, 4]

    # A leaf survives iff it matches the selected leaf's labels on every
    # confirmed column (it descends from the new root).
    agree = ((state.hist_meas == sel_meas[..., None, :])
             & (state.hist_ais == sel_ais[..., None, :])
             & (state.hist_mmsi == sel_mmsi[..., None, :]))
    keep = (agree | ~col_cut[..., None, :]).all(dim=-1)

    last_cut = (W - depth + ncut - 1).long().clamp(0, W - 1)
    new_root_cnllr = torch.where(ncut > 0, sel_cnllr[(*ix, last_cut)],
                                 state.tgt_root_cnllr)
    cut_mmsi = torch.where(col_cut, sel_mmsi, 0)
    new_tgt_mmsi = torch.maximum(state.tgt_mmsi, cut_mmsi.amax(dim=-1))

    cut3 = col_cut[..., None, :]
    new_state = state.replace(
        leaf_mask=state.leaf_mask & keep,
        hist_meas=torch.where(cut3, -1, state.hist_meas),
        hist_ais=torch.where(cut3, 0, state.hist_ais),
        hist_mmsi=torch.where(cut3, 0, state.hist_mmsi),
        hist_cnllr=torch.where(cut3, 0.0, state.hist_cnllr),
        hist_x=torch.where(cut3[..., None], 0.0, state.hist_x),
        tgt_depth=depth - ncut,
        tgt_root_cnllr=new_root_cnllr,
        tgt_mmsi=new_tgt_mmsi,
    )
    return PruneOutputs(
        state=new_state,
        confirmed_mask=col_cut & state.tgt_mask[..., None],
        confirmed_x=sel_x, confirmed_meas=sel_meas, confirmed_ais=sel_ais,
        confirmed_mmsi=sel_mmsi, confirmed_cnllr=sel_cnllr)


class TerminateOutputs(NamedTuple):
    state: TrackerState
    dead: torch.Tensor     # [T] bool — terminated this scan
    reason: torch.Tensor   # [T] i32 — 0 alive, 1 range, 2 score, 3 cnllr


def terminate(state: TrackerState, shapes: TrackerShapes,
              params: TrackerParams) -> TerminateOutputs:
    dev = state.tgt_mask.device
    ix = lead_index(state.tgt_mask.shape, dev)
    sel = state.sel_leaf.long()
    sel_x = state.leaf_x[(*ix, sel)]
    sel_cnllr = state.leaf_cnllr[(*ix, sel)]

    rng = params.radar_range
    if math.isfinite(rng):
        dx = sel_x[..., 0] - float(params.position[0])
        dy = sel_x[..., 1] - float(params.position[1])
        out_of_range = torch.sqrt(dx * dx + dy * dy) > rng
    else:
        out_of_range = torch.zeros(state.tgt_mask.shape, dtype=torch.bool,
                                   device=dev)

    score = (sel_cnllr - state.tgt_root_cnllr) / (params.N + 1)
    bad_score = score > params.score_upper_limit
    bad_cnllr = sel_cnllr > params.cnllr_upper_limit
    dead = state.tgt_mask & (out_of_range | bad_score | bad_cnllr)
    reason = torch.where(out_of_range, 1,
                         torch.where(bad_score, 2,
                                     torch.where(bad_cnllr, 3, 0)))
    reason = torch.where(dead, reason, 0).int()
    new_state = state.replace(
        tgt_mask=state.tgt_mask & ~dead,
        leaf_mask=state.leaf_mask & ~dead[..., None],
        tgt_id=torch.where(dead, -1, state.tgt_id),
    )
    return TerminateOutputs(state=new_state, dead=dead, reason=reason)

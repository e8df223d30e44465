"""Hypothesis-forest growth, radar branch (counterpart of
pymht_tpu/core/grow.py:grow with ``ais=None``).

Predict every leaf of every target, gate and score it against every
measurement (K1, ops/gate_kernel.py, which also returns the radar
update's gain and covariance per leaf and the gate's reductions), keep
the best L candidates per target, force the feasibility spine into the
beam, gather the parents and roll the label history by one scan.

Candidate layout per leaf: slot 0 is the zero hypothesis (missed
detection), slot 1 + m is radar measurement m.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.constants import sigmaQ_tracker, sigmaR_RADAR_tracker
from ..ops.gate_kernel import BIG, radar_candidates
from .config import TrackerShapes, TrackerParams
from .state import TrackerState


class Scan(NamedTuple):
    """One radar scan, padded to M measurements."""
    z: torch.Tensor        # [M, 2] f32
    mask: torch.Tensor     # [M] bool
    time: torch.Tensor     # [] f32


class GrowOutputs(NamedTuple):
    state: TrackerState
    used_meas: torch.Tensor     # [M] bool — gated by any live leaf
    gated_counts: torch.Tensor  # [T] i32 — gated (leaf, meas) pairs


def smallest_k(x: torch.Tensor, k: int):
    """The k smallest entries along the last axis, ascending, ties broken
    by lower index first — the order of ``jax.lax.top_k(-x, k)`` (a
    stable sort; ``torch.topk`` makes no promise about ties)."""
    vals, idx = torch.sort(x, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def grow(state: TrackerState, scan: Scan, ais, shapes: TrackerShapes,
         params: TrackerParams) -> GrowOutputs:
    """Advance every target's hypothesis forest by one scan (radar only)."""
    if ais is not None:
        raise NotImplementedError("grow: the AIS branch is not ported yet")
    if shapes.radar_cand_width > 0:
        raise NotImplementedError("grow: the spatial pre-gate "
                                  "(radar_cand_width > 0) is not ported yet")
    T, L, W = state.hist_meas.shape
    M = shapes.max_meas
    dev = state.leaf_x.device

    # --- K1: predict + gate + score every (leaf, measurement) pair ----
    pd_leaf = state.tgt_pd[:, None].expand(T, L)
    cand = radar_candidates(
        state.leaf_x.reshape(T * L, 4),
        state.leaf_P.reshape(T * L, 4, 4),
        state.leaf_cnllr.reshape(T * L),
        pd_leaf.reshape(T * L),
        state.leaf_mask.reshape(T * L),
        scan.z, scan.mask,
        scan.time - state.time, sigmaQ_tracker,
        float(sigmaR_RADAR_tracker) ** 2,
        params.eta2, params.lambda_ex)
    Cn = 1 + M
    cand_scores = cand.scores.reshape(T, L, Cn)
    x_bar = cand.x_bar.reshape(T, L, 4)
    P_bar = cand.P_bar.reshape(T, L, 4, 4)
    K = cand.K.reshape(T, L, 4, 2)
    P_hat = cand.P_hat.reshape(T, L, 4, 4)
    zero_score = cand_scores[:, :, 0]                              # [T,L]

    # --- beam: the best L candidates per target -----------------------
    top_scores, top_idx = smallest_k(cand_scores.reshape(T, L * Cn), L)

    # Feasibility spine: force the zero-hypothesis child of the
    # previously selected leaf into the beam, so the previous selection
    # plus a missed detection is always a feasible global assignment.
    tb = torch.arange(T, device=dev)
    zero_parent = state.sel_leaf.long().clamp(0, L - 1)
    has_zero = state.leaf_mask[tb, zero_parent]
    zcand = zero_parent * Cn
    hit = top_idx == zcand[:, None]
    beam_pos = hit.int().argmax(dim=1)
    force = has_zero & ~hit.any(dim=1)
    top_idx = top_idx.clone()
    top_scores = top_scores.clone()
    top_idx[:, L - 1] = torch.where(force, zcand, top_idx[:, L - 1])
    top_scores[:, L - 1] = torch.where(force, zero_score[tb, zero_parent],
                                       top_scores[:, L - 1])
    spine_leaf = torch.where(has_zero,
                             torch.where(force, L - 1, beam_pos), 0)

    new_mask = top_scores < BIG * 0.5
    parent = top_idx // Cn                                         # [T,L]
    slot = top_idx % Cn
    is_zero = slot == 0
    radar_m = (slot - 1).clamp(0, M - 1)

    # --- gather the parents' payloads, apply the radar update ---------
    tp = (tb[:, None], parent)
    x_bar_p, P_bar_p = x_bar[tp], P_bar[tp]
    K_p, P_radar = K[tp], P_hat[tp]
    zt_p = scan.z[radar_m] - x_bar_p[..., :2]                      # [T,L,2]
    x_radar = x_bar_p + torch.einsum('tlij,tlj->tli', K_p, zt_p)
    new_x = torch.where(is_zero[..., None], x_bar_p, x_radar)
    new_P = torch.where(is_zero[..., None, None], P_bar_p, P_radar)
    new_meas_label = torch.where(is_zero, 0, radar_m + 1)
    new_meas_label = torch.where(new_mask, new_meas_label, -1).int()
    zeros_tl = torch.zeros((T, L), dtype=torch.int32, device=dev)

    # --- roll the history one column left, write the new column ------
    keep3 = new_mask[:, :, None]

    def shift_append(hist, col, fill):
        rolled = torch.cat([hist[tp][:, :, 1:], col[:, :, None]], dim=2)
        return torch.where(keep3, rolled, fill)

    hx = torch.cat([state.hist_x[tp][:, :, 1:], new_x[:, :, None]], dim=2)

    # Roll the warm-started selection duals with the window: prices of
    # the oldest scan's slots retire, the new scan's start at 0.
    per_col = M + shapes.max_ais
    lam = torch.roll(state.lam.reshape(W, per_col), -1, dims=0)
    lam[-1] = 0.0

    new_state = state.replace(
        lam=lam.reshape(-1),
        spine_leaf=spine_leaf.int(),
        leaf_x=torch.where(new_mask[..., None], new_x, 0.0),
        leaf_P=torch.where(new_mask[..., None, None], new_P, 0.0),
        leaf_cnllr=torch.where(new_mask, top_scores, 0.0),
        leaf_mask=new_mask & state.tgt_mask[:, None],
        hist_meas=shift_append(state.hist_meas, new_meas_label, -1),
        hist_ais=shift_append(state.hist_ais, zeros_tl, 0),
        hist_mmsi=shift_append(state.hist_mmsi, zeros_tl, 0),
        hist_cnllr=shift_append(state.hist_cnllr, top_scores, 0.0),
        hist_x=torch.where(new_mask[:, :, None, None], hx, 0.0),
        tgt_depth=torch.where(state.tgt_mask,
                              torch.clamp(state.tgt_depth + 1, max=W),
                              state.tgt_depth),
        scan_idx=state.scan_idx + 1,
        time=scan.time,
    )
    gated_counts = cand.gated_counts.view(T, L).sum(
        dim=1, dtype=torch.int32)                                  # [T]
    return GrowOutputs(state=new_state, used_meas=cand.used_meas,
                       gated_counts=gated_counts)

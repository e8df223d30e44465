"""Hypothesis-forest growth (counterpart of pymht_tpu/core/grow.py:grow).

Predict every leaf of every target, gate and score it against every
measurement (K1, ops/gate_kernel.py, which also returns the radar
update's gain and covariance per leaf and the gate's reductions) and,
with an ``AisBatch``, against the AIS messages fused with the radar
measurements (ops/ais_fused.py); keep the best L candidates per target,
force the feasibility spine into the beam, gather the parents and roll
the label history by one scan.

Candidate layout per leaf (C = 1 + M + G (1 + M) slots; G =
``shapes.ais_fuse_width``, the best G stage-1-gated messages per leaf,
mapped back to message indices through ``ais_idx``):

* slot 0                       : zero hypothesis (missed detection)
* slot 1 + m                   : radar measurement m
* slot 1 + M + g (1 + M)       : pure-AIS association with compressed slot g
* slot 1 + M + g (1 + M) + 1+m : slot g fused with radar measurement m

With the spatial pre-gate (``shapes.radar_cand_width`` = Km, 0 < Km < M)
every target's candidates run over its Km nearest measurements only (by
distance to the selected leaf's prediction): M above becomes Km, K1 takes
the per-target ``z_sub [T, Km, 2]``, and compressed indices map back to
scan indices through ``zidx`` after the beam.

Every branch also takes a batch of scenarios: leading axes B on the
state, the scan (``z [B, M, 2]``, ``time [B]``) and the AIS batch
(``[B, A, ...]``).  K1 then runs once for the whole batch through its
per-target entry point: without the pre-gate one "target" per scenario
(its T * L leaves against its own scan and time step), with it one per
(scenario, target), B * T targets of L leaves, whose Km columns index the
flat [B * M] measurement axis.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..batch import lead_index
from ..models.constants import sigmaQ_tracker, sigmaR_RADAR_tracker
from ..ops.ais_fused import ais_candidates
from ..ops.gate_kernel import BIG, radar_candidates
from ..ops.topk import smallest_k
from .config import TrackerShapes, TrackerParams
from .state import TrackerState


class Scan(NamedTuple):
    """One radar scan, padded to M measurements."""
    z: torch.Tensor        # [M, 2] f32
    mask: torch.Tensor     # [M] bool
    time: torch.Tensor     # [] f32


class AisBatch(NamedTuple):
    """AIS messages received since the previous scan, padded to A."""
    state: torch.Tensor    # [A, 4] f32
    time: torch.Tensor     # [A] f32
    mmsi: torch.Tensor     # [A] i32
    high_accuracy: torch.Tensor  # [A] bool
    mask: torch.Tensor     # [A] bool


def empty_ais(shapes: TrackerShapes, device) -> AisBatch:
    A = shapes.max_ais

    def z(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    return AisBatch(state=z((A, 4), torch.float32),
                    time=z((A,), torch.float32), mmsi=z((A,), torch.int32),
                    high_accuracy=z((A,), torch.bool),
                    mask=z((A,), torch.bool))


class GrowOutputs(NamedTuple):
    state: TrackerState
    used_meas: torch.Tensor     # [M] bool — gated by any live leaf
    gated_counts: torch.Tensor  # [T] i32 — gated (leaf, meas) pairs


def grow(state: TrackerState, scan: Scan, ais: Optional[AisBatch],
         shapes: TrackerShapes, params: TrackerParams,
         n_targets_global=None) -> GrowOutputs:
    """Advance every target's hypothesis forest by one scan.  ``ais`` is
    an AisBatch, or None for the radar-only branch.
    ``n_targets_global``: the live-target count of the whole forest for
    the AIS association density, where ``state`` holds only this rank's
    share of the targets (parallel/sharded_tracker.py); None counts
    ``state``'s own."""
    if ais is not None and not isinstance(ais, AisBatch):
        raise TypeError(f"grow: ais must be an AisBatch or None, got "
                        f"{type(ais).__name__}")
    *lead, T, L, W = state.hist_meas.shape
    lead = tuple(lead)
    M = shapes.max_meas
    dev = state.leaf_x.device
    ix1 = lead_index(lead + (T,), dev, extra=1)
    ix = tuple(a[..., 0] for a in ix1)                 # (tb,) unbatched
    dt = scan.time - state.time

    # --- spatial pre-gate: each target's Km nearest measurements ------
    Km = shapes.radar_cand_width
    pregate = 0 < Km < M
    bi2 = lead_index(lead, dev, extra=2)      # [..., T, k] picks of [..., M]
    sub = {}
    z_sub = zmask_sub = zidx = None
    z_k1, zmask_k1, dt_k1 = scan.z, scan.mask, dt
    if lead:         # the scenarios' scans on one flat [B*M] axis
        nb = math.prod(lead)
        z_k1 = scan.z.reshape(nb * M, 2).contiguous()
        zmask_k1 = scan.mask.reshape(nb * M).contiguous()
        if not pregate:      # one K1 "target" per scenario
            sub = dict(z_sub=z_k1.view(nb, M, 2),
                       zmask_sub=zmask_k1.view(nb, M),
                       zidx=torch.arange(nb * M, dtype=torch.int32,
                                         device=dev).view(nb, M),
                       leaves_per_target=T * L)
            dt_k1 = dt.reshape(nb).contiguous()
    if pregate:
        xr = state.leaf_x[(*ix, state.sel_leaf.long().clamp(0, L - 1))]
        px = xr[..., 0] + dt[..., None] * xr[..., 2]               # [T]
        py = xr[..., 1] + dt[..., None] * xr[..., 3]
        d2 = ((scan.z[..., None, :, 0] - px[..., None]) ** 2
              + (scan.z[..., None, :, 1] - py[..., None]) ** 2)    # [T,M]
        d2 = torch.where(scan.mask[..., None, :], d2, torch.inf)
        dvals, zidx = smallest_k(d2, Km)                           # [T,Km]
        z_sub = scan.z[(*bi2, zidx)]                               # [T,Km,2]
        zmask_sub = scan.mask[(*bi2, zidx)] & torch.isfinite(dvals)
        if lead:     # B * T targets; columns on the flat [B*M] axis
            off = torch.arange(0, nb * M, M, device=dev).view(
                *lead, 1, 1)
            sub = dict(z_sub=z_sub.reshape(nb * T, Km, 2),
                       zmask_sub=zmask_sub.reshape(nb * T, Km),
                       zidx=(zidx + off).int().reshape(nb * T, Km),
                       leaves_per_target=L)
            dt_k1 = dt.reshape(nb, 1).expand(nb, T).reshape(nb * T)
        else:
            sub = dict(z_sub=z_sub, zmask_sub=zmask_sub, zidx=zidx.int(),
                       leaves_per_target=L)
    M_eff = Km if pregate else M

    # --- K1: predict + gate + score every (leaf, measurement) pair ----
    N = math.prod(lead) * T * L
    pd_leaf = state.tgt_pd[..., None].expand(*lead, T, L)
    cand = radar_candidates(
        state.leaf_x.reshape(N, 4),
        state.leaf_P.reshape(N, 4, 4),
        state.leaf_cnllr.reshape(N),
        pd_leaf.reshape(N),
        state.leaf_mask.reshape(N),
        z_k1, zmask_k1, dt_k1, sigmaQ_tracker,
        float(sigmaR_RADAR_tracker) ** 2,
        params.eta2, params.lambda_ex, **sub)
    Cn_r = 1 + M_eff
    cand_scores = cand.scores.reshape(*lead, T, L, Cn_r)
    x_bar = cand.x_bar.reshape(*lead, T, L, 4)
    P_bar = cand.P_bar.reshape(*lead, T, L, 4, 4)
    K = cand.K.reshape(*lead, T, L, 4, 2)
    P_hat = cand.P_hat.reshape(*lead, T, L, 4, 4)
    zero_score = cand_scores[..., 0]                               # [T,L]

    # --- beam: the best L candidates per target -----------------------
    top_scores, top_idx = smallest_k(
        cand_scores.reshape(*lead, T, L * Cn_r), L)
    Cn = Cn_r
    if ais is not None:
        G = min(shapes.ais_fuse_width, shapes.max_ais)
        (g_ok, gate2, pure_gate, nllr1g, fused_score, x_bar2, z_hat2, K2g,
         P_ais_hat, ais_idx) = ais_candidates(
            state, scan, ais, params, G, n_targets=n_targets_global,
            prefilter=shapes.ais_prefilter_width, z_sub=z_sub,
            zmask_sub=zmask_sub)
        cn = state.leaf_cnllr[..., None]
        pure_score = torch.where(pure_gate, cn + nllr1g, BIG)      # [T,L,G]
        fused = torch.where(gate2, cn[..., None] + fused_score, BIG)
        ais_block = torch.cat([pure_score[..., None], fused], dim=-1)
        W_a = G * Cn_r
        Cn = Cn_r + W_a
        # Block-wise exact merge: the top L of [radar | ais] is the top L
        # of (top L of radar ++ top L of ais); radar first, so ties fall
        # as in the JAX package.  Indices go to the per-leaf slot layout
        # of the module docstring.
        glob_r = (top_idx // Cn_r) * Cn + top_idx % Cn_r
        score_a, idx_a = smallest_k(ais_block.reshape(*lead, T, L * W_a), L)
        glob_a = (idx_a // W_a) * Cn + Cn_r + idx_a % W_a
        top_scores, pos = smallest_k(
            torch.cat([top_scores, score_a], dim=-1), L)           # [T,2L]
        top_idx = torch.gather(torch.cat([glob_r, glob_a], dim=-1), -1,
                               pos)

    # Feasibility spine: force the zero-hypothesis child of the
    # previously selected leaf into the beam, so the previous selection
    # plus a missed detection is always a feasible global assignment.
    zero_parent = state.sel_leaf.long().clamp(0, L - 1)
    has_zero = state.leaf_mask[(*ix, zero_parent)]
    zcand = zero_parent * Cn
    hit = top_idx == zcand[..., None]
    beam_pos = hit.int().argmax(dim=-1)
    force = has_zero & ~hit.any(dim=-1)
    top_idx = top_idx.clone()
    top_scores = top_scores.clone()
    top_idx[..., L - 1] = torch.where(force, zcand, top_idx[..., L - 1])
    top_scores[..., L - 1] = torch.where(
        force, zero_score[(*ix, zero_parent)], top_scores[..., L - 1])
    spine_leaf = torch.where(has_zero,
                             torch.where(force, L - 1, beam_pos), 0)

    new_mask = top_scores < BIG * 0.5
    parent = top_idx // Cn                                         # [T,L]
    slot = top_idx % Cn
    is_zero = slot == 0
    radar_m = (slot - 1).clamp(0, M_eff - 1)
    if ais is not None:
        ais_slot = (slot - Cn_r).clamp(0, W_a - 1)
        is_ais = slot >= Cn_r
        ais_g = ais_slot // Cn_r                                   # [T,L]
        ais_sub = ais_slot % Cn_r                          # 0 pure, 1+m fused
        is_pure_ais = is_ais & (ais_sub == 0)
        ais_m = (ais_sub - 1).clamp(0, M_eff - 1)
    if pregate:      # compressed columns back to scan indices
        radar_m = torch.gather(zidx, -1, radar_m)
        if ais is not None:
            ais_m = torch.gather(zidx, -1, ais_m)

    # --- gather the parents' payloads, apply the radar update ---------
    tp = (*ix1, parent)
    x_bar_p, P_bar_p = x_bar[tp], P_bar[tp]
    K_p, P_radar = K[tp], P_hat[tp]
    zt_p = scan.z[(*bi2, radar_m)] - x_bar_p[..., :2]              # [T,L,2]
    x_radar = x_bar_p + torch.einsum('...ij,...j->...i', K_p, zt_p)
    new_x = torch.where(is_zero[..., None], x_bar_p, x_radar)
    new_P = torch.where(is_zero[..., None, None], P_bar_p, P_radar)
    new_meas_label = torch.where(is_zero, 0, radar_m + 1)
    new_ais_label = torch.zeros((*lead, T, L), dtype=torch.int32, device=dev)
    new_mmsi_label = new_ais_label

    if ais is not None:
        # the selected fused and pure-AIS states, from the compressed
        # stage-2 ingredients ([T,L] gathers; integer channels stay
        # integers)
        tpg = (*ix1, parent, ais_g)
        x_p = x_bar2[tpg]
        zt_f = scan.z[(*bi2, ais_m)] - z_hat2[tpg]
        x_f = x_p + torch.einsum('...ij,...j->...i', K2g[tpg], zt_f)
        ais_a = ais_idx[tpg]                        # message index, [T,L]
        new_x = torch.where(is_ais[..., None],
                            torch.where(is_pure_ais[..., None], x_p, x_f),
                            new_x)
        new_P = torch.where(is_ais[..., None, None], P_ais_hat[tpg], new_P)
        new_meas_label = torch.where(
            is_ais, torch.where(is_pure_ais, 0, ais_m + 1), new_meas_label)
        new_ais_label = torch.where(is_ais, ais_a + 1, 0).int()
        new_mmsi_label = torch.where(is_ais, ais.mmsi[(*bi2, ais_a)],
                                     0).int()

    new_meas_label = torch.where(new_mask, new_meas_label, -1).int()

    # --- roll the history one column left, write the new column ------
    keep3 = new_mask[..., None]

    def shift_append(hist, col, fill):
        rolled = torch.cat([hist[tp][..., 1:], col[..., None]], dim=-1)
        return torch.where(keep3, rolled, fill)

    hx = torch.cat([state.hist_x[tp][..., 1:, :], new_x[..., None, :]],
                   dim=-2)

    # Roll the warm-started selection duals with the window: prices of
    # the oldest scan's slots retire, the new scan's start at 0.
    per_col = M + shapes.max_ais
    lam = torch.roll(state.lam.reshape(*lead, W, per_col), -1, dims=-2)
    lam[..., -1, :] = 0.0

    new_state = state.replace(
        lam=lam.reshape(*lead, -1),
        spine_leaf=spine_leaf.int(),
        leaf_x=torch.where(new_mask[..., None], new_x, 0.0),
        leaf_P=torch.where(new_mask[..., None, None], new_P, 0.0),
        leaf_cnllr=torch.where(new_mask, top_scores, 0.0),
        leaf_mask=new_mask & state.tgt_mask[..., None],
        hist_meas=shift_append(state.hist_meas, new_meas_label, -1),
        hist_ais=shift_append(state.hist_ais, new_ais_label, 0),
        hist_mmsi=shift_append(state.hist_mmsi, new_mmsi_label, 0),
        hist_cnllr=shift_append(state.hist_cnllr, top_scores, 0.0),
        hist_x=torch.where(new_mask[..., None, None], hx, 0.0),
        tgt_depth=torch.where(state.tgt_mask,
                              torch.clamp(state.tgt_depth + 1, max=W),
                              state.tgt_depth),
        scan_idx=state.scan_idx + 1,
        time=scan.time,
    )
    gated_counts = cand.gated_counts.view(*lead, T, L).sum(
        dim=-1, dtype=torch.int32)                                 # [T]
    used = cand.used_meas.view(*lead, M) if lead else cand.used_meas
    return GrowOutputs(state=new_state, used_meas=used,
                       gated_counts=gated_counts)

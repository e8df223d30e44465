"""The AIS two-stage fusion candidates of grow (counterpart of
pymht_tpu/ops/ais_fused.py:ais_candidates_planes).

Stage 1 predicts every leaf to every AIS message's own timestamp and
gates it with the full-state (4x4) innovation, under MMSI consistency
with the leaf's history; the gated messages are compressed to the best G
per leaf by stage-1 NIS; the stage-1 update is computed for those only;
stage 2 re-predicts the AIS-updated state to scan time and gates and
scores it against the radar measurements (2x2).  Scores follow the
reference pyMHT (tracker.py:417-552): fused 0.5 nllr_ais + 0.5
nllr_radar, pure AIS nllr_ais.

The JAX module spells every matrix entry out as a scalar plane so that
XLA fuses the chain into a few kernels.  Eager torch launches one kernel
per expression, so the same arithmetic is written here on stacked
[..., 4, 4] tensors: the constant-velocity predict in 2x2 blocks (the
planes' formulas, block by block) and the block-Schur inverse of
``ops.kalman.inv4x4``.  The small matrix products are broadcast
multiply-and-sum, not ``@``: batched cuBLAS calls on 2x2 and 4x4 matrices
cost ~50 us each on an H100, 2.3 of the AIS scene's 8.5 ms of device time
per scan when this module used them (PERF.md, under Findings).  Clamps are
the planes' (``log max(det, 1e-30)``, ``log max(lambda, 1e-20)``).  These
are plain torch ops on either device: the JAX chain is XLA code, not a
TPU kernel.  Every tensor may carry leading scenario axes (a batch of
scenarios, ``parallel/scenario.py``): the state's ``[..., T, L]``, the
scan's ``[..., M]``, the AIS batch's ``[..., A]``.
"""
from __future__ import annotations

import math

import torch

from ..batch import lead_index
from ..models import ais as ais_model
from ..models.constants import sigmaQ_tracker, sigmaR_RADAR_tracker
from . import kalman as k
from .topk import smallest_k

_LOG2PI = math.log(2.0 * math.pi)


def _mm(a, b):
    """a @ b for small matrices [..., i, k] x [..., k, j], elementwise."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def _mv(a, v):
    """a @ v for [..., i, k] x [..., k]."""
    return (a * v[..., None, :]).sum(dim=-1)


def _inv_det4(S):
    """Inverse and determinant of [..., 4, 4] from one 2x2 block-Schur
    factorisation (that of ``kalman.inv4x4`` / ``det4x4``)."""
    A, B, C, D = (S[..., :2, :2], S[..., :2, 2:], S[..., 2:, :2],
                  S[..., 2:, 2:])
    Ainv = k.inv2x2(A)
    CAinv = _mm(C, Ainv)
    M = D - _mm(CAinv, B)
    Minv = k.inv2x2(M)
    F = _mm(_mm(Ainv, B), Minv)
    top = torch.cat([Ainv + _mm(F, CAinv), -F], dim=-1)
    bot = torch.cat([-_mm(Minv, CAinv), Minv], dim=-1)
    return torch.cat([top, bot], dim=-2), k.det2x2(A) * k.det2x2(M)


def _pred_cov(P, T, q):
    """Phi(T) P Phi(T)^T + Q(T, q) in closed form, in 2x2 blocks
    (position, velocity).  P [..., 4, 4]; T broadcastable to P's batch
    shape.  The formulas of ``_pred_cov_planes`` (the reference's T^3/3
    off-diagonal kept)."""
    T = T[..., None, None]
    T2 = T * T
    eye = torch.eye(2, dtype=P.dtype, device=P.device)
    pp, pv_, vp, vv = (P[..., :2, :2], P[..., :2, 2:], P[..., 2:, :2],
                       P[..., 2:, 2:])
    q3 = (T2 * T / 3.0 * q) * eye
    top = torch.cat([pp + T * (pv_ + vp) + T2 * vv + (T2 * T2 / 4.0 * q) * eye,
                     pv_ + T * vv + q3], dim=-1)
    bot = torch.cat([vp + T * vv + q3, vv + (T2 * q) * eye], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _pred_state(x, T):
    """Constant-velocity predict of x [..., 4] over T (broadcastable)."""
    return torch.cat([x[..., :2] + T[..., None] * x[..., 2:],
                      x[..., 2:].expand(*torch.broadcast_shapes(
                          x.shape[:-1], T.shape), 2)], dim=-1)


def _stage1(x, P, dt, r, s, q):
    """Stage-1 pieces on a message axis K.  x [..., T,L,4], P
    [..., T,L,4,4]; dt, r broadcastable to [..., T,L,K]; s (message states)
    broadcastable to [..., T,L,K,4].  Returns (nis [..., T,L,K], P_bar,
    S_inv, det S, x_bar, zt)."""
    P_bar = _pred_cov(P[..., None, :, :], dt, q)               # [T,L,K,4,4]
    eye = torch.eye(4, dtype=P.dtype, device=P.device)
    S_inv, det = _inv_det4(P_bar + r[..., None, None] * eye)
    x_bar = _pred_state(x[..., None, :], dt)                   # [T,L,K,4]
    zt = s - x_bar
    nis = (zt * _mv(S_inv, zt)).sum(dim=-1)
    return nis, P_bar, S_inv, det, x_bar, zt


def ais_candidates(state, scan, ais, params, G, n_targets=None,
                   prefilter=0, z_sub=None, zmask_sub=None):
    """Two-stage AIS + radar fusion candidates.

    state: TrackerState; scan: Scan; ais: AisBatch; G: compressed AIS
    width per leaf.  ``n_targets`` (a number or 0-d tensor) overrides the
    live-target count in the AIS association density (needed when the
    target axis is split over devices; default: this state's count).
    ``prefilter`` (shapes.ais_prefilter_width): when 0 < prefilter < A
    the 4x4 sweep runs on only the max(prefilter, G) best messages per
    leaf under the lossless bound NIS >= |zt|^2 / trace(S).
    ``z_sub`` [T,Km,2] / ``zmask_sub`` [T,Km]: per-target measurements of
    the spatial pre-gate.

    Returns (g_ok [T,L,G], gate2 [T,L,G,M], pure_gate [T,L,G],
    nllr1g [T,L,G], fused_score [T,L,G,M], x_bar2 [T,L,G,4],
    z_hat2 [T,L,G,2], K2 [T,L,G,4,2], P_hat2 [T,L,G,4,4],
    ais_idx [T,L,G] int64), each behind the state's leading axes; slots
    with ``g_ok`` false hold arbitrary ingredients."""
    *lead, T, L = state.leaf_mask.shape
    A = ais.mask.shape[-1]
    dev = state.leaf_x.device
    q = float(sigmaQ_tracker)
    x, P = state.leaf_x, state.leaf_P
    bi = lead_index(lead, dev, extra=3)      # [..., T, L, k] picks of [..., A]

    dT1 = ais.time - state.time[..., None]                        # [A]
    r_a = torch.where(ais.high_accuracy,
                      ais_model.sigmaR_AIS_true_highAccuracy ** 2,
                      ais_model.sigmaR_AIS_true_lowAccuracy ** 2
                      ).to(torch.float32)                         # [A]

    # MMSI consistency: a leaf takes only messages of its track's MMSI
    # (if it has one)
    leaf_mmsi = torch.maximum(state.hist_mmsi.amax(dim=-1),
                              state.tgt_mmsi[..., None])          # [T,L]
    mmsi_ok = ((leaf_mmsi[..., None] == 0)
               | (leaf_mmsi[..., None] == ais.mmsi[..., None, None, :]))
    admissible = (ais.mask[..., None, None, :] & state.leaf_mask[..., None]
                  & mmsi_ok)                                      # [T,L,A]

    if 0 < prefilter < A:
        Gp = min(max(prefilter, G), A)
        dt1 = dT1[..., None, None, :]
        t2 = dt1 * dt1

        def p(i, j):
            return P[..., i, j][..., None]

        trace = (p(0, 0) + dt1 * (p(0, 2) + p(2, 0)) + t2 * p(2, 2)
                 + p(1, 1) + dt1 * (p(1, 3) + p(3, 1)) + t2 * p(3, 3)
                 + p(2, 2) + p(3, 3)
                 + (t2 * t2 / 2.0 + 2.0 * t2) * q
                 + 4.0 * r_a[..., None, None, :])                 # tr S
        ztb = (ais.state[..., None, None, :, :]
               - _pred_state(x[..., None, :], dt1))
        bound = (ztb * ztb).sum(dim=-1) / trace                   # [T,L,A]
        okb = (bound <= params.eta2_ais) & admissible
        _, idxp = smallest_k(torch.where(okb, bound, torch.inf), Gp)
        validp = torch.gather(okb, -1, idxp)
        ip = (*bi, idxp)
        nis_p = _stage1(x, P, dT1[ip], r_a[ip], ais.state[ip], q)[0]
        gate_p = validp & (nis_p <= params.eta2_ais)
        nis1g, sel2 = smallest_k(torch.where(gate_p, nis_p, torch.inf), G)
        ais_idx = torch.gather(idxp, -1, sel2)                    # [T,L,G]
    else:
        # exact stage-1 sweep over the full [T,L,A] axis, then the G
        # best gated messages per leaf (ties and the inf padding fall to
        # the lowest index, as in the JAX package)
        nis1 = _stage1(x, P, dT1[..., None, None, :],
                       r_a[..., None, None, :],
                       ais.state[..., None, None, :, :], q)[0]
        gate1 = (nis1 <= params.eta2_ais) & admissible
        nis1g, ais_idx = smallest_k(torch.where(gate1, nis1, torch.inf), G)
    g_ok = torch.isfinite(nis1g)

    # ---- stage-1 update for the selected messages, [T,L,G] -----------
    ig = (*bi, ais_idx)
    dtg, msg_time = dT1[ig], ais.time[ig]
    _, pbg, invg, detg, xbg, ztg = _stage1(x, P, dtg, r_a[ig],
                                           ais.state[ig], q)
    xh = xbg + _mv(pbg, _mv(invg, ztg))       # x_bar + P_bar S^-1 zt
    ph = pbg - _mm(pbg, _mm(invg, pbg))

    if n_targets is None:
        n_targets = state.tgt_mask.sum(dim=-1).to(torch.float32)
    radar_range = (params.radar_range
                   if math.isfinite(params.radar_range) else 1e4)
    lambda_ais = (torch.as_tensor(n_targets, dtype=torch.float32, device=dev)
                  * params.P_ais / (math.pi * radar_range ** 2))
    nllr1g = (0.5 * nis1g
              + torch.log(lambda_ais.clamp(min=1e-20))[..., None, None, None]
              + 0.5 * (4.0 * _LOG2PI + torch.log(detg.clamp(min=1e-30))))

    # ---- stage 2: re-predict to scan time, 2x2 gate and score --------
    dt2 = scan.time[..., None, None, None] - msg_time             # [T,L,G]
    pb2 = _pred_cov(ph, dt2, q)
    x_bar2 = _pred_state(xh, dt2)                                 # [T,L,G,4]
    r2 = float(sigmaR_RADAR_tracker) ** 2
    s11, s12 = pb2[..., 0, 0] + r2, pb2[..., 0, 1]
    s21, s22 = pb2[..., 1, 0], pb2[..., 1, 1] + r2
    det2 = s11 * s22 - s12 * s21
    rdet = 1.0 / det2
    i11, i12, i21, i22 = s22 * rdet, -s12 * rdet, -s21 * rdet, s11 * rdet

    if z_sub is None:
        zx = scan.z[..., None, None, None, :, 0]                  # [1,1,1,M]
        zy = scan.z[..., None, None, None, :, 1]
        m_mask = scan.mask[..., None, None, None, :]
    else:
        zx = z_sub[..., :, None, None, :, 0]                      # [T,1,1,Km]
        zy = z_sub[..., :, None, None, :, 1]
        m_mask = zmask_sub[..., :, None, None, :]
    dx = zx - x_bar2[..., 0, None]                                # [T,L,G,M]
    dy = zy - x_bar2[..., 1, None]
    nis2 = (i11[..., None] * dx * dx + (i12 + i21)[..., None] * dx * dy
            + i22[..., None] * dy * dy)
    gate2 = (nis2 <= params.eta2) & m_mask & g_ok[..., None]
    log_term2 = (math.log(max(float(params.lambda_ex), 1e-20))
                 + 0.5 * (2.0 * _LOG2PI + torch.log(det2.clamp(min=1e-30)))
                 - torch.log(state.tgt_pd)[..., None, None])
    nllr2 = 0.5 * nis2 + log_term2[..., None]
    fused_score = 0.5 * nllr1g[..., None] + 0.5 * nllr2           # [T,L,G,M]
    pure_gate = g_ok & ~gate2.any(dim=-1)

    # ---- ingredients of a selected candidate's state -----------------
    S2_inv = torch.stack([torch.stack([i11, i12], dim=-1),
                          torch.stack([i21, i22], dim=-1)], dim=-2)
    K2 = _mm(pb2[..., :, :2], S2_inv)                             # [T,L,G,4,2]
    P_hat2 = pb2 - _mm(K2, pb2[..., :2, :])
    return (g_ok, gate2, pure_gate, nllr1g, fused_score,
            x_bar2, x_bar2[..., :2], K2, P_hat2, ais_idx)

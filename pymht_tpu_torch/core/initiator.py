"""m/n track initiation (counterpart of pymht_tpu/core/initiator.py).

1. preliminary tracks are predicted; every AIS message whose MMSI no
   prelim holds, predicted to scan time, seeds a new prelim; measurements
   are gated (chi2 df=2) and assigned by GNN (auction_assign), assigned
   tracks get a KF update and m += 1, every track n += 1, then m/n
   analysis confirms (m >= M) or kills (n >= N with m < M, or speed >
   1.5 v_max);
2. measurements unclaimed by prelims pair with the previous scan's
   one-point initiators (distance GNN, gate v_max dt) and spawn new
   prelims with two-point velocity initialisation and NIS dedup;
3. everything still unclaimed becomes the next scan's initiators.

The step also takes a batch of scenarios: leading axes on the state, on
``z``, ``z_mask`` and ``time`` and on the AIS batch.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..batch import isin, lead_index
from ..models import pv, ais as ais_model
from ..ops import kalman as k
from ..ops.assignment import auction_assign
from .config import TrackerShapes, TrackerParams
from .grow import AisBatch
from .state import _Tensors


@dataclasses.dataclass
class InitiatorState(_Tensors):
    # Preliminary tracks
    p_x: torch.Tensor         # [P, 4]
    p_P: torch.Tensor         # [P, 4, 4]
    p_m: torch.Tensor         # [P] i32 — hits
    p_n: torch.Tensor         # [P] i32 — checks
    p_mask: torch.Tensor      # [P] bool
    p_mmsi: torch.Tensor      # [P] i32
    p_meas_idx: torch.Tensor  # [P] i32 — last assigned measurement
    # One-point initiators (previous scan's leftovers)
    i_pos: torch.Tensor       # [I, 2]
    i_mask: torch.Tensor      # [I] bool
    last_time: torch.Tensor   # [] f32
    has_time: torch.Tensor    # [] bool


class InitiatorOutputs(NamedTuple):
    state: InitiatorState
    new_x: torch.Tensor     # [P, 4] confirmed target states
    new_P: torch.Tensor     # [P, 4, 4]
    new_mask: torch.Tensor  # [P] bool
    new_mmsi: torch.Tensor  # [P] i32


def empty_initiator(shapes: TrackerShapes, device,
                    batch: tuple = ()) -> InitiatorState:
    """No prelims and no initiators; ``batch`` leading scenario axes."""
    P, I = shapes.max_prelim, shapes.max_initiators
    batch = tuple(batch)

    def z(shape, dt):
        return torch.zeros(batch + shape, dtype=dt, device=device)

    return InitiatorState(
        p_x=z((P, 4), torch.float32), p_P=z((P, 4, 4), torch.float32),
        p_m=z((P,), torch.int32), p_n=z((P,), torch.int32),
        p_mask=z((P,), torch.bool), p_mmsi=z((P,), torch.int32),
        p_meas_idx=torch.full(batch + (P,), -1, dtype=torch.int32,
                              device=device),
        i_pos=z((I, 2), torch.float32), i_mask=z((I,), torch.bool),
        last_time=z((), torch.float32), has_time=z((), torch.bool))


def _insert_rows(dst_mask, src_mask):
    """Map the k-th valid source row to the k-th free destination slot.
    Returns (take [D] bool, src_idx [D])."""
    free = ~dst_mask
    slot_rank = torch.cumsum(free.int(), -1) - 1
    src_rank = torch.cumsum(src_mask.int(), -1) - 1
    match = (free[..., :, None] & src_mask[..., None, :]
             & (slot_rank[..., :, None] == src_rank[..., None, :]))
    return match.any(dim=-1), match.int().argmax(dim=-1)


def _nis_dedup(cand_x, cand_mask, pool_x, pool_P, pool_mask,
               threshold: float = 1.0):
    """Drop candidates whose NIS to an existing prelim (S = P + R_ais(low))
    is within ``threshold``."""
    S_inv = k.inv_psd(pool_P + ais_model.R(False, pool_P.device))
    d = cand_x[..., :, None, :] - pool_x[..., None, :, :]            # [K,P,4]
    nis = torch.einsum('...kpi,...pij,...kpj->...kp', d, S_inv, d)
    close = (nis <= threshold) & pool_mask[..., None, :]
    return cand_mask & ~close.any(dim=-1)


def _claim(mask, idx, ok):
    """``mask`` with entries ``idx[ok]`` set (a copy)."""
    *lead, M = mask.shape
    out = torch.cat([mask, mask.new_zeros((*lead, 1))], dim=-1)
    # a device value, not a Python scalar: no host copy under capture
    out[(*lead_index(lead, mask.device, extra=1),
         torch.where(ok, idx.long(), M))] = torch.ones(
        (), dtype=torch.bool, device=mask.device)
    return out[..., :M]


def step(state: InitiatorState, z, z_mask, time, ais: Optional[AisBatch],
         shapes: TrackerShapes, params: TrackerParams) -> InitiatorOutputs:
    """One scan of the initiator.  ``ais`` holds the messages that may
    seed prelims.  ``None`` (AIS initiation off) gives what an empty
    AisBatch gives and skips the seeding block: in eager torch that block
    launches its kernels whether or not a message is there (164 device
    ops per scan on the radar-only bench scene, H100; PERF.md, Findings)."""
    if ais is not None and not isinstance(ais, AisBatch):
        raise TypeError(f"initiator.step: ais must be an AisBatch or None, "
                        f"got {type(ais).__name__}")
    P = shapes.max_prelim
    *lead, M = z.shape[:-1]
    lead = tuple(lead)
    dev = z.device
    gamma = params.gamma_initiator
    bi = lead_index(lead, dev, extra=1)        # () unbatched

    # -- 1a. predict preliminary tracks --------------------------------
    dt = torch.where(state.has_time, time - state.last_time,
                     float(params.radar_period))
    F, Q = pv.Phi(dt, dev), pv.Q(dt, device=dev)
    p_x = torch.einsum('...ij,...pj->...pi', F, state.p_x)
    p_P = torch.einsum('...ij,...pjk,...lk->...pil', F, state.p_P, F) \
        + Q[..., None, :, :]
    pm1, pm2 = state.p_mask[..., None], state.p_mask[..., None, None]
    st = state.replace(p_x=torch.where(pm1, p_x, 0.0),
                       p_P=torch.where(pm2, p_P, 0.0))

    # -- 1b. AIS-seeded prelims ----------------------------------------
    if ais is not None:
        dTa = time[..., None] - ais.time                                 # [A]
        PhiA = pv.Phi(dTa, dev)
        ax = torch.einsum('...aij,...aj->...ai', PhiA, ais.state)
        aP = torch.einsum('...aij,jk,...alk->...ail', PhiA, pv.P0(dev),
                          PhiA) + pv.Q(dTa, device=dev)
        held = torch.where(st.p_mask, st.p_mmsi, -1)
        a_new = ais.mask & ~isin(ais.mmsi, held)
        a_new = _nis_dedup(ax, a_new, st.p_x, st.p_P, st.p_mask)
        take, src = _insert_rows(st.p_mask, a_new)
        src = (*bi, src)
        st = st.replace(
            p_x=torch.where(take[..., None], ax[src], st.p_x),
            p_P=torch.where(take[..., None, None], aP[src], st.p_P),
            p_m=torch.where(take, 0, st.p_m),
            p_n=torch.where(take, 0, st.p_n),
            p_mmsi=torch.where(take, ais.mmsi[src], st.p_mmsi),
            p_meas_idx=torch.where(take, -1, st.p_meas_idx),
            p_mask=st.p_mask | take,
        )

    # -- 1c. gate + GNN assign measurements to prelims -----------------
    z_hat, _, S_inv, K, P_hat = k.precalc(pv.C_RADAR(dev), pv.R_RADAR(dev),
                                          st.p_x, st.p_P)
    zt = z[..., None, :, :] - z_hat[..., None, :]                    # [P,M,2]
    nis = k.nis(zt, S_inv)
    dist = torch.linalg.vector_norm(zt, dim=-1)
    gate = (nis <= gamma) & z_mask[..., None, :] & st.p_mask[..., None]
    assign = auction_assign(dist, gate, max_iters=48)                # [P]
    assigned = assign >= 0
    am = assign.long().clamp(0, M - 1)
    pidx = lead_index((*lead, P), dev)
    x_upd = st.p_x + torch.einsum('...ij,...j->...i', K, zt[(*pidx, am)])
    st = st.replace(
        p_x=torch.where(assigned[..., None], x_upd, st.p_x),
        p_P=torch.where(assigned[..., None, None], P_hat, st.p_P),
        p_m=st.p_m + assigned.int(),
        p_n=st.p_n + st.p_mask.int(),
        p_meas_idx=torch.where(assigned, assign, -1).int(),
    )
    meas_claimed = _claim(torch.zeros((*lead, M), dtype=torch.bool,
                                      device=dev), assign, assigned)

    # -- 1d. m/n analysis ----------------------------------------------
    speed = torch.linalg.vector_norm(st.p_x[..., 2:4], dim=-1)
    too_fast = speed > params.max_speed * 1.5
    confirmed = st.p_mask & (st.p_m >= params.M_required) & ~too_fast
    dead = st.p_mask & (too_fast | ((st.p_n >= params.N_checks)
                                    & (st.p_m < params.M_required)))
    new_x, new_P = st.p_x, st.p_P
    new_mmsi = torch.where(confirmed, st.p_mmsi, 0)
    st = st.replace(p_mask=st.p_mask & ~(confirmed | dead))

    # -- 2. pair unclaimed measurements with previous initiators -------
    un1 = z_mask & ~meas_claimed
    d_init = torch.linalg.vector_norm(
        z[..., None, :, :] - st.i_pos[..., :, None, :], dim=-1)
    gate2 = ((d_init <= (params.max_speed * dt)[..., None, None])
             & un1[..., None, :] & st.i_mask[..., None]
             & state.has_time[..., None, None])
    assign2 = auction_assign(d_init, gate2, max_iters=48)           # [I]
    paired = assign2 >= 0
    zp = z[(*bi, assign2.long().clamp(0, M - 1))]
    vel = (zp - st.i_pos) / torch.clamp(dt, min=1e-6)[..., None, None]
    cand_x = torch.cat([zp, vel], dim=-1)                            # [I, 4]
    cand_ok = _nis_dedup(cand_x, paired, st.p_x, st.p_P, st.p_mask)
    take2, src2 = _insert_rows(st.p_mask, cand_ok)
    st = st.replace(
        p_x=torch.where(take2[..., None], cand_x[(*bi, src2)], st.p_x),
        p_P=torch.where(take2[..., None, None], pv.P0(dev), st.p_P),
        p_m=torch.where(take2, 0, st.p_m),
        p_n=torch.where(take2, 0, st.p_n),
        p_mmsi=torch.where(take2, 0, st.p_mmsi),
        p_meas_idx=torch.where(take2, -1, st.p_meas_idx),
        p_mask=st.p_mask | take2,
    )
    meas_claimed = _claim(meas_claimed, assign2, paired)

    # -- 3. leftovers become next scan's initiators --------------------
    un2 = z_mask & ~meas_claimed
    take3, src3 = _insert_rows(torch.zeros_like(st.i_mask), un2)
    st = st.replace(
        i_pos=torch.where(take3[..., None], z[(*bi, src3)], 0.0),
        i_mask=take3,
        last_time=time.to(torch.float32),
        has_time=torch.ones_like(st.has_time),
    )
    return InitiatorOutputs(state=st, new_x=new_x, new_P=new_P,
                            new_mask=confirmed, new_mmsi=new_mmsi)

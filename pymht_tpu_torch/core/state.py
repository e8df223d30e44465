"""Struct-of-arrays tracker state as a dataclass of torch tensors
(counterpart of pymht_tpu/core/state.py).

The whole hypothesis forest lives in padded device tensors: a leaf is
one row of the leaf table and its ancestry is a label history whose
column ``W-1`` is the current scan.  Field names, shapes, dtypes and
encodings are the JAX state's (``hist_meas``: -1 no scan, 0 missed
detection, m >= 1 radar measurement m-1; indices are int32), so a state
converts to and from the JAX one field by field through numpy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..batch import lead_index
from ..ops.topk import smallest_k
from .config import TrackerShapes, TrackerParams

f32, i32 = torch.float32, torch.int32


class _Tensors:
    """``replace`` for the state dataclasses (flax's PyTreeNode API)."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


def _to_numpy(obj) -> dict:
    return {f.name: getattr(obj, f.name).cpu().numpy()
            for f in dataclasses.fields(obj)}


def _from_numpy(cls, d: dict, device):
    return cls(**{f.name: torch.as_tensor(np.array(d[f.name]), device=device)
                  for f in dataclasses.fields(cls)})


@dataclasses.dataclass
class TrackerState(_Tensors):
    # Leaf table
    leaf_x: torch.Tensor       # [T, L, 4] f32
    leaf_P: torch.Tensor       # [T, L, 4, 4] f32
    leaf_cnllr: torch.Tensor   # [T, L] f32 — cumulative NLLR since birth
    leaf_mask: torch.Tensor    # [T, L] bool
    # Label history window (col W-1 == current scan)
    hist_meas: torch.Tensor    # [T, L, W] i32
    hist_ais: torch.Tensor     # [T, L, W] i32
    hist_mmsi: torch.Tensor    # [T, L, W] i32
    hist_cnllr: torch.Tensor   # [T, L, W] f32
    hist_x: torch.Tensor       # [T, L, W, 4] f32
    # Per-target
    tgt_mask: torch.Tensor     # [T] bool
    tgt_id: torch.Tensor       # [T] i32 (-1 free slot)
    tgt_root_cnllr: torch.Tensor  # [T] f32
    tgt_depth: torch.Tensor    # [T] i32
    tgt_window: torch.Tensor   # [T] i32
    tgt_pd: torch.Tensor       # [T] f32
    tgt_mmsi: torch.Tensor     # [T] i32
    sel_leaf: torch.Tensor     # [T] i32
    spine_leaf: torch.Tensor   # [T] i32 — zero-hyp child of previous sel
    # Globals
    scan_idx: torch.Tensor     # [] i32
    time: torch.Tensor         # [] f32
    next_id: torch.Tensor      # [] i32
    lam: torch.Tensor          # [W*(M+A)] f32 — warm-started duals


def empty_state(shapes: TrackerShapes, params: TrackerParams,
                device, batch: tuple = ()) -> TrackerState:
    """The empty forest; ``batch`` leading scenario axes on every field
    (``parallel/scenario.batch_states``)."""
    T, L, W = shapes.max_targets, shapes.max_leaves, shapes.window
    batch = tuple(batch)

    def z(shape, dt):
        return torch.zeros(batch + shape, dtype=dt, device=device)

    def full(shape, v, dt):
        return torch.full(batch + shape, v, dtype=dt, device=device)

    return TrackerState(
        leaf_x=z((T, L, 4), f32),
        leaf_P=z((T, L, 4, 4), f32),
        leaf_cnllr=z((T, L), f32),
        leaf_mask=z((T, L), torch.bool),
        hist_meas=full((T, L, W), -1, i32),
        hist_ais=z((T, L, W), i32),
        hist_mmsi=z((T, L, W), i32),
        hist_cnllr=z((T, L, W), f32),
        hist_x=z((T, L, W, 4), f32),
        tgt_mask=z((T,), torch.bool),
        tgt_id=full((T,), -1, i32),
        tgt_root_cnllr=z((T,), f32),
        tgt_depth=z((T,), i32),
        tgt_window=full((T,), params.N, i32),
        tgt_pd=full((T,), params.P_d, f32),
        tgt_mmsi=z((T,), i32),
        sel_leaf=z((T,), i32),
        spine_leaf=z((T,), i32),
        scan_idx=z((), i32),
        time=z((), f32),
        next_id=z((), i32),
        lam=z((W * (shapes.max_meas + shapes.max_ais),), f32),
    )


_LEAF_FIELDS = ('leaf_x', 'leaf_P', 'leaf_cnllr', 'leaf_mask', 'hist_meas',
                'hist_ais', 'hist_mmsi', 'hist_cnllr', 'hist_x')


def shrink_beam(state: TrackerState, new_L: int) -> TrackerState:
    """The forest with a narrower hypothesis beam (L -> new_L): each
    target keeps its best ``new_L`` live leaves by cumulative NLLR (ties
    by lower index, as ``jax.lax.top_k``), the currently selected leaf
    first.  Between scans leaf indices are stable, so the conversion is
    one gather; ``sel_leaf`` and ``spine_leaf`` are remapped so that the
    next grow's feasibility spine (the zero-hypothesis child of the
    previous selection) stays intact."""
    T, L, W = state.hist_meas.shape
    if new_L > L:
        raise ValueError(f"shrink_beam: new_L {new_L} exceeds L {L}")
    if new_L == L:
        return state
    dev = state.leaf_mask.device
    tb = torch.arange(T, device=dev)
    sel = state.sel_leaf.long().clamp(0, L - 1)
    sel_live = state.leaf_mask[tb, sel]
    key = torch.where(state.leaf_mask, state.leaf_cnllr, torch.inf)
    is_sel = ((torch.arange(L, device=dev)[None, :] == sel[:, None])
              & sel_live[:, None])
    key = torch.where(is_sel, -torch.inf, key)              # selected first
    _, keep = smallest_k(key, new_L)                          # [T, new_L]
    new_sel = torch.where(sel_live,
                          (keep == sel[:, None]).int().argmax(dim=1), 0).int()

    def take(a):
        idx = keep.reshape(keep.shape + (1,) * (a.dim() - 2))
        return torch.gather(a, 1, idx.expand(keep.shape + a.shape[2:]))

    return state.replace(sel_leaf=new_sel, spine_leaf=new_sel,
                         **{f: take(getattr(state, f)) for f in _LEAF_FIELDS})


def expand_beam(state: TrackerState, new_L: int) -> TrackerState:
    """The inverse conversion: the beam widened to ``new_L`` with dead
    leaves.  Leaf order is kept, so ``sel_leaf`` does not change."""
    T, L, W = state.hist_meas.shape
    if new_L < L:
        raise ValueError(f"expand_beam: new_L {new_L} is below L {L}")
    if new_L == L:
        return state

    def pad(a, fill):
        return torch.cat([a, a.new_full((T, new_L - L) + a.shape[2:], fill)],
                         dim=1)

    return state.replace(**{f: pad(getattr(state, f),
                                   -1 if f == 'hist_meas' else 0)
                            for f in _LEAF_FIELDS})


def insert_targets(state: TrackerState, new_x, new_P, new_mask, new_mmsi,
                   time, params: TrackerParams,
                   new_ids=None) -> TrackerState:
    """Initiate up to K new targets into free slots (masked, fixed shape):
    the k-th new target takes the k-th free slot as a single root leaf
    with cnllr 0 and the next free id, or its id from ``new_ids`` [K]
    (the target-sharded step, where ids must be unique over the ranks).
    ``time`` (a 0-d tensor, or one per scenario) advances the forest
    clock.  Leading scenario axes on the state and on the new targets'
    tensors are allowed."""
    lead = state.leaf_mask.shape[:-2]
    free = ~state.tgt_mask
    slot_rank = torch.cumsum(free.int(), -1) - 1                  # [T]
    new_rank = torch.cumsum(new_mask.int(), -1) - 1               # [K]
    match = (free[..., :, None] & new_mask[..., None, :]
             & (slot_rank[..., :, None] == new_rank[..., None, :]))  # [T, K]
    take = match.any(dim=-1)
    src = match.int().argmax(dim=-1)

    bi = lead_index(lead, src.device, extra=1)
    x_in, P_in, mmsi_in = (new_x[(*bi, src)], new_P[(*bi, src)],
                           new_mmsi[(*bi, src)])
    t1, t2, t3 = (take[..., None], take[..., None, None],
                  take[..., None, None, None])
    root_x = torch.zeros_like(state.leaf_x)
    root_x[..., 0, :] = x_in
    root_P = torch.zeros_like(state.leaf_P)
    root_P[..., 0, :, :] = P_in
    first = torch.zeros_like(state.leaf_mask)
    first[..., 0] = True

    ids_in = (state.next_id[..., None] + slot_rank if new_ids is None
              else new_ids[(*bi, src)])
    ids = torch.where(take, ids_in, state.tgt_id)
    return state.replace(
        time=torch.maximum(state.time, time.to(f32)),
        leaf_x=torch.where(t2, root_x, state.leaf_x),
        leaf_P=torch.where(t3, root_P, state.leaf_P),
        leaf_cnllr=torch.where(t1, 0.0, state.leaf_cnllr),
        leaf_mask=torch.where(t1, first, state.leaf_mask),
        hist_meas=torch.where(t2, -1, state.hist_meas),
        hist_ais=torch.where(t2, 0, state.hist_ais),
        hist_mmsi=torch.where(t2, 0, state.hist_mmsi),
        hist_cnllr=torch.where(t2, 0.0, state.hist_cnllr),
        hist_x=torch.where(t3, 0.0, state.hist_x),
        tgt_mask=state.tgt_mask | take,
        tgt_id=ids.to(i32),
        tgt_root_cnllr=torch.where(take, 0.0, state.tgt_root_cnllr),
        tgt_depth=torch.where(take, 0, state.tgt_depth),
        tgt_window=torch.where(take, params.N, state.tgt_window),
        tgt_pd=torch.where(take, params.P_d, state.tgt_pd),
        tgt_mmsi=torch.where(take, mmsi_in, state.tgt_mmsi),
        sel_leaf=torch.where(take, 0, state.sel_leaf),
        spine_leaf=torch.where(take, 0, state.spine_leaf),
        next_id=state.next_id + new_mask.sum(dim=-1).to(i32),
    )


def state_from_numpy(d: dict, device) -> TrackerState:
    """A TrackerState from a dict of numpy arrays named like its fields
    (e.g. the fields of a JAX state after ``jax.device_get``, batched by
    ``jax.vmap`` or not)."""
    return _from_numpy(TrackerState, d, device)


def state_to_numpy(state: TrackerState) -> dict:
    return _to_numpy(state)


def initiator_from_numpy(d: dict, device):
    from .initiator import InitiatorState
    return _from_numpy(InitiatorState, d, device)


def initiator_to_numpy(init_state) -> dict:
    return _to_numpy(init_state)


def ais_from_numpy(d: dict, device):
    """An AisBatch from a dict of numpy arrays named like its fields
    (e.g. a JAX AisBatch's ``_asdict()`` after ``jax.device_get``)."""
    from .grow import AisBatch
    return AisBatch(**{f: torch.as_tensor(np.array(d[f]), device=device)
                       for f in AisBatch._fields})

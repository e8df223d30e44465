"""Target-sharded full tracker step: the whole per-scan pipeline on each
rank's share of the targets, with the selection collectives of
distributed_select.py (counterpart of
pymht_tpu/parallel/sharded_tracker.py).

The forest's target axis is split over the ranks of an ``Axis``
(collectives.py; the 'cluster' dimension of a mesh, BASELINE config 5).
In SPMD style every rank runs the same program on its own [T / size]
rows of every per-target tensor of the state; ``lam``, ``next_id``,
``scan_idx``, ``time`` and the initiator state are replicated, and so
are the scan and the AIS batch.  Per scan:

* grow     — target-parallel (each rank grows its own targets against
             the replicated scan; K1 runs at N = (T / size) L), after ONE
             pre-collective: the global live-target count of the AIS
             association density;
* select   — distributed Lagrangian with psum'd usage counts and pmin'd
             repair keys (distributed_select.py);
* terminate / N-scan prune — target-local;
* initiate — replicated compute on the globally unused measurements
             (identical on every rank), with new targets dealt
             round-robin over the ranks and their ids taken from the
             replicated global rank, so ids stay unique and ``next_id``
             replicated.

Every loop exit and branch that the port reads on the host is read from
a reduced or replicated value, so all ranks take the same path and the
next collective cannot hang.  ``shard_state`` cuts a rank's share from a
whole forest, ``gather_state`` and ``gather_outputs`` put the shares
back together.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import initiator as initiator_mod
from ..core.config import TrackerParams, TrackerShapes
from ..core.grow import AisBatch, grow
from ..core.lifecycle import n_scan_prune, terminate
from ..core.merge import prune_similar as merge_similar
from ..core.state import TrackerState, insert_targets
from ..core.tracker import (PER_TARGET_OUTPUTS, _merge_new_targets,
                            shrink_windows)
from .collectives import Axis
from .distributed_select import (distributed_lagrangian,
                                 distributed_select_compact)

# TrackerState fields without a leading target axis are replicated; the
# others are split by rows
REPLICATED_FIELDS = ('scan_idx', 'time', 'next_id', 'lam')
PER_TARGET_FIELDS = tuple(f.name for f in dataclasses.fields(TrackerState)
                          if f.name not in REPLICATED_FIELDS)


def rows_of(x, axis: Axis, n_targets: int):
    """This rank's rows of an array (numpy or torch) whose leading axis
    is the whole forest's ``n_targets`` targets."""
    if n_targets % axis.size:
        raise ValueError(f"{n_targets} targets do not split evenly over "
                         f"{axis.size} ranks")
    n = n_targets // axis.size
    return x[axis.index * n:(axis.index + 1) * n]


def shard_state(state: TrackerState, axis: Axis) -> TrackerState:
    """This rank's share of a whole forest: its rows of every per-target
    field, the replicated fields as they are."""
    T = state.tgt_mask.shape[0]
    return state.replace(**{k: rows_of(getattr(state, k), axis, T)
                            .contiguous() for k in PER_TARGET_FIELDS})


def gather_state(state: TrackerState, axis: Axis) -> TrackerState:
    """The whole forest from every rank's share (one all-gather per
    per-target field), on every rank."""
    return state.replace(**{k: axis.all_gather(getattr(state, k))
                            for k in PER_TARGET_FIELDS})


def gather_outputs(outs: dict, axis: Axis) -> dict:
    """A step's outputs in the whole forest's layout (JAX's
    ``out_specs``): the per-target ones (``StepOutputs``' names)
    all-gathered, the global scalars as they are."""
    return {k: axis.all_gather(v) if k in PER_TARGET_OUTPUTS else v
            for k, v in outs.items()}


def sharded_scan_step(state: TrackerState, init_state, scan, ais,
                      shapes: TrackerShapes, params: TrackerParams,
                      axis: Axis, use_ais: bool = False,
                      ais_initialization: bool = True,
                      prune_similar: bool = False,
                      dynamic_window: bool = False,
                      select_impl: str = 'compact', select_kw=None):
    """One scan on this rank's share: ``state`` holds this rank's target
    rows; ``init_state``, ``scan`` and ``ais`` are replicated.  Returns
    (state, init_state, outputs) with the outputs of JAX's step: the
    per-target ones this rank's rows, ``sel_obj`` / ``sel_bound`` /
    ``sel_feasible`` global; besides JAX's, the per-target fields that a
    Tracker's track archive reads (``Tracker._absorb_outputs``), named as
    in ``StepOutputs``."""
    if select_impl not in ('compact', 'full'):
        raise ValueError(f"unknown select_impl {select_impl!r}")
    if use_ais and not isinstance(ais, AisBatch):
        raise TypeError("sharded_scan_step: use_ais=True needs an AisBatch")
    T, L, W = state.hist_meas.shape
    dev = state.leaf_x.device
    tb = torch.arange(T, device=dev)

    # 1. grow.  The AIS association density depends on the GLOBAL
    # live-target count: the local count would bias every AIS score by
    # log(global / local).
    n_global = (axis.psum(state.tgt_mask.sum(dtype=torch.float32))
                if use_ais else None)
    g = grow(state, scan, ais if use_ais else None, shapes, params,
             n_targets_global=n_global)
    state = g.state
    if prune_similar:
        state = merge_similar(state, shapes, params)
    used_meas = axis.psum(g.used_meas) > 0

    # 2-3. distributed selection
    select = (distributed_select_compact if select_impl == 'compact'
              else distributed_lagrangian)
    sel, obj, lb, feas, lam = select(state, shapes, params, axis,
                                     lam0=state.lam, **(select_kw or {}))
    state = state.replace(sel_leaf=sel.int(), lam=lam)
    track_x = state.leaf_x[tb, sel]
    track_mask, track_id = state.tgt_mask, state.tgt_id
    sel_hist_valid = ((torch.arange(W, device=dev)[None, :]
                       >= (W - state.tgt_depth)[:, None])
                      & state.tgt_mask[:, None])
    sel_hist_x = state.hist_x[tb, sel]
    sel_hist_meas = state.hist_meas[tb, sel]
    sel_hist_mmsi = state.hist_mmsi[tb, sel]

    # 6-7. lifecycle (target-local)
    term = terminate(state, shapes, params)
    state = term.state
    pr = n_scan_prune(state, shapes, params)
    state = pr.state

    # 8. initiate: replicated compute, round-robin insertion.  A message
    # whose MMSI a surviving leaf on ANY rank associated is not available
    # for seeding.
    unused_z = scan.mask & ~used_meas
    ais_for_init = None
    if use_ais and ais_initialization:
        cur_mmsi = torch.where(state.leaf_mask, state.hist_mmsi[:, :, -1], 0)
        used_local = torch.isin(ais.mmsi, cur_mmsi.reshape(-1))
        used_mmsi = axis.psum(used_local) > 0
        ais_for_init = ais._replace(mask=ais.mask & ~used_mmsi)
    init_out = initiator_mod.step(init_state, scan.z, unused_z, scan.time,
                                  ais_for_init, shapes, params)
    init_state = init_out.state
    new_x, new_mask, new_mmsi = _merge_new_targets(
        init_out.new_x, init_out.new_mask, init_out.new_mmsi,
        params.merge_threshold)
    # global neighbour rejection: any rank's live leaf close by
    d = torch.linalg.vector_norm(
        new_x[:, None, :2] - state.leaf_x[..., :2].reshape(1, -1, 2), dim=-1)
    near_local = ((d < params.merge_threshold)
                  & state.leaf_mask.reshape(1, -1)).any(dim=1)
    new_mask = new_mask & ~(axis.psum(near_local) > 0)
    # new target k goes to rank k mod size, with the id of its global
    # rank
    rank = torch.cumsum(new_mask.int(), 0) - 1
    mine = new_mask & ((rank % axis.size) == axis.index)
    next_id_after = state.next_id + new_mask.sum(dtype=torch.int32)
    prev_mask = state.tgt_mask
    state = insert_targets(state, new_x, init_out.new_P, mine, new_mmsi,
                           scan.time, params, new_ids=state.next_id + rank)
    state = state.replace(next_id=next_id_after)
    inserted = state.tgt_mask & ~prev_mask

    # 9. on-device dynamic window: saturation is target-local, the
    # load-share trigger compares against the GLOBAL scan total
    if dynamic_window:
        state = shrink_windows(state, g.gated_counts, inserted, params,
                               axis)

    outs = dict(track_mask=track_mask, track_id=track_id, track_x=track_x,
                sel_hist_meas=sel_hist_meas, sel_obj=obj, sel_bound=lb,
                sel_feasible=feas, dead=term.dead,
                confirmed_mask=pr.confirmed_mask, confirmed_x=pr.confirmed_x,
                confirmed_meas=pr.confirmed_meas,
                # the archive's (Tracker._absorb_outputs)
                sel_hist_valid=sel_hist_valid, sel_hist_x=sel_hist_x,
                sel_hist_mmsi=sel_hist_mmsi, dead_reason=term.reason,
                confirmed_mmsi=pr.confirmed_mmsi, inserted_mask=inserted,
                inserted_id=state.tgt_id,
                inserted_P=state.leaf_P[:, 0, :, :])
    return state, init_state, outs


def make_sharded_tracker_step(axis: Axis, shapes: TrackerShapes,
                              params: TrackerParams, use_ais: bool = False,
                              ais_initialization: bool = True,
                              prune_similar: bool = False,
                              dynamic_window: bool = False,
                              select_impl: str = 'compact',
                              select_kw=None):
    """``run(state, init_state, scan, ais=None) -> (state, init_state,
    outputs)`` for one scan on this rank's share (``shard_state``) of a
    forest of ``shapes.max_targets`` targets split evenly over ``axis``.
    Track ids assigned by the round-robin insertion come from the
    replicated global rank, so they are unique over the ranks."""
    if shapes.max_targets % axis.size:
        raise ValueError(f"max_targets {shapes.max_targets} does not split "
                         f"over {axis.size} ranks")

    def run(state, init_state, scan, ais=None):
        if state.tgt_mask.shape[0] * axis.size != shapes.max_targets:
            raise ValueError("make_sharded_tracker_step: the state is not "
                             "this rank's share (shard_state)")
        return sharded_scan_step(state, init_state, scan, ais, shapes,
                                 params, axis, use_ais=use_ais,
                                 ais_initialization=ais_initialization,
                                 prune_similar=prune_similar,
                                 dynamic_window=dynamic_window,
                                 select_impl=select_impl,
                                 select_kw=select_kw)

    return run

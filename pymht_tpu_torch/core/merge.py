"""Similar-state hypothesis merging (counterpart of
pymht_tpu/core/merge.py).

Sibling hypotheses (leaves of one target that agree on every history
column except the newest) whose current positions lie within
``params.prune_threshold`` are merged into one leaf carrying the group's
mean state, covariance and cumulative NLLR.  AIS-labelled hypotheses and
the feasibility spine are exempt.  The representative keeps its own
label; the others free their beam slots by mask only.  No value is read
on the host.
"""
from __future__ import annotations

import torch

from .config import TrackerShapes, TrackerParams
from .state import TrackerState


def prune_similar(state: TrackerState, shapes: TrackerShapes,
                  params: TrackerParams) -> TrackerState:
    T, L, W = state.hist_meas.shape
    dev = state.leaf_x.device
    lids = torch.arange(L, device=dev)

    def prefix_eq(h):
        return (h[:, :, None, :-1] == h[:, None, :, :-1]).all(dim=3)

    pos = state.leaf_x[..., :2]
    dist = torch.linalg.vector_norm(pos[:, :, None, :] - pos[:, None, :, :],
                                    dim=3)
    no_ais = state.hist_mmsi[:, :, -1] == 0                          # [T,L]
    # the feasibility spine must never be absorbed
    not_spine = lids[None, :] != state.spine_leaf[:, None]
    ok = state.leaf_mask & no_ais & not_spine
    mergeable = (prefix_eq(state.hist_meas) & prefix_eq(state.hist_ais)
                 & prefix_eq(state.hist_mmsi)
                 & (dist < params.prune_threshold)
                 & ok[:, :, None] & ok[:, None, :])                  # [T,L,L]

    # Representative = first (lowest index) mergeable partner.
    rep = mergeable.int().argmax(dim=2)                              # [T,L]
    has_partner = mergeable.any(dim=2)                        # self counts
    is_rep = has_partner & (rep == lids[None, :])
    # Chains (j -> r with r itself absorbed into q) wait for the next
    # scan: only leaves whose representative is a stable one take part.
    has_partner = has_partner & torch.gather(is_rep, 1, rep)
    is_rep = has_partner & (rep == lids[None, :])
    # w[t, j, r]: leaf j belongs to representative r
    w = (has_partner[:, :, None]
         & (rep[:, :, None] == lids[None, None, :])).float()
    counts = w.sum(dim=1)                                            # [T,L]
    wT = w.transpose(1, 2)                                         # [T,r,j]
    denom = torch.clamp(counts, min=1.0)
    mean_x = torch.bmm(wT, state.leaf_x) / denom[..., None]
    mean_P = (torch.bmm(wT, state.leaf_P.reshape(T, L, 16))
              / denom[..., None]).reshape(T, L, 4, 4)
    mean_c = torch.bmm(wT, state.leaf_cnllr[..., None])[..., 0] / denom

    merged_group = is_rep & (counts > 1.5)
    absorbed = has_partner & ~is_rep
    hist_cnllr = state.hist_cnllr.clone()
    hist_cnllr[:, :, -1] = torch.where(merged_group, mean_c,
                                       state.hist_cnllr[:, :, -1])
    return state.replace(
        leaf_x=torch.where(merged_group[..., None], mean_x, state.leaf_x),
        leaf_P=torch.where(merged_group[..., None, None], mean_P,
                           state.leaf_P),
        leaf_cnllr=torch.where(merged_group, mean_c, state.leaf_cnllr),
        hist_cnllr=hist_cnllr,
        leaf_mask=state.leaf_mask & ~absorbed)

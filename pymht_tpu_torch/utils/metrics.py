"""Track-quality metrics against ground truth (the port's own copy of
pymht_tpu/utils/metrics.py; numpy and scipy only).

The reference delegates evaluation to its companion pyMHT-simulator
repo, but pre-declares the vocabulary in its XML schema
(xmlDefinitions.py:44-64: rms error, track loss, track percentage,
time-match lengths) and carries a truth-comparison helper
(_compareTracksWithTruth, tracker.py:952-956).  This module computes
those metrics directly: truth-to-track matching by position gating, RMS
position/velocity error over matched samples, track-loss and coverage
percentages, and NEES-style consistency.
"""
from __future__ import annotations

import numpy as np


def truth_positions(sim_list):
    """[S, K, 4] array of truth states from a host sim_list."""
    return np.array([[t.cartesian_state() for t in sample]
                     for sample in sim_list])


def evaluate(tracker, sim_list, radar_period, match_threshold=20.0,
             init_time=None, p0=None, radar_range=None):
    """Compare a finished run against ground truth.

    Returns a dict: rms (position), rms_vel, track_percent (fraction of
    truth samples covered by a matched track), track_loss (fraction of
    truth targets whose coverage ends early), n_false_tracks,
    mean_time_match (scans of continuous coverage).
    """
    truth = truth_positions(sim_list)                    # [S, K, 4]
    S, K, _ = truth.shape
    t0 = init_time if init_time is not None else sim_list[0][0].time
    truth_times = np.array([sample[0].time for sample in sim_list])

    seqs = tracker._track_measurement_sequences(include_terminated=True)
    # Build per-track (time -> state) maps in absolute time.
    track_states = {}
    for tid, (times, labels, states, _mmsi) in seqs.items():
        track_states[tid] = {
            round(float(t) + tracker.t0, 6): np.asarray(s)
            for t, s in zip(times, states) if t is not None}

    # Exclude truth samples outside radar coverage (the reference's
    # ground-truth export does the same, classDefinitions.py:365-368).
    in_range = np.ones((S, K), bool)
    if p0 is not None and radar_range is not None:
        d = np.linalg.norm(truth[:, :, :2] - np.asarray(p0), axis=2)
        in_range = d <= radar_range

    # Per scan, ONE-TO-ONE matching of truth targets to track states
    # via the Hungarian assignment (gated at match_threshold) —
    # nearest-track matching lets one track "cover" several nearby
    # truths, inflating coverage (same scheme
    # as bench_swarm.py).  Ungated pairs are clamped to the gate cost so
    # the assignment never prefers them, then discarded.
    from scipy.optimize import linear_sum_assignment
    matched = np.zeros((S, K), bool)
    pos_err2, vel_err2 = [], []
    used_tracks = set()
    coverage = {k: [] for k in range(K)}
    last_valid = {k: 0 for k in range(K)}
    for si, tt in enumerate(truth_times):
        key = round(float(tt), 6)
        ks = [k for k in range(K) if in_range[si, k]]
        for k in ks:
            last_valid[k] = si
        cand = [(tid, m[key]) for tid, m in track_states.items()
                if key in m]
        if not cand or not ks:
            continue
        tp = np.stack([st[:2] for _, st in cand])            # [C, 2]
        d = np.linalg.norm(truth[si, ks][:, None, :2] - tp[None, :, :],
                           axis=2)                           # [k, C]
        ri, ci = linear_sum_assignment(np.minimum(d, match_threshold))
        for r, c in zip(ri, ci):
            if d[r, c] >= match_threshold:
                continue
            k = ks[r]
            tid, st = cand[c]
            matched[si, k] = True
            used_tracks.add(tid)
            pos_err2.append(np.sum((st[:2] - truth[si, k, :2]) ** 2))
            vel_err2.append(np.sum((st[2:4] - truth[si, k, 2:4]) ** 2))
            coverage[k].append(si)

    # track loss: a truth target is "lost" if its last matched sample is
    # more than one scan before the end while it was ever matched.
    lost = 0
    time_matches = []
    for k in range(K):
        if coverage[k]:
            time_matches.append(len(coverage[k]))
            if coverage[k][-1] < last_valid[k] - 1:
                lost += 1
        else:
            lost += 1
    n_tracked = sum(1 for k in range(K) if coverage[k])
    n_false = len(track_states) - len(used_tracks)

    return {
        'rms': float(np.sqrt(np.mean(pos_err2))) if pos_err2 else np.inf,
        'rms_vel': float(np.sqrt(np.mean(vel_err2))) if vel_err2 else np.inf,
        'track_percent': float(matched[in_range].mean()),
        'track_loss': float(lost / max(K, 1)),
        'n_tracked': n_tracked,
        'n_truth': K,
        'n_false_tracks': int(n_false),
        'mean_time_match': float(np.mean(time_matches))
        if time_matches else 0.0,
    }

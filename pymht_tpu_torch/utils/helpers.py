"""Misc host-side helpers mirroring the reference pyMHT's helpFunctions
(pymht/utils/helpFunctions.py); the port's own copy of
pymht_tpu/utils/helpers.py."""
from __future__ import annotations

import math

import numpy as np


def binomial(n: int, k: int) -> int:
    """reference helpFunctions.binomial (helpFunctions.py:32-33)."""
    return math.comb(int(n), int(k)) if k >= 0 else 0


def backtrack_measurement_numbers(tracker, track_id=None,
                                  include_terminated=False):
    """Per-track association history: measurement label per scan
    (0 = missed detection, m >= 1 = measurement index m-1 of that scan)
    — the reference's backtrackMeasurementNumbers
    (helpFunctions.py:66-83) over the archive + current window.

    Returns {track_id: (times, labels)} or a single (times, labels)
    when ``track_id`` is given.
    """
    seqs = tracker._track_measurement_sequences(include_terminated)
    out = {tid: (times, labels)
           for tid, (times, labels, _s, _m) in seqs.items()}
    if track_id is not None:
        return out.get(int(track_id))
    return out


def expected_hypotheses(n_meas_in_gate: int, window: int) -> int:
    """Rough upper bound on hypothesis count for one target: each scan
    branches into (1 + gated measurements); the reference reasons about
    this growth when capping tree size (tracker.py:118)."""
    return int((1 + n_meas_in_gate) ** window)

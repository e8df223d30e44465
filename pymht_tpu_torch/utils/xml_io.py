"""XML persistence compatible with the reference's result format
(counterpart of pymht_tpu/utils/xml_io.py: the same functions and tag
vocabulary, reading the port's Tracker; host code, numpy and the
standard library only).

Reimplements the reference's write-only export path — ground-truth
scenarios (classDefinitions.py:346-386 storeGroundTruth), tracker
configuration (tracker.py:1475-1498 _storeTrackerArgs) and per-run
tracks with raw + smoothed states (tracker.py:1500-1545 _storeRun,
pyTarget.py:745-829 _storeNode) — using the same tag vocabulary
(utils/xmlDefinitions.py) so downstream analysis tooling written for the
reference's XML keeps working.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

# Tag vocabulary (data-format contract, reference xmlDefinitions.py:1-76)
SCENARIO = "Scenario"
GROUNDTRUTH = "groundtruth"
SIMULATION = "Simulation"
VARIATIONS = "Variations"          # xmlDefinitions.py:4
VARIATION = "Variation"            # xmlDefinitions.py:5
SCENARIO_SETTINGS = "Scenario-settings"
TRACKER_SETTINGS = "Tracker-settings"
RUN = "Run"
RUNTIME = "Runtime"
TRACK = "Track"
STATES = "States"
SMOOTHED_STATES = "SmoothedStates"
STATE = "S"
POSITION = "P"
VELOCITY = "V"
NORTH = "N"
EAST = "E"
MMSI = "mmsi"
TIME = "t"
MEAN = "mean"
MIN = "min"
MAX = "max"
PRECISION = "precision"            # xmlDefinitions.py:23
DESCRIPTION = "Description"        # xmlDefinitions.py:24
SMOOTHED = "smoothed"              # xmlDefinitions.py:25
ID = "id"
ITERATION = "i"                    # xmlDefinitions.py:27
TYPE = "type"
ESTIMATE = "estimate"
PD = "Pd"
SIGMA_Q = "sigmaQ"
SEED = "seed"
LENGTH = "length"
AIS_CLASS = "aisClass"
PR = "Pr"
NAME = "name"
PREINITIALIZED = "preinitialized"
ACTIVE = "Active"
OUT_OF_RANGE = "OutOfRange"
STATUS = "status"
TOO_LOW_SCORE = "TooLowScore"
TERMINATED = "terminated"
N_SCANS = "nScans"
RADAR_PERIOD = "radarPeriod"
S_INV = "S_inv"     # reference xmlDefinitions.py:60 inverseResidualCovarianceTag
# Analysis-side vocabulary (reference xmlDefinitions.py:43-60; written
# by the reference's companion analysis repo, computed here by
# utils/metrics.evaluate and exported via store_evaluation)
MATCH_ID = "mathID"                # sic — the reference's own spelling, :43
RMS_ERROR = "rms"
TIME_MATCH = "timeMatch"
GOOD_TIME_MATCH = "goodtimeMatch"
N_TAG = "N"
M_INIT = "M_init"
N_INIT = "N_init"
LAMBDA_PHI = "lambda_phi"
TRACK_LOSS = "trackloss"
LOST_TRACK = "lostTrack"
TRACK_PERCENT = "trackPercent"
TIME_MATCH_LENGTH = "timeMatchLength"
GOOD_TIME_MATCH_LENGTH = "goodTimeMatchLength"
INITIALIZATION_LOG = "initializationLog"
CORRECT_TARGETS = "correctTargets"
FALSE_TARGETS = "falseTargets"
SS_ERROR = "ssError"
# Per-phase runtime keys (reference xmlDefinitions.py:66-74)
PHASE_TAGS = ("Total", "Init", "Cluster", "DynN", "Optim", "N-prune",
              "Process", "ILP-Prune", "Terminate")
TIME_LOG_PRECISION = 6


def write_element_to_file(path, element):
    """reference helpFunctions.writeElementToFile:86-93."""
    head, _ = os.path.split(path)
    if head and not os.path.isdir(head):
        os.makedirs(head)
    ET.ElementTree(element).write(path)


def _state_element(parent, t, x, status=None):
    e = ET.SubElement(parent, STATE, attrib={TIME: str(t)})
    pos = ET.SubElement(e, POSITION)
    ET.SubElement(pos, NORTH).text = str(round(float(x[1]), 2))
    ET.SubElement(pos, EAST).text = str(round(float(x[0]), 2))
    vel = ET.SubElement(e, VELOCITY)
    ET.SubElement(vel, NORTH).text = str(round(float(x[3]), 2))
    ET.SubElement(vel, EAST).text = str(round(float(x[2]), 2))
    if status and status != 'Active':
        e.attrib[STATE] = status
    return e


def store_ground_truth(scenario_element, sim_list, p0, radar_range,
                       radar_period, init_time):
    """Ground-truth XML (reference SimList.storeGroundTruth)."""
    gt = ET.SubElement(scenario_element, GROUNDTRUTH)
    n_targets = len(sim_list[0])
    for i in range(n_targets):
        track = ET.SubElement(gt, TRACK, attrib={ID: str(i)})
        states = ET.SubElement(track, STATES)
        count = 0
        for sample in sim_list:
            tgt = sample[i]
            in_range = tgt.in_range(p0, radar_range)
            on_radar = ((tgt.time - init_time) % radar_period) == 0.0
            if not (in_range and on_radar):
                continue
            count += 1
            e = ET.SubElement(states, STATE,
                              attrib={TIME: str(tgt.time),
                                      PD: str(tgt.P_d)})
            pos = ET.SubElement(e, POSITION)
            st = tgt.cartesian_state()
            ET.SubElement(pos, NORTH).text = str(round(float(st[1]), 2))
            ET.SubElement(pos, EAST).text = str(round(float(st[0]), 2))
            vel = ET.SubElement(e, VELOCITY)
            ET.SubElement(vel, NORTH).text = str(round(float(st[3]), 2))
            ET.SubElement(vel, EAST).text = str(round(float(st[2]), 2))
            if tgt.mmsi is not None:
                track.attrib[MMSI] = str(tgt.mmsi)
                track.attrib[AIS_CLASS] = str(tgt.ais_class)
                track.attrib[PR] = str(tgt.P_r)
            states.attrib[SIGMA_Q] = str(tgt.sigma_Q)
            track.attrib[LENGTH] = str(count)
    return gt


def store_tracker_settings(parent, shapes, params, **extra):
    """Scenario/tracker configuration for reproducibility
    (reference _storeTrackerArgs)."""
    e = ET.SubElement(parent, TRACKER_SETTINGS)
    import dataclasses
    for field in dataclasses.fields(params):
        e.attrib[field.name] = str(getattr(params, field.name))
    for field in dataclasses.fields(shapes):
        e.attrib[field.name] = str(getattr(shapes, field.name))
    for k, v in extra.items():
        e.attrib[str(k)] = str(v)
    return e


def _sinv_sequence(times, labels, params, P0=None):
    """Innovation-covariance inverses along a track, recomputed from the
    covariance recursion (the reference stores each node's S_inv,
    pyTarget.py:782-784; the recursion needs no measurements — P evolves
    deterministically given the detection pattern).  ``P0`` seeds the
    recursion with the track's TRUE initial covariance (the two-point
    initiator covariance for confirmed tracks, recorded in
    Tracker.init_P); pv.P0 is only the pre-initialized-track default."""
    from ..models import pv
    C = pv.C_RADAR("cpu").numpy().astype(np.float64)
    R = pv.R_RADAR("cpu").numpy().astype(np.float64)
    P = np.asarray(pv.P0("cpu").numpy() if P0 is None else P0, np.float64)
    out = []
    prev_t = None
    for t, lab in zip(times, labels):
        dt = params.radar_period if prev_t is None or t is None \
            else max(float(t) - float(prev_t), 0.0)
        F = pv.Phi(dt).numpy().astype(np.float64)
        Q = pv.Q(dt).numpy().astype(np.float64)
        P_bar = F @ P @ F.T + Q
        S = C @ P_bar @ C.T + R
        S_inv = np.linalg.inv(S)
        out.append(S_inv.astype(np.float32))
        if lab is not None and lab >= 1:
            K = P_bar @ C.T @ S_inv
            P = P_bar - K @ C @ P_bar
        else:
            P = P_bar
        prev_t = t
    return out


def store_run(parent, tracker, smooth=True, sparse=False,
              include_sinv=True, **attrib):
    """Per-run tracks + runtimes (reference _storeRun, tracker.py:1500-1545;
    _storeNode/_storeNodeSparse, pyTarget.py:745-829).

    ``sparse`` mirrors the reference's non-preinitialized mode: only the
    first and last states per track, no smoothed states, no S_inv.
    """
    run = ET.SubElement(parent, RUN,
                        attrib={str(k): str(v) for k, v in attrib.items()})
    # Per-phase runtime stats, reference _storeRun layout
    # (tracker.py:1512-1533): one sub-element per recorded phase with
    # mean/min/max attribs and the raw series as text.  The compiled
    # step records 'Total' every scan; per-phase series appear when the
    # caller has run Tracker.profile_phases (phase timing requires
    # de-fused execution — utils/timing.phase_profile).
    phase_log = getattr(getattr(tracker, 'runtime', None), 'log', None)
    if phase_log is None:
        phase_log = {'Total': list(tracker.runtime_log)} \
            if tracker.runtime_log else {}
    if any(v for v in phase_log.values()):
        rt_el = ET.SubElement(run, RUNTIME, attrib={
            DESCRIPTION: "Per iteration",
            PRECISION: str(TIME_LOG_PRECISION)})
        for k, v in phase_log.items():
            if not v:
                continue
            arr = np.asarray(v, np.float64)
            ET.SubElement(rt_el, str(k), attrib={
                MEAN: str(round(float(arr.mean()), TIME_LOG_PRECISION)),
                MIN: str(round(float(arr.min()), TIME_LOG_PRECISION)),
                MAX: str(round(float(arr.max()), TIME_LOG_PRECISION)),
            }).text = np.array_str(arr, precision=TIME_LOG_PRECISION,
                                   max_line_width=999999)
    smoothed = tracker.get_smooth_tracks(include_terminated=True) \
        if smooth and not sparse else {}
    seqs = tracker._track_measurement_sequences(include_terminated=True)
    statuses = {tid: a.status for tid, a in tracker.terminated.items()}
    for tid, (times, labels, states, mmsis) in seqs.items():
        track = ET.SubElement(run, TRACK, attrib={ID: str(tid)})
        track.attrib[LENGTH] = str(len(times))
        # historical MMSI (reference _getHistoricalMmsi, pyTarget.py:297-302)
        hist_mmsi = max((m for m in mmsis if m), default=0)
        if hist_mmsi:
            track.attrib[MMSI] = str(hist_mmsi)
        if tid in statuses:
            track.attrib[TERMINATED] = str(True)
        raw = ET.SubElement(track, STATES)
        if sparse:
            idxs = (0, len(times) - 1) if len(times) > 1 else (0,)
            for i in idxs:
                _state_element(raw, times[i], states[i], statuses.get(tid))
            continue
        sinvs = _sinv_sequence(times, labels, tracker.params,
                               P0=getattr(tracker, 'init_P', {}).get(tid)) \
            if include_sinv else [None] * len(times)
        for t, x, si in zip(times, states, sinvs):
            e = _state_element(raw, t, x, statuses.get(tid))
            if si is not None:
                ET.SubElement(e, S_INV).text = np.array_str(
                    si, max_line_width=9999)
        if smooth and tid in smoothed:
            pos, vel, ok = smoothed[tid]
            if ok:
                sm = ET.SubElement(track, SMOOTHED_STATES)
                for t, p, v in zip(times, pos, vel):
                    _state_element(sm, t, np.concatenate([p, v]))
    return run


def store_evaluation(run_element, metrics, initiation_log=None):
    """Write track-quality metrics into a Run element using the
    reference's analysis vocabulary (xmlDefinitions.py:43-60 — in the
    reference these tags are filled by the companion analysis repo;
    here ``metrics`` is the dict from utils/metrics.evaluate).

    ``initiation_log``: optional (n_correct, n_false) pair for the
    initializationLog element (reference correctTargets/falseTargets).
    """
    prec = TIME_LOG_PRECISION
    run_element.attrib[RMS_ERROR] = str(round(metrics['rms'], prec))
    run_element.attrib[TRACK_PERCENT] = \
        str(round(metrics['track_percent'], prec))
    run_element.attrib[TRACK_LOSS] = str(round(metrics['track_loss'], prec))
    run_element.attrib[TIME_MATCH_LENGTH] = \
        str(round(metrics.get('mean_time_match', 0.0), prec))
    if 'rms_vel' in metrics:
        run_element.attrib[SS_ERROR] = str(round(metrics['rms_vel'], prec))
    if initiation_log is not None:
        n_correct, n_false = initiation_log
        ET.SubElement(run_element, INITIALIZATION_LOG, attrib={
            CORRECT_TARGETS: str(int(n_correct)),
            FALSE_TARGETS: str(int(n_false))})
    elif 'n_false_tracks' in metrics:
        ET.SubElement(run_element, INITIALIZATION_LOG, attrib={
            CORRECT_TARGETS: str(int(metrics.get('n_tracked', 0))),
            FALSE_TARGETS: str(int(metrics['n_false_tracks']))})
    return run_element

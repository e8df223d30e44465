"""Scan-level checkpoint/resume of the full tracker (counterpart of
pymht_tpu/utils/checkpoint.py, same file format).

The whole tracker (device state, initiator state, host archives, scan
history, config) serialises to a single .npz + JSON sidecar, enabling
exact scan-level resume (bitwise: all device state is concrete arrays,
no RNG lives in the tracker itself).  The .npz holds ``state.<field>``,
``init.<field>`` and ``scan.<i>``; the field names of TrackerState and
InitiatorState are the JAX package's, so a checkpoint written by either
package loads in the other.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from ..core.config import TrackerShapes, TrackerParams
from ..core.state import (TrackerState, initiator_from_numpy,
                          initiator_to_numpy, state_from_numpy,
                          state_to_numpy)
from ..core.tracker import Tracker, TrackArchive, _resolve_device
from ..parallel.sharded_tracker import PER_TARGET_FIELDS, rows_of


def _arrays(state, init_state) -> dict:
    arrays = {f"state.{k}": v for k, v in state_to_numpy(state).items()}
    arrays.update({f"init.{k}": v
                   for k, v in initiator_to_numpy(init_state).items()})
    return arrays


def _restore(data, device, shard=None):
    def fields(prefix):
        return {k[len(prefix):]: data[k] for k in data.files
                if k.startswith(prefix)}
    state = fields("state.")
    if shard is not None:       # this rank's rows, cut on the host
        T = state["tgt_mask"].shape[0]
        state.update({k: rows_of(state[k], shard, T)
                      for k in PER_TARGET_FIELDS})
    return (state_from_numpy(state, device),
            initiator_from_numpy(fields("init."), device))


def _make_parent(path):
    head = os.path.dirname(path)
    if head and not os.path.isdir(head):
        os.makedirs(head)


def save(tracker: Tracker, path: str):
    """The whole tracker to ``path``.npz and ``path``.json.  Outputs
    still pending on the device (``pipeline_outputs``) are absorbed
    first."""
    tracker.flush()
    _make_parent(path)
    arrays = _arrays(tracker.state, tracker.init_state)
    for i, z in enumerate(tracker.scan_history):
        arrays[f"scan.{i}"] = z
    np.savez_compressed(path + ".npz", **arrays)

    def arch_dict(a):
        return {"track_id": a.track_id,
                "times": [float(t) if t is not None else None
                          for t in a.times],
                "states": [np.asarray(s).tolist() for s in a.states],
                "meas": [int(m) for m in a.meas],
                "mmsi": [int(m) for m in a.mmsi],
                "status": a.status}

    meta = {
        "shapes": dataclasses.asdict(tracker.shapes),
        "params": _params_dict(tracker.params),
        "method": tracker.method,
        "t0": tracker.t0,
        "scan_times": [float(t) for t in tracker.scan_times],
        "runtime_log": [float(t) for t in tracker.runtime_log],
        "archives": {str(k): arch_dict(v) for k, v in tracker.archives.items()},
        "terminated": {str(k): arch_dict(v)
                       for k, v in tracker.terminated.items()},
        "n_scans": len(tracker.scan_history),
    }
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def _params_dict(params: TrackerParams) -> dict:
    """``params`` as the JAX package writes them, with the port's own
    ``selection_gap`` only where it is not its default: a default file
    loads in either package, and one that asks for another gap only in
    the port (the JAX package certifies none)."""
    d = dataclasses.asdict(params)
    if d["selection_gap"] == TrackerParams.selection_gap:
        del d["selection_gap"]
    return d


def save_state(path: str, state: TrackerState, init_state):
    """Snapshot bare device state: the checkpoint primitive for the
    device-resident streaming mode (between ``scan_many`` dispatches)."""
    _make_parent(path)
    np.savez_compressed(path + ".npz", **_arrays(state, init_state))


def load_state(path: str, device=None, shard=None):
    """Restore (TrackerState, InitiatorState) saved by ``save_state``
    onto ``device`` (None: the GPU, as everywhere in the port).  With
    ``shard``, a ``parallel.collectives.Axis`` over which the targets are
    split (the JAX function's ``shardings``), this rank restores only its
    rows of the per-target fields (``parallel.sharded_tracker.
    shard_state``'s layout) and the replicated fields whole: a file
    written by either package, sharded or not, resumes sharded."""
    return _restore(np.load(path + ".npz"), _resolve_device(device), shard)


def load(path: str, device=None) -> Tracker:
    """A Tracker resumed from ``save``'s files on ``device`` (None: the
    GPU).  The options that are not part of the file (``use_ais``,
    ``prune_similar``, ...) take the constructor's defaults, as in the
    JAX package; set them on the returned tracker."""
    with open(path + ".json") as f:
        meta = json.load(f)
    # a file written by the JAX package may carry config fields that the
    # port leaves out
    names = {f.name for f in dataclasses.fields(TrackerShapes)}
    shapes = TrackerShapes(**{k: v for k, v in meta["shapes"].items()
                              if k in names})
    params_d = meta["params"]
    params_d["position"] = tuple(params_d["position"])
    params = TrackerParams(**params_d)
    tracker = Tracker(shapes, params, method=meta["method"], device=device)
    data = np.load(path + ".npz")
    tracker.state, tracker.init_state = _restore(data, tracker.device)
    tracker.t0 = meta["t0"]
    tracker.scan_times = list(meta["scan_times"])
    tracker.runtime_log = list(meta["runtime_log"])
    tracker.scan_history = [data[f"scan.{i}"] for i in range(meta["n_scans"])]

    def mk_arch(d):
        return TrackArchive(track_id=d["track_id"], times=list(d["times"]),
                            states=[np.asarray(s, np.float32)
                                    for s in d["states"]],
                            meas=list(d["meas"]), mmsi=list(d["mmsi"]),
                            status=d["status"])

    tracker.archives = {int(k): mk_arch(v)
                        for k, v in meta["archives"].items()}
    tracker.terminated = {int(k): mk_arch(v)
                          for k, v in meta["terminated"].items()}
    return tracker

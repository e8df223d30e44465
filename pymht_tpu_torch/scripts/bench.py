"""Headline benchmark: ms/scan for a 100-target high-clutter scan
(gating + hypothesis-tree growth + global hypothesis selection +
pruning + initiation) on one GPU (counterpart of bench.py).

    python -m pymht_tpu_torch.scripts.bench [--device cpu]

Four paths on bench.py's scenes (``utils/scenes.bench_scene``: 100
seeded targets in T=128 slots, L=32, M=512, W=7, seed 1234, 12 scans;
``bench_scene_ais``: the same shapes with A=32, G=2, seed 4321):

  A   one ``Tracker.add_measurement_list`` per scan over all 13 simulated
      scans (``pipeline_outputs``: a scan's outputs are fetched during
      the next); ``dispatch_ms_per_scan`` is the median wall from the
      third scan on.  The median dual gap (objective against the
      Lagrangian bound) over its scans, and the gap of the last forest's
      selection against the exact HiGHS oracle;
  B   the first 12 scans on the device, streamed through ``scan_many``
      from the same input state a warm-up and 3 times: ``value`` is the
      median wall over the scan count (the production pattern);
  B2  path B with ``compute_clusters=True`` (the cluster diagnostics);
  C   the AIS scene streamed as path B with the AIS branch on.

Every wall is closed by a device synchronise.  Prints one JSON line with
the JAX script's keys (``vs_baseline`` = the 10 ms/scan budget of
BASELINE.json over ``value``), the card's name and power limit under
``hardware``, and per path the host reads and K1 launches per scan
(``sync.count``, ``gate_kernel.launches``; 0 launches on the CPU, which
runs K1's plain twin).

Knobs (environment, as the JAX script's): BENCH_TARGETS=100
BENCH_SCANS=12 BENCH_MEAS=512 (M and the initiator capacity)
BENCH_METHOD=lagrangian BENCH_PREGATE=0 (the per-target pre-gate width
Km; 0 = off) BENCH_AIS=32 (A of path C).
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from .. import sync
from ..core.grow import AisBatch, empty_ais
from ..core.tracker import (StepOutputs, Tracker, outputs_to_host,
                            scan_many)
from ..ops import gate_kernel as gk
from ..utils import scenes
from ..utils.oracle import selection_gap
from . import _common

BUDGET_MS = 10.0    # BASELINE.json's north star, ms/scan

# the knobs at their defaults: bench.py's
DEFAULTS = dict(n_targets=100, n_scans=12, meas=512, method="lagrangian",
                pregate=0, a_cap=32)
_ENV = dict(n_targets="BENCH_TARGETS", n_scans="BENCH_SCANS",
            meas="BENCH_MEAS", method="BENCH_METHOD", pregate="BENCH_PREGATE",
            a_cap="BENCH_AIS")


def knobs() -> dict:
    """DEFAULTS, each overridden by its environment variable."""
    return {name: type(DEFAULTS[name])(os.environ.get(var, DEFAULTS[name]))
            for name, var in _ENV.items()}


def radar_scene(k: dict):
    return scenes.bench_scene(k["n_targets"], k["n_scans"],
                              max_meas=k["meas"],
                              radar_cand_width=k["pregate"])


def ais_scene(k: dict):
    return scenes.bench_scene_ais(k["n_targets"], k["n_scans"],
                                  max_ais=k["a_cap"], max_meas=k["meas"],
                                  radar_cand_width=k["pregate"])


def dispatch(device, k: dict, scene):
    """Path A: one call per scan.  Returns (walls [s], host reads, K1
    launches, the tracker after ``flush``, its outputs stacked on a scan
    axis, on the host)."""
    shapes, params, scans, _, seeds = scene
    tracker = Tracker(shapes, params, method=k["method"], use_ais=False,
                      pipeline_outputs=True, device=device)
    tracker.pre_initialize(scans[0].time - params.radar_period, seeds)
    walls, outs = [], []
    r0, l0 = sync.count, gk.launches
    for s in scans:
        t0 = time.perf_counter()
        out = tracker.add_measurement_list(s.time, s.measurements)
        _common.synchronize(device)
        walls.append(time.perf_counter() - t0)
        outs.append(out)
    tracker.flush()
    reads, launches = sync.count - r0, gk.launches - l0
    stacked = StepOutputs(*[torch.stack(f) for f in zip(*outs)])
    return walls, reads, launches, tracker, outputs_to_host(stacked)


def radar_stream_inputs(device, k: dict, scene):
    """Path B's inputs: (a Tracker pre-initialised with the seeds, the
    first BENCH_SCANS scans as one device-resident Scan, an empty AIS
    batch on the same axis).  Every time is relative to the tracker's
    origin ``t0``: another base shifts the first scan's dt and breaks
    the pre-initialised tracks."""
    shapes, params, scans, _, seeds = scene
    tracker = Tracker(shapes, params, method=k["method"], use_ais=False,
                      device=device)
    tracker.pre_initialize(scans[0].time - params.radar_period, seeds)
    scan_b, _ = tracker.make_stream_inputs(scans[:k["n_scans"]])
    S = scan_b.z.shape[0]
    ais_b = AisBatch(*(f.expand((S,) + f.shape)
                       for f in empty_ais(shapes, tracker.device)))
    return tracker, scan_b, ais_b


def ais_stream_inputs(device, k: dict, scene):
    """Path C's inputs: (a Tracker pre-initialised with the seeds and
    MMSIs, the first BENCH_SCANS scans, their AIS groups, each cut to its
    first A messages), times relative to the tracker's origin."""
    shapes, params, scans, groups, _, seeds, mmsi = scene
    tracker = Tracker(shapes, params, method=k["method"], use_ais=True,
                      device=device)
    tracker.pre_initialize(scans[0].time - params.radar_period, seeds,
                           mmsi=mmsi)
    scan_b, ais_b = tracker.make_stream_inputs(scans[:k["n_scans"]],
                                               groups[:k["n_scans"]])
    return tracker, scan_b, ais_b


def streamed(tracker, scan_b, ais_b, use_ais: bool,
             compute_clusters: bool = False, reps: int = 3):
    """``scan_many`` over the inputs from the tracker's state, a warm-up
    and ``reps`` times.  Returns (walls [s], host reads and K1 launches
    of the last call, its stacked outputs on the host)."""
    counts = []

    def once():
        r0, l0 = sync.count, gk.launches
        out = scan_many(tracker.state, tracker.init_state, scan_b, ais_b,
                        tracker.shapes, tracker.params, method=tracker.method,
                        use_ais=use_ais, compute_clusters=compute_clusters)
        counts.append((sync.count - r0, gk.launches - l0))
        return out

    walls, out = _common.timed(once, tracker.device, reps=reps)
    return walls, counts[-1][0], counts[-1][1], outputs_to_host(out[2])


def median_dual_gap(outs: StepOutputs) -> float:
    """Median over scans of (objective - bound) / max(1, |bound|), over
    the scans where both are finite (0 if none is)."""
    obj = outs.sel_obj.astype(np.float64)
    bound = outs.sel_bound.astype(np.float64)
    ok = np.isfinite(obj) & np.isfinite(bound)
    gaps = (obj - bound)[ok] / np.maximum(1.0, np.abs(bound[ok]))
    return float(np.median(gaps)) if gaps.size else 0.0


def run(device, k: dict = None, reps: int = 3):
    """The benchmark on ``device``: (the JSON line's dict, each path's
    stacked step outputs as numpy, by path: "A", "B", "B2", "C")."""
    k = knobs() if k is None else k
    scene = radar_scene(k)
    shapes, params = scene[:2]

    walls_a, reads_a, launches_a, tracker, outs_a = dispatch(device, k,
                                                             scene)
    n_a = len(walls_a)
    dispatch_ms = float(np.median(walls_a[2:]) * 1000.0)
    gap = median_dual_gap(outs_a)
    oracle_gap = selection_gap(tracker.state, shapes, params)

    inputs = radar_stream_inputs(device, k, scene)
    S = inputs[1].z.shape[0]
    walls_b, reads_b, launches_b, outs_b = streamed(*inputs, False,
                                                    reps=reps)
    walls_b2, _, launches_b2, outs_b2 = streamed(*inputs, False, True,
                                                 reps=reps)
    del inputs

    scene_c = ais_scene(k)
    walls_c, _, launches_c, outs_c = streamed(
        *ais_stream_inputs(device, k, scene_c), True, reps=reps)
    groups = scene_c[3]
    n_msgs = [len(groups[i]) if i < len(groups) else 0 for i in range(S)]

    def per_scan_ms(walls):
        return float(np.median(walls) / S * 1000.0)

    stream_ms = per_scan_ms(walls_b)
    result = {
        "metric": "ms_per_scan_100tgt_highclutter",
        "value": round(stream_ms, 3),
        "unit": "ms",
        "vs_baseline": round(BUDGET_MS / stream_ms, 4),
        "dispatch_ms_per_scan": round(dispatch_ms, 3),
        "ais_ms_per_scan": round(per_scan_ms(walls_c), 3),
        "clusters_on_ms_per_scan": round(per_scan_ms(walls_b2), 3),
        "ais_msgs_per_scan": round(float(np.mean(n_msgs)), 1),
        "median_dual_gap": round(gap, 6),
        "opt_gap_vs_exact_oracle": (round(oracle_gap, 6)
                                    if oracle_gap is not None else None),
        "n_targets": k["n_targets"],
        "method": k["method"],
        "hardware": _common.hardware(device),
        "host_reads_per_scan": {"A": reads_a / n_a, "B": reads_b / S},
        "k1_launches_per_scan": {"A": launches_a / n_a, "B": launches_b / S,
                                 "B2": launches_b2 / S,
                                 "C": launches_c / S},
    }
    return result, {"A": outs_a, "B": outs_b, "B2": outs_b2, "C": outs_c}


def main(argv=None):
    """Prints the JSON line; returns ``run``'s result."""
    args = _common.parser(__doc__).parse_args(argv)
    device = _common.device_of(args.device, "bench")
    result, outs = run(device)
    print(json.dumps(result), flush=True)
    return result, outs


if __name__ == "__main__":
    main()

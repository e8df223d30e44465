"""Saturation curve: ms/scan against the target count at a fixed load per
target on one GPU (counterpart of bench_saturation.py).

    python -m pymht_tpu_torch.scripts.bench_saturation [--device cpu]

The scene area grows with T (``utils/scenes.saturation_scene``: a radar
of 12 km x sqrt(T / 1024), M = 2T), so the measurement density per
target stays constant (~1.8 returns per target with clutter).  For each
T it times, per scan (median of SAT_REPS streamed runs of SAT_SCANS
scans after a warm-up, each closed by a device synchronise):

  grow        — the candidate planes and the beam (the [T, L, M] work)
  grow+select — plus the tiered global selection
  full        — the production ``scan_many`` step

so that the knee, and the phase that dominates past it, show in the
deltas.  Prints one JSON line per point and a summary line that names
the bottleneck phase at the largest T.  Each row also reports the
one-to-one truth coverage and rms (Hungarian, 20 m gate), so that what a
degraded or pre-gated mode costs in quality is measured.

Knobs (environment, as the JAX script's): SAT_POINTS="256,512,1024,2048,
4096" SAT_SCANS=4 SAT_REPS=3 SAT_BEAM=16 (8: the degraded half beam)
SAT_PREGATE=0 (the per-target pre-gate width Km; 0 = off).  A point too
large for the card's memory gives a row with its error.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..core.grow import grow
from ..core.select import select
from ..core.tracker import Tracker, outputs_to_host, scan_many
from ..utils import scenes
from . import _common


def knobs() -> dict:
    env = os.environ.get
    return dict(points=[int(x) for x in env(
        "SAT_POINTS", "256,512,1024,2048,4096").split(",")],
        n_scans=int(env("SAT_SCANS", "4")), reps=int(env("SAT_REPS", "3")),
        beam=int(env("SAT_BEAM", "16")),
        pregate=int(env("SAT_PREGATE", "0")))


def run_point(T_cap: int, device, k: dict) -> dict:
    n_scans, reps = k["n_scans"], k["reps"]
    shapes, params, scans, sim_list, seeds = scenes.saturation_scene(
        T_cap, beam=k["beam"], pregate=k["pregate"], n_scans=n_scans)
    tracker = Tracker(shapes, params, method="lagrangian", use_ais=False,
                      device=device)
    tracker.pre_initialize(scans[0].time - params.radar_period, seeds)
    scan_b, ais_b = tracker.make_stream_inputs(scans)
    n_meas = float(np.mean([len(s.measurements) for s in scans]))
    st, ist = tracker.state, tracker.init_state
    per_scan = [type(scan_b)(*(f[i] for f in scan_b))
                for i in range(n_scans)]

    def ms_of(fn):
        walls, _ = _common.timed(fn, device, reps=reps)
        return float(np.median(walls) / n_scans * 1000.0)

    def grow_only():
        s = st
        for sc in per_scan:
            s = grow(s, sc, None, shapes, params).state
        return s

    def grow_sel():
        s = st
        for sc in per_scan:
            s = grow(s, sc, None, shapes, params).state
            res = select(s, shapes, params, method="lagrangian",
                         compute_clusters=False)
            s = s.replace(sel_leaf=res.sel, lam=res.lam)
        return s

    def full():
        return scan_many(st, ist, scan_b, ais_b, shapes, params,
                         method="lagrangian", use_ais=False)

    ms_grow, ms_gsel, ms_full = ms_of(grow_only), ms_of(grow_sel), ms_of(full)
    outs = outputs_to_host(full()[2])
    coverage, rms = _common.one_to_one(
        outs.track_x, outs.track_mask, _common.truth_of(sim_list, n_scans))
    return dict(targets=T_cap, meas_per_scan=round(n_meas, 1),
                beam=k["beam"], pregate=k["pregate"],
                grow_ms=round(ms_grow, 3),
                select_ms=round(ms_gsel - ms_grow, 3),
                rest_ms=round(ms_full - ms_gsel, 3),
                full_ms=round(ms_full, 3),
                us_per_target=round(1000.0 * ms_full / T_cap, 2),
                coverage=round(coverage, 4), rms_m=round(rms, 2))


def main(argv=None):
    args = _common.parser(__doc__).parse_args(argv)
    device = _common.device_of(args.device, "bench_saturation")
    k = knobs()
    rows = []
    for T_cap in k["points"]:
        try:
            r = run_point(T_cap, device, k)
        except torch.cuda.OutOfMemoryError as e:
            torch.cuda.empty_cache()
            r = dict(targets=T_cap, error=str(e)[:200])
        rows.append(r)
        print(json.dumps({"metric": "saturation_point", **r}), flush=True)
    ok = [r for r in rows if "error" not in r]
    if len(ok) >= 2:
        # knee: the largest T whose us/target stays within 1.5x the best
        best = min(r["us_per_target"] for r in ok)
        knee = max(r["targets"] for r in ok
                   if r["us_per_target"] <= 1.5 * best)
        last = ok[-1]
        phases = {"grow": last["grow_ms"], "select": last["select_ms"],
                  "lifecycle+init": last["rest_ms"]}
        print(json.dumps({
            "metric": "chip_saturation_curve",
            "points": rows, "knee_targets": knee,
            "bottleneck_at_max": max(phases, key=phases.get),
            "hardware": (_common.hardware(device)
                         + ", device-resident streaming"),
        }), flush=True)


if __name__ == "__main__":
    main()

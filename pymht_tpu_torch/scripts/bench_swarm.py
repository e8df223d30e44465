"""Swarm-scale benchmark: 1000 targets with AIS priors on one GPU
(counterpart of bench_swarm.py; BASELINE config 5, "1000-target swarm
with AIS priors").

    python -m pymht_tpu_torch.scripts.bench_swarm [--device cpu]

Streams the scene of ``utils/scenes.swarm_scene`` (T=1024 slots, L=16,
M=2048, A=128, W=6, G=2, the per-target pre-gate at Km=64, 8 scans)
through ``scan_many`` with ``method='lagrangian'``: grow with the
two-stage AIS fusion, the tiered selection, lifecycle and initiation,
every scan on the device with nothing fetched in between.  The wall is
the median of 3 repetitions after a warm-up, each closed by a device
synchronise.  Then: the median dual gap; the one-to-one Hungarian
coverage and rms against truth at a 20 m gate; the selection of one
swarm forest (the first N-1 scans streamed, the last grown) against the
exact HiGHS oracle under a time limit; and every track smoothed in one
batched call.  Prints one JSON line with the JAX script's keys, the
card's name and power limit under ``hardware``, the host reads per scan
(``sync.count``) and K1's launches per scan.

Knobs (environment, as the JAX script's): SWARM_TARGETS=1000
SWARM_SCANS=8 SWARM_MEAS=2048 SWARM_AIS=128 SWARM_USE_AIS=1 SWARM_DYNWIN=0
SWARM_PREFILTER=0 SWARM_PREGATE=64 SWARM_ORACLE=1 SWARM_ORACLE_LIMIT=900.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from .. import sync
from ..core.grow import grow
from ..core.select import select
from ..core.tracker import Tracker, outputs_to_host, scan_many
from ..models import pv
from ..ops import gate_kernel as gk
from ..ops.smoother import smooth_tracks
from ..utils import scenes
from ..utils.oracle import milp_select_oracle
from . import _common


# the knobs at their defaults: bench_swarm.py's
DEFAULTS = dict(n_targets=1000, n_scans=8, m_cap=2048, a_cap=128,
                use_ais=True, dyn_win=False, prefilter=0, pregate=64,
                oracle=True, oracle_limit=900.0)
_ENV = dict(n_targets="SWARM_TARGETS", n_scans="SWARM_SCANS",
            m_cap="SWARM_MEAS", a_cap="SWARM_AIS", use_ais="SWARM_USE_AIS",
            dyn_win="SWARM_DYNWIN", prefilter="SWARM_PREFILTER",
            pregate="SWARM_PREGATE", oracle="SWARM_ORACLE",
            oracle_limit="SWARM_ORACLE_LIMIT")


def knobs() -> dict:
    """DEFAULTS, each overridden by its environment variable (flags as
    "0" / "1")."""
    k = dict(DEFAULTS)
    for name, var in _ENV.items():
        if var in os.environ:
            v = os.environ[var]
            k[name] = (v == "1" if isinstance(DEFAULTS[name], bool)
                       else type(DEFAULTS[name])(v))
    return k


def scene_of(k: dict) -> scenes.SwarmScene:
    return scenes.swarm_scene(k["n_targets"], k["n_scans"], k["m_cap"],
                              k["a_cap"], k["pregate"], k["use_ais"],
                              ais_prefilter=k["prefilter"])


def stream_inputs(scene: scenes.SwarmScene, device, use_ais: bool,
                  n_scans: int = None):
    """(Tracker pre-initialised with the scene's seeds and MMSIs, Scan,
    AisBatch) of the first ``n_scans`` scans, on ``device`` after one
    transfer."""
    scans = scene.scans[:n_scans]
    tracker = Tracker(scene.shapes, scene.params, method="lagrangian",
                      use_ais=use_ais, device=device)
    tracker.pre_initialize(scans[0].time - scene.params.radar_period,
                           scene.seeds, mmsi=scene.mmsi)
    scan_b, ais_b = tracker.make_stream_inputs(scans,
                                               scene.ais_groups[:len(scans)])
    return tracker, scan_b, ais_b


def stream(tracker, scan_b, ais_b, use_ais, dyn_win=False):
    """One ``scan_many`` over the inputs from the tracker's state."""
    return scan_many(tracker.state, tracker.init_state, scan_b, ais_b,
                     tracker.shapes, tracker.params, method="lagrangian",
                     use_ais=use_ais, dynamic_window=dyn_win)


def oracle_gap(scene, device, use_ais: bool, limit: float):
    """The device selection of one swarm forest (the first N-1 scans
    streamed, the last grown) against the HiGHS oracle: (gap or None,
    proven optimal)."""
    n = len(scene.scans)
    tracker, scan_b, ais_b = stream_inputs(scene, device, use_ais)
    part = [type(scan_b)(*(f[:n - 1] for f in scan_b)),
            type(ais_b)(*(f[:n - 1] for f in ais_b))]
    st, _, _ = stream(tracker, *part, use_ais)
    last = type(scan_b)(*(f[n - 1] for f in scan_b))
    a_last = type(ais_b)(*(f[n - 1] for f in ais_b)) if use_ais else None
    g = grow(st, last, a_last, scene.shapes, scene.params)
    res = select(g.state, scene.shapes, scene.params, method="lagrangian",
                 compute_clusters=False)
    obj_dev = float(res.obj)
    _, obj_o, optimal = milp_select_oracle(g.state, scene.shapes,
                                           scene.params, time_limit=limit)
    gap = ((obj_dev - obj_o) / max(1.0, abs(obj_o))
           if np.isfinite(obj_o) else None)
    return gap, bool(optimal)


def smooth_ms(scene, device):
    """Wall ms of one batched RTS smoothing of every target's truth
    positions, after a warm-up (bench_swarm.py:193-215)."""
    n_tgt = len(scene.x0)
    n = max(len(scene.scans), 2)
    zs = np.stack([[s[k].cartesian_state()[:2] for s in scene.sim_list[:n]]
                   for k in range(n_tgt)]).astype(np.float32)
    mk = scene.rng.random((n_tgt, n)) < 0.9
    args = (torch.from_numpy(scene.x0).to(device),
            pv.P0(device).expand(n_tgt, 4, 4).contiguous(),
            torch.from_numpy(zs).to(device), torch.from_numpy(mk).to(device))
    period = scene.params.radar_period
    walls, _ = _common.timed(lambda: smooth_tracks(*args, period), device,
                             reps=1)
    return 1000.0 * walls[0]


def run(device, k: dict = None, scene=None, reps: int = 3):
    """The benchmark on ``device``: (the JSON line's dict, the stacked step
    outputs of the last repetition as numpy)."""
    k = knobs() if k is None else k
    scene = scene_of(k) if scene is None else scene
    n_scans = len(scene.scans)
    use_ais = k["use_ais"]
    tracker, scan_b, ais_b = stream_inputs(scene, device, use_ais)
    counts = []

    def once():
        r0, l0 = sync.count, gk.launches
        out = stream(tracker, scan_b, ais_b, use_ais, k["dyn_win"])
        counts.append((sync.count - r0, gk.launches - l0))
        return out

    walls, out = _common.timed(once, device, reps=reps)
    ms = float(np.median(walls) / n_scans * 1000.0)
    reads, launches = counts[-1]
    final_state, _, outs = out
    outs = outputs_to_host(outs)
    gaps = outs.sel_obj - outs.sel_bound
    rel = float(np.median(gaps / np.maximum(1.0, np.abs(outs.sel_bound))))
    tw = final_state.tgt_window[final_state.tgt_mask].cpu().numpy()
    win_stats = ({"mean": round(float(tw.mean()), 2), "min": int(tw.min()),
                  "max": int(tw.max()),
                  "shrunk_frac": round(float((tw < scene.params.N).mean()),
                                       3)}
                 if k["dyn_win"] and tw.size else None)
    coverage, rms = _common.one_to_one(outs.track_x, outs.track_mask,
                                       _common.truth_of(scene.sim_list,
                                                        n_scans))
    gap, optimal = (oracle_gap(scene, device, use_ais, k["oracle_limit"])
                    if k["oracle"] else (None, None))
    groups = scene.ais_groups
    period = scene.params.radar_period
    result = {
        "metric": "ms_per_scan_1000tgt_ais_swarm",
        "value": round(ms, 3),
        "unit": "ms",
        "vs_real_time": round(period * 1000.0 / ms, 1),
        "n_targets": len(scene.seeds),
        "tracks_alive_last_scan": int(outs.track_mask[-1].sum()),
        "mean_meas_per_scan": round(float(np.mean(
            [len(s.measurements) for s in scene.scans])), 1),
        "mean_ais_per_scan": round(float(np.mean(
            [len(groups[i]) if i < len(groups) else 0
             for i in range(n_scans)])), 1),
        "median_dual_gap": round(rel, 6),
        "opt_gap_vs_exact_oracle": (round(gap, 6) if gap is not None
                                    else None),
        "oracle_proven_optimal": optimal,
        "truth_coverage": round(coverage, 4),
        "rms_matched_m": round(rms, 3),
        "dynamic_window": win_stats,
        "smooth_1000tracks_one_dispatch_ms": round(smooth_ms(scene, device),
                                                   2),
        "hardware": _common.hardware(device) + ", device-resident streaming",
        "host_reads_per_scan": reads / n_scans,
        "k1_launches_per_scan": launches / n_scans,
    }
    return result, outs


def main(argv=None):
    args = _common.parser(__doc__).parse_args(argv)
    device = _common.device_of(args.device, "bench_swarm")
    result, _ = run(device)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()

"""Where a scan step's time goes on the GPU.

    python -m pymht_tpu_torch.profile_step        # needs a CUDA device
    python -m pymht_tpu_torch.profile_step --ais  # the AIS-fusion scene
    python -m pymht_tpu_torch.profile_step --ais --pregate 64
    python -m pymht_tpu_torch.profile_step --prune-similar --dynamic-window
    python -m pymht_tpu_torch.profile_step --method ipm

Runs the radar-only bench scene (``Tracker(use_ais=False)``) or, with
``--ais``, the AIS-fusion scene (``Tracker(use_ais=True)``, A=32, G=2;
utils/scenes.py) through the port's Tracker on the card; ``--pregate Km``
sets ``radar_cand_width``; ``--method`` names the selection solver
(default ``'lagrangian'``, the production hybrid); ``--prune-similar`` and ``--dynamic-window``
turn on ``scan_step``'s arguments of those names (the stepped Tracker
hands the step only the first; the second is streaming's, given to the
step here so that its device work can be read beside the rest).  Over the
steady scans (3 onwards) it reports:

* per phase (grow, select, terminate + prune, initiate), the wall time of
  that phase alone, run on the step's own inputs and closed by
  ``torch.cuda.synchronize()`` — the step itself is then run unchanged;
* a ``torch.profiler`` trace of the whole steps: device time by kernel,
  device busy time per scan and the device's idle share of the window.

Prints one JSON object.  Nothing here runs on the tracker's hot path.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import sys
import time

import numpy as np
import torch

from . import sync
from .core import initiator as initiator_mod
from .core.grow import grow
from .core.lifecycle import n_scan_prune, terminate
from .core.merge import prune_similar
from .core.select import select
from .core.tracker import Tracker
from .utils.scenes import bench_scene, bench_scene_ais


def _phase_times(tr: Tracker, packed):
    """Wall ms of each phase of the next step, run alone on its inputs."""
    scan, ais = tr._unpack_inputs(packed)
    shapes, params = tr.shapes, tr.params
    out, t = {}, time.perf_counter()

    def lap(name):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        out[name] = 1e3 * (now - t)
        t = now

    n_sync = sync.count
    g = grow(tr.state, scan, ais, shapes, params)
    if tr.prune_similar:
        g = g._replace(state=prune_similar(g.state, shapes, params))
    lap("grow")
    res = select(g.state, shapes, params, method=tr.method)
    lap("select")
    st = g.state.replace(sel_leaf=res.sel, lam=res.lam)
    st = n_scan_prune(terminate(st, shapes, params).state, shapes,
                      params).state
    lap("terminate_prune")
    # (the used-MMSI filter of scan_step, a handful of ops, is left out)
    initiator_mod.step(tr.init_state, scan.z, scan.mask & ~g.used_meas,
                       scan.time, ais, shapes, params)
    lap("initiate")
    out["host_syncs_grow_select_prune_initiate"] = sync.count - n_sync
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ais", action="store_true",
                    help="the AIS-fusion scene through Tracker(use_ais=True)")
    ap.add_argument("--pregate", type=int, default=0, metavar="Km",
                    help="radar_cand_width (0: no spatial pre-gate)")
    ap.add_argument("--method", default="lagrangian",
                    choices=("lagrangian", "ipm", "lagrangian_pure",
                             "greedy"),
                    help="the selection solver (default: lagrangian)")
    ap.add_argument("--prune-similar", action="store_true",
                    help="merge similar sibling hypotheses after grow")
    ap.add_argument("--dynamic-window", action="store_true",
                    help="the on-device window trigger in every step")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.ais:
        shapes, params, scans, groups, _, seeds, mmsi = bench_scene_ais()
    else:
        shapes, params, scans, _, seeds = bench_scene()
        groups, mmsi = [], None
    shapes = dataclasses.replace(shapes, radar_cand_width=args.pregate)

    def messages(i):
        return groups[i] if i < len(groups) else []

    def new_tracker():
        tr = Tracker(shapes, params, method=args.method, use_ais=args.ais,
                     device="cuda", prune_similar=args.prune_similar)
        tr.pre_initialize(scans[0].time - params.radar_period, seeds,
                          mmsi=mmsi)
        if args.dynamic_window:
            tr._step = functools.partial(tr._step, dynamic_window=True)
        return tr

    # pass 1: each phase of each steady step, timed alone
    tr, phases = new_tracker(), []
    for i, s in enumerate(scans):
        if i >= 2:
            packed = tr._pack_inputs(float(s.time) - tr.t0, s.measurements,
                                     messages(i))
            phases.append(_phase_times(tr, packed))
        tr.add_measurement_list(s.time, s.measurements, messages(i))
    # pass 2: the unchanged steps under the profiler
    tr = new_tracker()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    for i, s in enumerate(scans):
        if i == 2:
            torch.cuda.synchronize()
            prof.__enter__()
            t_window = time.perf_counter()
        tr.add_measurement_list(s.time, s.measurements, messages(i))
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t_window)
    prof.__exit__(None, None, None)
    n = len(scans) - 2

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    from torch.autograd import DeviceType
    events = [e for e in prof.key_averages()      # kernels and copies
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:20]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "scene": "ais" if args.ais else "radar",
        "method": args.method,
        "radar_cand_width": args.pregate,
        "prune_similar": args.prune_similar,
        "dynamic_window": args.dynamic_window,
        "ais_messages_per_scan": [min(len(messages(i)), shapes.max_ais)
                                  for i in range(len(scans))],
        "scans_profiled": n,
        "wall_ms_per_scan": wall_ms / n,
        "device_busy_ms_per_scan": busy_ms / n,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "phase_ms_median": {k: float(np.median([p[k] for p in phases]))
                            for k in phases[0]},
        "host_syncs_per_scan": tr.host_syncs,
        "device_ops_per_scan": sum(e.count for e in events) / n,
        "k1": [{"name": e.key[:90], "device_ms_per_call":
                dev_us(e) / 1e3 / e.count, "calls_per_scan": e.count / n}
               for e in events if "gate_score" in e.key],
        "top_device_ops": [
            {"name": e.key[:90], "device_ms_per_scan": dev_us(e) / 1e3 / n,
             "calls_per_scan": e.count / n} for e in top],
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

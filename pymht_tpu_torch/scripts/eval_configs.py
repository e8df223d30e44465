"""Tracking-quality evaluation over the BASELINE.json scenario families
(counterpart of eval_configs.py).

    python -m pymht_tpu_torch.scripts.eval_configs [--device cpu]

Runs scaled versions of the five benchmark configurations and prints one
JSON line per configuration with its tracking metrics (rms, coverage,
track loss, false tracks) and the selection-gap certificate.
EVAL_SCALE=full runs the full-size configurations; EVAL_OUT=<path> also
writes every line to one JSON file.

  1. 2-target crossing, no clutter, P_d=1
  2. 10 targets, clutter, P_d=0.9
  3. 50 targets, dense clutter, N=3 (24 at the small scale)
  4. Monte-Carlo batch of scenarios (batched on the device)
  5. swarm with AIS priors (scaled)
  and ``2_ipm_xcheck``: configuration 2 under the interior-point solver.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from ..core.config import TrackerParams, TrackerShapes
from ..core.tracker import Tracker
from ..parallel import montecarlo as mc
from ..utils import simulator as sim
from ..utils.ais_io import AisMessageStream
from ..utils.metrics import evaluate
from . import _common


def build_scene(n_targets, clutter, P_d, N, shapes_kw, n_scans=16,
                radar_range=1000.0, use_ais=False, seed=7):
    """The deterministic scenario and configuration of one family:
    (shapes, params, sim_list, scans, ais_groups)."""
    period = 2.5
    shapes = TrackerShapes(**shapes_kw)
    params = TrackerParams(radar_period=period, P_d=min(P_d, 0.99),
                           lambda_phi=clutter, lambda_nu=1e-5, N=N,
                           radar_range=radar_range)
    rng = np.random.default_rng(seed)
    targets = sim.generate_initial_targets(rng, n_targets, (0., 0.),
                                           radar_range * 0.6, P_d, 0.1,
                                           assign_mmsi=use_ais)
    sim_list = sim.simulate_targets(rng, targets, sim_time=n_scans * period,
                                    dt=period)
    scans = sim.simulate_scans(rng, sim_list, period, sigma_R=2.5,
                               lambda_phi=clutter, radar_range=radar_range,
                               p0=(0., 0.), P_d=P_d,
                               local_clutter=clutter > 0,
                               global_clutter=clutter > 0)
    ais_groups = (sim.simulate_ais(rng, sim_list, period,
                                   sim_list[0][0].time) if use_ais else [])
    return shapes, params, sim_list, scans, ais_groups


def run_config(name, n_targets, clutter, P_d, N, shapes_kw, n_scans=16,
               radar_range=1000.0, use_ais=False, seed=7,
               method='lagrangian', device=None):
    """One family stepped through a ``Tracker`` on ``device`` (the GPU
    unless named); prints and returns its metrics."""
    period = 2.5
    shapes, params, sim_list, scans, ais_groups = build_scene(
        n_targets, clutter, P_d, N, shapes_kw, n_scans=n_scans,
        radar_range=radar_range, use_ais=use_ais, seed=seed)
    stream = AisMessageStream(ais_groups)
    # the production selection by default; 'ipm' is the cross-check
    tracker = Tracker(shapes, params, method=method, use_ais=use_ais,
                      device=device)
    gaps = []
    for s in scans:
        msgs = [m for m in stream.get_measurements(s.time)
                if s.time - period < m.time < s.time] if use_ais else None
        out = tracker.add_measurement_list(s.time, s.measurements, msgs)
        obj, bound = float(out.sel_obj), float(out.sel_bound)
        if np.isfinite(obj) and np.isfinite(bound):
            gaps.append((obj - bound) / max(1.0, abs(bound)))
    m = evaluate(tracker, sim_list, period, p0=(0., 0.),
                 radar_range=radar_range)
    m['config'] = name
    m['median_gap'] = round(float(np.median(gaps)), 6) if gaps else 0.0
    m = {k: (round(v, 3) if isinstance(v, float) else v)
         for k, v in m.items()}
    print(json.dumps(m), flush=True)
    return m


def run_montecarlo(name, batch, n_targets, n_scans=10, device=None,
                   seed=0):
    """A batch of drawn scenarios through ``parallel.montecarlo.run_batch``
    on ``device``; prints and returns the tracks alive at the last scan
    and their median position error.  The draws come from a torch
    generator seeded with ``seed`` on the CPU (the JAX script draws from
    ``PRNGKey(0)``: other numbers of the same distributions)."""
    device = _common.device_of(device, "run_montecarlo")
    shapes = TrackerShapes(max_targets=max(8, n_targets + 4),
                           max_leaves=16, max_meas=n_targets + 24,
                           max_ais=2, window=6, max_prelim=8,
                           max_initiators=n_targets + 24)
    params = TrackerParams(radar_period=2.5, P_d=0.9, lambda_phi=1e-6,
                           lambda_nu=1e-5, N=4, radar_range=800.0)
    sc = mc.generate(torch.Generator().manual_seed(seed), batch, n_targets,
                     n_scans, shapes, params, 800.0, sigma_Q=0.05)
    sc = mc.McScenario(*(a.to(device) for a in sc))
    _, xs, ms = mc.run_batch(sc, shapes, params)
    xs, msk = xs.cpu().numpy(), ms.cpu().numpy()
    truth = sc.truth.cpu().numpy()
    errs = [np.linalg.norm(xs[-1, b, k, :2] - truth[b, -1, k, :2])
            for b in range(batch) for k in range(n_targets)
            if msk[-1, b, k]]
    out = {'config': name, 'batch': batch,
           'tracks_alive': int(msk[-1, :, :n_targets].sum()),
           'expected': batch * n_targets,
           'median_err': round(float(np.median(errs)), 2) if errs else None}
    print(json.dumps(out), flush=True)
    return out


SMALL = dict(max_targets=16, max_leaves=32, max_meas=64, max_ais=4,
             window=7, max_prelim=16, max_initiators=64)
# max_prelim sized to the 50-target confirm-from-empty burst (32 starves
# the m/n initiator)
BIG = dict(max_targets=80, max_leaves=16, max_meas=192, max_ais=4,
           window=5, max_prelim=96, max_initiators=192)


def main(argv=None):
    args = _common.parser(__doc__).parse_args(argv)
    device = _common.device_of(args.device, "eval_configs")
    full = os.environ.get("EVAL_SCALE", "small") == "full"
    results = [
        run_config("1_crossing", 2, 0.0, 1.0, 5, SMALL, radar_range=2000.0,
                   device=device),
        run_config("2_10tgt_clutter", 10, 2e-6, 0.9, 5, SMALL,
                   device=device),
        run_config("3_50tgt_dense", 50 if full else 24, 4e-6, 0.9, 3, BIG,
                   radar_range=2000.0, device=device),
        run_montecarlo("4_mc_batch", 64 if full else 8, 4, device=device),
        # max_ais sized to the scenario's peak AIS rate (12 messages per
        # scan): an undersized static cap drops messages
        run_config("5_ais_swarm", 12, 1e-6, 0.9, 4, dict(SMALL, max_ais=16),
                   use_ais=True, radar_range=1500.0, device=device),
        # configuration 2 under the interior-point solver
        run_config("2_ipm_xcheck", 10, 2e-6, 0.9, 5, SMALL, method='ipm',
                   device=device),
    ]
    out_path = os.environ.get("EVAL_OUT")
    if out_path:
        with open(out_path, "w") as fh:
            json.dump({"scale": "full" if full else "small",
                       "configs": results}, fh, indent=1)
        print(f"wrote {out_path}", file=sys.stderr)


if __name__ == "__main__":
    main()

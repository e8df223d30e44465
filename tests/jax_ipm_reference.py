"""The JAX package's results on chip_smoke.py's two ``'ipm'`` scenes, for
the floors that script holds the port to.

    JAX_PLATFORMS=cpu python tests/jax_ipm_reference.py

1. examples/demo_tracking.py's scene at its defaults (T=32, L=32, M=64,
   A=8, W=7, N=5, six targets with transponders, 20 scans, seed 42)
   through ``Tracker(method='ipm', use_ais=True)``;
2. eval_configs.py's ``2_ipm_xcheck`` scene (the ``small`` shapes, ten
   targets, 16 scans, seed 7, radar only) through ``method='ipm'`` and,
   on the same scans, ``method='lagrangian'``.

Prints one JSON object per run: coverage, rms, the per-scan selection
objectives and on how many scans the independent optima were in conflict
(the scans on which the solver ran).  Not collected by pytest.
"""
import json

import numpy as np

from pymht_tpu.core import select as jsel
from pymht_tpu.core.config import TrackerParams, TrackerShapes
from pymht_tpu.core.tracker import Tracker
from pymht_tpu.utils import metrics, simulator as sim


def demo_scene(n_targets=6, n_scans=20, seed=42, clutter=2e-6):
    period, radar_range = 2.5, 1000.0
    shapes = TrackerShapes(max_targets=32, max_leaves=32, max_meas=64,
                           max_ais=8, window=7, max_prelim=32,
                           max_initiators=64)
    params = TrackerParams(radar_period=period, P_d=0.9, lambda_phi=clutter,
                           lambda_nu=1e-5, N=5, radar_range=radar_range)
    rng = np.random.default_rng(seed)
    targets = sim.generate_initial_targets(rng, n_targets, (0., 0.),
                                           radar_range * 0.7, 0.9, 0.1,
                                           assign_mmsi=True)
    sim_list = sim.simulate_targets(rng, targets, sim_time=n_scans * period,
                                    dt=period)
    scans = sim.simulate_scans(rng, sim_list, period, sigma_R=2.5,
                               lambda_phi=clutter, radar_range=radar_range,
                               p0=(0., 0.))
    groups = sim.simulate_ais(rng, sim_list, period, sim_list[0][0].time)
    by_scan = {}
    for g in groups:
        tmax = max(m.time for m in g)
        for s in scans:
            if s.time > tmax:
                by_scan.setdefault(s.time, []).extend(g)
                break
    ais_groups = [[m for m in by_scan.get(s.time, [])
                   if s.time - period < m.time < s.time] for s in scans]
    return shapes, params, scans, ais_groups, sim_list


def xcheck_scene(n_targets=10, n_scans=16, seed=7, clutter=2e-6):
    period, radar_range, P_d = 2.5, 1000.0, 0.9
    shapes = TrackerShapes(max_targets=16, max_leaves=32, max_meas=64,
                           max_ais=4, window=7, max_prelim=16,
                           max_initiators=64)
    params = TrackerParams(radar_period=period, P_d=P_d, lambda_phi=clutter,
                           lambda_nu=1e-5, N=5, radar_range=radar_range)
    rng = np.random.default_rng(seed)
    targets = sim.generate_initial_targets(rng, n_targets, (0., 0.),
                                           radar_range * 0.6, P_d, 0.1,
                                           assign_mmsi=False)
    sim_list = sim.simulate_targets(rng, targets, sim_time=n_scans * period,
                                    dt=period)
    scans = sim.simulate_scans(rng, sim_list, period, sigma_R=2.5,
                               lambda_phi=clutter, radar_range=radar_range,
                               p0=(0., 0.), P_d=P_d, local_clutter=True,
                               global_clutter=True)
    return shapes, params, scans, [[] for _ in scans], sim_list


def run(name, scene, method, use_ais):
    shapes, params, scans, groups, sim_list = scene
    tr = Tracker(shapes, params, method=method, use_ais=use_ais)
    objs, feasible, conflicted = [], [], 0
    for s, g in zip(scans, groups):
        out = tr.add_measurement_list(s.time, s.measurements, g)
        objs.append(float(out.sel_obj))
        feasible.append(bool(out.sel_feasible))
        # obj above bound: the fast path returns bound == obj
        conflicted += float(out.sel_obj) != float(out.sel_bound)
    m = metrics.evaluate(tr, sim_list, params.radar_period, p0=(0.0, 0.0),
                         radar_range=params.radar_range)
    print(json.dumps({"scene": name, "method": method, "scans": len(scans),
                      "tracks": sorted(tr.get_tracks()),
                      "coverage": m["track_percent"], "rms": m["rms"],
                      "false_tracks": m["n_false_tracks"],
                      "all_feasible": all(feasible),
                      "scans_with_obj_off_bound": conflicted,
                      "sel_obj": [round(o, 5) for o in objs]}))


def main():
    assert jsel.select.__defaults__[0] == 'ipm'
    run("demo", demo_scene(), 'ipm', use_ais=True)
    run("2_ipm_xcheck", xcheck_scene(), 'ipm', use_ais=False)
    run("2_ipm_xcheck", xcheck_scene(), 'lagrangian', use_ais=False)


if __name__ == "__main__":
    main()

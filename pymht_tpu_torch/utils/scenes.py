"""Seeded scenes shared by the port's smoke run and profiler."""
from __future__ import annotations

import numpy as np

from ..core.config import TrackerParams, TrackerShapes
from . import simulator as sim


def _bench_config(**shape_kw):
    shapes = TrackerShapes(max_targets=128, max_leaves=32, max_meas=512,
                           window=7, max_prelim=64, max_initiators=512,
                           **shape_kw)
    params = TrackerParams(radar_period=2.5, P_d=0.9, lambda_phi=2e-5,
                           lambda_nu=1e-5, N=5, radar_range=2000.0)
    return shapes, params


def bench_scene(n_targets: int = 100, n_scans: int = 12, seed: int = 1234):
    """bench.py's scene (bench.py:53-89): T=128, L=32, M=512, W=7, 64
    prelims, 512 initiators, no pre-gate; ``n_targets`` seeded targets in
    a 2 km radar with clutter, ``n_scans + 1`` scans.

    Returns (shapes, params, scans, sim_list, seeds): ``seeds`` are the
    targets' states back-propagated one period, for
    ``Tracker.pre_initialize(scans[0].time - period, seeds)``."""
    shapes, params = _bench_config(max_ais=8)
    period, radar_range = params.radar_period, params.radar_range
    rng = np.random.default_rng(seed)
    targets = sim.generate_initial_targets(rng, n_targets, (0.0, 0.0),
                                           radar_range, 0.9, 0.1)
    sim_list = sim.simulate_targets(rng, targets, sim_time=n_scans * period,
                                    dt=period)
    scans = sim.simulate_scans(rng, sim_list, period, sigma_R=2.5,
                               lambda_phi=2e-5, radar_range=radar_range,
                               p0=(0.0, 0.0), lambda_local=0.5)
    F_inv = np.eye(4)
    F_inv[0, 2] = F_inv[1, 3] = -period
    seeds = [F_inv @ t.state for t in targets]
    return shapes, params, scans, sim_list, seeds


def bench_scene_ais(n_targets: int = 100, n_scans: int = 12,
                    seed: int = 4321, max_ais: int = 32,
                    ais_per_leaf: int = 2):
    """bench.py's AIS-fusion scene (bench.py:164-213): the shapes of
    ``bench_scene`` with A = ``max_ais`` messages per scan and G =
    ``ais_per_leaf``; every seeded target carries a transponder
    (``P_r`` = 0.9) reporting at class-A intervals.

    Returns (shapes, params, scans, ais_groups, sim_list, seeds, mmsi):
    ``ais_groups[i]`` are the messages for ``scans[i]`` (fewer groups
    than scans is possible: a scan past the last group has none);
    ``seeds`` and ``mmsi`` go to ``Tracker.pre_initialize(scans[0].time -
    period, seeds, mmsi=mmsi)``."""
    shapes, params = _bench_config(max_ais=max_ais,
                                   ais_per_leaf=ais_per_leaf)
    period, radar_range = params.radar_period, params.radar_range
    rng = np.random.default_rng(seed)
    targets = sim.generate_initial_targets(rng, n_targets, (0.0, 0.0),
                                           radar_range, 0.9, 0.1,
                                           assign_mmsi=True, P_r=0.9)
    sim_list = sim.simulate_targets(rng, targets, sim_time=n_scans * period,
                                    dt=period)
    scans = sim.simulate_scans(rng, sim_list, period, sigma_R=2.5,
                               lambda_phi=2e-5, radar_range=radar_range,
                               p0=(0.0, 0.0), lambda_local=0.5)
    ais_groups = sim.simulate_ais(rng, sim_list, period,
                                  init_time=sim_list[0][0].time)
    F_inv = np.eye(4)
    F_inv[0, 2] = F_inv[1, 3] = -period
    seeds = [F_inv @ t.state for t in targets]
    return (shapes, params, scans, ais_groups, sim_list, seeds,
            [t.mmsi for t in targets])

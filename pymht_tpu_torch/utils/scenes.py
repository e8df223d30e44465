"""Seeded scenes shared by the port's smoke run and profiler."""
from __future__ import annotations

import numpy as np

from ..core.config import TrackerParams, TrackerShapes
from . import simulator as sim


def bench_scene(n_targets: int = 100, n_scans: int = 12, seed: int = 1234):
    """bench.py's scene (bench.py:53-89): T=128, L=32, M=512, W=7, 64
    prelims, 512 initiators, no pre-gate; ``n_targets`` seeded targets in
    a 2 km radar with clutter, ``n_scans + 1`` scans.

    Returns (shapes, params, scans, sim_list, seeds): ``seeds`` are the
    targets' states back-propagated one period, for
    ``Tracker.pre_initialize(scans[0].time - period, seeds)``."""
    period, radar_range = 2.5, 2000.0
    shapes = TrackerShapes(max_targets=128, max_leaves=32, max_meas=512,
                           max_ais=8, window=7, max_prelim=64,
                           max_initiators=512)
    params = TrackerParams(radar_period=period, P_d=0.9, lambda_phi=2e-5,
                           lambda_nu=1e-5, N=5, radar_range=radar_range)
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

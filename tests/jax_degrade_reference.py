"""The JAX package's track quality on chip_smoke.py's dynamic-window-and-
degrade run, for the floor that script holds the port to.

    JAX_PLATFORMS=cpu python tests/jax_degrade_reference.py

bench.py's radar-only scene (T=128, L=32, M=512, W=7, 100 seeded targets,
13 scans, seed 1234) is stepped through the JAX ``scan_step`` with
``method='lagrangian'``, ``prune_similar=True`` and the on-device
``dynamic_window=True`` (what the port's ``Tracker(prune_similar=True)
.stream(..., dynamic_window=True)`` runs scan for scan); after 8 scans the
beam is halved with ``Tracker.degrade()`` and the run goes on at L=16.
Prints one JSON object.  Not collected by pytest.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np

from pymht_tpu.core.config import TrackerParams, TrackerShapes
from pymht_tpu.core.grow import Scan, empty_ais
from pymht_tpu.core.tracker import Tracker, scan_step
from pymht_tpu.utils import metrics, simulator as sim

DEGRADE_AFTER = 8


def main():
    shapes = TrackerShapes(max_targets=128, max_leaves=32, max_meas=512,
                           max_ais=8, window=7, max_prelim=64,
                           max_initiators=512)
    params = TrackerParams(radar_period=2.5, P_d=0.9, lambda_phi=2e-5,
                           lambda_nu=1e-5, N=5, radar_range=2000.0)
    period = params.radar_period
    rng = np.random.default_rng(1234)
    targets = sim.generate_initial_targets(rng, 100, (0.0, 0.0), 2000.0, 0.9,
                                           0.1)
    sim_list = sim.simulate_targets(rng, targets, sim_time=12 * period,
                                    dt=period)
    scans = sim.simulate_scans(rng, sim_list, period, sigma_R=2.5,
                               lambda_phi=2e-5, radar_range=2000.0,
                               p0=(0.0, 0.0), lambda_local=0.5)
    F_inv = np.eye(4)
    F_inv[0, 2] = F_inv[1, 3] = -period
    tr = Tracker(shapes, params, method='lagrangian', use_ais=False,
                 prune_similar=True)
    tr.pre_initialize(scans[0].time - period, [F_inv @ t.state
                                               for t in targets])

    def make_step(shapes):
        ais = empty_ais(shapes)
        return jax.jit(lambda st, ist, sc: scan_step(
            st, ist, sc, ais, shapes, params, method='lagrangian',
            use_ais=False, prune_similar=True, compute_clusters=False,
            dynamic_window=True))

    step = make_step(tr.shapes)
    shrunk = []
    for i, s in enumerate(scans):
        if i == DEGRADE_AFTER:
            shrunk.append(int(np.sum(np.asarray(tr.state.tgt_window
                                                < params.N)
                                     & np.asarray(tr.state.tgt_mask))))
            assert tr.degrade()
            step = make_step(tr.shapes)
        packed = np.asarray(tr._pad_scan(float(s.time) - tr.t0,
                                         s.measurements))
        M = shapes.max_meas
        scan = Scan(z=jnp.asarray(packed[:M]),
                    mask=jnp.arange(M) < int(packed[M, 0]),
                    time=jnp.asarray(packed[M, 1]))
        tr.state, tr.init_state, out = step(tr.state, tr.init_state, scan)
        tr.scan_history.append(np.asarray(s.measurements, np.float32))
        tr.ais_history.append([])
        tr.scan_times.append(float(s.time) - tr.t0)
        tr._absorb_outputs(jax.device_get(out), n_scans=len(tr.scan_times))
        tr.check_integrity()
    shrunk.append(int(np.sum(np.asarray(tr.state.tgt_window < params.N)
                             & np.asarray(tr.state.tgt_mask))))
    m = metrics.evaluate(tr, sim_list, period, p0=(0.0, 0.0),
                         radar_range=params.radar_range)
    print(json.dumps({"scans": len(scans), "beam": tr.shapes.max_leaves,
                      "tracks": len(tr.get_tracks()),
                      "coverage": m["track_percent"], "rms": m["rms"],
                      "false_tracks": m["n_false_tracks"],
                      "targets_with_shrunk_window": shrunk}))


if __name__ == "__main__":
    main()

"""The JAX package's track quality on the swarm benchmark's scene, for the
floors that chip_smoke.py's swarm phase holds the port to.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/jax_swarm_reference.py

bench_swarm.py's scene at its defaults (BASELINE config 5: 1000 seeded
targets, half with transponders, in T=1024 slots; L=16, M=2048, A=128,
W=6, G=2, the per-target pre-gate at Km=64, seed 77, 8 scans) streamed
once through the JAX ``scan_many`` with ``method='lagrangian'`` and AIS on,
scored as bench_swarm.py scores it: per scan a one-to-one Hungarian match
of truth to selected tracks inside a 20 m gate.  Prints one JSON object.
Not collected by pytest.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
from scipy.optimize import linear_sum_assignment

from pymht_tpu.core.config import TrackerParams, TrackerShapes
from pymht_tpu.core.grow import AisBatch, Scan
from pymht_tpu.core.tracker import Tracker, scan_many
from pymht_tpu.utils import simulator as sim

N_SCANS = 8
GATE = 20.0


def main():
    period, radar_range = 2.5, 12000.0
    shapes = TrackerShapes(max_targets=1024, max_leaves=16, max_meas=2048,
                           max_ais=128, window=6, max_prelim=64,
                           max_initiators=512, ais_per_leaf=2,
                           radar_cand_width=64)
    params = TrackerParams(radar_period=period, P_d=0.9, lambda_phi=1.5e-6,
                           lambda_nu=1e-6, N=4, radar_range=radar_range)
    n_tgt = 1000
    rng = np.random.default_rng(77)
    targets = sim.generate_initial_targets(
        rng, n_tgt, (0.0, 0.0), radar_range * 0.85, 0.9, 0.1,
        assign_mmsi=True, P_r=0.5)
    sim_list = sim.simulate_targets(rng, targets, sim_time=N_SCANS * period,
                                    dt=period)
    scans = sim.simulate_scans(rng, sim_list, period, sigma_R=2.5,
                               lambda_phi=1.5e-6, radar_range=radar_range,
                               p0=(0.0, 0.0), lambda_local=0.2)
    groups = sim.simulate_ais(rng, sim_list, period,
                              init_time=sim_list[0][0].time)
    F_inv = np.eye(4)
    F_inv[0, 2] = F_inv[1, 3] = -period
    tr = Tracker(shapes, params, method='lagrangian', use_ais=True)
    tr.pre_initialize(scans[0].time - period,
                      [F_inv @ t.state for t in targets],
                      mmsi=[t.mmsi for t in targets])
    scan_b, ais_b = tr.make_stream_inputs(scans[:N_SCANS], groups[:N_SCANS])
    _, _, outs = jax.jit(lambda st, ist, sc, a: scan_many(
        st, ist, sc, a, shapes, params, method='lagrangian',
        use_ais=True))(tr.state, tr.init_state, scan_b, ais_b)
    track_x = np.asarray(outs.track_x)
    track_ok = np.asarray(outs.track_mask)
    truth = np.array([[t.cartesian_state() for t in sample]
                      for sample in sim_list[:N_SCANS]])
    matched, sq = 0, []
    for i in range(N_SCANS):
        tp = track_x[i][track_ok[i]][:, :2]
        d = np.linalg.norm(truth[i][:, None, :2] - tp[None], axis=2)
        ri, ci = linear_sum_assignment(np.minimum(d, GATE))
        dm = d[ri, ci]
        hit = dm < GATE
        matched += int(hit.sum())
        sq.extend((dm[hit] ** 2).tolist())
    gaps = np.asarray(outs.sel_obj) - np.asarray(outs.sel_bound)
    rel = gaps / np.maximum(1.0, np.abs(np.asarray(outs.sel_bound)))
    print(json.dumps({
        "scans": N_SCANS, "n_targets": n_tgt,
        "tracks_alive_last_scan": int(track_ok[-1].sum()),
        "truth_coverage": matched / float(truth.shape[0] * truth.shape[1]),
        "rms_matched_m": float(np.sqrt(np.mean(sq))),
        "median_dual_gap": float(np.median(rel)),
        "mean_meas_per_scan": float(np.mean(
            [len(s.measurements) for s in scans[:N_SCANS]])),
        "mean_ais_per_scan": float(np.mean(
            [len(groups[i]) if i < len(groups) else 0
             for i in range(N_SCANS)]))}))


if __name__ == "__main__":
    main()

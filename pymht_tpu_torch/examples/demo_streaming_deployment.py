"""Demo: the production streaming deployment pattern, end to end
(counterpart of examples/demo_streaming_deployment.py).

    python -m pymht_tpu_torch.examples.demo_streaming_deployment
        [--targets 100] [--scans 12] [--chunk 4] [--device cpu]

How the pieces a deployed tracker needs compose:

  1. device-resident streaming: a chunk of scans goes to the device in
     one transfer and through ``scan_many`` with nothing fetched between
     its scans;
  2. graceful degradation on the device: ``dynamic_window=True`` runs the
     reference's dynamic-window triggers inside the step, so overloaded
     targets shrink their N-scan window without a host round trip;
  3. checkpoint and resume between chunks: ``checkpoint.save_state``
     snapshots the bare (TrackerState, InitiatorState); a restarted
     process resumes bit for bit (the last checkpoint is reloaded and
     compared);
  4. consumption on the host: the chunk's selected tracks come back in
     one transfer, and quality is scored by one-to-one truth matching.

This is the low-level pattern; ``Tracker.stream(scans, ais_groups,
chunk=N)`` is the high-level one (the same chunks, plus the per-track
archives and host supervision between chunks).  At swarm scale also set
``TrackerShapes(radar_cand_width=64)``, the spatial pre-gate.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from ..core.config import TrackerParams, TrackerShapes
from ..core.tracker import Tracker, scan_many, tensors_to_host
from ..scripts import _common
from ..utils import checkpoint
from ..utils import simulator as sim


def fields(state, istate):
    return [getattr(s, f.name) for s in (state, istate)
            for f in dataclasses.fields(s)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--targets", type=int, default=100)
    ap.add_argument("--scans", type=int, default=12)
    ap.add_argument("--chunk", type=int, default=4)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    device = _common.device_of(args.device, "demo_streaming_deployment")

    period = 2.5
    radar_range = 4000.0 * float(np.sqrt(args.targets / 100.0))
    shapes = TrackerShapes(
        max_targets=max(128, args.targets + 24), max_leaves=16,
        max_meas=2 * args.targets + 64, max_ais=64, window=6,
        max_prelim=64, max_initiators=256, ais_per_leaf=2)
    params = TrackerParams(radar_period=period, P_d=0.9,
                           lambda_phi=1.5e-6, lambda_nu=1e-6, N=4,
                           radar_range=radar_range)

    rng = np.random.default_rng(args.seed)
    targets = sim.generate_initial_targets(
        rng, args.targets, (0.0, 0.0), radar_range * 0.8, 0.9, 0.1,
        assign_mmsi=True, P_r=0.5)
    sim_list = sim.simulate_targets(rng, targets,
                                    sim_time=args.scans * period, dt=period)
    scans = sim.simulate_scans(rng, sim_list, period, sigma_R=2.5,
                               lambda_phi=1.5e-6, radar_range=radar_range,
                               p0=(0.0, 0.0), lambda_local=0.2)
    ais_groups = sim.simulate_ais(rng, sim_list, period,
                                  init_time=sim_list[0][0].time)

    F_inv = np.eye(4)
    F_inv[0, 2] = F_inv[1, 3] = -period
    tracker = Tracker(shapes, params, use_ais=True, device=device)
    tracker.pre_initialize(scans[0].time - period,
                           [F_inv @ t.state for t in targets],
                           mmsi=[t.mmsi for t in targets])

    ckpt_dir = tempfile.mkdtemp(prefix="pymht_ckpt_")
    state, istate = tracker.state, tracker.init_state
    for lo in range(0, args.scans, args.chunk):
        hi = min(lo + args.chunk, args.scans)
        t0 = time.perf_counter()
        scan_b, ais_b = tracker.make_stream_inputs(scans[lo:hi],
                                                   ais_groups[lo:hi])
        state, istate, outs = scan_many(
            state, istate, scan_b, ais_b, shapes, params,
            method="lagrangian", use_ais=True, dynamic_window=True)
        # one host transfer per chunk: the selected-track summaries
        track_mask, = tensors_to_host([outs.track_mask])
        dt = time.perf_counter() - t0
        alive = int(track_mask[-1].sum())
        print(f"chunk {lo:3d}-{hi:3d}: {alive:4d} tracks alive, "
              f"{dt / (hi - lo) * 1000:7.2f} ms/scan "
              f"(the first chunk includes the warm-up)")
        # the operational checkpoint: a restarted process resumes here
        checkpoint.save_state(os.path.join(ckpt_dir, f"scan{hi:04d}"),
                              state, istate)

    # resume: reload the last checkpoint and compare it bit for bit
    last = os.path.join(ckpt_dir, f"scan{args.scans:04d}")
    st2, ist2 = checkpoint.load_state(last, device=device)
    same = all(torch.equal(a, b) for a, b in zip(fields(state, istate),
                                                  fields(st2, ist2)))
    print(f"checkpoint resume bitwise-identical: {same}")

    ok = state.tgt_mask.cpu().numpy()
    tw = state.tgt_window.cpu().numpy()[ok]
    print(f"dynamic window: mean {tw.mean():.2f}, min {tw.min()}, "
          f"max {tw.max()} (N={params.N}); "
          f"{(tw < params.N).mean() * 100:.1f}% of targets degraded")

    # the final chunk's estimates against truth, one to one
    truth = _common.truth_of(sim_list, args.scans)[-1:]
    est = state.leaf_x[torch.arange(shapes.max_targets, device=device),
                       state.sel_leaf.long()].cpu().numpy()
    coverage, rms = _common.one_to_one(est[None], ok[None], truth)
    print(f"final-scan coverage: {coverage * 100:.1f}% "
          f"({round(coverage * truth.shape[1])}/{truth.shape[1]}), "
          f"rms {rms:.2f} m")
    if not same:
        raise RuntimeError("demo_streaming_deployment: the reloaded "
                           "checkpoint differs from the state saved")


if __name__ == "__main__":
    main()

"""Scaling of the scenario-sharded step over ranks (counterpart of
bench_scaling.py).

    python -m pymht_tpu_torch.scripts.bench_scaling [--device cpu]
        [--worlds 1,2,4]

For each world size it draws ``SCALING_BATCH_PER_DEV`` x size Monte-Carlo
scenarios (8 targets in a 500 m radar, T=16, L=16, M=32, W=6, 8 scans),
splits them over the 'scenario' dimension of a (size x 1) mesh of ranks
and steps them through ``parallel/scenario.make_sharded_step``; the wall
is the median of 3 runs of the 8 scans after a warm-up, each closed by a
device synchronise and a barrier.  Prints one JSON line per size
(scenario-scans per second and the efficiency against the first size)
and, with more than one size, the efficiency line.

By default it runs on the GPU at world size 1, one rank over NCCL:
ranks that share one card time-share it, so a larger size on one card
measures nothing about scaling (``--worlds`` allows it, and the lines
then say so under ``"note"``).  With ``--device cpu`` the ranks are
gloo processes on the CPU at world sizes 1, 2 and 4, as the JAX script
defaults to virtual CPU devices.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..core.config import TrackerParams, TrackerShapes
from ..core.grow import empty_ais
from ..parallel import montecarlo as mc
from . import _common

SHAPES = TrackerShapes(max_targets=16, max_leaves=16, max_meas=32,
                       max_ais=2, window=6, max_prelim=16,
                       max_initiators=32)
PARAMS = TrackerParams(radar_period=2.5, P_d=0.9, lambda_phi=2e-6,
                       lambda_nu=1e-5, N=4, radar_range=500.0)
N_SCANS = 8
N_TARGETS = 8


def scaling_rank(rank, world, device, per_dev):
    """Scenario-scans per second of this size; rank 0's result."""
    import torch.distributed as dist

    from ..parallel.multihost import hybrid_mesh
    from ..parallel.scenario import make_sharded_step
    B = per_dev * world
    # the same draws on every rank (a CPU generator), each rank keeps its
    # block of scenarios
    sc = mc.generate(torch.Generator().manual_seed(0), B, N_TARGETS,
                     N_SCANS, SHAPES, PARAMS, 500.0)
    sc = mc.McScenario(*(a.to(device) for a in sc))
    mesh = hybrid_mesh(world, 1, device_type=device.type)
    step, shard = make_sharded_step(mesh, SHAPES, PARAMS,
                                    method="lagrangian", use_ais=False)
    state_b, istate_b = mc.initial_states(sc, SHAPES, PARAMS)
    ais_b = type(empty_ais(SHAPES, device))(*(
        x.expand((B,) + x.shape).contiguous()
        for x in empty_ais(SHAPES, device)))
    st0, ist0, _, ais_l = shard(state_b, istate_b, mc.scan_batch(sc, 0),
                                ais_b)
    scans = [shard(state_b, istate_b, mc.scan_batch(sc, s), ais_b)[2]
             for s in range(N_SCANS)]

    def run():
        st, ist = st0, ist0
        for scan in scans:
            st, ist, _ = step(st, ist, scan, ais_l)
        return st

    def sync_all():
        _common.synchronize(device)
        dist.barrier()

    run()
    sync_all()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        sync_all()
        walls.append(time.perf_counter() - t0)
    return {"rate": B * N_SCANS / float(np.median(walls)), "batch": B,
            "hardware": _common.hardware(device)}


def main(argv=None):
    ap = _common.parser(__doc__)
    ap.add_argument("--worlds", default=None,
                    help="world sizes (default: 1,2,4 on the CPU, 1 on "
                         "the GPU)")
    args = ap.parse_args(argv)
    device = _common.device_of(args.device, "bench_scaling")
    worlds = [int(w) for w in (args.worlds or (
        "1" if device.type == "cuda" else "1,2,4")).split(",")]
    per_dev = int(os.environ.get("SCALING_BATCH_PER_DEV", "4"))
    results, base_rate = [], None
    for nd in worlds:
        r = _common.run_ranks(scaling_rank, nd, device, per_dev)
        rate = r["rate"]
        base_rate = rate if base_rate is None else base_rate
        eff = rate / (base_rate * nd)
        results.append((nd, rate, eff))
        line = {"metric": "scenario_scans_per_s", "devices": nd,
                "batch": r["batch"], "value": round(rate, 1),
                "efficiency": round(eff, 3), "hardware": r["hardware"]}
        if device.type == "cuda" and nd > 1:
            line["note"] = (f"{nd} gloo ranks time-share one card: not a "
                            "measure of scaling")
        print(json.dumps(line), flush=True)
    if len(results) > 1:
        print(json.dumps({"metric": "scaling_efficiency",
                          "value": round(results[-1][2], 3),
                          "devices": results[-1][0],
                          "unit": "fraction"}), flush=True)


if __name__ == "__main__":
    main()

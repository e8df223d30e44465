"""A/B of the two distributed selections, 'full' against 'compact'
(counterpart of tools/ab_distributed_select.py).

    python -m pymht_tpu_torch.scripts.ab_distributed_select [--device cpu]
        [--world N]

One conflicted swarm-shape forest (T=1024 slots, 1000 targets packed in
pairs and triples so that their gates overlap, L=8, M=512, A=32, W=6; one
grown scan), split over the ranks of one process group, through both
implementations of ``parallel/distributed_select``:

* 'full'    — the full-slot formulation: [n_slots] usage counts reduced
  per iteration, [n_slots] pmins per repair round;
* 'compact' — production: the contested-slot compaction, [CAP]-sized
  reductions per iteration.

Reported, per implementation:
1. the wall time of one call at 10 and at 40 iterations with
   ``force_iters=True`` (exactly that many loop bodies), and their
   difference over 30 as the ms per iteration;
2. the collectives per call and per iteration, with their bytes, counted
   by ``collectives.Axis`` (``count`` / ``bytes``) in the forced runs
   (the JAX tool reads them from the compiled HLO), and the same counts
   at the swarm benchmark's shapes (L=16, M=2048, A=128: n_slots 13,056;
   256 targets);
3. the objectives of both under the production exits (60 iterations),
   and ``obj_rel_delta``, their difference over 1 + |obj|: at most
   OBJ_RTOL on this instance (the JAX tool's gives 0.0).

One rank on the GPU runs over NCCL; ``--world N`` (2-4) runs N gloo
ranks on the CPU, as the JAX tool runs on virtual CPU devices (with
``--device cuda`` N gloo ranks share the one card).  Prints each
implementation's entry and then one JSON line; ``--out PATH`` also
writes that object to PATH.
"""
from __future__ import annotations

import json
import time

import numpy as np
import torch

from ..core.config import TrackerParams, TrackerShapes
from ..core.grow import Scan, grow
from ..core.select import _hist_usage
from ..core.state import empty_state, insert_targets
from ..models import pv
from . import _common

K1, K2 = 10, 40
CAP = 512
OBJ_RTOL = 1e-5      # obj_rel_delta allowed on INSTANCE
# the instance (tools/ab_distributed_select.py's) and the swarm
# benchmark's shapes at which the collectives are counted as well
INSTANCE = dict(slots=1024, targets=1000, meas=512)
SWARM_SHAPE = dict(leaves=16, meas=2048, ais=128, targets=256, cap=256)


def build_state(shapes, params, n_tgt, device, seed=11):
    """A swarm-shape forest after one grow, with dense conflicts: targets
    packed in pairs and triples near shared gates, ~0.7 measurements per
    target near the predictions plus clutter (tools/ab_distributed_select
    .py's instance)."""
    rng = np.random.default_rng(seed)
    T, M = shapes.max_targets, shapes.max_meas
    xs = np.zeros((T, 4), np.float32)
    for i in range(n_tgt):
        c = i // 3
        xs[i, :2] = [150.0 * (c % 64), 150.0 * (c // 64)]
        xs[i, :2] += rng.normal(0, 8.0, 2)
        xs[i, 2:] = rng.normal(0, 3.0, 2)
    mask = np.zeros(T, bool)
    mask[:n_tgt] = True
    st = insert_targets(
        empty_state(shapes, params, device), torch.from_numpy(xs).to(device),
        pv.P0(device).expand(T, 4, 4), torch.from_numpy(mask).to(device),
        torch.zeros(T, dtype=torch.int32, device=device),
        torch.zeros((), device=device), params)
    z = np.zeros((M, 2), np.float32)
    zmask = np.zeros(M, bool)
    n_near = min(int(0.7 * n_tgt), int(0.9 * M))
    pick = rng.choice(n_tgt, n_near, replace=False)
    z[:n_near] = (xs[pick, :2] + xs[pick, 2:] * params.radar_period
                  + rng.normal(0, 2.0, (n_near, 2)))
    n_clut = min(M - n_near, n_tgt // 2)
    z[n_near:n_near + n_clut] = rng.uniform(0, 6400, (n_clut, 2))
    zmask[:n_near + n_clut] = True
    scan = Scan(z=torch.from_numpy(z).to(device),
                mask=torch.from_numpy(zmask).to(device),
                time=torch.full((), params.radar_period, device=device))
    return grow(st, scan, None, shapes, params).state


def impl_kw(impl: str, cap: int) -> dict:
    return ({"fast_path": False, "contested_cap": cap}
            if impl == "compact" else {})


def _collectives(axis, run, state):
    c0, b0 = axis.count, axis.bytes
    run(state)
    return axis.count - c0, axis.bytes - b0


def ab_rank(rank, world, device, cfg, sw_cfg):
    """The A/B on this rank's share of the instance ``cfg`` (as
    INSTANCE), with the collectives also counted at ``sw_cfg`` (as
    SWARM_SHAPE); rank 0's result."""
    import torch.distributed as dist

    from ..parallel.collectives import Axis
    from ..parallel.distributed_select import make_distributed_select
    from ..parallel.sharded_tracker import shard_state
    axis = Axis()
    shapes = TrackerShapes(max_targets=cfg["slots"], max_leaves=8,
                           max_meas=cfg["meas"], max_ais=32, window=6)
    params = TrackerParams(radar_period=2.5, P_d=0.85, lambda_phi=2e-6,
                           lambda_nu=1e-6, N=4)
    n_slots = shapes.window * (shapes.max_meas + shapes.max_ais)
    whole = build_state(shapes, params, cfg["targets"], device)
    n_cont = int((_hist_usage(whole, shapes).sum(dim=0) >= 2).sum())
    state = shard_state(whole, axis)

    def sync_all():
        _common.synchronize(device)
        dist.barrier()

    res = {"metric": "distributed_select_ab",
           "hardware": (f"{world} rank(s) on "
                        f"{_common.hardware(device)}"),
           "shape": {"T": shapes.max_targets, "L": shapes.max_leaves,
                     "M": shapes.max_meas, "A": shapes.max_ais,
                     "n_slots": n_slots, "contested_cap": CAP,
                     "n_contested_slots": n_cont, "ranks": world}}
    for impl in ("full", "compact"):
        entry, counts = {}, {}
        for K in (K1, K2):
            run = make_distributed_select(axis, shapes, params, iters=K,
                                          impl=impl, force_iters=True,
                                          **impl_kw(impl, CAP))
            counts[K] = _collectives(axis, run, state)
            walls = []
            for _ in range(3):
                sync_all()
                t0 = time.perf_counter()
                out = run(state)
                sync_all()
                walls.append(time.perf_counter() - t0)
            entry[f"ms_iters_{K}"] = round(float(np.median(walls)) * 1e3, 3)
            _, obj, lb, feas, _ = out
            entry["obj"], entry["lb"], entry["feasible"] = (
                float(obj), float(lb), bool(feas))
        entry["ms_per_iteration"] = round(
            (entry[f"ms_iters_{K2}"] - entry[f"ms_iters_{K1}"]) / (K2 - K1),
            4)
        entry["collectives_per_call"] = {
            str(K): {"count": c, "bytes": b} for K, (c, b) in counts.items()}
        entry["collectives_per_iteration"] = {
            "count": (counts[K2][0] - counts[K1][0]) / (K2 - K1),
            "bytes": (counts[K2][1] - counts[K1][1]) / (K2 - K1)}
        res[impl] = entry
        if rank == 0:
            print(impl, json.dumps(entry, indent=1), flush=True)
    f_b = res["full"]["collectives_per_iteration"]["bytes"]
    c_b = res["compact"]["collectives_per_iteration"]["bytes"]
    res["per_iteration_allreduce_bytes_ratio"] = (round(f_b / c_b, 1)
                                                  if c_b else None)

    # the selections under the production exits
    conv = {}
    for impl in ("full", "compact"):
        run = make_distributed_select(axis, shapes, params, iters=60,
                                      impl=impl, **impl_kw(impl, CAP))
        _, obj, lb, feas, _ = run(state)
        conv[impl] = {"obj": float(obj), "lb": float(lb),
                      "feasible": bool(feas)}
    res["converged"] = conv
    d_obj = abs(conv["full"]["obj"] - conv["compact"]["obj"])
    res["obj_rel_delta"] = round(d_obj / (1 + abs(conv["full"]["obj"])), 6)

    # collectives at the swarm benchmark's shapes: per call at the two
    # forced budgets, and per iteration
    sw_shapes = TrackerShapes(max_targets=cfg["slots"],
                              max_leaves=sw_cfg["leaves"],
                              max_meas=sw_cfg["meas"],
                              max_ais=sw_cfg["ais"], window=6,
                              ais_per_leaf=2)
    sw_state = shard_state(build_state(sw_shapes, params, sw_cfg["targets"],
                                       device, seed=5), axis)
    sw = {}
    for impl in ("full", "compact"):
        c = {K: _collectives(axis, make_distributed_select(
            axis, sw_shapes, params, iters=K, impl=impl,
            force_iters=True, **impl_kw(impl, sw_cfg["cap"])), sw_state)
            for K in (K1, K2)}
        sw[impl] = {
            "per_call": {str(K): {"count": n, "bytes": b}
                         for K, (n, b) in c.items()},
            "per_iteration": {
                "count": (c[K2][0] - c[K1][0]) / (K2 - K1),
                "bytes": (c[K2][1] - c[K1][1]) / (K2 - K1)}}
    sw_f = sw["full"]["per_iteration"]["bytes"]
    sw_c = sw["compact"]["per_iteration"]["bytes"]
    res["swarm_shape_collectives"] = {
        "n_slots": sw_shapes.window * (sw_shapes.max_meas
                                       + sw_shapes.max_ais),
        **sw,
        "per_iteration_allreduce_bytes_ratio":
            round(sw_f / sw_c, 1) if sw_c else None}
    return res


def main(argv=None):
    ap = _common.parser(__doc__)
    ap.add_argument("--world", type=int, default=1,
                    help="ranks (1 on the GPU over NCCL; 2-4 gloo ranks)")
    ap.add_argument("--out", default=None,
                    help="also write the JSON object to this path")
    args = ap.parse_args(argv)
    device = _common.device_of(args.device, "ab_distributed_select")
    if INSTANCE["slots"] % args.world:
        raise ValueError(f"{INSTANCE['slots']} slots do not split over "
                         f"{args.world} ranks")
    res = _common.run_ranks(ab_rank, args.world, device, INSTANCE,
                            SWARM_SHAPE)
    print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)


if __name__ == "__main__":
    main()

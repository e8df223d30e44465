"""The aten operations that fixed runs of the port make on the CPU, as
one fingerprint per run: to show that a change leaves a path's device
work alone, run it in two trees and compare.

    PYTHONPATH=<tree> python tests/torch_op_sequence.py

Each run is recorded under a ``TorchDispatchMode`` with view operations
left out (they launch nothing on a card); an equal count and digest of
the operation names means the same operations, in the same order, per
run.  The runs: bench.py's radar-only scene stepped 13 scans and its
AIS scene 6 scans (``Tracker(method='lagrangian')``); on a forest of the
sharded swarm scene (120 targets, 5 scans, one more grown):
``select_hybrid``, the compact Lagrangian over every live target, and
``distributed_select_compact`` and ``distributed_lagrangian`` on one gloo
rank.  Prints one JSON object.  Not collected by pytest.
"""
import datetime
import hashlib
import json
import socket

import torch
from torch.utils._python_dispatch import TorchDispatchMode


class OpRecorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def fingerprint(fn):
    with OpRecorder() as rec:
        fn()
    return [len(rec.ops), hashlib.sha256(
        "\n".join(rec.ops).encode()).hexdigest()[:16]]


def stepped(scene, n_scans, use_ais):
    from pymht_tpu_torch import Tracker
    if use_ais:
        shapes, params, scans, groups, _, seeds, mmsi = scene()
    else:
        (shapes, params, scans, _, seeds), groups, mmsi = scene(), None, None
    tr = Tracker(shapes, params, method="lagrangian", use_ais=use_ais,
                 device="cpu")
    tr.pre_initialize(scans[0].time - params.radar_period, seeds, mmsi=mmsi)

    def run():
        for i, s in enumerate(scans[:n_scans]):
            tr.add_measurement_list(
                s.time, s.measurements,
                (groups[i] if i < len(groups) else []) if use_ais else None)
    return run


def swarm_forest():
    """The sharded swarm scene's forest after 5 scans, grown once more."""
    from pymht_tpu_torch import Tracker
    from pymht_tpu_torch.core.grow import AisBatch, Scan, grow
    from pymht_tpu_torch.utils.scenes import swarm_shard_scene
    shapes, params, scans, groups, _, seeds, mmsi = swarm_shard_scene(
        n_scans=6, n_targets=120)
    tr = Tracker(shapes, params, method="lagrangian", use_ais=True,
                 device="cpu")
    tr.pre_initialize(scans[0].time - params.radar_period, seeds, mmsi=mmsi)
    for i, s in enumerate(scans[:5]):
        tr.add_measurement_list(s.time, s.measurements,
                                groups[i] if i < len(groups) else [])
    scan_b, ais_b = tr.make_stream_inputs(scans[5:6], groups[5:6])
    g = grow(tr.state, Scan(*(f[0] for f in scan_b)),
             AisBatch(*(f[0] for f in ais_b)), shapes, params)
    return shapes, params, g.state


def main():
    from pymht_tpu_torch.core import select as sel
    from pymht_tpu_torch.parallel import distributed_select as ds
    from pymht_tpu_torch.parallel.collectives import Axis
    from pymht_tpu_torch.utils import scenes
    torch.set_num_threads(1)
    out = {"radar_stepped_13": fingerprint(
        stepped(scenes.bench_scene, 13, False)),
        "ais_stepped_6": fingerprint(
            stepped(scenes.bench_scene_ais, 6, True))}
    shapes, params, st = swarm_forest()
    out["select_hybrid"] = fingerprint(
        lambda: sel.select_hybrid(st, shapes, params))

    def compact_all():
        """The compact Lagrangian over every live target (tier 3 as the
        distributed select runs it, without an axis)."""
        usage = sel._hist_usage(st, shapes)
        Uc, _, _, _, eff_leaf = sel._contested_leaf_usage(
            st, shapes, st.tgt_mask, 256, usage)
        sel._compact_lagrangian(sel.leaf_scores(st, params), Uc,
                                torch.zeros(Uc.shape[-1]), st.spine_leaf,
                                st.tgt_mask, eff_leaf, 0.0)

    out["compact_lagrangian"] = fingerprint(compact_all)
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
    try:
        axis = Axis()
        out["distributed_compact"] = fingerprint(
            lambda: ds.distributed_select_compact(st, shapes, params, axis,
                                                  fast_path=False))
        out["distributed_full"] = fingerprint(
            lambda: ds.distributed_lagrangian(st, shapes, params, axis))
    finally:
        dist.destroy_process_group()
    print(json.dumps(out))


if __name__ == "__main__":
    main()

"""Rank program of the port's multi-rank CPU tests
(tests/test_torch_distributed_select.py, test_torch_sharded_tracker.py,
test_torch_multihost.py), and the launcher those tests call.

A test writes its inputs to an .npz and calls ``launch(job, world,
inputs, out_dir)``, which starts ``world`` processes of

    python tests/torch_dist_worker.py <job> <inputs.npz> <out_dir>

with ``PYMHT_COORDINATOR`` / ``PYMHT_NUM_PROCS`` / ``PYMHT_PROC_ID`` set
(``multihost.initialize`` reads them) on a free localhost port.  Every
rank joins a gloo group on the CPU with a collective timeout, pins torch
to one thread, runs the job, writes ``out<rank>.npz``, and checks that
neither jax nor the JAX package was imported (both are made unimportable
first).
"""
from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLLECTIVE_TIMEOUT_S = 120


# ----------------------------------------------------------------------
# pytest side
# ----------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def numpy_fields(obj, prefix: str = "") -> dict:
    """The fields of a state dataclass or NamedTuple of either package as
    numpy arrays, named ``prefix + field``."""
    names = (obj._fields if isinstance(obj, tuple)
             else [f.name for f in dataclasses.fields(obj)])
    return {prefix + k: np.asarray(getattr(obj, k)) for k in names}


def config_json(shapes, params) -> np.ndarray:
    """Shapes and params of either package as a JSON string array."""
    return np.array(json.dumps({"shapes": dataclasses.asdict(shapes),
                                "params": dataclasses.asdict(params)}))


def launch(job: str, world: int, inputs: str, out_dir: str,
           timeout: float = 300.0) -> list:
    """Run ``job`` on ``world`` gloo ranks; returns each rank's outputs
    as a dict of numpy arrays.  A rank that fails, or a run that outlasts
    ``timeout`` seconds, fails the calling test with the ranks' output."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "PALLAS_"))}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               PYMHT_COORDINATOR=f"127.0.0.1:{port}",
               PYMHT_NUM_PROCS=str(world))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), job, inputs, out_dir],
        env=dict(env, PYMHT_PROC_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"OK rank={r}" in out, \
            f"rank {r} of {job} failed (rc {p.returncode}):\n{out[-6000:]}"
    return [dict(np.load(os.path.join(out_dir, f"out{r}.npz")))
            for r in range(world)]


# ----------------------------------------------------------------------
# rank side
# ----------------------------------------------------------------------

def _config(data, key="config"):
    from pymht_tpu_torch.core.config import TrackerParams, TrackerShapes
    d = json.loads(str(data[key]))
    names = {f.name for f in dataclasses.fields(TrackerShapes)}
    shapes = TrackerShapes(**{k: v for k, v in d["shapes"].items()
                              if k in names})
    params = dict(d["params"], position=tuple(d["params"]["position"]))
    return shapes, TrackerParams(**params)


def _fields(data, prefix):
    return {k[len(prefix):]: data[k] for k in data.files
            if k.startswith(prefix)}


def _state(data, prefix):
    from pymht_tpu_torch.core.state import state_from_numpy
    return state_from_numpy(_fields(data, prefix), "cpu")


def _axes():
    """{2: the axis of ranks 0-1, 4: the axis of all four} on a world of
    four (new_group is called by every rank); a rank outside a group has
    no entry for it."""
    import torch.distributed as dist
    from pymht_tpu_torch.parallel.collectives import Axis
    world, rank = dist.get_world_size(), dist.get_rank()
    axes = {}
    for n in (2, 4):
        if n > world:
            continue
        group = dist.new_group(list(range(n)))
        if rank < n:
            axes[n] = Axis(group)
    return axes


def job_select(data) -> dict:
    """make_distributed_select, compact and full, at 2 and 4 ranks on
    each state; the compact one again with the scatter contested build
    forced.  Writes the gathered selection and the global results."""
    from pymht_tpu_torch.core import select as sel_mod
    from pymht_tpu_torch.parallel.distributed_select import (
        make_distributed_select)
    from pymht_tpu_torch.parallel.sharded_tracker import shard_state
    shapes, params = _config(data)
    out = {}
    for n, axis in _axes().items():
        for name in str(data["names"]).split(","):
            local = shard_state(_state(data, f"{name}."), axis)
            runs = [(impl, impl, sel_mod._INT32_WALL)
                    for impl in ("compact", "full")]
            runs.append(("scatter", "compact", 0))
            for key, impl, wall in runs:
                saved, sel_mod._INT32_WALL = sel_mod._INT32_WALL, wall
                try:
                    sel, obj, lb, feas, lam = make_distributed_select(
                        axis, shapes, params, impl=impl)(local)
                finally:
                    sel_mod._INT32_WALL = saved
                res = dict(sel=axis.all_gather(sel), obj=obj, lb=lb,
                           feas=feas, lam=lam)
                out.update({f"{name}.{key}.{n}.{k}": v.numpy()
                            for k, v in res.items()})
    return out


def _scans(data, prefix, n_scans):
    import torch
    from pymht_tpu_torch.core.grow import Scan
    from pymht_tpu_torch.core.state import ais_from_numpy
    scans, ais = [], []
    for k in range(n_scans):
        p = f"{prefix}scan{k}."
        scans.append(Scan(z=torch.from_numpy(data[p + "z"]),
                          mask=torch.from_numpy(data[p + "mask"]),
                          time=torch.from_numpy(data[p + "time"])))
        f = _fields(data, f"{prefix}ais{k}.")
        ais.append(ais_from_numpy(f, "cpu") if f else None)
    return scans, ais


def job_tracker(data) -> dict:
    """make_sharded_tracker_step over each case's scans at each of its
    rank counts; per scan the gathered outputs and the selected leaf's
    AIS label, after the last the gathered state.  With ``swarm`` in a
    case, also one grow of each rank's share with the global and with
    the local live-target count."""
    import torch
    from pymht_tpu_torch.core import initiator as initiator_mod
    from pymht_tpu_torch.core.grow import grow
    from pymht_tpu_torch.parallel.collectives import check_replicated
    from pymht_tpu_torch.parallel.sharded_tracker import (
        gather_outputs, gather_state, make_sharded_tracker_step,
        shard_state)
    axes = _axes()
    out = {}
    for case in str(data["cases"]).split(","):
        opts = json.loads(str(data[f"{case}.opts"]))
        shapes, params = _config(data, f"{case}.config")
        whole = _state(data, f"{case}.state.")
        scans, ais = _scans(data, f"{case}.", opts["n_scans"])
        for n in opts["ranks"]:
            if n not in axes:
                continue
            axis = axes[n]
            step = make_sharded_tracker_step(axis, shapes, params,
                                             **opts["step"])
            st = shard_state(whole, axis)
            ist = initiator_mod.empty_initiator(shapes, "cpu")
            for k, (sc, ab) in enumerate(zip(scans, ais)):
                st, ist, o = step(st, ist, sc, ab)
                check_replicated(axis, [st.lam, st.next_id, *vars(ist)
                                        .values()], f"{case} scan {k}")
                o = gather_outputs(o, axis)
                o["sel_ais"] = axis.all_gather(
                    st.hist_ais[torch.arange(st.sel_leaf.shape[0]),
                                st.sel_leaf.long(), -1])
                out.update({f"{case}.{n}.scan{k}.{key}": v.numpy()
                            for key, v in o.items()})
            g = gather_state(st, axis)
            for key in ("tgt_window", "tgt_id", "tgt_mask", "next_id",
                        "sel_leaf", "lam"):
                out[f"{case}.{n}.final.{key}"] = getattr(g, key).numpy()
            if opts.get("swarm"):
                local = shard_state(whole, axis)
                n_g = axis.psum(local.tgt_mask.sum(dtype=torch.float32))
                for key, count in (("global", n_g), ("local", None)):
                    gr = grow(local, scans[0], ais[0], shapes, params,
                              n_targets_global=count)
                    out[f"{case}.{n}.grow_{key}"] = axis.all_gather(
                        gr.state.leaf_cnllr).numpy()
    return out


def job_multihost(data) -> dict:
    """On a 2 x 2 ('scenario', 'cluster') mesh: the mesh's groups, the
    measurement exchange, make_sharded_step against make_batched_step
    scan by scan, dryrun(4), dryrun_swarm_cluster(4), and a checkpoint
    restored by rows."""
    import torch
    import torch.distributed as dist
    from pymht_tpu_torch.core.grow import Scan
    from pymht_tpu_torch.parallel import multihost
    from pymht_tpu_torch.parallel import scenario as scen
    from pymht_tpu_torch.parallel.collectives import Axis
    from pymht_tpu_torch.parallel.sharded_tracker import gather_state
    from pymht_tpu_torch.utils.checkpoint import load_state
    rank, world = dist.get_rank(), dist.get_world_size()
    out = {}

    mesh = multihost.hybrid_mesh(2, 2, device_type="cpu")
    scen_ax = Axis.of_mesh(mesh, "scenario")
    clus_ax = Axis.of_mesh(mesh, "cluster")
    out["mesh"] = np.array([mesh.shape[0], mesh.shape[1], scen_ax.index,
                            scen_ax.size, clus_ax.index, clus_ax.size])
    out["mesh_names"] = np.array(",".join(mesh.mesh_dim_names))

    # measurement exchange (tests/multihost_worker.py's check)
    z_local = np.zeros((3, 2), np.float32)
    z_local[:2] = [[10.0 * rank, 1.0], [10.0 * rank, 2.0]]
    z, mask = multihost.gather_local_measurements(
        z_local, np.array([True, True, False]), 8, device="cpu")
    out["z"], out["z_mask"] = z, mask
    # overflow: 8 valid per rank into 12 slots keeps ranks 0 and 1's
    z_many = np.stack([np.full(8, rank, np.float32),
                       np.arange(8, dtype=np.float32)], axis=1)
    out["z_over"] = multihost.gather_local_measurements(
        z_many, np.ones(8, bool), 12, device="cpu")[0]

    # make_sharded_step against make_batched_step, scan by scan
    shapes, params = _config(data)
    B, M = 2, shapes.max_meas
    step, shard = scen.make_sharded_step(mesh, shapes, params)
    plain = scen.make_batched_step(shapes, params)
    whole = scen.batch_states(shapes, params, B, "cpu")
    local = shard(*whole, None)[:2]
    for k in range(len([f for f in data.files if f.startswith("scan")])):
        scan_b = Scan(z=torch.from_numpy(data[f"scan{k}.z"]),
                      mask=torch.ones((B, M), dtype=torch.bool),
                      time=torch.full((B,), float(k + 1)))
        st, ist, o = plain(*whole, scan_b)
        ls, lis, lo = step(*local, shard(*whole, scan_b)[2])
        mine = shard(st, ist, scan_b)
        for name, a, b in (("state", mine[0], ls), ("init", mine[1], lis)):
            for f in dataclasses.fields(a):
                out[f"mh.scan{k}.{name}.{f.name}.ref"] = \
                    getattr(a, f.name).numpy()
                out[f"mh.scan{k}.{name}.{f.name}.got"] = \
                    getattr(b, f.name).numpy()
        for f in ("sel_obj", "track_x", "track_id", "sel_hist_meas"):
            ref = getattr(o, f).narrow(0, scen_ax.index, 1)
            if f in ("track_x", "track_id", "sel_hist_meas"):
                ref = ref.narrow(1, clus_ax.index * (shapes.max_targets
                                                     // 2),
                                 shapes.max_targets // 2)
            out[f"mh.scan{k}.out.{f}.ref"] = ref.numpy()
            out[f"mh.scan{k}.out.{f}.got"] = getattr(lo, f).numpy()
        whole, local = (st, ist), (ls, lis)

    # dryrun(4) against the batched step on its inputs
    st_d, ist_d, o_d = scen.dryrun(world, device="cpu")
    inp = scen.dryrun_inputs(scen.DRYRUN_SHAPES, scen.DRYRUN_PARAMS, 2,
                             "cpu")
    ref = scen.make_batched_step(scen.DRYRUN_SHAPES, scen.DRYRUN_PARAMS)(
        *inp)
    _, dshard = scen.make_sharded_step(mesh, scen.DRYRUN_SHAPES,
                                       scen.DRYRUN_PARAMS)
    ref_local = dshard(ref[0], ref[1], inp[2])
    out["dryrun.leaf_cnllr.got"] = st_d.leaf_cnllr.numpy()
    out["dryrun.leaf_cnllr.ref"] = ref_local[0].leaf_cnllr.numpy()
    out["dryrun.p_x.got"] = ist_d.p_x.numpy()
    out["dryrun.p_x.ref"] = ref_local[1].p_x.numpy()

    # dryrun_swarm_cluster(4): one swarm-shaped scan over the world
    from pymht_tpu_torch.parallel.sharded_tracker import gather_outputs
    _, _, o_sw = scen.dryrun_swarm_cluster(world, device="cpu")
    out.update({f"swarm.{k}": v.numpy()
                for k, v in gather_outputs(o_sw, Axis()).items()})

    # a checkpoint written by the JAX package, restored by rows on the
    # cluster axis and on the whole world
    path = str(data["ckpt"])
    for key, axis in (("cluster", clus_ax), ("world", Axis())):
        st_s, init_s = load_state(path, device="cpu", shard=axis)
        out[f"ckpt.{key}.rows"] = st_s.leaf_x.numpy()
        out[f"ckpt.{key}.gathered"] = gather_state(st_s, axis).leaf_x.numpy()
        out[f"ckpt.{key}.lam"] = st_s.lam.numpy()
        out[f"ckpt.{key}.p_x"] = init_s.p_x.numpy()
    return out


JOBS = {"select": job_select, "tracker": job_tracker,
        "multihost": job_multihost}


def main():
    sys.modules["jax"] = None          # any 'import jax' now raises
    sys.modules["pymht_tpu"] = None    # and so does the JAX package
    job, inputs, out_dir = sys.argv[1:4]
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from pymht_tpu_torch.parallel import multihost
    assert multihost.initialize(device="cpu", backend="gloo",
                                timeout=COLLECTIVE_TIMEOUT_S)
    rank = dist.get_rank()
    out = JOBS[job](np.load(inputs))
    np.savez(os.path.join(out_dir, f"out{rank}.npz"), **out)
    dist.destroy_process_group()
    loaded = [m for m in sys.modules if sys.modules[m] is not None
              and (m.split(".")[0] in ("jax", "pymht_tpu"))]
    assert not loaded, loaded
    print(f"OK rank={rank}", flush=True)


if __name__ == "__main__":
    main()

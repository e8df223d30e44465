"""Where a scan step's time goes on the GPU.

    python -m pymht_tpu_torch.profile_step        # needs a CUDA device
    python -m pymht_tpu_torch.profile_step --ais  # the AIS-fusion scene
    python -m pymht_tpu_torch.profile_step --ais --pregate 64
    python -m pymht_tpu_torch.profile_step --prune-similar --dynamic-window
    python -m pymht_tpu_torch.profile_step --method ipm
    python -m pymht_tpu_torch.profile_step --batch 32        # B scenarios
    python -m pymht_tpu_torch.profile_step --batch 256 --mc
    python -m pymht_tpu_torch.profile_step --batch 32 --ais
    python -m pymht_tpu_torch.profile_step --batch 32 --pregate 64
    python -m pymht_tpu_torch.profile_step --batch 8 --demo --method ipm
    python -m pymht_tpu_torch.profile_step --swarm   # the swarm benchmark
    python -m pymht_tpu_torch.profile_step --eager   # no captured graph
    python -m pymht_tpu_torch.profile_step --batch 32 --eager

Runs the radar-only bench scene (``Tracker(use_ais=False)``) or, with
``--ais``, the AIS-fusion scene (``Tracker(use_ais=True)``, A=32, G=2;
utils/scenes.py) through the port's Tracker on the card; ``--pregate Km``
sets ``radar_cand_width``; ``--method`` names the selection solver
(default ``'lagrangian'``, the production hybrid); ``--prune-similar`` and ``--dynamic-window``
turn on ``scan_step``'s arguments of those names (the stepped Tracker
hands the step only the first; the second is streaming's, given to the
step here so that its device work can be read beside the rest).  With
``--batch B`` it steps B scenarios together through the batched step
(``parallel/scenario.make_batched_step``): B scenarios of
``scenes.mc_bench_scene`` (bench.py's shapes, 100 targets each), with
``--mc`` of ``scenes.mc_scene`` (eval_configs.py's Monte-Carlo
configuration), with ``--ais`` B draws of the AIS-fusion scene
(``scenes.bench_ais_batch``) and with ``--demo`` B draws of the demo
scene (``scenes.demo_batch``, AIS on, 21 scans), each under ``--method``
and ``--pregate``; a "scan" below is then one batched scan.  With
``--swarm`` it profiles the swarm benchmark's 8 scans, streamed in one
``scan_many`` as ``scripts/bench_swarm.run`` streams them (once to warm
up, once under the profiler; no phases alone, and every scan counts).
The Tracker (and with ``--batch`` the batched step) steps the scene as
one captured CUDA graph per scan (core/graph.py) under ``'lagrangian'``,
``'lagrangian_pure'`` and ``'greedy'``, with or without ``--ais`` and
``--pregate``; ``'ipm'`` and ``--eager`` step through the plain
``scan_step`` instead, and
``--eager`` also reports, per loop of ``sync.while_loop`` (by the source
line of its body), the bodies run per scan and the device time per body
(the kernels launched inside it, nested loops included).  Over the steady scans (3 onwards) it reports:

* per phase (grow, select, terminate + prune, initiate), the wall time of
  that phase alone, run on the step's own inputs and closed by
  ``torch.cuda.synchronize()`` — the step itself is then run unchanged;
* a ``torch.profiler`` trace of the whole steps: device time by kernel,
  device busy time per scan and the device's idle share of the window.
  For the graphed step it also reports the device time of one replay
  (CUDA events) and the condition kernel's runs per scan as the device
  counted them: the trace may not hold the kernels that run inside a
  conditional node.

Prints one JSON object.  Nothing here runs on the tracker's hot path.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import sys
import time

import numpy as np
import torch

from . import sync
from .core import initiator as initiator_mod
from .core.grow import grow
from .core.lifecycle import n_scan_prune, terminate
from .core.merge import prune_similar
from .core.select import select
from .core import graph as graph_mod
from .core.tracker import Tracker, scan_step
from .kernels import graph_flow
from .utils.scenes import bench_scene, bench_scene_ais


def _phase_times(state, init_state, scan, ais, shapes, params, method,
                 merge=False):
    """Wall ms of each phase of the next step, run alone on its inputs."""
    out, t = {}, time.perf_counter()

    def lap(name):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        out[name] = 1e3 * (now - t)
        t = now

    n_sync = sync.count
    g = grow(state, scan, ais, shapes, params)
    if merge:
        g = g._replace(state=prune_similar(g.state, shapes, params))
    lap("grow")
    res = select(g.state, shapes, params, method=method)
    lap("select")
    st = g.state.replace(sel_leaf=res.sel, lam=res.lam)
    st = n_scan_prune(terminate(st, shapes, params).state, shapes,
                      params).state
    lap("terminate_prune")
    # (the used-MMSI filter of scan_step, a handful of ops, is left out)
    initiator_mod.step(init_state, scan.z, scan.mask & ~g.used_meas,
                       scan.time, ais, shapes, params)
    lap("initiate")
    out["host_syncs_grow_select_prune_initiate"] = sync.count - n_sync
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ais", action="store_true",
                    help="the AIS-fusion scene through Tracker(use_ais=True)")
    ap.add_argument("--pregate", type=int, default=0, metavar="Km",
                    help="radar_cand_width (0: no spatial pre-gate)")
    ap.add_argument("--method", default="lagrangian",
                    choices=("lagrangian", "ipm", "lagrangian_pure",
                             "greedy"),
                    help="the selection solver (default: lagrangian)")
    ap.add_argument("--prune-similar", action="store_true",
                    help="merge similar sibling hypotheses after grow")
    ap.add_argument("--dynamic-window", action="store_true",
                    help="the on-device window trigger in every step")
    ap.add_argument("--batch", type=int, default=0, metavar="B",
                    help="B scenarios through the batched step")
    ap.add_argument("--mc", action="store_true",
                    help="with --batch: eval_configs.py's Monte-Carlo "
                         "configuration instead of bench.py's shapes")
    ap.add_argument("--demo", action="store_true",
                    help="with --batch: draws of the demo scene (AIS on)")
    ap.add_argument("--swarm", action="store_true",
                    help="the swarm benchmark's streamed scans")
    ap.add_argument("--eager", action="store_true",
                    help="step through the plain scan_step (no graph); "
                         "report each loop's bodies and device time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.swarm:
        return _swarm()
    if args.batch:
        return _batched(args)
    if args.ais:
        shapes, params, scans, groups, _, seeds, mmsi = bench_scene_ais()
    else:
        shapes, params, scans, _, seeds = bench_scene()
        groups, mmsi = [], None
    shapes = dataclasses.replace(shapes, radar_cand_width=args.pregate)

    def messages(i):
        return groups[i] if i < len(groups) else []

    def new_tracker():
        tr = Tracker(shapes, params, method=args.method, use_ais=args.ais,
                     device="cuda", prune_similar=args.prune_similar)
        tr.pre_initialize(scans[0].time - params.radar_period, seeds,
                          mmsi=mmsi)
        if args.eager:
            tr._step = functools.partial(_eager_step, tr)
        if args.dynamic_window:
            tr._step = functools.partial(tr._step, dynamic_window=True)
        return tr

    # pass 1: each phase of each steady step, timed alone
    tr, phases = new_tracker(), []
    for i, s in enumerate(scans):
        if i >= 2:
            packed = tr._pack_inputs(float(s.time) - tr.t0, s.measurements,
                                     messages(i))
            phases.append(_phase_times(tr.state, tr.init_state,
                                       *tr._unpack_inputs(packed), shapes,
                                       params, tr.method, tr.prune_similar))
        tr.add_measurement_list(s.time, s.measurements, messages(i))
    # pass 2: the unchanged steps under the profiler
    tr = new_tracker()
    loops = _LoopRanges() if args.eager else contextlib.nullcontext()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    with loops:
        for i, s in enumerate(scans):
            if i == 2:
                torch.cuda.synchronize()
                prof.__enter__()
                graph_flow.reset_runs()
                t_window = time.perf_counter()
            tr.add_measurement_list(s.time, s.measurements, messages(i))
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t_window)
        prof.__exit__(None, None, None)
    n = len(scans) - 2
    busy_ms, events, top = _device_time(prof)
    graphs = list(tr._graphs.values())
    graphed = {}
    if graphs:
        graphed = {
            "graph_pool_bytes": graphs[0].pool_bytes(),
            "graph_capture_s": graphs[0].capture_s,
            "condition_kernel_runs_per_scan": graph_flow.runs() / n,
            "replay_device_ms": _replay_device_ms(graphs[0])}
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "scene": "ais" if args.ais else "radar",
        "method": args.method,
        "radar_cand_width": args.pregate,
        "prune_similar": args.prune_similar,
        "dynamic_window": args.dynamic_window,
        "ais_messages_per_scan": [min(len(messages(i)), shapes.max_ais)
                                  for i in range(len(scans))],
        "scans_profiled": n,
        "wall_ms_per_scan": wall_ms / n,
        "device_busy_ms_per_scan": busy_ms / n,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "phase_ms_median": {k: float(np.median([p[k] for p in phases]))
                            for k in phases[0]},
        "host_syncs_per_scan": tr.host_syncs,
        "graphed": bool(graphs),
        **graphed,
        **({"loops": _loop_summary(prof, n)} if args.eager else {}),
        **_device_summary(events, top, n),
    }, indent=1))
    return 0


def _eager_step(tr, packed, **kw):
    """``Tracker._step`` through the plain ``scan_step``: no graph."""
    scan, ais = tr._unpack_inputs(packed)
    return scan_step(tr.state, tr.init_state, scan, ais, tr.shapes,
                     tr.params, method=tr.method, use_ais=tr.use_ais,
                     ais_initialization=tr.ais_initialization,
                     prune_similar=tr.prune_similar, **kw)


class _LoopRanges:
    """Inside the block every body of ``sync.while_loop`` runs inside a
    profiler range named after the body's source line."""

    def __enter__(self):
        self.real = sync.while_loop

        def while_loop(cond, body, carry, *a, **kw):
            code = body.__code__
            name = (f"loop {code.co_filename.rsplit('/', 1)[-1]}:"
                    f"{code.co_firstlineno}")

            def ranged(c, active):
                with torch.profiler.record_function(name):
                    return body(c, active)
            return self.real(cond, ranged, carry, *a, **kw)
        sync.while_loop = while_loop
        return self

    def __exit__(self, *exc):
        sync.while_loop = self.real


def _loop_summary(prof, n):
    """Per loop range: bodies per scan and device ms per body (the host
    range's kernels, summed; the range's span on the device is not)."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.key_averages():
        if e.key.startswith("loop ") and e.device_type == DeviceType.CPU:
            dev = getattr(e, "device_time_total",
                          getattr(e, "cuda_time_total", 0.0))
            out[e.key[5:]] = {"bodies_per_scan": e.count / n,
                              "device_ms_per_body": dev / 1e3 / e.count}
    return out


def _replay_device_ms(g, reps=7):
    """Device ms of one replay of the step graph ``g`` on its last scan,
    between two CUDA events behind a device spin, from the same saved
    state each time (a replay writes the next state in place)."""
    keep = (graph_mod.clone_state(g.state),
            graph_mod.clone_state(g.init_state))
    times = []
    for _ in range(reps):
        g.load(*keep)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        a.record()
        g.graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    g.load(*keep)
    return float(np.median(times))


def replays_device_ms(g, state, init_state, inputs):
    """Device ms of each replay of the step graph ``g`` over a run of
    scans from ``state`` / ``init_state``: ``inputs`` yields each scan's
    (Scan, AisBatch or None), copied in before a pair of CUDA events
    around the replay (a scan's loops run as many times as its data
    asks, so one scan's replay is not every scan's)."""
    g.load(state, init_state)
    times = []
    for scan, ais in inputs:
        for buf, src in zip(g.scan, scan):
            buf.copy_(src)
        if g.ais is not None:
            for buf, src in zip(g.ais, ais):
                buf.copy_(src)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def _dev_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def _device_time(prof):
    """(device busy ms, device events, the 20 longest) of a trace."""
    from torch.autograd import DeviceType
    events = [e for e in prof.key_averages()      # kernels and copies
              if e.device_type == DeviceType.CUDA and _dev_us(e) > 0
              and not getattr(e, "is_user_annotation", False)]
    top = sorted(events, key=_dev_us, reverse=True)[:20]
    return sum(_dev_us(e) for e in events) / 1e3, events, top


def _device_summary(events, top, n):
    return {
        "device_ops_per_scan": sum(e.count for e in events) / n,
        "k1": [{"name": e.key[:90], "device_ms_per_call":
                _dev_us(e) / 1e3 / e.count, "calls_per_scan": e.count / n}
               for e in events if "gate_score" in e.key],
        "condition_kernel": [
            {"device_ms_per_call": _dev_us(e) / 1e3 / e.count,
             "calls_per_scan": e.count / n}
            for e in events if "condition_kernel" in e.key],
        "top_device_ops": [
            {"name": e.key[:90], "device_ms_per_scan": _dev_us(e) / 1e3 / n,
             "calls_per_scan": e.count / n} for e in top]}


def _swarm():
    """The swarm benchmark's scans, streamed as ``bench_swarm.run`` streams
    them, once to warm up and once under the profiler."""
    from .scripts import bench_swarm as bs
    k = bs.knobs()
    scene = bs.scene_of(k)
    n = len(scene.scans)

    def once(prof=contextlib.nullcontext()):
        tracker, scan_b, ais_b = bs.stream_inputs(scene, "cuda",
                                                  k["use_ais"])
        torch.cuda.synchronize()
        with prof:
            reads, t = sync.count, time.perf_counter()
            bs.stream(tracker, scan_b, ais_b, k["use_ais"], k["dyn_win"])
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t)
        return wall, sync.count - reads

    warm_ms, _ = once()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    wall_ms, reads = once(prof)
    busy_ms, events, top = _device_time(prof)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "scene": "swarm",
        "scans_profiled": n,
        "wall_ms_per_scan_warm_up": warm_ms / n,
        "wall_ms_per_scan": wall_ms / n,
        "device_busy_ms_per_scan": busy_ms / n,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "host_reads_per_scan": reads / n,
        **_device_summary(events, top, n),
    }, indent=1))
    return 0


def _batched(args):
    """The batched step on B scenarios: phases alone, then the steady
    scans under the profiler, as for one scenario."""
    from .parallel import montecarlo as mc
    from .parallel.scenario import make_batched_step
    from .utils import scenes
    B = args.batch
    if args.ais or args.demo:
        build = scenes.demo_batch if args.demo else scenes.bench_ais_batch
        bs = build(B, device="cuda")
        shapes, params, use_ais, truth = bs.shapes, bs.params, True, None
        S = bs.scans.z.shape[1]

        def initial():
            return bs.state, bs.init_state

        def scan_at(s):
            return bs.scan(s)
    else:
        shapes, params, sc = (scenes.mc_scene if args.mc
                              else scenes.mc_bench_scene)(batch=B)
        sc = mc.McScenario(*(a.to("cuda") for a in sc))
        use_ais, truth, S = False, sc.truth, sc.z.shape[1]

        def initial():
            return mc.initial_states(sc, shapes, params)

        def scan_at(s):
            return mc.scan_batch(sc, s), None
    shapes = dataclasses.replace(shapes, radar_cand_width=args.pregate)
    step = make_batched_step(shapes, params, method=args.method,
                             use_ais=use_ais)

    def eager(st, ist, scan, ais):
        return scan_step(st, ist, scan, ais, shapes, params,
                         method=args.method, use_ais=use_ais)
    if args.eager:
        step = eager

    # pass 1: each phase of each steady batched scan, timed alone, the
    # states advanced eagerly (a graph captured now would hold its pool
    # beside the phases' own memory)
    st, ist = initial()
    phases = []
    for s in range(S):
        scan, ais = scan_at(s)
        if s >= 2:
            phases.append(_phase_times(st, ist, scan, ais, shapes, params,
                                       args.method))
        st, ist, _ = eager(st, ist, scan, ais)
    del st, ist
    torch.cuda.empty_cache()
    # pass 2: the unchanged batched steps under the profiler (a graph is
    # captured at the first scan, outside the profiled window)
    torch.cuda.reset_peak_memory_stats()
    st, ist = initial()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    reads, walls = [], []
    for s in range(S):
        if s == 2:
            torch.cuda.synchronize()
            prof.__enter__()
            graph_flow.reset_runs()
            t_window = time.perf_counter()
        n_sync, t = sync.count, time.perf_counter()
        st, ist, out = step(st, ist, *scan_at(s))
        reads.append(sync.count - n_sync)
        if s < 2:
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t))
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t_window)
    prof.__exit__(None, None, None)
    n = S - 2
    busy_ms, events, top = _device_time(prof)
    K = truth.shape[2] if truth is not None else shapes.max_targets
    graphs = list(getattr(step, "graphs", {}).values())
    graphed = {}
    if graphs:
        g = graphs[0]
        runs = graph_flow.runs()          # the profiled window's
        every = replays_device_ms(g, *initial(),
                                  (scan_at(s) for s in range(S)))
        # the trace holds no kernel of a conditional body: the device's
        # share of the wall is read from the replays' own times
        graphed = {
            "graph_pool_bytes": g.pool_bytes(),
            "graph_capture_s": g.capture_s,
            "condition_kernel_runs_per_scan": runs / n,
            "replay_device_ms": _replay_device_ms(g),
            "replays_device_ms": every,
            "idle_share_beside_replays":
                1.0 - float(np.mean(every[2:])) / (wall_ms / n)}
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "scene": ("demo" if args.demo else "ais" if args.ais
                  else "mc" if args.mc else "mc-bench"),
        "batch": B,
        "shapes": dataclasses.asdict(shapes),
        "method": args.method,
        "use_ais": use_ais,
        "scans_profiled": n,
        "wall_ms_first_two_scans": walls,
        "wall_ms_per_batched_scan": wall_ms / n,
        "scenario_scans_per_s": B * n / (wall_ms / 1e3),
        "device_busy_ms_per_scan": busy_ms / n,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "phase_ms_median": {k: float(np.median([p[k] for p in phases]))
                            for k in phases[0]},
        "host_syncs_per_scan": reads,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "tracks_alive": int(out.track_mask[:, :K].sum()),
        "graphed": bool(graphs),
        **graphed,
        **_device_summary(events, top, n),
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

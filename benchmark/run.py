"""Run one cell of the benchmark of ``pymht_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  The cell (an entry of ``workloads`` in
``BENCHMARK.json``) names a configuration (``benchmark/configs/``) and a
traffic mix (``benchmark/traffic/<name>.json``); both are found by name.
The run first builds the port's kernels (nvcc, into ``build/`` inside the
checkout: only the first run of a checkout compiles), draws the stream
from the seed, builds a ``Tracker`` on the card,
pre-initialises it with the stream's targets, warms it up on a few scans
(the first captures the step), then hands it one scan after another for
``--seconds``
(a closed loop: each scan as soon as the previous scan's outputs are on
the host), and afterwards holds a sample of the window's scans, drawn
from the seed, to the plain reference (``reference.py``).  With
``--trace 1`` the same run also records the per-layer metrics, each read
by its own file ``benchmark/metrics/<name>.py``.  The last line of
standard output is the result, one JSON object; the numbers compared and
their limits end standard error.  Without a CUDA device the run exits
with code 2 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse                                              # noqa: E402
import contextlib                                            # noqa: E402
import dataclasses                                           # noqa: E402
import gc                                                    # noqa: E402
import importlib.util                                        # noqa: E402
import json                                                  # noqa: E402
import subprocess                                            # noqa: E402
import sys                                                   # noqa: E402
import traceback                                             # noqa: E402
from pathlib import Path                                     # noqa: E402

import numpy as np                                           # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]

import reference                                             # noqa: E402
import stream as stream_mod                                  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "pymht_tpu")
CALL = "Tracker.add_measurement_list"    # the traced run's span per scan


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, name: str):
    """(cell, configuration file, traffic file)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"run.py: no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return (cell, load_json(ROOT / conf["file"]),
            load_json(HERE / "traffic" / f"{cell['traffic']}.json"))


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's or
    the JAX package's (names compared whole)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


# -- the stream, scan by scan ---------------------------------------------

class Feed:
    """The stream's scans in order, drawing a block when the last is used
    up; ``draw_s`` is the time spent drawing."""

    def __init__(self, stream):
        self.stream, self.block, self.i, self.b = stream, None, 0, 0
        self.draw_s = 0.0

    def next(self):
        if self.block is None or self.i == len(self.block.times):
            tic = time.perf_counter()
            self.block = self.stream.block(self.b)
            self.draw_s += time.perf_counter() - tic
            self.b, self.i = self.b + 1, 0
        i, blk = self.i, self.block
        self.i += 1
        return blk.times[i], blk.z[i], blk.ais[i]


def padded(t, z, msgs, t0, c: reference.Cfg, use_ais: bool):
    """The scan and AIS batch as the tracker is handed them: the first M
    measurements and the first A messages, times relative to ``t0`` in
    float32 (numpy dicts named as the reference reads them)."""
    M, A = c.M, c.A
    n = min(len(z), M)
    scan = dict(z=np.zeros((M, 2), np.float32), mask=np.arange(M) < n,
                time=np.float32(float(t) - t0))
    scan["z"][:n] = z[:n]
    if not use_ais:
        return scan, None
    ais = dict(state=np.zeros((A, 4), np.float32),
               time=np.zeros(A, np.float32), mmsi=np.zeros(A, np.int32),
               high=np.zeros(A, bool), mask=np.zeros(A, bool))
    for j, m in enumerate(msgs[:A]):
        ais["state"][j] = m.state
        ais["time"][j] = float(m.time) - t0
        ais["mmsi"][j], ais["high"][j] = m.mmsi, m.highAccuracy
        ais["mask"][j] = True
    return scan, ais


def fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def snapshot(obj) -> dict:
    """A state's fields copied to the host (numpy), waiting for the
    device."""
    return {k: v.to("cpu", copy=True).numpy() for k, v in fields(obj).items()}


# -- the traced run's instruments -------------------------------------------

class Instruments:
    """CUDA events around each call of the step graph (copy-in and
    replay), the host-read and loop-iteration counters, and a profiler
    over a short stretch of the window."""

    def __init__(self, torch, n_profiled: int):
        from pymht_tpu_torch import sync
        from pymht_tpu_torch.core import graph
        from pymht_tpu_torch.kernels import graph_flow
        self.torch, self.sync, self.flow = torch, sync, graph_flow
        self.cls = graph.StepGraph
        self.real = self.cls.__call__
        self.events = []
        self.n_profiled = n_profiled
        self.prof = None
        events, real = self.events, self.real

        def timed_call(g, *a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = real(g, *a, **kw)
            e1.record()
            events.append((e0, e1))
            return out

        self.cls.__call__ = timed_call

    def start(self):
        self.reads0, self.runs0 = self.sync.count, self.flow.runs()

    def stop(self):
        self.reads = self.sync.count - self.reads0
        self.runs = self.flow.runs() - self.runs0
        self.cls.__call__ = self.real

    def profile_on(self):
        prof = self.torch.profiler
        self.prof = prof.profile(activities=[prof.ProfilerActivity.CPU,
                                             prof.ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.prof_t0 = time.perf_counter()

    def profile_off(self):
        self.torch.cuda.synchronize()
        self.prof_window_s = time.perf_counter() - self.prof_t0
        self.prof.__exit__(None, None, None)


def device_trace(prof) -> dict:
    """From a profiler trace: K1's calls and device seconds, the device's
    busy seconds (the union of its kernels and copies), the operations
    that took most device time and the longest idle gaps between device
    operations, each named by the host operation running then."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA and e.name == CALL:
            continue        # the span's copy on the device's timeline
        if e.device_type == DeviceType.CUDA:
            dev.append((tr.start, tr.end, e.name))
        elif e.device_type == DeviceType.CPU:
            host.append((tr.start, tr.end, e.name))
    k1 = [(s, t) for s, t, n in dev if "gate_score" in n
          and "startup" not in n]
    per_op = {}
    for s, t, n in dev:
        per_op[n] = per_op.get(n, 0.0) + (t - s) * 1e-6
    dev.sort()
    busy, gaps, end = 0.0, [], None
    for s, t, n in dev:
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    host.sort(key=lambda h: h[0])

    def doing(mid):
        inner = [h for h in host if h[0] <= mid <= h[1]]
        if not inner:
            return "the harness, between two scans"
        name = min(inner, key=lambda h: h[1] - h[0])[2]
        return (f"{CALL}, in Python outside any profiled operation (pack, "
                "fetch, archive update)" if name == CALL else name)

    top_gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return dict(
        k1_calls=len(k1), k1_device_s=sum(t - s for s, t in k1) * 1e-6,
        busy_s=busy * 1e-6,
        device_ops=sorted(([n[:120], s] for n, s in per_op.items()),
                          key=lambda p: -p[1])[:10],
        idle_gaps=[[doing((a + b) / 2)[:120], (b - a) * 1e-6]
                   for a, b in top_gaps])


def load_metric(name: str):
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_')}", HERE / "metrics"
        / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def hardware(torch) -> dict:
    kind = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        limit = f"nvidia-smi failed: {e}"
    return dict(kind=kind, nvidia_smi=limit)


# -- one run ------------------------------------------------------------------

def build_kernels() -> float:
    """Build the port's two CUDA sources side by side, unless built;
    returns the seconds it took."""
    from concurrent.futures import ThreadPoolExecutor
    from pymht_tpu_torch.kernels import build
    tic = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(build.build, ("gate_score", "graph_flow")))
    return time.perf_counter() - tic


def run_cell(conf_file, traffic, seed, seconds, trace, device="cuda",
             tracker_hook=None, keep_checks=False):
    """One run of a cell (its configuration and traffic files); returns
    the result's fields and the numbers compared.  ``tracker_hook
    (tracker)`` lets a test break the system under the harness, and
    ``keep_checks`` keeps the checked scans (the control's inputs); the
    benchmark's own runs use neither."""
    import torch
    from pymht_tpu_torch import Tracker, TrackerParams, TrackerShapes
    parts = dict(imports_s=time.perf_counter() - T_START)
    if device == "cuda":
        parts["build_s"] = build_kernels()
        log(f"build {parts['build_s']:.3f} s (the port's CUDA sources; "
            "only a checkout's first run compiles them)")
    tic = time.perf_counter()
    c = reference.Cfg(conf_file)
    params = dict(conf_file["params"])
    params["position"] = tuple(params["position"])
    shapes = TrackerShapes(**conf_file["shapes"])
    params = TrackerParams(**params)
    use_ais = bool(conf_file["use_ais"])
    period = params.radar_period
    stream = stream_mod.Stream(traffic, dict(period=period,
                                             range=params.radar_range), seed)
    feed = Feed(stream)
    tracker = Tracker(shapes, params, method=conf_file["method"],
                      use_ais=use_ais, device=device)
    x0, mmsi0 = stream.initial
    tracker.pre_initialize(0.0, x0, mmsi=mmsi0 if use_ais else None)
    parts["tracker_s"] = time.perf_counter() - tic
    t0 = 0.0 - period           # the tracker's time origin
    if tracker_hook is not None:
        tracker_hook(tracker)
    sync = (torch.cuda.synchronize if device == "cuda"
            else (lambda: None))
    n_over = [0, 0]

    def hand(t, z, msgs):
        n_over[0] += max(0, len(z) - c.M)
        n_over[1] += max(0, len(msgs) - c.A)
        return tracker.add_measurement_list(t, z, msgs if use_ais else None)

    warm = int(traffic["warmup_scans"])
    for i in range(warm):
        tic = time.perf_counter()
        hand(*feed.next())
        part = "first_scan_s" if i == 0 else "warm_scans_s"
        parts[part] = parts.get(part, 0.0) + time.perf_counter() - tic
    sync()
    setup_s = time.perf_counter() - T_START
    parts["drawing_s"] = feed.draw_s
    log(f"set-up {setup_s:.3f} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items()) + " (the first scan "
        "captures the step; drawing is inside the scans' times)")

    rng = stream_mod.key(seed, 2)
    check_at = sorted(rng.uniform(0.05, 0.95, int(traffic["check_scans"]))
                      * seconds)
    inst = Instruments(torch, int(traffic["trace_scans"])) if trace else None
    prof_from = 64                  # the profiled stretch's first scan
    lat, failed, checks, profiled = [], 0, [], set()
    draw0 = feed.draw_s
    paused = 0.0
    if inst:
        inst.start()
    w0 = time.perf_counter()
    n = 0
    while time.perf_counter() - w0 - paused < seconds:
        tic = time.perf_counter()
        t, z, msgs = feed.next()
        check = bool(check_at) and tic - w0 - paused >= check_at[0]
        if check:
            check_at.pop(0)
            pre = (snapshot(tracker.state), snapshot(tracker.init_state))
        if inst and n == prof_from:
            inst.profile_on()
        paused += time.perf_counter() - tic
        t1 = time.perf_counter()
        try:
            with (torch.profiler.record_function(CALL) if inst
                  else contextlib.nullcontext()):
                out = hand(t, z, msgs)
        except Exception:                                  # noqa: BLE001
            failed += 1
            out = None
            log(traceback.format_exc())
        t2 = time.perf_counter()
        lat.append(t2 - t1)
        tic = time.perf_counter()
        if inst and prof_from <= n < prof_from + inst.n_profiled:
            profiled.add(n)
            if n == prof_from + inst.n_profiled - 1:
                inst.profile_off()
        if check and out is not None:
            checks.append((pre, (snapshot(tracker.state),
                                 snapshot(tracker.init_state)),
                           out._asdict(), padded(t, z, msgs, t0, c, use_ais)))
        paused += time.perf_counter() - tic
        n += 1
    window_s = time.perf_counter() - w0 - paused
    if inst:
        sync()
        inst.stop()
    log(f"window {window_s:.3f} s, {n} scans, {failed} failed; drawing "
        f"{feed.draw_s - draw0:.3f} s and snapshots kept out of it; "
        f"dropped beyond capacity: {n_over[0]} measurements, {n_over[1]} "
        f"AIS messages")
    mem = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    live = max([int(ck[0][0]["tgt_mask"].sum()) for ck in checks],
               default=0)
    res = dict(attempted=n, failed=failed, window_s=window_s, lat=lat,
               setup_s=setup_s, setup_parts=parts, memory_peak_bytes=mem,
               live_tracks=live)
    if inst:
        ev = [a.elapsed_time(b) for a, b in inst.events]
        keep = [i for i in range(len(ev)) if i not in profiled]
        tr = device_trace(inst.prof)
        res["trace"] = dict(
            config=conf_file, scans=n, host_reads=inst.reads,
            flow_runs=inst.runs, replay_ms=[ev[i] for i in keep],
            call_s=[lat[i] for i in keep], profiled_scans=len(profiled),
            profiled_window_s=inst.prof_window_s, **tr)
    # the check, with the system's state freed first
    del tracker, inst
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    tic = time.perf_counter()
    res["numbers"], res["left_out"] = judge_all(
        checks, c, "cuda" if device == "cuda" else "cpu")
    res["checked"] = len(checks)
    if keep_checks:
        res["checks"] = checks
    log(f"reference over {len(checks)} scans: "
        f"{time.perf_counter() - tic:.3f} s")
    return res


def judge_all(checks, c, device) -> tuple:
    """The numbers over all checked scans (counts summed, the rest the
    largest over the scans), and the rows and targets left out as on the
    edge of a decision."""
    total = dict.fromkeys(reference.NUMBERS, 0.0)
    parts, excused = {}, 0
    for (pre, pre_i), (post, post_i), out, (scan, ais) in checks:
        n = reference.judge(pre, pre_i, scan, ais, c, post, post_i, out,
                            device=device)
        excused += n.pop("excused")
        for line in n.pop("differ"):
            log(f"initiator row differs: {line}")
        for k, v in n.pop("parts").items():
            parts[k] = max(parts.get(k, 0.0), v)
        for k, v in n.items():
            total[k] = (total[k] + v if k.endswith("mismatch")
                        else max(total[k], v))
    log("state_err by kind: " + ", ".join(f"{k} {v:.3e}"
                                          for k, v in parts.items()))
    log(f"initiator rows left out as on the edge of a decision: {excused}")
    return total, excused


def verdict(res, limits) -> tuple:
    """(correct, the numbers compared beside their limits)."""
    check = {"failed_scans": dict(value=res["failed"], limit=0),
             "checked_scans": dict(value=res["checked"],
                                   limit=f">= {limits['checked_scans']}")}
    ok = res["failed"] == 0 and res["checked"] >= limits["checked_scans"]
    for k, v in res["numbers"].items():
        lim = limits[k]
        check[k] = dict(value=v, limit=lim)
        ok = ok and v <= lim
    return ok, check


def percentile(xs, q) -> float:
    """The q-th percentile (numpy's linear interpolation)."""
    return float(np.percentile(np.asarray(xs, np.float64), q))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    bench = load_json(ROOT / "BENCHMARK.json")
    cell, conf_file, traffic = find_cell(bench, args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        log(f"run.py: {args.workload} needs {cell['chips']} CUDA "
            f"device(s); torch sees {torch.cuda.device_count()}")
        return 2
    res = run_cell(conf_file, traffic, args.seed, args.seconds,
                   bool(args.trace))
    hw = hardware(torch)
    log(f"device: {hw['nvidia_smi']}")
    bad = forbidden_modules()
    if bad:
        log(f"run.py: the process loaded {bad}: the benchmark may run "
            f"neither JAX nor the JAX package")
        return 3
    limits = load_json(HERE / "limits" / f"{cell['config']}.json")
    correct, check = verdict(res, limits)
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]
             + bench["per_layer"]}
    lat_ms = [s * 1e3 for s in res["lat"]]
    log(f"per-scan ms: median {percentile(lat_ms, 50):.4f}, p99 "
        f"{percentile(lat_ms, 99):.4f}, max {max(lat_ms):.4f} over "
        f"{len(lat_ms)} scans; most live tracks at a checked scan "
        f"{res['live_tracks']}; peak device memory "
        f"{res['memory_peak_bytes']} B")
    device = dict(platform="gpu", kind=hw["kind"], count=1,
                  memory_peak_bytes=int(res["memory_peak_bytes"]))
    line = dict(correct=bool(correct), attempted=res["attempted"],
                failed=res["failed"], metrics={}, device=device)
    if not args.trace:
        values = dict(scans_per_s=res["attempted"] / res["window_s"],
                      scan_ms_p99=percentile(lat_ms, 99),
                      setup_s=res["setup_s"])
        for m in bench["end_to_end"]:
            if args.workload in m.get("workloads", [args.workload]):
                line["metrics"][m["name"]] = dict(value=values[m["name"]],
                                                  unit=m["unit"])
    else:
        tr = res["trace"]
        for m in bench["per_layer"]:
            if args.workload not in m.get("workloads", [args.workload]):
                continue
            v = load_metric(m["name"]).read(tr)
            if v is not None:
                line["metrics"][m["name"]] = dict(value=v,
                                                  unit=units[m["name"]])
        device.update(busy_s=tr["busy_s"], window_s=tr["profiled_window_s"])
        line["breakdown"] = dict(device_ops=tr["device_ops"],
                                 idle_gaps=tr["idle_gaps"])
        log(f"trace: {tr['profiled_scans']} scans profiled, K1 "
            f"{tr['k1_calls']} calls, {tr['k1_device_s']:.6f} s; "
            f"power limit {hw['nvidia_smi']}")
    line["setup_parts"] = res["setup_parts"]
    line["check"] = check
    for k, v in check.items():
        log(f"check {k}: {v['value']} (limit {v['limit']})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

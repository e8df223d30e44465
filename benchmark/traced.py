"""Run one cell of the benchmark as ``run.py`` does, with the program's own
tracer on (``pymht_tpu_torch.utils.timing``), from the root of a
checkout:

    python3 benchmark/traced.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

The tracer is switched on before the ``Tracker`` is built, so the step
graph is captured with its phase stamps.  ``run.py`` runs unchanged and
prints its result line; this script then prints one more JSON line, the
program's trace of the window: the step's phases from the stamps, the
host spans per scan, the condition kernel's runs per node, captures and
pool bytes, the stamps' place inside their scans' spans, and the four
phases' share of each step graph call's events.  With ``--trace 1`` the
trace starts with ``run.py``'s window and leaves out its profiled
stretch, as ``replay_ms`` does, and is read after the window's counts
are taken; with ``--trace 0`` it holds the whole run, warm-up scans left
out.  The calibration and the table of loops end standard error.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import run                                                   # noqa: E402

# the metrics a traced benchmark run would read from the summary, each
# the sum of these summary entries
METRICS = dict(grow_ms=("grow_ms",), select_ms=("select_ms",),
               prune_ms=("prune_ms",), initiate_ms=("initiate_ms",),
               pack_ms=("pack_ms", "upload_ms"), absorb_ms=("absorb_ms",),
               gc_ms_per_scan=("gc_ms",))


def inside_share(trace) -> float:
    """The share of the window's scans whose five stamps lie inside their
    ``scan`` span (host clock)."""
    sp, st, first = trace["spans"], trace["stamps"], trace["first_step"]
    hits = []
    for k in range(len(sp["id"])):
        if sp["name"][k] != "scan" or sp["parent"][k] >= 0:
            continue
        r = sp["scan"][k] - first
        if 0 <= r < len(st) and (st[r] > 0).all():
            hits.append(sp["start"][k] <= st[r, 0]
                        and st[r, -1] <= sp["end"][k])
    return sum(hits) / len(hits) if hits else None


def main(argv=None) -> int:
    from pymht_tpu_torch.utils import timing
    args = list(sys.argv[1:] if argv is None else argv)
    traced = "--trace" in args and args[args.index("--trace") + 1] == "1"
    held = {}
    inst_cls = run.Instruments
    real = dict(start=inst_cls.start, stop=inst_cls.stop,
                on=inst_cls.profile_on, off=inst_cls.profile_off)

    def start(inst):
        real["start"](inst)
        timing.reset()

    def profile_on(inst):
        held["profiled_from"] = timing.TRACE.steps
        real["on"](inst)

    def profile_off(inst):
        real["off"](inst)
        held["profiled_to"] = timing.TRACE.steps

    def stop(inst):
        real["stop"](inst)
        held["trace"] = timing.read()
        held["events_ms"] = [a.elapsed_time(b) for a, b in inst.events]

    inst_cls.start, inst_cls.stop = start, stop
    inst_cls.profile_on, inst_cls.profile_off = profile_on, profile_off
    timing.trace_on()
    try:
        rc = run.main(args)
    finally:
        for k, v in dict(start=real["start"], stop=real["stop"],
                         profile_on=real["on"],
                         profile_off=real["off"]).items():
            setattr(inst_cls, k, v)
    if rc != 0:
        return rc
    if traced:
        trace = held["trace"]
        skip = range(held.get("profiled_from", 0),
                     held.get("profiled_to", 0))
    else:
        trace = timing.read()
        bench = run.load_json(run.ROOT / "BENCHMARK.json")
        _, _, traffic = run.find_cell(bench, args[args.index(
            "--workload") + 1])
        skip = range(int(traffic["warmup_scans"]))
    timing.trace_off()
    s = timing.summary(trace, skip)
    out = dict(metrics={k: sum(s.get(p) or 0.0 for p in parts)
                        for k, parts in METRICS.items()},
               summary=s, stamps_inside_scan=inside_share(trace),
               calibration=trace["calibration"])
    if traced:
        ev, st = held["events_ms"], trace["stamps"]
        keep = [i for i in range(len(ev)) if i not in skip]
        rows = [(i, i - trace["first_step"]) for i in keep]
        share = sorted((st[r, -1] - st[r, 0]) * 1e-6 / ev[i] for i, r in rows
                       if 0 <= r < len(st) and (st[r] > 0).all())
        out["phase_share_of_events"] = dict(
            min=share[0], median=share[len(share) // 2], max=share[-1],
            n=len(share))
        out["events_ms_mean"] = sum(ev[i] for i in keep) / len(keep)
    run.log(f"calibration (host ns, device ns, window ns): "
            f"{trace['calibration']}")
    n = max(1, s["scans"])
    for name, runs in sorted(s["node_runs"].items(), key=lambda x: -x[1]):
        run.log(f"loop {name}: {runs / n:.3f} runs/scan")
    print(json.dumps(out, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

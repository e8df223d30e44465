"""The readings that the limits of ``benchmark/limits/`` are set from.

    python3 benchmark/control.py --workload <cell> --seconds <s> \\
        --seeds <n,n,...> [--control-seeds <n,n,...>] [--fault <name>]

For each seed of ``--seeds``: one run of the cell as ``run.py`` makes it
(the window at the cell's own load, ``--seconds`` long), with its
checked scans held to the reference: the system's readings, whose
largest over a dozen seeds or more is each number's lower reading.  For
each seed of ``--control-seeds`` the same, and then on the same checked
scans the reference itself, computed in bfloat16 (the precision below
the configuration's float32), is put in the system's place and judged:
the control's readings, whose smallest is each number's upper reading.
With ``--fault`` (a name of ``faults.FAULTS``) the runs of ``--seeds``
have that fault planted in the timed path: their readings have to fail.
One JSON line per run.  The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import faults
import reference
import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        run.log("control.py: no CUDA device")
        return 2
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    _, conf_file, traffic = run.find_cell(bench, args.workload)
    c = reference.Cfg(conf_file)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl = [int(s) for s in args.control_seeds.split(",") if s]
    for seed in seeds + ctl:
        fault = args.fault if seed in seeds else None
        res = run.run_cell(conf_file, traffic, seed, args.seconds, False,
                           keep_checks=seed in ctl,
                           tracker_hook=fault and faults.FAULTS[fault])
        limits = run.load_json(run.HERE / "limits"
                               / f"{conf_file['name']}.json")
        correct, _ = run.verdict(res, limits)
        print(json.dumps(dict(kind=f"fault {fault}" if fault else "system",
                              seed=seed, correct=correct,
                              scans=res["attempted"], failed=res["failed"],
                              checked=res["checked"], **res["numbers"])),
              flush=True)
        for (pre, pre_i), _, _, (scan, ais) in res.get("checks", []):
            tic = time.perf_counter()
            try:
                post, post_i, out = reference.control(
                    pre, pre_i, scan, ais, c, device="cuda")
                n = reference.judge(pre, pre_i, scan, ais, c, post, post_i,
                                    out, device="cuda")
                n.pop("parts")
                n.pop("excused"), n.pop("differ")
            except Exception as e:                         # noqa: BLE001
                n = dict(error=repr(e)[:300])
            print(json.dumps(dict(kind="control", seed=seed, **n,
                                  seconds=time.perf_counter() - tic)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

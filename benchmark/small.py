"""Tiny copies of the benchmark's configurations and traffic mixes, for
the tests on the CPU: the same files with fewer targets, slots, leaves
and measurements, on a radar disc scaled with the population so that
its density of targets and clutter stays the same."""
from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
SHAPES = {
    "swarm1000": dict(max_targets=40, max_leaves=8, max_meas=128,
                      max_ais=16, max_initiators=128, max_prelim=16,
                      radar_cand_width=32),
}
SCALE = {"swarm1000": 0.03}
TRAFFIC = {"swarm1000": "swarm_ais"}


def small(config: str, **traffic_kw):
    """(configuration, traffic) dicts of ``config`` cut for a CPU test."""
    cfg = json.loads((HERE / "configs" / f"{config}.json").read_text())
    tr = json.loads((HERE / "traffic" / f"{TRAFFIC[config]}.json")
                    .read_text())
    s = SCALE[config]
    cfg["shapes"].update(SHAPES[config])
    cfg["params"]["radar_range"] *= s ** 0.5
    tr.update(n_targets=int(tr["n_targets"] * s), warmup_scans=8,
              check_scans=3, block_scans=32,
              spawn_radius=tr["spawn_radius"] * s ** 0.5)
    tr.update(traffic_kw)
    return cfg, tr

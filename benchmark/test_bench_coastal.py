"""The coastal cell on the CPU: its files load and agree with
``BENCHMARK.json``, and a few scans of a small copy run through
``run_cell`` with every checked scan held to the reference."""
import json
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))


def _load(*parts):
    return json.loads(HERE.joinpath(*parts).read_text())


def test_coastal_files_load():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = {c["name"]: c for c in bench["configs"]}["coastal100"]
    cell = {w["name"]: w for w in bench["workloads"]}["coastal100.steady"]
    assert cell["config"] == "coastal100" and cell["chips"] == 1
    cfg = json.loads((ROOT / conf["file"]).read_text())
    traffic = _load("traffic", f"{cell['traffic']}.json")
    limits = _load("limits", "coastal100.json")
    assert cfg["name"] == "coastal100" and cfg["reduced"] == conf["reduced"]
    assert cfg["shapes"]["max_targets"] == 128
    assert cfg["shapes"]["max_leaves"] == 32
    assert cfg["shapes"]["max_meas"] == 512
    assert cfg["shapes"]["radar_cand_width"] == 0
    assert not cfg["use_ais"] and cfg["method"] == "lagrangian"
    assert "ais" not in traffic and traffic["n_targets"] == 100
    assert limits["sel_gap"] == cfg["guarantees"]["selection_gap"] == 1e-3
    # the program is handed the guarantee, and certifies it
    assert cfg["params"]["selection_gap"] == limits["sel_gap"]
    assert limits["score_err"] == 1e-3
    from pymht_tpu_torch import TrackerParams, TrackerShapes
    TrackerShapes(**cfg["shapes"])
    TrackerParams(**dict(cfg["params"],
                         position=tuple(cfg["params"]["position"])))
    for m in bench["per_layer"]:
        if m["name"].startswith("select_finish"):
            assert m["workloads"] == ["coastal100.steady"]
            assert (HERE / "metrics" / f"{m['name']}.py").exists()


def test_finish_metrics_read_the_counters():
    """The two readers give the program's counters as ratios, and nothing
    where a counter they divide by reads zero."""
    import run
    from pymht_tpu_torch.utils import timing
    share = run.load_metric("select_finish_share")
    iters = run.load_metric("select_finish_iters")
    c = timing.counters()
    want_share = (100.0 * c["finish_entered"] / c["select_tier3"]
                  if c["select_tier3"] else None)
    want_iters = (c["finish_iters"] / c["finish_entered"]
                  if c["finish_entered"] else None)
    assert share.read({}) == want_share and iters.read({}) == want_iters


def test_coastal_cell_runs_small_on_the_cpu():
    """A copy of the cell cut to 24 target slots and 16 leaves (the
    density of targets and clutter kept), run for a second on the CPU:
    scans complete and the checked ones read ``correct``."""
    import run
    torch = pytest.importorskip("torch")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = _load("configs", "coastal100.json")
        traffic = _load("traffic", "coastal_steady.json")
        s = 0.12
        cfg["shapes"].update(max_targets=24, max_leaves=16, max_meas=128,
                             max_initiators=128, max_prelim=16)
        cfg["params"]["radar_range"] *= s ** 0.5
        traffic.update(n_targets=int(traffic["n_targets"] * s),
                       spawn_radius=traffic["spawn_radius"] * s ** 0.5,
                       warmup_scans=4, check_scans=3)
        res = run.run_cell(cfg, traffic, 2147483901, 1.0, False,
                           device="cpu")
    finally:
        torch.set_num_threads(n)
    limits = _load("limits", "coastal100.json")
    correct, check = run.verdict(res, dict(limits, checked_scans=3))
    assert res["attempted"] > 0 and res["failed"] == 0
    assert correct, check

"""The port's benchmark and evaluation scripts on the CPU at tiny sizes
(``--device cpu``): each prints the JAX script's JSON keys, and what it
computes agrees with the JAX package.

* ``scripts.bench_swarm``: the swarm scene (``utils/scenes.swarm_scene``)
  at 24 targets in T=64 slots streamed through the port's ``scan_many``
  selects, scan for scan, the labels (radar and MMSI) that the JAX
  package's ``Tracker`` + ``scan_many`` select on the same scene; the
  script's line carries bench_swarm.py's keys plus the host reads and K1
  launches per scan.
* ``scripts.bench_saturation``: two points, bench_saturation.py's rows
  and summary line.
* ``scripts.eval_configs``: configuration 1 gives the JAX package's
  metrics (eval_configs.run_config on the same scene); ``main`` prints
  the six configurations with the JAX script's keys.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from pymht_tpu.core.config import TrackerParams, TrackerShapes  # noqa: E402
from pymht_tpu.core.tracker import Tracker as JTracker  # noqa: E402
from pymht_tpu.core.tracker import scan_many as jscan_many  # noqa: E402
from pymht_tpu_torch.core.tracker import outputs_to_host  # noqa: E402
from pymht_tpu_torch.scripts import bench_saturation, bench_swarm  # noqa: E402
from pymht_tpu_torch.scripts import eval_configs  # noqa: E402
from pymht_tpu_torch.utils import scenes  # noqa: E402

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# bench_swarm.py:217-235 (SWARM_r05.json's "ais_on" is one such line)
SWARM_KEYS = {"metric", "value", "unit", "vs_real_time", "n_targets",
              "tracks_alive_last_scan", "mean_meas_per_scan",
              "mean_ais_per_scan", "median_dual_gap",
              "opt_gap_vs_exact_oracle", "oracle_proven_optimal",
              "truth_coverage", "rms_matched_m", "dynamic_window",
              "smooth_1000tracks_one_dispatch_ms", "hardware"}
# bench_saturation.py:150-159 and :166-172
SAT_ROW_KEYS = {"targets", "meas_per_scan", "beam", "pregate", "grow_ms",
                "select_ms", "rest_ms", "full_ms", "us_per_target",
                "coverage", "rms_m"}
SAT_SUMMARY_KEYS = {"metric", "points", "knee_targets", "bottleneck_at_max",
                    "hardware"}


def tiny_swarm(n_scans=3):
    """The swarm scene at 24 targets in T=64 slots, M=1024, A=32."""
    return scenes.swarm_scene(24, n_scans, 1024, 32, t_cap=64)


def lines(out):
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def test_jax_swarm_record_has_the_keys():
    """SWARM_KEYS are those of a line bench_swarm.py printed."""
    with open(os.path.join(REPO_ROOT, "SWARM_r05.json")) as fh:
        assert set(json.load(fh)["ais_on"]) == SWARM_KEYS


def test_swarm_scene_labels_match_jax():
    scene = tiny_swarm()
    assert scene.shapes.max_targets == 64 and len(scene.seeds) == 24
    assert len(scene.scans) == 3 and scene.ais_groups
    # the port: the script's own stream
    tr, scan_b, ais_b = bench_swarm.stream_inputs(scene, torch.device("cpu"),
                                                  True)
    outs_t = outputs_to_host(bench_swarm.stream(tr, scan_b, ais_b, True)[2])
    # the JAX package on the same scene
    shapes = TrackerShapes(**{f.name: getattr(scene.shapes, f.name)
                              for f in dataclasses.fields(scene.shapes)})
    params = TrackerParams(**dataclasses.asdict(scene.params))
    trj = JTracker(shapes, params, method="lagrangian", use_ais=True)
    trj.pre_initialize(scene.scans[0].time - params.radar_period,
                       scene.seeds, mmsi=scene.mmsi)
    sb, ab = trj.make_stream_inputs(scene.scans, scene.ais_groups[:3])
    outs_j = jax.device_get(jax.jit(lambda st, ist, s, a: jscan_many(
        st, ist, s, a, shapes, params, method="lagrangian",
        use_ais=True))(trj.state, trj.init_state, sb, ab)[2])
    np.testing.assert_array_equal(outs_t.track_mask, outs_j.track_mask)
    live = outs_t.track_mask
    for f in ("track_id", "sel_hist_meas", "sel_hist_mmsi"):
        np.testing.assert_array_equal(getattr(outs_t, f)[live],
                                      np.asarray(getattr(outs_j, f))[live],
                                      err_msg=f)
    np.testing.assert_allclose(outs_t.track_x[live],
                               np.asarray(outs_j.track_x)[live], rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(outs_t.sel_obj, outs_j.sel_obj, rtol=1e-4,
                               atol=1e-3)
    assert (outs_t.sel_hist_mmsi[live] != 0).any()      # AIS was fused


def test_bench_swarm_prints_the_jax_keys(monkeypatch, capsys):
    monkeypatch.setattr(bench_swarm, "scene_of", lambda k: tiny_swarm(2))
    monkeypatch.setenv("SWARM_ORACLE_LIMIT", "60")
    bench_swarm.main(["--device", "cpu"])
    (line,) = lines(capsys.readouterr().out)
    assert set(line) == SWARM_KEYS | {"host_reads_per_scan",
                                      "k1_launches_per_scan"}
    assert line["n_targets"] == 24 and line["tracks_alive_last_scan"] >= 20
    assert line["oracle_proven_optimal"] is True
    assert line["opt_gap_vs_exact_oracle"] <= 1e-3
    assert line["truth_coverage"] > 0.9 and line["rms_matched_m"] < 6.0
    assert line["hardware"].startswith("cpu")
    assert line["k1_launches_per_scan"] == 0      # the CPU runs the twin
    assert line["host_reads_per_scan"] > 0


def test_bench_saturation_prints_the_jax_rows(monkeypatch, capsys):
    monkeypatch.setenv("SAT_POINTS", "32,48")
    monkeypatch.setenv("SAT_SCANS", "2")
    monkeypatch.setenv("SAT_REPS", "1")
    bench_saturation.main(["--device", "cpu"])
    out = lines(capsys.readouterr().out)
    assert [r["metric"] for r in out] == ["saturation_point"] * 2 + [
        "chip_saturation_curve"]
    for r, T in zip(out, (32, 48)):
        assert set(r) == SAT_ROW_KEYS | {"metric"} and r["targets"] == T
        assert r["coverage"] > 0.9
    assert set(out[-1]) == SAT_SUMMARY_KEYS
    assert out[-1]["points"] == [{k: v for k, v in r.items()
                                  if k != "metric"} for r in out[:2]]


def _jax_eval_configs():
    sys.path.insert(0, REPO_ROOT)
    try:
        import eval_configs as jeval
    finally:
        sys.path.remove(REPO_ROOT)
    return jeval


def test_eval_config1_equals_jax(capsys):
    jeval = _jax_eval_configs()
    args = ("1_crossing", 2, 0.0, 1.0, 5, eval_configs.SMALL)
    m_j = jeval.run_config(*args, radar_range=2000.0)
    m_t = eval_configs.run_config(*args, radar_range=2000.0, device="cpu")
    assert m_t == m_j
    assert m_t["n_tracked"] == 2 and m_t["track_percent"] > 0.7


def test_eval_configs_main_prints_six_configs(monkeypatch, capsys,
                                              tmp_path):
    monkeypatch.setenv("EVAL_OUT", str(tmp_path / "eval.json"))
    eval_configs.main(["--device", "cpu"])
    out = lines(capsys.readouterr().out)
    with open(os.path.join(REPO_ROOT, "EVAL_r05.json")) as fh:
        jax_keys = [set(c) for c in json.load(fh)["configs"]]
    assert [c["config"] for c in out] == [
        "1_crossing", "2_10tgt_clutter", "3_50tgt_dense", "4_mc_batch",
        "5_ais_swarm", "2_ipm_xcheck"]
    assert [set(c) for c in out] == jax_keys
    with open(tmp_path / "eval.json") as fh:
        assert json.load(fh) == {"scale": "small", "configs": out}
    mc = out[3]
    assert mc["tracks_alive"] >= 0.9 * mc["expected"]

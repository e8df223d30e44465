"""``scripts.bench``, the port's headline benchmark, on the CPU at a tiny
size (8 targets, 3 scans, M=256; ``--device cpu`` runs K1's plain twin).

* ``main`` prints one JSON line with bench.py's keys plus the hardware,
  the host reads and the K1 launches per scan;
* the knobs are read when ``knobs()`` is called, and reach the scenes;
* a streamed path leaves its input state, scans and AIS batch bitwise
  as they were, so its repetitions start from the same state and give
  the same outputs;
* path B2 (clusters on) selects path B's labels, and path B selects,
  scan for scan, path A's (stepped one call per scan).
"""
import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pymht_tpu_torch.scripts import bench  # noqa: E402

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"BENCH_TARGETS": "8", "BENCH_SCANS": "3", "BENCH_MEAS": "256"}
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The step is thousands of small ops: torch's intra-op thread pool
    adds only contention when several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_keys():
    """The keys of a line bench.py printed (BENCH_r05.json)."""
    with open(os.path.join(REPO_ROOT, "BENCH_r05.json")) as fh:
        return set(json.load(fh)["parsed"])


@pytest.fixture(scope="module")
def ran():
    """``main(['--device', 'cpu'])`` at TINY: (its stdout, its result)."""
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        for var in bench._ENV.values():
            mp.delenv(var, raising=False)
        for var, v in TINY.items():
            mp.setenv(var, v)
        with contextlib.redirect_stdout(buf):
            result = bench.main(["--device", "cpu"])
    return buf.getvalue(), result


def test_main_prints_one_line_with_the_jax_keys(ran):
    out, (result, _) = ran
    lines = out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == result
    assert set(line) == jax_keys() | {"hardware", "host_reads_per_scan",
                                      "k1_launches_per_scan"}
    assert line["metric"] == "ms_per_scan_100tgt_highclutter"
    assert line["n_targets"] == 8 and line["method"] == "lagrangian"
    assert line["value"] > 0 and line["dispatch_ms_per_scan"] > 0
    # value is rounded to 3 decimals, vs_baseline to 4
    assert abs(line["vs_baseline"] - 10.0 / line["value"]) <= 1e-4
    assert line["opt_gap_vs_exact_oracle"] is not None
    assert abs(line["opt_gap_vs_exact_oracle"]) <= 1e-3
    assert line["hardware"].startswith("cpu")
    assert set(line["host_reads_per_scan"]) == {"A", "B"}
    assert all(v > 0 for v in line["host_reads_per_scan"].values())
    # the CPU runs K1's twin, which counts no launch
    assert line["k1_launches_per_scan"] == {"A": 0.0, "B": 0.0, "B2": 0.0,
                                            "C": 0.0}


def test_knobs_are_read_at_call_time(monkeypatch):
    for var in bench._ENV.values():
        monkeypatch.delenv(var, raising=False)
    assert bench.knobs() == bench.DEFAULTS
    shapes = bench.radar_scene(dict(bench.DEFAULTS, n_scans=1))[0]
    assert (shapes.max_targets, shapes.max_leaves, shapes.max_meas,
            shapes.max_initiators, shapes.window, shapes.max_prelim,
            shapes.radar_cand_width) == (128, 32, 512, 512, 7, 64, 0)
    env = {"BENCH_TARGETS": "5", "BENCH_SCANS": "2", "BENCH_MEAS": "64",
           "BENCH_METHOD": "greedy", "BENCH_PREGATE": "16", "BENCH_AIS": "4"}
    for var, v in env.items():
        monkeypatch.setenv(var, v)
    k = bench.knobs()
    assert k == dict(n_targets=5, n_scans=2, meas=64, method="greedy",
                     pregate=16, a_cap=4)
    shapes, _, scans, _, seeds = bench.radar_scene(k)
    assert (shapes.max_meas, shapes.max_initiators,
            shapes.radar_cand_width) == (64, 64, 16)
    assert len(scans) == 3 and len(seeds) == 5
    shapes_a = bench.ais_scene(k)[0]
    assert (shapes_a.max_meas, shapes_a.max_initiators, shapes_a.max_ais,
            shapes_a.ais_per_leaf, shapes_a.radar_cand_width) == (
                64, 64, 4, 2, 16)


def snapshot(*trees):
    """Copies of every tensor of the states and input batches."""
    got = []
    for tree in trees:
        items = ([getattr(tree, f.name) for f in dataclasses.fields(tree)]
                 if dataclasses.is_dataclass(tree) else list(tree))
        got += [t.clone() for t in items]
    return got


def test_stream_leaves_its_inputs_alone_and_repeats(monkeypatch):
    for var, v in TINY.items():
        monkeypatch.setenv(var, v)
    k = bench.knobs()
    tracker, scan_b, ais_b = bench.radar_stream_inputs(
        CPU, k, bench.radar_scene(k))
    trees = (tracker.state, tracker.init_state, scan_b, ais_b)
    before = snapshot(*trees)
    walls, _, _, first = bench.streamed(tracker, scan_b, ais_b, False,
                                        reps=0)
    assert walls == []
    after = snapshot(*trees)
    assert len(after) == len(before)
    for a, b in zip(before, after):
        assert a.dtype == b.dtype and torch.equal(a, b)
    walls, _, _, again = bench.streamed(tracker, scan_b, ais_b, False,
                                        reps=1)
    assert len(walls) == 1
    for name, a, b in zip(first._fields, first, again):
        np.testing.assert_array_equal(a, b, err_msg=name)


def labels(outs, i):
    live = outs.track_mask[i]
    return (live, outs.track_id[i][live], outs.sel_hist_meas[i][live],
            outs.sel_hist_mmsi[i][live])


def test_clusters_on_selects_the_same_labels(ran):
    outs = ran[1][1]
    b, b2 = outs["B"], outs["B2"]
    assert b.track_mask.shape[0] == 3
    for i in range(3):
        for x, y in zip(labels(b, i), labels(b2, i)):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(b.sel_obj, b2.sel_obj)
    assert (b2.n_clusters > 0).all()


def test_streamed_selects_the_stepped_labels(ran):
    outs = ran[1][1]
    a, b = outs["A"], outs["B"]
    assert a.track_mask.shape[0] == 4      # path A steps all 4 scans
    assert a.track_mask[0].sum() == 8      # every seeded target kept
    for i in range(b.track_mask.shape[0]):
        for x, y in zip(labels(a, i), labels(b, i)):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_allclose(a.track_x[i][a.track_mask[i]],
                                   b.track_x[i][b.track_mask[i]],
                                   rtol=1e-5, atol=1e-4)

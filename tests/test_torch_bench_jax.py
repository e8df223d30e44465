"""``scripts.bench`` against the JAX package's ``bench.py`` on the CPU, at
8 targets, 3 scans and M=64.

``bench.py``'s ``main`` runs with its module constants set to that size
and ``jax.block_until_ready`` wrapped, so that the step outputs it waits
on are kept: the outputs of path A's scans, in order, then those of the
warm-up and the three repetitions of paths B, B2 and C.  Then the twin's
``main`` runs at the same knobs.  The two lines carry the same untimed
values (the median dual gap and the oracle's gap within 1e-6, the same
message count, target count and method); path A's and path C's selected
(track, measurement, MMSI) labels are equal scan for scan, and their
objectives agree to rtol 1e-5.
"""
import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from pymht_tpu_torch.scripts import bench  # noqa: E402

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_TARGETS, N_SCANS, MEAS = 8, 3, 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The step is thousands of small ops: torch's intra-op thread pool
    adds only contention when several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_bench():
    """bench.py from the repository root, as a module of its own name."""
    spec = importlib.util.spec_from_file_location(
        "jax_bench_script", os.path.join(REPO_ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def one_line(out):
    (line,) = [json.loads(s) for s in out.splitlines() if s.startswith("{")]
    return line


def test_twin_matches_bench_py(monkeypatch, capsys):
    for var in bench._ENV.values():
        monkeypatch.delenv(var, raising=False)
    jb = jax_bench()
    monkeypatch.setattr(jb, "N_TARGETS", N_TARGETS)
    monkeypatch.setattr(jb, "N_SCANS", N_SCANS)
    monkeypatch.setattr(jb, "BENCH_MEAS", MEAS)
    monkeypatch.setattr(jb, "METHOD", "lagrangian")
    waited, real_wait = [], jax.block_until_ready

    def keeping(x):
        waited.append(x)
        return real_wait(x)

    monkeypatch.setattr(jax, "block_until_ready", keeping)
    jb.main()
    line_j = one_line(capsys.readouterr().out)
    monkeypatch.setattr(jax, "block_until_ready", real_wait)

    monkeypatch.setenv("BENCH_TARGETS", str(N_TARGETS))
    monkeypatch.setenv("BENCH_SCANS", str(N_SCANS))
    monkeypatch.setenv("BENCH_MEAS", str(MEAS))
    result, outs = bench.main(["--device", "cpu"])
    line_t = one_line(capsys.readouterr().out)
    assert line_t == result

    for key in ("median_dual_gap", "opt_gap_vs_exact_oracle"):
        assert line_j[key] is not None and line_t[key] is not None, key
        assert abs(line_t[key] - line_j[key]) <= 1e-6, key
    for key in ("ais_msgs_per_scan", "n_targets", "method"):
        assert line_t[key] == line_j[key], key
    assert set(line_j) < set(line_t)

    # what bench.py waited on: path A's scans, then 4 calls of B, B2, C
    n_a = outs["A"].track_mask.shape[0]
    assert n_a == N_SCANS + 1 and len(waited) == n_a + 12
    a_j = [jax.device_get(o) for o in waited[:n_a]]
    c_j = jax.device_get(waited[-1][2])
    paths = {"A": (outs["A"], lambda f, i: np.asarray(getattr(a_j[i], f))),
             "C": (outs["C"], lambda f, i: np.asarray(getattr(c_j, f))[i])}
    for path, (o_t, of_j) in paths.items():
        n = o_t.track_mask.shape[0]
        assert n == (n_a if path == "A" else N_SCANS)
        for i in range(n):
            live = o_t.track_mask[i]
            np.testing.assert_array_equal(live, of_j("track_mask", i),
                                          err_msg=f"{path} scan {i}")
            for f in ("track_id", "sel_hist_meas", "sel_hist_mmsi"):
                np.testing.assert_array_equal(
                    getattr(o_t, f)[i][live], of_j(f, i)[live],
                    err_msg=f"{path} scan {i}: {f}")
            np.testing.assert_allclose(o_t.sel_obj[i], of_j("sel_obj", i),
                                       rtol=1e-5,
                                       err_msg=f"{path} scan {i}: sel_obj")
        assert o_t.track_mask[-1].any(), path
    # the AIS scene fuses: some selected label carries an MMSI
    assert (outs["C"].sel_hist_mmsi > 0).any()

"""The port's multi-rank scripts and its examples on the CPU at tiny
sizes (``--device cpu``).

* ``scripts.ab_distributed_select`` on two gloo ranks: the JAX tool's
  top-level keys; with ``force_iters`` the 40-iteration call makes more
  collectives than the 10-iteration one, the compact selection's
  per-iteration payload is smaller than the full-slot one's, and both
  selections are feasible, with the JAX tool's objectives under the
  production exits.
* ``scripts.bench_scaling`` at world sizes 1 and 2: bench_scaling.py's
  lines (scenario-scans per second, efficiency), plus the hardware.
* ``examples.demo_tracking`` (XML and the figure) and
  ``examples.demo_streaming_deployment`` (the checkpoint reloaded bit for
  bit); the demo's plotting raises, with its reason, where matplotlib is
  missing.
"""
import builtins
import json
import xml.etree.ElementTree as ET

import pytest

torch = pytest.importorskip("torch")

from pymht_tpu_torch.examples import (  # noqa: E402
    demo_streaming_deployment, demo_tracking)
from pymht_tpu_torch.scripts import (  # noqa: E402
    ab_distributed_select, bench_scaling)

# The JAX tool's selections under the production exits on the test's
# instance (tests/jax_ab_reference.py, 2 virtual CPU devices): the
# full-slot loop stops at its cap there, so the two differ.
JAX_AB_OBJ = {"full": -64.95014953613281, "compact": -65.39512634277344}
RTOL = 1e-5
# tools/ab_distributed_select.py's result object
AB_KEYS = {"metric", "hardware", "shape", "full", "compact",
           "per_iteration_allreduce_bytes_ratio", "converged",
           "obj_rel_delta", "swarm_shape_collectives"}


def lines(out):
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def test_ab_distributed_select_on_two_ranks(monkeypatch, capsys, tmp_path):
    # a small instance, and the swarm shapes' counts at its 64 slots
    monkeypatch.setattr(ab_distributed_select, "INSTANCE",
                        dict(slots=64, targets=60, meas=64))
    monkeypatch.setattr(ab_distributed_select, "SWARM_SHAPE",
                        dict(ab_distributed_select.SWARM_SHAPE, targets=60))
    out_path = tmp_path / "ab.json"
    ab_distributed_select.main(["--device", "cpu", "--world", "2",
                                "--out", str(out_path)])
    res = lines(capsys.readouterr().out)[-1]
    assert set(res) == AB_KEYS
    with open(out_path) as fh:
        assert json.load(fh) == res
    assert res["shape"]["ranks"] == 2 and res["shape"]["n_contested_slots"]
    for impl in ("full", "compact"):
        calls = res[impl]["collectives_per_call"]
        assert calls["40"]["count"] > calls["10"]["count"] > 0
        assert res[impl]["collectives_per_iteration"]["bytes"] > 0
        assert res["converged"][impl]["feasible"]
        # the JAX package's objective on the same instance
        obj = res["converged"][impl]["obj"]
        assert abs(obj - JAX_AB_OBJ[impl]) <= RTOL * (1 + abs(obj)), impl
    assert res["per_iteration_allreduce_bytes_ratio"] > 1.0
    sw = res["swarm_shape_collectives"]
    assert sw["n_slots"] == 6 * (2048 + 128)
    assert sw["per_iteration_allreduce_bytes_ratio"] > 1.0


def test_bench_scaling_on_one_and_two_ranks(monkeypatch, capsys):
    monkeypatch.setenv("SCALING_BATCH_PER_DEV", "1")
    bench_scaling.main(["--device", "cpu", "--worlds", "1,2"])
    out = lines(capsys.readouterr().out)
    assert [r["metric"] for r in out] == ["scenario_scans_per_s"] * 2 + [
        "scaling_efficiency"]
    for r, nd in zip(out, (1, 2)):
        assert set(r) == {"metric", "devices", "batch", "value",
                          "efficiency", "hardware"}
        assert r["devices"] == nd and r["batch"] == nd and r["value"] > 0
    assert out[0]["efficiency"] == 1.0
    assert set(out[-1]) == {"metric", "value", "devices", "unit"}


def test_demo_tracking_writes_xml_and_figure(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    demo_tracking.main(["--device", "cpu", "--targets", "3", "--scans", "6",
                        "--out", str(tmp_path)])
    assert "active tracks after 7 scans" in capsys.readouterr().out
    root = ET.parse(tmp_path / "demo_run.xml").getroot()
    assert root.tag == "Scenario" and len(list(root)) >= 3
    assert (tmp_path / "demo_scene.png").stat().st_size > 10_000


def test_demo_tracking_refuses_to_skip_the_plot(tmp_path, monkeypatch):
    real = builtins.__import__

    def no_matplotlib(name, *a, **kw):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError("No module named 'matplotlib'")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with pytest.raises(RuntimeError, match="--no-plot"):
        demo_tracking.main(["--device", "cpu", "--targets", "2", "--scans",
                            "2", "--out", str(tmp_path)])
    demo_tracking.main(["--device", "cpu", "--targets", "2", "--scans", "2",
                        "--out", str(tmp_path), "--no-plot"])
    assert (tmp_path / "demo_run.xml").exists()
    assert not (tmp_path / "demo_scene.png").exists()


def test_demo_streaming_deployment_resumes_bitwise(capsys):
    demo_streaming_deployment.main(["--device", "cpu", "--targets", "12",
                                    "--scans", "5", "--chunk", "2"])
    out = capsys.readouterr().out
    assert sum(line.startswith("chunk ") for line in out.splitlines()) == 3
    assert "checkpoint resume bitwise-identical: True" in out
    assert "final-scan coverage" in out

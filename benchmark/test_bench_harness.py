"""The harness on the CPU: K1's frozen byte and flop count, the import
guard, a cell added by files alone, and the refusal without a card."""
import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
import k1_bound  # noqa: E402

# modules that stand apart from the system under test
PLAIN = {"reference.py", "stream.py", "k1_bound.py", "small.py"}


def test_k1_bound_figures():
    """``chip_smoke.py``'s figures: the shared-scan shape of the bench
    scene (N=4096, M=512) and the per-target shape of swarm1000."""
    a, b = k1_bound.k1_bound(4096, 512), k1_bound.k1_sub_bound(1024, 16,
                                                                64, 2048)
    assert (a["bytes"], b["bytes"]) == (9_511_940, 9_521_156)
    assert round(a["bound_ms"] * 1e3, 3) == 2.839
    assert round(b["bound_ms"] * 1e3, 3) == 2.842
    assert a["bound_by"] == b["bound_by"] == "bytes"
    conf = json.loads((HERE / "configs" / "swarm1000.json").read_text())
    assert k1_bound.bound_of(conf) == b


def test_stated_limits_are_the_configurations():
    """A limit the configuration states is that limit: the selection
    gap of every configuration a cell uses."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for conf in bench["configs"]:
        stated = json.loads((ROOT / conf["file"]).read_text())["guarantees"]
        limits = json.loads((HERE / "limits" / f"{conf['name']}.json")
                            .read_text())
        assert limits["sel_gap"] == stated["selection_gap"]


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_import_guard(path):
    """No module of the benchmark imports JAX or the JAX package (top-level
    names compared whole); the reference, the generator and the bound
    import nothing of the port either.  The tests may import the port."""
    names = _imports(path)
    assert not names & {"jax", "jaxlib", "flax", "pymht_tpu"}
    if path.name in PLAIN or path.parent.name == "metrics":
        assert "pymht_tpu_torch" not in names


def test_a_cell_added_by_files_alone(tmp_path):
    """A copy of the harness finds a traffic file and a cell entry that
    were only added, and runs the cell (on the CPU, at a tiny size)."""
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "pymht_tpu_torch").symlink_to(ROOT / "pymht_tpu_torch")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark")
              .rglob("*") if p.is_file()}
    sys.path.insert(0, str(tmp_path / "benchmark"))
    try:
        from small import small
        cfg, tr = small("swarm1000")
        (tmp_path / "benchmark" / "configs" / "tiny.json").write_text(
            json.dumps(dict(cfg, name="tiny")))
        (tmp_path / "benchmark" / "traffic" / "calm.json").write_text(
            json.dumps(dict(tr, name="calm", lambda_phi=2e-6,
                            lambda_local=0.0)))
        bench["configs"].append(dict(name="tiny", source="a test",
                                     file="benchmark/configs/tiny.json",
                                     reduced=[], why="a test"))
        bench["workloads"].append(dict(name="tiny.calm", config="tiny",
                                       traffic="calm", chips=1, why="test"))
        (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
        code = ("import sys, json; sys.path.insert(0, 'benchmark'); "
                "import run, torch; torch.set_num_threads(1); "
                "b = run.load_json(run.ROOT / 'BENCHMARK.json'); "
                "cell, conf, tr = run.find_cell(b, 'tiny.calm'); "
                "r = run.run_cell(conf, tr, 5, 1.0, False, device='cpu'); "
                "print(json.dumps([tr['name'], r['attempted'], "
                "r['checked'], r['failed']]))")
        out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        name, attempted, checked, failed = json.loads(
            out.stdout.strip().splitlines()[-1])
        assert name == "calm" and attempted > 0 and checked > 0 \
            and failed == 0
    finally:
        sys.path.remove(str(tmp_path / "benchmark"))
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"


def test_no_card_no_result():
    """Without a CUDA device the command exits non-zero, printing no
    result on standard output."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cell = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          cell["name"], "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr

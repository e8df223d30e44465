"""The check that decides ``correct``, on the CPU at a tiny size of each
configuration: the plain reference agrees with the port's eager step
scan by scan, the reference in bfloat16 put in the port's place fails,
and so does the port with its timed path broken underneath."""
import json
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]
import reference  # noqa: E402
import run  # noqa: E402
from faults import FAULTS  # noqa: E402
from small import small  # noqa: E402

CONFIGS = ("swarm1000",)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def limits(config):
    return json.loads((HERE / "limits" / f"{config}.json").read_text())


def cpu_run(config, seconds=1.5, seed=11, **kw):
    cfg, tr = small(config)
    res = run.run_cell(cfg, tr, seed, seconds, False, device="cpu", **kw)
    assert res["checked"] == tr["check_scans"]
    return cfg, res


@pytest.mark.parametrize("config", CONFIGS)
def test_reference_agrees_with_the_port(config):
    """Every checked scan of the port's eager CPU step within the
    configuration's limits: grow (gating, the beam, scores, states, the
    AIS chain and the pre-gate), select (its leaves and objective),
    terminate, prune, initiation and the outputs returned."""
    _, res = cpu_run(config)
    assert res["failed"] == 0
    ok, check = run.verdict(res, dict(limits(config), checked_scans=3))
    assert ok, check
    # a sound run leaves out few rows as on the edge of a decision
    assert res["left_out"] <= 5


@pytest.mark.parametrize("config", CONFIGS)
def test_control_in_bfloat16_fails(config):
    cfg, res = cpu_run(config, keep_checks=True)
    c = reference.Cfg(cfg)
    lim = limits(config)
    failed = 0
    for (pre, pre_i), _, _, (scan, ais) in res["checks"]:
        post, post_i, out = reference.control(pre, pre_i, scan, ais, c)
        n = reference.judge(pre, pre_i, scan, ais, c, post, post_i, out)
        n.pop("parts"), n.pop("excused"), n.pop("differ")
        failed += any(v > lim[k] for k, v in n.items())
    assert failed == len(res["checks"]) >= 1


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_path_is_not_correct(config, fault):
    """The harness's run with the timed path broken (the chip's absence
    skipped): ``correct`` comes out false.  One card runs no exchange
    between chips, so that fault has no test."""
    _, res = cpu_run(config, tracker_hook=FAULTS[fault])
    ok, check = run.verdict(res, dict(limits(config), checked_scans=3))
    assert not ok, check

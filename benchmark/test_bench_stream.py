"""The traffic generator (``stream.py``) on the CPU: determinism by
block, a steady population, the Poisson and P_d rates, and agreement
with the port's simulator at a small size."""
import math
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
import stream  # noqa: E402
from small import small  # noqa: E402

RADAR = dict(period=2.5, range=2000.0)
COASTAL = dict(n_targets=30, spawn_radius=1600.0, sigma_Q=0.1, P_d=0.9,
               sigma_R=2.5, lambda_local=0.5, lambda_phi=2e-5, ais=None,
               block_scans=64)
AIS = dict(COASTAL, ais={"class": "B", "P_r": 0.5, "p_high": 0.5,
                         "sigma_hi": 1.0, "sigma_lo": 3.0})


def _same(a: stream.Block, b: stream.Block):
    assert np.array_equal(a.times, b.times)
    assert all(np.array_equal(x, y) for x, y in zip(a.z, b.z))
    assert [[(m.time, m.mmsi, m.highAccuracy, tuple(m.state)) for m in g]
            for g in a.ais] == [[(m.time, m.mmsi, m.highAccuracy,
                                  tuple(m.state)) for m in g] for g in b.ais]


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 7, 10 ** 12 + 3])
def test_same_seed_same_blocks_whatever_consumed(seed):
    short = stream.Stream(AIS, RADAR, seed)
    long = stream.Stream(AIS, RADAR, seed)
    a = [short.block(b) for b in range(2)]
    b = [long.block(b) for b in range(4)]
    for x, y in zip(a, b):
        _same(x, y)
    other = stream.Stream(AIS, RADAR, seed + 1).block(0)
    assert not np.array_equal(other.z[0], a[0].z[0])
    with pytest.raises(ValueError):
        short.block(5)


def test_population_steady_through_births():
    s = stream.Stream(AIS, RADAR, 5)
    births = 0
    for b in range(6):
        blk = s.block(b)
        births += int(blk.births.sum())
        assert len(s.x) == COASTAL["n_targets"]
        assert (np.hypot(s.x[:, 0], s.x[:, 1])
                <= COASTAL["spawn_radius"]).all()
        assert len(set(s.mmsi.tolist())) == len(s.mmsi)
    assert births > 10


def test_clutter_and_detection_rates():
    tr = dict(COASTAL, n_targets=40, lambda_local=0.0, block_scans=400)
    glob = tr["lambda_phi"] * math.pi * RADAR["range"] ** 2
    counts = np.array([len(z) for z in
                       stream.Stream(tr, RADAR, 9).block(0).z])
    mean = tr["n_targets"] * tr["P_d"] + glob
    sd = math.sqrt(tr["n_targets"] * 0.09 + glob)
    assert abs(counts.mean() - mean) < 4 * sd / math.sqrt(len(counts))
    assert abs(counts.var() / sd ** 2 - 1.0) < 0.25
    no_clutter = dict(tr, lambda_phi=0.0, lambda_local=0.5)
    counts = np.array([len(z) for z in
                       stream.Stream(no_clutter, RADAR, 9).block(0).z])
    mean = 40 * 0.9 * 1.5
    assert abs(counts.mean() - mean) < 0.05 * mean


def test_follows_the_port_simulator():
    """The simulator's tables and matrices, and its scans' statistics on
    a small clip of the same model."""
    from pymht_tpu_torch.utils import simulator as sim
    for dt in (0.5, 2.5):
        assert np.allclose(stream.q_matrix(dt, 0.1), sim._q(dt, 0.1))
        assert np.allclose(stream.phi(dt), sim._phi(dt))
    for v in (0.2, 2.0, 7.5, 14.0, 17.5):
        for cls in ("A", "B"):
            assert stream.report_interval(v, cls) == \
                sim._ais_report_interval(v, cls)
    assert np.allclose(np.sort(stream.SPEEDS),
                       np.array([1, 10, 12, 15, 28, 35]) * 0.5)
    rng = np.random.default_rng(3)
    n, scans = 40, 60
    tgts = sim.generate_initial_targets(rng, n, (0.0, 0.0), 2000.0, 0.9,
                                        0.1)
    sims = sim.simulate_targets(rng, tgts, scans * 2.5, 2.5)
    sim_counts = [len(s.measurements) for s in sim.simulate_scans(
        rng, sims, 2.5, sigma_R=2.5, lambda_phi=2e-5, radar_range=2000.0,
        p0=(0.0, 0.0), lambda_local=0.5)]
    ours = stream.Stream(dict(COASTAL, n_targets=n, block_scans=scans),
                         RADAR, 3)
    d_sim = np.array([np.hypot(*t.state[:2]) for t in tgts])
    d_ours = np.hypot(ours.x[:, 0], ours.x[:, 1])
    ours_counts = [len(z) for z in ours.block(0).z]
    expect = n * 0.9 * 1.5 + 2e-5 * math.pi * 2000.0 ** 2
    for c in (sim_counts, ours_counts):
        assert abs(np.mean(c) - expect) < 0.06 * expect
    # both draw the distance uniform on [0, 0.8 R]
    assert d_sim.max() <= 1600.0 and d_ours.max() <= 1600.0
    assert abs(d_sim.mean() - 800.0) < 150 and abs(d_ours.mean() - 800.0) \
        < 150


def test_ais_reports_at_their_intervals():
    s = stream.Stream(dict(AIS, n_targets=50, block_scans=200), RADAR, 4)
    blk = s.block(0)
    per_mmsi = {}
    for g, t in zip(blk.ais, blk.times):
        for m in g:
            assert t - 2.5 < m.time <= t
            per_mmsi.setdefault(m.mmsi, []).append(m.time)
    rate = sum(len(v) for v in per_mmsi.values()) / (200 * 2.5)
    speeds = np.hypot(s.initial[0][:, 2], s.initial[0][:, 3])
    expect = 0.5 * (1.0 / stream.report_interval(speeds, "B")).sum()
    assert abs(rate - expect) < 0.25 * expect


def test_small_configurations_draw():
    for config in ("swarm1000",):
        cfg, tr = small(config)
        s = stream.Stream(tr, dict(period=cfg["params"]["radar_period"],
                                   range=cfg["params"]["radar_range"]), 1)
        blk = s.block(0)
        assert max(len(z) for z in blk.z) <= cfg["shapes"]["max_meas"]

"""The slice end to end: the port's Tracker against the JAX Tracker
(method='lagrangian', radar only) at the shapes of
tests/test_tracker_e2e.py.  Same ids, selected labels and confirmed
archives; states within rtol 1e-4 / atol 1e-3."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pymht_tpu.core.config import (  # noqa: E402
    TrackerShapes as JShapes, TrackerParams as JParams)
from pymht_tpu.core.tracker import Tracker as JTracker  # noqa: E402
from pymht_tpu.utils import simulator as sim  # noqa: E402
from pymht_tpu_torch.core import tracker as ttracker  # noqa: E402
from pymht_tpu_torch.core.config import (  # noqa: E402
    TrackerShapes, TrackerParams)
from pymht_tpu_torch.core.tracker import Tracker  # noqa: E402

# each side gets its own classes, built from the same numbers
_SHAPES = dict(max_targets=8, max_leaves=32, max_meas=16, max_ais=4,
               window=7, max_prelim=8, max_initiators=16)
SHAPES, JSHAPES = TrackerShapes(**_SHAPES), JShapes(**_SHAPES)
TOL = dict(rtol=1e-4, atol=1e-3)


def crossing_scene():
    """Two targets crossing, no clutter, no seeds: both must be
    initiated by the m/n initiator (tests/test_tracker_e2e.py)."""
    period = 2.5
    params = dict(radar_period=period, P_d=0.9, lambda_phi=1e-8,
                  lambda_nu=1e-6, N=5, radar_range=1000.0)
    tgt = [sim.SimTarget(state=np.array([-100.0, 10.0, 5.0, -0.5]),
                         time=0.0, P_d=1.0, sigma_Q=0.1),
           sim.SimTarget(state=np.array([100.0, -10.0, -5.0, 0.5]),
                         time=0.0, P_d=1.0, sigma_Q=0.1)]
    rng = np.random.default_rng(7)
    sim_list = sim.simulate_targets(rng, tgt, sim_time=9 * period,
                                    dt=period)
    scans = sim.simulate_scans(rng, sim_list, period, sigma_R=1.0,
                               lambda_phi=0.0, radar_range=1000.0,
                               p0=(0.0, 0.0), P_d=1.0, local_clutter=False,
                               global_clutter=False)
    return TrackerParams(**params), JParams(**params), scans, None


def cluttered_scene():
    """Six seeded targets in clutter, with missed detections."""
    period = 2.5
    params = dict(radar_period=period, P_d=0.9, lambda_phi=2e-5,
                  lambda_nu=1e-5, N=4, radar_range=150.0)
    rng = np.random.default_rng(4)
    targets = sim.generate_initial_targets(rng, 6, (0.0, 0.0), 100.0, 0.9,
                                           0.1)
    sim_list = sim.simulate_targets(rng, targets, sim_time=8 * period,
                                    dt=period)
    scans = sim.simulate_scans(rng, sim_list, period, sigma_R=2.5,
                               lambda_phi=2e-5, radar_range=150.0,
                               p0=(0.0, 0.0), lambda_local=0.5)
    F_inv = np.eye(4)
    F_inv[0, 2] = F_inv[1, 3] = -period
    return (TrackerParams(**params), JParams(**params), scans,
            [F_inv @ t.state for t in targets[:5]])


@pytest.mark.parametrize("scene", [crossing_scene, cluttered_scene])
def test_tracker_matches_jax(scene):
    params, jparams, scans, seeds = scene()
    jt = JTracker(JSHAPES, jparams, method='lagrangian', use_ais=False)
    tt = Tracker(SHAPES, params, method='lagrangian', use_ais=False,
                 device='cpu')
    if seeds is not None:
        jt.pre_initialize(scans[0].time - params.radar_period, seeds)
        tt.pre_initialize(scans[0].time - params.radar_period, seeds)
    for s in scans:
        oj = jt.add_measurement_list(s.time, s.measurements)
        ot = tt.add_measurement_list(s.time, s.measurements)
        for name in oj._fields:
            a, b = np.asarray(getattr(oj, name)), getattr(ot, name)
            if a.dtype.kind == "f":
                np.testing.assert_allclose(b, a, err_msg=name, **TOL)
            else:
                np.testing.assert_array_equal(b, a, err_msg=name)
    assert len(tt.host_syncs) == len(scans)
    tr_j, tr_t = jt.get_tracks(), tt.get_tracks()
    assert sorted(tr_t) == sorted(tr_j) and len(tr_t) >= 2
    for tid, a in tr_j.items():
        b = tr_t[tid]
        for key in ("confirmed_times", "confirmed_meas", "window_times",
                    "window_meas", "window_mmsi", "confirmed_mmsi"):
            assert b[key] == a[key], (tid, key)
        for key in ("confirmed_states", "window_states"):
            np.testing.assert_allclose(np.asarray(b[key]),
                                       np.asarray(a[key]), **TOL)
    assert sorted(tt.terminated) == sorted(jt.terminated)


def test_pipelined_outputs_match_stepped():
    params, _, scans, seeds = cluttered_scene()
    a = Tracker(SHAPES, params, method='lagrangian', use_ais=False,
                device='cpu')
    b = Tracker(SHAPES, params, method='lagrangian', use_ais=False,
                pipeline_outputs=True, device='cpu')
    for tr in (a, b):
        tr.pre_initialize(scans[0].time - params.radar_period, seeds)
        for s in scans:
            tr.add_measurement_list(s.time, s.measurements)
    b.flush()
    assert a._track_measurement_sequences(True).keys() == \
        b._track_measurement_sequences(True).keys()
    for tid, seq in a._track_measurement_sequences(True).items():
        assert b._track_measurement_sequences(True)[tid][1] == seq[1]


def test_scan_many_matches_stepping():
    """scan_many (a loop of scan_step over stacked scans) gives the
    stepped Tracker's selected labels."""
    params, _, scans, seeds = cluttered_scene()
    tr = Tracker(SHAPES, params, method='lagrangian', use_ais=False,
                 device='cpu')
    tr.pre_initialize(scans[0].time - params.radar_period, seeds)
    st0, ist0 = tr.state, tr.init_state
    M = SHAPES.max_meas
    z = np.zeros((len(scans), M, 2), np.float32)
    m = np.zeros((len(scans), M), bool)
    for i, s in enumerate(scans):
        n = min(len(s.measurements), M)
        z[i, :n] = s.measurements[:n]
        m[i, :n] = True
    t = np.array([s.time - tr.t0 for s in scans], np.float32)
    batch = ttracker.Scan(z=torch.from_numpy(z), mask=torch.from_numpy(m),
                          time=torch.from_numpy(t))
    _, _, outs = ttracker.scan_many(st0, ist0, batch, None, SHAPES, params,
                                    use_ais=False, compute_clusters=True)
    for i, s in enumerate(scans):
        o = tr.add_measurement_list(s.time, s.measurements)
        np.testing.assert_array_equal(outs.sel_hist_meas[i].numpy(),
                                      o.sel_hist_meas)


def test_tracker_refuses_unported_options():
    """Nothing of Tracker's surface raises NotImplementedError any more:
    every selection method runs, the options and entry points of the
    streaming and degradation slice are accepted.  What is refused: an
    unknown method (ValueError) and a step without its AisBatch.  No
    NotImplementedError is left anywhere in the package: the batched
    step takes every option too (parallel/scenario.py)."""
    params = TrackerParams()
    tr = Tracker(SHAPES, params, device='cpu', prune_similar=True,
                 dynamic_window=True, degrade_on_overload=True)
    assert tr.use_ais and tr.ais_initialization     # the JAX class's defaults
    assert tr.method == 'ipm'
    assert tr.stream([]) == [] and tr.get_smooth_tracks() == {}
    assert tr.degrade() and tr.shapes.max_leaves == SHAPES.max_leaves // 2
    assert tr.state.leaf_mask.shape[1] == SHAPES.max_leaves // 2
    tr.check_integrity()
    cparams, _, scans, seeds = cluttered_scene()
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)      # thousands of tiny ops: no thread pool
    try:
        for method in ("ipm", "lagrangian_pure", "lagrangian", "greedy"):
            t2 = Tracker(SHAPES, cparams, method=method, device='cpu')
            t2.pre_initialize(scans[0].time - cparams.radar_period, seeds)
            for s in scans[:3]:
                out = t2.add_measurement_list(s.time, s.measurements)
            assert out.track_mask.sum() >= len(seeds)
            assert method == 'greedy' or bool(out.sel_feasible)
    finally:
        torch.set_num_threads(n_threads)
    with pytest.raises(ValueError, match="unknown selection method"):
        Tracker(SHAPES, params, method="simplex", device='cpu') \
            .add_measurement_list(scans[0].time, scans[0].measurements)
    with pytest.raises(TypeError, match="AisBatch"):
        ttracker.scan_step(tr.state, tr.init_state, None, None, SHAPES,
                           params)
    import pathlib
    port = pathlib.Path(ttracker.__file__).resolve().parents[1]
    hits = [str(f.relative_to(port)) for f in port.rglob("*.py")
            if "NotImplementedError" in f.read_text()]
    assert hits == [], hits


def test_tracker_defaults_to_the_card(monkeypatch):
    """No ``device`` means CUDA: without a CUDA device the constructor
    raises and names device='cpu'; it never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Tracker(SHAPES, TrackerParams())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Tracker(SHAPES, TrackerParams(), device=None)


def test_tracker_runs_on_the_cpu_when_asked():
    """Also the default ``use_ais=True`` with no messages: the AIS branch
    runs on an empty batch."""
    params, _, scans, seeds = cluttered_scene()
    tr = Tracker(SHAPES, params, method='lagrangian', device='cpu')
    assert tr.device == torch.device('cpu')
    tr.pre_initialize(scans[0].time - params.radar_period, seeds)
    out = tr.add_measurement_list(scans[0].time, scans[0].measurements)
    assert tr.state.leaf_x.device.type == 'cpu'
    assert out.track_mask.sum() == len(seeds)

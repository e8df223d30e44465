"""Both ``Tracker(method='ipm')``s (the class's default solver) scan by
scan on a 16-scan scene of eight converging targets, the port's
``Tracker(method='lagrangian_pure')`` on the same scans, and the method
defaults of ``Tracker``, ``scan_step`` and ``scan_many`` against the JAX
package's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pymht_tpu.core.tracker import Tracker as JTracker  # noqa: E402
from pymht_tpu_torch.core.config import TrackerShapes  # noqa: E402
from pymht_tpu_torch.core.tracker import Tracker  # noqa: E402
from test_torch_select_ipm import converging, jax_cfg  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The solvers are thousands of tiny ops: torch's intra-op thread pool
    adds only contention when several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_tracker_ipm_matches_jax_scan_by_scan():
    shapes, params, scans, seeds = converging(15)
    assert len(scans) == 16
    jt = JTracker(jax_cfg(shapes), jax_cfg(params), method='ipm',
                  use_ais=False)
    tt = Tracker(shapes, params, method='ipm', use_ais=False, device='cpu')
    for tr in (jt, tt):
        tr.pre_initialize(scans[0].time - params.radar_period, seeds)
    solved = 0
    for i, s in enumerate(scans):
        oj = jt.add_measurement_list(s.time, s.measurements)
        ot = tt.add_measurement_list(s.time, s.measurements)
        assert bool(ot.sel_feasible) and bool(oj.sel_feasible), i
        obj_j = float(oj.sel_obj)
        assert abs(float(ot.sel_obj) - obj_j) <= 1e-4 * (1 + abs(obj_j)), i
        solved += float(ot.sel_obj) != float(ot.sel_bound)
        for name in ("track_mask", "track_id", "sel_hist_meas", "dead",
                     "confirmed_mask", "confirmed_meas", "n_clusters",
                     "inserted_mask"):
            np.testing.assert_array_equal(getattr(ot, name),
                                          np.asarray(getattr(oj, name)),
                                          err_msg=f"{name}, scan {i}")
        np.testing.assert_allclose(ot.track_x, np.asarray(oj.track_x),
                                   rtol=1e-4, atol=1e-3)
    assert solved >= 3                  # the solver ran, not the fast path
    assert sorted(tt.get_tracks()) == sorted(jt.get_tracks())
    assert len(tt.get_tracks()) >= 6


def test_tracker_lagrangian_pure_runs_the_scene():
    """``Tracker(method='lagrangian_pure')`` on the same 16 scans: every
    selection feasible and, where the loop certified its gap, inside the
    0.1 % contract; the tracks of the ``'ipm'`` run.  (Not held to the
    JAX run scan by scan: on forests where the subgradient loop does not
    converge its incumbents depend on rounding, and XLA under jit rounds
    otherwise than eager torch.)"""
    shapes, params, scans, seeds = converging(15)
    runs = {}
    for method in ("lagrangian_pure", "ipm"):
        tr = Tracker(shapes, params, method=method, use_ais=False,
                     device='cpu')
        tr.pre_initialize(scans[0].time - params.radar_period, seeds)
        outs = [tr.add_measurement_list(s.time, s.measurements)
                for s in scans]
        assert all(bool(o.sel_feasible) for o in outs)
        runs[method] = (tr, outs)
    tr, outs = runs["lagrangian_pure"]
    assert sum(float(o.sel_obj) != float(o.sel_bound) for o in outs) >= 3
    for o in outs:
        assert float(o.sel_bound) <= float(o.sel_obj) + 1e-4
    assert sorted(tr.get_tracks()) == sorted(runs["ipm"][0].get_tracks())
    tr.check_integrity()


def test_tracker_default_method_is_ipm():
    import inspect
    from pymht_tpu.core import tracker as jtracker
    from pymht_tpu_torch.core import tracker as ttracker
    for name in ("scan_step", "scan_many"):
        dt = inspect.signature(getattr(ttracker, name)).parameters["method"]
        dj = inspect.signature(getattr(jtracker, name)).parameters["method"]
        assert dt.default == dj.default, name
    assert inspect.signature(Tracker.__init__).parameters["method"].default \
        == inspect.signature(JTracker.__init__).parameters["method"].default \
        == 'ipm'
    tr = Tracker(TrackerShapes(max_targets=4, max_leaves=4, max_meas=4,
                               max_ais=2, window=3, max_prelim=4,
                               max_initiators=4), device='cpu')
    assert tr.method == 'ipm'

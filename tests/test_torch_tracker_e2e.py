"""The tracker at its edges, the port's ``Tracker`` against the JAX
package's on the same scans (tests/test_tracker_e2e.py's edge cases and
the probes of the verify notes).

* empty scans from the start: no track;
* a dropout scan mid-run: tracks coast on zero hypotheses and
  re-acquire;
* zero clutter density (lambda_phi = lambda_nu = 0): every score finite
  through the density floor;
* the probes: steps with every target slot masked (the initiator alone),
  then a scan with no measurement (M = 0 valid rows) on the forest they
  started, and the association score at lambda_ex = 0.

Each case asserts the JAX test's own conditions on the port and holds
the port's outputs to JAX's scan by scan: the same track mask, ids and
selected labels, states and objectives within rtol 1e-4, atol 1e-3.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pymht_tpu.core.config import TrackerParams, TrackerShapes  # noqa: E402
from pymht_tpu.core.tracker import Tracker as JTracker  # noqa: E402
from pymht_tpu.ops import kalman as jk  # noqa: E402
from pymht_tpu_torch import Tracker as TTracker  # noqa: E402
from pymht_tpu_torch.core import config as tconfig  # noqa: E402
from pymht_tpu_torch.ops import kalman as tk  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-3)
SHAPES = TrackerShapes(max_targets=8, max_leaves=32, max_meas=16,
                       max_ais=4, window=7, max_prelim=8, max_initiators=16)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The default 'ipm' is thousands of tiny ops: torch's intra-op
    thread pool adds only contention when several test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port(cfg):
    cls = getattr(tconfig, type(cfg).__name__)
    return cls(**{f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cls) if hasattr(cfg, f.name)})


def _pair(shapes, params, **kw):
    return (JTracker(shapes, params, use_ais=False, **kw),
            TTracker(port(shapes), port(params), use_ais=False,
                     device="cpu", **kw))


def _step_both(trj, trt, t, z):
    """One scan through both trackers, their outputs held together."""
    oj = trj.add_measurement_list(t, z)
    ot = trt.add_measurement_list(t, z)
    mask = np.asarray(oj.track_mask)
    np.testing.assert_array_equal(np.asarray(ot.track_mask), mask)
    np.testing.assert_array_equal(np.asarray(ot.track_id)[mask],
                                  np.asarray(oj.track_id)[mask])
    np.testing.assert_array_equal(np.asarray(ot.sel_hist_meas)[mask],
                                  np.asarray(oj.sel_hist_meas)[mask])
    np.testing.assert_allclose(np.asarray(ot.track_x)[mask],
                               np.asarray(oj.track_x)[mask], **TOL)
    np.testing.assert_allclose(float(ot.sel_obj), float(oj.sel_obj), **TOL)
    assert bool(ot.sel_feasible) == bool(oj.sel_feasible)
    return ot


def _same_tracks(trj, trt):
    ids_j, st_j = trj.get_track_states()
    ids_t, st_t = trt.get_track_states()
    assert list(ids_t) == list(ids_j)
    np.testing.assert_allclose(np.asarray(st_t), np.asarray(st_j), **TOL)
    return ids_t, np.asarray(st_t)


def test_empty_scans_no_tracks():
    trj, trt = _pair(SHAPES, TrackerParams(radar_period=1.0))
    for k in range(4):
        _step_both(trj, trt, (k + 1) * 1.0, np.zeros((0, 2)))
    ids, _ = _same_tracks(trj, trt)
    assert len(ids) == 0


# the dropout test's configuration, which the probes share
COAST_SHAPES = TrackerShapes(max_targets=8, max_leaves=16, max_meas=16,
                             max_ais=2, window=6, max_prelim=8,
                             max_initiators=16)
COAST_PARAMS = TrackerParams(radar_period=2.5, P_d=0.9, lambda_phi=1e-7,
                             lambda_nu=1e-6, N=4, radar_range=1000.0)


def test_mid_stream_empty_scan_coast_and_reacquire():
    trj, trt = _pair(COAST_SHAPES, COAST_PARAMS)
    x0 = np.array([[0.0, 0.0, 2.0, 0.0], [100.0, 50.0, -2.0, 1.0]])
    for tr in (trj, trt):
        tr.pre_initialize(0.0, list(x0))
    rng = np.random.default_rng(3)
    for k in range(6):
        t = 2.5 * (k + 1)
        z = (np.zeros((0, 2), np.float32) if k == 2
             else x0[:, :2] + x0[:, 2:] * t + rng.normal(0, 1.0, (2, 2)))
        out = _step_both(trj, trt, t, z)
        if k == 2:       # the dropout scan: both coast on a miss
            assert (np.asarray(out.sel_hist_meas)[:2, -1] == 0).all()
    ids, states = _same_tracks(trj, trt)
    assert len(ids) == 2, f"track lost across dropout: {ids}"
    for i, s in enumerate(states[np.argsort(ids)]):
        expect = x0[i, :2] + x0[i, 2:] * 15.0
        assert np.linalg.norm(s[:2] - expect) < 10.0, (i, s, expect)


def test_zero_clutter_density_stays_finite():
    shapes = TrackerShapes(max_targets=4, max_leaves=8, max_meas=8,
                           max_ais=2, window=5, max_prelim=4,
                           max_initiators=8)
    params = TrackerParams(radar_period=2.5, P_d=0.9, lambda_phi=0.0,
                           lambda_nu=0.0, N=3, radar_range=1000.0)
    trj, trt = _pair(shapes, params)
    for tr in (trj, trt):
        tr.pre_initialize(0.0, [np.array([0.0, 0.0, 1.0, 0.0])])
    rng = np.random.default_rng(0)
    for k in range(4):
        t = 2.5 * (k + 1)
        z = np.array([[t, 0.0]]) + rng.normal(0, 1.0, (1, 2))
        out = _step_both(trj, trt, t, z)
        assert np.isfinite(float(out.sel_obj)), out.sel_obj
    ids, states = _same_tracks(trj, trt)
    assert len(ids) == 1 and np.all(np.isfinite(states))
    cn, ok = trt.state.leaf_cnllr.numpy(), trt.state.leaf_mask.numpy()
    assert np.all(np.isfinite(cn[ok]))
    np.testing.assert_allclose(cn[ok], np.asarray(trj.state.leaf_cnllr)[ok],
                               **TOL)


def test_probes_every_slot_masked_then_a_scan_without_measurements():
    """No live target (every slot masked): grow and select have nothing
    to do, the initiator alone sees the scans, and after the m/n checks
    the same tracks start in both.  Then a scan with M = 0 valid rows on
    that live forest: every track coasts on its zero hypothesis, none
    dies, no measurement is used."""
    trj, trt = _pair(COAST_SHAPES, COAST_PARAMS)
    assert not trt.state.tgt_mask.any()
    x = np.array([[0.0, 0.0, 4.0, 1.0], [-60.0, 30.0, 2.0, -3.0]])
    rng = np.random.default_rng(5)
    for k in range(5):
        t = 2.5 * (k + 1)
        out = _step_both(trj, trt, t, x[:, :2] + x[:, 2:] * t
                         + rng.normal(0, 1.0, (2, 2)))
        if k == 0:
            assert not np.asarray(out.track_mask).any()
            assert float(out.sel_obj) == 0.0
    ids, _ = _same_tracks(trj, trt)
    assert len(ids) == 2
    live = np.asarray(out.track_mask)
    out = _step_both(trj, trt, 15.0, np.zeros((0, 2), np.float32))
    np.testing.assert_array_equal(np.asarray(out.track_mask), live)
    assert (np.asarray(out.sel_hist_meas)[live, -1] == 0).all()
    assert not np.asarray(out.used_meas).any()
    assert len(_same_tracks(trj, trt)[0]) == 2


@pytest.mark.parametrize("lambda_ex", [0.0, 1e-30, 2e-5])
def test_probe_association_score_at_zero_density(lambda_ex):
    """nllr at lambda_ex = 0 (the reference's latent NameError): finite
    through the 1e-20 floor, equal to JAX's."""
    rng = np.random.default_rng(1)
    a = rng.normal(0, 1, (3, 2, 2)).astype(np.float32)
    S = a @ np.swapaxes(a, -1, -2) + 2 * np.eye(2, dtype=np.float32)
    nis = rng.uniform(0, 9, (3, 5)).astype(np.float32)
    pd = np.full((3,), 0.9, np.float32)
    got = tk.nllr(lambda_ex, torch.from_numpy(pd), torch.from_numpy(S),
                  torch.from_numpy(nis)).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, np.asarray(jk.nllr(lambda_ex, pd, S,
                                                       nis)), **TOL)

"""Streaming, the dynamic window and degradation of the port's Tracker
against its own stepped path and against the JAX package.

* ``Tracker.stream`` (chunks through ``scan_many``, one packed transfer
  each way per chunk) against ``add_measurement_list`` scan by scan and
  against the JAX ``stream``, radar only and with AIS, with a chunk that
  does not divide the scan count;
* ``make_stream_inputs``: time base, overflow warning, integer MMSIs;
* the on-device window trigger of ``scan_step`` against the JAX
  ``scan_many``;
* the host ``_dynamic_window``'s three triggers and its cooldown against
  the JAX method on the same calls;
* the roof-triggered ``degrade`` in ``stream`` under a scripted
  ``_clock``: not on the first chunk, not on the chunk after a degrade;
* ``prune_similar`` in ``scan_step`` against the JAX step, and through
  ``stream`` against the port's stepped path.

Tolerances: the port's streamed and stepped paths run the same code on
the same inputs and must agree exactly; against the JAX package integer
and boolean outputs are identical and floats within rtol 1e-4 /
atol 1e-3.
"""
import dataclasses
import logging
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from pymht_tpu.core import tracker as jtracker  # noqa: E402
from pymht_tpu.core.config import (  # noqa: E402
    TrackerShapes as JShapes, TrackerParams as JParams)
from pymht_tpu.core.tracker import Tracker as JTracker  # noqa: E402
from pymht_tpu_torch import sync  # noqa: E402
from pymht_tpu_torch.core import tracker as ttracker  # noqa: E402
from pymht_tpu_torch.core.config import (  # noqa: E402
    TrackerShapes, TrackerParams)
from pymht_tpu_torch.core.tracker import Tracker  # noqa: E402
from tests.test_reference_parity_ais import (  # noqa: E402
    PARAMS as AIS_JPARAMS, SHAPES as AIS_JSHAPES, _ais_scenario)
from tests.test_torch_tracker import cluttered_scene  # noqa: E402
from tests.test_torch_tracker_ais import port, port_messages  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-3)
_SHAPES = dict(max_targets=8, max_leaves=16, max_meas=16, max_ais=4,
               window=7, max_prelim=8, max_initiators=16)
SHAPES, JSHAPES = TrackerShapes(**_SHAPES), JShapes(**_SHAPES)


def radar_scene():
    params, jparams, scans, seeds = cluttered_scene()
    return dict(shapes=SHAPES, jshapes=JSHAPES, params=params,
                jparams=jparams, scans=list(scans), groups=None,
                jgroups=None, seeds=seeds, mmsi=None, t_init=scans[0].time
                - params.radar_period, kw=dict(use_ais=False))


def ais_scene():
    x0, mmsi, rows = _ais_scenario(n_scans=6, seed=17)
    jshapes = dataclasses.replace(AIS_JSHAPES, max_leaves=16)
    scans = [SimpleNamespace(time=t, measurements=z) for t, z, _ in rows]
    return dict(shapes=port(jshapes), jshapes=jshapes,
                params=port(AIS_JPARAMS), jparams=AIS_JPARAMS, scans=scans,
                groups=[port_messages(m) for _, _, m in rows],
                jgroups=[m for _, _, m in rows], seeds=x0, mmsi=mmsi,
                t_init=0.0, kw=dict(use_ais=True, ais_initialization=True))


SCENES = {"radar": (radar_scene, 4), "ais": (ais_scene, 4)}


def new_tracker(sc, **kw):
    tr = Tracker(sc["shapes"], sc["params"], method='lagrangian',
                 device='cpu', **sc["kw"], **kw)
    tr.pre_initialize(sc["t_init"], sc["seeds"], mmsi=sc["mmsi"])
    return tr


def step_all(tr, sc, **kw):
    return [tr.add_measurement_list(
        s.time, s.measurements,
        ais_messages=sc["groups"][i] if sc["groups"] else None, **kw)
        for i, s in enumerate(sc["scans"])]


def assert_same_archives(a, b, exact=True):
    ta, tb = a.get_tracks(), b.get_tracks()
    assert sorted(ta) == sorted(tb)
    assert sorted(a.terminated) == sorted(b.terminated)
    for tid in ta:
        for key in ("confirmed_times", "confirmed_meas", "confirmed_mmsi",
                    "window_times", "window_meas", "window_mmsi"):
            assert ta[tid][key] == tb[tid][key], (tid, key)
        for key in ("confirmed_states", "window_states"):
            x, y = np.asarray(ta[tid][key]), np.asarray(tb[tid][key])
            if exact:
                np.testing.assert_array_equal(x, y)
            else:
                np.testing.assert_allclose(x, y, **TOL)


@pytest.mark.parametrize("scene", list(SCENES))
def test_stream_matches_stepped_tracker(scene):
    make, chunk = SCENES[scene]
    sc = make()
    n = len(sc["scans"])
    assert n % chunk != 0                # the last chunk is a short one
    stepped, streamed = new_tracker(sc), new_tracker(sc)
    outs_step = step_all(stepped, sc, check_integrity=True)
    n_sync = sync.count
    chunks = streamed.stream(sc["scans"], sc["groups"], chunk=chunk,
                             compute_clusters=True)
    assert [len(c.track_mask) for c in chunks] == \
        [chunk] * (n // chunk) + [n % chunk]
    flat = [ttracker.StepOutputs(*(f[j] for f in c))
            for c in chunks for j in range(len(c.track_mask))]
    for i, (a, b) in enumerate(zip(outs_step, flat)):
        for name in a._fields:
            np.testing.assert_array_equal(getattr(b, name), getattr(a, name),
                                          err_msg=f"scan {i}: {name}")
    streamed.check_integrity()
    assert_same_archives(streamed, stepped)
    assert streamed.scan_times == stepped.scan_times
    assert [len(z) for z in streamed.scan_history] == \
        [len(s.measurements) for s in sc["scans"]]
    assert [len(g) for g in streamed.ais_history] == \
        [len(g) for g in stepped.ais_history]
    assert {k: v.shape for k, v in streamed.init_P.items()} == \
        {k: v.shape for k, v in stepped.init_P.items()}
    # one entry per scan in the runtime log, one per chunk in chunk_syncs,
    # whose reads are the loop exits plus ONE output fetch per chunk
    assert len(streamed.runtime_log) == len(streamed.runtime.log['Total']) == n
    assert [c[0] for c in streamed.chunk_syncs] == \
        [chunk] * (n // chunk) + [n % chunk]
    assert sum(c[1] for c in streamed.chunk_syncs) == sync.count - n_sync
    assert sum(c[1] for c in streamed.chunk_syncs) == \
        sum(stepped.host_syncs) - n + len(chunks)
    assert streamed.host_syncs == []


@pytest.mark.parametrize("scene,chunk", [("radar", 4), ("ais", 3)])
def test_stream_matches_jax_stream(scene, chunk):
    sc = SCENES[scene][0]()
    jt = JTracker(sc["jshapes"], sc["jparams"], method='lagrangian',
                  **sc["kw"])
    jt.pre_initialize(sc["t_init"], sc["seeds"], mmsi=sc["mmsi"])
    tt = new_tracker(sc)
    want = jt.stream(sc["scans"], sc["jgroups"], chunk=chunk)
    got = tt.stream(sc["scans"], sc["groups"], chunk=chunk)
    assert len(got) == len(want)
    fused = 0
    for k, (cj, ct) in enumerate(zip(want, got)):
        for name in cj._fields:
            a, b = np.asarray(getattr(cj, name)), getattr(ct, name)
            if a.dtype.kind == "f":
                np.testing.assert_allclose(b, a, err_msg=f"chunk {k} {name}",
                                           **TOL)
            else:
                np.testing.assert_array_equal(b, a,
                                              err_msg=f"chunk {k} {name}")
        fused += int(((ct.sel_hist_mmsi[:, :, -1] != 0)
                      & ct.track_mask).sum())
    assert fused >= 1 or scene == "radar"
    assert_same_archives(tt, jt, exact=False)
    assert tt.scan_times == pytest.approx(jt.scan_times)
    assert sorted(tt.init_P) == sorted(jt.init_P)
    tt.check_integrity()


def test_make_stream_inputs_time_base_and_overflow(caplog):
    sc = ais_scene()
    tr = new_tracker(sc)
    assert tr.t0 == -sc["params"].radar_period
    scan_b, ais_b = tr.make_stream_inputs(sc["scans"], sc["groups"])
    n, M, A = len(sc["scans"]), sc["shapes"].max_meas, sc["shapes"].max_ais
    assert scan_b.z.shape == (n, M, 2) and scan_b.mask.shape == (n, M)
    assert ais_b.state.shape == (n, A, 4)
    assert ais_b.mmsi.dtype == torch.int32 and ais_b.mask.dtype == torch.bool
    # the stacked inputs are what the stepped path packs scan by scan
    for i, s in enumerate(sc["scans"]):
        one, ais1 = tr._unpack_inputs(tr._pack_inputs(
            float(s.time) - tr.t0, s.measurements, sc["groups"][i]))
        for a, b in zip(one, (f[i] for f in scan_b)):
            assert torch.equal(a, b)
        for a, b in zip(ais1, (f[i] for f in ais_b)):
            assert torch.equal(a, b)
    np.testing.assert_allclose(
        scan_b.time.numpy(), [s.time - tr.t0 for s in sc["scans"]])
    msg = sc["groups"][0][0]
    assert float(ais_b.time[0, 0]) == pytest.approx(msg.time - tr.t0)
    assert int(ais_b.mmsi[0, 0]) == msg.mmsi
    assert not caplog.records

    # without pre_initialize the origin comes from the first scan
    fresh = Tracker(sc["shapes"], sc["params"], device='cpu')
    sb, _ = fresh.make_stream_inputs(sc["scans"][2:4])
    assert fresh.t0 == sc["scans"][2].time - sc["params"].radar_period
    assert float(sb.time[0]) == pytest.approx(sc["params"].radar_period)

    # overflow of the static shapes is dropped with a warning
    big = SimpleNamespace(time=2.5, measurements=np.zeros((M + 3, 2)))
    with caplog.at_level(logging.WARNING):
        sb, ab = tr.make_stream_inputs([big], [sc["groups"][0] * (A + 1)])
    assert "dropped 3 measurements" in caplog.text
    assert int(sb.mask.sum()) == M and int(ab.mask.sum()) == A


def overload_scene():
    """tests/test_dynamic_window.py::test_streaming_device_dynamic_window:
    eight clutter points on target 0 every scan saturate its L=4 beam;
    target 1 coasts."""
    shapes = dict(max_targets=4, max_leaves=4, max_meas=16, max_ais=2,
                  window=6, max_prelim=4, max_initiators=16)
    params = dict(radar_period=2.5, P_d=0.9, lambda_phi=1e-6, lambda_nu=1e-6,
                  N=5, radar_range=500.0, cnllr_upper_limit=1e9,
                  score_upper_limit_scale=1e6)
    rng = np.random.default_rng(0)
    scans = [SimpleNamespace(
        time=(k + 1) * 2.5, measurements=np.array([[(k + 1) * 2.5, 0.0]])
        + rng.normal(0, 1.5, (8, 2))) for k in range(6)]
    x0 = [np.array([0.0, 0.0, 1.0, 0.0]), np.array([200.0, 200.0, -1.0, 0.0])]
    return shapes, params, scans, x0


@pytest.mark.parametrize("dynamic_window", [True, False])
def test_on_device_dynamic_window_matches_jax_scan_many(dynamic_window):
    shapes, params, scans, x0 = overload_scene()
    jsh, jpa = JShapes(**shapes), JParams(**params)
    tsh, tpa = TrackerShapes(**shapes), TrackerParams(**params)
    jt = JTracker(jsh, jpa, use_ais=False)
    tt = Tracker(tsh, tpa, use_ais=False, device='cpu')
    jt.pre_initialize(0.0, x0)
    tt.pre_initialize(0.0, x0)
    js, ja = jt.make_stream_inputs(scans)
    ts, ta = tt.make_stream_inputs(scans)
    jstate, _, jouts = jax.jit(lambda st, ist, sc, a: jtracker.scan_many(
        st, ist, sc, a, jsh, jpa, method='lagrangian', use_ais=False,
        dynamic_window=dynamic_window))(jt.state, jt.init_state, js, ja)
    tstate, _, touts = ttracker.scan_many(
        tt.state, tt.init_state, ts, ta, tsh, tpa, use_ais=False,
        dynamic_window=dynamic_window)
    tw = tstate.tgt_window.numpy()
    np.testing.assert_array_equal(tw, np.asarray(jstate.tgt_window))
    for name in ("leaf_counts", "gated_counts", "sel_hist_meas", "track_id",
                 "confirmed_mask", "confirmed_meas", "dead"):
        np.testing.assert_array_equal(getattr(touts, name).numpy(),
                                      np.asarray(getattr(jouts, name)),
                                      err_msg=name)
    ids, mask = tstate.tgt_id.numpy(), tstate.tgt_mask.numpy()
    slot0 = int(np.nonzero(mask & (ids == 0))[0][0])
    slot1 = int(np.nonzero(mask & (ids == 1))[0][0])
    if dynamic_window:
        assert 1 <= tw[slot0] < tpa.N and tw[slot1] == tpa.N
    else:
        assert (tw[mask] == tpa.N).all()


def window_pair(degrade_on_overload=False, max_target_time=0.2):
    shapes = dict(max_targets=4, max_leaves=16, max_meas=16, max_ais=2,
                  window=6, max_prelim=4, max_initiators=16)
    params = dict(radar_period=2.5, P_d=0.9, lambda_phi=1e-6, lambda_nu=1e-6,
                  N=5, radar_range=200.0, max_target_time=max_target_time)
    kw = dict(use_ais=False, dynamic_window=True,
              degrade_on_overload=degrade_on_overload)
    jt = JTracker(JShapes(**shapes), JParams(**params), **kw)
    tt = Tracker(TrackerShapes(**shapes), TrackerParams(**params),
                 method='lagrangian', device='cpu', **kw)
    x0 = [np.array([0.0, 0.0, 1.0, 0.0]), np.array([50.0, 50.0, -1.0, 0.0])]
    for tr in (jt, tt):
        tr.pre_initialize(0.0, x0)
        tr.scan_times = [0.0, 2.5, 5.0]            # past the warm-up guard
    return jt, tt


# (dt_wall, leaf_counts, gated_counts) per call, and what must happen to
# the windows of targets 0 and 1 (N = 5)
WINDOW_CASES = {
    # 12 leaves x 400 gated pairs take ~99 % of a 1 s scan: over 200 ms
    "time_budget": ([(1.0, [12, 2, 0, 0], [400, 3, 0, 0])], [4, 5]),
    # a full beam (L = 16) is over budget in capacity
    "saturation": ([(0.01, [16, 3, 0, 0], [5, 5, 0, 0])], [4, 5]),
    # 2.1 s of a 2.5 s period: the roof comes down for everyone, twice
    "roof": ([(2.1, [3, 3, 0, 0], [5, 5, 0, 0])] * 2, [3, 3]),
    "none": ([(0.01, [3, 3, 0, 0], [5, 5, 0, 0])], [5, 5]),
}


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_host_dynamic_window_triggers_match_jax(case):
    calls, want = WINDOW_CASES[case]
    jt, tt = window_pair(max_target_time=0.2 if case == "time_budget"
                         else 10.0)
    for dt_wall, lc, gc in calls:
        lc, gc = np.array(lc, np.int32), np.array(gc, np.int32)
        jt._dynamic_window(dt_wall, lc, gc)
        tt._dynamic_window(dt_wall, lc, gc)
    tw = tt.state.tgt_window.numpy()
    np.testing.assert_array_equal(tw, np.asarray(jt.state.tgt_window))
    assert tt.state.tgt_window.dtype == torch.int32
    assert tw[:2].tolist() == want
    assert getattr(tt, '_n_roof', None) == getattr(jt, '_n_roof', None)
    assert tt.shapes.max_leaves == 16              # no degrade without the flag


def test_host_roof_degrades_with_cooldown_like_jax():
    """With ``degrade_on_overload`` the roof halves the beam, then three
    scans pass before it may do so again (both packages)."""
    jt, tt = window_pair(degrade_on_overload=True, max_target_time=10.0)
    lc, gc = np.array([3, 3, 0, 0], np.int32), np.array([5, 5, 0, 0], np.int32)
    beams = []
    for _ in range(5):
        jt._dynamic_window(2.1, lc, gc)
        tt._dynamic_window(2.1, lc, gc)
        assert tt.shapes.max_leaves == jt.shapes.max_leaves
        assert tt._degrade_cooldown == jt._degrade_cooldown
        assert tt.state.leaf_mask.shape[1] == tt.shapes.max_leaves
        beams.append(tt.shapes.max_leaves)
    assert beams == [8, 8, 8, 4, 4]
    tt.check_integrity()


class ScriptedClock:
    """A clock for ``Tracker._clock``: ``stream`` reads it once before and
    once after each chunk; call 2k returns k * 1000 and call 2k + 1 that
    plus ``seconds_per_chunk[k]``.  Every reading also checks the
    tracker's integrity, so the forest is checked at every chunk
    boundary, before and after a degrade."""

    def __init__(self, tracker, seconds_per_chunk):
        self.tracker, self.script, self.calls = tracker, seconds_per_chunk, 0

    def __call__(self):
        k, toc = divmod(self.calls, 2)
        self.calls += 1
        self.tracker.check_integrity()
        return 1000.0 * k + (self.script[k] if toc else 0.0)


@pytest.mark.parametrize("degrade_on_overload", [True, False])
def test_roof_trigger_in_stream_with_scripted_clock(degrade_on_overload):
    sc = radar_scene()
    n, period = len(sc["scans"]), sc["params"].radar_period
    chunk = 2
    long, short = 0.9 * period * chunk, 0.01
    # chunk 0 long (first: never a load signal), 1 long (degrade), 2 long
    # (the chunk after a degrade is not checked), 3 long (degrade again),
    # 4 short
    script = [long * 50, long, long, long, short]
    assert len(script) == -(-n // chunk)
    tr = new_tracker(sc, degrade_on_overload=degrade_on_overload)
    tr._clock = ScriptedClock(tr, script)
    beams = []
    real_degrade = tr.degrade
    tr.degrade = lambda *a, **k: (beams.append(len(tr.scan_times)),
                                  real_degrade(*a, **k))[1]
    outs = tr.stream(sc["scans"], chunk=chunk, compute_clusters=True)
    assert tr._clock.calls == 2 * len(script)
    if degrade_on_overload:
        assert beams == [4, 8]                    # after chunks 1 and 3
        assert tr.shapes.max_leaves == 4
        assert tr.state.leaf_mask.shape == (8, 4)
    else:
        assert beams == [] and tr.shapes.max_leaves == 16
    # the runtime log holds each chunk's per-scan time; more than the
    # period is a hard violation (chunk 0), more than 60 % a soft one
    per_scan = [script[i // chunk] / len(sc["scans"][i // chunk * chunk:
                                                     i // chunk * chunk
                                                     + chunk])
                for i in range(n)]
    np.testing.assert_allclose(tr.runtime_log, per_scan)
    assert tr.runtime.violations == sum(p > period for p in per_scan) == 2
    assert tr.runtime.soft_violations == \
        sum(0.6 * period < p <= period for p in per_scan) == 6
    assert tr.get_runtime_average()['Total'] == pytest.approx(
        np.mean(per_scan))
    # every selection stays feasible across the switches and the
    # archives are continuous: consecutive scan times, no gap, no repeat
    for c in outs:
        assert c.sel_feasible.all()
    times = tr.scan_times
    for tid, (ts, labels, _, _) in \
            tr._track_measurement_sequences(True).items():
        i0 = times.index(ts[0])
        assert ts == times[i0:i0 + len(ts)], tid
    # until the first switch the run equals the undegraded stepped run
    ref = new_tracker(sc)
    outs_ref = step_all(ref, sc)
    for i in range(4 if degrade_on_overload else n):
        c, j = outs[i // chunk], i % chunk
        np.testing.assert_array_equal(c.sel_hist_meas[j],
                                      outs_ref[i].sel_hist_meas)
    # with a quarter of the beam the tracks of the full run are all found
    assert set(ref.get_tracks()) <= set(tr.get_tracks()) | set(tr.terminated)


def test_stream_excludes_only_the_first_chunk_of_a_call():
    """A long second chunk fires at once; a tracker without the flag, or
    with short chunks, never degrades."""
    sc = radar_scene()
    period = sc["params"].radar_period
    tr = new_tracker(sc, degrade_on_overload=True)
    tr._clock = ScriptedClock(tr, [0.01, 3 * 0.85 * period, 0.01])
    tr.stream(sc["scans"], chunk=3)
    assert tr.shapes.max_leaves == 8 and tr._degrade_cooldown == 0
    calm = new_tracker(sc, degrade_on_overload=True)
    calm._clock = ScriptedClock(calm, [3 * 0.79 * period] * 3)
    calm.stream(sc["scans"], chunk=3)
    assert calm.shapes.max_leaves == 16


@pytest.mark.parametrize("scene", ["radar", "ais"])
def test_prune_similar_in_step_matches_jax_and_streams_alike(scene):
    """``prune_threshold`` is raised so that sibling hypotheses do merge;
    the stepped port equals the stepped JAX Tracker, and the port's
    stream (which hands ``prune_similar`` on to ``scan_many``) equals its
    stepped path."""
    sc = SCENES[scene][0]()
    sc["params"] = dataclasses.replace(sc["params"], prune_threshold=3.0)
    sc["jparams"] = dataclasses.replace(sc["jparams"], prune_threshold=3.0)
    jt = JTracker(sc["jshapes"], sc["jparams"], method='lagrangian',
                  prune_similar=True, **sc["kw"])
    jt.pre_initialize(sc["t_init"], sc["seeds"], mmsi=sc["mmsi"])
    tt = new_tracker(sc, prune_similar=True)
    plain = new_tracker(sc)
    outs_plain = step_all(plain, sc)
    n_fewer = 0
    outs = []
    for i, s in enumerate(sc["scans"]):
        oj = jt.add_measurement_list(
            s.time, s.measurements,
            ais_messages=sc["jgroups"][i] if sc["jgroups"] else None)
        ot = tt.add_measurement_list(
            s.time, s.measurements,
            ais_messages=sc["groups"][i] if sc["groups"] else None,
            check_integrity=True)
        outs.append(ot)
        for name in oj._fields:
            a, b = np.asarray(getattr(oj, name)), getattr(ot, name)
            if a.dtype.kind == "f":
                np.testing.assert_allclose(b, a, err_msg=f"{i} {name}", **TOL)
            else:
                np.testing.assert_array_equal(b, a, err_msg=f"{i} {name}")
        n_fewer += int(ot.n_leaves) < int(outs_plain[i].n_leaves)
    assert n_fewer >= 2, "prune_similar merged nothing on this scene"
    streamed = new_tracker(sc, prune_similar=True)
    chunks = streamed.stream(sc["scans"], sc["groups"], chunk=4,
                             compute_clusters=True)
    flat = [ttracker.StepOutputs(*(f[j] for f in c))
            for c in chunks for j in range(len(c.track_mask))]
    for a, b in zip(outs, flat):
        for name in a._fields:
            np.testing.assert_array_equal(getattr(b, name), getattr(a, name),
                                          err_msg=name)
    streamed.check_integrity()

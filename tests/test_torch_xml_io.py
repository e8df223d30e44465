"""The port's XML export (utils/xml_io.py) against the JAX package's: the
host-only writers give the same bytes on the same inputs, and a run of
both Trackers on the same scans exports the same document element by
element (runtimes apart; numbers within the trackers' f32 tolerance)."""
import os
import re
import xml.etree.ElementTree as ET

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pymht_tpu.core import config as jconfig  # noqa: E402
from pymht_tpu.core.tracker import Tracker as JTracker  # noqa: E402
from pymht_tpu.utils import xml_io as jxml  # noqa: E402
from pymht_tpu_torch.core.config import (  # noqa: E402
    TrackerParams, TrackerShapes)
from pymht_tpu_torch.core.tracker import Tracker  # noqa: E402
from pymht_tpu_torch.utils import metrics, simulator as sim  # noqa: E402
from pymht_tpu_torch.utils import xml_io as txml  # noqa: E402

SHAPES = dict(max_targets=8, max_leaves=16, max_meas=16, max_ais=2, window=6,
              max_prelim=8, max_initiators=16)
PARAMS = dict(radar_period=1.0, P_d=0.9, lambda_phi=1e-6, lambda_nu=1e-6,
              radar_range=500.0)


@pytest.fixture(scope="module")
def runs():
    """Both trackers after the same 12 scans: three targets, one of which
    leaves the radar's range (a terminated track), light clutter."""
    rng = np.random.default_rng(5)
    targets = sim.generate_initial_targets(rng, 2, (0., 0.), 300.0, 0.9, 0.1)
    targets.append(sim.SimTarget(state=np.array([470.0, 0.0, 12.0, 0.0]),
                                 time=0.0, P_d=0.9, sigma_Q=0.1))
    sim_list = sim.simulate_targets(rng, targets, sim_time=11.0, dt=1.0)
    scans = sim.simulate_scans(rng, sim_list, 1.0, sigma_R=1.0,
                               lambda_phi=1e-6, radar_range=500.0,
                               p0=(0., 0.))
    jt = JTracker(jconfig.TrackerShapes(**SHAPES),
                  jconfig.TrackerParams(**PARAMS), method='lagrangian',
                  use_ais=False)
    tt = Tracker(TrackerShapes(**SHAPES), TrackerParams(**PARAMS),
                 method='lagrangian', use_ais=False, device='cpu')
    for s in scans:
        jt.add_measurement_list(s.time, s.measurements)
        tt.add_measurement_list(s.time, s.measurements)
    return jt, tt, sim_list, scans


NUMBER = re.compile(r"-?\d+\.?\d*(?:[eE][-+]?\d+)?")


def _assert_same_text(a, b, where, atol):
    """Equal strings, or the same text around numbers that agree within
    ``atol`` (absolute) or 1e-3 (relative)."""
    a, b = (a or "").strip(), (b or "").strip()
    if a == b:
        return
    assert NUMBER.sub("#", a) == NUMBER.sub("#", b), where
    na = np.array([float(x) for x in NUMBER.findall(a)])
    nb = np.array([float(x) for x in NUMBER.findall(b)])
    np.testing.assert_allclose(nb, na, rtol=1e-3, atol=atol, err_msg=where)


def _assert_same_element(a, b, where="", atol=0.011):
    """States are written rounded to 0.01: a last-bit difference between
    the trackers may flip one unit of rounding."""
    where = f"{where}/{a.tag}"
    assert a.tag == b.tag, where
    if a.tag == txml.RUNTIME:
        assert len(list(a)) == len(list(b)) >= 1
        return
    if a.tag == txml.SMOOTHED_STATES:
        atol = 0.05                 # two smoothers, 12 steps of f32
    assert sorted(a.attrib) == sorted(b.attrib), where
    for k in a.attrib:
        _assert_same_text(a.attrib[k], b.attrib[k], f"{where}@{k}", atol)
    _assert_same_text(a.text, b.text, where, atol)
    assert len(list(a)) == len(list(b)), where
    for ca, cb in zip(a, b):
        _assert_same_element(ca, cb, where, atol)


@pytest.mark.parametrize("kw", [dict(smooth=True), dict(smooth=False),
                                dict(sparse=True),
                                dict(include_sinv=False)],
                         ids=["smooth", "raw", "sparse", "no_sinv"])
def test_store_run_matches_jax_element_by_element(runs, kw):
    jt, tt, _, _ = runs
    ej, et = ET.Element(jxml.SCENARIO), ET.Element(txml.SCENARIO)
    jxml.store_run(ej, jt, i=0, seed=5, **kw)
    txml.store_run(et, tt, i=0, seed=5, **kw)
    _assert_same_element(ej, et)
    run = et.find(txml.RUN)
    tracks = run.findall(txml.TRACK)
    assert len(tracks) >= 3
    assert any(t.attrib.get(txml.TERMINATED) == "True" for t in tracks)
    assert run.find(txml.RUNTIME).find("Total") is not None
    if kw.get("smooth") and not kw.get("sparse"):
        assert sum(t.find(txml.SMOOTHED_STATES) is not None
                   for t in tracks) >= 2
    if kw.get("sparse"):
        assert all(len(t.find(txml.STATES)) <= 2 for t in tracks)
    has_sinv = tracks[0].find(txml.STATES).find(txml.STATE) \
        .find(txml.S_INV) is not None
    assert has_sinv == (not kw.get("sparse")
                        and kw.get("include_sinv", True))


def test_run_parses_back(runs, tmp_path):
    """store_run(smooth=True) written to a file and parsed back: the
    tracks of the tracker, their lengths, a runtime element, smoothed
    states beside the raw ones."""
    _, tt, sim_list, _ = runs
    scenario = ET.Element(txml.SCENARIO)
    txml.store_ground_truth(scenario, sim_list, (0., 0.), 500.0, 1.0, 0.0)
    txml.store_tracker_settings(scenario, tt.shapes, tt.params, seed=5)
    txml.store_run(scenario, tt, smooth=True, i=0)
    path = os.path.join(str(tmp_path), "out", "run.xml")
    txml.write_element_to_file(path, scenario)
    root = ET.parse(path).getroot()
    assert root.tag == txml.SCENARIO
    assert len(root.find(txml.GROUNDTRUTH).findall(txml.TRACK)) == 3
    run = root.find(txml.RUN)
    seqs = tt._track_measurement_sequences(include_terminated=True)
    tracks = {int(t.attrib[txml.ID]): t for t in run.findall(txml.TRACK)}
    assert sorted(tracks) == sorted(seqs)
    for tid, (times, _, states, _) in seqs.items():
        t = tracks[tid]
        assert int(t.attrib[txml.LENGTH]) == len(times)
        raw = t.find(txml.STATES).findall(txml.STATE)
        assert len(raw) == len(times)
        east = float(raw[-1].find(txml.POSITION).find(txml.EAST).text)
        assert abs(east - float(states[-1][0])) <= 0.006
        sm = t.find(txml.SMOOTHED_STATES)
        if sm is not None:
            assert len(sm.findall(txml.STATE)) == len(times)
    assert run.find(txml.RUNTIME).attrib[txml.PRECISION] == "6"
    settings = root.find(txml.TRACKER_SETTINGS)
    assert settings.attrib["max_leaves"] == "16"
    assert settings.attrib["seed"] == "5"


def test_host_writers_give_the_same_bytes(runs):
    """Ground truth, tracker settings and the evaluation tags read no
    device value: both modules write the same document."""
    jt, tt, sim_list, _ = runs
    docs = []
    for mod, tr in ((jxml, jt), (txml, tt)):
        e = ET.Element(mod.SCENARIO)
        mod.store_ground_truth(e, sim_list, (0., 0.), 500.0, 1.0, 0.0)
        mod.store_tracker_settings(e, tt.shapes, tt.params, seed=5, note="x")
        run = ET.SubElement(e, mod.RUN)
        m = metrics.evaluate(tt, sim_list, 1.0, p0=(0., 0.),
                             radar_range=500.0)
        mod.store_evaluation(run, m)
        mod.store_evaluation(ET.SubElement(e, mod.RUN), m,
                             initiation_log=(3, 1))
        docs.append(ET.tostring(e))
    assert docs[0] == docs[1] and len(docs[0]) > 500
    names = [n for n in dir(jxml) if n.isupper()]
    assert len(names) > 60
    for n in names:
        assert getattr(txml, n) == getattr(jxml, n), n


@pytest.mark.parametrize("with_p0", [False, True])
def test_sinv_sequence_matches_jax(with_p0):
    times = [1.0, 2.0, 3.0, None, 5.5, 5.5]
    labels = [1, 0, 3, 2, None, -1]
    P0 = np.diag([4.0, 4.0, 1.0, 1.0]) if with_p0 else None
    params = TrackerParams(**PARAMS)
    a = jxml._sinv_sequence(times, labels, params, P0=P0)
    b = txml._sinv_sequence(times, labels, params, P0=P0)
    assert len(a) == len(b) == len(times)
    for x, y in zip(a, b):
        assert y.dtype == np.float32 and y.shape == (2, 2)
        np.testing.assert_allclose(y, x, rtol=1e-6)


def test_sinv_is_seeded_from_the_initiators_covariance(runs):
    """Tracks started by the initiator carry their two-point covariance
    in ``init_P``; the export seeds the S_inv recursion from it."""
    _, tt, _, _ = runs
    assert tt.init_P and all(P.shape == (4, 4) for P in tt.init_P.values())
    tid, P0 = next(iter(tt.init_P.items()))
    times, labels, _, _ = tt._track_measurement_sequences(True)[tid]
    a = txml._sinv_sequence(times, labels, tt.params, P0=P0)
    b = txml._sinv_sequence(times, labels, tt.params)
    assert not np.allclose(a[0], b[0])

"""Checkpoint/resume of the port (utils/checkpoint.py): a resumed tracker
continues bit-identically, stepped and streamed, and a checkpoint written
by either package resumes in the other (same file format)."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from pymht_tpu.core import config as jconfig  # noqa: E402
from pymht_tpu.core.tracker import Tracker as JTracker  # noqa: E402
from pymht_tpu.utils import checkpoint as jcheckpoint  # noqa: E402
from pymht_tpu_torch.core.config import (  # noqa: E402
    TrackerParams, TrackerShapes)
from pymht_tpu_torch.core.tracker import Tracker  # noqa: E402
from pymht_tpu_torch.utils import checkpoint, simulator as sim  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The solvers are thousands of tiny ops: torch's intra-op thread pool
    adds only contention when several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SHAPES = dict(max_targets=8, max_leaves=16, max_meas=16, max_ais=2, window=6,
              max_prelim=8, max_initiators=16)
PARAMS = dict(radar_period=2.5, P_d=0.9, lambda_phi=2e-6, lambda_nu=1e-6,
              radar_range=500.0)


def _scans(n_scans=12):
    rng = np.random.default_rng(9)
    targets = sim.generate_initial_targets(rng, 4, (0., 0.), 300.0, 0.9, 0.1)
    sim_list = sim.simulate_targets(rng, targets, sim_time=n_scans * 2.5,
                                    dt=2.5)
    return sim.simulate_scans(rng, sim_list, 2.5, sigma_R=2.0,
                              lambda_phi=2e-6, radar_range=500.0,
                              p0=(0., 0.))


def _new(method='lagrangian', **kw):
    return Tracker(TrackerShapes(**SHAPES), TrackerParams(**PARAMS),
                   method=method, use_ais=False, device='cpu', **kw)


def _assert_same_tracker(a, b):
    for tree_a, tree_b in ((a.state, b.state), (a.init_state, b.init_state)):
        for f in dataclasses.fields(tree_a):
            x, y = getattr(tree_a, f.name), getattr(tree_b, f.name)
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            assert torch.equal(x, y), f.name
    assert a.scan_times == b.scan_times and a.t0 == b.t0
    assert len(a.scan_history) == len(b.scan_history)
    for x, y in zip(a.scan_history, b.scan_history):
        np.testing.assert_array_equal(x, y)
    for da, db in ((a.archives, b.archives), (a.terminated, b.terminated)):
        assert sorted(da) == sorted(db)
        for tid, x in da.items():
            y = db[tid]
            assert (x.times, x.meas, x.mmsi, x.status) == \
                (y.times, y.meas, y.mmsi, y.status)
            np.testing.assert_array_equal(np.asarray(x.states),
                                          np.asarray(y.states))


@pytest.mark.parametrize("method", ["lagrangian", "ipm"])
def test_checkpoint_resume_is_bitwise_stepped(tmp_path, method):
    scans = _scans()
    a = _new(method)
    for s in scans:
        a.add_measurement_list(s.time, s.measurements)
    b = _new(method)
    half = len(scans) // 2
    for s in scans[:half]:
        b.add_measurement_list(s.time, s.measurements)
    path = str(tmp_path / "sub" / "ck")
    checkpoint.save(b, path)
    c = checkpoint.load(path, device='cpu')
    assert c.method == method and c.device == torch.device('cpu')
    assert c.shapes == b.shapes and c.params == b.params
    c.use_ais = False
    _assert_same_tracker(b, c)
    for s in scans[half:]:
        c.add_measurement_list(s.time, s.measurements)
    _assert_same_tracker(a, c)
    assert len(a.get_tracks()) >= 3


def test_checkpoint_resume_is_bitwise_streamed(tmp_path):
    """Streamed in chunks of 3 with a full checkpoint after two chunks,
    and the bare device state saved and restored between two others."""
    scans = _scans()
    a = _new()
    a.stream(scans, chunk=3)
    b = _new()
    b.stream(scans[:6], chunk=3)
    path = str(tmp_path / "ck")
    checkpoint.save(b, path)
    c = checkpoint.load(path, device='cpu')
    c.use_ais = False
    c.stream(scans[6:9], chunk=3)
    checkpoint.save_state(str(tmp_path / "bare"), c.state, c.init_state)
    st, ist = checkpoint.load_state(str(tmp_path / "bare"), device='cpu')
    for f in dataclasses.fields(st):
        assert torch.equal(getattr(st, f.name), getattr(c.state, f.name))
    c.state, c.init_state = st, ist
    c.stream(scans[9:], chunk=3)
    _assert_same_tracker(a, c)


def test_save_absorbs_pipelined_outputs(tmp_path):
    scans = _scans(6)
    a, b = _new(), _new(pipeline_outputs=True)
    for s in scans:
        a.add_measurement_list(s.time, s.measurements)
        b.add_measurement_list(s.time, s.measurements)
    checkpoint.save(b, str(tmp_path / "ck"))
    c = checkpoint.load(str(tmp_path / "ck"), device='cpu')
    _assert_same_tracker(a, c)


def test_load_defaults_to_the_card(tmp_path, monkeypatch):
    tr = _new()
    checkpoint.save(tr, str(tmp_path / "ck"))
    checkpoint.save_state(str(tmp_path / "bare"), tr.state, tr.init_state)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        checkpoint.load(str(tmp_path / "ck"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        checkpoint.load_state(str(tmp_path / "bare"))


def _jax_new(method='lagrangian'):
    return JTracker(jconfig.TrackerShapes(**SHAPES),
                    jconfig.TrackerParams(**PARAMS), method=method,
                    use_ais=False)


def _assert_outputs_agree(ot, oj):
    for name in oj._fields:
        a, b = np.asarray(getattr(oj, name)), np.asarray(getattr(ot, name))
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-3,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


def _assert_states_agree(tstate, jstate):
    for f in dataclasses.fields(tstate):
        a = np.asarray(getattr(jstate, f.name))
        b = getattr(tstate, f.name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-3,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f.name)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_between_the_packages(tmp_path, writer):
    """Six scans in one package, ``save``; ``load`` in the other; then
    the remaining scans on both sides, agreeing scan by scan."""
    scans = _scans(9)
    path = str(tmp_path / "ck")
    src = _jax_new() if writer == "jax" else _new()
    for s in scans[:6]:
        src.add_measurement_list(s.time, s.measurements)
    if writer == "jax":
        jcheckpoint.save(src, path)
        dst = checkpoint.load(path, device='cpu')
        jt, tt = src, dst
    else:
        checkpoint.save(src, path)
        dst = jcheckpoint.load(path)
        jt, tt = dst, src
    dst.use_ais = False
    assert dst.method == 'lagrangian'
    assert dst.scan_times == src.scan_times and dst.t0 == src.t0
    assert sorted(dst.archives) == sorted(src.archives)
    _assert_states_agree(tt.state, jax.device_get(jt.state))
    for s in scans[6:]:
        _assert_outputs_agree(tt.add_measurement_list(s.time, s.measurements),
                              jt.add_measurement_list(s.time, s.measurements))
    assert sorted(tt.get_tracks()) == sorted(jt.get_tracks())
    for tid, a in jt.get_tracks().items():
        b = tt.get_tracks()[tid]
        assert b["confirmed_meas"] == a["confirmed_meas"]
        assert b["confirmed_times"] == a["confirmed_times"]


def test_checkpoint_files_have_the_jax_packages_format(tmp_path):
    """The same keys, dtypes and shapes in the .npz, the same keys in the
    JSON sidecar; and the bare state crosses through save_state /
    load_state in both directions."""
    scans = _scans(4)
    jt, tt = _jax_new(), _new()
    for s in scans:
        jt.add_measurement_list(s.time, s.measurements)
        tt.add_measurement_list(s.time, s.measurements)
    jcheckpoint.save(jt, str(tmp_path / "j"))
    checkpoint.save(tt, str(tmp_path / "t"))
    dj, dt = np.load(str(tmp_path / "j.npz")), np.load(str(tmp_path / "t.npz"))
    assert sorted(dj.files) == sorted(dt.files)
    assert {k.split(".")[0] for k in dt.files} == {"state", "init", "scan"}
    for k in dj.files:
        assert dj[k].dtype == dt[k].dtype and dj[k].shape == dt[k].shape, k
    mj = json.load(open(str(tmp_path / "j.json")))
    mt = json.load(open(str(tmp_path / "t.json")))
    assert sorted(mj) == sorted(mt)
    assert set(mj["shapes"]) - set(mt["shapes"]) == {"pregate_approx"}
    assert mj["params"] == mt["params"] and mj["n_scans"] == mt["n_scans"]

    jcheckpoint.save_state(str(tmp_path / "jb"), jt.state, jt.init_state)
    st, ist = checkpoint.load_state(str(tmp_path / "jb"), device='cpu')
    _assert_states_agree(st, jax.device_get(jt.state))
    checkpoint.save_state(str(tmp_path / "tb"), tt.state, tt.init_state)
    jst, jist = jcheckpoint.load_state(str(tmp_path / "tb"))
    _assert_states_agree(tt.state, jax.device_get(jst))
    _assert_states_agree(tt.init_state, jax.device_get(jist))

"""The AIS slice end to end: the port's ``Tracker(use_ais=True)`` against
the JAX Tracker on the scenarios of tests/test_reference_parity_ais.py
(three seeded targets, two with transponders, clutter, AIS messages at
mid-period times; and its id-scrambling variant), and on a scene where an
unclaimed transponder must start a track (``ais_initialization``).

Required per scan: the same selected (measurement, MMSI) labels and every
integer output; float outputs within rtol 1e-4 / atol 1e-3; the selection
objective within 1e-3.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pymht_tpu.core.tracker import Tracker as JTracker  # noqa: E402
from pymht_tpu_torch.core import config as tconfig  # noqa: E402
from pymht_tpu_torch.core import tracker as ttracker  # noqa: E402
from pymht_tpu_torch.core.grow import AisBatch, Scan  # noqa: E402
from pymht_tpu_torch.core.tracker import Tracker  # noqa: E402
from pymht_tpu_torch.utils.simulator import AisMessage  # noqa: E402
from tests.test_reference_parity_ais import (  # noqa: E402
    PARAMS, SHAPES, _ais_scenario)

TOL = dict(rtol=1e-4, atol=1e-3)
W = SHAPES.window


def port(cfg, **kw):
    cls = getattr(tconfig, type(cfg).__name__)
    return cls(**{**{f.name: getattr(cfg, f.name)
                     for f in dataclasses.fields(cls)
                     if hasattr(cfg, f.name)}, **kw})


def port_messages(msgs):
    """The port's own message class, from the JAX side's."""
    return [AisMessage(state=np.asarray(m.state), time=m.time, mmsi=m.mmsi,
                       highAccuracy=m.highAccuracy) for m in msgs]


def assert_outputs_equal(oj, ot, scan):
    for name in oj._fields:
        a, b = np.asarray(getattr(oj, name)), getattr(ot, name)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, err_msg=f"scan {scan}: {name}",
                                       **TOL)
        else:
            np.testing.assert_array_equal(b, a,
                                          err_msg=f"scan {scan}: {name}")
    assert abs(float(ot.sel_obj) - float(oj.sel_obj)) <= 1e-3


def labels(out, K):
    return [(int(out.sel_hist_meas[k, W - 1]),
             int(out.sel_hist_mmsi[k, W - 1])) for k in range(K)]


SCENARIOS = {
    "parity": (dict(), None, {}),
    "id_scrambling": (dict(n_scans=5, seed=9, id_scrambling=True),
                      [0, 0, 0], {}),
    "compressed": (dict(n_scans=6, seed=17), None, dict(ais_per_leaf=2)),
    "pregate": (dict(n_scans=6, seed=17), None,
                dict(ais_per_leaf=2, radar_cand_width=3)),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_tracker_ais_matches_jax(name):
    kw, mmsi_override, shape_kw = SCENARIOS[name]
    x0, mmsi, scans = _ais_scenario(**kw)
    mmsi = mmsi if mmsi_override is None else mmsi_override
    jshapes = dataclasses.replace(SHAPES, **shape_kw)
    jt = JTracker(jshapes, PARAMS, method='lagrangian', use_ais=True,
                  ais_initialization=False)
    tt = Tracker(port(jshapes), port(PARAMS), method='lagrangian',
                 use_ais=True, ais_initialization=False, device='cpu')
    jt.pre_initialize(0.0, x0, mmsi=mmsi)
    tt.pre_initialize(0.0, x0, mmsi=mmsi)
    fused = pure = 0
    for i, (t, z, msgs) in enumerate(scans):
        oj = jt.add_measurement_list(t, z, ais_messages=msgs)
        ot = tt.add_measurement_list(t, z, ais_messages=port_messages(msgs))
        assert_outputs_equal(oj, ot, i)
        assert labels(ot, len(x0)) == labels(oj, len(x0))
        for m, mm in labels(ot, len(x0)):
            fused += int(mm != 0 and m > 0)
            pure += int(mm != 0 and m == 0)
    print(name, "fused", fused, "pure", pure)
    assert fused >= 1, "no fused association was selected"
    assert [len(g) for g in tt.ais_history] == [len(s[2]) for s in scans]
    tr_j, tr_t = jt.get_tracks(), tt.get_tracks()
    assert sorted(tr_t) == sorted(tr_j)
    for tid, a in tr_j.items():
        for key in ("confirmed_meas", "confirmed_mmsi", "window_meas",
                    "window_mmsi"):
            assert tr_t[tid][key] == a[key], (tid, key)


def initiation_scene():
    """One seeded target with a transponder and one unseeded ship that
    only reports over AIS and radar: its first message seeds a prelim,
    the radar confirms it, and the new track carries its MMSI.  The radar
    misses the seeded target on scans 2 and 4, where only its AIS message
    can be associated (a pure-AIS hypothesis)."""
    period = 2.5
    rng = np.random.default_rng(5)
    known = np.array([-50.0, 20.0, 4.0, 0.5])
    newcomer = np.array([80.0, -40.0, -3.0, 2.0])
    F = np.eye(4)
    F[0, 2] = F[1, 3] = period
    scans = []
    for i in range(6):
        t = (i + 1) * period
        known, newcomer = F @ known, F @ newcomer
        z = np.stack([known[:2] + rng.normal(0, 1.0, 2),
                      newcomer[:2] + rng.normal(0, 1.0, 2)])
        if i in (2, 4):
            z = z[1:]
        Fa = np.eye(4)
        Fa[0, 2] = Fa[1, 3] = -1.0            # one second before the scan
        msgs = [AisMessage(state=Fa @ known + rng.normal(0, .3, 4),
                           time=t - 1.0, mmsi=257000001, highAccuracy=True)]
        if i in (1, 3):
            msgs.append(AisMessage(
                state=Fa @ newcomer + rng.normal(0, .3, 4), time=t - 1.0,
                mmsi=987654321, highAccuracy=bool(i == 3)))
        scans.append((t, z.astype(np.float32), msgs))
    x0 = [np.array([-50.0, 20.0, 4.0, 0.5])]
    return x0, [257000001], scans


@pytest.mark.parametrize("ais_initialization", [True, False])
def test_ais_initialization_matches_jax(ais_initialization):
    x0, mmsi, scans = initiation_scene()
    kw = dict(method='lagrangian', use_ais=True,
              ais_initialization=ais_initialization)
    jt = JTracker(SHAPES, PARAMS, **kw)
    tt = Tracker(port(SHAPES), port(PARAMS), device='cpu', **kw)
    jt.pre_initialize(0.0, x0, mmsi=mmsi)
    tt.pre_initialize(0.0, x0, mmsi=mmsi)
    seeded = []
    for i, (t, z, msgs) in enumerate(scans):
        oj = jt.add_measurement_list(t, z, ais_messages=msgs)
        ot = tt.add_measurement_list(t, z, ais_messages=msgs)
        assert_outputs_equal(oj, ot, i)
        seeded.append(labels(ot, 1)[0])
        for f in dataclasses.fields(tt.init_state):
            a = np.asarray(getattr(jt.init_state, f.name))
            b = getattr(tt.init_state, f.name).numpy()
            if a.dtype.kind == "f":
                np.testing.assert_allclose(b, a, err_msg=f.name, rtol=1e-4,
                                           atol=1e-3)
            else:
                np.testing.assert_array_equal(b, a, err_msg=f.name)
    np.testing.assert_array_equal(tt.state.tgt_mmsi.numpy(),
                                  np.asarray(jt.state.tgt_mmsi))
    assert sorted(tt.get_tracks()) == sorted(jt.get_tracks())
    # fused while the radar sees the seeded target, pure AIS when not
    assert seeded[2] == seeded[4] == (0, 257000001)
    assert all(m > 0 and mm == 257000001 for m, mm in seeded[:2])
    held = set(tt.state.tgt_mmsi[tt.state.tgt_mask].tolist())
    if ais_initialization:
        # the AIS-seeded prelim carried the newcomer's MMSI into its track
        assert held == {257000001, 987654321}
    else:
        assert held <= {257000001, 0}


def test_scan_many_with_ais_matches_stepping():
    """scan_many with a leading time axis on the scans and on the AIS
    batches gives the stepped Tracker's outputs."""
    x0, mmsi, scans = _ais_scenario(n_scans=5)
    shapes, params = port(SHAPES), port(PARAMS)
    tr = Tracker(shapes, params, method='lagrangian', device='cpu')
    tr.pre_initialize(0.0, x0, mmsi=mmsi)
    st0, ist0 = tr.state, tr.init_state
    packed = [tr._unpack_inputs(tr._pack_inputs(t - tr.t0, z,
                                                port_messages(msgs)))
              for t, z, msgs in scans]
    scans_b = Scan(*[torch.stack(f) for f in zip(*[p[0] for p in packed])])
    ais_b = AisBatch(*[torch.stack(f) for f in zip(*[p[1] for p in packed])])
    assert ais_b.mmsi.dtype == torch.int32 and ais_b.mask.any()
    _, _, outs = ttracker.scan_many(st0, ist0, scans_b, ais_b, shapes, params,
                                    compute_clusters=True)
    for i, (t, z, msgs) in enumerate(scans):
        o = tr.add_measurement_list(t, z, ais_messages=port_messages(msgs))
        for name in o._fields:
            np.testing.assert_array_equal(getattr(outs, name)[i].numpy(),
                                          getattr(o, name), err_msg=name)


def test_packed_inputs_carry_integers_as_integers():
    """One transfer per scan for scan and AIS together; a nine-digit MMSI
    and the flags come back exactly (no trip through f32 values)."""
    shapes, params = port(SHAPES), port(PARAMS)
    tr = Tracker(shapes, params, device='cpu')
    tr.t0 = 100.0
    msgs = [AisMessage(state=np.array([1.5, -2.5, 3.0, 4.0]), time=101.25,
                       mmsi=999999937, highAccuracy=True),
            AisMessage(state=np.zeros(4), time=102.0, mmsi=200000003,
                       highAccuracy=False)]
    z = np.array([[10.0, 20.0], [30.0, 40.0], [50.0, 60.0]], np.float32)
    packed = tr._pack_inputs(2.5, z, msgs)
    assert packed.dtype == torch.uint8 and packed.dim() == 1
    scan, ais = tr._unpack_inputs(packed)
    assert scan.mask.tolist() == [True] * 3 + [False] * (shapes.max_meas - 3)
    np.testing.assert_array_equal(scan.z[:3].numpy(), z)
    assert float(scan.time) == 2.5
    assert ais.mmsi.tolist() == [999999937, 200000003, 0, 0]
    assert ais.time.tolist() == [1.25, 2.0, 0.0, 0.0]
    assert ais.high_accuracy.tolist() == [True, False, False, False]
    assert ais.mask.tolist() == [True, True, False, False]
    np.testing.assert_array_equal(ais.state[0].numpy(),
                                  np.float32([1.5, -2.5, 3.0, 4.0]))
    radar_only = Tracker(shapes, params, use_ais=False, device='cpu')
    scan, none = radar_only._unpack_inputs(radar_only._pack_inputs(2.5, z))
    assert none is None and int(scan.mask.sum()) == 3

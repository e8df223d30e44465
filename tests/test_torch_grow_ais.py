"""grow of the port with an AisBatch and with the spatial pre-gate
(``radar_cand_width``) against the JAX grow on the same forest.

Scenes: the one of tests/test_grow_kernel_path.py::
test_pregate_matches_exact_grow (L=8, M=32, A=4), and a forest four scans
into the AIS scenario of tests/test_reference_parity_ais.py (a label
history with fused and pure-AIS columns).

Required: identical hist_meas / hist_ais / hist_mmsi, leaf_mask,
spine_leaf, used_meas and gated_counts; leaf_x, leaf_P and leaf_cnllr
within rtol 1e-4 / atol 1e-3.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from pymht_tpu.core.config import TrackerShapes, TrackerParams  # noqa: E402
from pymht_tpu.core.grow import (  # noqa: E402
    AisBatch as JAis, Scan as JScan, grow as jgrow)
from pymht_tpu.core.state import empty_state, insert_targets  # noqa: E402
from pymht_tpu.core.tracker import Tracker as JTracker  # noqa: E402
from pymht_tpu.models import pv  # noqa: E402
from pymht_tpu_torch import sync  # noqa: E402
from pymht_tpu_torch.core import config as tconfig  # noqa: E402
from pymht_tpu_torch.core import grow as tgrow  # noqa: E402
from pymht_tpu_torch.core import state as tstate  # noqa: E402
from pymht_tpu_torch.core.grow import Scan, grow  # noqa: E402
from pymht_tpu_torch.ops import gate_kernel as tk  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-3)


def port(cfg):
    cls = getattr(tconfig, type(cfg).__name__)
    return cls(**{f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cls) if hasattr(cfg, f.name)})


def to_port(jstate):
    return tstate.state_from_numpy(
        {f.name: np.asarray(getattr(jstate, f.name))
         for f in dataclasses.fields(jstate)}, "cpu")


@functools.lru_cache(maxsize=None)
def pregate_scene():
    """Six targets 60 m apart with a return each, three extra returns and
    clutter; one AIS message for target 0, which holds its MMSI."""
    shapes = TrackerShapes(max_targets=8, max_leaves=8, max_meas=32,
                           max_ais=4, window=5, ais_per_leaf=2)
    params = TrackerParams(radar_period=2.5, P_d=0.9, lambda_phi=2e-6,
                           lambda_nu=1e-6, N=3)
    rng = np.random.default_rng(21)
    xs = np.zeros((8, 4), np.float32)
    for i in range(6):
        xs[i, :2] = [60.0 * i, 10.0 * (i % 3)]
        xs[i, 2:] = rng.normal(0, 2.0, 2)
    mask = np.zeros(8, bool)
    mask[:6] = True
    mm = np.zeros(8, np.int32)
    mm[0] = 111000001
    st0 = insert_targets(empty_state(shapes, params), jnp.asarray(xs),
                         jnp.broadcast_to(pv.P0, (8, 4, 4)),
                         jnp.asarray(mask), jnp.asarray(mm),
                         jnp.asarray(0.0), params)
    z = np.concatenate([
        xs[:6, :2] + xs[:6, 2:] * 2.5 + rng.normal(0, 1.0, (6, 2)),
        xs[:3, :2] + xs[:3, 2:] * 2.5 + rng.normal(0, 2.0, (3, 2)),
        rng.uniform(-200, 500, (10, 2))]).astype(np.float32)
    zp = np.zeros((32, 2), np.float32)
    zp[:len(z)] = z
    zm = np.zeros(32, bool)
    zm[:len(z)] = True
    scan = dict(z=zp, mask=zm, time=np.float32(2.5))
    ais = dict(
        state=np.stack([xs[0] + [2.0, 0, 0, 0], np.zeros(4), np.zeros(4),
                        np.zeros(4)]).astype(np.float32),
        time=np.float32([1.6, 0, 0, 0]),
        mmsi=np.int32([111000001, 0, 0, 0]),
        high_accuracy=np.array([True, False, False, False]),
        mask=np.array([True, False, False, False]))
    return shapes, params, st0, scan, ais


@functools.lru_cache(maxsize=None)
def fused_history_scene():
    """Four scans into the AIS scenario of
    tests/test_reference_parity_ais.py through the JAX Tracker, then the
    fifth scan's inputs: leaves whose history holds fused and pure-AIS
    columns, MMSIs of nine digits."""
    from tests.test_reference_parity_ais import (
        PARAMS, SHAPES, _ais_scenario)
    shapes = dataclasses.replace(SHAPES, max_leaves=16, ais_per_leaf=2)
    x0, mmsi, scans = _ais_scenario()
    tr = JTracker(shapes, PARAMS, method='lagrangian', use_ais=True,
                  ais_initialization=False)
    tr.pre_initialize(0.0, x0, mmsi=mmsi)
    for t, z, msgs in scans[:4]:
        tr.add_measurement_list(t, z, ais_messages=msgs)
    assert (np.asarray(tr.state.hist_ais) > 0).any()
    t, z, msgs = scans[4]
    assert msgs
    packed = np.asarray(tr._pad_scan(t - tr.t0, z))
    M = shapes.max_meas
    scan = dict(z=packed[:M], mask=np.arange(M) < int(packed[M, 0]),
                time=np.float32(packed[M, 1]))
    ais = {k: np.asarray(v) for k, v in tr._pad_ais(msgs)._asdict().items()}
    return shapes, PARAMS, tr.state, scan, ais


def run_both(shapes, params, jstate, scan, ais):
    jscan = JScan(**{k: jnp.asarray(v) for k, v in scan.items()})
    jais = None if ais is None else JAis(
        **{k: jnp.asarray(v) for k, v in ais.items()})
    g_j = jax.device_get(jgrow(jstate, jscan, jais, shapes, params))
    g_t = grow(to_port(jstate),
               Scan(**{k: torch.as_tensor(np.array(v)) for k, v in scan.items()}),
               None if ais is None else tstate.ais_from_numpy(ais, "cpu"),
               port(shapes), port(params))
    return g_j, g_t


def assert_same(g_j, g_t):
    sj, st = g_j.state, tstate.state_to_numpy(g_t.state)
    lm = np.asarray(sj.leaf_mask)
    for name in ("leaf_mask", "hist_meas", "hist_ais", "hist_mmsi",
                 "spine_leaf", "tgt_depth", "scan_idx"):
        np.testing.assert_array_equal(st[name], np.asarray(getattr(sj, name)),
                                      err_msg=name)
        assert st[name].dtype == np.asarray(getattr(sj, name)).dtype, name
    np.testing.assert_array_equal(g_t.used_meas.numpy(),
                                  np.asarray(g_j.used_meas))
    np.testing.assert_array_equal(g_t.gated_counts.numpy(),
                                  np.asarray(g_j.gated_counts))
    for name in ("leaf_x", "leaf_P", "leaf_cnllr"):
        np.testing.assert_allclose(st[name][lm],
                                   np.asarray(getattr(sj, name))[lm],
                                   err_msg=name, **TOL)
    for name in ("hist_cnllr", "hist_x", "lam", "time"):
        np.testing.assert_allclose(st[name], np.asarray(getattr(sj, name)),
                                   err_msg=name, **TOL)
    return st


@pytest.mark.parametrize("scene", [pregate_scene, fused_history_scene])
@pytest.mark.parametrize("Km", [0, -1, 8, 3])
@pytest.mark.parametrize("use_ais", [True, False])
def test_grow_matches_jax(scene, Km, use_ais):
    """Km = 0: no pre-gate; -1: M - 1 columns (every real measurement
    stays); 8 and 3: tight pre-gates (3 drops gated measurements on the
    pre-gate scene — the approximation must still be JAX's)."""
    shapes, params, jstate, scan, ais = scene()
    Km = min(Km % shapes.max_meas, shapes.max_meas - 1) if Km else 0
    shapes = dataclasses.replace(shapes, radar_cand_width=Km)
    g_j, g_t = run_both(shapes, params, jstate, scan,
                        ais if use_ais else None)
    st = assert_same(g_j, g_t)
    assert st["leaf_mask"].sum() > np.asarray(jstate.tgt_mask).sum()
    new_ais = st["hist_ais"][:, :, -1][st["leaf_mask"]]
    assert (new_ais > 0).any() == use_ais
    if use_ais:
        mm = st["hist_mmsi"][:, :, -1][st["leaf_mask"]]
        assert set(mm[new_ais > 0]) <= set(ais["mmsi"][ais["mask"]])
        assert mm.max() > 2 ** 24        # would not survive a trip via f32


def test_pregate_keeps_exact_decisions():
    """With Km covering every gated measurement the pre-gated grow equals
    the exact one (the approximation contract of radar_cand_width)."""
    shapes, params, jstate, scan, ais = pregate_scene()
    tscan = Scan(**{k: torch.as_tensor(np.array(v)) for k, v in scan.items()})
    tais = tstate.ais_from_numpy(ais, "cpu")
    exact = grow(to_port(jstate), tscan, tais, port(shapes), port(params))
    for Km in (31, 8):
        pre = grow(to_port(jstate), tscan, tais,
                   dataclasses.replace(port(shapes), radar_cand_width=Km),
                   port(params))
        for name in ("hist_meas", "hist_ais", "hist_mmsi", "leaf_mask"):
            assert torch.equal(getattr(pre.state, name),
                               getattr(exact.state, name)), (Km, name)
        torch.testing.assert_close(pre.state.leaf_cnllr,
                                   exact.state.leaf_cnllr, rtol=0, atol=1e-5)
        torch.testing.assert_close(pre.state.leaf_x, exact.state.leaf_x,
                                   rtol=0, atol=1e-4)
        assert torch.equal(pre.used_meas, exact.used_meas)
        assert torch.equal(pre.gated_counts, exact.gated_counts)


def test_pregate_goes_through_k1_per_target(monkeypatch):
    """Under the pre-gate grow makes one call to K1's wrapper, with the
    per-target measurements: z_sub [T, Km, 2], zidx int32 on the real
    axis, and used_meas [M] is the wrapper's tensor."""
    shapes, params, jstate, scan, ais = pregate_scene()
    calls = []

    def spy(*args, **kw):
        calls.append((kw, tk.radar_candidates(*args, **kw)))
        return calls[-1][1]

    monkeypatch.setattr(tgrow, "radar_candidates", spy)
    n_sync = sync.count
    g = grow(to_port(jstate),
             Scan(**{k: torch.as_tensor(np.array(v)) for k, v in scan.items()}),
             tstate.ais_from_numpy(ais, "cpu"),
             dataclasses.replace(port(shapes), radar_cand_width=8),
             port(params))
    assert len(calls) == 1
    assert sync.count == n_sync         # grow reads nothing on the host
    kw, cand = calls[0]
    T, L, M = shapes.max_targets, shapes.max_leaves, shapes.max_meas
    assert kw["z_sub"].shape == (T, 8, 2)
    assert kw["zmask_sub"].shape == (T, 8)
    assert kw["zidx"].dtype == torch.int32 and kw["zidx"].shape == (T, 8)
    assert kw["leaves_per_target"] == L
    assert cand.scores.shape == (T * L, 9)
    assert g.used_meas is cand.used_meas and g.used_meas.shape == (M,)
    # the nearest measurement of target t is one of its own returns
    # (index t, and t + 6 for the first three)
    for t, m in enumerate(kw["zidx"][:6, 0].tolist()):
        assert m in (t, t + 6)


def test_empty_batch_equals_radar_only():
    """use_ais with no message: the AIS branch on an empty batch gives
    the radar-only forest."""
    shapes, params, jstate, scan, ais = pregate_scene()
    tscan = Scan(**{k: torch.as_tensor(np.array(v)) for k, v in scan.items()})
    a = grow(to_port(jstate), tscan, tgrow.empty_ais(port(shapes), "cpu"),
             port(shapes), port(params))
    b = grow(to_port(jstate), tscan, None, port(shapes), port(params))
    for f in dataclasses.fields(a.state):
        assert torch.equal(getattr(a.state, f.name),
                           getattr(b.state, f.name)), f.name

"""grow (radar branch) of the port against JAX grow on the same forest:
through the Pallas kernel (use_gate_kernel=True, interpret mode) and
through the default XLA planes (False).

Required: identical hist_meas, leaf_mask and used_meas; states and
scores within rtol 1e-4 / atol 1e-3.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from pymht_tpu.core.config import TrackerShapes, TrackerParams  # noqa: E402
from pymht_tpu.core.grow import Scan as JScan, grow as jgrow  # noqa: E402
from pymht_tpu.core.state import empty_state, insert_targets  # noqa: E402
from pymht_tpu.core.tracker import Tracker as JTracker  # noqa: E402
from pymht_tpu.models import pv  # noqa: E402
from pymht_tpu.utils import simulator as sim  # noqa: E402
from pymht_tpu_torch.core import config as tconfig  # noqa: E402
from pymht_tpu_torch.core import state as tstate  # noqa: E402
from pymht_tpu_torch.core import grow as tgrow  # noqa: E402
from pymht_tpu_torch.core.grow import Scan, grow, smallest_k  # noqa: E402
from pymht_tpu_torch.ops import gate_kernel as tk  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-3)


def port(cfg):
    """The port's own TrackerShapes/TrackerParams, built from the numbers
    of the JAX package's: each side is given its own classes."""
    cls = getattr(tconfig, type(cfg).__name__)
    return cls(**{f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cls) if hasattr(cfg, f.name)})


def to_port(jstate):
    return tstate.state_from_numpy(
        {f.name: np.asarray(getattr(jstate, f.name))
         for f in dataclasses.fields(jstate)}, "cpu")


def kernel_path_scene():
    """tests/test_grow_kernel_path.py's scene: three targets with a
    measurement each plus clutter, one free slot."""
    shapes = TrackerShapes(max_targets=4, max_leaves=8, max_meas=16,
                           max_ais=2, window=5)
    params = TrackerParams(radar_period=2.5, P_d=0.85, lambda_phi=1e-5,
                           lambda_nu=1e-5, N=3)
    rng = np.random.default_rng(0)
    state = empty_state(shapes, params)
    xs = rng.normal(0, 50, (4, 4)).astype(np.float32)
    state = insert_targets(state, jnp.asarray(xs),
                           jnp.broadcast_to(pv.P0, (4, 4, 4)),
                           jnp.asarray(np.array([True, True, True, False])),
                           jnp.zeros(4, jnp.int32), jnp.asarray(0.0), params)
    z = np.concatenate([xs[:3, :2] + xs[:3, 2:] * 2.5
                        + rng.normal(0, 1, (3, 2)),
                        rng.normal(0, 60, (13, 2))]).astype(np.float32)
    return shapes, params, state, z, np.ones(16, bool), 2.5


def cluttered_scene():
    """Eight targets in clutter, three scans into a JAX tracker run: a
    forest with many live leaves per target and a real label history."""
    period = 2.5
    shapes = TrackerShapes(max_targets=12, max_leaves=16, max_meas=48,
                           max_ais=2, window=5, max_prelim=8,
                           max_initiators=48)
    params = TrackerParams(radar_period=period, P_d=0.9, lambda_phi=4e-5,
                           lambda_nu=1e-5, N=3, radar_range=250.0)
    rng = np.random.default_rng(11)
    targets = sim.generate_initial_targets(rng, 8, (0.0, 0.0), 150.0, 0.9,
                                           0.1)
    sim_list = sim.simulate_targets(rng, targets, sim_time=4 * period,
                                    dt=period)
    scans = sim.simulate_scans(rng, sim_list, period, sigma_R=2.5,
                               lambda_phi=4e-5, radar_range=250.0,
                               p0=(0.0, 0.0), lambda_local=1.0)
    F_inv = np.eye(4)
    F_inv[0, 2] = F_inv[1, 3] = -period
    tr = JTracker(shapes, params, method='lagrangian', use_ais=False)
    tr.pre_initialize(scans[0].time - period, [F_inv @ t.state
                                               for t in targets])
    for s in scans[:3]:
        tr.add_measurement_list(s.time, s.measurements)
    s = scans[3]
    n = min(len(s.measurements), shapes.max_meas)
    z = np.zeros((shapes.max_meas, 2), np.float32)
    z[:n] = s.measurements[:n]
    zmask = np.arange(shapes.max_meas) < n
    return (shapes, params, tr.state, z, zmask,
            float(s.time) - tr.t0)


@pytest.mark.parametrize("scene", [kernel_path_scene, cluttered_scene])
@pytest.mark.parametrize("use_gate_kernel", [True, False])
def test_grow_matches_jax(scene, use_gate_kernel):
    shapes, params, jstate, z, zmask, t = scene()
    jscan = JScan(z=jnp.asarray(z), mask=jnp.asarray(zmask),
                  time=jnp.asarray(t, jnp.float32))
    g_j = jax.device_get(jgrow(jstate, jscan, None, shapes, params,
                               use_gate_kernel=use_gate_kernel))
    scan = Scan(z=torch.from_numpy(z), mask=torch.from_numpy(zmask),
                time=torch.tensor(t, dtype=torch.float32))
    g_t = grow(to_port(jstate), scan, None, port(shapes), port(params))
    sj, st = g_j.state, tstate.state_to_numpy(g_t.state)
    lm = np.asarray(sj.leaf_mask)
    assert lm.sum() > np.asarray(sj.tgt_mask).sum()      # a real beam
    for name in ("leaf_mask", "hist_meas", "hist_ais", "hist_mmsi",
                 "spine_leaf", "tgt_depth", "scan_idx"):
        np.testing.assert_array_equal(st[name], np.asarray(getattr(sj, name)),
                                      err_msg=name)
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


@pytest.mark.parametrize("scene", [kernel_path_scene, cluttered_scene])
def test_grow_takes_gain_counts_and_used_from_k1(scene, monkeypatch):
    """grow makes one call to K1's wrapper and reads K, P_hat, the
    per-leaf counts and the used mask from it: used_meas is the wrapper's
    tensor, gated_counts its per-target sum, and both equal the JAX
    package's reductions of the gate."""
    shapes, params, jstate, z, zmask, t = scene()
    calls = []

    def spy(*args, **kw):
        assert not kw                       # no pre-gate: the shared scan
        calls.append(tk.radar_candidates(*args))
        return calls[-1]

    monkeypatch.setattr(tgrow, "radar_candidates", spy)
    assert not hasattr(tgrow, "k")          # no Kalman precalc in grow
    scan = Scan(z=torch.from_numpy(z), mask=torch.from_numpy(zmask),
                time=torch.tensor(t, dtype=torch.float32))
    g_t = grow(to_port(jstate), scan, None, port(shapes), port(params))
    assert len(calls) == 1
    cand = calls[0]
    T, L = shapes.max_targets, shapes.max_leaves
    assert g_t.used_meas is cand.used_meas
    np.testing.assert_array_equal(
        g_t.gated_counts.numpy(),
        cand.gated_counts.numpy().reshape(T, L).sum(1))
    assert g_t.gated_counts.dtype == torch.int32
    jscan = JScan(z=jnp.asarray(z), mask=jnp.asarray(zmask),
                  time=jnp.asarray(t, jnp.float32))
    g_j = jax.device_get(jgrow(jstate, jscan, None, shapes, params))
    np.testing.assert_array_equal(g_t.used_meas.numpy(),
                                  np.asarray(g_j.used_meas))
    np.testing.assert_array_equal(g_t.gated_counts.numpy(),
                                  np.asarray(g_j.gated_counts))
    assert int(g_t.gated_counts.sum()) > 0


def test_state_round_trip():
    """JAX state -> numpy -> port -> numpy is the identity, dtypes kept."""
    _, _, jstate, _, _, _ = cluttered_scene()
    d = {f.name: np.asarray(getattr(jstate, f.name))
         for f in dataclasses.fields(jstate)}
    back = tstate.state_to_numpy(tstate.state_from_numpy(d, "cpu"))
    assert set(back) == set(d)
    for k, v in d.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_grow_refuses_unported_options():
    """Nothing of grow is left unported: the pre-gate runs, and the only
    thing grow refuses is an ``ais`` that is not an AisBatch."""
    shapes, params, jstate, z, zmask, t = kernel_path_scene()
    scan = Scan(z=torch.from_numpy(z), mask=torch.from_numpy(zmask),
                time=torch.tensor(t))
    with pytest.raises(TypeError, match="AisBatch"):
        grow(to_port(jstate), scan, object(), port(shapes), port(params))
    g = grow(to_port(jstate), scan, None,
             dataclasses.replace(port(shapes), radar_cand_width=4),
             port(params))
    assert g.used_meas.shape == (shapes.max_meas,) and g.state.leaf_mask.any()


@pytest.mark.parametrize("seed", range(3))
def test_beam_tie_order_matches_jax_top_k(seed):
    """smallest_k keeps jax.lax.top_k(-x, k)'s order on heavy ties (the
    score plane is mostly equal BIG entries, and beam slots follow it)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 4, (6, 300)).astype(np.float32)
    x[:, 100:] = 1e9
    for k in (5, 40, 150):
        neg, idx_j = jax.lax.top_k(-jnp.asarray(x), k)
        vals, idx_t = smallest_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
        np.testing.assert_array_equal(vals.numpy(), -np.asarray(neg))

"""The port's Monte-Carlo runner against the JAX package's
(pymht_tpu/parallel/montecarlo.py), and the port's scenario generator.

One JAX ``generate`` at tests/test_montecarlo.py's shapes (B=4 scenarios,
3 targets, 8 scans, sigma_Q=0.05) goes, as numpy, through JAX's
``run_batch`` (one compile, in a module fixture) and through the port's
on the CPU: the track masks must be equal on every scan, the track
states within STATE_RTOL / STATE_ATOL, and the final states field by
field (integers equal, floats within the same tolerance).  JAX's PRNG
cannot be reproduced, so the port's ``generate`` is held to the
statistics of its contract instead.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from pymht_tpu.core.config import (  # noqa: E402
    TrackerParams as JParams, TrackerShapes as JShapes)
from pymht_tpu.parallel import montecarlo as jmc  # noqa: E402
from pymht_tpu_torch.core.config import (  # noqa: E402
    TrackerParams, TrackerShapes)
from pymht_tpu_torch.core.state import state_to_numpy  # noqa: E402
from pymht_tpu_torch.parallel import montecarlo as mc  # noqa: E402

SHAPE_KW = dict(max_targets=8, max_leaves=16, max_meas=24, max_ais=2,
                window=6, max_prelim=8, max_initiators=24)
PARAM_KW = dict(radar_period=2.5, P_d=0.95, lambda_phi=1e-6,
                lambda_nu=1e-5, N=4, radar_range=500.0)
SHAPES, PARAMS = TrackerShapes(**SHAPE_KW), TrackerParams(**PARAM_KW)
# 8 scans of f32 filtering on ~500 m positions
STATE_RTOL, STATE_ATOL = 1e-4, 1e-2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Thousands of tiny ops: no intra-op thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_run():
    shapes, params = JShapes(**SHAPE_KW), JParams(**PARAM_KW)
    sc = jmc.generate(jax.random.PRNGKey(7), batch=4, n_targets=3,
                      n_scans=8, shapes=shapes, params=params,
                      radar_range=500.0, sigma_Q=0.05)
    state_b, xs, ms = jax.device_get(jmc.run_batch(sc, shapes, params))
    return jax.device_get(sc), state_b, np.asarray(xs), np.asarray(ms)


def test_run_batch_matches_jax(jax_run):
    sc_j, state_j, xs_j, ms_j = jax_run
    sc = mc.McScenario(*(torch.from_numpy(np.array(a)) for a in sc_j))
    state_b, xs, ms = mc.run_batch(sc, SHAPES, PARAMS)
    assert xs.shape == xs_j.shape == (8, 4, 8, 4)
    for s in range(xs.shape[0]):
        np.testing.assert_array_equal(ms[s].numpy(), ms_j[s],
                                      err_msg=f"track masks, scan {s}")
        np.testing.assert_allclose(xs[s].numpy(), xs_j[s], rtol=STATE_RTOL,
                                   atol=STATE_ATOL,
                                   err_msg=f"track states, scan {s}")
    assert ms_j[-1].sum() >= 8               # the run tracks something
    for name, a in state_to_numpy(state_b).items():
        b = np.asarray(getattr(state_j, name))
        assert a.shape == b.shape, name
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=STATE_RTOL,
                                       atol=STATE_ATOL, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def _generate(seed, **kw):
    args = dict(batch=4, n_targets=3, n_scans=6, shapes=SHAPES,
                params=PARAMS, radar_range=500.0)
    args.update(kw)
    return mc.generate(torch.Generator().manual_seed(seed), **args)


def test_generate_shapes_and_determinism():
    s1, s2, s3 = _generate(0), _generate(0), _generate(1)
    assert s1.z.shape == (4, 6, 24, 2) and s1.z_mask.shape == (4, 6, 24)
    assert s1.truth.shape == (4, 6, 3, 4) and s1.z_mask.dtype == torch.bool
    assert all(a.device.type == "cpu" for a in s1)     # the generator's
    np.testing.assert_allclose(s1.times.numpy(),
                               2.5 * (np.arange(6) + 1))
    for a, b in zip(s1, s2):
        assert torch.equal(a, b)
    assert not torch.equal(s1.z, s3.z)
    det_rate = s1.z_mask[:, :, :3].float().mean()
    assert det_rate > 0.8                    # P_d = 0.95


def test_generate_statistics():
    """Detections thin at P_d among in-range targets; speeds come from
    SPEEDS and starts lie within 0.8 of the range (with no process
    noise: the truth at scan 0 is the start moved one period)."""
    sc = _generate(2, batch=256, n_scans=8, P_d=0.8, sigma_Q=0.0)
    in_rng = sc.truth[..., :2].norm(dim=-1) <= 500.0
    det = sc.z_mask[:, :, :3]
    assert not (det & ~in_rng).any()
    rate = float(det[in_rng].float().mean())
    assert abs(rate - 0.8) < 0.02, rate
    v = sc.truth[:, 0, :, 2:]
    speed = v.norm(dim=-1)
    d = (speed[..., None] - mc.SPEEDS).abs().amin(dim=-1)
    assert float(d.max()) < 1e-3
    assert len(set(np.round(speed.numpy().ravel(), 2))) == len(mc.SPEEDS)
    start = sc.truth[:, 0, :, :2] - 2.5 * v
    assert float(start.norm(dim=-1).max()) <= 0.8 * 500.0 + 1e-2
    # the target returns lie around the truth
    err = (sc.z[:, :, :3] - sc.truth[..., :2])[det]
    assert 2.0 < float(err.std()) < 3.0      # sigma_R = 2.5


def test_generate_caps_the_clutter():
    """Local clutter fills K * local_cap columns; global clutter the
    remaining M - K - K * Cl, whatever the Poisson rate asks for."""
    K, Cl, M = 3, 2, SHAPES.max_meas
    sc = _generate(3, batch=32, n_targets=K, clutter_rate=1e-3,
                   lambda_local=0.5, local_cap=Cl)
    assert sc.z.shape[2] == M
    glob = sc.z_mask[:, :, K + K * Cl:]
    assert glob.shape[2] == M - K - K * Cl
    assert int(glob.sum(dim=2).max()) <= M - K - K * Cl
    assert glob.float().mean() > 0.7         # 785 points asked for
    xy = sc.z[:, :, K + K * Cl:][glob]
    assert float(xy.norm(dim=-1).max()) <= 500.0
    loc = sc.z_mask[:, :, K:K + K * Cl]        # Poisson(0.5) points, cap 2
    assert loc.any() and not loc.all()
    with pytest.raises(ValueError, match="no room for clutter"):
        _generate(4, n_targets=8, lambda_local=0.5, local_cap=2)


def test_generate_needs_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mc.generate(0, 2, 3, 4, SHAPES, PARAMS, 500.0)
    sc = mc.generate(0, 2, 3, 4, SHAPES, PARAMS, 500.0, device="cpu")
    assert sc.z.device.type == "cpu"


def test_run_batch_tracks_truth():
    """tests/test_montecarlo.py's criterion, on the port's own draw."""
    sc = mc.generate(torch.Generator().manual_seed(7), batch=4, n_targets=3,
                     n_scans=8, shapes=SHAPES, params=PARAMS,
                     radar_range=500.0, sigma_Q=0.05)
    state_b, xs, ms = mc.run_batch(sc, SHAPES, PARAMS)
    assert xs.shape == (8, 4, 8, 4) and ms.shape == (8, 4, 8)
    errs = [float((xs[-1, b, k, :2] - sc.truth[b, -1, k, :2]).norm())
            for b in range(4) for k in range(3) if ms[-1, b, k]]
    assert len(errs) >= 8, "most tracks should survive"
    assert np.median(errs) < 20.0, f"median err {np.median(errs)}"
    assert state_b.leaf_x.shape == (4, 8, 16, 4)


def test_signatures_are_the_jax_packages():
    import inspect
    for name in ("generate", "run_batch"):
        a = list(inspect.signature(getattr(mc, name)).parameters)
        b = list(inspect.signature(getattr(jmc, name)).parameters)
        assert a[:len(b)] == b, name
    assert mc.McScenario._fields == jmc.McScenario._fields
    np.testing.assert_array_equal(mc.SPEEDS.numpy(), np.asarray(jmc.SPEEDS))

"""The port's RTS smoother (ops/smoother.py) against the JAX package's on
seeded tracks: a single track with missed detections, a padded batch of
tracks of different lengths, ``em_iters`` 0 and 5 in both EM modes; and
``Tracker.get_smooth_tracks`` of both Trackers on one run.

Tolerances (f32; the port sums its 4x4 products in another order than
XLA's einsums, and five EM refits feed that back through the noise
matrices): pure RTS rtol 1e-4 / atol 1e-3 on states of hundreds of
metres and on covariances; with EM rtol 2e-3 / atol 2e-2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from pymht_tpu.models import pv as jpv  # noqa: E402
from pymht_tpu.ops import smoother as jsm  # noqa: E402
from pymht_tpu.core.config import TrackerShapes as JShapes  # noqa: E402
from pymht_tpu.core.tracker import Tracker as JTracker  # noqa: E402
from pymht_tpu_torch.core.config import TrackerShapes  # noqa: E402
from pymht_tpu_torch.core.tracker import Tracker  # noqa: E402
from pymht_tpu_torch.models import pv  # noqa: E402
from pymht_tpu_torch.ops import smoother as tsm  # noqa: E402
from tests.test_torch_tracker import cluttered_scene  # noqa: E402

PERIOD = 2.5
TOL_RTS = dict(rtol=1e-4, atol=1e-3)
TOL_EM = dict(rtol=2e-3, atol=2e-2)
MODES = [(0, 'scalar'), (5, 'scalar'), (5, 'full')]


def seeded_track(seed, n, p_detect=0.8):
    """A constant-velocity track with process noise, measured with 2.5 m
    noise; ``p_detect`` of the steps observed (the first two always)."""
    rng = np.random.default_rng(seed)
    F = np.eye(4)
    F[0, 2] = F[1, 3] = PERIOD
    x = np.array([rng.normal(0, 300), rng.normal(0, 300),
                  rng.normal(0, 6), rng.normal(0, 6)])
    x0 = x + rng.normal(0, 1.0, 4)
    zs = np.zeros((n, 2), np.float32)
    for i in range(n):
        x = F @ x + rng.normal(0, 0.3, 4) * [1, 1, .3, .3]
        zs[i] = x[:2] + rng.normal(0, 2.5, 2)
    mask = rng.random(n) < p_detect
    mask[:2] = True
    zs[~mask] = 1e6        # garbage where not observed must not matter
    return x0.astype(np.float32), zs, mask


@pytest.mark.parametrize("em_iters,em_mode", MODES)
def test_rts_smooth_matches_jax(em_iters, em_mode):
    x0, zs, mask = seeded_track(3, 14)
    mask[[5, 6, 10]] = False                       # missed detections
    zs[~mask] = 1e6
    want_x, want_P = jsm.rts_smooth(
        jnp.asarray(x0), jpv.P0, jnp.asarray(zs), jnp.asarray(mask), PERIOD,
        em_iters=em_iters, em_mode=em_mode)
    xs, Ps = tsm.rts_smooth(torch.from_numpy(x0), pv.P0("cpu"),
                            torch.from_numpy(zs), torch.from_numpy(mask),
                            PERIOD, em_iters=em_iters, em_mode=em_mode)
    tol = TOL_EM if em_iters else TOL_RTS
    assert xs.shape == (14, 4) and Ps.shape == (14, 4, 4)
    np.testing.assert_allclose(xs.numpy(), np.asarray(want_x), **tol)
    np.testing.assert_allclose(Ps.numpy(), np.asarray(want_P), **tol)
    assert np.isfinite(xs.numpy()).all()


def test_rts_smooth_takes_noise_scales():
    x0, zs, mask = seeded_track(4, 9)
    kw = dict(sigma_q=2.0, sigma_r=0.5)
    want_x, _ = jsm.rts_smooth(jnp.asarray(x0), jpv.P0, jnp.asarray(zs),
                               jnp.asarray(mask), PERIOD, **kw)
    xs, _ = tsm.rts_smooth(torch.from_numpy(x0), pv.P0("cpu"),
                           torch.from_numpy(zs), torch.from_numpy(mask),
                           PERIOD, **kw)
    np.testing.assert_allclose(xs.numpy(), np.asarray(want_x), **TOL_RTS)
    plain, _ = tsm.rts_smooth(torch.from_numpy(x0), pv.P0("cpu"),
                              torch.from_numpy(zs), torch.from_numpy(mask),
                              PERIOD)
    assert not np.allclose(plain.numpy(), xs.numpy(), atol=1e-3)


def padded_batch():
    """Five tracks of 5 to 16 steps, padded to 16 with masked steps."""
    lengths = [16, 5, 11, 8, 13]
    B, N = len(lengths), 16
    x0 = np.zeros((B, 4), np.float32)
    zs = np.zeros((B, N, 2), np.float32)
    mask = np.zeros((B, N), bool)
    for i, n in enumerate(lengths):
        x0[i], zs[i, :n], mask[i, :n] = seeded_track(10 + i, n)
    return lengths, x0, zs, mask


@pytest.mark.parametrize("em_iters,em_mode", MODES)
def test_smooth_tracks_padded_batch_matches_jax(em_iters, em_mode):
    """With ``em_iters`` > 0 the JAX function lets the padded transitions
    of a shorter track into its Q statistics; the port computes the same,
    so the two agree on padded batches as well."""
    lengths, x0, zs, mask = padded_batch()
    B = len(lengths)
    P0 = np.broadcast_to(np.asarray(jpv.P0), (B, 4, 4)).copy()
    want_x, want_P = jax.jit(
        lambda a, b, c, d: jsm.smooth_tracks(a, b, c, d, PERIOD,
                                             em_iters=em_iters,
                                             em_mode=em_mode))(
        jnp.asarray(x0), jnp.asarray(P0), jnp.asarray(zs), jnp.asarray(mask))
    xs, Ps = tsm.smooth_tracks(
        torch.from_numpy(x0), torch.from_numpy(P0), torch.from_numpy(zs),
        torch.from_numpy(mask), PERIOD, em_iters=em_iters, em_mode=em_mode)
    tol = TOL_EM if em_iters else TOL_RTS
    for i, n in enumerate(lengths):
        np.testing.assert_allclose(xs[i, :n].numpy(),
                                   np.asarray(want_x)[i, :n],
                                   err_msg=f"track {i}", **tol)
        np.testing.assert_allclose(Ps[i, :n].numpy(),
                                   np.asarray(want_P)[i, :n],
                                   err_msg=f"track {i}", **tol)
    if em_iters == 0:
        # pure RTS: the padded tail does not perturb the interior
        for i, n in enumerate(lengths):
            alone, _ = tsm.rts_smooth(
                torch.from_numpy(x0[i]), pv.P0("cpu"),
                torch.from_numpy(zs[i, :n]), torch.from_numpy(mask[i, :n]),
                PERIOD)
            np.testing.assert_allclose(xs[i, :n].numpy(), alone.numpy(),
                                       **TOL_RTS)


@pytest.mark.parametrize("em_iters,em_mode", [(0, 'scalar'), (5, 'full')])
def test_get_smooth_tracks_matches_jax_tracker(em_iters, em_mode):
    params, jparams, scans, seeds = cluttered_scene()
    shapes = dict(max_targets=8, max_leaves=16, max_meas=16, max_ais=4,
                  window=7, max_prelim=8, max_initiators=16)
    jt = JTracker(JShapes(**shapes), jparams, method='lagrangian',
                  use_ais=False)
    tt = Tracker(TrackerShapes(**shapes), params, method='lagrangian',
                 use_ais=False, device='cpu')
    for tr in (jt, tt):
        tr.pre_initialize(scans[0].time - params.radar_period, seeds)
        for s in scans:
            tr.add_measurement_list(s.time, s.measurements)
    assert [len(z) for z in tt.scan_history] == \
        [len(s.measurements) for s in scans]
    want = jt.get_smooth_tracks(em_iters=em_iters, em_mode=em_mode,
                                include_terminated=True)
    got = tt.getSmoothTracks(em_iters=em_iters, em_mode=em_mode,
                             include_terminated=True)
    assert sorted(got) == sorted(want) and len(got) >= 5
    tol = TOL_EM if em_iters else TOL_RTS
    n_ok = 0
    for tid, (pos_j, vel_j, ok_j) in want.items():
        pos, vel, ok = got[tid]
        assert ok == ok_j and pos.shape == pos_j.shape
        np.testing.assert_allclose(pos, pos_j, err_msg=str(tid), **tol)
        np.testing.assert_allclose(vel, vel_j, err_msg=str(tid), **tol)
        n_ok += bool(ok)
    assert n_ok >= 5

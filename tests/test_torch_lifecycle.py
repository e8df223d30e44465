"""N-scan pruning and termination of the port against the JAX package,
on selected forests from a tracker run (exact for labels and masks,
rtol 1e-6 for copied floats)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from pymht_tpu.core import lifecycle as jlife, select as jsel  # noqa: E402
from pymht_tpu.core.config import TrackerShapes, TrackerParams  # noqa: E402
from pymht_tpu.core.grow import Scan as JScan, grow as jgrow  # noqa: E402
from pymht_tpu.core.tracker import Tracker as JTracker  # noqa: E402
from pymht_tpu.utils import simulator as sim  # noqa: E402
from pymht_tpu_torch.core import config as tconfig  # noqa: E402
from pymht_tpu_torch.core import lifecycle as tlife  # noqa: E402
from pymht_tpu_torch.core.state import state_from_numpy  # noqa: E402

def port(cfg):
    """The port's own TrackerShapes/TrackerParams, built from the numbers
    of the JAX package's: each side is given its own classes."""
    cls = getattr(tconfig, type(cfg).__name__)
    return cls(**{f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cls)})


SHAPES = TrackerShapes(max_targets=10, max_leaves=16, max_meas=32,
                       max_ais=2, window=4, max_prelim=8, max_initiators=32)


def _selected_forests(params):
    """Post-grow, post-select JAX states (sel_leaf written) of scans
    1..6 of a six-target scene in clutter."""
    period = params.radar_period
    rng = np.random.default_rng(2)
    targets = sim.generate_initial_targets(rng, 6, (0.0, 0.0), 120.0, 0.9,
                                           0.1)
    sim_list = sim.simulate_targets(rng, targets, sim_time=6 * period,
                                    dt=period)
    scans = sim.simulate_scans(rng, sim_list, period, sigma_R=2.5,
                               lambda_phi=3e-5, radar_range=200.0,
                               p0=(0.0, 0.0), lambda_local=1.0)
    F_inv = np.eye(4)
    F_inv[0, 2] = F_inv[1, 3] = -period
    tr = JTracker(SHAPES, params, method='lagrangian', use_ais=False)
    tr.pre_initialize(scans[0].time - period, [F_inv @ t.state
                                               for t in targets])

    @jax.jit
    def grow_select(st, sc):
        st = jgrow(st, sc, None, SHAPES, params).state
        res = jsel.select(st, SHAPES, params, method='lagrangian')
        return st.replace(sel_leaf=res.sel, lam=res.lam)

    M = SHAPES.max_meas
    out = []
    for i, s in enumerate(scans):
        n = min(len(s.measurements), M)
        z = np.zeros((M, 2), np.float32)
        z[:n] = s.measurements[:n]
        scan = JScan(z=jnp.asarray(z), mask=jnp.asarray(np.arange(M) < n),
                     time=jnp.asarray(float(s.time) - tr.t0, jnp.float32))
        if i >= 1:
            out.append(grow_select(tr.state, scan))
        tr.add_measurement_list(s.time, s.measurements)
    return out


def _assert_state(got, want):
    for f in dataclasses.fields(want):
        w = np.asarray(getattr(want, f.name))
        g = getattr(got, f.name).numpy()
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f.name)


FOREST_PARAMS = TrackerParams(radar_period=2.5, P_d=0.9, lambda_phi=3e-5,
                              lambda_nu=1e-5, N=2, radar_range=200.0)


@pytest.fixture(scope="module")
def forests():
    return _selected_forests(FOREST_PARAMS)


# Each case's limits make tracks die for the stated reason (1 range,
# 2 windowed score, 3 cumulative NLLR); the first keeps the defaults.
INF = float("inf")


@pytest.mark.parametrize("kw,reason", [
    (dict(), None),
    (dict(radar_range=60.0), 1),
    (dict(radar_range=INF, score_upper_limit_scale=-5.0), 2),
    (dict(radar_range=INF, cnllr_upper_limit=-1000.0), 3),
])
def test_prune_and_terminate_match_jax(forests, kw, reason):
    params = dataclasses.replace(FOREST_PARAMS, **kw)
    n_dead = n_cut = 0
    reasons = set()
    for jst in forests:
        tst = state_from_numpy({f.name: np.asarray(getattr(jst, f.name))
                                for f in dataclasses.fields(jst)}, "cpu")
        term_j = jax.device_get(jlife.terminate(jst, SHAPES, params))
        term_t = tlife.terminate(tst, port(SHAPES), port(params))
        np.testing.assert_array_equal(term_t.dead.numpy(), term_j.dead)
        np.testing.assert_array_equal(term_t.reason.numpy(), term_j.reason)
        _assert_state(term_t.state, term_j.state)
        n_dead += int(term_j.dead.sum())
        reasons |= set(np.asarray(term_j.reason)[term_j.dead].tolist())

        pr_j = jax.device_get(jlife.n_scan_prune(term_j.state, SHAPES,
                                                 params))
        pr_t = tlife.n_scan_prune(term_t.state, port(SHAPES), port(params))
        _assert_state(pr_t.state, pr_j.state)
        for name in pr_j._fields[1:]:
            np.testing.assert_array_equal(getattr(pr_t, name).numpy(),
                                          np.asarray(getattr(pr_j, name)),
                                          err_msg=name)
        n_cut += int(np.asarray(pr_j.confirmed_mask).sum())
    if reason is None:
        assert n_cut > 0                              # pruning happened
    else:
        assert n_dead > 0 and reason in reasons

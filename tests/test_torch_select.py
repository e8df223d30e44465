"""Global hypothesis selection of the port against JAX select on forests
with crossing targets, grown scan by scan (8 targets converging on one
point in clutter: clusters of 1, 2, 4, 5 and 7 targets, conflicts in
most scans).

Required per scan: the same ``sel``, or else an objective equal within
1e-5 relative with both selections feasible; and a gap <= 1e-3 against
the exact MILP oracle (utils.oracle) on the port's selection.  Where the
port's ``'lagrangian'`` runs its exact finish, which JAX's select lacks,
the selection is held to the oracle and to JAX's as no worse.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from pymht_tpu.core import select as jsel  # noqa: E402
from pymht_tpu.core.config import TrackerShapes, TrackerParams  # noqa: E402
from pymht_tpu.core.grow import Scan as JScan, grow as jgrow  # noqa: E402
from pymht_tpu.core.state import TrackerState as JState  # noqa: E402
from pymht_tpu.core.tracker import Tracker as JTracker  # noqa: E402
from pymht_tpu.utils import simulator as sim  # noqa: E402
from pymht_tpu.utils.oracle import selection_gap  # noqa: E402
from pymht_tpu_torch.core import config as tconfig  # noqa: E402
from pymht_tpu_torch.core import select as tsel  # noqa: E402
from pymht_tpu_torch.core.state import (  # noqa: E402
    state_from_numpy, state_to_numpy)
from pymht_tpu_torch.utils import timing  # noqa: E402
from pymht_tpu_torch.utils.oracle import milp_select_oracle  # noqa: E402


def port(cfg):
    """The port's own TrackerShapes/TrackerParams, built from the numbers
    of the JAX package's: each side is given its own classes."""
    cls = getattr(tconfig, type(cfg).__name__)
    return cls(**{f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cls) if hasattr(cfg, f.name)})


SHAPES = TrackerShapes(max_targets=12, max_leaves=16, max_meas=48,
                       max_ais=2, window=5, max_prelim=8, max_initiators=48)
PARAMS = TrackerParams(radar_period=2.5, P_d=0.9, lambda_phi=4e-5,
                       lambda_nu=1e-5, N=3, radar_range=400.0)
TSHAPES, TPARAMS = port(SHAPES), port(PARAMS)


def _np_fields(st):
    return {f.name: np.asarray(getattr(st, f.name))
            for f in dataclasses.fields(st)}


@pytest.fixture(scope="module")
def forests():
    """Post-grow JAX states of scans 1..8 (before selection)."""
    period = PARAMS.radar_period
    ang = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    tgts = [sim.SimTarget(state=np.array([60 * np.cos(a), 60 * np.sin(a),
                                          -6 * np.cos(a), -6 * np.sin(a)]),
                          time=0.0, P_d=0.9, sigma_Q=0.5) for a in ang]
    rng = np.random.default_rng(5)
    sim_list = sim.simulate_targets(rng, tgts, sim_time=8 * period,
                                    dt=period)
    scans = sim.simulate_scans(rng, sim_list, period, sigma_R=2.5,
                               lambda_phi=4e-5, radar_range=400.0,
                               p0=(0.0, 0.0), lambda_local=1.0)
    F_inv = np.eye(4)
    F_inv[0, 2] = F_inv[1, 3] = -period
    tr = JTracker(SHAPES, PARAMS, method='lagrangian', use_ais=False)
    tr.pre_initialize(scans[0].time - period, [F_inv @ t.state
                                               for t in tgts])
    M = SHAPES.max_meas
    grow_j = jax.jit(lambda st, sc: jgrow(st, sc, None, SHAPES, PARAMS))
    out = []
    for i, s in enumerate(scans):
        n = min(len(s.measurements), M)
        z = np.zeros((M, 2), np.float32)
        z[:n] = s.measurements[:n]
        scan = JScan(z=jnp.asarray(z), mask=jnp.asarray(np.arange(M) < n),
                     time=jnp.asarray(float(s.time) - tr.t0, jnp.float32))
        if i >= 1:
            out.append(grow_j(tr.state, scan).state)
        tr.add_measurement_list(s.time, s.measurements)
    return out


def _check_same(res_t, res_j, f):
    sel_t, sel_j = res_t.sel.numpy(), np.asarray(res_j.sel)
    assert bool(res_t.feasible) == bool(res_j.feasible)
    if not np.array_equal(sel_t, sel_j):
        assert bool(res_t.feasible) and bool(res_j.feasible)
        np.testing.assert_allclose(float(res_t.obj), float(res_j.obj),
                                   rtol=1e-5)
    np.testing.assert_allclose(float(res_t.obj), float(res_j.obj),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(res_t.bound), float(res_j.bound),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(res_t.labels.numpy(),
                                  np.asarray(res_j.labels))
    assert int(res_t.n_clusters) == int(res_j.n_clusters)
    np.testing.assert_allclose(res_t.lam.numpy(), np.asarray(res_j.lam),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("method,fast_path", [("lagrangian", True),
                                              ("lagrangian", False),
                                              ("greedy", True)])
def test_select_matches_jax(forests, method, fast_path):
    """The port's select against JAX's on each forest.  Where the port's
    ``'lagrangian'`` enters its exact finish (JAX's select has none and
    may stop with its certificate open), the selection is held to the
    HiGHS oracle instead: within 1e-3 of the optimum, never worse than
    JAX's, with a sound bound no looser than JAX's; its clusters and
    duals are still JAX's."""
    sel_j = jax.jit(lambda st: jsel.select(st, SHAPES, PARAMS, method=method,
                                           fast_path=fast_path))
    n_conflicted = 0
    for jst in forests:
        res_j = jax.device_get(sel_j(jst))
        tst = state_from_numpy(_np_fields(jst), "cpu")
        c0 = timing.counters()["finish_entered"]
        res_t = tsel.select(tst, TSHAPES, TPARAMS, method=method,
                            fast_path=fast_path)
        if timing.counters()["finish_entered"] == c0:
            _check_same(res_t, res_j, tsel.leaf_scores(tst, TPARAMS))
        else:
            _check_finished(res_t, res_j, tst)
        n_conflicted += not bool(tsel._independent_best(
            tst, TSHAPES, TPARAMS)[2])
    assert n_conflicted >= 4           # the scene exercises the solver


def _check_finished(res_t, res_j, tst):
    """A selection through the exact finish, against the oracle and JAX."""
    _, opt, proven = milp_select_oracle(tst, TSHAPES, TPARAMS)
    obj, bound = float(res_t.obj), float(res_t.bound)
    scale = max(1.0, abs(opt))
    assert proven and bool(res_t.feasible)
    assert obj - opt <= 1e-3 * scale and bound <= opt + 1e-5 * scale
    assert obj <= float(res_j.obj) + 1e-5 * scale
    assert bound >= float(res_j.bound) - 1e-5 * scale
    np.testing.assert_array_equal(res_t.labels.numpy(),
                                  np.asarray(res_j.labels))
    assert int(res_t.n_clusters) == int(res_j.n_clusters)
    np.testing.assert_allclose(res_t.lam.numpy(), np.asarray(res_j.lam),
                               rtol=1e-4, atol=1e-5)


def test_selection_gap_vs_exact_oracle(forests):
    """The port's selection, written into its state and converted back
    to a JAX state, is within 1e-3 of the MILP optimum."""
    gaps = []
    for jst in forests:
        tst = state_from_numpy(_np_fields(jst), "cpu")
        res = tsel.select(tst, TSHAPES, TPARAMS, method='lagrangian')
        assert bool(res.feasible)
        d = state_to_numpy(tst.replace(sel_leaf=res.sel))
        back = JState(**{k: jnp.asarray(v) for k, v in d.items()})
        gap = selection_gap(back, SHAPES, PARAMS)
        assert gap is not None and gap <= 1e-3, gap
        gaps.append(gap)
    assert len(gaps) == len(forests)


def test_select_refuses_unported_methods(forests):
    """Nothing is left unported: 'ipm' and 'lagrangian_pure' run, and
    only an unknown method is refused."""
    tst = state_from_numpy(_np_fields(forests[2]), "cpu")
    want = tsel.select(tst, TSHAPES, TPARAMS, method='lagrangian')
    for method in ("ipm", "lagrangian_pure"):
        res = tsel.select(tst, TSHAPES, TPARAMS, method=method)
        assert bool(res.feasible)
        assert abs(float(res.obj) - float(want.obj)) \
            <= 1e-3 * (1.0 + abs(float(want.obj)))
    with pytest.raises(ValueError):
        tsel.select(tst, TSHAPES, TPARAMS, method="simplex")


def test_target_usage_matches_jax(forests):
    for jst in forests:
        tst = state_from_numpy(_np_fields(jst), "cpu")
        use_t, n_t = tsel.target_usage(tst, TSHAPES)
        use_j, n_j = jsel.target_usage(jst, SHAPES)
        assert n_t == n_j == SHAPES.window * (SHAPES.max_meas
                                              + SHAPES.max_ais)
        np.testing.assert_array_equal(use_t.numpy(), np.asarray(use_j))


def _compact_inputs(tst):
    """The compact Lagrangian's inputs over every live target of the
    port's forest (the distributed select's tier 3), as torch tensors."""
    tm = tst.tgt_mask
    usage = tsel._hist_usage(tst, TSHAPES)
    Uc, col_slot, col_ok, _, eff_leaf = tsel._contested_leaf_usage(
        tst, TSHAPES, tm, 256, usage)
    lam0 = torch.zeros(Uc.shape[-1])
    return (tsel.leaf_scores(tst, TPARAMS), Uc, lam0, tst.spine_leaf, tm,
            eff_leaf)


@pytest.mark.parametrize("iters", [3, 12])
def test_forced_iterations_match_jax(forests, iters, monkeypatch):
    """``force_iters=True`` runs exactly ``iters`` bodies (no convergence
    or patience exit), as JAX's forced ``cond``; the result equals JAX's
    forced loop on the same inputs.  Without it the production exits
    stop the loop earlier on some forest."""
    bodies, real = [], tsel._lagrangian_step

    def counting(*a, **kw):
        bodies.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tsel, "_lagrangian_step", counting)
    early = 0
    for jst in forests:
        tst = state_from_numpy(_np_fields(jst), "cpu")
        args = _compact_inputs(tst)
        bodies.clear()
        out_t = tsel._compact_lagrangian(*args, 0.0, iters=iters,
                                         force_iters=True)
        assert len(bodies) == iters
        out_j = jsel._compact_lagrangian(
            *(jnp.asarray(a.numpy()) for a in args), 0.0, iters=iters,
            force_iters=True)
        sel_t, feas_t, obj_t, lb_t, lam_t = out_t
        sel_j, feas_j, obj_j, lb_j, lam_j = jax.device_get(out_j)
        assert bool(feas_t) == bool(feas_j)
        if not np.array_equal(sel_t.numpy(), np.asarray(sel_j)):
            assert bool(feas_t)
        np.testing.assert_allclose(float(obj_t), float(obj_j), rtol=1e-4,
                                   atol=1e-3)
        np.testing.assert_allclose(float(lb_t), float(lb_j), rtol=1e-4,
                                   atol=1e-3)
        np.testing.assert_allclose(lam_t.numpy(), np.asarray(lam_j),
                                   rtol=1e-4, atol=1e-3)
        bodies.clear()
        tsel._compact_lagrangian(*args, 0.0, iters=iters)
        early += len(bodies) < iters
    assert early >= 1

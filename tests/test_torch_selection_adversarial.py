"""Adversarial selection instances of tests/test_selection_adversarial.py
on the port's select, each against the JAX select on the same forest.

The four cases: the history depth equal to the window (no phantom
conflicts through empty compact columns), the tier-2 truncation bound
(sound, and flagging its gap), 5-8-target clusters in tier 3 (gap <= 1e-3
against the HiGHS oracle) and the contested-cap overflow with its spine
retreat.  The hand-built forests are built in the JAX package's state and
converted, the dense clusters stepped by the port's Tracker and converted
back; both selects then run on each.  Required: the JAX test's
assertions on the port's result, and the same selection (or, where the
leaves differ, both feasible with equal objectives) as JAX, objectives
and bounds within rtol 1e-4, atol 1e-3.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from pymht_tpu.core import select as jsel  # noqa: E402
from pymht_tpu.core.config import TrackerParams, TrackerShapes  # noqa: E402
from pymht_tpu.core.state import empty_state  # noqa: E402
from pymht_tpu.core.state import TrackerState as JState  # noqa: E402
from pymht_tpu_torch import Tracker as TTracker  # noqa: E402
from pymht_tpu_torch.core import config as tconfig  # noqa: E402
from pymht_tpu_torch.core import select as tsel  # noqa: E402
from pymht_tpu_torch.core.state import (  # noqa: E402
    state_from_numpy, state_to_numpy)
from pymht_tpu_torch.utils import oracle as toracle  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-3)


def port(cfg):
    cls = getattr(tconfig, type(cfg).__name__)
    return cls(**{f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cls)})


def to_port(jst):
    return state_from_numpy({f.name: np.asarray(getattr(jst, f.name))
                             for f in dataclasses.fields(jst)}, "cpu")


def _forest(shapes, params, hist_meas, cnllr, spine):
    """A JAX TrackerState whose forest is given explicitly
    (tests/test_selection_adversarial.py's builder)."""
    st = empty_state(shapes, params)
    Ta, La, W = np.asarray(hist_meas).shape
    T, L = shapes.max_targets, shapes.max_leaves
    hm = np.full((T, L, W), -1, np.int32)
    hm[:Ta, :La] = hist_meas
    cn = np.asarray(cnllr, np.float32)
    lm = np.zeros((T, L), bool)
    lm[:Ta, :La] = np.isfinite(cn)
    cnp = np.zeros((T, L), np.float32)
    cnp[:Ta, :La] = np.where(np.isfinite(cn), cn, 0.0)
    tm = np.zeros((T,), bool)
    tm[:Ta] = True
    sp = np.zeros((T,), np.int32)
    sp[:Ta] = spine
    depth = np.count_nonzero(hm[:, 0] >= 0, axis=1).astype(np.int32)
    return st.replace(
        hist_meas=jnp.asarray(hm), leaf_cnllr=jnp.asarray(cnp),
        leaf_mask=jnp.asarray(lm), tgt_mask=jnp.asarray(tm),
        spine_leaf=jnp.asarray(sp), tgt_depth=jnp.asarray(depth),
        sel_leaf=jnp.asarray(sp))


def _both(jst, shapes, params, **kw):
    """(port result, JAX result) of select_hybrid on the same forest, held
    to each other.  The JAX select is jitted (eagerly it compiles op by
    op, several seconds a call)."""
    res_j = jax.device_get(jax.jit(lambda st: jsel.select_hybrid(
        st, shapes, params, **kw))(jst))
    res_t = tsel.select_hybrid(to_port(jst), port(shapes), port(params),
                               **kw)
    assert bool(res_t.feasible) == bool(res_j.feasible)
    if not np.array_equal(res_t.sel.numpy(), np.asarray(res_j.sel)):
        assert bool(res_t.feasible) and bool(res_j.feasible)
    np.testing.assert_allclose(float(res_t.obj), float(res_j.obj), **TOL)
    np.testing.assert_allclose(float(res_t.bound), float(res_j.bound), **TOL)
    return res_t, res_j


def test_depth_equals_window_no_phantom_conflicts():
    shapes = TrackerShapes(max_targets=8, max_leaves=4, max_meas=16,
                           max_ais=2, window=6, max_prelim=4,
                           max_initiators=8)
    params = TrackerParams(radar_period=1.0, N=5)
    n, N = 5, params.N
    hist, cnllr = [], []
    for t in range(n):
        d = t + 2
        hist.append([[d] * 5 + [1], [0] + [d] * 4 + [0], [-1] * 6, [-1] * 6])
        cnllr.append([1.0 * N, 2.0 * N, np.inf, np.inf])
    jst = _forest(shapes, params, np.asarray(hist), np.asarray(cnllr),
                  spine=np.ones(n, np.int32))
    res, _ = _both(jst, shapes, params)
    tst = to_port(jst)
    _, obj_o, optimal = toracle.milp_select_oracle(tst, port(shapes),
                                                   port(params))
    assert optimal and np.isclose(obj_o, 9.0, atol=1e-5)
    assert bool(res.feasible)
    assert np.isclose(float(res.obj), obj_o, atol=1e-3)
    assert float(res.bound) <= obj_o + 1e-3
    lm = tst.leaf_mask.numpy()
    assert all(lm[t, int(res.sel[t])] for t in range(n))


def test_tier2_truncation_bound_stays_sound():
    shapes = TrackerShapes(max_targets=4, max_leaves=4, max_meas=16,
                           max_ais=2, window=6, max_prelim=4,
                           max_initiators=8)
    params = TrackerParams(radar_period=1.0, N=5)
    N = params.N
    pad = [-1] * 4
    hist = [[pad + [2, 1], pad + [3, 1], pad + [4, 2], pad + [5, 0]],
            [pad + [6, 1], pad + [7, 0], [-1] * 6, [-1] * 6]]
    cnllr = [[1.0 * N, 1.1 * N, 3.0 * N, 5.0 * N],
             [1.0 * N, 4.0 * N, np.inf, np.inf]]
    jst = _forest(shapes, params, np.asarray(hist), np.asarray(cnllr),
                  spine=np.asarray([3, 1], np.int32))
    res, _ = _both(jst, shapes, params, enum_cands=2)
    _, obj_o, optimal = toracle.milp_select_oracle(
        to_port(jst), port(shapes), port(params))
    assert optimal and np.isclose(obj_o, 4.0, atol=1e-5)
    assert np.isclose(float(res.obj), 5.0, atol=1e-4)
    assert bool(res.feasible)
    assert float(res.bound) <= obj_o + 1e-5
    assert float(res.obj) - float(res.bound) > 0.5
    res_full, _ = _both(jst, shapes, params)
    assert np.isclose(float(res_full.obj), obj_o, atol=1e-4)


SHAPES_BIG = TrackerShapes(max_targets=16, max_leaves=16, max_meas=32,
                           max_ais=2, window=6, max_prelim=8,
                           max_initiators=32)
PARAMS_BIG = TrackerParams(radar_period=1.0, P_d=0.9, lambda_phi=1e-5,
                           lambda_nu=1e-5, radar_range=500.0)


def _dense_cluster_scans(n_targets, n_scans=8, seed=11, spacing=6.0):
    rng = np.random.default_rng(seed)
    base = np.array([[0.0, spacing * i, 3.0, 0.0] for i in range(n_targets)])
    scans = []
    for k in range(n_scans):
        t = (k + 1) * 1.0
        zs = [b[:2] + b[2:] * t + rng.normal(0, 1.2, 2) for b in base]
        for i in range(n_targets - 1):
            zs.append(base[i][:2] + base[i][2:] * t
                      + np.array([0.0, spacing / 2]) + rng.normal(0, 1.0, 2))
        scans.append((t, np.stack(zs)))
    return base, scans


@pytest.fixture(scope="module")
def dense_cluster():
    """The forest (a JAX state) after the dense-cluster scans, stepped by
    the port's Tracker on the CPU, one per (targets, scans)."""
    made = {}

    def get(n_targets, n_scans=8):
        if (n_targets, n_scans) not in made:
            base, scans = _dense_cluster_scans(n_targets, n_scans)
            tr = TTracker(port(SHAPES_BIG), port(PARAMS_BIG),
                          method="lagrangian", use_ais=False, device="cpu")
            tr.pre_initialize(0.0, base)
            for t, z in scans:
                tr.add_measurement_list(t, z)
            made[n_targets, n_scans] = JState(**{
                k: jnp.asarray(v)
                for k, v in state_to_numpy(tr.state).items()})
        return made[n_targets, n_scans]

    return get


@pytest.mark.parametrize("n_targets", [5, 6, 8])
def test_tier3_cluster_gap_vs_oracle(dense_cluster, n_targets):
    assert n_targets > tsel.K_ENUM
    jst = dense_cluster(n_targets)
    tst = to_port(jst)
    labels, _ = tsel.cluster(tst, port(SHAPES_BIG))
    csize = tsel.cluster_sizes(labels, tst.tgt_mask).numpy()
    assert csize[tst.tgt_mask.numpy()].max() > tsel.K_ENUM
    res, _ = _both(jst, SHAPES_BIG, PARAMS_BIG)
    assert bool(res.feasible)
    gap = toracle.selection_gap(tst.replace(sel_leaf=res.sel),
                                port(SHAPES_BIG), port(PARAMS_BIG))
    assert gap is not None and gap < 1e-3, gap


def test_contested_overflow_spine_retreat(dense_cluster):
    jst = dense_cluster(8, n_scans=6)
    res_small, _ = _both(jst, SHAPES_BIG, PARAMS_BIG, contested_cap=2)
    assert bool(res_small.feasible)
    res_full, _ = _both(jst, SHAPES_BIG, PARAMS_BIG)
    assert bool(res_full.feasible)
    assert float(res_full.obj) <= float(res_small.obj) + 1e-4
    lm = np.asarray(jst.leaf_mask)
    for t in np.nonzero(np.asarray(jst.tgt_mask))[0]:
        assert lm[t, int(res_small.sel[t])]

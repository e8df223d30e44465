"""Selection and lifecycle of the port on forests whose label history
holds AIS associations (``hist_ais``, ``hist_mmsi``, the ``M + max_ais``
slot columns), against the JAX package.

Scene: two pairs of ships sailing 5 m apart, none with a known MMSI, so
each AIS message gates both ships of a pair and the selection has to
settle who takes it (a conflict on an AIS slot), plus a lone ship; radar
returns with clutter.  Forests are grown scan by scan by the JAX package.

Required per scan: the same ``sel`` (or an equal objective, both
feasible), objective and bound within 1e-5; terminate and N-scan prune
identical on labels, masks and MMSIs.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from pymht_tpu.core import lifecycle as jlife, select as jsel  # noqa: E402
from pymht_tpu.core.config import TrackerShapes, TrackerParams  # noqa: E402
from pymht_tpu.core.grow import grow as jgrow  # noqa: E402
from pymht_tpu.core.tracker import Tracker as JTracker  # noqa: E402
from pymht_tpu.utils.ref_oracle import AisMsg  # noqa: E402
from pymht_tpu_torch.core import config as tconfig  # noqa: E402
from pymht_tpu_torch.core import lifecycle as tlife  # noqa: E402
from pymht_tpu_torch.core import select as tsel  # noqa: E402
from pymht_tpu_torch.core.state import state_from_numpy  # noqa: E402

SHAPES = TrackerShapes(max_targets=6, max_leaves=16, max_meas=12, max_ais=4,
                       window=5, max_prelim=8, max_initiators=12,
                       ais_per_leaf=2)
PARAMS = TrackerParams(radar_period=2.5, P_d=0.9, lambda_phi=1e-5,
                       lambda_nu=1e-6, N=3, radar_range=1e4,
                       cnllr_upper_limit=1e9, score_upper_limit_scale=1e6)


def port(cfg):
    cls = getattr(tconfig, type(cfg).__name__)
    return cls(**{f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cls)})


def to_port(jstate):
    return state_from_numpy({f.name: np.asarray(getattr(jstate, f.name))
                             for f in dataclasses.fields(jstate)}, "cpu")


@pytest.fixture(scope="module")
def forests():
    """Post-grow JAX states of scans 1..6 (before selection)."""
    period = PARAMS.radar_period
    rng = np.random.default_rng(12)
    xs = [np.array([0.0, 0.0, 5.0, 0.0]), np.array([0.0, 5.0, 5.0, 0.0]),
          np.array([200.0, 100.0, -4.0, 2.0]),
          np.array([203.0, 104.0, -4.0, 2.0]),
          np.array([-150.0, -80.0, 0.0, 6.0])]
    F = np.eye(4)
    F[0, 2] = F[1, 3] = period
    tr = JTracker(SHAPES, PARAMS, method='lagrangian', use_ais=True,
                  ais_initialization=False)
    tr.pre_initialize(0.0, xs)
    grow_j = jax.jit(lambda st, sc, ab: jgrow(st, sc, ab, SHAPES, PARAMS))
    M = SHAPES.max_meas
    out = []
    for i in range(7):
        t = (i + 1) * period
        Fa = np.eye(4)
        Fa[0, 2] = Fa[1, 3] = period * 0.6
        # one message per pair per scan, from one of its two ships, and
        # one from the lone ship; the tracks start without an MMSI
        msgs = [AisMsg(state=Fa @ xs[k] + rng.normal(0, 1.0, 4) * [1, 1, .1, .1],
                       time=t - period * 0.4, mmsi=300000001 + k,
                       high_accuracy=bool(k % 2))
                for k in (int(rng.integers(0, 2)), 2 + int(rng.integers(0, 2)),
                          4)]
        xs = [F @ x for x in xs]
        z = np.stack([x[:2] + rng.normal(0, 1.5, 2) for x in xs
                      if rng.random() < 0.9]
                     + [rng.uniform(-200, 250, 2) for _ in range(3)])
        if i >= 1:
            packed = np.asarray(tr._pad_scan(t - tr.t0, z))
            from pymht_tpu.core.grow import Scan as JScan
            scan = JScan(z=jnp.asarray(packed[:M]),
                         mask=jnp.arange(M) < int(packed[M, 0]),
                         time=jnp.asarray(packed[M, 1]))
            out.append(grow_j(tr.state, scan, tr._pad_ais(msgs)).state)
        tr.add_measurement_list(t, z.astype(np.float32), ais_messages=msgs)
    return out


def test_forests_hold_ais_conflicts(forests):
    """The scene does what it is for: leaves of different targets claim
    the same AIS message in the same column."""
    shared = 0
    for jst in forests:
        a = np.where(np.asarray(jst.leaf_mask),
                     np.asarray(jst.hist_ais)[:, :, -1], 0)     # [T, L]
        per_target = [set(row[row > 0].tolist()) for row in a]
        shared += sum(bool(per_target[i] & per_target[j])
                      for i in range(len(per_target))
                      for j in range(i + 1, len(per_target)))
    assert max(int(np.asarray(jst.hist_mmsi).max())
               for jst in forests) > 300000000
    assert shared >= 4


@pytest.mark.parametrize("method,fast_path", [("lagrangian", True),
                                              ("lagrangian", False),
                                              ("greedy", True)])
def test_select_with_ais_labels_matches_jax(forests, method, fast_path):
    sel_j = jax.jit(lambda st: jsel.select(st, SHAPES, PARAMS, method=method,
                                           fast_path=fast_path))
    n_conflicted = n_ais = 0
    for jst in forests:
        res_j = jax.device_get(sel_j(jst))
        tst = to_port(jst)
        res_t = tsel.select(tst, port(SHAPES), port(PARAMS), method=method,
                            fast_path=fast_path)
        sel_t, sel_jn = res_t.sel.numpy(), np.asarray(res_j.sel)
        assert bool(res_t.feasible) == bool(res_j.feasible)
        assert bool(res_t.feasible) or method == "greedy"
        if not np.array_equal(sel_t, sel_jn):
            np.testing.assert_allclose(float(res_t.obj), float(res_j.obj),
                                       rtol=1e-5)
        for name in ("obj", "bound"):
            np.testing.assert_allclose(float(getattr(res_t, name)),
                                       float(getattr(res_j, name)),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
        np.testing.assert_array_equal(res_t.labels.numpy(),
                                      np.asarray(res_j.labels))
        assert int(res_t.n_clusters) == int(res_j.n_clusters)
        np.testing.assert_allclose(res_t.lam.numpy(), np.asarray(res_j.lam),
                                   rtol=1e-4, atol=1e-5)
        n_conflicted += not bool(tsel._independent_best(
            tst, port(SHAPES), port(PARAMS))[2])
        live = np.asarray(jst.tgt_mask)
        picked = np.asarray(jst.hist_ais)[np.arange(len(sel_t)), sel_t, -1]
        n_ais += int((picked[live] > 0).sum())
        if bool(res_t.feasible):           # no AIS message is taken twice
            taken = picked[live][picked[live] > 0]
            assert len(set(taken.tolist())) == len(taken)
    assert n_conflicted >= 2 and n_ais >= 6


def test_prune_and_terminate_with_ais_labels_match_jax(forests):
    sel_j = jax.jit(lambda st: jsel.select(st, SHAPES, PARAMS,
                                           method='lagrangian'))
    n_cut_mmsi = 0
    for jst in forests:
        res = sel_j(jst)
        jst = jst.replace(sel_leaf=res.sel, lam=res.lam)
        tst = to_port(jst)
        term_j = jax.device_get(jlife.terminate(jst, SHAPES, PARAMS))
        term_t = tlife.terminate(tst, port(SHAPES), port(PARAMS))
        pr_j = jax.device_get(jlife.n_scan_prune(term_j.state, SHAPES,
                                                 PARAMS))
        pr_t = tlife.n_scan_prune(term_t.state, port(SHAPES), port(PARAMS))
        for f in dataclasses.fields(pr_j.state):
            w = np.asarray(getattr(pr_j.state, f.name))
            g = getattr(pr_t.state, f.name).numpy()
            if w.dtype.kind == "f":
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=0,
                                           err_msg=f.name)
            else:
                np.testing.assert_array_equal(g, w, err_msg=f.name)
        for name in pr_j._fields[1:]:
            np.testing.assert_array_equal(getattr(pr_t, name).numpy(),
                                          np.asarray(getattr(pr_j, name)),
                                          err_msg=name)
        n_cut_mmsi += int((np.asarray(pr_j.confirmed_mmsi)
                           [np.asarray(pr_j.confirmed_mask)] > 0).sum())
        assert pr_t.state.tgt_mmsi.dtype == torch.int32
    assert n_cut_mmsi >= 2          # confirmed columns carried an MMSI

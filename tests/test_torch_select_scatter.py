"""The scatter formulations of the port's select against its dense
formulations and against the JAX package.

Two kinds of forests: seeded random ones (T=8, L=8, W=5, M=12, A=4, dense
random labels with AIS associations, one big cluster, more contested
slots than a small cap) and the grown AIS forests of
tests/test_torch_select_ais.py (small clusters, conflicts on AIS slots).
The port's size switches (``_USAGE_DENSE_LIMIT``, ``_INT32_WALL``) are
module attributes and are forced to 0 here, so shapes this small take
the scatter builds.

Required: every integer and boolean output identical between the two
builds and the JAX function (usage, contestedness, ranks, labels,
selections, feasibility); Uc identical (it holds 0/1 only); objective,
bound and duals within 1e-5 of the JAX package's and identical between
the port's two builds (they run the same arithmetic on identical
tensors).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from pymht_tpu.core import select as jsel  # noqa: E402
from pymht_tpu.core.config import (  # noqa: E402
    TrackerShapes as JShapes, TrackerParams as JParams)
from pymht_tpu.core.state import TrackerState as JState  # noqa: E402
from pymht_tpu_torch.core import select as tsel  # noqa: E402
from pymht_tpu_torch.core.config import (  # noqa: E402
    TrackerShapes, TrackerParams)
from pymht_tpu_torch.core.state import (  # noqa: E402
    empty_state, state_to_numpy)
from tests.test_torch_select_ais import (  # noqa: E402,F401
    PARAMS as AIS_JPARAMS, SHAPES as AIS_JSHAPES, forests, port, to_port)

_SHAPES = dict(max_targets=8, max_leaves=8, max_meas=12, max_ais=4, window=5,
               max_prelim=4, max_initiators=8)
_PARAMS = dict(radar_period=2.5, P_d=0.9, lambda_phi=1e-5, lambda_nu=1e-6,
               N=3, radar_range=1e4)
SHAPES, JSHAPES = TrackerShapes(**_SHAPES), JShapes(**_SHAPES)
PARAMS, JPARAMS = TrackerParams(**_PARAMS), JParams(**_PARAMS)
SEEDS = [0, 1, 2, 3]


def random_forest(seed, n_meas=None, p_miss=0.0, p_ais=0.3):
    """A seeded forest with dense random labels: seven active targets,
    ~80 % live leaves, measurements drawn from ``n_meas`` (default 12)
    values so that most slots are contested, an AIS association on ~30 %
    of the nodes, random warm-start duals.  ``p_miss`` turns that share of
    the labels into missed detections (fewer shared slots, more
    clusters)."""
    T, L, W = SHAPES.max_targets, SHAPES.max_leaves, SHAPES.window
    M, A = SHAPES.max_meas, SHAPES.max_ais
    rng = np.random.default_rng(seed)
    depth = rng.integers(1, W + 1, T)
    cols = np.arange(W)[None, None, :] >= (W - depth)[:, None, None]
    hist_meas = np.where(cols, rng.integers(0, (n_meas or M) + 1, (T, L, W)),
                         -1)
    hist_meas = np.where(cols & (rng.random((T, L, W)) < p_miss), 0,
                         hist_meas)
    hist_ais = np.where(cols & (rng.random((T, L, W)) < p_ais),
                        rng.integers(1, A + 1, (T, L, W)), 0)
    tgt_mask = np.arange(T) < 7
    leaf_mask = (rng.random((T, L)) < 0.8) & tgt_mask[:, None]
    leaf_mask[:7, 0] = True
    st = empty_state(SHAPES, PARAMS, "cpu")
    cn = rng.normal(0, 2, (T, L)).astype(np.float32)

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)

    return st.replace(
        hist_meas=t(hist_meas, torch.int32), hist_ais=t(hist_ais, torch.int32),
        hist_mmsi=t(np.where(hist_ais > 0, 300000000 + hist_ais, 0),
                    torch.int32),
        leaf_mask=t(leaf_mask, torch.bool), leaf_cnllr=t(cn, torch.float32),
        tgt_mask=t(tgt_mask, torch.bool), tgt_depth=t(depth, torch.int32),
        tgt_id=t(np.where(tgt_mask, np.arange(T), -1), torch.int32),
        spine_leaf=t(rng.integers(0, L, T), torch.int32),
        lam=t(rng.uniform(0, 0.1, st.lam.shape[0]), torch.float32))


def to_jax(tst):
    return JState(**{k: jnp.asarray(v)
                     for k, v in state_to_numpy(tst).items()})


@pytest.fixture
def scatter(monkeypatch):
    """Force the port's scatter builds at any size."""
    def force():
        monkeypatch.setattr(tsel, "_USAGE_DENSE_LIMIT", 0)
        monkeypatch.setattr(tsel, "_INT32_WALL", 0)
    return force


def big_filter(seed):
    return np.random.default_rng(100 + seed).random(SHAPES.max_targets) < 0.6


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("filtered", [False, True])
def test_hist_usage_builds_agree(seed, filtered, monkeypatch):
    tst = random_forest(seed)
    filt = big_filter(seed) if filtered else None
    tf = None if filt is None else torch.from_numpy(filt)
    dense = tsel._hist_usage(tst, SHAPES, tf)
    want = np.asarray(jsel._hist_usage(
        to_jax(tst), JSHAPES, None if filt is None else jnp.asarray(filt)))
    monkeypatch.setattr(tsel, "_USAGE_DENSE_LIMIT", 0)
    monkeypatch.setattr(jsel, "_USAGE_DENSE_LIMIT", 0)
    scat = tsel._hist_usage(tst, SHAPES, tf)
    want_scat = np.asarray(jsel._hist_usage(
        to_jax(tst), JSHAPES, None if filt is None else jnp.asarray(filt)))
    assert dense.dtype == scat.dtype == torch.bool
    assert dense.any() and not dense.all()
    np.testing.assert_array_equal(dense.numpy(), want)
    np.testing.assert_array_equal(scat.numpy(), want)
    np.testing.assert_array_equal(want_scat, want)


def test_selection_feasible_builds_agree(monkeypatch):
    seen = set()
    for seed in range(12):
        # few distinct measurements: conflicts; many: mostly feasible
        tst = random_forest(seed, n_meas=2 if seed % 2 else None)
        tst = tst.replace(hist_ais=torch.zeros_like(tst.hist_ais)
                          if seed % 4 < 2 else tst.hist_ais)
        rng = np.random.default_rng(seed)
        sel = torch.from_numpy(rng.integers(0, SHAPES.max_leaves,
                                            SHAPES.max_targets))
        if seed >= 8:      # one target per measurement: feasible
            hm = tst.hist_meas.clone()
            hm[:] = torch.arange(1, 9, dtype=torch.int32)[:, None, None]
            tst = tst.replace(hist_meas=hm,
                              hist_ais=torch.zeros_like(tst.hist_ais))
        dense = bool(tsel._selection_feasible(tst, SHAPES, sel))
        want = bool(jsel._selection_feasible(to_jax(tst), JSHAPES,
                                             jnp.asarray(sel.numpy())))
        with monkeypatch.context() as m:
            m.setattr(tsel, "_USAGE_DENSE_LIMIT", 0)
            m.setattr(jsel, "_USAGE_DENSE_LIMIT", 0)
            scat = bool(tsel._selection_feasible(tst, SHAPES, sel))
            want_scat = bool(jsel._selection_feasible(
                to_jax(tst), JSHAPES, jnp.asarray(sel.numpy())))
        assert dense == scat == want == want_scat, seed
        seen.add(dense)
    assert seen == {True, False}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("filtered", [False, True])
def test_contested_minmax_matches_dense_counts_and_jax(seed, filtered):
    tst = random_forest(seed)
    filt = big_filter(seed) if filtered else None
    tf = None if filt is None else torch.from_numpy(filt)
    cont, used = tsel._contested_minmax(tst, SHAPES, tf)
    usage = tsel._hist_usage(tst, SHAPES, tf).reshape(SHAPES.max_targets, -1)
    np.testing.assert_array_equal(cont.numpy(),
                                  (usage.sum(dim=0) >= 2).numpy())
    np.testing.assert_array_equal(used.numpy(), usage.any(dim=0).numpy())
    cj, uj = jsel._contested_minmax(
        to_jax(tst), JSHAPES, None if filt is None else jnp.asarray(filt))
    np.testing.assert_array_equal(cont.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(used.numpy(), np.asarray(uj))
    assert cont.any() and not used.all()


@pytest.mark.parametrize("cap", [3, 256])
@pytest.mark.parametrize("seed", SEEDS[:2])
def test_compact_rank_and_usage_match_jax(seed, cap):
    """``cap=3`` is below the contested count: the slots beyond it go to
    the dump column."""
    tst = random_forest(seed)
    jst = to_jax(tst)
    cont, _ = tsel._contested_minmax(tst, SHAPES)
    assert int(cont.sum()) > 3
    rank = tsel._compact_rank(cont, cap)
    rank_j = jsel._compact_rank(jnp.asarray(cont.numpy()), cap)
    np.testing.assert_array_equal(rank.numpy(), np.asarray(rank_j))
    assert rank.shape == (cont.shape[0] + 1,) and int(rank[-1]) == cap
    for filt in (None, big_filter(seed)):
        tf = None if filt is None else torch.from_numpy(filt)
        uc = tsel._compact_usage(tst, SHAPES, rank, cap, tf)
        uc_j = jsel._compact_usage(
            jst, JSHAPES, rank_j, cap,
            None if filt is None else jnp.asarray(filt))
        np.testing.assert_array_equal(uc.numpy(), np.asarray(uc_j))
        # the dense way: the usage matrix's first ``cap`` contested columns
        usage = tsel._hist_usage(tst, SHAPES, tf).reshape(
            SHAPES.max_targets, -1)
        cols = torch.nonzero(cont)[:cap, 0]
        np.testing.assert_array_equal(uc[:, :len(cols)].numpy(),
                                      usage[:, cols].float().numpy())
        assert not uc[:, len(cols):].any()


def _assert_results_equal(a, b, exact_floats):
    for name in ("sel", "labels"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      np.asarray(getattr(b, name)),
                                      err_msg=name)
    assert bool(a.feasible) == bool(b.feasible)
    assert int(a.n_clusters) == int(b.n_clusters)
    tol = dict(rtol=0, atol=0) if exact_floats else dict(rtol=1e-5, atol=1e-5)
    for name in ("obj", "bound", "lam"):
        np.testing.assert_allclose(np.asarray(getattr(a, name)),
                                   np.asarray(getattr(b, name)),
                                   err_msg=name, **tol)


@pytest.mark.parametrize("seed", SEEDS)
def test_cluster_builds_agree(seed, scatter):
    tst = (random_forest(seed) if seed % 2
           else random_forest(seed, p_miss=0.9, p_ais=0.01))
    lab_d, n_d = tsel.cluster(tst, SHAPES)
    assert int(n_d) == 1 if seed % 2 else 1 < int(n_d) < 7
    lab_j, n_j = jsel.cluster(to_jax(tst), JSHAPES)
    scatter()
    lab_s, n_s = tsel.cluster(tst, SHAPES)
    np.testing.assert_array_equal(lab_s.numpy(), lab_d.numpy())
    np.testing.assert_array_equal(lab_s.numpy(), np.asarray(lab_j))
    assert int(n_s) == int(n_d) == int(n_j)


@pytest.mark.parametrize("cap", [256, 2])
def test_select_hybrid_builds_agree_on_random_forests(cap, monkeypatch):
    """``cap=2`` puts the contested count above the cap: the overflow
    guard (full-space feasibility check, retreat to the spines) runs in
    both builds."""
    hyb_j = jax.jit(lambda st: jsel.select_hybrid(st, JSHAPES, JPARAMS,
                                                  contested_cap=cap))
    n_big = 0
    for seed in SEEDS:
        tst = random_forest(seed)
        dense = tsel.select_hybrid(tst, SHAPES, PARAMS, contested_cap=cap)
        want = jax.device_get(hyb_j(to_jax(tst)))
        with monkeypatch.context() as m:
            m.setattr(tsel, "_USAGE_DENSE_LIMIT", 0)
            m.setattr(tsel, "_INT32_WALL", 0)
            scat = tsel.select_hybrid(tst, SHAPES, PARAMS, contested_cap=cap)
        n_cont = tsel._contested_leaf_usage(tst, SHAPES, tst.tgt_mask,
                                            cap)[3]
        _assert_results_equal(scat, dense, exact_floats=True)
        _assert_results_equal(scat, want, exact_floats=False)
        n_big += int(n_cont) > cap
    assert n_big == len(SEEDS) if cap == 2 else n_big == 0


@pytest.mark.parametrize("seed", SEEDS)
def test_contested_leaf_usage_builds_agree(seed):
    tst = random_forest(seed)
    big = torch.from_numpy(big_filter(seed))
    usage = tsel._hist_usage(tst, SHAPES)
    for cap in (3, 64):
        d = tsel._contested_leaf_usage(tst, SHAPES, big, cap, usage)
        s = tsel._contested_leaf_usage(tst, SHAPES, big, cap, None)
        for a, b, name in zip(d, s, ("Uc", "col_slot", "col_ok", "n_cont",
                                     "eff_leaf")):
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
        assert d[0].shape == (8, 8, cap) and d[0].any()
        # only live leaves of the filtered targets use a column
        assert not d[0][~(tst.leaf_mask & big[:, None])].any()


def test_select_on_grown_ais_forests_with_scatter_builds(forests, scatter):
    """The whole ``select`` (fast path, clusters, tiers 1-3) on grown
    forests with AIS labels: scatter builds against the dense ones and
    against the JAX package."""
    shapes, params = port(AIS_JSHAPES), port(AIS_JPARAMS)
    sel_j = jax.jit(lambda st: jsel.select(st, AIS_JSHAPES, AIS_JPARAMS,
                                           method='lagrangian'))
    dense = [tsel.select(to_port(j), shapes, params, method='lagrangian')
             for j in forests]
    scatter()
    for jst, d in zip(forests, dense):
        s = tsel.select(to_port(jst), shapes, params, method='lagrangian')
        _assert_results_equal(s, d, exact_floats=True)
        _assert_results_equal(s, jax.device_get(sel_j(jst)),
                              exact_floats=False)


@pytest.mark.parametrize("fn", ["cluster", "select_hybrid"])
def test_int32_wall_boundary_takes_the_scatter_build(fn, monkeypatch):
    """T * n_slots == _INT32_WALL is already past the dense build (the
    JAX package's inclusive test would index out of int32 range there);
    one element less is not."""
    tst = random_forest(0)
    calls = []
    real = tsel._contested_minmax
    monkeypatch.setattr(tsel, "_contested_minmax",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    S = SHAPES.window * (SHAPES.max_meas + SHAPES.max_ais)
    run = {"cluster": lambda: tsel.cluster(tst, SHAPES),
           "select_hybrid": lambda: tsel.select_hybrid(tst, SHAPES, PARAMS)}
    monkeypatch.setattr(tsel, "_INT32_WALL", SHAPES.max_targets * S + 1)
    dense = run[fn]()
    assert not calls
    monkeypatch.setattr(tsel, "_INT32_WALL", SHAPES.max_targets * S)
    scat = run[fn]()
    assert calls
    for a, b in zip(dense, scat):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_dense_only_guard_is_gone():
    assert not hasattr(tsel, "_dense_only")
    assert tsel._INT32_WALL == 1 << 31 and tsel._USAGE_DENSE_LIMIT == 1 << 29

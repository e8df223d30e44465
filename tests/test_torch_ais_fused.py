"""The port's AIS candidate chain (pymht_tpu_torch/ops/ais_fused.py)
against the JAX package's ``ais_candidates_planes`` on the seeded forests
of tests/test_ais_fused.py.

Required: ``g_ok``, ``gate2`` and ``pure_gate`` identical, ``ais_idx``
identical under ``g_ok`` (elsewhere both pad with arbitrary messages);
scores at rtol 1e-4 / atol 1e-3; the selected-candidate ingredients
(x_bar2, z_hat2, K2, P_hat2) at rtol 1e-3 / atol 1e-3 under ``g_ok`` (the
f32 4x4 block-Schur inverse is good to ~1e-3, and the port forms it with
batched products where JAX spells out scalar planes).  No (leaf, message)
pair of these seeds has a stage-1 NIS within 1e-3 of the gate, so none is
excluded from the exact comparison (asserted below).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from pymht_tpu.core.config import TrackerShapes, TrackerParams  # noqa: E402
from pymht_tpu.core.grow import Scan as JScan, AisBatch as JAis  # noqa: E402
from pymht_tpu.core.state import empty_state, insert_targets  # noqa: E402
from pymht_tpu.models import pv  # noqa: E402
from pymht_tpu.ops.ais_fused import ais_candidates_planes  # noqa: E402
from pymht_tpu_torch.core import config as tconfig  # noqa: E402
from pymht_tpu_torch.core import state as tstate  # noqa: E402
from pymht_tpu_torch.core.grow import Scan  # noqa: E402
from pymht_tpu_torch.ops.ais_fused import ais_candidates  # noqa: E402

NAMES = ("g_ok", "gate2", "pure_gate", "nllr1g", "fused_score", "x_bar2",
         "z_hat2", "K2", "P_hat2", "ais_idx")
SCORE_TOL = dict(rtol=1e-4, atol=1e-3)
STATE_TOL = dict(rtol=1e-3, atol=1e-3)


def port(cfg):
    cls = getattr(tconfig, type(cfg).__name__)
    return cls(**{f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cls)})


def to_port(jstate):
    return tstate.state_from_numpy(
        {f.name: np.asarray(getattr(jstate, f.name))
         for f in dataclasses.fields(jstate)}, "cpu")


def setup(seed=0, T=6, L=4, M=24, A=5, with_mmsi=True, tgt_mmsi=False):
    """The forest, scan and AIS batch of tests/test_ais_fused.py:_setup
    (same draws in the same order); ``tgt_mmsi`` gives targets 0 and 1 a
    known MMSI (message 0's, and one that no message carries)."""
    shapes = TrackerShapes(max_targets=T, max_leaves=L, max_meas=M,
                           max_ais=A, window=4, max_prelim=8,
                           max_initiators=M, ais_per_leaf=2)
    params = TrackerParams(radar_period=2.5, P_d=0.9, lambda_phi=2e-6,
                           lambda_nu=1e-5, N=3, radar_range=500.0)
    rng = np.random.default_rng(seed)
    xs = np.zeros((T, 4), np.float32)
    xs[:, :2] = rng.uniform(-200, 200, (T, 2))
    xs[:, 2:] = rng.normal(0, 4, (T, 2))
    mm = np.zeros((T,), np.int32)
    if tgt_mmsi:
        mm[:2] = (100000000, 777000777)
    st = empty_state(shapes, params)
    st = insert_targets(st, jnp.asarray(xs),
                        jnp.broadcast_to(jnp.asarray(np.asarray(pv.P0)),
                                         (T, 4, 4)),
                        jnp.ones((T,), bool), jnp.asarray(mm),
                        jnp.asarray(0.0), params)
    lx = np.repeat(np.asarray(st.leaf_x)[:, :1], L, axis=1)
    lx += rng.normal(0, 1.5, lx.shape).astype(np.float32)
    lP = np.repeat(np.asarray(st.leaf_P)[:, :1], L, axis=1)
    lP += np.eye(4, dtype=np.float32) * rng.uniform(0, .5, (T, L, 1, 1))
    st = st.replace(
        leaf_x=jnp.asarray(lx), leaf_P=jnp.asarray(lP),
        leaf_mask=jnp.asarray(rng.random((T, L)) < 0.9),
        leaf_cnllr=jnp.asarray(rng.normal(0, 1, (T, L)).astype(np.float32)))
    z = rng.uniform(-220, 220, (M, 2)).astype(np.float32)
    z[:T] = xs[:, :2] + 2.5 * xs[:, 2:] + rng.normal(0, 2, (T, 2))
    scan = dict(z=z, mask=rng.random(M) < 0.95, time=np.float32(2.5))
    ast = np.zeros((A, 4), np.float32)
    ast[:, :2] = xs[:A, :2] + rng.normal(0, 1.0, (A, 2))
    ast[:, 2:] = xs[:A, 2:] + rng.normal(0, .5, (A, 2))
    ais = dict(
        state=ast, time=rng.uniform(0.3, 2.2, A).astype(np.float32),
        mmsi=(100000000 + np.arange(A)).astype(np.int32)
        * (1 if with_mmsi else 0),
        high_accuracy=rng.random(A) < 0.5, mask=rng.random(A) < 0.9)
    return shapes, params, st, scan, ais


def both(shapes, params, st, scan, ais, prefilter=0, z_sub=None,
         zmask_sub=None, n_targets=None):
    G = shapes.ais_fuse_width
    jsub = {} if z_sub is None else dict(z_sub=jnp.asarray(z_sub),
                                         zmask_sub=jnp.asarray(zmask_sub))
    tsub = {} if z_sub is None else dict(z_sub=torch.from_numpy(z_sub),
                                         zmask_sub=torch.from_numpy(zmask_sub))
    a = jax.device_get(ais_candidates_planes(
        st, JScan(**{k: jnp.asarray(v) for k, v in scan.items()}),
        JAis(**{k: jnp.asarray(v) for k, v in ais.items()}), params, G,
        n_targets=n_targets, prefilter=prefilter, **jsub))
    b = ais_candidates(
        to_port(st), Scan(**{k: torch.as_tensor(v) for k, v in scan.items()}),
        tstate.ais_from_numpy(ais, "cpu"), port(params), G,
        n_targets=n_targets, prefilter=prefilter, **tsub)
    return dict(zip(NAMES, a)), {n: v.numpy() for n, v in zip(NAMES, b)}


def compare(a, b):
    g = a["g_ok"]
    np.testing.assert_array_equal(b["g_ok"], g, err_msg="g_ok")
    for name in ("gate2", "pure_gate"):
        np.testing.assert_array_equal(b[name], a[name], err_msg=name)
    np.testing.assert_array_equal(b["ais_idx"][g], a["ais_idx"][g])
    np.testing.assert_allclose(b["nllr1g"][g], a["nllr1g"][g], **SCORE_TOL)
    np.testing.assert_allclose(b["fused_score"][a["gate2"]],
                               a["fused_score"][a["gate2"]], **SCORE_TOL)
    for name in ("x_bar2", "z_hat2", "K2", "P_hat2"):
        np.testing.assert_allclose(b[name][g], a[name][g], err_msg=name,
                                   **STATE_TOL)


def stage1_nis_margin(shapes, params, st, ais):
    """Smallest |NIS - eta2_ais| over the admissible (leaf, message)
    pairs, from a float64 stage-1 sweep."""
    x = np.asarray(st.leaf_x, np.float64)
    P = np.asarray(st.leaf_P, np.float64)
    t0 = float(st.time)
    margin = np.inf
    for a in np.nonzero(ais["mask"])[0]:
        T_ = float(ais["time"][a]) - t0
        F = np.eye(4)
        F[0, 2] = F[1, 3] = T_
        Q = np.array([[T_**4 / 4, 0, T_**3 / 3, 0], [0, T_**4 / 4, 0, T_**3 / 3],
                      [T_**3 / 3, 0, T_**2, 0], [0, T_**3 / 3, 0, T_**2]])
        r = 1.0 if ais["high_accuracy"][a] else 9.0
        S = F @ P @ F.T + Q + r * np.eye(4)
        zt = ais["state"][a].astype(np.float64) - x @ F.T
        nis = np.einsum('tli,tlij,tlj->tl', zt, np.linalg.inv(S), zt)
        margin = min(margin, np.abs(
            nis - params.eta2_ais)[np.asarray(st.leaf_mask)].min())
    return margin


@pytest.mark.parametrize("seed", range(6))
def test_candidates_match_jax_planes(seed):
    shapes, params, st, scan, ais = setup(seed)
    assert stage1_nis_margin(shapes, params, st, ais) > 1e-3
    a, b = both(shapes, params, st, scan, ais)
    assert a["g_ok"].any()
    compare(a, b)


@pytest.mark.parametrize("seed,kw", [(0, dict(with_mmsi=False)),
                                     (2, dict(tgt_mmsi=True)),
                                     (4, dict(tgt_mmsi=True))])
def test_mmsi_consistency_matches(seed, kw):
    """Messages without an MMSI, and targets that already hold one: a
    9-digit MMSI must compare as an integer."""
    shapes, params, st, scan, ais = setup(seed, **kw)
    a, b = both(shapes, params, st, scan, ais)
    compare(a, b)
    if kw.get("tgt_mmsi"):
        # target 1 holds an MMSI that no message carries
        assert not b["g_ok"][1].any()


def test_no_messages():
    shapes, params, st, scan, ais = setup(1)
    ais["mask"][:] = False
    a, b = both(shapes, params, st, scan, ais)
    for name in ("g_ok", "gate2", "pure_gate"):
        assert not a[name].any() and not b[name].any()
    for name in NAMES:
        assert b[name].shape == a[name].shape, name


@pytest.mark.parametrize("seed", [0, 3])
def test_prefilter_matches_exact_sweep(seed):
    """ais_prefilter_width: the bound sweep picks what the exact sweep
    picks (A = 10 messages, Gp = 6), and both equal the JAX package's."""
    shapes, params, st, scan, ais = setup(seed, T=10, A=10)
    exact_j, exact_t = both(shapes, params, st, scan, ais)
    fast_j, fast_t = both(shapes, params, st, scan, ais, prefilter=6)
    compare(fast_j, fast_t)
    compare(exact_t, fast_t)
    assert exact_t["g_ok"].any()


def test_per_target_measurements_and_target_count():
    """z_sub / zmask_sub (the spatial pre-gate's per-target axis) and the
    n_targets override."""
    shapes, params, st, scan, ais = setup(5)
    rng = np.random.default_rng(50)
    T, Km = shapes.max_targets, 7
    idx = np.stack([rng.permutation(shapes.max_meas)[:Km] for _ in range(T)])
    idx[:, 0] = np.arange(T)            # each target keeps its own return
    a, b = both(shapes, params, st, scan, ais, z_sub=scan["z"][idx],
                zmask_sub=scan["mask"][idx], n_targets=40.0)
    assert a["gate2"].shape == (T, shapes.max_leaves, 2, Km)
    assert a["gate2"].any()
    compare(a, b)
    c, _ = both(shapes, params, st, scan, ais, z_sub=scan["z"][idx],
                zmask_sub=scan["mask"][idx])
    g = a["g_ok"]
    np.testing.assert_allclose(a["nllr1g"][g] - c["nllr1g"][g],
                               np.log(40.0 / 6.0), rtol=1e-4)

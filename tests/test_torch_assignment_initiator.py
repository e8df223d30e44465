"""Auction assignment and the m/n initiator of the port against the JAX
package.

Auction: cardinality identical to JAX's (exact maximum cardinality),
total cost within n*eps of JAX's (eps = span / (2 (n+1)^2), the auction's
optimality bound, ops/assignment.py:29-31).  Initiator: three-plus scans
of step() with identical integer state and float state within
rtol 1e-5 / atol 1e-4.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from pymht_tpu.core import initiator as jinit  # noqa: E402
from pymht_tpu.core.config import TrackerShapes, TrackerParams  # noqa: E402
from pymht_tpu.core.grow import empty_ais  # noqa: E402
from pymht_tpu.ops.assignment import auction_assign as j_auction  # noqa: E402
from pymht_tpu_torch.core import config as tconfig  # noqa: E402
from pymht_tpu_torch.core import initiator as tinit  # noqa: E402
from pymht_tpu_torch.core.grow import empty_ais as t_empty_ais  # noqa: E402
from pymht_tpu_torch.core.state import (  # noqa: E402
    ais_from_numpy, initiator_from_numpy, initiator_to_numpy)
from pymht_tpu_torch.ops.assignment import auction_assign  # noqa: E402


def _problem(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "geometric":          # sparse gates, like the initiator's
        R, C = 12, 20
        a = rng.uniform(0, 100, (R, 2))
        b = rng.uniform(0, 100, (C, 2))
        cost = np.linalg.norm(a[:, None] - b[None], axis=2)
        valid = cost < 25.0
    elif kind == "ties":             # dense integer costs: many ties
        R, C = 10, 10
        cost = rng.integers(0, 3, (R, C)).astype(np.float64)
        valid = rng.uniform(size=(R, C)) < 0.6
    else:                            # over-subscribed: more rows than cols
        R, C = 16, 6
        cost = rng.uniform(0, 10, (R, C))
        valid = rng.uniform(size=(R, C)) < 0.5
    return cost.astype(np.float32), valid


@pytest.mark.parametrize("kind", ["geometric", "ties", "oversubscribed"])
@pytest.mark.parametrize("max_iters", [48, 4000])
@pytest.mark.parametrize("seed", range(3))
def test_auction_matches_jax(kind, max_iters, seed):
    cost, valid = _problem(kind, seed)
    r_j = np.asarray(jax.jit(lambda c, v: j_auction(c, v, max_iters))(
        jnp.asarray(cost), jnp.asarray(valid)))
    r_t = auction_assign(torch.from_numpy(cost), torch.from_numpy(valid),
                         max_iters).numpy()
    for r in (r_t, r_j):
        ok = r >= 0
        assert valid[np.nonzero(ok)[0], r[ok]].all()           # gated pairs
        assert len(set(r[ok].tolist())) == ok.sum()           # one-to-one
    assert (r_t >= 0).sum() == (r_j >= 0).sum()
    cost_of = lambda r: float(cost[np.nonzero(r >= 0)[0],  # noqa: E731
                                   r[r >= 0]].sum())
    n = max(cost.shape)
    vc = cost[valid]
    span = max(float(vc.max() - vc.min()), 1.0) if vc.size else 1.0
    eps = span / (2.0 * (n + 1) ** 2)
    assert abs(cost_of(r_t) - cost_of(r_j)) <= n * eps + 1e-4


def port(cfg):
    """The port's own TrackerShapes/TrackerParams, built from the numbers
    of the JAX package's: each side is given its own classes."""
    cls = getattr(tconfig, type(cfg).__name__)
    return cls(**{f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cls) if hasattr(cfg, f.name)})


SHAPES = TrackerShapes(max_targets=8, max_leaves=8, max_meas=16, max_ais=2,
                       window=5, max_prelim=8, max_initiators=16)
PARAMS = TrackerParams(radar_period=2.5, P_d=0.9, lambda_phi=1e-5,
                       lambda_nu=1e-5, N=3)
TSHAPES, TPARAMS = port(SHAPES), port(PARAMS)


def test_initiator_step_matches_jax():
    """Five scans: four targets appear (two of them close together, so
    the GNN and the NIS dedup matter) plus clutter; prelims form, get
    updated and confirm."""
    rng = np.random.default_rng(3)
    x0 = np.array([[0, 0, 5, 1], [200, 50, -4, 3], [6, 2, 5, -1],
                   [-150, 80, 2, -6]], np.float32)
    step_j = jax.jit(lambda st, z, m, t: jinit.step(
        st, z, m, t, empty_ais(SHAPES), SHAPES, PARAMS))
    st_j = jinit.empty_initiator(SHAPES)
    st_t = tinit.empty_initiator(TSHAPES, "cpu")
    n_confirmed = 0
    for k in range(5):
        t = 2.5 * (k + 1)
        pos = x0[:, :2] + x0[:, 2:] * t + rng.normal(0, 1.0, (4, 2))
        clutter = rng.uniform(-300, 300, (5, 2))
        meas = np.concatenate([pos, clutter]).astype(np.float32)
        z = np.zeros((16, 2), np.float32)
        z[:len(meas)] = meas
        zm = np.arange(16) < len(meas)
        out_j = jax.device_get(step_j(st_j, jnp.asarray(z), jnp.asarray(zm),
                                      jnp.asarray(t, jnp.float32)))
        out_t = tinit.step(st_t, torch.from_numpy(z), torch.from_numpy(zm),
                           torch.tensor(t, dtype=torch.float32),
                           t_empty_ais(TSHAPES, "cpu"), TSHAPES, TPARAMS)
        st_j, st_t = out_j.state, out_t.state
        got = initiator_to_numpy(st_t)
        for f in dataclasses.fields(st_j):
            want = np.asarray(getattr(st_j, f.name))
            if want.dtype.kind == "f":
                np.testing.assert_allclose(got[f.name], want, rtol=1e-5,
                                           atol=1e-4, err_msg=f.name)
            else:
                np.testing.assert_array_equal(got[f.name], want,
                                              err_msg=f.name)
        np.testing.assert_array_equal(out_t.new_mask.numpy(),
                                      np.asarray(out_j.new_mask))
        m = np.asarray(out_j.new_mask)
        np.testing.assert_allclose(out_t.new_x.numpy()[m],
                                   np.asarray(out_j.new_x)[m],
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(out_t.new_P.numpy()[m],
                                   np.asarray(out_j.new_P)[m],
                                   rtol=1e-5, atol=1e-4)
        n_confirmed += int(m.sum())
        # the numpy round trip of the port's state is lossless
        st_t = initiator_from_numpy(got, "cpu")
    assert n_confirmed >= 3


def _assert_initiator_equal(st_j, st_t):
    got = initiator_to_numpy(st_t)
    for f in dataclasses.fields(st_j):
        want = np.asarray(getattr(st_j, f.name))
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got[f.name], want, rtol=1e-5,
                                       atol=1e-4, err_msg=f.name)
        else:
            np.testing.assert_array_equal(got[f.name], want, err_msg=f.name)


def test_initiator_ais_seeding_matches_jax():
    """Block 1b against the JAX initiator over four scans: messages seed
    prelims at their state predicted to scan time with P0; a message
    whose MMSI a prelim already holds, a message without an MMSI next to
    an existing prelim (NIS dedup) and masked messages seed nothing; the
    radar then confirms the seeded prelims, which carry their nine-digit
    MMSI into ``new_mmsi``."""
    from pymht_tpu.core.grow import AisBatch as JAis
    rng = np.random.default_rng(8)
    ships = np.array([[0, 0, 5, 1], [200, 50, -4, 3], [-150, 80, 2, -6]],
                     np.float32)
    mmsi = np.int32([987654321, 257000001, 0])
    step_j = jax.jit(lambda st, z, m, t, a: jinit.step(st, z, m, t, a,
                                                       SHAPES, PARAMS))
    st_j = jinit.empty_initiator(SHAPES)
    st_t = tinit.empty_initiator(TSHAPES, "cpu")
    seen = set()
    for k in range(4):
        t = 2.5 * (k + 1)
        pos = ships[:, :2] + ships[:, 2:] * t + rng.normal(0, 1.0, (3, 2))
        z = np.zeros((16, 2), np.float32)
        z[:3] = pos
        z[3:6] = rng.uniform(-300, 300, (3, 2))
        zm = np.arange(16) < 6
        # scan k reports ships k % 3 and (k + 1) % 3, 0.7 s before the scan
        a_state = np.zeros((2, 4), np.float32)
        a_mmsi = np.zeros(2, np.int32)
        for j, ship in enumerate((k % 3, (k + 1) % 3)):
            a_state[j] = ships[ship]
            a_state[j, :2] += ships[ship, 2:] * (t - 0.7)
            a_state[j] += rng.normal(0, 0.3, 4)
            a_mmsi[j] = mmsi[ship]
        ais = dict(state=a_state, time=np.float32([t - 0.7, t - 0.7]),
                   mmsi=a_mmsi, high_accuracy=np.array([True, False]),
                   mask=np.array([True, k != 2]))
        out_j = jax.device_get(step_j(
            st_j, jnp.asarray(z), jnp.asarray(zm),
            jnp.asarray(t, jnp.float32),
            JAis(**{n: jnp.asarray(v) for n, v in ais.items()})))
        out_t = tinit.step(st_t, torch.from_numpy(z), torch.from_numpy(zm),
                           torch.tensor(t, dtype=torch.float32),
                           ais_from_numpy(ais, "cpu"), TSHAPES, TPARAMS)
        st_j, st_t = out_j.state, out_t.state
        _assert_initiator_equal(st_j, st_t)
        np.testing.assert_array_equal(out_t.new_mask.numpy(),
                                      np.asarray(out_j.new_mask))
        np.testing.assert_array_equal(out_t.new_mmsi.numpy(),
                                      np.asarray(out_j.new_mmsi))
        m = np.asarray(out_j.new_mask)
        np.testing.assert_allclose(out_t.new_x.numpy()[m],
                                   np.asarray(out_j.new_x)[m],
                                   rtol=1e-5, atol=1e-4)
        seen |= set(out_t.new_mmsi.numpy()[m].tolist())
    assert {987654321, 257000001} <= seen


def test_initiator_refuses_ais():
    """The initiator takes an AisBatch or None, nothing else; None (AIS
    initiation off) gives what an empty batch gives."""
    st = tinit.empty_initiator(TSHAPES, "cpu")
    z = torch.tensor(np.random.default_rng(0).uniform(-50, 50, (16, 2)),
                     dtype=torch.float32)
    zm = torch.arange(16) < 9
    with pytest.raises(TypeError, match="AisBatch"):
        tinit.step(st, z, zm, torch.tensor(1.0), object(), TSHAPES, TPARAMS)
    for k in range(3):
        t = torch.tensor(2.5 * (k + 1))
        a = tinit.step(st, z + k, zm, t, None, TSHAPES, TPARAMS)
        b = tinit.step(st, z + k, zm, t, t_empty_ais(TSHAPES, "cpu"),
                       TSHAPES, TPARAMS)
        for f in dataclasses.fields(a.state):
            assert torch.equal(getattr(a.state, f.name),
                               getattr(b.state, f.name)), f.name
        assert torch.equal(a.new_mask, b.new_mask)
        st = a.state
    assert bool(st.p_mask.any())

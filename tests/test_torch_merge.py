"""Similar-state merging of the port (core/merge.prune_similar): the four
cases of tests/test_merge.py on the port, and parity with the JAX
function on seeded forests built to merge (sibling groups with shared
history prefixes, positions strung out so that chains a~b~c with a!~c
occur, AIS-labelled leaves and spines inside groups).

Required: ``leaf_mask`` (which leaves survive) identical to the JAX
package's; merged states, covariances and scores within rtol 1e-5 /
atol 1e-5 (means of up to L f32 values, summed in another order).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from pymht_tpu.core.config import (  # noqa: E402
    TrackerShapes as JShapes, TrackerParams as JParams)
from pymht_tpu.core.merge import prune_similar as jprune  # noqa: E402
from pymht_tpu.core.state import TrackerState as JState  # noqa: E402
from pymht_tpu_torch.core.config import (  # noqa: E402
    TrackerShapes, TrackerParams)
from pymht_tpu_torch.core.merge import prune_similar  # noqa: E402
from pymht_tpu_torch.core.state import (  # noqa: E402
    empty_state, state_to_numpy)

_SHAPES = dict(max_targets=4, max_leaves=8, max_meas=8, max_ais=2, window=4)
SHAPES, JSHAPES = TrackerShapes(**_SHAPES), JShapes(**_SHAPES)
PARAMS, JPARAMS = (TrackerParams(prune_threshold=4.0),
                   JParams(prune_threshold=4.0))
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def state_with_leaves(positions, last_labels, prefix_label=1, mmsi=None):
    """A single-target state with the given leaf positions and current
    labels; all leaves share the history prefix; the spine points at an
    unused slot."""
    st = empty_state(SHAPES, PARAMS, "cpu")
    T, L, W = st.hist_meas.shape
    leaf_x = np.zeros((T, L, 4), np.float32)
    leaf_mask = np.zeros((T, L), bool)
    hist_meas = np.full((T, L, W), -1, np.int32)
    hist_mmsi = np.zeros((T, L, W), np.int32)
    cnllr = np.zeros((T, L), np.float32)
    for i, p in enumerate(positions):
        leaf_x[0, i, :2] = p
        leaf_mask[0, i] = True
        hist_meas[0, i, W - 2] = prefix_label
        hist_meas[0, i, W - 1] = last_labels[i]
        if mmsi and mmsi[i]:
            hist_mmsi[0, i, W - 1] = mmsi[i]
        cnllr[0, i] = float(i)
    return st.replace(
        leaf_x=_t(leaf_x), leaf_mask=_t(leaf_mask), hist_meas=_t(hist_meas),
        hist_mmsi=_t(hist_mmsi), leaf_cnllr=_t(cnllr),
        hist_cnllr=_t(np.broadcast_to(cnllr[..., None], (T, L, W)).copy()),
        tgt_mask=_t(np.array([True, False, False, False])),
        tgt_depth=_t(np.array([2, 0, 0, 0], np.int32)),
        spine_leaf=torch.full((T,), L - 1, dtype=torch.int32))


def to_jax(tst):
    return JState(**{k: jnp.asarray(v)
                     for k, v in state_to_numpy(tst).items()})


def assert_matches_jax(tst, out):
    want = jprune(to_jax(tst), JSHAPES, JPARAMS)
    for f in dataclasses.fields(out):
        a, b = getattr(out, f.name).numpy(), np.asarray(getattr(want, f.name))
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, err_msg=f.name, **TOL)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)


def test_close_siblings_merge():
    st = state_with_leaves([(0, 0), (1, 0), (100, 0)], [1, 2, 3])
    out = prune_similar(st, SHAPES, PARAMS)
    assert out.leaf_mask[0].tolist()[:3] == [True, False, True]
    # the representative takes the group's mean state and cnllr
    np.testing.assert_allclose(out.leaf_x[0, 0, :2].numpy(), [0.5, 0.0])
    assert float(out.leaf_cnllr[0, 0]) == 0.5
    assert float(out.hist_cnllr[0, 0, -1]) == 0.5
    assert_matches_jax(st, out)


def test_ais_leaves_exempt():
    st = state_with_leaves([(0, 0), (1, 0)], [1, 2], mmsi=[0, 123456789])
    out = prune_similar(st, SHAPES, PARAMS)
    assert int(out.leaf_mask[0].sum()) == 2
    assert_matches_jax(st, out)


def test_spine_exempt():
    """The feasibility spine (zero-hypothesis child of the previously
    selected leaf) is never absorbed: selection repair relies on it."""
    st = state_with_leaves([(0, 0), (1, 0)], [0, 2])
    st = st.replace(spine_leaf=torch.zeros_like(st.spine_leaf))
    out = prune_similar(st, SHAPES, PARAMS)
    assert int(out.leaf_mask[0].sum()) == 2
    assert_matches_jax(st, out)


def test_different_prefix_not_merged():
    st = state_with_leaves([(0, 0), (1, 0)], [1, 2])
    hm = st.hist_meas.clone()
    hm[0, 1, -2] = 5
    st = st.replace(hist_meas=hm)
    out = prune_similar(st, SHAPES, PARAMS)
    assert int(out.leaf_mask[0].sum()) == 2
    assert_matches_jax(st, out)


def test_first_partner_is_the_representative():
    """Three mutually close siblings: ``argmax`` on the bool membership
    must return the first maximum, as ``jnp.argmax`` does, so leaf 0
    represents all three."""
    st = state_with_leaves([(0, 0), (1, 0), (2, 0)], [1, 2, 3])
    out = prune_similar(st, SHAPES, PARAMS)
    assert out.leaf_mask[0].tolist()[:3] == [True, False, False]
    np.testing.assert_allclose(out.leaf_x[0, 0, :2].numpy(), [1.0, 0.0])
    assert_matches_jax(st, out)


def seeded_forest(seed):
    """Every target: leaves in sibling groups of 1-4 that share a prefix;
    inside a group positions step by 0-3.5 m along a line (threshold
    4 m), so pairs, whole groups and chains all occur; ~15 % of the
    leaves carry an AIS label, the spine sits on a random live leaf."""
    rng = np.random.default_rng(seed)
    st = empty_state(SHAPES, PARAMS, "cpu")
    T, L, W = st.hist_meas.shape
    leaf_x = rng.normal(0, 1, (T, L, 4)).astype(np.float32)
    leaf_P = (np.eye(4) * rng.uniform(1, 3, (T, L, 1, 1))).astype(np.float32)
    hist_meas = np.zeros((T, L, W), np.int32)
    hist_ais = np.zeros((T, L, W), np.int32)
    hist_mmsi = np.zeros((T, L, W), np.int32)
    for t in range(T):
        leaf, group = 0, 0
        while leaf < L:
            size = int(rng.integers(1, 5))
            prefix = rng.integers(0, 9, W - 1)
            origin = rng.normal(0, 200, 2)
            step = 0.0
            for _ in range(min(size, L - leaf)):
                hist_meas[t, leaf, :W - 1] = prefix
                hist_meas[t, leaf, W - 1] = leaf + 1
                leaf_x[t, leaf, :2] = origin + [step, 0.0]
                step += rng.uniform(0.0, 3.5)
                if rng.random() < 0.15:
                    hist_ais[t, leaf, W - 1] = 1
                    hist_mmsi[t, leaf, W - 1] = 257000000 + group
                leaf += 1
            group += 1
    leaf_mask = rng.random((T, L)) < 0.9
    cnllr = rng.normal(0, 3, (T, L)).astype(np.float32)
    hist_cnllr = rng.normal(0, 3, (T, L, W)).astype(np.float32)
    hist_cnllr[:, :, -1] = cnllr
    return st.replace(
        leaf_x=_t(leaf_x), leaf_P=_t(leaf_P), leaf_mask=_t(leaf_mask),
        leaf_cnllr=_t(cnllr), hist_cnllr=_t(hist_cnllr),
        hist_meas=_t(hist_meas), hist_ais=_t(hist_ais),
        hist_mmsi=_t(hist_mmsi), tgt_mask=torch.ones(T, dtype=torch.bool),
        tgt_depth=torch.full((T,), W, dtype=torch.int32),
        spine_leaf=_t(rng.integers(0, L, T).astype(np.int32)))


@pytest.mark.parametrize("seed", range(6))
def test_prune_similar_matches_jax_on_seeded_forests(seed):
    st = seeded_forest(seed)
    before = {k: v.copy() for k, v in state_to_numpy(st).items()}
    out = prune_similar(st, SHAPES, PARAMS)
    assert_matches_jax(st, out)
    n_absorbed = int((st.leaf_mask & ~out.leaf_mask).sum())
    n_moved = int(((out.leaf_x != st.leaf_x).any(dim=2)
                   & out.leaf_mask).sum())
    assert n_absorbed >= 3 and n_moved >= 2, (n_absorbed, n_moved)
    # an absorbed leaf is never AIS-labelled nor the spine
    gone = (st.leaf_mask & ~out.leaf_mask).numpy()
    assert not (gone & (before["hist_mmsi"][:, :, -1] != 0)).any()
    assert not gone[np.arange(4), before["spine_leaf"]].any()
    # the input state is not modified
    for k, v in state_to_numpy(st).items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)

"""``shrink_beam`` / ``expand_beam`` of the port against the JAX package
on seeded forests: which leaves are kept (score ties, dead leaves with
+inf keys, the selected leaf forced first, dead selections), every field
gathered alike, ``sel_leaf``/``spine_leaf`` remapped; the round trip
through the numpy converters at the new beam width; and a grown forest
that goes on tracking after the conversion exactly as the JAX package's
does.

Required: on the same forest all fields identical (the conversion is a
gather, no arithmetic); on forests each package grew itself, integers
and masks identical and floats within rtol 1e-4 / atol 1e-3.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from pymht_tpu.core import state as jstate  # noqa: E402
from pymht_tpu.core.config import (  # noqa: E402
    TrackerShapes as JShapes, TrackerParams as JParams)
from pymht_tpu.core.tracker import Tracker as JTracker  # noqa: E402
from pymht_tpu_torch.core import state as tstate  # noqa: E402
from pymht_tpu_torch.core.config import (  # noqa: E402
    TrackerShapes, TrackerParams)
from pymht_tpu_torch.core.tracker import Tracker  # noqa: E402
from tests.test_torch_tracker import cluttered_scene  # noqa: E402

_SHAPES = dict(max_targets=6, max_leaves=16, max_meas=12, max_ais=4, window=5,
               max_prelim=4, max_initiators=8)
SHAPES, JSHAPES = TrackerShapes(**_SHAPES), JShapes(**_SHAPES)
PARAMS, JPARAMS = TrackerParams(), JParams()


def seeded_state(seed):
    """Random leaf tables; scores drawn from five values so that ties are
    everywhere; target 1 has a dead selected leaf, target 2 only two live
    leaves, target 3 none, target 4 a selection index beyond the beam."""
    rng = np.random.default_rng(seed)
    T, L, W = SHAPES.max_targets, SHAPES.max_leaves, SHAPES.window
    d = tstate.state_to_numpy(tstate.empty_state(SHAPES, PARAMS, "cpu"))
    for name, a in d.items():
        if a.ndim >= 2 and a.shape[:2] == (T, L):
            if a.dtype.kind == "f":
                d[name] = rng.normal(0, 5, a.shape).astype(np.float32)
            elif a.dtype.kind == "i":
                d[name] = rng.integers(-1, 9, a.shape).astype(np.int32)
    d["leaf_cnllr"] = rng.integers(0, 5, (T, L)).astype(np.float32)
    mask = rng.random((T, L)) < 0.7
    sel = rng.integers(0, L, T).astype(np.int32)
    mask[np.arange(T), sel] = True
    mask[1, sel[1]] = False
    mask[2] = False
    mask[2, [3, 11]] = True
    sel[2] = 11
    mask[3] = False
    sel[4] = L + 3
    d["leaf_mask"], d["sel_leaf"] = mask, sel
    d["spine_leaf"] = rng.integers(0, L, T).astype(np.int32)
    d["tgt_mask"] = np.ones(T, bool)
    return d


def both(d):
    return (tstate.state_from_numpy(d, "cpu"),
            jstate.TrackerState(**{k: jnp.asarray(v) for k, v in d.items()}))


def assert_states_equal(tst, jst, float_tol=None):
    """``float_tol``: for forests that each package grew itself (f32
    filtering rounds differently); integers and masks stay exact."""
    for f in dataclasses.fields(tst):
        a = getattr(tst, f.name)
        b = np.asarray(getattr(jst, f.name))
        assert tuple(a.shape) == b.shape, f.name
        assert a.numpy().dtype == b.dtype, f.name
        if float_tol and b.dtype.kind == "f":
            np.testing.assert_allclose(a.numpy(), b, err_msg=f.name,
                                       **float_tol)
        else:
            np.testing.assert_array_equal(a.numpy(), b, err_msg=f.name)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("new_L", [8, 4, 1, 16])
def test_shrink_beam_matches_jax(seed, new_L):
    d = seeded_state(seed)
    tst, jst = both(d)
    out = tstate.shrink_beam(tst, new_L)
    assert_states_equal(out, jstate.shrink_beam(jst, new_L))
    assert out.leaf_mask.shape == (SHAPES.max_targets, new_L)
    if new_L == 16:
        assert out is tst
        return
    # the selected leaf, where live, is kept and sel/spine point at it
    sel = np.clip(d["sel_leaf"], 0, 15)
    for t in range(SHAPES.max_targets):
        if d["leaf_mask"][t, sel[t]]:
            s = int(out.sel_leaf[t])
            assert int(out.spine_leaf[t]) == s and bool(out.leaf_mask[t, s])
            np.testing.assert_array_equal(out.leaf_x[t, s].numpy(),
                                          d["leaf_x"][t, sel[t]])
        else:
            assert int(out.sel_leaf[t]) == 0
    # as many live leaves as fit are kept
    np.testing.assert_array_equal(
        out.leaf_mask.sum(dim=1).numpy(),
        np.minimum(d["leaf_mask"].sum(axis=1), new_L))


@pytest.mark.parametrize("seed", range(2))
def test_expand_beam_matches_jax_and_round_trips(seed):
    d = seeded_state(seed)
    tst, jst = both(d)
    small = tstate.shrink_beam(tst, 8)
    wide = tstate.expand_beam(small, 16)
    assert_states_equal(wide, jstate.expand_beam(jstate.shrink_beam(jst, 8),
                                                 16))
    assert tstate.expand_beam(small, 8) is small
    assert not wide.leaf_mask[:, 8:].any()
    assert (wide.hist_meas[:, 8:] == -1).all()
    # shrinking the padded forest again gives the small one back
    again = tstate.shrink_beam(wide, 8)
    live = small.leaf_mask
    np.testing.assert_array_equal(again.leaf_x[live].numpy(),
                                  small.leaf_x[live].numpy())
    # the numpy converters read the beam width from the arrays
    back = tstate.state_from_numpy(tstate.state_to_numpy(small), "cpu")
    for f in dataclasses.fields(small):
        assert torch.equal(getattr(back, f.name), getattr(small, f.name))
    with pytest.raises(ValueError):
        tstate.shrink_beam(small, 9)
    with pytest.raises(ValueError):
        tstate.expand_beam(small, 7)


def test_tracking_continues_alike_after_degrade():
    """Both Trackers halve the beam by hand after scan 4 and go on: the
    same outputs on every scan, so the spine remap survives the next grow
    and select."""
    params, jparams, scans, seeds = cluttered_scene()
    shapes = dict(max_targets=8, max_leaves=16, max_meas=16, max_ais=4,
                  window=7, max_prelim=8, max_initiators=16)
    jt = JTracker(JShapes(**shapes), jparams, method='lagrangian',
                  use_ais=False)
    tt = Tracker(TrackerShapes(**shapes), params, method='lagrangian',
                 use_ais=False, device='cpu')
    for tr in (jt, tt):
        tr.pre_initialize(scans[0].time - params.radar_period, seeds)
    for i, s in enumerate(scans):
        if i == 4:
            before = tt.get_track_states()
            assert jt.degrade() and tt.degrade()
            assert tt.shapes.max_leaves == jt.shapes.max_leaves == 8
            assert_states_equal(tt.state, jt.state,
                                dict(rtol=1e-4, atol=1e-3))
            after = tt.get_track_states()
            np.testing.assert_array_equal(before[0], after[0])
            np.testing.assert_array_equal(before[1], after[1])
        oj = jt.add_measurement_list(s.time, s.measurements)
        ot = tt.add_measurement_list(s.time, s.measurements,
                                     check_integrity=True)
        assert bool(ot.sel_feasible)
        for name in oj._fields:
            a, b = np.asarray(getattr(oj, name)), getattr(ot, name)
            if a.dtype.kind == "f":
                np.testing.assert_allclose(b, a, err_msg=name, rtol=1e-4,
                                           atol=1e-3)
            else:
                np.testing.assert_array_equal(b, a, err_msg=name)
    assert not tt.degrade(min_leaves=8)
    assert tt.degrade() and tt.shapes.max_leaves == 4
    assert not tt.degrade()

"""The exact finish of the port's production selection
(``core/select.finish``, the ``'lagrangian'`` method of ``select``) held
to the plain HiGHS oracle (``utils/oracle.milp_select_oracle``).

One small forest per exit of ``select_hybrid`` that leaves its own
certificate (``obj - bound``) open: (a) tier 2's truncated candidate
sets, (b) tier 3's Lagrangian stopped above its tolerance, (c) the
contested-slot cap's retreat to the spines.  On each, ``select`` reaches
the oracle's optimum within 1e-3 with a sound, closed bound; on a forest
whose certificate is closed the finish is not entered.  Then a short
seeded stream at the coastal deployment's density through
``Tracker(device='cpu')``, every scan's selection within 1e-3 of HiGHS.
Port only (no JAX), on the CPU.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pymht_tpu_torch import Tracker, TrackerParams, TrackerShapes  # noqa: E402
from pymht_tpu_torch.core import select as tsel  # noqa: E402
from pymht_tpu_torch.core import tracker as tracker_mod  # noqa: E402
from pymht_tpu_torch.utils import oracle, timing  # noqa: E402

import torch_select_forests as forests  # noqa: E402
from torch_select_forests import (  # noqa: E402
    PARAMS_BIG, SHAPES_BIG, forest, truncation_forest)

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
GAP = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dense_cluster():
    return forests.dense_cluster()


def counted(fn):
    """(fn(), the program's counters it added)."""
    c0 = timing.counters()
    out = fn()
    c1 = timing.counters()
    return out, {k: c1[k] - c0[k] for k in c1}


def certified(res, st, shapes, params):
    """The oracle's optimum; asserts ``res`` feasible, within GAP of it,
    with a sound bound and a closed certificate."""
    _, opt, proven = oracle.milp_select_oracle(st, shapes, params)
    assert proven
    obj, bound = float(res.obj), float(res.bound)
    assert bool(res.feasible)
    assert obj - opt <= GAP * max(1.0, abs(opt)), (obj, opt)
    assert bound <= opt + 1e-4 * max(1.0, abs(opt)), (bound, opt)
    assert obj - bound <= GAP * max(1.0, abs(obj)), (obj, bound)
    assert bool(tsel._selection_feasible(st, shapes, res.sel))
    lm = st.leaf_mask.numpy()
    assert all(lm[t, int(res.sel[t])]
               for t in np.nonzero(st.tgt_mask.numpy())[0])
    return opt


def test_a_tier2_truncation_is_finished():
    st, shapes, params = truncation_forest()
    hyb = tsel.select_hybrid(st, shapes, params, enum_cands=2)
    assert float(hyb.obj) - float(hyb.bound) > 0.5       # open
    res, n = counted(lambda: tsel.select(st, shapes, params,
                                         method="lagrangian", enum_cands=2))
    opt = certified(res, st, shapes, params)
    assert np.isclose(opt, 4.0, atol=1e-5)
    assert np.isclose(float(res.obj), 4.0, atol=1e-4)
    assert n["finish_entered"] == 1 and n["finish_iters"] >= 1
    assert n["finish_open"] == 0 and n["select_tier3"] == 0


def test_b_tier3_stopped_open_is_finished(dense_cluster):
    st = dense_cluster
    labels, _ = tsel.cluster(st, SHAPES_BIG)
    csize = tsel.cluster_sizes(labels, st.tgt_mask)
    assert int(csize.max()) > tsel.K_ENUM
    hyb = tsel.select_hybrid(st, SHAPES_BIG, PARAMS_BIG, iters=1)
    assert float(hyb.obj) - float(hyb.bound) \
        > tsel.FINISH_SHARE * PARAMS_BIG.selection_gap \
        * max(1.0, abs(float(hyb.obj)))
    res, n = counted(lambda: tsel.select(st, SHAPES_BIG, PARAMS_BIG,
                                         method="lagrangian", iters=1))
    certified(res, st, SHAPES_BIG, PARAMS_BIG)
    assert n["select_tier3"] == 1 and n["finish_entered"] == 1
    assert n["finish_iters"] >= 1 and n["finish_open"] == 0


def test_c_contested_overflow_is_finished(dense_cluster):
    st = dense_cluster
    hyb = tsel.select_hybrid(st, SHAPES_BIG, PARAMS_BIG, contested_cap=2)
    assert float(hyb.obj) - float(hyb.bound) \
        > tsel.FINISH_SHARE * PARAMS_BIG.selection_gap \
        * max(1.0, abs(float(hyb.obj)))
    res, n = counted(lambda: tsel.select(st, SHAPES_BIG, PARAMS_BIG,
                                         method="lagrangian",
                                         contested_cap=2))
    certified(res, st, SHAPES_BIG, PARAMS_BIG)
    assert n["finish_entered"] == 1 and n["finish_open"] == 0
    assert float(res.obj) <= float(hyb.obj) + 1e-5


def test_the_finish_opens_at_the_params_gap(dense_cluster):
    """``TrackerParams.selection_gap`` is the gap the finish certifies: one
    wider than the hybrid's own certificate leaves the hybrid's result as
    it is and enters no finish (test_b: the default's enters)."""
    st = dense_cluster
    hyb = tsel.select_hybrid(st, SHAPES_BIG, PARAMS_BIG, iters=1)
    rel = (float(hyb.obj) - float(hyb.bound)) / max(1.0, abs(float(hyb.obj)))
    assert rel > PARAMS_BIG.selection_gap
    wide = dataclasses.replace(PARAMS_BIG,
                               selection_gap=4 * rel / tsel.FINISH_SHARE)
    res, n = counted(lambda: tsel.select(st, SHAPES_BIG, wide,
                                         method="lagrangian", iters=1))
    assert n["finish_entered"] == 0 and n["finish_open"] == 0
    assert torch.equal(res.sel, hyb.sel)
    assert float(res.obj) == float(hyb.obj)
    assert float(res.bound) == float(hyb.bound)


def test_closed_certificate_skips_the_finish():
    """Tier 2 enumerates every leaf of this forest and closes it: ``select``
    returns the hybrid's result unchanged and enters no finish."""
    st, shapes, params = truncation_forest()
    hyb = tsel.select_hybrid(st, shapes, params)
    assert float(hyb.obj) == float(hyb.bound)
    res, n = counted(lambda: tsel.select(st, shapes, params,
                                         method="lagrangian"))
    assert torch.equal(res.sel, hyb.sel)
    assert float(res.obj) == float(hyb.obj)
    assert float(res.bound) == float(hyb.bound)
    # no finish; the forest's one cluster of two is tier 2's one bucket,
    # in tier 2's one solve
    assert n == dict(dict.fromkeys(timing.COUNTERS, 0), enum_buckets=1,
                     enum_calls=1)
    certified(res, st, shapes, params)


def test_batched_finish_per_scenario():
    """A batch of the open truncation forest and a closed one: each
    scenario's result is its own select's."""
    st, shapes, params = truncation_forest()
    pad = [-1] * 4
    closed = forest(shapes, params,
                    [[pad + [2, 1], pad + [3, 1]], [pad + [4, 1],
                                                     pad + [5, 2]]],
                    [[5.0, 6.0], [5.0, 7.0]], np.zeros(2, np.int32))
    both = type(st)(**{k: torch.stack([getattr(st, k), getattr(closed, k)])
                       for k in st.__dataclass_fields__})
    res = tsel.select(both, shapes, params, method="lagrangian",
                      enum_cands=2)
    for b, one in enumerate((st, closed)):
        r1 = tsel.select(one, shapes, params, method="lagrangian",
                         enum_cands=2)
        assert torch.equal(res.sel[b], r1.sel)
        assert np.isclose(float(res.obj[b]), float(r1.obj), atol=1e-5)
        assert np.isclose(float(res.bound[b]), float(r1.bound), atol=1e-5)


def test_batch_gives_each_scenario_its_own_node_budget(dense_cluster):
    """Under the contested-slot cap the dense cluster's search holds
    hundreds of open nodes at once; in a batch of 32 each scenario still
    keeps ``FINISH_NODES`` of them and finds what it finds alone."""
    st = dense_cluster
    one = tsel.select(st, SHAPES_BIG, PARAMS_BIG, method="lagrangian",
                      contested_cap=2)
    B = 32
    both = type(st)(**{k: torch.stack([getattr(st, k)] * B)
                       for k in st.__dataclass_fields__})
    res = tsel.select(both, SHAPES_BIG, PARAMS_BIG, method="lagrangian",
                      contested_cap=2)
    for b in range(B):
        assert torch.equal(res.sel[b], one.sel)
        assert float(res.obj[b]) == float(one.obj)
        assert float(res.bound[b]) == float(one.bound)
    certified(one, st, SHAPES_BIG, PARAMS_BIG)


@pytest.fixture(scope="module")
def coastal_small():
    """The coastal deployment's configuration and traffic at T=32, L=32:
    20 vessels on a disc cut so that the density of targets and clutter
    stays the source's."""
    sys.path.insert(0, str(BENCH))
    try:
        import stream as stream_mod
    finally:
        sys.path.remove(str(BENCH))
    cfg = json.loads((BENCH / "configs" / "coastal100.json").read_text())
    tr = json.loads((BENCH / "traffic" / "coastal_steady.json").read_text())
    s = 0.2
    cfg["shapes"].update(max_targets=32, max_meas=128, max_initiators=128,
                         max_prelim=16)
    p = dict(cfg["params"], position=tuple(cfg["params"]["position"]))
    p["radar_range"] *= s ** 0.5
    tr.update(n_targets=int(tr["n_targets"] * s),
              spawn_radius=tr["spawn_radius"] * s ** 0.5)
    params = TrackerParams(**p)
    return (TrackerShapes(**cfg["shapes"]), params,
            stream_mod.Stream(tr, dict(period=params.radar_period,
                                       range=params.radar_range), 77))


def test_coastal_stream_every_scan_exact(coastal_small, monkeypatch):
    shapes, params, stream = coastal_small
    grown = []
    real = tracker_mod.select

    def keep(state, *a, **kw):
        res = real(state, *a, **kw)
        grown.append((state, res))
        return res
    monkeypatch.setattr(tracker_mod, "select", keep)
    tr = Tracker(shapes, params, method="lagrangian", use_ais=False,
                 device="cpu")
    tr.pre_initialize(0.0, stream.initial[0])
    blk = stream.block(0)
    _, n = counted(lambda: [tr.add_measurement_list(t, z) for t, z in
                            zip(blk.times[:14], blk.z[:14])])
    assert len(grown) == 14 and n["finish_open"] == 0
    for st, res in grown:
        certified(res, st, shapes, params)

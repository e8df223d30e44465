"""The captured scan step on the card (core/graph.py, kernels/graph_flow.py,
csrc/graph_flow.cu) against the eager ``scan_step`` on the same card: the
radar-only ``'lagrangian'`` step, and the configurations captured since
(AIS fusion, AIS with the spatial pre-gate, ``'lagrangian_pure'`` and
``'greedy'``).

Every test needs a CUDA device and nvcc (the conditional nodes exist only
in a captured CUDA graph) and skips without one.  On the H100:
``python -m pytest --noconftest -m cuda tests/test_torch_graph_cuda.py``.

Integer and boolean outputs and states must be equal; float ones within
FLOAT_ATOL / FLOAT_RTOL: the same kernels run in the same order, but the
cuBLAS products of ``cluster`` run on a body stream with a workspace of
their own, where cuBLAS may pick another reduction split.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pymht_tpu_torch import Tracker, sync  # noqa: E402
from pymht_tpu_torch.core import graph as graph_mod  # noqa: E402
from pymht_tpu_torch.core.tracker import (  # noqa: E402
    StepOutputs, outputs_to_host, scan_many, scan_step)
from pymht_tpu_torch.ops import gate_kernel as gk  # noqa: E402
from pymht_tpu_torch.utils import scenes  # noqa: E402

FLOAT_ATOL, FLOAT_RTOL = 1e-6, 1e-6
N_TARGETS, M, N_SCANS = 60, 128, 8


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (conditional graph nodes have no "
                    "CPU mode)")
    return torch.device("cuda")


def _scene():
    return scenes.bench_scene(n_targets=N_TARGETS, n_scans=N_SCANS,
                              max_meas=M)


def _tracker(scene, **kw):
    shapes, params, scans, _, seeds = scene
    tr = Tracker(shapes, params, method="lagrangian", use_ais=False,
                 device="cuda", **kw)
    tr.pre_initialize(scans[0].time - params.radar_period, seeds)
    return tr


def _eager_step(tr, s, **kw):
    """One scan through the plain ``scan_step`` on the tracker's state."""
    scan, _ = tr._unpack_inputs(tr._pack_inputs(float(s.time) - tr.t0,
                                                s.measurements))
    tr.state, tr.init_state, out = scan_step(
        tr.state, tr.init_state, scan, None, tr.shapes, tr.params,
        method="lagrangian", use_ais=False, prune_similar=tr.prune_similar,
        **kw)
    return outputs_to_host(out)


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind == "f":
        np.testing.assert_allclose(a, b, atol=FLOAT_ATOL, rtol=FLOAT_RTOL,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(a, b, err_msg=what)


def _same_state(a, b, what):
    for f in a.__dataclass_fields__:
        _same(getattr(a, f).cpu(), getattr(b, f).cpu(), f"{what}.{f}")


@pytest.mark.cuda
def test_loop_and_branch_nodes_test_on_the_device(card):
    """A WHILE node whose exit and a nested IF whose branch change with
    the data of each replay, a fixed trip and an untested first body,
    each against the same function run eagerly."""
    from pymht_tpu_torch.kernels import graph_flow

    def fn(n):
        def body(c, _):
            x, acc = c
            acc = sync.cond(x % 3 == 0, lambda: acc + 10 * x,
                            lambda: acc - x)
            return x + 1, acc
        x, acc = sync.while_loop(lambda c: c[0] < n, body,
                                 (torch.zeros_like(n), torch.zeros_like(n)),
                                 max_iters=50)
        fixed = sync.while_loop(None, lambda c, _: (c[0] * 2,),
                                (torch.ones_like(n),), max_iters=5)[0]
        once = sync.while_loop(lambda c: c[0] < 0, lambda c, _: (c[0] + 7,),
                               (n.clone(),), test_first=False)[0]
        return torch.stack([x, acc, fixed, once])

    n = torch.zeros((), dtype=torch.int64, device=card)
    g = torch.cuda.CUDAGraph()
    with graph_flow.capture(g):
        out = fn(n)
    for v in (0, 1, 7, 20, 80):
        n.fill_(v)
        reads = sync.count
        g.replay()
        got = out.cpu()
        assert sync.count == reads
        want = fn(torch.tensor(v, device=card)).cpu()
        assert torch.equal(got, want), (v, got, want)


@pytest.mark.cuda
def test_graphed_tracker_equals_eager_scan_step(card):
    """The graphed Tracker against the plain scan_step on the card, scan
    by scan: outputs, selected leaves and both states; one replay, at
    most one host read and one K1 launch per scan."""
    scene = _scene()
    tr, ref = _tracker(scene), _tracker(scene)
    for i, s in enumerate(scene[2]):
        reads, k1 = sync.count, gk.launches
        got = tr.add_measurement_list(s.time, s.measurements)
        assert sync.count - reads <= 1 and tr.host_syncs[-1] <= 1
        assert gk.launches - k1 == 1
        want = _eager_step(ref, s)
        for f in StepOutputs._fields:
            _same(getattr(got, f), getattr(want, f), f"scan {i} {f}")
        _same_state(tr.state, ref.state, f"scan {i} state")
        _same_state(tr.init_state, ref.init_state, f"scan {i} init_state")
    (g,) = tr._graphs.values()
    assert g.replays == len(scene[2])
    assert g.pool_bytes() > 0


@pytest.mark.cuda
def test_degrade_recaptures(card):
    scene = _scene()
    tr, ref = _tracker(scene), _tracker(scene)
    for i, s in enumerate(scene[2]):
        if i == 3:
            old = next(iter(tr._graphs.values()))
            assert tr.degrade() and ref.degrade()
            assert not tr._graphs
        got = tr.add_measurement_list(s.time, s.measurements)
        want = _eager_step(ref, s)
        for f in StepOutputs._fields:
            _same(getattr(got, f), getattr(want, f), f"scan {i} {f}")
        _same_state(tr.state, ref.state, f"scan {i} state")
    (g,) = tr._graphs.values()
    assert g is not old and g.shapes.max_leaves == old.shapes.max_leaves // 2


@pytest.mark.cuda
def test_scan_many_graphed_equals_stepped(card):
    scene = _scene()
    tr = _tracker(scene)
    scan_b, ais_b = tr.make_stream_inputs(scene[2])
    reads, k1 = sync.count, gk.launches
    st, ist, outs = scan_many(tr.state, tr.init_state, scan_b, ais_b,
                              tr.shapes, tr.params, use_ais=False,
                              compute_clusters=True)
    assert sync.count == reads and gk.launches - k1 == len(scene[2])
    outs = outputs_to_host(outs)
    ref = _tracker(scene)
    for i, s in enumerate(scene[2]):
        want = _eager_step(ref, s)
        for f in StepOutputs._fields:
            _same(getattr(outs, f)[i], getattr(want, f), f"scan {i} {f}")
    _same_state(st, ref.state, "state")
    _same_state(ist, ref.init_state, "init_state")


@pytest.mark.cuda
def test_a_capture_that_cannot_work_raises(card):
    """A batched loop (two scenarios) under capture raises, and a
    batched forest never reaches the graph."""
    from pymht_tpu_torch.kernels import graph_flow
    x = torch.zeros(2, dtype=torch.int64, device=card)
    g = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="batched"):
        with graph_flow.capture(g):
            sync.while_loop(lambda c: c[0] < 3, lambda c, _: (c[0] + 1,),
                            (x,))
    shapes, params = _scene()[:2]
    from pymht_tpu_torch.core.state import empty_state
    st = empty_state(shapes, params, card, batch=(2,))
    assert not graph_mod.graphable(st, "lagrangian")
    st1 = empty_state(shapes, params, card)
    assert graph_mod.graphable(st1, "greedy")
    assert not graph_mod.graphable(st1, "ipm")
    assert not graph_mod.graphable(st1, "lagrangian", dict(iters=5))


# ----------------------------------------------------------------------
# the other captured configurations: AIS, the pre-gate, the other methods
# ----------------------------------------------------------------------

CONFIGS = {
    "ais": dict(method="lagrangian", use_ais=True, km=0),
    "ais_pregate": dict(method="lagrangian", use_ais=True, km=32),
    "pure": dict(method="lagrangian_pure", use_ais=False, km=0),
    "greedy": dict(method="greedy", use_ais=False, km=0),
}


def _config_scene(name):
    """(shapes, params, scans, AIS groups, seeds, MMSIs) of a
    configuration: the AIS scene cut as the radar one, or the radar one."""
    cfg = CONFIGS[name]
    if cfg["use_ais"]:
        shapes, params, scans, groups, _, seeds, mmsi = scenes.bench_scene_ais(
            n_targets=N_TARGETS, n_scans=N_SCANS, max_meas=M,
            radar_cand_width=cfg["km"])
        return shapes, params, scans, groups, seeds, mmsi
    shapes, params, scans, _, seeds = _scene()
    return shapes, params, scans, [], seeds, None


def _config_tracker(name, scene):
    shapes, params, scans, _, seeds, mmsi = scene
    cfg = CONFIGS[name]
    tr = Tracker(shapes, params, method=cfg["method"],
                 use_ais=cfg["use_ais"], device="cuda")
    tr.pre_initialize(scans[0].time - params.radar_period, seeds, mmsi=mmsi)
    return tr


def _messages(scene, i):
    groups = scene[3]
    return groups[i] if i < len(groups) else []


def _eager_config_step(tr, s, msgs):
    """One scan (with its AIS messages) through the plain ``scan_step``
    on the tracker's state, with the tracker's method and flags."""
    scan, ais = tr._unpack_inputs(tr._pack_inputs(float(s.time) - tr.t0,
                                                  s.measurements, msgs))
    tr.state, tr.init_state, out = scan_step(
        tr.state, tr.init_state, scan, ais, tr.shapes, tr.params,
        method=tr.method, use_ais=tr.use_ais,
        ais_initialization=tr.ais_initialization,
        prune_similar=tr.prune_similar)
    return outputs_to_host(out)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_graphed_config_equals_eager_scan_step(card, name):
    """The graphed Tracker of each configuration against the plain
    scan_step on the card, scan by scan: outputs, selected leaves and
    both states; one replay, at most one host read and one K1 launch per
    scan (through the per-target entry point when pre-gated)."""
    scene = _config_scene(name)
    tr, ref = _config_tracker(name, scene), _config_tracker(name, scene)
    pregate = CONFIGS[name]["km"] > 0
    fused = 0
    for i, s in enumerate(scene[2]):
        reads, k1, k1p = sync.count, gk.launches, gk.launches_pregate
        got = tr.add_measurement_list(s.time, s.measurements,
                                      _messages(scene, i))
        assert sync.count - reads <= 1 and tr.host_syncs[-1] <= 1
        assert gk.launches - k1 == 1
        assert gk.launches_pregate - k1p == int(pregate)
        want = _eager_config_step(ref, s, _messages(scene, i))
        for f in StepOutputs._fields:
            _same(getattr(got, f), getattr(want, f), f"{name} scan {i} {f}")
        _same_state(tr.state, ref.state, f"{name} scan {i} state")
        _same_state(tr.init_state, ref.init_state,
                    f"{name} scan {i} init_state")
        fused += int((got.sel_hist_mmsi[got.track_mask] != 0).sum())
    (g,) = tr._graphs.values()
    assert g.replays == len(scene[2]) and g.pool_bytes() > 0
    assert g.flags["method"] == CONFIGS[name]["method"]
    assert (g.ais is not None) == CONFIGS[name]["use_ais"]
    if CONFIGS[name]["use_ais"]:
        assert fused > 0              # the AIS labels went through the graph


@pytest.mark.cuda
def test_ais_stream_and_scan_many_equal_stepped_graph(card):
    """``Tracker.stream`` and the module ``scan_many`` with AIS against
    the stepped graphed Tracker: one replay per scan, no host read in
    ``scan_many``, one fetch per streamed chunk."""
    scene = _config_scene("ais")
    scans = scene[2]
    groups = [_messages(scene, i) for i in range(len(scans))]
    stepped = _config_tracker("ais", scene)
    want = [stepped.add_measurement_list(s.time, s.measurements, groups[i])
            for i, s in enumerate(scans)]
    streamed = _config_tracker("ais", scene)
    k1 = gk.launches
    chunks = streamed.stream(scans, groups, chunk=4, compute_clusters=True)
    assert gk.launches - k1 == len(scans)
    assert [c[1] for c in streamed.chunk_syncs] == [1] * len(chunks)
    got = [StepOutputs(*(f[j] for f in c)) for c in chunks
           for j in range(len(c.track_mask))]
    for i, (a, b) in enumerate(zip(got, want)):
        for f in StepOutputs._fields:
            _same(getattr(a, f), getattr(b, f), f"stream scan {i} {f}")
    _same_state(streamed.state, stepped.state, "stream state")
    _same_state(streamed.init_state, stepped.init_state, "stream init_state")
    (g,) = streamed._graphs.values()
    assert g.replays == len(scans) and g.ais is not None

    tr = _config_tracker("ais", scene)
    scan_b, ais_b = tr.make_stream_inputs(scans, groups)
    reads, k1 = sync.count, gk.launches
    st, ist, outs = scan_many(tr.state, tr.init_state, scan_b, ais_b,
                              tr.shapes, tr.params, use_ais=True,
                              compute_clusters=True)
    assert sync.count == reads and gk.launches - k1 == len(scans)
    outs = outputs_to_host(outs)
    for i, b in enumerate(want):
        for f in StepOutputs._fields:
            _same(getattr(outs, f)[i], getattr(b, f), f"scan_many {i} {f}")
    _same_state(st, stepped.state, "scan_many state")
    _same_state(ist, stepped.init_state, "scan_many init_state")


@pytest.mark.cuda
def test_ais_degrade_recaptures_at_the_new_fusion_width(card):
    scene = _config_scene("ais")
    tr, ref = _config_tracker("ais", scene), _config_tracker("ais", scene)
    for i, s in enumerate(scene[2]):
        if i == 3:
            old = next(iter(tr._graphs.values()))
            assert tr.degrade(ais_per_leaf=1)
            assert ref.degrade(ais_per_leaf=1)
            assert not tr._graphs
        got = tr.add_measurement_list(s.time, s.measurements,
                                      _messages(scene, i))
        want = _eager_config_step(ref, s, _messages(scene, i))
        for f in StepOutputs._fields:
            _same(getattr(got, f), getattr(want, f), f"scan {i} {f}")
        _same_state(tr.state, ref.state, f"scan {i} state")
    (g,) = tr._graphs.values()
    assert g is not old and g.shapes.ais_fuse_width == 1
    assert g.shapes.max_leaves == old.shapes.max_leaves // 2
    assert g.replays == len(scene[2]) - 3


@pytest.mark.cuda
def test_methods_and_ais_flags_get_graphs_of_their_own(card):
    """``scan_many``'s module cache hands each method and AIS flag its own
    graph: the key names them."""
    scene = _config_scene("ais")
    tr = _config_tracker("ais", scene)
    scan_b, ais_b = tr.make_stream_inputs(scene[2][:2],
                                          [_messages(scene, i)
                                           for i in range(2)])
    graph_mod.GRAPHS.clear()
    for method in ("lagrangian", "greedy"):
        for init in (True, False):
            scan_many(tr.state, tr.init_state, scan_b, ais_b, tr.shapes,
                      tr.params, method=method, use_ais=True,
                      ais_initialization=init)
    flags = [dict(k[3]) for k in graph_mod.GRAPHS]
    assert len(flags) == graph_mod.GRAPHS_KEPT == 4
    assert {(f["method"], f["ais_initialization"]) for f in flags} == {
        ("lagrangian", True), ("lagrangian", False), ("greedy", True),
        ("greedy", False)}
    graph_mod.GRAPHS.clear()

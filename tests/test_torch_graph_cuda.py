"""The captured scan step on the card (core/graph.py, kernels/graph_flow.py,
csrc/graph_flow.cu) against the eager ``scan_step`` on the same card: the
radar-only ``'lagrangian'`` step, the configurations captured since (AIS
fusion, AIS with the spatial pre-gate, ``'lagrangian_pure'`` and
``'greedy'``), and each of them on a batch of scenarios
(``parallel/scenario.make_batched_step``, ``parallel/montecarlo.
run_batch``).

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
    """A loop or branch under a capture begun outside
    ``graph_flow.capture`` raises, and ``'ipm'``, ``select_kw`` and a
    second batch axis never reach the graph."""
    x = torch.zeros(2, dtype=torch.int64, device=card)
    g = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="graph_flow.capture"):
        with torch.cuda.graph(g):
            sync.while_loop(lambda c: c[0] < 3, lambda c, _: (c[0] + 1,),
                            (x,))
    shapes, params = _scene()[:2]
    from pymht_tpu_torch.core.state import empty_state
    st = empty_state(shapes, params, card, batch=(2,))
    assert graph_mod.graphable(st, "lagrangian")
    assert not graph_mod.graphable(st, "ipm")
    st2 = empty_state(shapes, params, card, batch=(2, 2))
    assert not graph_mod.graphable(st2, "lagrangian")
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


# ----------------------------------------------------------------------
# batches: the batched step and run_batch, graphed against eager
# ----------------------------------------------------------------------

BATCH, BATCH_SCANS = 3, 4


@pytest.mark.cuda
def test_batched_loop_and_branch_nodes_test_on_the_device(card):
    """A batched WHILE node (per-scenario exits, a finished scenario keeps
    its carry), a nested batched IF whose scenarios part, and an untested
    first body that runs for every scenario, against the same function
    run eagerly, on data that changes with each replay."""
    from pymht_tpu_torch.kernels import graph_flow

    def fn(n):
        def body(c, active):
            x, acc = c
            acc = sync.cond((x % 3 == 0) & active, lambda: acc + 10 * x,
                            lambda: acc - x)
            return x + 1, acc
        x, acc = sync.while_loop(lambda c: c[0] < n, body,
                                 (torch.zeros_like(n), torch.zeros_like(n)),
                                 max_iters=50)
        once = sync.while_loop(lambda c: c[0] < 0, lambda c, _: (c[0] + 7,),
                               (n.clone(),), test_first=False)[0]
        return torch.stack([x, acc, once])

    n = torch.zeros(4, dtype=torch.int64, device=card)
    g = torch.cuda.CUDAGraph()
    with graph_flow.capture(g):
        out = fn(n)
    for v in ([0, 0, 0, 0], [1, 7, 0, 3], [20, 80, 5, 5], [3, 2, 1, 60]):
        n.copy_(torch.tensor(v))
        reads = sync.count
        g.replay()
        got = out.cpu()
        assert sync.count == reads
        want = fn(torch.tensor(v, device=card)).cpu()
        assert torch.equal(got, want), (v, got, want)


BATCH_CONFIGS = {
    "radar": dict(method="lagrangian", use_ais=False, km=0),
    "ais": dict(method="lagrangian", use_ais=True, km=0),
    "ais_pregate": dict(method="lagrangian", use_ais=True, km=32),
    "radar_pregate": dict(method="lagrangian", use_ais=False, km=32),
    "pure": dict(method="lagrangian_pure", use_ais=False, km=0),
    "greedy": dict(method="greedy", use_ais=False, km=0),
}


def _batch_scene(name):
    """B draws of the configuration's scene (the small scenes above, seeds
    1234 + b radar only, 4321 + b with AIS) as a ``BatchScene`` on the
    card."""
    import dataclasses
    cfg = BATCH_CONFIGS[name]
    if cfg["use_ais"]:
        return scenes.bench_ais_batch(BATCH, n_targets=N_TARGETS,
                                      n_scans=BATCH_SCANS - 1, max_meas=M,
                                      radar_cand_width=cfg["km"],
                                      device="cuda")
    draws = []
    for b in range(BATCH):
        shapes, params, scans, sim_list, seeds = scenes.bench_scene(
            n_targets=N_TARGETS, n_scans=BATCH_SCANS - 1, max_meas=M,
            seed=1234 + b)
        draws.append((scans, [], seeds, None, sim_list))
    shapes = dataclasses.replace(shapes, radar_cand_width=cfg["km"])
    return scenes.batch_scene(shapes, params, draws, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(BATCH_CONFIGS))
def test_graphed_batched_step_equals_eager(card, name):
    """``make_batched_step`` on the card replays one graph per batched
    scan, with no host read and one K1 launch, and equals the plain
    ``scan_step`` on the batched tensors: outputs and both states."""
    from pymht_tpu_torch.parallel.scenario import make_batched_step
    cfg = BATCH_CONFIGS[name]
    bs = _batch_scene(name)
    step = make_batched_step(bs.shapes, bs.params, method=cfg["method"],
                             use_ais=cfg["use_ais"])
    st, ist = bs.state, bs.init_state
    ref, ref_i = bs.state, bs.init_state
    for s in range(BATCH_SCANS):
        scan, ais = bs.scan(s)
        reads, k1, k1p = sync.count, gk.launches, gk.launches_pregate
        st, ist, got = step(st, ist, scan, ais)
        assert sync.count == reads
        assert gk.launches - k1 == 1 and gk.launches_pregate - k1p == 1
        ref, ref_i, want = scan_step(ref, ref_i, scan, ais, bs.shapes,
                                     bs.params, method=cfg["method"],
                                     use_ais=cfg["use_ais"])
        for f in StepOutputs._fields:
            _same(getattr(got, f).cpu(), getattr(want, f).cpu(),
                  f"{name} scan {s} {f}")
        _same_state(st, ref, f"{name} scan {s} state")
        _same_state(ist, ref_i, f"{name} scan {s} init_state")
    (g,) = step.graphs.values()
    assert g.replays == BATCH_SCANS and g.pool_bytes() > 0
    assert g.scan.z.shape[0] == BATCH


@pytest.mark.cuda
def test_run_batch_graphed_equals_eager(card):
    """``run_batch`` on the card (one replay per scan from the module's
    graphs, nothing read in between) against the eager batched step."""
    from pymht_tpu_torch.parallel import montecarlo as mc
    shapes, params, sc = scenes.mc_scene(batch=16, n_scans=6)
    sc = mc.McScenario(*(a.to(card) for a in sc))
    graph_mod.GRAPHS.clear()
    reads, k1 = sync.count, gk.launches
    st, xs, ms = mc.run_batch(sc, shapes, params)
    assert sync.count == reads and gk.launches - k1 == sc.z.shape[1]
    (g,) = graph_mod.GRAPHS.values()
    ref, ref_i = mc.initial_states(sc, shapes, params)
    for s in range(sc.z.shape[1]):
        ref, ref_i, out = scan_step(ref, ref_i, mc.scan_batch(sc, s), None,
                                    shapes, params, method="lagrangian",
                                    use_ais=False)
        _same(xs[s].cpu(), out.track_x.cpu(), f"scan {s} track_x")
        _same(ms[s].cpu(), out.track_mask.cpu(), f"scan {s} track_mask")
    _same_state(st, ref, "final state")
    _same_state(g.init_state, ref_i, "final initiator state")
    # a second run replays the same graph
    st2, xs2, ms2 = mc.run_batch(sc, shapes, params)
    assert list(graph_mod.GRAPHS.values()) == [g]
    assert torch.equal(ms2, ms) and torch.equal(xs2, xs)
    graph_mod.GRAPHS.clear()


@pytest.mark.cuda
def test_batch_of_one_equals_the_unbatched_graph(card):
    """The batched graph at B=1 against the unbatched graph
    (``scan_many``) on the same scene: labels and integer state equal,
    floats within the batch's tolerance (K1 runs through its per-target
    entry point in a batch, its shared-scan one alone)."""
    from pymht_tpu_torch.parallel.scenario import make_batched_step
    scene = _scene()
    tr = _tracker(scene)
    scan_b, ais_b = tr.make_stream_inputs(scene[2])
    st1 = graph_mod.clone_state(tr.state)
    ist1 = graph_mod.clone_state(tr.init_state)
    st, ist, outs = scan_many(tr.state, tr.init_state, scan_b, ais_b,
                              tr.shapes, tr.params, use_ais=False,
                              compute_clusters=True)
    step = make_batched_step(tr.shapes, tr.params, method="lagrangian")

    def one(tree):
        import dataclasses
        return tree.replace(**{f.name: getattr(tree, f.name)[None]
                               for f in dataclasses.fields(tree)})

    sb, isb = one(st1), one(ist1)
    for i in range(scan_b.z.shape[0]):
        scan = type(scan_b)(*(f[i][None] for f in scan_b))
        sb, isb, out = step(sb, isb, scan)
        for f in StepOutputs._fields:
            a, b = getattr(out, f)[0].cpu(), getattr(outs, f)[i].cpu()
            if a.dtype.is_floating_point:
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                           atol=2e-3, err_msg=f"scan {i} {f}")
            else:
                np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                              err_msg=f"scan {i} {f}")
    (g,) = step.graphs.values()
    assert g.replays == scan_b.z.shape[0]


@pytest.mark.cuda
def test_kept_batched_outputs_are_not_overwritten(card):
    """What ``make_batched_step`` returns is the caller's: the next step
    (a replay that writes over the graph's buffers) leaves it as it was."""
    from pymht_tpu_torch.parallel.scenario import make_batched_step
    bs = _batch_scene("radar")
    step = make_batched_step(bs.shapes, bs.params, method="lagrangian")
    st, ist, out = step(bs.state, bs.init_state, *bs.scan(0))
    kept = [t.clone() for t in (*out, st.leaf_x, st.tgt_mask, ist.p_x)]
    st2, ist2, out2 = step(st, ist, *bs.scan(1))
    after = (*out, st.leaf_x, st.tgt_mask, ist.p_x)
    assert all(torch.equal(a, b) for a, b in zip(kept, after))
    assert not torch.equal(out2.track_x, out.track_x)
    (g,) = step.graphs.values()
    assert all(not sync.same_storage(t, b) for t in (*out, *out2)
               for b in g.out)


@pytest.mark.cuda
def test_archive_update_overlaps_the_next_replay(card):
    """The swarm scene (T=1024, AIS, the pre-gate) graphed, with the
    tracer on: in each of three calls after the capturing one, the step's
    first stamp (the device's clock on the host's) comes before the end
    of the ``absorb`` span that follows the call's ``replay``, so the
    previous scan's archive update ran while the device ran this scan.
    The archive equals the one built by absorbing each call's returned
    outputs at once."""
    from types import SimpleNamespace
    from pymht_tpu_torch.utils import timing
    sw = scenes.swarm_scene(n_scans=4)
    timing.trace_on()
    try:
        tr = Tracker(sw.shapes, sw.params, method="lagrangian",
                     use_ais=True, device="cuda")
        tr.pre_initialize(sw.scans[0].time - sw.params.radar_period,
                          sw.seeds, mmsi=sw.mmsi)
        outs = []

        def call(i):
            s = sw.scans[i]
            msgs = sw.ais_groups[i] if i < len(sw.ais_groups) else []
            out = tr.add_measurement_list(s.time, s.measurements, msgs)
            outs.append(StepOutputs(*(f.copy() for f in out)))
        call(0)                     # captures the step
        torch.cuda.synchronize()
        timing.reset()
        for i in range(1, 4):
            call(i)
        trace = timing.read()
    finally:
        timing.trace_off()
        timing.reset()
    sp, st = trace["spans"], trace["stamps"]
    scans = np.nonzero((sp["name"] == "scan") & (sp["parent"] < 0))[0]
    assert len(scans) == 3 and st.shape == (3, 5)
    for k in scans:
        kids = np.nonzero(sp["parent"] == sp["id"][k])[0]
        names = [n for n in sp["name"][kids] if n != "gc"]
        assert names == ["pack", "upload", "replay", "absorb", "fetch"]
        rep, ab = (kids[list(sp["name"][kids]).index(n)]
                   for n in ("replay", "absorb"))
        first = st[sp["scan"][k] - trace["first_step"], 0]
        assert sp["end"][rep] <= sp["start"][ab]
        assert first < sp["end"][ab], (first - sp["end"][ab]) * 1e-6
    assert timing.summary(trace)["absorbs_behind_replay"] == 3
    ref = SimpleNamespace(shapes=tr.shapes, scan_times=list(tr.scan_times),
                          archives={}, terminated={}, init_P={})
    for k, o in enumerate(outs):
        Tracker._absorb_outputs(ref, o, n_scans=k + 1)
    for name in ("archives", "terminated", "init_P"):
        a, b = getattr(ref, name), getattr(tr, name)
        assert sorted(a) == sorted(b), name
        for tid in a:
            x, y = a[tid], b[tid]
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y, err_msg=name)
                continue
            assert (x.times, x.meas, x.mmsi, x.status) == \
                (y.times, y.meas, y.mmsi, y.status), (name, tid)
            np.testing.assert_array_equal(np.asarray(x.states),
                                          np.asarray(y.states))
    assert len(tr.archives) >= 900

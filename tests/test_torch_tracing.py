"""The port's tracer (``pymht_tpu_torch/utils/timing.py``): host spans,
the step's phase stamps, the condition kernel's runs per node, and what
``Tracker.runtime`` reads from them.

The CPU tests run a small copy of the benchmark's swarm configuration
(``benchmark/small.py``) on the plain twins, where a stamp is the host's
clock.  The tests marked ``cuda`` need a CUDA device and nvcc (the stamp
kernel and the conditional nodes run only on the card) and skip without
one; on the H100: ``python -m pytest --noconftest -m cuda
tests/test_torch_tracing.py``.
"""
import gc
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pymht_tpu_torch import Tracker, TrackerParams, TrackerShapes  # noqa: E402
from pymht_tpu_torch import sync  # noqa: E402
from pymht_tpu_torch.core import graph as graph_mod  # noqa: E402
from pymht_tpu_torch.core import select as tsel  # noqa: E402
from pymht_tpu_torch.core.state import (  # noqa: E402
    empty_state, state_from_numpy, state_to_numpy)
from pymht_tpu_torch.utils import scenes, timing  # noqa: E402

import torch_select_forests as forests  # noqa: E402

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
# a stepped call's children: the previous scan's archive update runs
# while the device runs this scan, before the fetch waits for it (none in
# a tracker's first call); a streamed chunk absorbs its own scans last
FIRST_CALL = ["pack", "upload", "replay", "fetch"]
CALL = ["pack", "upload", "replay", "absorb", "fetch"]
CHUNK = ["pack", "upload", "replay", "fetch", "absorb"]


@pytest.fixture
def tracer():
    """The process's tracer, on and empty, switched off afterwards."""
    timing.trace_on()
    timing.reset()
    yield timing.TRACE
    timing.trace_off()
    timing.reset()


@pytest.fixture(scope="module")
def swarm():
    """(shapes, params, method, the first block of scans, the initial
    targets) of the benchmark's swarm, cut for the CPU."""
    sys.path.insert(0, str(BENCH))
    try:
        from small import small
        import stream as stream_mod
    finally:
        sys.path.remove(str(BENCH))
    cfg, traffic = small("swarm1000")
    p = dict(cfg["params"])
    p["position"] = tuple(p["position"])
    params = TrackerParams(**p)
    st = stream_mod.Stream(traffic, dict(period=params.radar_period,
                                         range=params.radar_range),
                           2147483901)
    return (TrackerShapes(**cfg["shapes"]), params, cfg["method"],
            st.block(0), st.initial)


def _tracker(swarm):
    shapes, params, method, _, (x0, mmsi) = swarm
    tr = Tracker(shapes, params, method=method, use_ais=True, device="cpu")
    tr.pre_initialize(0.0, x0, mmsi=mmsi)
    return tr


def _step(tr, blk, n):
    for i in range(n):
        tr.add_measurement_list(blk.times[i], blk.z[i], blk.ais[i])


def _children(trace, i):
    sp = trace["spans"]
    k = np.nonzero(sp["id"] == i)[0][0]
    kids = np.nonzero((sp["parent"] == i) & (sp["name"] != "gc"))[0]
    return k, [sp["name"][j] for j in kids], kids


def test_tracing_off_records_nothing(swarm, monkeypatch):
    """Off (the default): no span, no stamp, no step counted; and a step
    graph's key tells tracing on from off."""
    torch.set_num_threads(1)
    timing.reset()
    assert not timing.tracing()

    def refuse(*a, **kw):
        raise AssertionError("a stamp with tracing off")
    monkeypatch.setattr(timing.TRACE, "stamp", refuse)
    monkeypatch.setattr(timing.TRACE, "begin", refuse)
    tr = _tracker(swarm)
    _step(tr, swarm[3], 2)
    assert timing.TRACE.n == 0 and timing.TRACE.steps == 0
    assert set(tr.get_runtime_average()) == {"Total"}
    shapes, params = swarm[0], swarm[1]
    st = empty_state(shapes, params, "cpu")
    flags = dict(method="lagrangian", use_ais=True, ais_initialization=True)
    off = graph_mod.graph_key(st, shapes, params, flags)
    monkeypatch.setattr(timing.TRACE, "on", True)
    assert graph_mod.graph_key(st, shapes, params, flags) != off


def test_spans_and_stamps_per_scan(swarm, tracer):
    """On: one ``scan`` span a call with the children pack, upload,
    replay, fetch in the first call and pack, upload, replay, absorb,
    fetch in every later one, in order, each with the scan's number; five
    stamps a step, in order, inside the step's ``replay`` span; the
    runtime log's phases are the stamps' differences."""
    torch.set_num_threads(1)
    tr = _tracker(swarm)
    n = 3
    _step(tr, swarm[3], n)
    trace = timing.read()
    sp = trace["spans"]
    scans = np.nonzero((sp["name"] == "scan") & (sp["parent"] < 0))[0]
    assert len(scans) == n
    assert trace["first_step"] == 0 and trace["stamps"].shape == (n, 5)
    for s, k in enumerate(scans):
        i = sp["id"][k]
        assert sp["scan"][k] == s
        _, names, kids = _children(trace, i)
        assert names == (CALL if s else FIRST_CALL)
        assert (sp["scan"][kids] == s).all()
        assert (np.diff(sp["start"][kids]) > 0).all()
        assert (sp["start"][kids] >= sp["start"][k]).all()
        assert (sp["end"][kids] <= sp["end"][k]).all()
        stamps = trace["stamps"][s]
        assert (np.diff(stamps) > 0).all()
        rep = kids[names.index("replay")]
        assert sp["start"][rep] <= stamps[0] and stamps[-1] <= sp["end"][rep]
    ph = np.diff(trace["stamps"], axis=1) * 1e-9
    avg = tr.get_runtime_average()
    for i, phase in enumerate(timing.STEP_PHASES):
        assert avg[timing.RUNTIME_OF[phase]] == pytest.approx(
            ph[:, i].mean(), rel=1e-9)
    assert len(tr.runtime.log["Process"]) == n      # read once, kept
    s = timing.summary(trace)
    assert s["scans"] == s["steps"] == n
    assert s["phase_sum_ms"] == pytest.approx(
        (trace["stamps"][:, -1] - trace["stamps"][:, 0]).mean() * 1e-6)
    assert (s["absorbs"], s["absorbs_behind_replay"],
            s["absorbs_on_read"]) == (n - 1, n - 1, 0)


@pytest.mark.parametrize("pipelined", [False, True])
def test_absorb_counts(swarm, tracer, pipelined):
    """``summary``'s counts of archive updates: every stepped call after
    the first absorbs the previous scan between its replay and its fetch
    (with ``pipeline_outputs`` the fetch of the previous scan comes
    first, so none is behind the replay); the last scan's absorb is run
    by the first read after the last call, outside any scan, and only
    once."""
    torch.set_num_threads(1)
    tr = _tracker(swarm)
    tr.pipeline_outputs = pipelined
    n = 3
    _step(tr, swarm[3], n)
    assert tr.archives          # the first read absorbs the last scan
    assert tr.get_tracks()      # the second finds nothing pending
    s = timing.summary(timing.read())
    assert (s["absorbs"], s["absorbs_behind_replay"],
            s["absorbs_on_read"]) == (n, 0 if pipelined else n - 1, 1)


def test_stream_chunk_spans(swarm, tracer):
    """``Tracker.stream``: one ``scan`` span per chunk, the same children,
    a stamped step per scan of the chunk."""
    torch.set_num_threads(1)
    tr = _tracker(swarm)
    blk = swarm[3]

    class Scan:
        def __init__(self, t, z):
            self.time, self.measurements = t, z

    scans = [Scan(blk.times[i], blk.z[i]) for i in range(4)]
    tr.stream(scans, [blk.ais[i] for i in range(4)], chunk=2)
    trace = timing.read()
    sp = trace["spans"]
    chunks = np.nonzero((sp["name"] == "scan") & (sp["parent"] < 0))[0]
    assert [sp["scan"][k] for k in chunks] == [0, 2]
    for k in chunks:
        assert _children(trace, sp["id"][k])[1] == CHUNK
    assert trace["steps"] == 4 and (np.diff(trace["stamps"]) > 0).all()


def test_loop_and_gc_spans(tracer):
    """Eagerly, with tracing on, each loop body and branch taken runs in a
    span of its name (``name=`` or its body's file:line); a collection
    is a ``gc`` span under the span open then."""
    n = torch.tensor(3)

    def body(c, _):
        return (c[0] + 1,)

    sync.while_loop(lambda c: c[0] < n, body, (torch.tensor(0),))
    sync.while_loop(lambda c: c[0] < n, body, (torch.tensor(0),),
                    name="counted")
    sync.cond(n > 1, lambda: n + 1, lambda: n - 1, name="branch")
    with timing.Span("outer"):
        gc.collect()
    sp = timing.read()["spans"]
    names = list(sp["name"])
    site = sync.node_name(body)
    assert site == f"test_torch_tracing.py:{body.__code__.co_firstlineno}"
    assert names.count(site) == 3 and names.count("counted") == 3
    assert names.count("branch") == 1
    outer = sp["id"][names.index("outer")]
    assert any(p == outer for nm, p in zip(names, sp["parent"])
               if nm == "gc")


def test_ring_keeps_the_newest():
    """A full ring keeps the newest spans and steps, in order."""
    t = timing.Tracer(spans=8, rows=4)
    t._alloc()
    t.on = True
    cpu = torch.device("cpu")
    for i in range(20):
        t.begin(f"s{i % 3}")
        if i % 5 == 0:
            t.stamp(0, cpu)
            for k in range(1, timing.N_STAMPS):
                t.stamp(k, cpu)
        t.end()
    for _ in range(3):
        for k in range(timing.N_STAMPS):
            t.stamp(k, cpu)
    r = t.read()
    sp = r["spans"]
    assert list(sp["id"]) == list(range(12, 20))
    assert list(sp["name"]) == [f"s{i % 3}" for i in range(12, 20)]
    assert (sp["parent"] == -1).all() and (sp["end"] >= sp["start"]).all()
    assert list(sp["scan"]) == [3, 3, 3, 3, 4, 4, 4, 4]
    assert r["steps"] == 7 and r["first_step"] == 3
    assert r["stamps"].shape == (4, timing.N_STAMPS)
    st = r["stamps"]
    assert (np.diff(st, axis=1) >= 0).all() and (np.diff(st[:, 0]) > 0).all()
    t.reset()                      # a replay binds the rows' device too
    t.replayed(cpu)
    assert t.device == cpu and t.steps == 1
    nested = timing.Tracer(spans=4, rows=2)
    nested._alloc()
    nested.on = True
    nested.begin("scan")
    for _ in range(5):             # the parent leaves the ring
        nested.begin("x")
        nested.end()
    nested.end()
    sp = nested.read()["spans"]
    assert list(sp["id"]) == [2, 3, 4, 5] and (sp["parent"] == 0).all()
    assert (sp["end"] >= sp["start"]).all()


def _synthetic():
    """Three scans of spans and stamps with known times (ms), the second
    left out as a profiled one."""
    ms = 10 ** 6
    names, start, end, parent, scan = [], [], [], [], []

    def put(nm, a, b, par, s):
        names.append(nm)
        start.append(a * ms)
        end.append(b * ms)
        parent.append(par)
        scan.append(s)
        return len(names) - 1

    stamps = []
    for s in range(3):
        t = 100 * s
        root = put("scan", t, t + 30, -1, s)
        put("pack", t + 1, t + 2.5, root, s)
        put("upload", t + 2.5, t + 3, root, s)
        rep = put("replay", t + 3, t + 4, root, s)
        put("capture", t + 3.1, t + 3.2, rep, s)
        put("fetch", t + 4, t + 20, root, s)
        ab = put("absorb", t + 20, t + 29 + s, root, s)
        put("gc", t + 21, t + 21.5 + s, ab, s)
        stamps.append([(t + 4 + x) * ms for x in (0, 6, 11, 11.5, 13 + s)])
    put("gc", 400, 405, -1, 3)             # outside any scan
    sp = dict(id=np.arange(len(names)), name=np.array(names, dtype=object),
              start=np.array(start, np.int64), end=np.array(end, np.int64),
              parent=np.array(parent), scan=np.array(scan))
    return dict(spans=sp, stamps=np.array(stamps, np.int64), first_step=0,
                steps=3, node_runs={"cluster": 6}, captures=1,
                pool_bytes=1 << 20, calibration=None, device="cuda:0")


@pytest.mark.parametrize("skip", [(), (1,)])
def test_summary_of_a_synthetic_trace(skip):
    """``timing.summary``: the phases per step, each span name per scan
    (the quantities behind grow_ms, select_ms, prune_ms, initiate_ms,
    pack_ms = pack + upload, absorb_ms and gc_ms_per_scan), skipping the
    scans named."""
    s = timing.summary(_synthetic(), skip=skip)
    kept = [k for k in range(3) if k not in skip]
    n = len(kept)
    assert s["steps"] == s["scans"] == n
    assert s["grow_ms"] == pytest.approx(6.0)
    assert s["select_ms"] == pytest.approx(5.0)
    assert s["prune_ms"] == pytest.approx(0.5)
    assert s["initiate_ms"] == pytest.approx(np.mean([1.5 + k
                                                      for k in kept]))
    assert s["phase_sum_ms"] == pytest.approx(np.mean([13 + k
                                                       for k in kept]))
    assert s["pack_ms"] + s["upload_ms"] == pytest.approx(2.0)
    assert s["absorb_ms"] == pytest.approx(np.mean([9 + k for k in kept]))
    assert s["gc_ms"] == pytest.approx(np.mean([0.5 + k for k in kept]))
    assert s["fetch_ms"] == pytest.approx(16.0)
    assert s["replay_ms"] == pytest.approx(1.0)
    assert s["capture_ms"] == pytest.approx(0.1)
    assert s["scan_ms"] == pytest.approx(30.0)
    # each absorb follows its scan's fetch; none ran on a read
    assert (s["absorbs"], s["absorbs_behind_replay"],
            s["absorbs_on_read"]) == (n, 0, 0)
    assert (s["captures"], s["pool_bytes"], s["node_runs"]) == (
        1, 1 << 20, {"cluster": 6})


# -- the exact finish's counters and loops -----------------------------------

@pytest.fixture(scope="module")
def finish_forests():
    """(a forest that needs the finish and reaches tier 3, its select's
    keywords; a closed forest, a forest that needs the finish without
    tier 3, and their shapes and parameters)."""
    open_ = (forests.dense_cluster(), forests.SHAPES_BIG,
             forests.PARAMS_BIG, dict(iters=1))
    trunc, shapes, params = forests.truncation_forest()
    return open_, (trunc, shapes, params, {}), (trunc, shapes, params,
                                                dict(enum_cands=2))


# the closed forest's counts: no finish, and its one cluster of two
# targets is tier 2's one non-empty bucket, in tier 2's one solve
CLOSED_COUNTS = dict(dict.fromkeys(timing.COUNTERS, 0), enum_buckets=1,
                     enum_calls=1)


def _select_counts(st, shapes, params, kw):
    c0 = timing.counters()
    res = tsel.select(st, shapes, params, method="lagrangian", **kw)
    c1 = timing.counters()
    return res, {k: c1[k] - c0[k] for k in timing.COUNTERS}


def test_finish_counters(finish_forests, monkeypatch):
    """The finish's four counters count on forests that need the finish
    and read zero on one that does not (where ``enum_buckets`` and
    ``enum_calls`` count its one small cluster and tier 2's one solve); a
    finish out of budget counts as open."""
    (dense, *rest_d), closed, trunc = finish_forests
    _, n = _select_counts(dense, *rest_d)
    assert n["select_tier3"] == n["finish_entered"] == 1
    assert n["finish_iters"] >= 1 and n["finish_open"] == 0
    _, n = _select_counts(*trunc)
    assert n["select_tier3"] == 0 and n["finish_entered"] == 1
    assert n["finish_iters"] >= 1 and n["finish_open"] == 0
    _, n = _select_counts(*closed)
    assert n == CLOSED_COUNTS
    monkeypatch.setattr(tsel, "FINISH_ITERS", 0)
    res, n = _select_counts(*trunc)
    assert n["finish_entered"] == n["finish_open"] == 1
    assert n["finish_iters"] == 0
    assert float(res.obj) - float(res.bound) > 1e-3


def test_finish_spans_and_summary(finish_forests, tracer):
    """Eagerly, with tracing on: the finish's branch is a ``finish`` span
    on every solved selection, its search a ``finish.search`` span per
    iteration only where it runs; ``summary`` gives the counters since
    the tracer's reset."""
    (dense, *rest_d), closed, _ = finish_forests
    _, n = _select_counts(dense, *rest_d)
    trace = timing.read()
    names = list(trace["spans"]["name"])
    assert names.count("finish") == 1
    assert names.count("finish.search") == n["finish_iters"] >= 1
    assert timing.summary(trace)["counters"] == n
    timing.reset()
    _select_counts(*closed)
    names = list(timing.read()["spans"]["name"])
    assert "finish.search" not in names
    assert timing.summary(timing.read())["counters"] == CLOSED_COUNTS


@pytest.mark.cuda
def test_card_finish_node_runs(card, finish_forests):
    """Captured on the card, the finish's IF node and its search loop count
    apart in ``node_runs()``: the loop runs on the forest that needs the
    finish, not on the closed one; the counters agree."""
    from pymht_tpu_torch.kernels import graph_flow
    (dense, *_), closed, trunc = finish_forests

    def replayed(st, shapes, params, kw):
        st = state_from_numpy(state_to_numpy(st), card)
        timing.ready(card)
        tsel.select(st, shapes, params, method="lagrangian", **kw)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with graph_flow.capture(g):
            res = tsel.select(st, shapes, params, method="lagrangian", **kw)
        torch.cuda.synchronize()
        graph_flow.reset_runs()
        c0 = timing.counters()
        g.replay()
        torch.cuda.synchronize()
        c1 = timing.counters()
        return res, graph_flow.node_runs(), {k: c1[k] - c0[k]
                                             for k in timing.COUNTERS}

    res, runs, n = replayed(*trunc)
    assert runs["finish"] == 2 and runs["finish.search"] >= 2
    assert n["finish_entered"] == 1 and n["finish_open"] == 0
    assert runs["finish.search"] == n["finish_iters"] + 1
    assert abs(float(res.obj) - 4.0) < 1e-4
    _, runs, n = replayed(*closed)
    assert runs.get("finish.search", 0) == 0
    assert n == CLOSED_COUNTS


# -- on the card ------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the stamp kernel and conditional "
                    "graph nodes have no CPU mode)")
    return torch.device("cuda")


def _card_run(n_scans, traced):
    """The bench scene stepped on the card through its graph, each
    ``StepGraph.__call__`` between CUDA events; (tracker, events ms)."""
    from pymht_tpu_torch.kernels import graph_flow
    shapes, params, scans, _, seeds = scenes.bench_scene(n_scans=n_scans)
    (timing.trace_on if traced else timing.trace_off)()
    tr = Tracker(shapes, params, method="lagrangian", use_ais=False,
                 device="cuda")
    tr.pre_initialize(scans[0].time - params.radar_period, seeds)
    tr.add_measurement_list(scans[0].time, scans[0].measurements)
    torch.cuda.synchronize()
    graph_flow.reset_runs()
    timing.reset()
    events, real = [], graph_mod.StepGraph.__call__

    def timed(g, *a, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real(g, *a, **kw)
        e1.record()
        events.append((e0, e1))
        return out
    graph_mod.StepGraph.__call__ = timed
    try:
        for s in scans[1:]:
            tr.add_measurement_list(s.time, s.measurements)
    finally:
        graph_mod.StepGraph.__call__ = real
    torch.cuda.synchronize()
    return tr, [a.elapsed_time(b) for a, b in events]


@pytest.mark.cuda
def test_card_stamps_and_node_runs(card):
    """Stamps monotone in every replay, calibrated inside their scan span;
    the four phases 95-100 % of the events around each call; the runs per
    node sum to the condition kernel's total."""
    from pymht_tpu_torch.kernels import graph_flow
    try:
        tr, ev = _card_run(13, traced=True)
        trace = timing.read()
        runs = graph_flow.runs()
    finally:
        timing.trace_off()
    st = trace["stamps"]
    assert st.shape == (len(ev), 5) and (np.diff(st, axis=1) > 0).all()
    ratio = (st[:, -1] - st[:, 0]) * 1e-6 / np.asarray(ev)
    assert ((0.95 <= ratio) & (ratio <= 1.0)).all(), ratio
    assert sum(trace["node_runs"].values()) == runs > 0
    sp = trace["spans"]
    scans = np.nonzero((sp["name"] == "scan") & (sp["parent"] < 0))[0]
    inside = [(sp["start"][k] <= st[s, 0]) & (st[s, -1] <= sp["end"][k])
              for s, k in zip(sp["scan"][scans], scans)]
    assert np.mean(inside) >= 0.99, inside
    assert set(tr.get_runtime_average()) >= {"Process", "Optim", "N-Prune",
                                             "Init"}


@pytest.mark.cuda
def test_card_untraced_launches_no_stamp(card):
    """With tracing off the graph holds no stamp: the device's row count
    and the host's steps stay 0 over a run."""
    timing.trace_on()           # the ring exists, so its count is readable
    timing.trace_off()
    _card_run(5, traced=False)
    dev = torch.device("cuda", torch.cuda.current_device())
    assert int(timing.TRACE.ring(dev)[0]) == 0 and timing.TRACE.steps == 0


@pytest.mark.cuda
def test_card_stamp_resolution(card):
    """Stamps back to back (one captured graph of 256 stamp nodes) never
    go back; prints the smallest non-zero gap between two and the step
    every gap is a multiple of (``%globaltimer``'s resolution)."""
    import math
    from pymht_tpu_torch.kernels import graph_flow
    ring = torch.zeros((256, 1), dtype=torch.int64, device=card)
    count = torch.zeros(1, dtype=torch.int64, device=card)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(256):
            graph_flow.stamp(ring, count, 0)
    g.replay()
    d = np.diff(ring[:, 0].cpu().numpy())
    assert int(count) == 256 and (d >= 0).all()
    print(f"globaltimer: back to back, smallest non-zero gap "
          f"{d[d > 0].min()} ns, median gap {np.median(d)} ns, every gap a "
          f"multiple of {math.gcd(*map(int, d))} ns")

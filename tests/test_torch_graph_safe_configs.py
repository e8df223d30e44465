"""Are the scan step's other captured configurations safe to capture as
one CUDA graph (core/graph.py)?  Checked on the CPU, where nothing is
captured and every loop and branch runs eagerly through ``sync``
(``tests/torch_graph_recorder.py``; ``tests/test_torch_graph_safe.py``
checks the radar-only ``'lagrangian'`` step the same way).

The configurations, each stepped by a ``Tracker`` on the CPU with torch
on one thread:

- ``ais``: bench.py's AIS scene cut to 60 targets, M=128, 4 scans,
  ``Tracker(method='lagrangian', use_ais=True)`` (AIS fusion in grow,
  the messages free for initiation, AIS seeding in the initiator);
- ``ais_pregate``: the same with the spatial pre-gate at
  ``radar_cand_width=32`` (K1's per-target entry point, its twin here);
- ``pure`` and ``greedy``: the radar-only scene of the radar-only test
  under ``'lagrangian_pure'`` and ``'greedy'``.

Each holds three properties, as in the radar-only test: no host read
outside ``sync``'s own; one op sequence per loop body, loop test and
branch, and per scan step; the selections (label histories, MMSIs and
track ids, digested; the objective and the cluster count of every scan)
equal to those of the tree before these configurations were captured.

Then the batched step (``parallel/scenario.make_batched_step``) on B=3
draws of those scenes under ``'lagrangian'``: ``batch``, the radar-only
scene (seeds 1234 + b), and ``batch_ais_pregate``, the AIS scene (seeds
4321 + b) with ``radar_cand_width=32``.  The same three properties, the
selections digested per scenario against the tree before batches were
captured; a batched loop or branch also makes one op sequence per site
for its selection by the batch's mask.

Then ``graph.graphable`` and the graph key: ``select_kw`` and ``'ipm'``
are refused, batched or not, and the key names the method, the AIS
flags and the batch's size.
"""
import collections

import pytest

torch = pytest.importorskip("torch")

from pymht_tpu_torch import Tracker  # noqa: E402
from pymht_tpu_torch.core import graph as graph_mod  # noqa: E402
from pymht_tpu_torch.core.state import empty_state  # noqa: E402
from pymht_tpu_torch.core.tracker import StepOutputs  # noqa: E402
from pymht_tpu_torch.parallel.scenario import make_batched_step  # noqa: E402
from pymht_tpu_torch.utils import scenes  # noqa: E402

from torch_graph_recorder import digest, recording  # noqa: E402

N_TARGETS, M, N_SCANS = 60, 128, 3      # N_SCANS + 1 scans are stepped

CONFIGS = {
    "ais": dict(method="lagrangian", use_ais=True, km=0),
    "ais_pregate": dict(method="lagrangian", use_ais=True, km=32),
    "pure": dict(method="lagrangian_pure", use_ais=False, km=0),
    "greedy": dict(method="greedy", use_ais=False, km=0),
}

# per configuration, per scan: (digest of sel_hist_meas, sel_hist_mmsi and
# track_id, sel_obj, n_clusters), from the tree before these
# configurations were captured (same scenes, one torch thread)
_AIS = [("fd669dfdd563ae64", -24.77819061279297, 57),
        ("945630c3558584ff", -29.341766357421875, 56),
        ("ee971c228ef1c7a9", -32.966793060302734, 47),
        ("ee4e4626119a9ca6", -35.32529067993164, 44)]
BEFORE = {
    "ais": _AIS,
    "ais_pregate": _AIS,     # every gated measurement among the 32 nearest
    "pure": [("3ab7d9f9e1b24911", -9.78929328918457, 58),
             ("bd143a32d0384a12", -13.879620552062988, 56),
             ("37318a5df03f59ec", -25.53978729248047, 36),
             ("fd9c6b97e96137b5", -26.357547760009766, 36)],
    "greedy": [("f6189026e993cf01", -9.971144676208496, 58),
               ("685a4e1f0bdfe6a5", -15.959489822387695, 56),
               ("429d5d77d5b9bafe", -27.350566864013672, 36),
               ("a50cb26f6d882d36", -27.410192489624023, 36)],
}


def step_config(name):
    """The configuration's scene stepped by a CPU Tracker under the
    recorder: (the recorder, the outputs of every scan)."""
    cfg = CONFIGS[name]
    with recording() as rec:
        if cfg["use_ais"]:
            shapes, params, scans, groups, _, seeds, mmsi = \
                scenes.bench_scene_ais(n_targets=N_TARGETS, n_scans=N_SCANS,
                                       max_meas=M, radar_cand_width=cfg["km"])
        else:
            shapes, params, scans, _, seeds = scenes.bench_scene(
                n_targets=N_TARGETS, n_scans=N_SCANS, max_meas=M)
            groups, mmsi = [], None
        tr = Tracker(shapes, params, method=cfg["method"],
                     use_ais=cfg["use_ais"], device="cpu")
        tr.pre_initialize(scans[0].time - params.radar_period, seeds,
                          mmsi=mmsi)
        outs = []
        with rec:
            for i, s in enumerate(scans):
                outs.append(tr.add_measurement_list(
                    s.time, s.measurements,
                    groups[i] if i < len(groups) else []))
    return rec, outs


_RUNS = {}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def stepped(request):
    if request.param not in _RUNS:
        _RUNS[request.param] = step_config(request.param)
    return (request.param, *_RUNS[request.param])


def test_no_host_read_outside_sync(stepped):
    _, rec, _ = stepped
    assert rec.reads == []


def test_every_body_and_branch_has_one_op_sequence(stepped):
    name, rec, _ = stepped
    varying = {key: len(seqs) for key, seqs in rec.seqs.items()
               if len(seqs) != 1}
    assert varying == {}
    kinds = collections.Counter(k for k, _ in rec.seqs)
    assert kinds["scan_step"] == 1
    bodies = [where for kind, where in rec.seqs if kind == "body"]
    # the initiator's auctions ran in every configuration
    assert sum(s.startswith("assignment.py") for s in bodies) >= 1
    if name == "pure":
        # the subgradient loop and its repair, and select's branch
        assert sum(s.startswith("select.py") for s in bodies) >= 2
        assert kinds["true"] >= 2 and kinds["false"] >= 2
    if name.startswith("ais"):
        # select's tiers ran: the scene conflicts
        assert sum(s.startswith("select.py") for s in bodies) >= 1


def test_selection_is_the_tree_befores(stepped):
    name, _, outs = stepped
    assert [digest(o) for o in outs] == BEFORE[name]


def test_ais_scenes_select_ais_associations():
    """The AIS runs use what the graph must capture: a selected track
    holds an MMSI in every scan after the first."""
    for name in ("ais", "ais_pregate"):
        if name not in _RUNS:
            _RUNS[name] = step_config(name)
        outs = _RUNS[name][1]
        assert all((o.sel_hist_mmsi[o.track_mask] != 0).any()
                   for o in outs[1:])


BATCH = 3
BATCH_CONFIGS = {
    "batch": dict(use_ais=False, km=0),
    "batch_ais_pregate": dict(use_ais=True, km=32),
}

# per configuration, per scan, per scenario: digests as ``BEFORE``'s, of
# the batch stepped eagerly on the tree before batches were captured
# (same scenes, one torch thread)
BATCH_BEFORE = {
    "batch": [
        [("3ab7d9f9e1b24911", -9.78929328918457, 58),
         ("2079093f99686306", -7.831917762756348, 59),
         ("6a6977be7f678451", -7.541505336761475, 59)],
        [("74c4f34f79fe70ab", -14.897287368774414, 56),
         ("3780f062d928852f", -12.995376586914062, 57),
         ("753c5ad410d9a071", -12.786073684692383, 57)],
        [("4e4ac5a699dec1d7", -26.557451248168945, 36),
         ("e546b88cf3968483", -32.993011474609375, 38),
         ("a0ed4d21f3c4ac3a", -32.165687561035156, 36)],
        [("bc73463407911b76", -27.677873611450195, 36),
         ("6f796cf3812d2d85", -28.25389862060547, 33),
         ("d52c37a61df6f018", -35.02923583984375, 35)]],
    "batch_ais_pregate": [
        [("fd669dfdd563ae64", -24.77819061279297, 57),
         ("fd38013f552ee7e3", -18.537464141845703, 60),
         ("e0df3f049d4d8158", -23.60991668701172, 59)],
        [("945630c3558584ff", -29.341766357421875, 56),
         ("173cc2fcf1d73f3c", -28.7208251953125, 59),
         ("4723811d0e548b1b", -30.89108657836914, 58)],
        [("ee971c228ef1c7a9", -32.96678924560547, 47),
         ("456edf844166d412", -36.33369064331055, 47),
         ("83d044a5427a4adf", -32.23747253417969, 48)],
        [("ee4e4626119a9ca6", -35.32529067993164, 44),
         ("ea615335742931ff", -37.39118576049805, 42),
         ("9ccdae6577ea158a", -35.777496337890625, 43)]],
}


def batch_scene_of(name):
    """B draws of the configuration's scene as a ``BatchScene`` on the
    CPU."""
    cfg = BATCH_CONFIGS[name]
    if cfg["use_ais"]:
        return scenes.bench_ais_batch(BATCH, n_targets=N_TARGETS,
                                      n_scans=N_SCANS, max_meas=M,
                                      radar_cand_width=cfg["km"],
                                      device="cpu")
    draws = []
    for b in range(BATCH):
        shapes, params, scans, sim_list, seeds = scenes.bench_scene(
            n_targets=N_TARGETS, n_scans=N_SCANS, max_meas=M, seed=1234 + b)
        draws.append((scans, [], seeds, None, sim_list))
    return scenes.batch_scene(shapes, params, draws, device="cpu")


def step_batch(name):
    """The configuration's batch stepped by ``make_batched_step`` on the
    CPU under the recorder: (the recorder, the outputs of every scan)."""
    cfg = BATCH_CONFIGS[name]
    with recording() as rec:
        bs = batch_scene_of(name)
        step = make_batched_step(bs.shapes, bs.params, method="lagrangian",
                                 use_ais=cfg["use_ais"])
        st, ist, outs = bs.state, bs.init_state, []
        with rec:
            for s in range(bs.scans.z.shape[1]):
                st, ist, out = step(st, ist, *bs.scan(s))
                # copied: an output may be a view of the recorder's
                # buffers, which the next scan writes over
                outs.append(StepOutputs(*(t.clone() for t in out)))
    return rec, outs


@pytest.fixture(scope="module", params=sorted(BATCH_CONFIGS))
def stepped_batch(request):
    if request.param not in _RUNS:
        _RUNS[request.param] = step_batch(request.param)
    return (request.param, *_RUNS[request.param])


def test_batch_makes_no_host_read_outside_sync(stepped_batch):
    _, rec, _ = stepped_batch
    assert rec.reads == []


def test_batch_body_and_branch_have_one_op_sequence(stepped_batch):
    name, rec, _ = stepped_batch
    varying = {key: len(seqs) for key, seqs in rec.seqs.items()
               if len(seqs) != 1}
    assert varying == {}
    kinds = collections.Counter(k for k, _ in rec.seqs)
    assert kinds["scan_step"] == 1
    bodies = [where for kind, where in rec.seqs if kind == "body"]
    # the initiator's auctions and select's loops ran, batched, and
    # their carries were selected by the batch's mask
    assert sum(s.startswith("assignment.py") for s in bodies) >= 1
    assert sum(s.startswith("select.py") for s in bodies) >= 2
    assert kinds["select"] >= 3


def test_batch_selection_is_the_tree_befores(stepped_batch):
    name, _, outs = stepped_batch
    got = [[digest(StepOutputs(*(f[b] for f in o))) for b in range(BATCH)]
           for o in outs]
    assert got == [[tuple(d) for d in row] for row in BATCH_BEFORE[name]]


def _small():
    shapes, params = scenes.bench_scene(n_targets=4, n_scans=1,
                                        max_meas=16)[:2]
    return shapes, params


class _OnCard:
    """A stand-in for a state on the card: ``graphable`` reads only
    ``leaf_x.is_cuda`` and ``hist_meas.dim()``."""

    def __init__(self, state):
        self.leaf_x = type("T", (), {"is_cuda": True})()
        self.hist_meas = state.hist_meas


@pytest.mark.parametrize("method,select_kw,batch,want", [
    ("lagrangian", None, (), True),
    ("lagrangian_pure", None, (), True),
    ("greedy", None, (), True),
    ("ipm", None, (), False),
    ("lagrangian", dict(iters=5), (), False),
    ("lagrangian", None, (2,), True),
    ("greedy", None, (2,), True),
    ("ipm", None, (2,), False),
])
def test_graphable(method, select_kw, batch, want):
    """On the card: the three methods, unbatched or with one scenario
    axis, without ``select_kw`` (AIS and the pre-gate are captured
    whatever their widths); never on the CPU."""
    shapes, params = _small()
    st = empty_state(shapes, params, "cpu", batch=batch)
    assert not graph_mod.graphable(st, method, select_kw)
    assert graph_mod.graphable(_OnCard(st), method, select_kw) is want


def test_graph_key_names_method_and_ais_flags():
    shapes, params = _small()
    st = empty_state(shapes, params, "cpu")

    def key(**flags):
        base = dict(method="lagrangian", use_ais=True,
                    ais_initialization=True, prune_similar=False)
        return graph_mod.graph_key(st, shapes, params, dict(base, **flags))

    keys = [key(), key(method="greedy"), key(method="lagrangian_pure"),
            key(use_ais=False), key(ais_initialization=False),
            key(prune_similar=True)]
    for B in (1, 2):      # a batch, and its size, have graphs of their own
        keys.append(graph_mod.graph_key(
            empty_state(shapes, params, "cpu", batch=(B,)), shapes, params,
            dict(method="lagrangian", use_ais=True, ais_initialization=True,
                 prune_similar=False)))
    assert len(set(keys)) == len(keys)
    assert key() == key()
    # the flags must name what the step would otherwise default
    with pytest.raises(ValueError, match="method"):
        graph_mod.graph_key(st, shapes, params, dict(use_ais=False))

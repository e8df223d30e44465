"""Is the radar-only ``'lagrangian'`` scan step safe to capture as one
CUDA graph (core/graph.py)?  Checked on the CPU, where nothing is
captured and every loop and branch runs eagerly through ``sync``.

bench.py's radar-only scene, cut to 60 targets, M=128 and 4 scans (the
smallest cut found where select leaves its fast path, tier 3 runs and
the repair loop runs), is stepped by ``Tracker(method='lagrangian',
use_ais=False)`` under a ``TorchDispatchMode`` that records every aten
operation, and so is one auction that its cap stops after a round (the
scene's auctions never reach the greedy completion or the augmenting
paths).  Three properties:

1. No host read happens outside the ``sync`` primitives' own reads
   (``flag`` and ``fetch``, which a captured graph replaces by
   conditional nodes and the one output transfer): no
   ``_local_scalar_dense`` (``.item()``, ``bool(t)``, a 0-d index),
   ``is_nonzero``, ``nonzero``, ``masked_select``, ``unique``, boolean
   mask indexing or ``repeat_interleave`` without ``output_size``; and
   no index assignment of a Python value (on the card a host-to-device
   copy, which a capture refuses).
2. Every loop body, loop test and branch makes the same aten operations
   in the same order every time it runs, across iterations and scans,
   and so does every scan step; a nested loop or branch counts as one
   token naming its site.  A capture records each body once and replays
   it, so this is what it needs.
3. The selections (the selected label histories and track ids, digested,
   the objective and the cluster count of every scan) are those of the
   tree before the device forms were added, on the same scene.
"""
import collections
import dataclasses
import hashlib
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from pymht_tpu_torch import Tracker, sync  # noqa: E402
from pymht_tpu_torch.core import graph as graph_mod  # noqa: E402
from pymht_tpu_torch.core import tracker as tracker_mod  # noqa: E402
from pymht_tpu_torch.ops.assignment import auction_assign  # noqa: E402
from pymht_tpu_torch.utils import scenes  # noqa: E402

N_TARGETS, M, N_SCANS = 60, 128, 3      # N_SCANS + 1 scans are stepped

# (digest of sel_hist_meas and track_id, sel_obj, n_clusters) per scan,
# from the tree before the device forms (same scene, one torch thread)
BEFORE = [("649f29d1ac4436a9", -9.78929328918457, 58),
          ("d9a90c2522954005", -14.897287368774414, 56),
          ("c2266018bd3242d8", -26.557451248168945, 36),
          ("0619ad1ca073bef3", -27.677873611450195, 36)]

_PUTS = ("aten.index_put", "aten.index_put_", "aten._index_put_impl_")
_READS = {"aten._local_scalar_dense", "aten.is_nonzero", "aten.nonzero",
          "aten.masked_select", "aten._unique", "aten._unique2",
          "aten.unique_dim", "aten.unique_consecutive", "aten.item"}


def _is_read(func, args, kwargs) -> bool:
    name = str(func.overloadpacket)
    if name in _READS:
        return True
    if name == "aten.index" or name in _PUTS:
        idx = args[1] if len(args) > 1 else kwargs.get("indices", ())
        return any(isinstance(t, torch.Tensor)
                   and t.dtype in (torch.bool, torch.uint8) for t in idx)
    if name == "aten.repeat_interleave":
        return kwargs.get("output_size") is None
    return False


class Recorder(TorchDispatchMode):
    """Aten operations (views and ``sync``'s own reads left out) on a
    stack of frames, one frame per body, test or branch being run; host
    reads outside ``sync``'s own."""

    def __init__(self):
        super().__init__()
        self.frames = [[]]
        self.seqs = collections.defaultdict(set)
        self.allowed = 0
        self.reads = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.allowed:         # sync's own read: no operation when captured
            return func(*args, **kwargs)
        if _is_read(func, args, kwargs):
            self.reads.append(str(func))
        if (str(func.overloadpacket) in _PUTS and len(args) > 2
                and getattr(args[2], "_from_python", False)):
            self.reads.append(f"{func} of a Python value")
        if not func.is_view:
            self.frames[-1].append(str(func))
        out = func(*args, **kwargs)
        if func is torch.ops.aten.lift_fresh.default:
            out._from_python = True      # a tensor made from a Python value
        return out

    def scoped(self, key, fn):
        """``fn`` with its operations recorded as one sequence of
        ``key``."""
        def run(*a, **kw):
            self.frames.append([])
            try:
                return fn(*a, **kw)
            finally:
                self.seqs[key].add(tuple(self.frames.pop()))
        return run


def _site(fn) -> str:
    code = fn.__code__
    return f"{code.co_filename.rsplit('/', 1)[-1]}:{code.co_firstlineno}"


@pytest.fixture(scope="module")
def stepped():
    """The scene stepped under the recorder, with ``sync``'s loops,
    branches and reads and the scan step wrapped."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    logging.disable(logging.WARNING)      # the scene overflows M: expected
    mp = pytest.MonkeyPatch()
    rec = Recorder()
    real_wl, real_cond = sync.while_loop, sync.cond
    real_flag, real_fetch = sync.flag, sync.fetch

    def allowed(fn):
        def run(t):
            rec.allowed += 1
            try:
                return fn(t)
            finally:
                rec.allowed -= 1
        return run

    def while_loop(cond, body, carry, max_iters=None, test_first=True):
        site = _site(body)
        rec.frames[-1].append(f"loop@{site}")
        if cond is not None:
            cond = rec.scoped(("test", site), cond)
        return real_wl(cond, rec.scoped(("body", site), body), carry,
                       max_iters, test_first)

    def cond(pred, true_fn, false_fn):
        rec.frames[-1].append(f"cond@{_site(true_fn)}")
        return real_cond(pred, rec.scoped(("true", _site(true_fn)), true_fn),
                         rec.scoped(("false", _site(false_fn)), false_fn))

    mp.setattr(sync, "while_loop", while_loop)
    mp.setattr(sync, "cond", cond)
    mp.setattr(sync, "flag", allowed(real_flag))
    mp.setattr(sync, "fetch", allowed(real_fetch))
    step = rec.scoped(("scan_step", ""), tracker_mod.scan_step)
    bufs = []

    def scan_step(state, init_state, *a, **kw):
        """The step on buffers laid out as the first scan's states, as a
        captured graph's static inputs are (core/graph.StepGraph.load):
        an einsum takes another path for other strides."""
        if not bufs:
            bufs.extend((graph_mod.clone_state(state),
                         graph_mod.clone_state(init_state)))
        for src, buf in zip((state, init_state), bufs):
            for f in dataclasses.fields(buf):
                getattr(buf, f.name).copy_(getattr(src, f.name))
        return step(*bufs, *a, **kw)

    mp.setattr(tracker_mod, "scan_step", scan_step)
    try:
        shapes, params, scans, _, seeds = scenes.bench_scene(
            n_targets=N_TARGETS, n_scans=N_SCANS, max_meas=M)
        tr = Tracker(shapes, params, method="lagrangian", use_ais=False,
                     device="cpu")
        tr.pre_initialize(scans[0].time - params.radar_period, seeds)
        outs = []
        # an auction its cap stops after one round, so that the greedy
        # completion, the augmentation and the path flip run as well
        rng = np.random.default_rng(3)
        cost = torch.from_numpy(rng.uniform(0, 10, (12, 10))
                                .astype(np.float32))
        valid = torch.from_numpy(rng.uniform(size=(12, 10)) < 0.35)
        with rec:
            for s in scans:
                outs.append(tr.add_measurement_list(s.time, s.measurements))
            auction_assign(cost, valid, max_iters=1)
    finally:
        mp.undo()
        logging.disable(logging.NOTSET)
        torch.set_num_threads(n)
    return rec, outs


def test_no_host_read_outside_sync(stepped):
    rec, _ = stepped
    assert rec.reads == []


def test_every_body_and_branch_has_one_op_sequence(stepped):
    rec, _ = stepped
    varying = {key: len(seqs) for key, seqs in rec.seqs.items()
               if len(seqs) != 1}
    assert varying == {}
    kinds = collections.Counter(k for k, _ in rec.seqs)
    # the path went through every kind of region, the solver included
    assert kinds["scan_step"] == 1 and kinds["body"] >= 8
    assert kinds["true"] >= 3 and kinds["false"] >= 3
    bodies = [site for kind, site in rec.seqs if kind == "body"]
    # cluster's propagation, the repair and the tier-3 Lagrangian; the
    # auction, greedy completion, augmentation, BFS and path flip
    assert sum(s.startswith("select.py") for s in bodies) >= 3
    assert sum(s.startswith("assignment.py") for s in bodies) >= 5


def test_selection_is_the_tree_befores(stepped):
    _, outs = stepped
    got = [(hashlib.sha256(np.ascontiguousarray(o.sel_hist_meas).tobytes()
                           + np.ascontiguousarray(o.track_id).tobytes())
            .hexdigest()[:16], float(o.sel_obj), int(o.n_clusters))
           for o in outs]
    assert got == BEFORE

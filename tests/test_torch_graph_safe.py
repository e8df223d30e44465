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
   ``is_nonzero``, ``nonzero``, ``masked_select``, ``unique``, ``isin``,
   boolean mask indexing or ``repeat_interleave`` without
   ``output_size``; and no index assignment of a Python value (on the
   card a host-to-device copy, which a capture refuses).  The recorder
   is ``tests/torch_graph_recorder.py``'s, shared with
   ``tests/test_torch_graph_safe_configs.py``.
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
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pymht_tpu_torch import Tracker  # noqa: E402
from pymht_tpu_torch.ops.assignment import auction_assign  # noqa: E402
from pymht_tpu_torch.utils import scenes  # noqa: E402

from torch_graph_recorder import recording  # noqa: E402

N_TARGETS, M, N_SCANS = 60, 128, 3      # N_SCANS + 1 scans are stepped

# (digest of sel_hist_meas and track_id, sel_obj, n_clusters) per scan,
# from the tree before the device forms (same scene, one torch thread)
BEFORE = [("649f29d1ac4436a9", -9.78929328918457, 58),
          ("d9a90c2522954005", -14.897287368774414, 56),
          ("c2266018bd3242d8", -26.557451248168945, 36),
          ("0619ad1ca073bef3", -27.677873611450195, 36)]


@pytest.fixture(scope="module")
def stepped():
    """The scene stepped under the recorder (tests/torch_graph_recorder.py:
    ``sync``'s loops, branches and reads and the scan step wrapped)."""
    with recording() as rec:
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

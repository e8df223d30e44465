"""The recorder behind the CPU checks that a configuration of the port's
scan step is safe to capture as one CUDA graph (core/graph.py):
``tests/test_torch_graph_safe.py`` (radar only, ``'lagrangian'``) and
``tests/test_torch_graph_safe_configs.py`` (AIS, the pre-gate,
``'lagrangian_pure'``, ``'greedy'``, a batch of scenarios).  Not
collected by pytest.

On the CPU nothing is captured: every loop and branch runs eagerly
through ``sync``.  Inside ``recording()`` the step runs in the form a
capture records it (``sync.captured`` holds, so a body tests on the
device what it would otherwise decide on the host), under a
``TorchDispatchMode`` that records every aten operation, one frame per
loop body, loop test and branch, and one per loop's or branch's
selection by the batch's mask (``sync.select``), each keyed by its site
and the sites it runs inside, and notes each host read made outside
``sync``'s own reads:

- ``_local_scalar_dense`` (``.item()``, ``bool(t)``, a 0-d index),
  ``is_nonzero``, ``nonzero``, ``masked_select``, ``unique``, boolean mask
  indexing, ``repeat_interleave`` without ``output_size``;
- ``isin``: one ``aten.isin`` here, but on a CUDA tensor with a large
  test set it takes the sorting path, whose ``_unique`` reads its output
  size on the host, and a capture fails there;
- an index assignment of a Python value (on the card a host-to-device
  copy, which a capture refuses).
"""
import collections
import contextlib
import dataclasses
import hashlib
import logging

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pymht_tpu_torch import sync
from pymht_tpu_torch.core import graph as graph_mod
from pymht_tpu_torch.core import tracker as tracker_mod
from pymht_tpu_torch.core.grow import AisBatch, Scan
from pymht_tpu_torch.parallel import scenario as scenario_mod

_PUTS = ("aten.index_put", "aten.index_put_", "aten._index_put_impl_")
_READS = {"aten._local_scalar_dense", "aten.is_nonzero", "aten.nonzero",
          "aten.masked_select", "aten._unique", "aten._unique2",
          "aten.unique_dim", "aten.unique_consecutive", "aten.item",
          "aten.isin"}


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


def site(fn) -> str:
    code = fn.__code__
    return f"{code.co_filename.rsplit('/', 1)[-1]}:{code.co_firstlineno}"


@contextlib.contextmanager
def recording():
    """Inside the block ``sync``'s loops, branches and reads and the scan
    step are wrapped for a ``Recorder``, which the block gets; torch runs
    on one thread.  Enter the recorder itself (``with rec:``) around the
    work to record."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    logging.disable(logging.WARNING)      # the scenes overflow M: expected
    mp = pytest.MonkeyPatch()
    rec = Recorder()
    real_wl, real_cond, real_select = sync.while_loop, sync.cond, sync.select
    real_flag, real_fetch, real_any = sync.flag, sync.fetch, sync.any_
    sites = []               # the loops and branches being run, innermost last

    def allowed(fn):
        def run(t):
            rec.allowed += 1
            try:
                return fn(t)
            finally:
                rec.allowed -= 1
        return run

    def placed(where=None):
        """A loop's or branch's site with the sites it runs inside: one
        node of the capture each (the same loop code entered from two
        places is two nodes)."""
        return " < ".join(([where] if where else []) + sites[::-1])

    def at(where, fn):
        def run(*a, **kw):
            sites.append(where)
            try:
                return fn(*a, **kw)
            finally:
                sites.pop()
        return run

    def while_loop(cond, body, carry, max_iters=None, test_first=True,
                   name=None):
        rec.frames[-1].append(f"loop@{site(body)}")
        where = placed(site(body))
        if cond is not None:
            cond = rec.scoped(("test", where), cond)
        return at(site(body), real_wl)(
            cond, rec.scoped(("body", where), body), carry, max_iters,
            test_first, name=name)

    def cond(pred, true_fn, false_fn, name=None):
        rec.frames[-1].append(f"cond@{site(true_fn)}")
        return at(site(true_fn), real_cond)(
            pred, rec.scoped(("true", placed(site(true_fn))), true_fn),
            rec.scoped(("false", placed(site(false_fn))), false_fn),
            name=name)

    def select(pred, a, b):
        """A batched loop's or branch's selection by its mask: one frame
        per site (the eager loop selects after every body, the eager
        branch only where the scenarios part), its recursion into
        sub-trees in the same frame."""
        if sites and sites[-1] == "select":
            return real_select(pred, a, b)
        return rec.scoped(("select", placed()), at("select", real_select))(
            pred, a, b)

    mp.setattr(sync, "while_loop", while_loop)
    mp.setattr(sync, "cond", cond)
    mp.setattr(sync, "select", select)
    mp.setattr(sync, "captured", lambda t: True)
    mp.setattr(sync, "flag", allowed(real_flag))
    mp.setattr(sync, "fetch", allowed(real_fetch))
    mp.setattr(sync, "any_", allowed(real_any))
    step = rec.scoped(("scan_step", ""), tracker_mod.scan_step)
    bufs = []

    def scan_step(state, init_state, scan, ais, *a, **kw):
        """The step on buffers laid out as the first scan's states, scan
        and AIS batch, as a captured graph's static inputs are
        (core/graph.StepGraph): an einsum takes another path for other
        strides."""
        if not bufs:
            bufs.extend((graph_mod.clone_state(state),
                         graph_mod.clone_state(init_state),
                         Scan(*(t.clone(memory_format=torch.contiguous_format)
                                for t in scan)),
                         None if ais is None
                         else AisBatch(*(t.clone() for t in ais))))
        for src, buf in zip((state, init_state), bufs):
            for f in dataclasses.fields(buf):
                getattr(buf, f.name).copy_(getattr(src, f.name))
        for src, buf in zip(scan, bufs[2]):
            buf.copy_(src)
        if ais is not None:
            for src, buf in zip(ais, bufs[3]):
                buf.copy_(src)
        return step(bufs[0], bufs[1], bufs[2], bufs[3], *a, **kw)

    mp.setattr(tracker_mod, "scan_step", scan_step)
    mp.setattr(scenario_mod, "scan_step", scan_step)
    try:
        yield rec
    finally:
        mp.undo()
        logging.disable(logging.NOTSET)
        torch.set_num_threads(n)


def digest(out) -> tuple:
    """(digest of the selected label histories and track ids, the
    objective, the cluster count) of one scan's outputs."""
    return (hashlib.sha256(np.ascontiguousarray(out.sel_hist_meas).tobytes()
                           + np.ascontiguousarray(out.sel_hist_mmsi).tobytes()
                           + np.ascontiguousarray(out.track_id).tobytes())
            .hexdigest()[:16], float(out.sel_obj), int(out.n_clusters))

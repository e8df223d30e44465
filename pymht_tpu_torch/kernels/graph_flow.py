"""Conditional nodes in a captured CUDA graph: the device form of
``sync.while_loop`` and ``sync.cond`` (binding of ``csrc/graph_flow.cu``).

``capture(graph)`` wraps ``torch.cuda.graph`` with a pool of its own and
records that pool, so that a node entered during the capture can route
its body's allocations there.  Inside it, ``while_node(pred, counter,
cap)`` and ``if_node(pred, negate)`` add a WHILE or IF node to the graph
being captured and make the node's body the current stream's capture:
what the ``with`` block launches runs on the device when the node's test
holds.  A WHILE body ends with ``node.next(pred)``.  The first test of
a node is captured just before it, by the condition kernel, from a device
bool; nothing is read on the host.  Nodes nest, one side stream per
depth.

The condition kernel runs only inside a replayed graph, so its count is
the device's: ``runs()`` reads how many times it ran since
``reset_runs()`` (one per node entered, one more per WHILE iteration),
and ``node_runs()`` the same count per node name (each node is given
one: ``sync`` names it by its body's source line or by the call site's
``name=``); the names' counts sum to ``runs()``.  ``stamp`` writes the
device's clock into a ring in device memory (``utils/timing``'s device
phase stamps): a launch, or under capture a kernel node.
A failed build, a node entered outside ``capture`` or a CUDA error
raises: nothing falls back to the host.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from . import build

_U64, _PTR, _INT = ctypes.c_ulonglong, ctypes.c_void_p, ctypes.c_int
_pool = None        # mempool id of the graph being captured by ``capture``
_streams = []       # one body stream per nesting depth
_depth = 0
SLOTS = 256         # node names counted apart (``kSlots`` in the source)
_slots = {}         # node name -> its slot of the device's per-node count


def lib() -> ctypes.CDLL:
    """Build (at first use, into build/) and load csrc/graph_flow.cu."""
    first = "graph_flow" not in build._loaded
    so = build.load("graph_flow")
    if first:
        so.graph_flow_begin.argtypes = ([_INT, _PTR, _PTR, _PTR, _INT, _PTR,
                                         _INT, _INT, _INT, _U64, _U64,
                                         ctypes.POINTER(_U64)])
        so.graph_flow_next.argtypes = [_PTR, _U64, _PTR, _PTR, _INT, _INT]
        so.graph_flow_end.argtypes = [_PTR]
        so.graph_flow_runs.argtypes = [ctypes.POINTER(_U64)]
        so.graph_flow_node_runs.argtypes = [ctypes.POINTER(_U64), _INT]
        so.graph_flow_reset_runs.argtypes = []
        so.graph_flow_stamp.argtypes = [_PTR, _PTR, _PTR, _INT, _INT, _INT]
        for f in ("graph_flow_begin", "graph_flow_next", "graph_flow_end",
                  "graph_flow_runs", "graph_flow_node_runs",
                  "graph_flow_reset_runs", "graph_flow_stamp"):
            getattr(so, f).restype = _INT
    return so


def _check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"graph_flow: {what} failed: " + {
            -1: "the stream is not capturing",
            -2: f"a node slot outside 0..{SLOTS - 1}"}.get(
                err, f"CUDA error {err}"))


def slot(name: str) -> int:
    """The slot of the device's per-node count that counts the nodes
    named ``name`` (given at first use; at most ``SLOTS`` names)."""
    s = _slots.get(name)
    if s is None:
        if len(_slots) >= SLOTS:
            raise RuntimeError(f"graph_flow: more than {SLOTS} node names")
        s = _slots[name] = len(_slots)
    return s


def _ptr(t):
    return None if t is None else t.data_ptr()


def capturing() -> bool:
    """Is a graph being captured by ``capture`` on this thread?"""
    return _pool is not None


@contextlib.contextmanager
def capture(graph: torch.cuda.CUDAGraph):
    """``torch.cuda.graph(graph)`` on a pool of its own, with the body
    streams of this capture's nodes made beforehand."""
    global _pool
    if _pool is not None:
        raise RuntimeError("graph_flow.capture: a capture is under way")
    lib()
    dev = torch.cuda.current_device()
    while len(_streams) < 8:
        _streams.append(torch.cuda.Stream(device=dev))
    pool = torch.cuda.graph_pool_handle()
    with torch.cuda.graph(graph, pool=pool, capture_error_mode="relaxed"):
        _pool = pool
        try:
            yield
        finally:
            _pool = None


class _Node:
    def __init__(self, handle: int, body: torch.cuda.Stream, counter,
                 cap: int, slot: int):
        self.handle, self.body, self.counter, self.cap, self.slot = (
            handle, body, counter, cap, slot)

    def next(self, pred=None):
        """End of a WHILE body: bump the trip counter and test ``pred``
        (None: true) and the cap for the next iteration."""
        _check(lib().graph_flow_next(self.body.cuda_stream, self.handle,
                                     _ptr(pred), _ptr(self.counter),
                                     self.cap, self.slot), "the loop test")


@contextlib.contextmanager
def _node(kind: int, pred, negate: bool, counter, cap: int, name: str):
    global _depth
    if _pool is None:
        raise RuntimeError("graph_flow: a conditional node needs a capture "
                           "begun by graph_flow.capture")
    for t, dt in ((pred, torch.bool), (counter, torch.int32)):
        if t is not None and (t.dtype != dt or t.numel() != 1
                              or not t.is_cuda):
            raise ValueError(f"graph_flow: a node's test needs a one-"
                             f"element {dt} on the card, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    outer = torch.cuda.current_stream()
    while len(_streams) <= _depth:
        _streams.append(torch.cuda.Stream(device=outer.device))
    body = _streams[_depth]
    handle = _U64()
    s = slot(name)
    _check(lib().graph_flow_begin(kind, outer.cuda_stream, body.cuda_stream,
                                  _ptr(pred), int(negate), _ptr(counter),
                                  cap, s, outer.device.index, _pool[0],
                                  _pool[1], ctypes.byref(handle)),
           "entering a conditional node")
    _depth += 1
    try:
        with torch.cuda.stream(body):
            yield _Node(handle.value, body, counter, cap, s)
    finally:
        _depth -= 1
        err = lib().graph_flow_end(body.cuda_stream)
    _check(err, "ending a conditional node's body")


def while_node(pred, counter, cap: int, name: str = "loop"):
    """A WHILE node: its body runs while ``pred`` (None: true) holds and
    fewer than ``cap`` bodies ran; ``counter`` (a 0-d int32 on the card)
    counts them.  The body ends with ``node.next(pred)``.  Its condition
    kernel's runs count under ``name`` in ``node_runs()``."""
    return _node(1, pred, False, counter, cap, name)


def if_node(pred, negate: bool = False, name: str = "branch"):
    """An IF node: its body runs when ``pred`` (``not pred`` with
    ``negate``) holds."""
    return _node(0, pred, negate, None, 0, name)


def runs() -> int:
    """Condition kernels the device ran since ``reset_runs()`` (waits for
    the device)."""
    out = _U64()
    _check(lib().graph_flow_runs(ctypes.byref(out)), "reading the runs")
    return out.value


def node_runs() -> dict:
    """``runs()`` per node name: {name: condition-kernel runs since
    ``reset_runs()``} (waits for the device)."""
    out = (_U64 * SLOTS)()
    _check(lib().graph_flow_node_runs(out, len(_slots)),
           "reading the runs per node")
    return {name: out[s] for name, s in _slots.items()}


def reset_runs():
    """Zero ``runs()`` and every count of ``node_runs()``."""
    _check(lib().graph_flow_reset_runs(), "resetting the runs")


def stamp(ring: torch.Tensor, row_count, k: int):
    """Write the device's clock (``%globaltimer``, ns) as stamp ``k`` of
    the current row of ``ring`` (int64 [rows, width] on the card), on the
    current stream; stamp 0 first advances ``row_count`` (a one-element
    int64 on the card).  Without ``row_count`` it writes ``ring[0, k]``."""
    for t, dim in ((ring, 2), (row_count, 1)):
        if t is not None and (t.dtype != torch.int64 or t.dim() != dim
                              or not t.is_cuda or not t.is_contiguous()):
            raise ValueError(f"graph_flow.stamp: needs a contiguous {dim}-d "
                             f"int64 on the card, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    rows, width = ring.shape
    if not 0 <= k < width:
        raise ValueError(f"graph_flow.stamp: stamp {k} of a row of {width}")
    _check(lib().graph_flow_stamp(torch.cuda.current_stream().cuda_stream,
                                  ring.data_ptr(), _ptr(row_count), rows,
                                  width, k), "a stamp")

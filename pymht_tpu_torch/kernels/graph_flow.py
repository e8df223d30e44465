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
``reset_runs()`` (one per node entered, one more per WHILE iteration).
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


def lib() -> ctypes.CDLL:
    """Build (at first use, into build/) and load csrc/graph_flow.cu."""
    first = "graph_flow" not in build._loaded
    so = build.load("graph_flow")
    if first:
        so.graph_flow_begin.argtypes = ([_INT, _PTR, _PTR, _PTR, _INT, _PTR,
                                         _INT, _INT, _U64, _U64,
                                         ctypes.POINTER(_U64)])
        so.graph_flow_next.argtypes = [_PTR, _U64, _PTR, _PTR, _INT]
        so.graph_flow_end.argtypes = [_PTR]
        so.graph_flow_runs.argtypes = [ctypes.POINTER(_U64)]
        so.graph_flow_reset_runs.argtypes = []
    return so


def _check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"graph_flow: {what} failed: "
                           + ("the stream is not capturing" if err == -1
                              else f"CUDA error {err}"))


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
                 cap: int):
        self.handle, self.body, self.counter, self.cap = (handle, body,
                                                          counter, cap)

    def next(self, pred=None):
        """End of a WHILE body: bump the trip counter and test ``pred``
        (None: true) and the cap for the next iteration."""
        _check(lib().graph_flow_next(self.body.cuda_stream, self.handle,
                                     _ptr(pred), _ptr(self.counter),
                                     self.cap), "the loop test")


@contextlib.contextmanager
def _node(kind: int, pred, negate: bool, counter, cap: int):
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
    _check(lib().graph_flow_begin(kind, outer.cuda_stream, body.cuda_stream,
                                  _ptr(pred), int(negate), _ptr(counter),
                                  cap, outer.device.index, _pool[0], _pool[1],
                                  ctypes.byref(handle)),
           "entering a conditional node")
    _depth += 1
    try:
        with torch.cuda.stream(body):
            yield _Node(handle.value, body, counter, cap)
    finally:
        _depth -= 1
        err = lib().graph_flow_end(body.cuda_stream)
    _check(err, "ending a conditional node's body")


def while_node(pred, counter, cap: int):
    """A WHILE node: its body runs while ``pred`` (None: true) holds and
    fewer than ``cap`` bodies ran; ``counter`` (a 0-d int32 on the card)
    counts them.  The body ends with ``node.next(pred)``."""
    return _node(1, pred, False, counter, cap)


def if_node(pred, negate: bool = False):
    """An IF node: its body runs when ``pred`` (``not pred`` with
    ``negate``) holds."""
    return _node(0, pred, negate, None, 0)


def runs() -> int:
    """Condition kernels the device ran since ``reset_runs()`` (waits for
    the device)."""
    out = _U64()
    _check(lib().graph_flow_runs(ctypes.byref(out)), "reading the runs")
    return out.value


def reset_runs():
    _check(lib().graph_flow_reset_runs(), "resetting the runs")

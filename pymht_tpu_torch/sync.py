"""Host reads of device values, counted, and the loops and branches
built on them.

Wherever the JAX package exits a ``lax.while_loop`` or takes a
``lax.cond`` branch on a device value, the port tests that value in one
of two ways.  Eagerly (on the CPU, or on the card outside a capture) it
reads the value on the host: on a CUDA tensor each read waits for the
device, so every one goes through ``flag`` (or ``fetch`` for whole
arrays) and is counted in ``count``; the Tracker reports the count per
scan step.  While a CUDA graph is being captured by
``kernels/graph_flow.capture`` (``core/graph.py`` captures the scan step
so, the counterpart of ``jax.jit``), a 0-d loop or branch becomes a
conditional node of the graph, tested on the device, and reads nothing:
``while_loop`` a WHILE node whose body writes its new carry over the
carry it read, ``cond`` two IF nodes (pred, not pred) whose false branch
copies its outputs over the true branch's.  Under capture a body must
make the same operations every time it runs and every carry leaf must be
a tensor; a batched loop or branch raises there.

``while_loop`` and ``cond`` take a predicate that is 0-d (one problem)
or batched, with the leading scenario axes of every tensor in the carry
(B independent problems, as under ``jax.vmap``).  A batched loop runs
while any scenario's predicate holds and keeps the carry of a scenario
that has exited (its body is computed and discarded); a batched branch
computes each side that some scenario takes and selects per scenario.
Either reads the host once per test, as the 0-d form does.

``psum`` / ``pmin`` / ``pmax`` reduce over an optional axis of ranks
(``parallel/collectives.Axis``): without one (``axis=None``, one device)
they return their input, so the single-device code runs no extra op.
"""
from __future__ import annotations

import torch

count = 0     # host reads of device values since import


def flag(t: torch.Tensor) -> bool:
    """``bool(t)`` for a 0-d bool tensor, counted as one host read."""
    global count
    count += 1
    return bool(t)


def fetch(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied to the host, counted as one host read."""
    global count
    count += 1
    return t.cpu()


def select(pred: torch.Tensor, a, b):
    """``a`` where the batched ``pred`` holds, else ``b``, over matching
    trees (tuples, NamedTuples) of tensors whose leading axes are
    ``pred``'s.  Leaves that are not tensors (a shared Python counter,
    None) are taken from ``a``."""
    if isinstance(a, torch.Tensor):
        if a.shape[:pred.dim()] != pred.shape:
            raise ValueError(f"sync.select: a carry tensor of shape "
                             f"{tuple(a.shape)} lacks the batch axes "
                             f"{tuple(pred.shape)}")
        p = pred.reshape(pred.shape + (1,) * (a.dim() - pred.dim()))
        return torch.where(p, a, b)
    if isinstance(a, tuple):
        items = [select(pred, x, y) for x, y in zip(a, b)]
        return type(a)(*items) if hasattr(a, "_fields") else tuple(items)
    return a


def _leaves(tree) -> list:
    """The tensors of a tree of tuples (NamedTuples) in order; a leaf
    that is not a tensor raises (a carry under capture is buffers)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [t for x in tree for t in _leaves(x)]
    raise TypeError(f"sync: a carry or branch output under graph capture "
                    f"must be tensors, got {type(tree).__name__}")


def _rebuild(tree, leaves):
    """``tree`` with its tensors replaced, in order, from ``leaves``."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    items = [_rebuild(x, leaves) for x in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)


def same_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def write_over(bufs, new, what: str):
    """Copy the tensors of ``new`` over ``bufs`` (same shapes and
    dtypes); a new value that lies in another buffer's storage is copied
    out first, so no copy reads what an earlier one wrote."""
    vals = _leaves(new)
    if len(vals) != len(bufs):
        raise ValueError(f"sync: {what} changed the number of tensors "
                         f"({len(bufs)} -> {len(vals)})")
    for b, v in zip(bufs, vals):
        if v.shape != b.shape or v.dtype != b.dtype:
            raise ValueError(f"sync: {what} changed a tensor from "
                             f"{b.dtype} {tuple(b.shape)} to {v.dtype} "
                             f"{tuple(v.shape)}")
    vals = [v.clone() if any(o is not b and same_storage(v, o)
                             for o in bufs) else v
            for b, v in zip(bufs, vals)]
    for b, v in zip(bufs, vals):
        if v is not b:
            b.copy_(v)


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, tuple):
        for x in tree:
            t = _first_tensor(x)
            if t is not None:
                return t
    return None


def _capturing(t: torch.Tensor) -> bool:
    if not t.is_cuda or not torch.cuda.is_current_stream_capturing():
        return False
    from .kernels import graph_flow
    if not graph_flow.capturing():
        raise RuntimeError("sync: a loop or branch under a CUDA graph "
                           "capture needs graph_flow.capture")
    return True


def _device_while(cond, body, carry, max_iters, test_first):
    """The WHILE node: the carry is copied into buffers of the loop's
    own, the body runs on them and writes its result over them."""
    from .kernels import graph_flow
    bufs = [t.clone() for t in _leaves(carry)]
    carry = _rebuild(carry, iter(bufs))
    test = cond is not None
    p0 = cond(carry) if test and test_first else None
    if p0 is not None and p0.dim() != 0:
        raise RuntimeError("sync.while_loop: a batched loop cannot be "
                           "captured")
    counter = torch.zeros((), dtype=torch.int32, device=bufs[0].device)
    cap = (1 << 31) - 1 if max_iters is None else int(max_iters)
    with graph_flow.while_node(p0, counter, cap) as node:
        write_over(bufs, body(carry, None), "a loop body")
        p = cond(carry) if test else None
        if p is not None and p.dim() != 0:
            raise RuntimeError("sync.while_loop: a batched loop cannot be "
                               "captured")
        node.next(p)
    return carry


def _device_cond(pred, true_fn, false_fn):
    """Two IF nodes: the true branch's outputs are copied into buffers
    made in its body (so that no input is written over), the false
    branch's are copied over them."""
    from .kernels import graph_flow
    with graph_flow.if_node(pred):
        out = true_fn()
        bufs = [t.clone() for t in _leaves(out)]
    with graph_flow.if_node(pred, negate=True):
        write_over(bufs, false_fn(), "the false branch")
    return _rebuild(out, iter(bufs))


def while_loop(cond, body, carry, max_iters=None, test_first=True):
    """``lax.while_loop(cond, body, carry)`` with the exit read on the
    host, at most ``max_iters`` bodies.  ``body(carry, active)`` gets the
    scenarios still running (None: all of them, or one 0-d problem), so
    that a branch or loop nested in it can leave the others out.  With
    ``test_first=False`` the first body runs untested (a loop whose first
    test is known to hold).  ``cond=None`` runs exactly ``max_iters``
    bodies and reads nothing on the host.  Under a graph capture (module
    docstring) the loop is a WHILE node and reads nothing."""
    first = _first_tensor(carry)
    if first is not None and _capturing(first):
        return _device_while(cond, body, carry, max_iters, test_first)
    it, active = 0, None
    while max_iters is None or it < max_iters:
        if cond is not None and (it > 0 or test_first):
            p = cond(carry)
            if p.dim() == 0:
                if not flag(p):
                    break
            else:
                if not flag(p.any()):
                    break
                active = p
        new = body(carry, active)
        carry = new if active is None else select(active, new, carry)
        it += 1
    return carry


def cond(pred: torch.Tensor, true_fn, false_fn):
    """``lax.cond(pred, true_fn, false_fn)``: a 0-d ``pred`` runs one
    branch.  A batched one is read once (does any, does every scenario
    take ``true_fn``): a branch no scenario takes is not run, otherwise
    both run and are selected per scenario.  Under a graph capture
    (module docstring) a 0-d ``pred`` makes two IF nodes and reads
    nothing."""
    if _capturing(pred):
        if pred.dim() != 0:
            raise RuntimeError("sync.cond: a batched branch cannot be "
                               "captured")
        return _device_cond(pred, true_fn, false_fn)
    if pred.dim() == 0:
        return true_fn() if flag(pred) else false_fn()
    any_, all_ = fetch(torch.stack([pred.any(), pred.all()])).tolist()
    if all_:
        return true_fn()
    if not any_:
        return false_fn()
    return select(pred, true_fn(), false_fn())


def psum(axis, x):
    """``axis.psum(x)``, or ``x`` itself without an axis (one device)."""
    return x if axis is None else axis.psum(x)


def pmin(axis, x):
    return x if axis is None else axis.pmin(x)


def pmax(axis, x):
    return x if axis is None else axis.pmax(x)

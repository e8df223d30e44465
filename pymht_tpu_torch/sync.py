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
so, the counterpart of ``jax.jit``), a loop or branch becomes a
conditional node of the graph, tested on the device, and reads nothing:
``while_loop`` a WHILE node whose body writes its new carry over the
carry it read, ``cond`` two IF nodes.  Under capture a body must make
the same operations every time it runs and every carry leaf must be a
tensor; code whose form would follow a host value (a cadence counted on
the host) asks ``captured`` and takes its device form.

``while_loop`` and ``cond`` take a predicate that is 0-d (one problem)
or batched, with the leading scenario axes of every tensor in the carry
(B independent problems, as under ``jax.vmap``).  A batched loop runs
while any scenario's predicate holds and keeps the carry of a scenario
that has exited (its body is computed and discarded): the body gets the
scenarios still running as a bool tensor ``active`` (all of them on an
untested first body) and its result is selected by it.  A batched
branch computes each side that some scenario takes and selects per
scenario.  Eagerly either reads the host once per test, as the 0-d form
does; under capture the WHILE node tests ``active.any()``, the two IF
nodes ``pred.any()`` and ``not pred.all()``, each branch writes into
buffers of its own, and ``select`` picks per scenario after both (a
branch no scenario took leaves stale buffers that nothing selects).

Each loop and branch has a name: the call site's ``name=``, else its
body's (a branch: its true function's) ``file:line``.  Under capture its
conditional nodes count their condition kernel's runs under it
(``graph_flow.node_runs``); eagerly, with tracing on (``utils/timing``),
each body and each branch taken runs inside a span of that name.

``psum`` / ``pmin`` / ``pmax`` reduce over an optional axis of ranks
(``parallel/collectives.Axis``): without one (``axis=None``, one device)
they return their input, so the single-device code runs no extra op.
"""
from __future__ import annotations

import torch

from .utils import timing

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


def captured(t: torch.Tensor) -> bool:
    """Is the work on ``t`` being captured into a graph?  A body then
    takes its device form: one that tests on the device what its eager
    form decides on the host (the repair cadence of the Lagrangian
    selects), so that the one captured run holds for every iteration."""
    return _capturing(t)


def any_(p: torch.Tensor) -> bool:
    """Does the (0-d or batched) predicate hold for some scenario: one
    counted host read."""
    return flag(p if p.dim() == 0 else p.any())


def node_name(fn, name=None) -> str:
    """A loop's or branch's name: ``name``, else ``fn``'s ``file:line``."""
    if name is not None:
        return name
    code = fn.__code__
    return f"{code.co_filename.rsplit('/', 1)[-1]}:{code.co_firstlineno}"


def _device_while(cond, body, carry, max_iters, test_first, name):
    """The WHILE node: the carry is copied into buffers of the loop's
    own, the body runs on them and writes its result over them.  A
    batched loop also keeps its ``active`` mask in a buffer and tests
    ``active.any()``."""
    from .kernels import graph_flow
    bufs = [t.clone() for t in _leaves(carry)]
    carry = _rebuild(carry, iter(bufs))
    p = cond(carry) if cond is not None else None
    counter = torch.zeros((), dtype=torch.int32, device=bufs[0].device)
    cap = (1 << 31) - 1 if max_iters is None else int(max_iters)
    if p is None or p.dim() == 0:
        with graph_flow.while_node(p if test_first else None, counter,
                                   cap, name) as node:
            write_over(bufs, body(carry, None), "a loop body")
            node.next(cond(carry) if cond is not None else None)
        return carry
    active = p.clone() if test_first else torch.ones_like(p)
    with graph_flow.while_node(active.any(), counter, cap, name) as node:
        new = select(active, body(carry, active), carry)
        write_over(bufs, new, "a loop body")
        active.copy_(cond(carry))
        node.next(active.any())
    return carry


def _device_cond(pred, true_fn, false_fn, name):
    """Two IF nodes.  0-d: the true branch's outputs are copied into
    buffers made in its body (so that no input is written over), the
    false branch's are copied over them.  Batched: each branch, run when
    some scenario takes it, copies its outputs into buffers of its own,
    and ``select`` picks per scenario."""
    from .kernels import graph_flow
    if pred.dim() == 0:
        with graph_flow.if_node(pred, name=name):
            out = true_fn()
            bufs = [t.clone() for t in _leaves(out)]
        with graph_flow.if_node(pred, negate=True, name=name):
            write_over(bufs, false_fn(), "the false branch")
        return _rebuild(out, iter(bufs))
    with graph_flow.if_node(pred.any(), name=name):
        out_t = true_fn()
        bufs_t = [t.clone() for t in _leaves(out_t)]
    with graph_flow.if_node(pred.all(), negate=True, name=name):
        out_f = false_fn()
        bufs_f = [t.clone() for t in _leaves(out_f)]
    return select(pred, _rebuild(out_t, iter(bufs_t)),
                  _rebuild(out_f, iter(bufs_f)))


def while_loop(cond, body, carry, max_iters=None, test_first=True,
               name=None):
    """``lax.while_loop(cond, body, carry)`` with the exit read on the
    host, at most ``max_iters`` bodies, named ``name`` (module
    docstring).  ``body(carry, active)`` gets the
    scenarios still running (a bool tensor for a batched loop; None for
    one 0-d problem), so that a branch or loop nested in it can leave the
    others out.  With ``test_first=False`` the first body runs untested
    (a loop whose first test is known to hold), for every scenario;
    ``cond`` is still called on the first carry, for the batch's shape.
    ``cond=None`` runs exactly ``max_iters`` bodies and reads nothing on
    the host.  Under a graph capture (module docstring) the loop is a
    WHILE node and reads nothing."""
    first = _first_tensor(carry)
    if first is not None and _capturing(first):
        return _device_while(cond, body, carry, max_iters, test_first,
                             node_name(body, name))
    if timing.TRACE.on:
        body = timing.spanned(node_name(body, name), body)
    cap = float("inf") if max_iters is None else max_iters
    if cap <= 0:
        return carry
    p = cond(carry) if cond is not None else None
    active = None if p is None or p.dim() == 0 else (
        p if test_first else torch.ones_like(p))
    if test_first and p is not None and not any_(p):
        return carry
    it = 0
    while it < cap:
        new = body(carry, active)
        carry = new if active is None else select(active, new, carry)
        it += 1
        if cond is not None and it < cap:
            p = cond(carry)
            if not any_(p):
                break
            if active is not None:
                active = p
    return carry


def cond(pred: torch.Tensor, true_fn, false_fn, name=None):
    """``lax.cond(pred, true_fn, false_fn)``, named ``name`` (module
    docstring): a 0-d ``pred`` runs one branch.  A batched one is read
    once (does any, does every scenario take ``true_fn``): a branch no
    scenario takes is not run, otherwise both run and are selected per
    scenario.  Under a graph capture
    (module docstring) it makes two IF nodes and reads nothing."""
    if _capturing(pred):
        return _device_cond(pred, true_fn, false_fn,
                            node_name(true_fn, name))
    if timing.TRACE.on:
        nm = node_name(true_fn, name)
        true_fn, false_fn = (timing.spanned(nm, true_fn),
                             timing.spanned(nm, false_fn))
    if pred.dim() == 0:
        return true_fn() if flag(pred) else false_fn()
    some, every = fetch(torch.stack([pred.any(), pred.all()])).tolist()
    if every:
        return true_fn()
    if not some:
        return false_fn()
    return select(pred, true_fn(), false_fn())


def psum(axis, x):
    """``axis.psum(x)``, or ``x`` itself without an axis (one device)."""
    return x if axis is None else axis.psum(x)


def pmin(axis, x):
    return x if axis is None else axis.pmin(x)


def pmax(axis, x):
    return x if axis is None else axis.pmax(x)

"""Host reads of device values, counted, and the loops and branches
built on them.

Wherever the JAX package exits a ``lax.while_loop`` or takes a
``lax.cond`` branch on a device value, the port reads that value on the
host (the simplest way to keep JAX's semantics exactly).  On a CUDA
tensor each read waits for the device, so every one goes through
``flag`` (or ``fetch`` for whole arrays) and is counted in ``count``; the
Tracker reports the count per scan step.

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


def while_loop(cond, body, carry, max_iters=None, test_first=True):
    """``lax.while_loop(cond, body, carry)`` with the exit read on the
    host, at most ``max_iters`` bodies.  ``body(carry, active)`` gets the
    scenarios still running (None: all of them, or one 0-d problem), so
    that a branch or loop nested in it can leave the others out.  With
    ``test_first=False`` the first body runs untested (a loop whose first
    test is known to hold).  ``cond=None`` runs exactly ``max_iters``
    bodies and reads nothing on the host."""
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
    both run and are selected per scenario."""
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

"""Host reads of device values, counted.

Wherever the JAX package exits a ``lax.while_loop`` or takes a
``lax.cond`` branch on a device value, the port reads that value on the
host (the simplest way to keep JAX's semantics exactly).  On a CUDA
tensor each read waits for the device, so every one goes through
``flag`` (or ``fetch`` for whole arrays) and is counted in ``count``; the
Tracker reports the count per scan step.
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

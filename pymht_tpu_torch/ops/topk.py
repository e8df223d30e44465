"""Exact k-smallest with the JAX package's tie order."""
from __future__ import annotations

import torch


def smallest_k(x: torch.Tensor, k: int):
    """The k smallest entries along the last axis, ascending, ties broken
    by lower index first — the order of ``jax.lax.top_k(-x, k)`` (a
    stable sort; ``torch.topk`` makes no promise about ties)."""
    vals, idx = torch.sort(x, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]

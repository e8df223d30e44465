"""Leading scenario axes: the index tuples that pick one entry per row.

Every core function takes its tensors with optional leading batch axes
(B scenarios stepped together, ``parallel/scenario.py``).  Where the
unbatched code indexes ``x[tb, sel]`` with ``tb = arange(T)``, it indexes
``x[(*lead_index((*B, T), dev), sel)]``: with no batch axes that is the
same tuple, so the unbatched path makes the same operations.
"""
from __future__ import annotations

import torch


def lead_index(shape, device, extra: int = 0) -> tuple:
    """One ``arange`` per axis of ``shape``, each shaped to broadcast
    against the others and against ``extra`` trailing axes:
    ``x[(*lead_index(x.shape[:k], dev), idx)]`` takes, at every position
    of the first k axes, the entries ``idx`` of axis k."""
    n = len(shape)
    return tuple(torch.arange(s, device=device)
                 .view((1,) * i + (s,) + (1,) * (n - 1 - i + extra))
                 for i, s in enumerate(shape))


def isin(elements: torch.Tensor, test: torch.Tensor) -> torch.Tensor:
    """``torch.isin(elements, test)`` per scenario: ``elements [..., A]``
    against ``test [..., K]`` with the same leading axes (``jnp.isin``
    under ``jax.vmap``), as one broadcast compare [..., A, K] with or
    without batch axes.  Not ``torch.isin``: on a CUDA tensor with a large
    test set it sorts, and its ``_unique`` reads the output size on the
    host, which a captured graph (core/graph.py) cannot do."""
    return (elements[..., :, None] == test[..., None, :]).any(dim=-1)

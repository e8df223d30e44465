"""Collectives over one axis of ranks (counterpart of a JAX mesh axis
name with ``jax.lax.psum / pmin / pmax / axis_index / axis_size``).

An ``Axis`` wraps one ``torch.distributed`` process group, normally one
dimension of a ``DeviceMesh`` (``Axis.of_mesh(mesh, 'cluster')``).  Its
reductions return new tensors and never reduce the caller's tensor in
place; inputs are made contiguous first, and a bool tensor is reduced as
int32 (the JAX code's ``astype(int32)`` before a psum), so ``psum`` of a
mask returns counts.  ``count`` and ``bytes`` add up the collectives it
made and the bytes each rank contributed to them, as ``sync.count``
counts host reads.

The transport is the group's backend: NCCL for CUDA tensors unless the
caller named gloo (which reduces and gathers CUDA tensors too, through
the host, as on one card shared by two ranks).  Nothing is staged or
downgraded here.

Where the single-device code takes ``axis=None`` the port runs exactly
its single-device operations (``sync.psum`` / ``pmin`` / ``pmax``,
re-exported here); an ``Axis`` of one rank makes the same numbers
through real (trivial) collectives.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..sync import pmax, pmin, psum  # noqa: F401  (the axis=None forms)


class Axis:
    """``psum`` / ``pmin`` / ``pmax`` / ``all_gather`` over the ranks of
    ``group`` (None: the default group); ``index`` is this rank's
    position on the axis, ``size`` the number of ranks."""

    def __init__(self, group=None):
        self.group = group
        self.index = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.count = 0      # collectives made
        self.bytes = 0      # bytes this rank contributed to them

    @classmethod
    def of_mesh(cls, mesh, dim: str) -> "Axis":
        """The axis of one named dimension of a ``DeviceMesh``."""
        return cls(mesh.get_group(dim))

    def _note(self, t: torch.Tensor):
        self.count += 1
        self.bytes += t.numel() * t.element_size()

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        y = (x.to(torch.int32) if x.dtype == torch.bool
             else x.clone(memory_format=torch.contiguous_format))
        self._note(y)
        dist.all_reduce(y, op=op, group=self.group)
        return y

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.SUM)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MIN)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MAX)

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order
        (JAX's ``all_gather(..., tiled=True)``)."""
        y = x.movedim(dim, 0).contiguous()
        out = y.new_empty((self.size * y.shape[0], *y.shape[1:]))
        self._note(y)
        dist.all_gather_into_tensor(out, y, group=self.group)
        return out.movedim(0, dim)


def digest(tensors) -> torch.Tensor:
    """[2] int64 fingerprint of the bytes of ``tensors`` (their sum and a
    position-weighted sum), equal on two ranks iff, up to collisions,
    the tensors are bitwise equal."""
    parts = []
    for t in tensors:
        b = t.detach().contiguous().reshape(-1).view(torch.uint8).long()
        w = torch.arange(1, b.numel() + 1, device=b.device) % 65521 + 1
        parts.append(torch.stack([b.sum(), (b * w).sum()]))
    return torch.stack(parts).sum(dim=0)


def check_replicated(axis: Axis, tensors, what: str = "replicated state"):
    """Raise unless every rank of ``axis`` holds bitwise the same
    ``tensors``: one all-gather of their digests, read on the host."""
    d = axis.all_gather(digest(tensors)[None]).cpu()
    if not bool((d == d[0]).all()):
        raise RuntimeError(f"{what} differs between the ranks: digests "
                           f"{d.tolist()}")

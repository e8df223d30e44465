"""Tier 2 of the selection on the card: the exact solve of every small
cluster as one hand-written kernel (``csrc/enum_small.cu``).

``enum_small`` takes what ``core/select._enum_small_clusters`` has built,
each member's top-C candidates (``cand_f [..., T, C]`` f32 and
``cand_idx [..., T, C]`` leaf ids) with the forest's slot ids
(``slots [..., T, L, W2]`` int64, ``n_slots`` for none) and the buckets'
members (``members [..., B, K]`` target ids, T for none; slot ids at or
above ``n_slots`` are none, and the kernel compares them in 32 bits, so
it takes ``n_slots`` < 2^31 - 1 and ids from -2^31 on), and returns
``(best [..., B] int64, val [..., B] f32)``: the flat index over C^K of
each bucket's best feasible combination and its value.  That is bit for
bit what the plain twin ``core/select._enum_buckets`` returns on the
members' gathered candidates (the CPU path and the reference; see the
source for why).  One block per bucket over every leading axis, one
launch.  On the device, each non-empty bucket adds 1 to the program's
counter ``enum_buckets`` and each launch 1 to ``enum_calls``
(``utils/timing.COUNTERS``), so a graph's replay counts what it ran.

CUDA tensors only: the wrapper launches the kernel or raises, and
``select`` takes the twin for tensors on the CPU.  ``prepare`` loads the
kernel before a stream capture (core/graph.py).
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import timing

MAX_C = 32            # candidates per member the kernel takes
MAX_K = 4             # members per bucket

_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_prepared = set()     # devices whose module is loaded


def _lib():
    from ..kernels import build
    lib = build.load("enum_small")
    if lib.enum_small_launch.argtypes is None:
        lib.enum_small_launch.argtypes = ([_PTR] * 8 + [_LL] + [_INT] * 7
                                          + [_PTR])
        lib.enum_small_launch.restype = _INT
        lib.enum_small_prepare.argtypes = []
        lib.enum_small_prepare.restype = _INT
    return lib


def prepare(device):
    """Build and load the kernel and query its attributes on ``device``
    (outside any capture), so that a launch inside one loads nothing."""
    device = torch.device(device)
    if device in _prepared:
        return
    with torch.cuda.device(device):
        err = _lib().enum_small_prepare()
    if err != 0:
        raise RuntimeError(f"enum_small: loading the kernel failed: CUDA "
                           f"error {err}")
    _prepared.add(device)


def _check(name, t, dtype, shape, dev):
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"enum_small: {name} must be a contiguous {dtype} "
                         f"tensor of shape {shape} on {dev}; got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def enum_small(cand_f, cand_idx, slots, members, n_slots: int):
    """(best [..., B] int64, val [..., B] f32) of every bucket (module
    docstring), in one launch on the current stream.  Raises for a tensor
    off the card, C above MAX_C, K above MAX_K, more buckets than a grid
    holds, n_slots from 2^31 - 1 on, or staging above a block's shared
    memory."""
    dev = cand_f.device
    if dev.type != "cuda":
        raise ValueError(f"enum_small: the kernel runs on CUDA tensors; got "
                         f"{dev} (the CPU path is core/select._enum_buckets)")
    *lead, T, C = cand_f.shape
    lead = tuple(lead)
    L, W2 = slots.shape[-2:]
    B, K = members.shape[-2:]
    if not 1 <= C <= MAX_C:
        raise ValueError(f"enum_small: C={C} candidates per member; the "
                         f"kernel takes 1 to {MAX_C}")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"enum_small: K={K} members per bucket; the kernel "
                         f"takes 1 to {MAX_K}")
    nb = 1
    for n in lead:
        nb *= n
    if nb * B >= 2 ** 31:
        raise ValueError(f"enum_small: {nb} x {B} buckets exceed the grid")
    for name, t, dtype, shape in (
            ("cand_f", cand_f, torch.float32, (*lead, T, C)),
            ("cand_idx", cand_idx, torch.int64, (*lead, T, C)),
            ("slots", slots, torch.int64, (*lead, T, L, W2)),
            ("members", members, torch.int64, (*lead, B, K))):
        _check(name, t, dtype, shape, dev)
    best = torch.empty((*lead, B), dtype=torch.int64, device=dev)
    val = torch.empty((*lead, B), dtype=torch.float32, device=dev)
    counter = timing._counter_buf(dev).data_ptr()
    slot = counter + 8 * timing.COUNTERS.index('enum_buckets')
    calls = counter + 8 * timing.COUNTERS.index('enum_calls')
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.enum_small_launch(
            cand_f.data_ptr(), cand_idx.data_ptr(), slots.data_ptr(),
            members.data_ptr(), best.data_ptr(), val.data_ptr(), slot, calls,
            int(n_slots), nb * B, T, L, C, W2, B, K, stream)
    if err == -1:
        raise RuntimeError(f"enum_small: the kernel refused the shape "
                           f"(buckets {nb} x {B}, T={T}, L={L}, C={C}, "
                           f"W2={W2}, K={K}, n_slots={n_slots}: n_slots "
                           f"at or above 2^31 - 1, or 4 K W2 C bytes of "
                           f"shared memory above a block's)")
    if err != 0:
        raise RuntimeError(f"enum_small kernel launch failed: CUDA error "
                           f"{err}")
    return best, val

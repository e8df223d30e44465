"""``scan_step`` captured as one CUDA graph and replayed once per scan:
the counterpart of the ``jax.jit`` on the JAX Tracker's step
(pymht_tpu/core/tracker.py:333-335), of ``scan_many``'s ``lax.scan``
(:225-245) and, for a batch of scenarios, of the jitted ``jax.vmap`` of
the step under ``run_batch``'s ``lax.scan``
(pymht_tpu/parallel/scenario.py:35-41, pymht_tpu/parallel/montecarlo.py:
116-152).

A ``StepGraph`` captures ``scan_step`` once per set of shapes (the
batch's size among them), parameters and static flags (the method,
``use_ais``, ``ais_initialization`` and the rest), on buffers of its
own: the state, the initiator state, one scan (z, mask, time) and, with
``use_ais``, one AIS batch (state, time, mmsi, high_accuracy, mask), each
with the batch's leading axis when there is one.  Every loop and branch
of the step becomes a conditional node tested on the device (``sync``
under ``kernels/graph_flow.capture``; a batched one tests whether any
scenario still runs), so a replay reads nothing on the host.  The
captured step ends by writing the next state over the state it read, as
JAX's ``donate_argnums`` lets the jitted step do: after a replay
``graph.state`` and ``graph.init_state`` ARE the next states, and
``graph.out`` holds the scan's outputs until the next replay.  A capture
that fails raises; nothing falls back to eager steps.

The configurations that are captured (``graphable``): one forest or a
batch of forests on one leading scenario axis, on the card, ``method``
one of ``'lagrangian'``, ``'lagrangian_pure'`` and ``'greedy'``, with or
without AIS fusion (and AIS initiation), with or without the spatial
pre-gate (``0 < radar_cand_width < max_meas``), no ``select_kw``, any of
``prune_similar``, ``compute_clusters`` and ``dynamic_window``.
``select_kw`` and ``'ipm'`` step eagerly.

K1 is launched once inside the graph, through its shared-scan or (with
the pre-gate, or for a batch) its per-target entry point, whose tile
plan ``card_plan`` is computed before the capture so that the capture
asks the runtime nothing: ``gate_kernel.launches`` and
``launches_pregate`` are counted per replay from what the capture
launched, so a count per scan stays true.
"""
from __future__ import annotations

import dataclasses
import math
import time

import torch

from .. import sync
from ..kernels import graph_flow
from ..ops import gate_kernel as gk
from .grow import AisBatch, Scan, empty_ais

GRAPHS_KEPT = 4          # graphs ``scan_many`` keeps, least recent dropped
GRAPHS = {}              # ``scan_many``'s graphs by key, oldest first
METHODS = ('lagrangian', 'lagrangian_pure', 'greedy')     # captured
# scan_step's static arguments that a graph key must name: each changes
# the captured program, and the step's defaults are not the Tracker's
FLAGS = ('method', 'use_ais', 'ais_initialization')

_warm = set()            # devices whose cuBLAS handle exists


def graphable(state, method: str, select_kw=None) -> bool:
    """Does this step run as a captured graph (module docstring)?  AIS
    and any pre-gate width are captured, so only the device, the batch
    axes (none or one), the method and ``select_kw`` decide."""
    return (state.leaf_x.is_cuda and state.hist_meas.dim() in (3, 4)
            and method in METHODS and not select_kw)


def graph_key(state, shapes, params, flags: dict) -> tuple:
    """The key of this step's graph: shapes, the batch's leading axes,
    parameters, device and every static flag of ``scan_step`` (``FLAGS``
    must be among them)."""
    missing = [f for f in FLAGS if f not in flags]
    if missing:
        raise ValueError(f"graph_key: the flags must name {missing}")
    return (shapes, params, state.leaf_x.device,
            tuple(sorted(flags.items())), tuple(state.hist_meas.shape[:-3]))


def _fields(obj) -> list:
    return [getattr(obj, f.name) for f in dataclasses.fields(obj)]


def clone_state(obj):
    return dataclasses.replace(obj, **{f.name: getattr(obj, f.name).clone()
                                       for f in dataclasses.fields(obj)})


class StepGraph:
    """``scan_step`` on one scan, captured (module docstring).  ``flags``:
    the keyword arguments of ``scan_step`` that are static; they must
    name ``FLAGS`` (``method``, ``use_ais``, ``ais_initialization``), and
    may name ``prune_similar``, ``compute_clusters`` and
    ``dynamic_window``."""

    def __init__(self, state, init_state, shapes, params, flags: dict):
        from .tracker import StepOutputs, scan_step
        dev = state.leaf_x.device
        self.shapes, self.params, self.flags = shapes, params, dict(flags)
        self.state = clone_state(state)
        self.init_state = clone_state(init_state)
        *lead, T, L, _ = state.hist_meas.shape
        lead = tuple(lead)
        M = shapes.max_meas
        self.scan = Scan(z=torch.zeros((*lead, M, 2), device=dev),
                         mask=torch.zeros((*lead, M), dtype=torch.bool,
                                          device=dev),
                         time=torch.zeros(lead, device=dev))
        self.ais = None
        if flags['use_ais']:
            self.ais = AisBatch(*(t.expand(lead + t.shape).contiguous()
                                  for t in empty_ais(shapes, dev)))
        if dev not in _warm:     # the thread's cuBLAS handle, made outside
            torch.ones(2, 2, device=dev) @ torch.ones(2, 2, device=dev)
            _warm.add(dev)
        # K1's per-target tile plan, asked of the runtime now: T targets of
        # L leaves pre-gated, B * T of them in a batch, and without the
        # pre-gate one target of T * L leaves per scenario (core/grow.py)
        nb, Km = math.prod(lead), shapes.radar_cand_width
        if 0 < Km < M:
            gk.card_plan(dev.index, nb * T, L, Km)
        elif lead:
            gk.card_plan(dev.index, nb, T * L, M)
        self.graph = torch.cuda.CUDAGraph()
        reads, k1, k1_sub = sync.count, gk.launches, gk.launches_pregate
        tic = time.perf_counter()
        with graph_flow.capture(self.graph):
            st, ist, out = scan_step(self.state, self.init_state, self.scan,
                                     self.ais, shapes, params, **self.flags)
            static = (_fields(self.state) + _fields(self.init_state)
                      + list(self.scan) + list(self.ais or ()))
            out = StepOutputs(*(
                t.clone() if any(sync.same_storage(t, s) for s in static)
                else t for t in out))
            sync.write_over(_fields(self.state), tuple(_fields(st)),
                            "the captured step")
            sync.write_over(_fields(self.init_state), tuple(_fields(ist)),
                            "the captured step")
        self.capture_s = time.perf_counter() - tic
        if sync.count != reads:
            raise RuntimeError("StepGraph: the capture read the host")
        self.k1, self.k1_pregate = (gk.launches - k1,
                                    gk.launches_pregate - k1_sub)
        gk.launches, gk.launches_pregate = k1, k1_sub   # nothing ran yet
        self.out = out
        self.replays = 0

    def load(self, state, init_state):
        """Make the graph's state buffers hold ``state`` and
        ``init_state`` (device copies of the fields that are not the
        buffers themselves)."""
        for obj, buf in ((state, self.state), (init_state, self.init_state)):
            for f in dataclasses.fields(buf):
                src, dst = getattr(obj, f.name), getattr(buf, f.name)
                if src is not dst:
                    dst.copy_(src)

    def __call__(self, scan: Scan, ais: AisBatch = None):
        """One scan (and, with ``use_ais``, its AIS batch), of every
        scenario of a batch: copy it in, replay; returns the outputs'
        buffers.  The inputs may be views of any alignment or stride (a
        packed transfer's bytes, a scan of a stacked batch): they are
        copied."""
        for buf, src in zip(self.scan, scan):
            buf.copy_(src)
        if self.ais is not None:
            for buf, src in zip(self.ais, ais):
                buf.copy_(src)
        self.graph.replay()
        gk.launches += self.k1
        gk.launches_pregate += self.k1_pregate
        self.replays += 1
        return self.out

    def pool_bytes(self) -> int:
        """Device memory held by the graph's private pool."""
        pool = tuple(self.graph.pool())
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == pool)


def get(graphs: dict, state, init_state, shapes, params, flags: dict,
        kept: int = None) -> StepGraph:
    """The graph of this configuration in ``graphs``, captured on first
    use (with at most ``kept`` graphs kept, the least recent dropped)."""
    key = graph_key(state, shapes, params, flags)
    g = graphs.pop(key, None)       # re-inserted last: the most recent
    if g is None:
        while kept is not None and len(graphs) >= kept:
            graphs.pop(next(iter(graphs)))
        g = StepGraph(state, init_state, shapes, params, flags)
    graphs[key] = g
    return g


def replay_many(g: StepGraph, state, init_state, scans: Scan,
                ais: AisBatch = None):
    """``scan_many`` on the graph: one replay per scan, each scan (and its
    AIS batch, row i of ``ais``) copied in and each output copied into
    row i of the stacked outputs, with nothing read in between.  Returns
    (the graph's state buffers, its initiator buffers, the stacked
    StepOutputs)."""
    from .tracker import StepOutputs
    g.load(state, init_state)
    S = scans.z.shape[0]
    stacked = None
    for i in range(S):
        out = g(Scan(*(f[i] for f in scans)),
                None if g.ais is None else AisBatch(*(f[i] for f in ais)))
        if stacked is None:
            stacked = [torch.empty((S, *t.shape), dtype=t.dtype,
                                   device=t.device) for t in out]
        for row, t in zip(stacked, out):
            row[i].copy_(t)
    return g.state, g.init_state, StepOutputs(*stacked)

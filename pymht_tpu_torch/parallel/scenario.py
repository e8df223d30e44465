"""Scenario batching (counterpart of pymht_tpu/parallel/scenario.py):
``make_batched_step`` and ``batch_states`` on one device, and
``make_sharded_step``, ``dryrun`` and ``dryrun_swarm_cluster`` on a
('scenario', 'cluster') mesh of ranks.

B independent scenarios advance one scan together.  Where the JAX
package ``jax.vmap``s ``scan_step``, the port writes the scenario axis
out: every tensor of the state, the initiator state, the scan, the AIS
batch and the step's outputs carries a leading B, and every core function
takes it (``batch.lead_index``), with any selection method, with or
without the AIS branch and with or without the spatial pre-gate.  The
loops and branches that the port reads on the host keep vmap's semantics
(``sync.while_loop``, ``sync.cond`` and the batched loops of
``ops/lp.py``): a loop runs while any scenario's test holds, a scenario
that is done keeps its carry, and a branch runs where some scenario takes
it and is selected per scenario.  A batched scan therefore makes a
number of launches that does not grow with B, K1 among them once.  On
the card, for the configurations ``core/graph.graphable`` names, the
batched step is one captured CUDA graph per (batch size, shapes,
parameters, flags), replayed once per batched scan with no host read
(the counterpart of the jitted ``jax.vmap``); eagerly (the CPU,
``'ipm'``) it makes about as many host reads as the slowest of its
scenarios alone.

On a mesh, ``make_sharded_step`` splits the scenarios over the
'scenario' ranks and keeps the target rows of each 'cluster' rank, but
steps each rank's scenarios whole: in the port it is a layout, not
target-parallel work.  The target-parallel path is
``sharded_tracker.make_sharded_tracker_step``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..core import graph as graph_mod
from ..core import initiator as initiator_mod
from ..core.config import TrackerParams, TrackerShapes
from ..core.grow import AisBatch, Scan, empty_ais
from ..core.state import empty_state, insert_targets
from ..core.tracker import (PER_TARGET_OUTPUTS, StepOutputs,
                            _resolve_device, scan_step)
from ..models import pv
from .collectives import Axis
from .multihost import hybrid_mesh
from .sharded_tracker import (PER_TARGET_FIELDS, make_sharded_tracker_step,
                              shard_state)


def make_batched_step(shapes: TrackerShapes, params: TrackerParams,
                      method: str = 'lagrangian', use_ais: bool = False,
                      graphs: dict = None):
    """``scan_step`` over a leading scenario axis: returns
    ``step(state_b, istate_b, scan_b, ais_b=None) -> (state_b, istate_b,
    outputs_b)``.  ``ais_b`` is the scenarios' ``AisBatch`` ``[B, A,
    ...]`` (read only with ``use_ais``).  An unknown ``method`` raises the
    dispatcher's ValueError at the first step, as the JAX step does when
    traced.

    On the card, for a configuration ``graph.graphable`` names, ``step``
    loads the states into a captured graph of the batched step, replays
    it and returns copies of the next states and of the outputs (the
    JAX step is functional: a caller may keep them across steps).  The
    graphs live in ``graphs`` (a dict of the step's own unless given; at
    most ``graph.GRAPHS_KEPT``, the least recent dropped).
    ``step.graph(state_b, istate_b)`` is the graph a step on these states
    replays, captured on first use, or None where the step runs eagerly
    (the CPU, ``'ipm'``)."""
    graphs = {} if graphs is None else graphs
    flags = dict(method=method, use_ais=use_ais, ais_initialization=True)

    def graph(state_b, istate_b):
        if not graph_mod.graphable(state_b, method):
            return None
        return graph_mod.get(graphs, state_b, istate_b, shapes, params,
                             flags, kept=graph_mod.GRAPHS_KEPT)

    def step(state_b, istate_b, scan_b, ais_b=None):
        g = graph(state_b, istate_b)
        if g is None:
            return scan_step(state_b, istate_b, scan_b, ais_b, shapes,
                             params, method=method, use_ais=use_ais)
        g.load(state_b, istate_b)
        out = g(scan_b, ais_b)
        return (graph_mod.clone_state(g.state),
                graph_mod.clone_state(g.init_state),
                StepOutputs(*(t.clone() for t in out)))

    step.graph = graph
    step.graphs = graphs
    return step


def batch_states(shapes: TrackerShapes, params: TrackerParams, n: int,
                 device=None):
    """(state, initiator state) of ``n`` empty scenarios, on ``device``:
    the GPU unless the caller names another (``device='cpu'`` runs the
    kernels' plain twins); with no CUDA device ``None`` raises."""
    dev = _resolve_device(device, "batch_states")
    return (empty_state(shapes, params, dev, batch=(n,)),
            initiator_mod.empty_initiator(shapes, dev, batch=(n,)))


# ----------------------------------------------------------------------
# Scenarios and targets over a ('scenario', 'cluster') mesh
# ----------------------------------------------------------------------

def _map_fields(obj, names, fn):
    """``obj`` (a state dataclass or a NamedTuple) with ``fn`` applied to
    the fields in ``names``."""
    if isinstance(obj, tuple):
        return obj._replace(**{k: fn(getattr(obj, k)) for k in obj._fields
                               if k in names})
    return obj.replace(**{f.name: fn(getattr(obj, f.name))
                          for f in dataclasses.fields(obj)
                          if f.name in names})


def _map_all(obj, fn):
    if obj is None:
        return None
    if isinstance(obj, tuple):
        return type(obj)(*(fn(x) for x in obj))
    return obj.replace(**{f.name: fn(getattr(obj, f.name))
                          for f in dataclasses.fields(obj)})


def make_sharded_step(mesh, shapes: TrackerShapes, params: TrackerParams,
                      method: str = 'lagrangian', use_ais: bool = False):
    """The batched step with the scenario axis B split over the mesh's
    'scenario' dimension and the target axis T over its 'cluster'
    dimension.  Returns ``(step, shard)``: ``shard(state_b, istate_b,
    scan_b, ais_b)`` cuts this rank's block from whole host-identical
    batches (its B / S scenarios; of the state's per-target fields its
    T / C targets; the rest of the state, the initiator state, the scans
    and the AIS batches whole per scenario), and ``step`` advances the
    blocks one scan, returning the step's outputs in the same layout.

    Sharding is a layout and changes no numbers: the result equals
    ``make_batched_step`` on the whole batch.  In the port this function
    does no target-parallel work: each rank all-gathers its cluster
    group's target rows (one collective per per-target field), steps its
    scenarios whole with ``make_batched_step``, and keeps its own rows;
    across 'scenario' nothing is exchanged.  The target-parallel path is
    ``sharded_tracker.make_sharded_tracker_step``, as in the JAX
    package."""
    scen = Axis.of_mesh(mesh, 'scenario')
    clus = Axis.of_mesh(mesh, 'cluster')
    T = shapes.max_targets
    if T % clus.size:
        raise ValueError(f"max_targets {T} does not split over "
                         f"{clus.size} cluster ranks")
    T_l = T // clus.size
    tgt_fields = frozenset(PER_TARGET_FIELDS)
    batched = make_batched_step(shapes, params, method=method,
                                use_ais=use_ais)

    def own_rows(x):
        return x.narrow(1, clus.index * T_l, T_l).contiguous()

    def step(state_b, istate_b, scan_b, ais_b=None):
        whole = _map_fields(state_b, tgt_fields,
                            lambda x: clus.all_gather(x, dim=1))
        st, ist, out = batched(whole, istate_b, scan_b, ais_b)
        return (_map_fields(st, tgt_fields, own_rows), ist,
                _map_fields(out, PER_TARGET_OUTPUTS, own_rows))

    def shard(state_b, istate_b, scan_b, ais_b=None):
        B = state_b.tgt_mask.shape[0]
        if B % scen.size:
            raise ValueError(f"{B} scenarios do not split over "
                             f"{scen.size} scenario ranks")
        B_l = B // scen.size

        def own_block(x):
            return x.narrow(0, scen.index * B_l, B_l).contiguous()

        st = _map_fields(_map_all(state_b, own_block), tgt_fields, own_rows)
        return (st, _map_all(istate_b, own_block),
                _map_all(scan_b, own_block), _map_all(ais_b, own_block))

    return step, shard


def dryrun_inputs(shapes: TrackerShapes, params: TrackerParams, B: int,
                  device):
    """``dryrun``'s batch: B empty scenarios and one scan of seeded
    measurements each (the JAX function's inputs)."""
    state_b, istate_b = batch_states(shapes, params, B, device)
    rng = np.random.default_rng(0)
    z = torch.from_numpy(rng.normal(0, 50, (B, shapes.max_meas, 2))
                         .astype(np.float32)).to(device)
    scan_b = Scan(z=z, mask=torch.ones((B, shapes.max_meas), dtype=torch.bool,
                                       device=device),
                  time=torch.full((B,), 1.0, device=device))
    ais_b = _map_all(empty_ais(shapes, device),
                     lambda x: x.expand((B,) + x.shape).contiguous())
    return state_b, istate_b, scan_b, ais_b


DRYRUN_SHAPES = TrackerShapes(max_targets=8, max_leaves=8, max_meas=8,
                              max_ais=2, window=4, max_prelim=8,
                              max_initiators=8)
DRYRUN_PARAMS = TrackerParams(radar_period=1.0, N=2)


def dryrun(n_devices: int, scenario: int = None, cluster: int = None,
           device=None):
    """ONE sharded batched step on a ('scenario', 'cluster') mesh of the
    ``n_devices`` initialised ranks, at the JAX function's tiny shapes
    (one scenario per scenario rank).  ``device``: this rank's device
    (None: its GPU).  Returns this rank's (state, initiator state,
    outputs) blocks."""
    if dist.get_world_size() != n_devices:
        raise ValueError(f"dryrun({n_devices}) runs in a group of "
                         f"{n_devices} ranks, not {dist.get_world_size()}")
    if scenario is None:
        cluster = min(2, n_devices)
        scenario = n_devices // cluster
    dev = _resolve_device(device, "dryrun")
    mesh = hybrid_mesh(scenario, cluster, device_type=dev.type)
    step, shard = make_sharded_step(mesh, DRYRUN_SHAPES, DRYRUN_PARAMS)
    inputs = dryrun_inputs(DRYRUN_SHAPES, DRYRUN_PARAMS, scenario, dev)
    return step(*shard(*inputs))


def swarm_cluster_inputs(device):
    """``dryrun_swarm_cluster``'s configuration and inputs, whole: (shapes,
    params, state, initiator state, scan, AIS batch)."""
    shapes = TrackerShapes(max_targets=1024, max_leaves=8, max_meas=512,
                           max_ais=32, window=5, max_prelim=32,
                           max_initiators=64, ais_per_leaf=2)
    params = TrackerParams(radar_period=2.5, P_d=0.9, lambda_phi=1.5e-6,
                           lambda_nu=1e-6, N=3, radar_range=12000.0)
    T, M, A = shapes.max_targets, shapes.max_meas, shapes.max_ais
    rng = np.random.default_rng(0)
    n_tgt = 600
    xs = np.zeros((T, 4), np.float32)
    xs[:n_tgt, :2] = rng.uniform(-6000, 6000, (n_tgt, 2))
    xs[:n_tgt, 2:] = rng.normal(0, 5, (n_tgt, 2))
    mask = np.arange(T) < n_tgt
    mmsi = np.where(mask, 111000000 + np.arange(T), 0).astype(np.int32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    state = insert_targets(
        empty_state(shapes, params, device), dev(xs),
        pv.P0(device).expand(T, 4, 4), dev(mask), dev(mmsi),
        torch.zeros((), device=device), params)
    istate = initiator_mod.empty_initiator(shapes, device)
    n_z = min(n_tgt, M)
    z = np.zeros((M, 2), np.float32)
    z[:n_z] = (xs[:n_z, :2] + xs[:n_z, 2:] * 2.5
               + rng.normal(0, 2.5, (n_z, 2)))
    scan = Scan(z=dev(z), mask=dev(np.arange(M) < n_z),
                time=torch.tensor(2.5, device=device))
    a_state = np.zeros((A, 4), np.float32)
    a_state[:16] = xs[:16] + 1.0
    ais = AisBatch(state=dev(a_state),
                   time=torch.full((A,), 1.5, device=device),
                   mmsi=dev(mmsi[:A]),
                   high_accuracy=torch.zeros((A,), dtype=torch.bool,
                                             device=device),
                   mask=dev(np.arange(A) < 16))
    return shapes, params, state, istate, scan, ais


def dryrun_swarm_cluster(n_devices: int, device=None):
    """ONE full tracker scan with the target axis split over all
    ``n_devices`` initialised ranks at swarm-like shapes (T=1024 slots,
    600 live targets, M=512, A=32, AIS fusion on): the configuration the
    target-sharded step exists for.  Returns this rank's (state,
    initiator state, outputs)."""
    if dist.get_world_size() != n_devices:
        raise ValueError(f"dryrun_swarm_cluster({n_devices}) runs in a "
                         f"group of {n_devices} ranks, not "
                         f"{dist.get_world_size()}")
    dev = _resolve_device(device, "dryrun_swarm_cluster")
    shapes, params, state, istate, scan, ais = swarm_cluster_inputs(dev)
    axis = Axis()
    step = make_sharded_tracker_step(axis, shapes, params, use_ais=True)
    return step(shard_state(state, axis), istate, scan, ais)

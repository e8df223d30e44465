"""The per-scan tracker pipeline and the host-facing Tracker class
(counterpart of pymht_tpu/core/tracker.py).

Device side: ``scan_step`` composes grow (radar and, with ``use_ais``,
AIS fusion) -> select -> terminate -> N-scan prune -> initiate -> insert
on tensors of one device.  Host side: ``Tracker`` keeps the JAX
Tracker's API (``add_measurement_list``, ``stream``, ``degrade``,
``pre_initialize``, ``get_tracks``, ``get_smooth_tracks``,
``check_integrity``) and archives each track's confirmed past as numpy,
appended from the prune outputs every scan.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import sync
from ..batch import isin, lead_index
from ..models import pv
from ..sync import psum
from .config import TrackerShapes, TrackerParams
from ..utils.timing import RuntimeLog
from .state import TrackerState, empty_state, insert_targets, shrink_beam
from .grow import AisBatch, Scan, grow
from .merge import prune_similar as merge_similar
from .select import cluster, select
from .lifecycle import n_scan_prune, terminate
from . import initiator as initiator_mod
from . import graph as graph_mod


class StepOutputs(NamedTuple):
    # Selected track estimate per target slot (post-selection, pre-prune)
    track_mask: torch.Tensor     # [T] bool
    track_id: torch.Tensor       # [T] i32
    track_x: torch.Tensor        # [T, 4]
    track_cnllr: torch.Tensor    # [T]
    sel_hist_valid: torch.Tensor  # [T, W] bool
    sel_hist_x: torch.Tensor     # [T, W, 4]
    sel_hist_meas: torch.Tensor  # [T, W] i32
    sel_hist_mmsi: torch.Tensor  # [T, W] i32
    # Lifecycle
    dead: torch.Tensor           # [T] bool
    dead_reason: torch.Tensor    # [T] i32
    confirmed_mask: torch.Tensor  # [T, W]
    confirmed_x: torch.Tensor    # [T, W, 4]
    confirmed_meas: torch.Tensor  # [T, W]
    confirmed_mmsi: torch.Tensor  # [T, W]
    # Newly inserted targets: slot mask, id, root-leaf covariance
    inserted_mask: torch.Tensor  # [T] bool
    inserted_id: torch.Tensor    # [T] i32
    inserted_P: torch.Tensor     # [T, 4, 4]
    # Diagnostics
    n_clusters: torch.Tensor     # [] i32
    sel_obj: torch.Tensor        # [] f32
    sel_bound: torch.Tensor      # [] f32
    sel_feasible: torch.Tensor   # [] bool
    n_leaves: torch.Tensor       # [] i32
    leaf_counts: torch.Tensor    # [T] i32
    gated_counts: torch.Tensor   # [T] i32
    used_meas: torch.Tensor      # [M] bool


# StepOutputs fields with a target axis (after any scenario axes); the
# others are per scan.  The sharded steps split and gather these.
PER_TARGET_OUTPUTS = frozenset((
    'track_mask', 'track_id', 'track_x', 'track_cnllr', 'sel_hist_valid',
    'sel_hist_x', 'sel_hist_meas', 'sel_hist_mmsi', 'dead', 'dead_reason',
    'confirmed_mask', 'confirmed_x', 'confirmed_meas', 'confirmed_mmsi',
    'inserted_mask', 'inserted_id', 'inserted_P', 'leaf_counts',
    'gated_counts'))


def scan_step(state: TrackerState, init_state, scan: Scan,
              ais: Optional[AisBatch], shapes: TrackerShapes,
              params: TrackerParams, method: str = 'ipm',
              use_ais: bool = True, ais_initialization: bool = True,
              prune_similar: bool = False, compute_clusters: bool = True,
              dynamic_window: bool = False,
              select_kw: Optional[dict] = None):
    """One radar scan through the full pipeline.  ``ais`` is the scan's
    AisBatch; it is not read when ``use_ais`` is false (and may then be
    None).  ``prune_similar`` merges near-identical sibling hypotheses
    after grow; ``dynamic_window`` shrinks the N-scan window of targets
    that are over budget (``shrink_windows``).  Neither reads a value on
    the host.  The step also takes a batch of scenarios, with any method
    and either branch: leading axes on the states, the scan, the AIS batch
    and every output (``parallel/scenario.make_batched_step``)."""
    if use_ais and not isinstance(ais, AisBatch):
        raise TypeError("scan_step: use_ais=True needs an AisBatch "
                        "(grow.empty_ais for a scan with no messages)")
    *lead, T, L, W = state.hist_meas.shape
    dev = state.leaf_x.device
    ix = lead_index((*lead, T), dev)

    # 1. grow
    g = grow(state, scan, ais if use_ais else None, shapes, params)
    state = g.state
    if prune_similar:
        state = merge_similar(state, shapes, params)

    # 2-3. cluster + global hypothesis selection
    sel_res = select(state, shapes, params, method=method,
                     compute_clusters=compute_clusters, **(select_kw or {}))
    state = state.replace(sel_leaf=sel_res.sel, lam=sel_res.lam)
    sel = sel_res.sel.long()
    track_x = state.leaf_x[(*ix, sel)]
    track_cnllr = state.leaf_cnllr[(*ix, sel)]
    sel_hist_valid = ((torch.arange(W, device=dev)[None, :]
                       >= (W - state.tgt_depth)[..., None])
                      & state.tgt_mask[..., None])
    sel_hist_x = state.hist_x[(*ix, sel)]
    sel_hist_meas = state.hist_meas[(*ix, sel)]
    sel_hist_mmsi = state.hist_mmsi[(*ix, sel)]
    track_mask, track_id = state.tgt_mask, state.tgt_id

    # 6. terminate, 7. N-scan prune
    term = terminate(state, shapes, params)
    state = term.state
    pr = n_scan_prune(state, shapes, params)
    state = pr.state

    # 8. initiate from the measurements no leaf gated
    if use_ais and ais_initialization:
        # messages whose MMSI a surviving leaf of the same scenario
        # associated this scan are not available for initiation
        cur_mmsi = torch.where(state.leaf_mask, state.hist_mmsi[..., -1], 0)
        ais_for_init = ais._replace(
            mask=ais.mask & ~isin(ais.mmsi, cur_mmsi.flatten(-2)))
    else:
        ais_for_init = None
    init_out = initiator_mod.step(init_state, scan.z, scan.mask & ~g.used_meas,
                                  scan.time, ais_for_init, shapes, params)
    init_state = init_out.state
    new_x, new_mask, new_mmsi = _merge_new_targets(
        init_out.new_x, init_out.new_mask, init_out.new_mmsi,
        params.merge_threshold)
    # reject new targets neighbouring an existing track's leaf
    leaf_pos = state.leaf_x[..., :2].reshape(*lead, -1, 2)
    d = torch.linalg.vector_norm(
        new_x[..., :, None, :2] - leaf_pos[..., None, :, :], dim=-1)
    near = ((d < params.merge_threshold)
            & state.leaf_mask.reshape(*lead, -1)[..., None, :])
    new_mask = new_mask & ~near.any(dim=-1)
    prev_mask = state.tgt_mask
    state = insert_targets(state, new_x, init_out.new_P, new_mask, new_mmsi,
                           scan.time, params)
    inserted = state.tgt_mask & ~prev_mask

    # 9. on-device dynamic window
    if dynamic_window:
        state = shrink_windows(state, g.gated_counts, inserted, params)

    live = state.leaf_mask.int()
    outputs = StepOutputs(
        track_mask=track_mask, track_id=track_id, track_x=track_x,
        track_cnllr=track_cnllr, sel_hist_valid=sel_hist_valid,
        sel_hist_x=sel_hist_x, sel_hist_meas=sel_hist_meas,
        sel_hist_mmsi=sel_hist_mmsi,
        dead=term.dead, dead_reason=term.reason,
        confirmed_mask=pr.confirmed_mask, confirmed_x=pr.confirmed_x,
        confirmed_meas=pr.confirmed_meas, confirmed_mmsi=pr.confirmed_mmsi,
        inserted_mask=inserted, inserted_id=state.tgt_id,
        inserted_P=state.leaf_P[..., 0, :, :],
        n_clusters=sel_res.n_clusters, sel_obj=sel_res.obj,
        sel_bound=sel_res.bound, sel_feasible=sel_res.feasible,
        n_leaves=live.flatten(-2).sum(dim=-1).int(),
        leaf_counts=live.sum(dim=-1).int(),
        gated_counts=g.gated_counts, used_meas=g.used_meas)
    return state, init_state, outputs


def shrink_windows(state: TrackerState, gated_counts, inserted,
                   params: TrackerParams, axis=None) -> TrackerState:
    """The on-device dynamic window: graceful degradation for the
    streaming path, where no wall clock exists inside the step.  A target
    (other than one ``inserted`` this scan) shrinks its N-scan window by
    one when its beam is still full after N-scan pruning, or when its
    share of the scan's gated-pair work (live leaves x gated pairs)
    exceeds max_target_time / radar_period with its beam at least half
    full.  Shapes are static, so this changes no arithmetic: it makes
    the N-scan pruning of that target more aggressive.  No host read.
    With an ``axis`` (the targets split over its ranks) the scan's total
    work is psum'd; saturation stays target-local."""
    L = state.leaf_mask.shape[-1]
    lc = state.leaf_mask.sum(dim=-1)                                 # [T]
    proxy = lc.float() * (1.0 + gated_counts.float())
    total = psum(axis, torch.where(state.tgt_mask, proxy, 0.0).sum(dim=-1))
    share = params.max_target_time / params.radar_period
    sat = state.tgt_mask & (lc >= L)
    over = (state.tgt_mask & (lc >= L // 2)
            & (proxy > (share * torch.clamp(total, min=1.0))[..., None]))
    shrink = (sat | over) & ~inserted
    return state.replace(tgt_window=torch.where(
        shrink, torch.clamp(state.tgt_window - 1, min=1), state.tgt_window))


def _merge_new_targets(new_x, new_mask, new_mmsi, threshold):
    """Greedy group-by-proximity merge: each candidate joins the first
    candidate within ``threshold``; representatives take the mean state.
    With leading scenario axes the product is a broadcast multiply and
    sum (a batched product of these sizes is one slow cuBLAS call)."""
    K = new_x.shape[-2]
    d = torch.linalg.vector_norm(
        new_x[..., :, None, :2] - new_x[..., None, :, :2], dim=-1)
    close = (d < threshold) & new_mask[..., :, None] & new_mask[..., None, :]
    first = close.int().argmax(dim=-1)
    rep = first == torch.arange(K, device=new_x.device)
    # a compare, not one_hot: on the CPU one_hot reads its input's range
    member_of = ((first[..., None] == torch.arange(K, device=new_x.device))
                 .float() * new_mask[..., None])
    counts = member_of.sum(dim=-2)
    if member_of.dim() == 2:
        summed = member_of.T @ new_x
    else:
        summed = (member_of[..., None] * new_x[..., None, :]).sum(dim=-3)
    mean_x = summed / torch.clamp(counts[..., None], min=1.0)
    keep = new_mask & rep
    return (torch.where(keep[..., None], mean_x, new_x), keep,
            torch.where(keep, new_mmsi, 0))


def scan_many(state, init_state, scans: Scan, ais: Optional[AisBatch],
              shapes: TrackerShapes, params: TrackerParams,
              method: str = 'lagrangian', use_ais: bool = True,
              ais_initialization: bool = True,
              compute_clusters: bool = False,
              dynamic_window: bool = False, prune_similar: bool = False,
              select_kw: Optional[dict] = None):
    """Process a batch of scans (leading time axis on ``scans`` and on
    ``ais``) one ``scan_step`` after another, with nothing fetched in
    between.  Returns (state, init_state, stacked StepOutputs).  On the
    card, for the configurations ``graph.graphable`` names, each scan is
    one replay of the step's captured graph (core/graph.py: the
    counterpart of the JAX function's ``lax.scan``), and the states
    returned are copies of the graph's buffers."""
    if graph_mod.graphable(state, method, select_kw):
        g = graph_mod.get(graph_mod.GRAPHS, state, init_state, shapes, params,
                          dict(method=method, use_ais=use_ais,
                               ais_initialization=ais_initialization,
                               compute_clusters=compute_clusters,
                               dynamic_window=dynamic_window,
                               prune_similar=prune_similar),
                          kept=graph_mod.GRAPHS_KEPT)
        st, ist, outs = graph_mod.replay_many(g, state, init_state, scans,
                                              ais)
        return graph_mod.clone_state(st), graph_mod.clone_state(ist), outs
    outs = []
    for i in range(scans.z.shape[0]):
        scan = Scan(*(f[i] for f in scans))
        ais_i = AisBatch(*(f[i] for f in ais)) if use_ais else None
        state, init_state, out = scan_step(
            state, init_state, scan, ais_i, shapes, params, method=method,
            use_ais=use_ais, ais_initialization=ais_initialization,
            prune_similar=prune_similar, compute_clusters=compute_clusters,
            dynamic_window=dynamic_window, select_kw=select_kw)
        outs.append(out)
    return state, init_state, StepOutputs(*[torch.stack(f)
                                            for f in zip(*outs)])


_NP_DTYPE = {torch.float32: np.float32, torch.int32: np.int32,
             torch.bool: np.bool_}
_TORCH_DTYPE = {v: k for k, v in _NP_DTYPE.items()}


def _to_device(host: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``; through pinned memory, without
    waiting, when that is a GPU."""
    t = torch.from_numpy(host)
    if device.type == 'cuda':
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def tensors_to_host(tensors) -> list:
    """Device tensors (f32, i32 or bool) copied to the host in ONE
    transfer: their bytes are packed into one uint8 tensor, fetched, and
    split into numpy arrays of the original dtypes and shapes."""
    parts = [t.reshape(-1).view(torch.uint8) for t in tensors]
    host = sync.fetch(torch.cat(parts)).numpy()
    fields, o = [], 0
    for t, p in zip(tensors, parts):
        n = p.numel()
        fields.append(host[o:o + n].view(_NP_DTYPE[t.dtype])
                      .reshape(tuple(t.shape)))
        o += n
    return fields


def outputs_to_host(out: StepOutputs) -> StepOutputs:
    """All step outputs (of one scan, or stacked over a chunk of scans)
    as numpy, after one transfer."""
    return StepOutputs(*tensors_to_host(out))


@dataclasses.dataclass
class TrackArchive:
    """Host-side confirmed history of one track."""
    track_id: int
    times: list
    states: list           # np [4]
    meas: list             # int labels (0 missed, m>=1 radar)
    mmsi: list
    status: str = 'Active'


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _resolve_device(device, who: str = "Tracker") -> torch.device:
    """``None`` means the GPU.  The CPU (the plain twins of the kernels)
    is taken only when the caller asks for it: without a CUDA device
    ``None`` raises instead of carrying on on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: no CUDA device is available and none was named; "
            "pass device='cpu' to run on the CPU (plain torch twins of "
            "the kernels)")
    return torch.device('cuda')


class Tracker:
    """Host-facing tracker with the JAX Tracker's API, on one torch
    device: the GPU unless the caller names another (``device='cpu'``
    runs the kernels' plain twins; with no CUDA device and no ``device``
    the constructor raises).

    Usage::

        tracker = Tracker(shapes, params)
        for scan in scans:
            tracker.add_measurement_list(t, z)   # z: [n, 2] numpy
        tracks = tracker.get_tracks()

    ``method`` defaults to ``'ipm'``, as in the JAX class: the dense
    interior-point solve with truncated branch-and-bound, a cross-check
    solver of thousands of small device operations per conflicted scan.
    The benchmark and production run ``method='lagrangian'`` (the tiered
    hybrid); ``'lagrangian_pure'`` and ``'greedy'`` are the other two
    (core/select.py).  ``use_ais`` (default on, as in the JAX class) runs
    grow's AIS branch every scan, on an empty batch when a scan brings
    no ``ais_messages``; ``ais_initialization`` lets unclaimed messages
    seed preliminary tracks.  ``prune_similar`` merges near-identical
    sibling hypotheses after grow.  ``dynamic_window`` applies the host
    triggers of ``_dynamic_window`` after every stepped scan (``stream``
    takes its own, on-device, ``dynamic_window``);
    ``degrade_on_overload`` lets the wall-clock roof halve the beam
    (``degrade``).  ``host_syncs`` records, per scan step, how many times
    the host read a device value (loop exits, branches and the one output
    transfer); ``chunk_syncs`` the same per streamed chunk, as (scans,
    reads).  Every wall-clock trigger reads the time through
    ``self._clock``.

    On the card, ``method`` ``'lagrangian'``, ``'lagrangian_pure'`` or
    ``'greedy'``, with or without AIS and with or without the pre-gate,
    steps as one captured CUDA graph per set of shapes, method and flags,
    replayed once per scan with no host read inside (core/graph.py, the
    counterpart of the JAX class's jitted step): ``self.state`` and
    ``self.init_state`` are then the graph's buffers, written over by
    each scan (copy a state to keep it), ``degrade`` captures anew (at
    the new L and AIS width), and ``stream`` replays a graph of its own
    per scan.  ``'ipm'`` steps eagerly, as everything does on the CPU.
    """

    def __init__(self, shapes: TrackerShapes = TrackerShapes(),
                 params: TrackerParams = TrackerParams(),
                 method: str = 'ipm', use_ais: bool = True,
                 ais_initialization: bool = True,
                 pipeline_outputs: bool = False,
                 prune_similar: bool = False,
                 dynamic_window: bool = False,
                 degrade_on_overload: bool = False,
                 device=None):
        self.shapes = shapes
        self.params = params
        self.method = method
        self.use_ais = use_ais
        self.ais_initialization = ais_initialization
        self.device = _resolve_device(device)
        self.pipeline_outputs = pipeline_outputs
        self.prune_similar = prune_similar
        self.dynamic_window = dynamic_window
        self.degrade_on_overload = degrade_on_overload
        self._degrade_cooldown = 0
        self._clock = time.perf_counter
        self._pending = None      # (device outputs, scan count)
        self._graphs = {}         # captured steps (core/graph.py) by key
        self.state = empty_state(shapes, params, self.device)
        self.init_state = initiator_mod.empty_initiator(shapes, self.device)
        self.archives = {}          # id -> TrackArchive
        self.terminated = {}        # id -> TrackArchive
        self.init_P = {}            # id -> initial covariance [4,4]
        self.scan_times = []
        self.scan_history = []      # raw numpy measurements per scan
        self.ais_history = []       # AIS message list per scan
        self.runtime = RuntimeLog(radar_period=params.radar_period)
        self.runtime_log = []       # wall seconds per scan
        self.host_syncs = []        # host reads of device values per scan
        self.chunk_syncs = []       # (scans, host reads) per streamed chunk
        self.t0 = None

    # -- input --------------------------------------------------------
    def _pad_scan(self, t, z) -> np.ndarray:
        """[M+1, 2] f32: rows 0..M-1 the measurements, row M (count,
        time)."""
        M = self.shapes.max_meas
        z = np.asarray(z, np.float32).reshape(-1, 2)
        n = min(len(z), M)
        packed = np.zeros((M + 1, 2), np.float32)
        packed[:n] = z[:n]
        packed[M] = (n, t)
        if len(z) > M:
            logging.getLogger(__name__).warning(
                "scan has %d measurements; capacity %d — dropping overflow",
                len(z), M)
        return packed

    def _pad_ais(self, messages) -> list:
        """The AisBatch fields of one scan as numpy, padded to A; message
        times relative to ``t0``."""
        A = self.shapes.max_ais
        st = np.zeros((A, 4), np.float32)
        tm = np.zeros((A,), np.float32)
        mm = np.zeros((A,), np.int32)
        hi = np.zeros((A,), bool)
        mask = np.zeros((A,), bool)
        if len(messages) > A:
            logging.getLogger(__name__).warning(
                "scan has %d AIS messages; capacity %d — dropping overflow",
                len(messages), A)
        for i, m in enumerate(messages[:A]):
            st[i] = np.asarray(m.state, np.float32)
            tm[i] = float(m.time) - self.t0
            mm[i] = int(m.mmsi)
            hi[i] = bool(getattr(m, 'highAccuracy', False))
            mask[i] = True
        return [st, tm, mm, hi, mask]

    def _pack_inputs(self, t, z, ais_messages=()) -> torch.Tensor:
        """One scan's inputs on the device after ONE host-to-device
        transfer: the bytes of the padded scan and, with ``use_ais``, of
        the padded AIS batch behind it (4-byte fields first; integers and
        flags travel as their own bytes, never as float values)."""
        parts = [self._pad_scan(t, z)]
        if self.use_ais:
            parts += self._pad_ais(list(ais_messages))
        return _to_device(np.concatenate(
            [p.reshape(-1).view(np.uint8) for p in parts]), self.device)

    def _unpack_inputs(self, packed: torch.Tensor):
        """(Scan, AisBatch or None) as views of ``_pack_inputs``' bytes."""
        M, A = self.shapes.max_meas, self.shapes.max_ais
        o = 0

        def take(shape, dtype):
            nonlocal o
            n = int(np.prod(shape)) * dtype.itemsize
            out = packed[o:o + n].view(dtype).view(shape)
            o += n
            return out

        sc = take((M + 1, 2), torch.float32)
        scan = Scan(z=sc[:M],
                    mask=torch.arange(M, device=self.device) < sc[M, 0].int(),
                    time=sc[M, 1])
        if not self.use_ais:
            return scan, None
        return scan, AisBatch(
            state=take((A, 4), torch.float32), time=take((A,), torch.float32),
            mmsi=take((A,), torch.int32),
            high_accuracy=take((A,), torch.bool),
            mask=take((A,), torch.bool))

    def _graphed(self, kw) -> bool:
        return graph_mod.graphable(self.state, self.method,
                                   kw.get('select_kw'))

    def _graph(self, flags: dict) -> graph_mod.StepGraph:
        return graph_mod.get(self._graphs, self.state, self.init_state,
                             self.shapes, self.params,
                             dict(flags, method=self.method,
                                  use_ais=self.use_ais,
                                  ais_initialization=self.ais_initialization,
                                  prune_similar=self.prune_similar))

    def _step(self, packed, **kw):
        scan, ais = self._unpack_inputs(packed)
        if self._graphed(kw):
            g = self._graph(kw)
            g.load(self.state, self.init_state)
            out = g(scan, ais)
            if self.pipeline_outputs:    # kept past the next replay
                out = StepOutputs(*(t.clone() for t in out))
            return g.state, g.init_state, out
        return scan_step(self.state, self.init_state, scan, ais,
                         self.shapes, self.params, method=self.method,
                         use_ais=self.use_ais,
                         ais_initialization=self.ais_initialization,
                         prune_similar=self.prune_similar, **kw)

    def pre_initialize(self, t, states, mmsi=None):
        """Seed confirmed targets from known initial states."""
        if self.t0 is None:
            self.t0 = float(t) - self.params.radar_period
        K = len(states)
        dev = self.device
        x = np.zeros((max(K, 1), 4), np.float32)
        x[:K] = np.asarray(states, np.float32)
        mask = np.zeros((max(K, 1),), bool)
        mask[:K] = True
        mm = np.zeros((max(K, 1),), np.int32)
        if mmsi is not None:
            mm[:K] = np.asarray(mmsi, np.int32)
        self.state = insert_targets(
            self.state, torch.from_numpy(x).to(dev),
            pv.P0(dev).expand(max(K, 1), 4, 4),
            torch.from_numpy(mask).to(dev), torch.from_numpy(mm).to(dev),
            torch.full((), float(t) - self.t0, dtype=torch.float32,
                       device=dev), self.params)

    # -- main entry ---------------------------------------------------
    def add_measurement_list(self, t, z, ais_messages=None,
                             check_integrity: bool = False, **kwargs):
        """One radar scan with the AIS messages received since the
        previous one (objects with ``state``, ``time``, ``mmsi`` and
        ``highAccuracy``; read only with ``use_ais``).  Returns the step
        outputs as numpy (or, with ``pipeline_outputs``, the device
        outputs, absorbed next scan).  ``check_integrity`` (or the
        ``checkIntegrity`` kwarg) runs the structural invariants after
        the scan and raises AssertionError on a violation."""
        tic = self._clock()
        check_integrity = check_integrity or kwargs.pop('checkIntegrity',
                                                        False)
        if self.t0 is None:
            # device time is relative to the first scan for fp32 safety
            self.t0 = float(t) - self.params.radar_period
        t_rel = float(t) - self.t0
        self.scan_history.append(np.asarray(z, np.float32).reshape(-1, 2))
        self.ais_history.append(list(ais_messages or []))
        n_sync = sync.count
        self.state, self.init_state, out = self._step(
            self._pack_inputs(t_rel, z, ais_messages or ()))
        self.scan_times.append(t_rel)
        if self.pipeline_outputs:
            self.flush()
            self._pending = (out, len(self.scan_times))
            self.host_syncs.append(sync.count - n_sync)
            self._record_wall(self._clock() - tic)
            if check_integrity:
                self.check_integrity()
            return out
        out_np = outputs_to_host(out)
        self.host_syncs.append(sync.count - n_sync)
        self._absorb_outputs(out_np, n_scans=len(self.scan_times))
        dt_wall = self._clock() - tic
        self._record_wall(dt_wall)
        if self.dynamic_window:
            self._dynamic_window(dt_wall, out_np.leaf_counts,
                                 out_np.gated_counts)
        if check_integrity:
            self.check_integrity()
        return out_np

    def _record_wall(self, seconds):
        self.runtime_log.append(seconds)
        self.runtime.record('Total', seconds)

    def _dynamic_window(self, dt_wall, leaf_counts, gated_counts=None):
        """Graceful degradation under load on the stepped path, three
        triggers in escalating scope:

        1. per-target time budget: each target's share of the scan's wall
           time is estimated from its growth-cost proxy (live leaves x
           gated pairs); a target whose estimate exceeds
           ``params.max_target_time`` shrinks its window;
        2. beam saturation: a target whose hypothesis beam is full is
           over budget in capacity and shrinks its window;
        3. global roof: a whole-scan wall time above 80 % of the radar
           period lowers the window roof for every target and, with
           ``degrade_on_overload``, halves the beam (``degrade``), after
           which three scans pass before the beam may shrink again.
        The first two scans never count as load."""
        L = self.shapes.max_leaves
        tw = sync.fetch(self.state.tgt_window).numpy()
        warm = len(self.scan_times) > 2
        if gated_counts is not None and warm:
            proxy = (np.asarray(leaf_counts, np.float64)
                     * (1.0 + np.asarray(gated_counts, np.float64)))
            total = proxy.sum()
            if total > 0:
                over = dt_wall * proxy / total > self.params.max_target_time
                tw = np.where(over, np.maximum(tw - 1, 1), tw)
        saturated = np.asarray(leaf_counts) >= L
        tw = np.where(saturated, np.maximum(tw - 1, 1), tw)
        roof = dt_wall > 0.8 * self.params.radar_period and warm
        if roof:
            self._n_roof = max(1, getattr(self, '_n_roof', self.params.N) - 1)
            tw = np.minimum(tw, self._n_roof)
        self.state = self.state.replace(tgt_window=torch.from_numpy(
            np.ascontiguousarray(tw, np.int32)).to(self.device))
        self._degrade_cooldown = max(0, self._degrade_cooldown - 1)
        if roof and self.degrade_on_overload and self._degrade_cooldown == 0:
            if self.degrade():
                self._degrade_cooldown = 3

    def flush(self):
        """Absorb any pipelined outputs still pending on the device."""
        if self._pending is not None:
            prev_out, prev_n = self._pending
            self._pending = None
            self._absorb_outputs(outputs_to_host(prev_out), n_scans=prev_n)

    def degrade(self, beam_factor: int = 2,
                ais_per_leaf: Optional[int] = None, min_leaves: int = 4):
        """Carry on with a narrower hypothesis beam (L -> max(min_leaves,
        L // beam_factor)): compute-shedding degradation.  Under static
        shapes only a smaller beam reduces the work of a scan: about half
        of grow's candidates and half of every selection tensor.  The
        device state is converted by ``state.shrink_beam`` (one gather)
        and ``self.shapes`` follows; ``ais_per_leaf`` also narrows the
        AIS fusion width.  Returns True if the beam shrank.  One-way."""
        L = self.shapes.max_leaves
        new_L = max(min_leaves, L // beam_factor)
        if new_L >= L:
            return False
        self.flush()
        self._graphs.clear()      # re-captured at the new shapes
        self.state = shrink_beam(self.state, new_L)
        kw = dict(max_leaves=new_L)
        if ais_per_leaf is not None:
            kw['ais_per_leaf'] = max(0, min(ais_per_leaf,
                                            self.shapes.max_ais))
        self.shapes = dataclasses.replace(self.shapes, **kw)
        return True

    # -- streaming ----------------------------------------------------
    def make_stream_inputs(self, scans, ais_groups=None):
        """The inputs of ``scan_many`` for a chunk of scans, on the device
        after ONE host-to-device transfer.

        ``scans``: objects with ``.time`` (absolute) and ``.measurements``
        [n, 2]; ``ais_groups``: optional per-scan lists of AIS messages.
        Returns (Scan, AisBatch) with a leading scan axis and every time
        relative to the tracker's origin ``self.t0`` (any other base
        shifts the first scan's dt and breaks pre-initialised tracks).
        Call after ``pre_initialize``, or the origin is taken from the
        first scan."""
        scans = list(scans)
        if self.t0 is None:
            self.t0 = float(scans[0].time) - self.params.radar_period
        n, M, A = len(scans), self.shapes.max_meas, self.shapes.max_ais
        n_z_over = n_ais_over = 0
        zb = np.zeros((n, M, 2), np.float32)
        tb = np.zeros((n,), np.float32)
        a_st = np.zeros((n, A, 4), np.float32)
        a_tm = np.zeros((n, A), np.float32)
        a_mm = np.zeros((n, A), np.int32)
        mb = np.zeros((n, M), bool)
        a_hi = np.zeros((n, A), bool)
        a_mk = np.zeros((n, A), bool)
        for i, s in enumerate(scans):
            z = np.asarray(s.measurements, np.float32).reshape(-1, 2)
            k = min(len(z), M)
            n_z_over += max(0, len(z) - M)
            zb[i, :k] = z[:k]
            mb[i, :k] = True
            tb[i] = float(s.time) - self.t0
            group = (ais_groups[i] if ais_groups is not None
                     and i < len(ais_groups) else [])
            n_ais_over += max(0, len(group) - A)
            for j, m in enumerate(group[:A]):
                a_st[i, j] = np.asarray(m.state, np.float32)
                a_tm[i, j] = float(m.time) - self.t0
                a_mm[i, j] = int(m.mmsi)
                a_hi[i, j] = bool(getattr(m, 'highAccuracy', False))
                a_mk[i, j] = True
        if n_z_over or n_ais_over:
            # a silent shape overflow skews streaming results
            logging.getLogger(__name__).warning(
                "make_stream_inputs: dropped %d measurements and %d AIS "
                "messages overflowing static shapes (M=%d, A=%d) across "
                "%d scans — raise TrackerShapes.max_meas/max_ais",
                n_z_over, n_ais_over, M, A, n)
        # 4-byte fields first, so every view below is aligned
        fields = [zb, tb, a_st, a_tm, a_mm, mb, a_hi, a_mk]
        packed = _to_device(np.concatenate(
            [f.reshape(-1).view(np.uint8) for f in fields]), self.device)
        views, o = [], 0
        for f in fields:
            views.append(packed[o:o + f.nbytes].view(_TORCH_DTYPE[f.dtype.type])
                         .view(f.shape))
            o += f.nbytes
        zb, tb, a_st, a_tm, a_mm, mb, a_hi, a_mk = views
        return (Scan(z=zb, mask=mb, time=tb),
                AisBatch(state=a_st, time=a_tm, mmsi=a_mm,
                         high_accuracy=a_hi, mask=a_mk))

    def stream(self, scans, ais_groups=None, chunk: int = 16,
               compute_clusters: bool = False,
               dynamic_window: bool = False):
        """Device-resident streaming with host supervision: ``chunk``
        scans go to the device in one transfer and through ``scan_many``
        with nothing fetched in between; the chunk's stacked outputs come
        back in ONE transfer and every scan is absorbed into the same
        per-track archives as ``add_measurement_list``.  Between chunks
        the host supervises by the wall clock: the runtime log and, with
        ``degrade_on_overload``, the roof-triggered switch to the
        half-beam state when a chunk took more than 80 % of the radar
        period per scan.  The first chunk of a call never counts as load
        (on the card it pays the kernel build and the warm-up), and the
        chunk after a degrade is not checked, so that one overlong chunk
        cannot collapse the beam to its minimum.  ``dynamic_window`` is
        the on-device window trigger of ``scan_step``.

        Returns the list of per-chunk stacked StepOutputs (host numpy)."""
        scans = list(scans)
        if not scans:
            return []
        if self.t0 is None:
            self.t0 = float(scans[0].time) - self.params.radar_period
        self.flush()
        outs_all = []
        # chunks still to pass unchecked after a degrade; counted in
        # chunks, so kept apart from the stepped path's cooldown in scans
        cooldown = 0
        for n_chunks_done, i0 in enumerate(range(0, len(scans), chunk)):
            sub = scans[i0:i0 + chunk]
            group = (ais_groups[i0:i0 + chunk]
                     if ais_groups is not None else None)
            tic = self._clock()
            n_sync = sync.count
            scan_b, ais_b = self.make_stream_inputs(sub, group)
            if self._graphed({}):
                self.state, self.init_state, outs = graph_mod.replay_many(
                    self._graph(dict(compute_clusters=compute_clusters,
                                     dynamic_window=dynamic_window)),
                    self.state, self.init_state, scan_b, ais_b)
            else:
                self.state, self.init_state, outs = scan_many(
                    self.state, self.init_state, scan_b, ais_b, self.shapes,
                    self.params, method=self.method, use_ais=self.use_ais,
                    ais_initialization=self.ais_initialization,
                    compute_clusters=compute_clusters,
                    dynamic_window=dynamic_window,
                    prune_similar=self.prune_similar)
            outs_np = outputs_to_host(outs)
            self.chunk_syncs.append((len(sub), sync.count - n_sync))
            per_scan = (self._clock() - tic) / len(sub)
            for j, s in enumerate(sub):
                self.scan_history.append(
                    np.asarray(s.measurements, np.float32).reshape(-1, 2))
                self.ais_history.append(
                    list(group[j]) if group is not None and j < len(group)
                    else [])
                self.scan_times.append(float(s.time) - self.t0)
                self._absorb_outputs(StepOutputs(*(f[j] for f in outs_np)),
                                     n_scans=len(self.scan_times))
                self._record_wall(per_scan)
            # supervision between chunks
            if cooldown > 0:
                cooldown -= 1
            elif (n_chunks_done >= 1 and self.degrade_on_overload
                    and per_scan > 0.8 * self.params.radar_period):
                if self.degrade():
                    cooldown = 1
            outs_all.append(outs_np)
        return outs_all

    addMeasurementList = add_measurement_list

    # -- observability --------------------------------------------------
    def print_time_log(self):
        print(self.runtime.summary())

    printTimeLog = print_time_log

    def profile_phases(self, t, z, ais_messages=None, record=True):
        """Per-phase timing of one scan: each phase run alone on the
        current state (utils/timing.phase_profile); with ``record`` the
        results enter ``self.runtime``.  Does NOT mutate tracker state."""
        from ..utils.timing import phase_profile
        phases = phase_profile(self, t, z, ais_messages)
        if record:
            for k, v in phases.items():
                self.runtime.record(k, v)
        return phases

    def get_runtime_average(self):
        return self.runtime.averages()

    def print_target_list(self):
        """One line per active target: id, current best state, leaf count
        and score."""
        st = self.state
        sel, xs, cn = _np(st.sel_leaf), _np(st.leaf_x), _np(st.leaf_cnllr)
        ids, nleaf = _np(st.tgt_id), _np(st.leaf_mask).sum(axis=1)
        print("Target list:")
        for slot in np.nonzero(_np(st.tgt_mask))[0]:
            x = xs[slot, sel[slot]]
            print(f"  T{int(ids[slot]):<4d} pos=({x[0]:8.1f},{x[1]:8.1f}) "
                  f"vel=({x[2]:6.2f},{x[3]:6.2f}) "
                  f"leaves={int(nleaf[slot]):3d} "
                  f"cnllr={float(cn[slot, sel[slot]]):8.3f}")

    printTargetList = print_target_list

    def print_cluster_list(self):
        """Clusters of targets sharing gated measurements."""
        labels, n = cluster(self.state, self.shapes)
        labels, ids = _np(labels), _np(self.state.tgt_id)
        groups = {}
        for slot in np.nonzero(_np(self.state.tgt_mask))[0]:
            groups.setdefault(int(labels[slot]), []).append(int(ids[slot]))
        print(f"Cluster list ({int(n)} clusters):")
        for i, (_, members) in enumerate(sorted(groups.items())):
            print(f"  Cluster {i}: targets {members}")

    printClusterList = print_cluster_list

    def check_integrity(self):
        """Structural invariants of the forest state
        (utils/integrity.py).  Raises AssertionError on violation."""
        from ..utils.integrity import check_state_integrity
        check_state_integrity(self)

    checkIntegrity = check_integrity

    def _absorb_outputs(self, out, n_scans=None):
        W = self.shapes.window
        n = n_scans if n_scans is not None else len(self.scan_times)

        def col_time(w):
            # window column w is scan index (n-1) - (W-1-w)
            i = n - 1 - (W - 1 - w)
            return self.scan_times[i] if 0 <= i < n else None

        # the true initial covariance of tracks inserted this scan (the
        # initiator's two-point covariance)
        for slot in np.nonzero(out.inserted_mask)[0]:
            self.init_P[int(out.inserted_id[slot])] = np.asarray(
                out.inserted_P[slot], np.float64)

        reasons = {1: 'OutOfRange', 2: 'TooLowScore', 3: 'TooLowScore'}
        for slot in np.nonzero(out.track_mask)[0]:
            tid = int(out.track_id[slot])
            arch = self.archives.setdefault(tid, TrackArchive(
                tid, [], [], [], []))
            dead = bool(out.dead[slot])
            valid = out.sel_hist_valid if dead else out.confirmed_mask
            xs = out.sel_hist_x if dead else out.confirmed_x
            meas = out.sel_hist_meas if dead else out.confirmed_meas
            mmsi = out.sel_hist_mmsi if dead else out.confirmed_mmsi
            # a dead track archives its whole remaining selected window
            for w in range(W):
                if valid[slot, w]:
                    arch.times.append(col_time(w))
                    arch.states.append(xs[slot, w].copy())
                    arch.meas.append(int(meas[slot, w]))
                    arch.mmsi.append(int(mmsi[slot, w]))
            if dead:
                arch.status = reasons.get(int(out.dead_reason[slot]),
                                          'Terminated')
                self.terminated[tid] = arch
                self.archives.pop(tid, None)

    # -- outputs ------------------------------------------------------
    def get_tracks(self):
        """Active tracks: id -> dict with confirmed history + current
        window of the selected hypothesis."""
        st = self.state
        ids, mask = _np(st.tgt_id), _np(st.tgt_mask)
        sel, depth = _np(st.sel_leaf), _np(st.tgt_depth)
        hist_x, hist_meas = _np(st.hist_x), _np(st.hist_meas)
        hist_mmsi = _np(st.hist_mmsi)
        W = self.shapes.window
        n = len(self.scan_times)
        tracks = {}
        for slot in np.nonzero(mask)[0]:
            tid = int(ids[slot])
            arch = self.archives.get(tid)
            cols = range(W - depth[slot], W)
            s = sel[slot]
            tracks[tid] = {
                'confirmed_times': list(arch.times) if arch else [],
                'confirmed_states': list(arch.states) if arch else [],
                'confirmed_meas': list(arch.meas) if arch else [],
                'confirmed_mmsi': list(arch.mmsi) if arch else [],
                'window_times': [self.scan_times[n - 1 - (W - 1 - w)]
                                 for w in cols],
                'window_states': [hist_x[slot, s, w] for w in cols],
                'window_meas': [int(hist_meas[slot, s, w]) for w in cols],
                'window_mmsi': [int(hist_mmsi[slot, s, w]) for w in cols],
            }
        return tracks

    def _track_measurement_sequences(self, include_terminated=False):
        """Per track: (times, labels, states, mmsi) per scan, combining
        the confirmed archive with the current selected window."""
        seqs = {}
        for tid, tr in self.get_tracks().items():
            times = tr['confirmed_times'] + tr['window_times']
            if not times:
                continue
            seqs[tid] = (times, tr['confirmed_meas'] + tr['window_meas'],
                         tr['confirmed_states'] + tr['window_states'],
                         tr['confirmed_mmsi'] + tr['window_mmsi'])
        if include_terminated:
            for tid, arch in self.terminated.items():
                if arch.times:
                    seqs[tid] = (list(arch.times), list(arch.meas),
                                 list(arch.states), list(arch.mmsi))
        return seqs

    def get_smooth_tracks(self, em_iters: int = 0,
                          include_terminated: bool = False,
                          em_mode: str = 'scalar'):
        """RTS-smoothed (positions, velocities, ok) per track id.

        Each track's selected measurements are looked up in
        ``scan_history``; all tracks are padded to a common power-of-two
        length and smoothed in ONE batched call on the tracker's device
        (ops/smoother.smooth_tracks); trailing masked steps do not
        perturb the smoothed interior.  A track with fewer than two
        measurements comes back unsmoothed with ``ok`` False.
        ``em_iters=5, em_mode='full'`` refits Q, R, x0 and P0 per track
        as pykalman's EM does; the default is pure RTS on the pv model."""
        from ..ops.smoother import smooth_tracks
        time_to_idx = {t: i for i, t in enumerate(self.scan_times)}
        out = {}
        batch = []                      # (tid, zs [n,2], mask [n], x0)
        for tid, (times, labels, states, _mmsi) in \
                self._track_measurement_sequences(include_terminated).items():
            zs, mask = [], []
            for t, lab in zip(times, labels):
                idx = time_to_idx.get(t)
                if idx is None or lab is None or lab < 1 \
                        or lab - 1 >= len(self.scan_history[idx]):
                    zs.append(np.zeros(2, np.float32))
                    mask.append(False)
                else:
                    zs.append(self.scan_history[idx][lab - 1])
                    mask.append(True)
            zs = np.array(zs, np.float32).reshape(-1, 2)
            mask = np.array(mask, bool)
            if mask.sum() < 2:
                pos = np.where(mask[:, None], zs, np.nan)
                out[tid] = (pos, np.full_like(pos, np.nan), False)
                continue
            batch.append((tid, zs, mask, np.asarray(states[0], np.float32)))
        if not batch:
            return out
        n_max = max(len(b[2]) for b in batch)
        n_pad = 1 << (n_max - 1).bit_length()
        B = len(batch)
        zb = np.zeros((B, n_pad, 2), np.float32)
        mb = np.zeros((B, n_pad), bool)
        x0b = np.zeros((B, 4), np.float32)
        for i, (_, zs, mask, x0) in enumerate(batch):
            zb[i, :len(mask)] = zs
            mb[i, :len(mask)] = mask
            x0b[i] = x0
        dev = self.device
        xs_b, _ = smooth_tracks(
            torch.from_numpy(x0b).to(dev), pv.P0(dev).expand(B, 4, 4),
            torch.from_numpy(zb).to(dev), torch.from_numpy(mb).to(dev),
            self.params.radar_period, em_iters=em_iters, em_mode=em_mode)
        xs_b = _np(xs_b)
        for i, (tid, _, mask, _) in enumerate(batch):
            xs = xs_b[i, :len(mask)]
            out[tid] = (xs[:, :2], xs[:, 2:], True)
        return out

    getSmoothTracks = get_smooth_tracks

    def get_track_states(self):
        """(ids, [n_active, 4] current best state) of the active tracks."""
        st = self.state
        sel, x, ids = _np(st.sel_leaf), _np(st.leaf_x), _np(st.tgt_id)
        slots = np.nonzero(_np(st.tgt_mask))[0]
        if len(slots) == 0:
            return ids[:0], np.zeros((0, 4), np.float32)
        return ids[slots], np.stack([x[s, sel[s]] for s in slots])

    def get_track_nodes(self):
        """Current best state per active track id."""
        ids, states = self.get_track_states()
        return {int(i): s for i, s in zip(ids, states)}

    getTrackNodes = get_track_nodes

    def compare_tracks_with_truth(self, truth_states):
        """NEES of each active track against a paired truth state."""
        st = self.state
        sel, xs, Ps = _np(st.sel_leaf), _np(st.leaf_x), _np(st.leaf_P)
        out = []
        for slot, xt in zip(np.nonzero(_np(st.tgt_mask))[0], truth_states):
            d = xs[slot, sel[slot]] - np.asarray(xt)
            Pi = np.linalg.inv(Ps[slot, sel[slot]] + 1e-9 * np.eye(4))
            out.append(float(d @ Pi @ d))
        return out

"""The per-scan tracker pipeline and the host-facing Tracker class
(counterpart of pymht_tpu/core/tracker.py).

Device side: ``scan_step`` composes grow (radar and, with ``use_ais``,
AIS fusion) -> select -> terminate -> N-scan prune -> initiate -> insert
on tensors of one device.  Host side: ``Tracker`` keeps the JAX
Tracker's API (``add_measurement_list``, ``pre_initialize``,
``get_tracks``) and archives each track's confirmed past as numpy,
appended from the prune outputs every scan.

Raising NotImplementedError: ``prune_similar``, the dynamic window,
degradation, streaming and the smoother.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import sync
from ..models import pv
from .config import TrackerShapes, TrackerParams
from .state import TrackerState, empty_state, insert_targets
from .grow import AisBatch, Scan, grow
from .select import select
from .lifecycle import n_scan_prune, terminate
from . import initiator as initiator_mod


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


def _not_ported(what):
    raise NotImplementedError(f"{what} is not ported to the torch package "
                              f"yet")


def scan_step(state: TrackerState, init_state, scan: Scan,
              ais: Optional[AisBatch], shapes: TrackerShapes,
              params: TrackerParams, method: str = 'lagrangian',
              use_ais: bool = True, ais_initialization: bool = True,
              compute_clusters: bool = True,
              select_kw: Optional[dict] = None):
    """One radar scan through the full pipeline.  ``ais`` is the scan's
    AisBatch; it is not read when ``use_ais`` is false (and may then be
    None)."""
    if use_ais and not isinstance(ais, AisBatch):
        raise TypeError("scan_step: use_ais=True needs an AisBatch "
                        "(grow.empty_ais for a scan with no messages)")
    T, L, W = state.hist_meas.shape
    dev = state.leaf_x.device
    tb = torch.arange(T, device=dev)

    # 1. grow
    g = grow(state, scan, ais if use_ais else None, shapes, params)
    state = g.state

    # 2-3. cluster + global hypothesis selection
    sel_res = select(state, shapes, params, method=method,
                     compute_clusters=compute_clusters, **(select_kw or {}))
    state = state.replace(sel_leaf=sel_res.sel, lam=sel_res.lam)
    sel = sel_res.sel.long()
    track_x = state.leaf_x[tb, sel]
    track_cnllr = state.leaf_cnllr[tb, sel]
    sel_hist_valid = ((torch.arange(W, device=dev)[None, :]
                       >= (W - state.tgt_depth)[:, None])
                      & state.tgt_mask[:, None])
    sel_hist_x = state.hist_x[tb, sel]
    sel_hist_meas = state.hist_meas[tb, sel]
    sel_hist_mmsi = state.hist_mmsi[tb, sel]
    track_mask, track_id = state.tgt_mask, state.tgt_id

    # 6. terminate, 7. N-scan prune
    term = terminate(state, shapes, params)
    state = term.state
    pr = n_scan_prune(state, shapes, params)
    state = pr.state

    # 8. initiate from the measurements no leaf gated
    if use_ais and ais_initialization:
        # messages whose MMSI a surviving leaf associated this scan are
        # not available for initiation
        cur_mmsi = torch.where(state.leaf_mask, state.hist_mmsi[:, :, -1], 0)
        ais_for_init = ais._replace(
            mask=ais.mask & ~torch.isin(ais.mmsi, cur_mmsi.reshape(-1)))
    else:
        ais_for_init = None
    init_out = initiator_mod.step(init_state, scan.z, scan.mask & ~g.used_meas,
                                  scan.time, ais_for_init, shapes, params)
    init_state = init_out.state
    new_x, new_mask, new_mmsi = _merge_new_targets(
        init_out.new_x, init_out.new_mask, init_out.new_mmsi,
        params.merge_threshold)
    # reject new targets neighbouring an existing track's leaf
    leaf_pos = state.leaf_x[..., :2].reshape(-1, 2)
    d = torch.linalg.vector_norm(new_x[:, None, :2] - leaf_pos[None, :, :],
                                 dim=2)
    near = ((d < params.merge_threshold)
            & state.leaf_mask.reshape(-1)[None, :])
    new_mask = new_mask & ~near.any(dim=1)
    prev_mask = state.tgt_mask
    state = insert_targets(state, new_x, init_out.new_P, new_mask, new_mmsi,
                           scan.time, params)
    inserted = state.tgt_mask & ~prev_mask

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
        inserted_P=state.leaf_P[:, 0],
        n_clusters=sel_res.n_clusters, sel_obj=sel_res.obj,
        sel_bound=sel_res.bound, sel_feasible=sel_res.feasible,
        n_leaves=live.sum().int(), leaf_counts=live.sum(dim=1).int(),
        gated_counts=g.gated_counts, used_meas=g.used_meas)
    return state, init_state, outputs


def _merge_new_targets(new_x, new_mask, new_mmsi, threshold):
    """Greedy group-by-proximity merge: each candidate joins the first
    candidate within ``threshold``; representatives take the mean state."""
    K = new_x.shape[0]
    d = torch.linalg.vector_norm(new_x[:, None, :2] - new_x[None, :, :2],
                                 dim=2)
    close = (d < threshold) & new_mask[:, None] & new_mask[None, :]
    first = close.int().argmax(dim=1)
    rep = first == torch.arange(K, device=new_x.device)
    member_of = (torch.nn.functional.one_hot(first, K).float()
                 * new_mask[:, None])
    counts = member_of.sum(dim=0)
    mean_x = (member_of.T @ new_x) / torch.clamp(counts[:, None], min=1.0)
    keep = new_mask & rep
    return (torch.where(keep[:, None], mean_x, new_x), keep,
            torch.where(keep, new_mmsi, 0))


def scan_many(state, init_state, scans: Scan, ais: Optional[AisBatch],
              shapes: TrackerShapes, params: TrackerParams,
              method: str = 'lagrangian', use_ais: bool = True,
              ais_initialization: bool = True,
              compute_clusters: bool = False,
              select_kw: Optional[dict] = None):
    """Process a batch of scans (leading time axis on ``scans`` and on
    ``ais``) one ``scan_step`` after another.  Returns (state,
    init_state, stacked StepOutputs)."""
    outs = []
    for i in range(scans.z.shape[0]):
        scan = Scan(*(f[i] for f in scans))
        ais_i = AisBatch(*(f[i] for f in ais)) if use_ais else None
        state, init_state, out = scan_step(
            state, init_state, scan, ais_i, shapes, params, method=method,
            use_ais=use_ais, ais_initialization=ais_initialization,
            compute_clusters=compute_clusters, select_kw=select_kw)
        outs.append(out)
    return state, init_state, StepOutputs(*[torch.stack(f)
                                            for f in zip(*outs)])


_NP_DTYPE = {torch.float32: np.float32, torch.int32: np.int32,
             torch.bool: np.bool_}


def outputs_to_host(out: StepOutputs) -> StepOutputs:
    """All step outputs copied to the host in ONE transfer: the fields'
    bytes are packed into one uint8 tensor, fetched, and split into
    numpy arrays of the original dtypes and shapes."""
    parts = [t.reshape(-1).view(torch.uint8) for t in out]
    host = sync.fetch(torch.cat(parts)).numpy()
    fields, o = [], 0
    for t, p in zip(out, parts):
        n = p.numel()
        fields.append(host[o:o + n].view(_NP_DTYPE[t.dtype])
                      .reshape(tuple(t.shape)))
        o += n
    return StepOutputs(*fields)


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


def _resolve_device(device) -> torch.device:
    """``None`` means the GPU.  The CPU (the plain twins of the kernels)
    is taken only when the caller asks for it: without a CUDA device
    ``None`` raises instead of carrying on on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "Tracker: no CUDA device is available and none was named; "
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

    ``method`` defaults to ``'lagrangian'`` (the tiered hybrid, what the
    benchmark and production run); the JAX Tracker's default ``'ipm'``
    is not ported.  ``use_ais`` (default on, as in the JAX class) runs
    grow's AIS branch every scan, on an empty batch when a scan brings
    no ``ais_messages``; ``ais_initialization`` lets unclaimed messages
    seed preliminary tracks.  ``host_syncs`` records, per scan step, how
    many times the host read a device value (loop exits, branches and
    the one output transfer).
    """

    def __init__(self, shapes: TrackerShapes = TrackerShapes(),
                 params: TrackerParams = TrackerParams(),
                 method: str = 'lagrangian', use_ais: bool = True,
                 ais_initialization: bool = True,
                 pipeline_outputs: bool = False,
                 prune_similar: bool = False,
                 dynamic_window: bool = False,
                 degrade_on_overload: bool = False,
                 device=None):
        if prune_similar:
            _not_ported("prune_similar")
        if dynamic_window:
            _not_ported("the dynamic window")
        if degrade_on_overload:
            _not_ported("degradation")
        self.shapes = shapes
        self.params = params
        self.method = method
        self.use_ais = use_ais
        self.ais_initialization = ais_initialization
        self.device = _resolve_device(device)
        self.pipeline_outputs = pipeline_outputs
        self._pending = None      # (device outputs, scan count)
        self.state = empty_state(shapes, params, self.device)
        self.init_state = initiator_mod.empty_initiator(shapes, self.device)
        self.archives = {}          # id -> TrackArchive
        self.terminated = {}        # id -> TrackArchive
        self.scan_times = []
        self.ais_history = []       # AIS message list per scan
        self.host_syncs = []        # host reads of device values per scan
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
        host = torch.from_numpy(np.concatenate(
            [p.reshape(-1).view(np.uint8) for p in parts]))
        if self.device.type == 'cuda':
            return host.pin_memory().to(self.device, non_blocking=True)
        return host.to(self.device)

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

    def _step(self, packed):
        scan, ais = self._unpack_inputs(packed)
        return scan_step(self.state, self.init_state, scan, ais,
                         self.shapes, self.params, method=self.method,
                         use_ais=self.use_ais,
                         ais_initialization=self.ais_initialization)

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
        outputs, absorbed next scan)."""
        if check_integrity or kwargs.pop('checkIntegrity', False):
            _not_ported("check_integrity")
        if self.t0 is None:
            # device time is relative to the first scan for fp32 safety
            self.t0 = float(t) - self.params.radar_period
        t_rel = float(t) - self.t0
        self.ais_history.append(list(ais_messages or []))
        n_sync = sync.count
        self.state, self.init_state, out = self._step(
            self._pack_inputs(t_rel, z, ais_messages or ()))
        self.scan_times.append(t_rel)
        if self.pipeline_outputs:
            self.flush()
            self._pending = (out, len(self.scan_times))
            self.host_syncs.append(sync.count - n_sync)
            return out
        out_np = outputs_to_host(out)
        self.host_syncs.append(sync.count - n_sync)
        self._absorb_outputs(out_np, n_scans=len(self.scan_times))
        return out_np

    def flush(self):
        """Absorb any pipelined outputs still pending on the device."""
        if self._pending is not None:
            prev_out, prev_n = self._pending
            self._pending = None
            self._absorb_outputs(outputs_to_host(prev_out), n_scans=prev_n)

    def degrade(self, *args, **kwargs):
        _not_ported("Tracker.degrade")

    def stream(self, *args, **kwargs):
        _not_ported("Tracker.stream")

    def get_smooth_tracks(self, *args, **kwargs):
        _not_ported("Tracker.get_smooth_tracks")

    def _absorb_outputs(self, out, n_scans=None):
        W = self.shapes.window
        n = n_scans if n_scans is not None else len(self.scan_times)

        def col_time(w):
            # window column w is scan index (n-1) - (W-1-w)
            i = n - 1 - (W - 1 - w)
            return self.scan_times[i] if 0 <= i < n else None

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

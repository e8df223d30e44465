"""Per-phase runtime observability and the port's tracer (the port's own
copy of pymht_tpu/utils/timing.py, with the tracer added).

* ``RuntimeLog`` — per-scan wall clock of the step plus the watchdog
  counts (hard and soft real-time limits against the radar period); a
  tracker's phases come from its steps' device stamps, read when the log
  is read.
* ``phase_profile`` — a debug runner that executes each phase of one scan
  as its own call, closed by ``torch.cuda.synchronize()`` on a CUDA
  device, recovering a per-phase breakdown.  It does not mutate the
  tracker.
* The tracer, one per process and off by default (``trace_on`` /
  ``trace_off`` / ``tracing``).  When off, a span costs one attribute
  test and a stamp is neither launched nor captured.  When on:

  - host spans (``Span``: ``with SPAN:``) go into preallocated arrays, a
    ring of the newest ``SPANS``: name, start and end
    (``time.perf_counter_ns``), parent span and scan number (the step the
    span's outermost span began at); a collection of the garbage
    collector is a ``gc`` span under the span open then.  While
    ``torch.profiler`` records, each span is also a profiler range of its
    name, so it lies on the profiler's timeline beside the device's work;
  - ``stamp(k, device)`` marks the boundaries of a step's phases
    (``STEP_PHASES``, between ``N_STAMPS`` stamps in ``scan_step``): on
    the card a one-thread kernel writes ``%globaltimer`` into a ring in
    device memory whose row the device advances itself
    (``kernels/graph_flow.stamp``), a kernel node when the step is
    captured; on the CPU the host clock.  Whether tracing is on is part of
    a step graph's key (``core/graph.graph_key``), so a graph captured
    with tracing off holds no stamp;
  - ``trace_on`` calibrates the device clock against the host's (a host
    time read before and after one stamp and a synchronise), and ``read``
    again, so the stamps are placed on the spans' clock.

  ``read()`` returns what the rings hold (one host read of the device
  ring), ``summary(trace)`` the means per scan and per step.
* The program's counters (``COUNTERS``), always on: counts the step keeps
  on the device it runs on (``count``), one int64 tensor per device made
  before any capture, so that a captured step adds to it as a kernel node
  and a replay reads nothing.  ``counters()`` reads them, process-wide
  since import (one copy per device, outside any step); the tracer's
  ``read`` gives them since its reset.
"""
from __future__ import annotations

import gc
import time
import weakref
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

PHASES = ('Total', 'Process', 'Cluster', 'Optim', 'DynN',
          'N-Prune', 'Terminate', 'Init')
# the step's phases between its stamps (core/tracker.scan_step), and the
# RuntimeLog entry of each (terminate and N-scan prune are one phase)
STEP_PHASES = ('grow', 'select', 'prune', 'initiate')
RUNTIME_OF = dict(grow='Process', select='Optim', prune='N-Prune',
                  initiate='Init')
N_STAMPS = len(STEP_PHASES) + 1
# the program's counters (``count``): selections that reached tier 3's
# Lagrangian, exact finishes entered, the finish's loop iterations,
# selections whose certificate is still open after it, the small
# clusters tier 2 solved (its non-empty buckets) and tier 2's solves (one
# a selection that reaches it; on the card the kernel adds both itself,
# one launch a solve, ops/enum_kernel.py) (core/select.py)
COUNTERS = ('select_tier3', 'finish_entered', 'finish_iters',
            'finish_open', 'enum_buckets', 'enum_calls')
SPANS = 1 << 16          # host spans kept, the newest
ROWS = 1 << 13           # steps whose stamps are kept, the newest


@dataclass
class RuntimeLog:
    radar_period: float
    _log: dict = field(default_factory=lambda: {k: [] for k in PHASES})
    violations: int = 0
    soft_violations: int = 0
    # {phase: [seconds]} not yet in the log (a tracker's stamped steps),
    # taken whenever the log is read
    pull: Optional[Callable[[], dict]] = None

    @property
    def log(self) -> dict:
        if self.pull is not None:
            for k, v in self.pull().items():
                self._log.setdefault(k, []).extend(v)
        return self._log

    def record(self, phase: str, seconds: float):
        self._log.setdefault(phase, []).append(seconds)
        if phase == 'Total':
            if seconds > self.radar_period:
                self.violations += 1
            elif seconds > 0.6 * self.radar_period:
                self.soft_violations += 1

    def averages(self):
        return {k: float(np.mean(v)) for k, v in self.log.items() if v}

    def summary(self):
        log = self.log
        parts = []
        for k in PHASES:
            v = log.get(k)
            if v:
                parts.append("{0:}: {1:6.1f}ms".format(k, 1000 * np.mean(v)))
        s = "  ".join(parts)
        if self.violations:
            s += "  [HARD-RT violations: %d]" % self.violations
        elif self.soft_violations:
            s += "  [soft-RT violations: %d]" % self.soft_violations
        return s


# -- the tracer ---------------------------------------------------------------

class Tracer:
    """The process's spans and stamps (module docstring): ``TRACE``.  Its
    arrays are made at the first ``trace_on``."""

    def __init__(self, spans: int = SPANS, rows: int = ROWS):
        self.on = False
        self.size, self.rows = spans, rows
        self.span_name = None
        self.names, self._ids = [], {}
        self.rings = {}        # device -> int64 [1 + rows * N_STAMPS]
        self.calibration = {}  # device -> [(host ns, device ns, window ns)]
        self.graphs = weakref.WeakSet()   # step graphs captured with stamps
        self._clear()

    def _alloc(self):
        self.span_name = np.zeros(self.size, np.int32)
        self.span_start = np.zeros(self.size, np.int64)
        self.span_end = np.zeros(self.size, np.int64)
        self.span_parent = np.zeros(self.size, np.int64)
        self.span_scan = np.zeros(self.size, np.int64)
        self.host_ring = np.zeros((self.rows, N_STAMPS), np.int64)

    def _clear(self):
        self.n = 0             # spans begun: the next span's id
        self.stack = []        # open spans: (id, profiler range or None)
        self.steps = 0         # steps begun, stamped: the next step's row
        self.device = None     # the device whose stamps the rows hold
        self.captures = 0      # step graphs captured (core/graph.StepGraph)
        self.node_runs0 = {}   # the condition kernel's counts at the reset
        self.counters0 = {}    # the program's counters at the reset

    def reset(self):
        """Forget every span, stamp and count (the device rings' row counts
        are zeroed on the current stream)."""
        self._clear()
        for buf in self.rings.values():
            buf[:1].zero_()
        self.node_runs0 = _node_runs()
        self.counters0 = counters()

    # spans
    def _id(self, name: str) -> int:
        i = self._ids.get(name)
        if i is None:
            i = self._ids[name] = len(self.names)
            self.names.append(name)
        return i

    def begin(self, name: str):
        rng = None
        if _profiling():
            import torch
            rng = torch._C._profiler._RecordFunctionFast(name)
            rng.__enter__()
        i, size = self.n, self.size
        self.n = i + 1
        parent = self.stack[-1][0] if self.stack else -1
        j = i % size
        self.span_name[j] = self._id(name)
        self.span_parent[j] = parent
        self.span_scan[j] = (self.steps if parent < 0 or parent <= i - size
                             else self.span_scan[parent % size])
        self.span_end[j] = -1
        self.span_start[j] = time.perf_counter_ns()
        self.stack.append((i, rng))

    def end(self):
        if not self.stack:     # begun before tracing was turned on
            return
        i, rng = self.stack.pop()
        if i >= self.n - self.size:      # not yet written over
            self.span_end[i % self.size] = time.perf_counter_ns()
        if rng is not None:
            rng.__exit__(None, None, None)

    def _gc(self, phase: str, info: dict):
        """``gc.callbacks`` hook: each collection a ``gc`` span under the
        span open then."""
        if phase == 'start':
            self.begin('gc')
        elif self.stack and self.names[
                self.span_name[self.stack[-1][0] % self.size]] == 'gc':
            self.end()

    # stamps
    def ring(self, device):
        """The device's stamp ring (one int64 tensor: the row count, then
        ``rows`` rows of ``N_STAMPS``), made at first use, outside any
        capture, and kept for the process: captured graphs hold it."""
        buf = self.rings.get(device)
        if buf is None:
            import torch
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("timing: a device's stamp ring is made "
                                   "before a capture (timing.ready)")
            buf = self.rings[device] = torch.zeros(
                1 + self.rows * N_STAMPS, dtype=torch.int64, device=device)
        return buf

    def _bind(self, device):
        if self.device is None:
            self.device = device
        elif device != self.device:
            raise ValueError(f"timing: stamps of {device} while the rows "
                             f"hold {self.device}'s (timing.reset between "
                             f"devices)")

    def stamp(self, k: int, device):
        self._bind(device)
        if device.type == 'cuda':
            import torch
            from ..kernels import graph_flow
            buf = self.ring(device)
            graph_flow.stamp(buf[1:].view(self.rows, N_STAMPS), buf[:1], k)
            if k == 0 and not torch.cuda.is_current_stream_capturing():
                self.steps += 1
            return
        if k == 0:
            self.steps += 1
        self.host_ring[(self.steps - 1) % self.rows, k] = \
            time.perf_counter_ns()

    def replayed(self, device):
        """A replay of a graph captured with stamps on ``device``: its
        stamps begin the next row."""
        self._bind(device)
        self.steps += 1

    def calibrate(self, device, tries: int = 5):
        """One more (host ns, device ns, window ns) pair of the device: of
        ``tries`` stamps, each between a synchronise and a synchronise, the
        one whose window was shortest, placed at its window's middle."""
        import torch
        from .. import sync
        from ..kernels import graph_flow
        cal = torch.zeros((1, tries), dtype=torch.int64, device=device)
        windows = []
        for k in range(tries):
            torch.cuda.synchronize(device)
            h0 = time.perf_counter_ns()
            graph_flow.stamp(cal, None, k)
            torch.cuda.synchronize(device)
            windows.append((h0, time.perf_counter_ns()))
        dev = sync.fetch(cal)[0].tolist()
        k = min(range(tries), key=lambda i: windows[i][1] - windows[i][0])
        h0, h1 = windows[k]
        self.calibration.setdefault(device, []).append(
            ((h0 + h1) // 2, dev[k], h1 - h0))

    def to_host(self, device, ns) -> np.ndarray:
        """Device clock ns as host clock ns: through the first and the last
        calibration when they lie a second or more apart (the clocks
        drift), else by the first's offset."""
        cal = self.calibration[device]
        (h_a, d_a, _), (h_b, d_b, _) = cal[0], cal[-1]
        ns = np.asarray(ns, np.float64)
        if h_b - h_a >= 10 ** 9 and d_b != d_a:
            ns = h_a + (ns - d_a) * ((h_b - h_a) / (d_b - d_a))
        else:
            ns = ns - (d_a - h_a)
        return ns.astype(np.int64)

    # reading
    def stamps(self) -> tuple:
        """(the first step kept, its stamps and the later steps' [steps,
        N_STAMPS] in host clock ns, 0 where missing); one host read of
        the device's ring, which is calibrated again."""
        first = max(0, self.steps - self.rows)
        rows = np.arange(first, self.steps) % self.rows
        dev = self.device
        if dev is None or dev.type != 'cuda':
            return first, self.host_ring[rows].copy()
        from .. import sync
        buf = sync.fetch(self.ring(dev)).numpy()
        if int(buf[0]) != self.steps:
            raise RuntimeError(f"timing: the device began {int(buf[0])} "
                               f"stamped steps, the host counted "
                               f"{self.steps}")
        self.calibrate(dev)
        raw = buf[1:].reshape(self.rows, N_STAMPS)[rows]
        return first, np.where(raw > 0, self.to_host(dev, raw), 0)

    def read(self) -> dict:
        """What the tracer holds, on the host clock (ns): ``spans`` (id,
        name, start, end, parent, scan; an open span's end is -1),
        ``stamps`` [steps kept, N_STAMPS] with ``first_step`` the step of
        row 0, ``node_runs`` of the condition kernel, the program's
        ``counters`` and ``captures`` since the reset, ``pool_bytes`` of the live graphs captured with stamps,
        and the device's ``calibration``."""
        if self.span_name is None:
            self._alloc()
        ids = np.arange(max(0, self.n - self.size), self.n)
        j = ids % self.size
        spans = dict(id=ids,
                     name=np.array(self.names + [''],
                                   dtype=object)[self.span_name[j]],
                     start=self.span_start[j].copy(),
                     end=self.span_end[j].copy(),
                     parent=self.span_parent[j].copy(),
                     scan=self.span_scan[j].copy())
        first, st = self.stamps()
        runs = _node_runs()
        cnt = counters()
        return dict(
            device=str(self.device), spans=spans, stamps=st,
            first_step=first, steps=self.steps,
            node_runs={k: v - self.node_runs0.get(k, 0)
                       for k, v in runs.items()},
            counters={k: v - self.counters0.get(k, 0)
                      for k, v in cnt.items()},
            captures=self.captures,
            pool_bytes=sum(g.pool_bytes() for g in list(self.graphs)),
            calibration=self.calibration.get(self.device))

    def phases(self, steps) -> dict:
        """{step: seconds of each of STEP_PHASES} of the given steps whose
        stamps are still kept."""
        if not steps:
            return {}
        first, st = self.stamps()
        out = {}
        for s in steps:
            r = s - first
            if 0 <= r < len(st) and (st[r] > 0).all():
                out[s] = np.diff(st[r]) * 1e-9
        return out


def _profiling() -> bool:
    import torch.autograd.profiler as prof
    return prof._is_profiler_enabled


def _node_runs() -> dict:
    """The condition kernel's runs per node name, where the device's count
    exists (its library is loaded)."""
    from ..kernels import build, graph_flow
    return graph_flow.node_runs() if "graph_flow" in build._loaded else {}


TRACE = Tracer()


def tracing() -> bool:
    """Is the process's tracer on?"""
    return TRACE.on


def trace_on():
    """Turn the tracer on (a no-op when on): spans and stamps are recorded
    from now; the current CUDA device's clock is calibrated."""
    if TRACE.on:
        return
    if TRACE.span_name is None:
        TRACE._alloc()
    import torch
    if torch.cuda.is_available():
        dev = torch.device('cuda', torch.cuda.current_device())
        TRACE.ring(dev)
        TRACE.calibrate(dev)
    gc.callbacks.append(TRACE._gc)
    TRACE.on = True


def trace_off():
    """Turn the tracer off; what it recorded stays readable."""
    if not TRACE.on:
        return
    TRACE.on = False
    gc.callbacks.remove(TRACE._gc)
    while TRACE.stack:
        TRACE.end()


def reset():
    """Forget what the tracer recorded (its switch is left as it is)."""
    TRACE.reset()


def read() -> dict:
    """``Tracer.read`` of the process's tracer."""
    return TRACE.read()


class Span:
    """``with SPAN:`` records a span of this name while tracing is on."""
    __slots__ = ('name',)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if TRACE.on:
            TRACE.begin(self.name)

    def __exit__(self, *exc):
        if TRACE.on:
            TRACE.end()


def spanned(name: str, fn):
    """``fn`` run inside a span ``name`` (a loop body, a branch)."""
    span = Span(name)

    def run(*a, **kw):
        with span:
            return fn(*a, **kw)
    return run


def stamp(k: int, device):
    """Stamp ``k`` of the step on ``device`` (module docstring), when
    tracing is on."""
    if TRACE.on:
        TRACE.stamp(k, device)


def ready(device):
    """Make the device's counters and, when tracing is on, its stamp ring,
    before a capture (both outlive every graph that writes them)."""
    _counter_buf(device)
    if TRACE.on and device.type == 'cuda':
        TRACE.ring(device)


# -- the program's counters --------------------------------------------------

_COUNTS = {}             # device -> int64 [len(COUNTERS)]; the CPU's made
                         # now, so that no step's first run makes it


def _counter_buf(device):
    import torch
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    buf = _COUNTS.get(device)
    if buf is None:
        if device.type == 'cuda' and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("timing: a device's counters are made "
                               "before a capture (timing.ready)")
        buf = _COUNTS[device] = torch.zeros(len(COUNTERS), dtype=torch.int64,
                                            device=device)
    return buf


_counter_buf('cpu')


def count(names, values):
    """Add ``values`` (one device tensor per name, the names consecutive
    in ``COUNTERS``; a bool, or a batch of them, counts its true entries)
    to the counters of the device they lie on: one add, a kernel node
    under capture."""
    import torch
    names = (names,) if isinstance(names, str) else tuple(names)
    values = (values,) if isinstance(values, torch.Tensor) else values
    i = COUNTERS.index(names[0])
    if COUNTERS[i:i + len(names)] != names:
        raise ValueError(f"timing.count: {names} are not consecutive in "
                         f"COUNTERS")
    buf = _counter_buf(values[0].device)
    inc = [v.reshape(-1).sum(0, keepdim=True, dtype=torch.int64)
           for v in values]
    buf[i:i + len(names)] += inc[0] if len(inc) == 1 else torch.cat(inc)


def counters(device=None) -> dict:
    """{name: count} of ``COUNTERS`` over every device (or ``device``
    alone), since import (a copy of each device's counters to the host,
    waiting for it)."""
    out = dict.fromkeys(COUNTERS, 0)
    bufs = (list(_COUNTS.values()) if device is None
            else [_counter_buf(device)])
    for buf in bufs:
        for k, v in zip(COUNTERS, buf.cpu().tolist()):
            out[k] += int(v)
    return out


# -- reading a trace ---------------------------------------------------------

def summary(trace: dict, skip=()) -> dict:
    """Means of a ``read()``: per stamped step, each of STEP_PHASES in ms
    (``<phase>_ms``) and their sum; per ``scan`` span (outermost), the
    time of each span name among its descendants, summed per scan and
    averaged over the scans (``<name>_ms``, ``gc`` included); the scans'
    own mean; counts.  Of the archive updates (``absorb`` spans):
    ``absorbs`` in all, ``absorbs_behind_replay`` those inside a ``scan``
    that began after the end of its ``replay`` and before any ``fetch``
    after it (so while the device ran the step), ``absorbs_on_read``
    those outside any ``scan`` (run by a read of the archive).  ``skip``:
    scan numbers left out (a profiled stretch).  ``counters``: the
    program's counters since the tracer's reset."""
    skip = set(skip)
    st = trace['stamps']
    steps = trace['first_step'] + np.arange(len(st))
    keep = (st > 0).all(axis=1) & ~np.isin(steps, list(skip))
    out = dict(steps=int(keep.sum()))
    ph = np.diff(st[keep], axis=1) * 1e-6 if keep.any() else None
    for i, name in enumerate(STEP_PHASES):
        out[f"{name}_ms"] = (float(ph[:, i].mean()) if ph is not None
                             else None)
    out["phase_sum_ms"] = float(ph.sum(axis=1).mean()) if ph is not None \
        else None
    sp = trace['spans']
    ids, parent, name = sp['id'], sp['parent'], sp['name']
    done = sp['end'] >= 0
    pos = {int(i): k for k, i in enumerate(ids)}
    root = np.empty(len(ids), np.int64)
    for k in range(len(ids)):           # parents precede their children
        p = pos.get(int(parent[k]))
        root[k] = k if p is None else root[p]
    scans = (name == 'scan') & (parent < 0) & done \
        & ~np.isin(sp['scan'], list(skip))
    n = int(scans.sum())
    out["scans"] = n
    dur = np.where(done, sp['end'] - sp['start'], 0) * 1e-6
    inside = scans[root] & done & ~(name == 'scan')
    out["scan_ms"] = float(dur[scans].mean()) if n else None
    for nm in sorted(set(name[inside])):
        out[f"{nm}_ms"] = float(dur[inside & (name == nm)].sum()) / n
    absorbs = (name == 'absorb') & done & ~np.isin(sp['scan'], list(skip))
    in_scan = ((name == 'scan') & (parent < 0))[root]
    out["absorbs"] = int(absorbs.sum())
    out["absorbs_on_read"] = int((absorbs & ~in_scan).sum())
    replayed, behind = {}, 0    # scan -> its replay's end; None once fetched
    marks = in_scan & (absorbs | (name == 'replay') | (name == 'fetch'))
    for k in np.nonzero(marks)[0]:      # in the order the spans began
        r, end = root[k], replayed.get(root[k])
        if name[k] == 'replay':
            replayed[r] = sp['end'][k]
        elif end is not None and sp['start'][k] >= end:
            if name[k] == 'fetch':
                replayed[r] = None
            else:
                behind += 1
    out["absorbs_behind_replay"] = behind
    out["captures"] = trace['captures']
    out["pool_bytes"] = trace['pool_bytes']
    out["node_runs"] = trace['node_runs']
    out["counters"] = trace.get('counters', {})
    return out


def phase_profile(tracker, scan_time, z, ais_messages=None, reps: int = 3):
    """Run one scan phase by phase, each phase alone on the tracker's
    current state, ``reps`` times after one warm-up.  Returns {phase:
    median seconds}.  Does NOT mutate the tracker."""
    import torch
    from ..core.grow import grow
    from ..core.select import select
    from ..core.lifecycle import n_scan_prune, terminate
    from ..core import initiator as initiator_mod

    shapes, params = tracker.shapes, tracker.params
    t_rel = float(scan_time) - (tracker.t0 or float(scan_time))
    scan, ais = tracker._unpack_inputs(
        tracker._pack_inputs(t_rel, z, ais_messages or ()))
    on_card = tracker.device.type == 'cuda'
    out = {}

    def timed(name, fn, *args):
        ts = []
        for _ in range(reps + 1):
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*args)
            if on_card:
                torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        out[name] = float(np.median(ts[1:]))
        return r

    g = timed('Process', lambda s: grow(s, scan, ais, shapes, params),
              tracker.state)
    sel_res = timed('Optim', lambda s: select(s, shapes, params,
                                              method=tracker.method), g.state)
    st = g.state.replace(sel_leaf=sel_res.sel)
    term = timed('Terminate', lambda s: terminate(s, shapes, params), st)
    timed('N-Prune', lambda s: n_scan_prune(s, shapes, params), term.state)
    ais_init = ais if tracker.use_ais and tracker.ais_initialization else None
    timed('Init', lambda i: initiator_mod.step(
        i, scan.z, scan.mask & ~g.used_meas, scan.time, ais_init, shapes,
        params), tracker.init_state)
    out['Total'] = sum(out.values())
    return out

"""Per-phase runtime observability (the port's own copy of
pymht_tpu/utils/timing.py).

* ``RuntimeLog`` — per-scan wall clock of the step plus the watchdog
  counts (hard and soft real-time limits against the radar period).
* ``phase_profile`` — a debug runner that executes each phase of one scan
  as its own call, closed by ``torch.cuda.synchronize()`` on a CUDA
  device, recovering a per-phase breakdown.  It does not mutate the
  tracker.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

PHASES = ('Total', 'Process', 'Cluster', 'Optim', 'DynN',
          'N-Prune', 'Terminate', 'Init')


@dataclass
class RuntimeLog:
    radar_period: float
    log: dict = field(default_factory=lambda: {k: [] for k in PHASES})
    violations: int = 0
    soft_violations: int = 0

    def record(self, phase: str, seconds: float):
        self.log.setdefault(phase, []).append(seconds)
        if phase == 'Total':
            if seconds > self.radar_period:
                self.violations += 1
            elif seconds > 0.6 * self.radar_period:
                self.soft_violations += 1

    def averages(self):
        return {k: float(np.mean(v)) for k, v in self.log.items() if v}

    def summary(self):
        parts = []
        for k in PHASES:
            v = self.log.get(k)
            if v:
                parts.append("{0:}: {1:6.1f}ms".format(k, 1000 * np.mean(v)))
        s = "  ".join(parts)
        if self.violations:
            s += "  [HARD-RT violations: %d]" % self.violations
        elif self.soft_violations:
            s += "  [soft-RT violations: %d]" % self.soft_violations
        return s


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

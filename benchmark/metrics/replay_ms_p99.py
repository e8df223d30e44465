"""Step graph layer: the 99th percentile of the same events' device ms
(numpy's linear interpolation), the scans whose data makes the step's
loops run long."""
import numpy as np


def read(tr):
    ev = tr["replay_ms"]
    return float(np.percentile(ev, 99)) if ev else None

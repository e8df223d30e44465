"""K1 (``ops/gate_kernel.py``, ``csrc/gate_score.cu``): the least time
the card could take for one call at the configuration's shapes
(``k1_bound.py``, against the H100's published HBM and float32 peaks)
over K1's mean device time per call in the profiled stretch, in %."""
import k1_bound


def read(tr):
    if not tr["k1_calls"] or tr["k1_device_s"] <= 0:
        return None
    per_call_ms = 1e3 * tr["k1_device_s"] / tr["k1_calls"]
    return 100.0 * k1_bound.bound_of(tr["config"])["bound_ms"] / per_call_ms

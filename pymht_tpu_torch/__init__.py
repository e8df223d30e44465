"""pymht_tpu_torch — the PyTorch/CUDA port of pymht_tpu.

The same fixed-shape hypothesis forest and per-scan pipeline as the JAX
package (radar and AIS fusion), on torch tensors of one device; K1 (the
gate-and-score pass of grow) is a hand-written CUDA kernel
(``csrc/gate_score.cu``).

Public API::

    from pymht_tpu_torch import Tracker, TrackerShapes, TrackerParams

Attribute access is lazy, so importing the package builds nothing.
"""
__version__ = "0.1.0"

_CONFIG = ("TrackerShapes", "TrackerParams")
_TRACKER = ("Tracker", "scan_step", "scan_many")
__all__ = list(_CONFIG + _TRACKER)


def __getattr__(name):
    if name in _CONFIG:
        from .core import config
        return getattr(config, name)
    if name in _TRACKER:
        from .core import tracker
        return getattr(tracker, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(__all__ + ["__version__"])

"""Host-side numpy utilities of the port: ``simulator``, ``metrics``,
``helpers`` and ``containers`` (numpy and scipy only; the port's own
copies of the JAX package's modules of the same names)."""
from . import containers, helpers, metrics, simulator

__all__ = ["containers", "helpers", "metrics", "simulator"]

"""Host-side numpy utilities of the port: ``simulator``, ``metrics``,
``helpers``, ``containers`` and ``ais_io`` (numpy and scipy only; the
port's own copies of the JAX package's modules of the same names).
``oracle``, ``checkpoint``, ``xml_io``, ``timing``, ``integrity`` and
``scenes`` read the port's tensors and are imported by name."""
from . import ais_io, containers, helpers, metrics, simulator

__all__ = ["ais_io", "containers", "helpers", "metrics", "simulator"]

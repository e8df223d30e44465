"""Host-side numpy utilities, shared with the JAX package by import.

``simulator``, ``metrics``, ``helpers`` and ``containers`` of
``pymht_tpu.utils`` are numpy-only and pull in no JAX; they are
re-exported here so the port's users import them from one place.
"""
from pymht_tpu.utils import containers, helpers, metrics, simulator

__all__ = ["containers", "helpers", "metrics", "simulator"]

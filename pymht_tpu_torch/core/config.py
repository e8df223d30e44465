"""Static tracker configuration, shared with the JAX package by import:
``pymht_tpu.core.config`` is numpy-only and pulls in no JAX."""
from pymht_tpu.core.config import TrackerParams, TrackerShapes

__all__ = ["TrackerParams", "TrackerShapes"]

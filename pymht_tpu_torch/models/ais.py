"""AIS observation model: only the measurement covariance, which the
initiator's similarity test uses (counterpart of
pymht_tpu/models/ais.py:R)."""
from __future__ import annotations

import torch

from .constants import default_dtype, N_OBS_AIS

sigmaR_AIS_true_highAccuracy = 1.0
sigmaR_AIS_true_lowAccuracy = 3.0


def R(highAccuracy: bool, device) -> torch.Tensor:
    """AIS measurement covariance, selected by the accuracy flag."""
    s = (sigmaR_AIS_true_highAccuracy if highAccuracy
         else sigmaR_AIS_true_lowAccuracy)
    return torch.eye(N_OBS_AIS, dtype=default_dtype, device=device) * s ** 2

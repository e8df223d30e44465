"""AIS (ship transponder) observation model (counterpart of
pymht_tpu/models/ais.py): AIS observes the full 4-D state, and its
measurement noise depends on the message's accuracy flag."""
from __future__ import annotations

import torch

from .constants import default_dtype, N_OBS_AIS, N_STATE
from .pv import Phi  # noqa: F401  (the same CV transition, re-exported)

sigmaR_AIS_true_highAccuracy = 1.0
sigmaR_AIS_true_lowAccuracy = 3.0


def C(device) -> torch.Tensor:
    """AIS observation matrix: the full state."""
    return torch.eye(N_OBS_AIS, N_STATE, dtype=default_dtype, device=device)


def R(highAccuracy, device) -> torch.Tensor:
    """AIS measurement covariance, selected by the accuracy flag: a
    Python bool gives [4, 4], a bool tensor of shape (...) gives
    (..., 4, 4) (a branchless select, nothing is read back)."""
    eye = torch.eye(N_OBS_AIS, dtype=default_dtype, device=device)
    hi = eye * sigmaR_AIS_true_highAccuracy ** 2
    lo = eye * sigmaR_AIS_true_lowAccuracy ** 2
    if isinstance(highAccuracy, torch.Tensor):
        return torch.where(highAccuracy.to(device)[..., None, None], hi, lo)
    return hi if highAccuracy else lo

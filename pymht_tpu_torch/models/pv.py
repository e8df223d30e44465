"""2D constant-velocity (PV) state-space model, built as torch tensors on
demand (counterpart of pymht_tpu/models/pv.py).

State x = [east, north, v_east, v_north].  Every constructor takes the
device explicitly; a time step ``T`` may be a Python float or a device
tensor of any shape, and is never read back to the host.
"""
from __future__ import annotations

import torch

from .constants import default_dtype, sigmaQ_tracker, sigmaR_RADAR_tracker

_P0_VAR = 2.5 ** 2   # position variance p; velocity variance 0.3 p


def as_time(T, device) -> torch.Tensor:
    """A time step as an f32 tensor on ``device`` (no host round trip)."""
    if isinstance(T, torch.Tensor):
        return T.to(device=device, dtype=default_dtype)
    return torch.full((), float(T), dtype=default_dtype, device=device)


def C_RADAR(device) -> torch.Tensor:
    """Radar observation matrix (a.k.a. H): observes position only."""
    return torch.eye(2, 4, dtype=default_dtype, device=device)


H_radar = C_RADAR


def P0(device) -> torch.Tensor:
    """Initial state covariance diag(p, p, 0.3 p, 0.3 p)."""
    d = torch.full((4,), _P0_VAR, dtype=default_dtype, device=device)
    d[2:] = 0.3 * _P0_VAR       # filled on the device: no host copy
    return torch.diag(d)


def GPS_COVARIANCE_PRECISE(device) -> torch.Tensor:
    """Half the initial state covariance."""
    return P0(device) * 0.5


def Q(T, sigmaQ=sigmaQ_tracker, device=None) -> torch.Tensor:
    """Process-noise covariance for time step T: [..., 4, 4] (the
    reference kernel with its T^3/3 off-diagonal)."""
    T = as_time(T, device if device is not None else _device_of(T))
    T2 = T * T
    T3 = T2 * T / 3.0
    T4 = T2 * T2 / 4.0
    z = torch.zeros_like(T)
    return torch.stack([
        torch.stack([T4, z, T3, z], dim=-1),
        torch.stack([z, T4, z, T3], dim=-1),
        torch.stack([T3, z, T2, z], dim=-1),
        torch.stack([z, T3, z, T2], dim=-1),
    ], dim=-2) * sigmaQ


def R_RADAR(device, sigmaR=sigmaR_RADAR_tracker) -> torch.Tensor:
    """Radar measurement-noise covariance."""
    return torch.eye(2, dtype=default_dtype, device=device) * (sigmaR ** 2)


def Phi(T, device=None) -> torch.Tensor:
    """Constant-velocity transition matrix; T of shape (...) gives
    (..., 4, 4)."""
    T = as_time(T, device if device is not None else _device_of(T))
    one = torch.ones_like(T)
    z = torch.zeros_like(T)
    return torch.stack([
        torch.stack([one, z, T, z], dim=-1),
        torch.stack([z, one, z, T], dim=-1),
        torch.stack([z, z, one, z], dim=-1),
        torch.stack([z, z, z, one], dim=-1),
    ], dim=-2)


def _device_of(T):
    return T.device if isinstance(T, torch.Tensor) else torch.device("cpu")

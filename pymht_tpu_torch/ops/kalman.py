"""Batched Kalman-filter primitives in torch (counterpart of
pymht_tpu/ops/kalman.py).

Same op contract: predict / precalc / residuals / NIS / NLLR, batched
over arbitrary leading axes, with 2x2 and 4x4 inverses in closed form.
Each function keeps the JAX function's numerics, including where it
does NOT clamp (``nllr`` takes the log of det S as it is).
"""
from __future__ import annotations

import math

import torch

_LOG2PI = math.log(2.0 * math.pi)


def inv2x2(S):
    """Closed-form inverse of batched 2x2 matrices (..., 2, 2)."""
    a, b = S[..., 0, 0], S[..., 0, 1]
    c, d = S[..., 1, 0], S[..., 1, 1]
    inv_det = 1.0 / (a * d - b * c)
    row0 = torch.stack([d * inv_det, -b * inv_det], dim=-1)
    row1 = torch.stack([-c * inv_det, a * inv_det], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def det2x2(S):
    return S[..., 0, 0] * S[..., 1, 1] - S[..., 0, 1] * S[..., 1, 0]


def _blocks(S):
    return S[..., :2, :2], S[..., :2, 2:], S[..., 2:, :2], S[..., 2:, 2:]


def inv4x4(S):
    """Closed-form inverse of batched 4x4 matrices via the 2x2 block
    Schur complement (the leading block must be invertible)."""
    A, B, C, D = _blocks(S)
    Ainv = inv2x2(A)
    Minv = inv2x2(D - C @ Ainv @ B)
    AinvB = Ainv @ B
    CAinv = C @ Ainv
    top = torch.cat([Ainv + AinvB @ Minv @ CAinv, -AinvB @ Minv], dim=-1)
    bot = torch.cat([-Minv @ CAinv, Minv], dim=-1)
    return torch.cat([top, bot], dim=-2)


def det4x4(S):
    A, B, C, D = _blocks(S)
    return det2x2(A) * det2x2(D - C @ inv2x2(A) @ B)


def inv_psd(S):
    dim = S.shape[-1]
    if dim == 2:
        return inv2x2(S)
    if dim == 4:
        return inv4x4(S)
    return torch.linalg.inv(S)


def det_psd(S):
    dim = S.shape[-1]
    if dim == 2:
        return det2x2(S)
    if dim == 4:
        return det4x4(S)
    return torch.linalg.det(S)


def predict(A, Q, x, P):
    """Batched time update.  A, Q: (4, 4); x: (..., 4), P: (..., 4, 4)."""
    x_bar = torch.einsum('ij,...j->...i', A, x)
    P_bar = torch.einsum('ij,...jk,lk->...il', A, P, A) + Q
    return x_bar, P_bar


def precalc(C, R, x_bar, P_bar):
    """Batched measurement-update precalculation.

    C: (m, n), R: (m, m); x_bar: (..., n), P_bar: (..., n, n).
    Returns z_hat (..., m), S (..., m, m), S_inv, K (..., n, m),
    P_hat (..., n, n)."""
    z_hat = torch.einsum('ij,...j->...i', C, x_bar)
    PCt = torch.einsum('...ij,kj->...ik', P_bar, C)
    S = torch.einsum('ij,...jk->...ik', C, PCt) + R
    S_inv = inv_psd(S)
    K = PCt @ S_inv
    P_hat = P_bar - torch.einsum('...ij,jk,...kl->...il', K, C, P_bar)
    return z_hat, S, S_inv, K, P_hat


def residuals(z, z_hat):
    """All-pairs innovations: z (M, m), z_hat (..., m) -> (..., M, m)."""
    return z - z_hat[..., None, :]


def nis(z_tilde, S_inv):
    """Normalized innovation squared: (..., M, m), (..., m, m) -> (..., M)."""
    return torch.einsum('...mi,...ij,...mj->...m', z_tilde, S_inv, z_tilde)


def filter_update(x_bar, K, z_tilde):
    """State update for many residuals of one prediction: x_bar (..., n),
    K (..., n, m), z_tilde (..., M, m) -> (..., M, n)."""
    return x_bar[..., None, :] + torch.einsum('...nm,...Mm->...Mn', K,
                                              z_tilde)


def nllr(lambda_ex, P_d, S, nis_values):
    """Association NLLR increment 0.5*NIS + ln(lambda_ex*sqrt(det 2 pi S)/P_d).

    ``lambda_ex`` is a Python float (clamped at 1e-20 like the JAX
    function); det S is not clamped."""
    m = S.shape[-1]
    log_norm = 0.5 * (m * _LOG2PI + torch.log(det_psd(S)))
    log_lam = math.log(max(float(lambda_ex), 1e-20))
    log_term = log_lam + log_norm - torch.log(P_d)
    return 0.5 * nis_values + log_term[..., None]


def nllr_ais(S, nis_values):
    """AIS-association NLLR increment 0.5*NIS + ln sqrt(det 2 pi S)."""
    m = S.shape[-1]
    log_norm = 0.5 * (m * _LOG2PI + torch.log(det_psd(S)))
    return 0.5 * nis_values + log_norm[..., None]


def nllr_missed(P_d):
    """Missed-detection (zero-hypothesis) NLLR increment -ln(1 - P_d)."""
    return -torch.log1p(-P_d)

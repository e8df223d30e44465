"""Batched fixed-interval RTS smoothing with EM refinement (counterpart
of pymht_tpu/ops/smoother.py).

A forward Kalman filter and a backward RTS pass over the padded track
length, all tracks at once: the JAX package's ``vmap`` over tracks is the
leading batch axis here and its ``lax.scan`` over time a Python loop of
batched [B, 4, 4] operations.  Missed detections (and the padded tail of
a shorter track) are masked steps: the filter coasts through them.

The small matrix products are broadcast multiply-and-sum
(``ais_fused._mm``), not ``@``: a batched cuBLAS call on 4x4 matrices
costs more than the whole step otherwise.  The radar observes position
only, so products with C = [I 0] are written as slices (exact).

EM modes, as in the JAX package: ``'full'`` refits the full Q [4,4] and
R [2,2] and (x0, P0) from the smoothed moments with lag-one covariances;
``'scalar'`` refits scale factors on the model's Q and R.  Both compute
what the JAX functions compute on a padded batch too: a padded
transition enters the Q statistics there, and so it does here.
"""
from __future__ import annotations

import torch

from ..models import pv
from .ais_fused import _inv_det4, _mm, _mv
from .kalman import inv2x2


def _sym(P):
    return 0.5 * (P + P.transpose(-1, -2))


def _smooth_pass(x0, P0, zs, mask, A, Q, R):
    """One filter + RTS pass over a batch.  x0 [B,4], P0 [B,4,4], zs
    [B,N,2], mask [B,N]; A [4,4]; Q [4,4] or [B,4,4]; R [2,2] or [B,2,2].
    Returns (xs [B,N,4], Ps [B,N,4,4], M [B,N,4,4]) with M[:, t] the
    lag-one smoothed covariance Cov(x_t, x_{t-1} | z_{1:N}) for t >= 1
    (M[:, 0] is zero padding)."""
    N = mask.shape[1]
    At = A.T
    x, P = x0, P0
    xf, Pf, xp, Pp = [], [], [], []
    for t in range(N):
        x_bar = _mv(A, x)
        P_bar = _mm(_mm(A, P), At) + Q
        PCt = P_bar[..., :, :2]                                      # [B,4,2]
        K = _mm(PCt, inv2x2(P_bar[..., :2, :2] + R))
        x_upd = x_bar + _mv(K, zs[:, t] - x_bar[..., :2])
        P_hat = P_bar - _mm(K, P_bar[..., :2, :])
        m = mask[:, t]
        x = torch.where(m[:, None], x_upd, x_bar)
        P = torch.where(m[:, None, None], P_hat, P_bar)
        xf.append(x)
        Pf.append(P)
        xp.append(x_bar)
        Pp.append(P_bar)

    x_s, P_s = xf[-1], Pf[-1]
    xs, Ps, Ms = [x_s], [P_s], []
    for t in range(N - 2, -1, -1):
        P_next = P_s
        # G = Pf A^T Pp^{-1}, with the prediction into t + 1
        G = _mm(_mm(Pf[t], At), _inv_det4(Pp[t + 1])[0])
        x_s = xf[t] + _mv(G, x_s - xp[t + 1])
        P_s = Pf[t] + _mm(_mm(G, P_next - Pp[t + 1]), G.transpose(-1, -2))
        # lag-one: Cov(x_{t+1}, x_t) = Ps[t+1] G[t]^T, stored at t + 1
        Ms.append(_mm(P_next, G.transpose(-1, -2)))
        xs.append(x_s)
        Ps.append(P_s)
    Ms.append(torch.zeros_like(P_s))
    return (torch.stack(xs[::-1], dim=1), torch.stack(Ps[::-1], dim=1),
            torch.stack(Ms[::-1], dim=1))


def _outer(a, b):
    return a[..., :, None] * b[..., None, :]


def smooth_tracks(x0s, P0s, zs, masks, radar_period, em_iters: int = 0,
                  em_mode: str = 'scalar', sigma_q: float = None,
                  sigma_r: float = None):
    """Smooth a batch of tracks: x0s [B,4], P0s [B,4,4], zs [B,N,2]
    measurements (anything where ~masks), masks [B,N].  Returns (xs
    [B,N,4], Ps [B,N,4,4]).  With ``em_iters`` > 0 smoothing alternates
    with per-track noise refits (see the module docstring)."""
    dev = x0s.device
    A = pv.Phi(radar_period, dev)
    Q0 = pv.Q(radar_period, device=dev)
    R0 = pv.R_RADAR(dev)
    maskf = masks.float()

    if em_mode == 'full':
        Qm, Rm, x0m, P0m = Q0, R0, x0s, P0s
        xs, Ps, M = _smooth_pass(x0m, P0m, zs, masks, A, Qm, Rm)
        for _ in range(em_iters):
            # Q: mean over transitions of
            #   outer(err) + Ps[t+1] - M[t+1] A^T - A M[t+1]^T + A Ps[t] A^T
            err = xs[:, 1:] - _mv(A, xs[:, :-1])
            Mt = M[:, 1:]
            Qn = (_outer(err, err) + Ps[:, 1:] - _mm(Mt, A.T)
                  - _mm(A, Mt.transpose(-1, -2))
                  + _mm(_mm(A, Ps[:, :-1]), A.T))
            Qm = _sym(Qn.mean(dim=1))
            # R: observed steps only, over the observed count
            v = zs - xs[..., :2]
            Rn = _outer(v, v) + Ps[..., :2, :2]
            n_obs = torch.clamp(maskf.sum(dim=1), min=1.0)
            Rm = _sym((Rn * maskf[..., None, None]).sum(dim=1)
                      / n_obs[:, None, None])
            x0m, P0m = xs[:, 0], _sym(Ps[:, 0])
            xs, Ps, M = _smooth_pass(x0m, P0m, zs, masks, A, Qm, Rm)
        return xs, Ps

    q = 1.0 if sigma_q is None else sigma_q
    r = 1.0 if sigma_r is None else sigma_r
    xs, Ps, _ = _smooth_pass(x0s, P0s, zs, masks, A, Q0 * q, R0 * r)
    for _ in range(em_iters):
        # scalar refit: match the innovation magnitudes
        resid = torch.where(masks[..., None], zs - xs[..., :2], 0.0)
        n_obs = torch.clamp(maskf.sum(dim=1), min=1.0)
        r = torch.clamp((resid ** 2).sum(dim=(1, 2)) / (2 * n_obs)
                        / R0[0, 0], min=1e-3)
        step_res = xs[:, 1:] - _mv(A, xs[:, :-1])
        q = torch.clamp((step_res[..., :2] ** 2).mean(dim=(1, 2))
                        / torch.clamp(Q0[0, 0], min=1e-6), min=1e-3)
        xs, Ps, _ = _smooth_pass(x0s, P0s, zs, masks, A,
                                 Q0 * q[:, None, None],
                                 R0 * r[:, None, None])
    return xs, Ps


def rts_smooth(x0, P0, zs, mask, radar_period, em_iters: int = 0,
               sigma_q: float = None, sigma_r: float = None,
               em_mode: str = 'scalar'):
    """Smooth one track: x0 [4], P0 [4,4], zs [N,2], mask [N].  Returns
    (xs [N,4], Ps [N,4,4])."""
    xs, Ps = smooth_tracks(x0[None], P0[None], zs[None], mask[None],
                           radar_period, em_iters=em_iters, em_mode=em_mode,
                           sigma_q=sigma_q, sigma_r=sigma_r)
    return xs[0], Ps[0]

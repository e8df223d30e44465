"""K1, the fused gate-and-score pass of grow: its CUDA kernel and its
plain torch twin.

For every hypothesis leaf: constant-velocity predict, 2x2 innovation,
all-pairs NIS against every measurement, the chi-square gate and the
candidate score  cnllr + NIS/2 + ln(lambda_ex sqrt(det 2 pi S) / P_d),
plus the zero-hypothesis column cnllr - ln(1 - P_d).

The kernel (``csrc/gate_score.cu``) replaces the TPU kernel ``_kernel``
launched by ``gate_and_score_pallas`` (pymht_tpu/ops/gate_kernel.py:34-202);
see the source for what bounds it on an H100 and how its design answers.

``gate_and_score`` takes the plain twin for tensors on the CPU.  For
CUDA tensors it launches the kernel or raises: there is no fallback.
``launches`` counts kernel launches, so a run can show that its path
went through the kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..models import pv
from . import kalman as k

BIG = 1e9
launches = 0      # kernel launches made by gate_and_score (CUDA tensors)

_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p]


def gate_and_score_reference(x, P, cnllr, pd, mask, z, zmask,
                             radar_period, q_scale, r_var, eta2, lambda_ex):
    """Plain torch twin (counterpart of the JAX gate_and_score_reference,
    pymht_tpu/ops/gate_kernel.py:205-223): the einsum Kalman path, with
    kalman.nllr's unclamped det.

    x [N,4], P [N,4,4], cnllr/pd [N] f32, mask [N] bool, z [M,2],
    zmask [M] bool; radar_period a float or 0-d tensor.
    Returns (scores [N, 1+M], x_bar [N,4], P_bar [N,4,4])."""
    dev = x.device
    A = pv.Phi(radar_period, dev)
    Q = pv.Q(radar_period, q_scale, dev)
    R = torch.eye(2, dtype=torch.float32, device=dev) * r_var
    x_bar, P_bar = k.predict(A, Q, x, P)
    z_hat, S, S_inv, _, _ = k.precalc(pv.C_RADAR(dev), R, x_bar, P_bar)
    nis = k.nis(k.residuals(z, z_hat), S_inv)
    nllr_m = k.nllr(lambda_ex, pd, S, nis)
    gate = (nis <= eta2) & zmask[None, :] & mask[:, None]
    meas = torch.where(gate, cnllr[:, None] + nllr_m, BIG)
    zero = torch.where(mask, cnllr - torch.log1p(-pd), BIG)
    return torch.cat([zero[:, None], meas], dim=1), x_bar, P_bar


def _lib():
    from ..kernels import build
    lib = build.load("gate_score")
    fn = lib.gate_score_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(name, t, dtype, shape, dev):
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"gate_and_score: {name} must be a contiguous "
                         f"{dtype} tensor of shape {shape} on {dev}; got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def gate_and_score_cuda(x, P, cnllr, pd, mask, z, zmask,
                        radar_period, q_scale, r_var, eta2, lambda_ex):
    """Launch K1 on the current stream.  Same contract as the twin; the
    scalars travel in a small device tensor, so a device ``radar_period``
    (the per-scan dt) is never read back to the host."""
    global launches
    dev = x.device
    N, M = x.shape[0], z.shape[0]
    P = P.reshape(N, 16)
    for name, t, dtype, shape in (
            ("x", x, torch.float32, (N, 4)), ("P", P, torch.float32, (N, 16)),
            ("cnllr", cnllr, torch.float32, (N,)),
            ("pd", pd, torch.float32, (N,)), ("mask", mask, torch.bool, (N,)),
            ("z", z, torch.float32, (M, 2)),
            ("zmask", zmask, torch.bool, (M,))):
        _check(name, t, dtype, shape, dev)
    host = torch.tensor([0.0, q_scale, r_var, eta2,
                         math.log(max(float(lambda_ex), 1e-20)), 0.0, 0.0,
                         0.0], dtype=torch.float32)
    params = host.to(dev, non_blocking=True)   # pageable: staged, no sync
    params[0:1] = pv.as_time(radar_period, dev).reshape(1)
    scores = torch.empty((N, M + 1), dtype=torch.float32, device=dev)
    xbar = torch.empty((N, 4), dtype=torch.float32, device=dev)
    pbar = torch.empty((N, 16), dtype=torch.float32, device=dev)
    if N > 0:
        fn = _lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(params.data_ptr(), x.data_ptr(), P.data_ptr(),
                     cnllr.data_ptr(), pd.data_ptr(), mask.data_ptr(),
                     z.data_ptr(), zmask.data_ptr(), scores.data_ptr(),
                     xbar.data_ptr(), pbar.data_ptr(), N, M, stream)
        if err != 0:
            raise RuntimeError(f"gate_score kernel launch failed: CUDA "
                               f"error {err}")
        launches += 1
    return scores, xbar, pbar.reshape(N, 4, 4)


def gate_and_score(x, P, cnllr, pd, mask, z, zmask, radar_period,
                   q_scale, r_var, eta2, lambda_ex):
    """Signature of gate_and_score_pallas: x [N,4], P [N,4,4],
    cnllr/pd/mask [N], z [M,2], zmask [M].  Returns
    (scores [N, M+1], x_bar [N,4], P_bar [N,4,4]).  CPU tensors take the
    plain twin; CUDA tensors take the kernel."""
    if x.device.type == "cpu":
        return gate_and_score_reference(x, P, cnllr, pd, mask, z, zmask,
                                        radar_period, q_scale, r_var,
                                        eta2, lambda_ex)
    if x.device.type != "cuda":
        raise ValueError(f"gate_and_score: no path for device {x.device}")
    return gate_and_score_cuda(x, P, cnllr, pd, mask, z, zmask,
                               radar_period, q_scale, r_var, eta2,
                               lambda_ex)

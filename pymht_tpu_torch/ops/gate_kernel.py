"""K1, the fused gate-and-score pass of grow: its CUDA kernel and its
plain torch twin.

For every hypothesis leaf: constant-velocity predict, 2x2 innovation,
all-pairs NIS against every measurement, the chi-square gate and the
candidate score  cnllr + NIS/2 + ln(lambda_ex sqrt(det 2 pi S) / P_d),
plus the zero-hypothesis column cnllr - ln(1 - P_d); and, from the same
pass, what grow needs after its beam: the radar update's gain K and
covariance P_hat per leaf, the number of gated measurements per leaf and
the mask of measurements gated by any leaf.

The kernel (``csrc/gate_score.cu``) replaces the TPU kernel ``_kernel``
launched by ``gate_and_score_pallas`` (pymht_tpu/ops/gate_kernel.py:34-202)
and returns what the JAX package's fused default path returns beside it
(``radar_candidates_planes``, pymht_tpu/ops/ais_fused.py:397-482); see the
source for what bounds it on an H100 and how its design answers.

``radar_candidates`` returns all seven outputs, ``gate_and_score`` the
Pallas contract's three; both make the one launch.  They take the plain
twin for tensors on the CPU.  For CUDA tensors they launch the kernel or
raise: there is no fallback.  ``launches`` counts kernel launches, so a
run can show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ..models import pv
from . import kalman as k

BIG = 1e9
launches = 0      # kernel launches made (CUDA tensors only)

_PTR, _F32, _INT = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
_ARGTYPES = [_PTR] * 8 + [_F32] * 4 + [_PTR] * 7 + [_INT, _INT, _PTR]


class RadarCandidates(NamedTuple):
    """Everything grow's radar branch reads of one scan's candidates."""
    scores: torch.Tensor        # [N, 1+M] f32; column 0 the zero hypothesis
    x_bar: torch.Tensor         # [N, 4]
    P_bar: torch.Tensor         # [N, 4, 4]
    K: torch.Tensor             # [N, 4, 2] radar gain
    P_hat: torch.Tensor         # [N, 4, 4] covariance after a radar update
    gated_counts: torch.Tensor  # [N] i32 gated measurements per leaf
    used_meas: torch.Tensor     # [M] bool gated by any live leaf


def radar_candidates_reference(x, P, cnllr, pd, mask, z, zmask,
                               radar_period, q_scale, r_var, eta2,
                               lambda_ex) -> RadarCandidates:
    """Plain torch twin (counterpart of the JAX gate_and_score_reference,
    pymht_tpu/ops/gate_kernel.py:205-223, extended with precalc's K and
    P_hat and the gate's reductions): the einsum Kalman path, with
    kalman.nllr's unclamped det.

    x [N,4], P [N,4,4], cnllr/pd [N] f32, mask [N] bool, z [M,2],
    zmask [M] bool; radar_period a float or 0-d tensor."""
    dev = x.device
    A = pv.Phi(radar_period, dev)
    Q = pv.Q(radar_period, q_scale, dev)
    R = torch.eye(2, dtype=torch.float32, device=dev) * r_var
    x_bar, P_bar = k.predict(A, Q, x, P)
    z_hat, S, S_inv, K, P_hat = k.precalc(pv.C_RADAR(dev), R, x_bar, P_bar)
    nis = k.nis(k.residuals(z, z_hat), S_inv)
    nllr_m = k.nllr(lambda_ex, pd, S, nis)
    gate = (nis <= eta2) & zmask[None, :] & mask[:, None]
    meas = torch.where(gate, cnllr[:, None] + nllr_m, BIG)
    zero = torch.where(mask, cnllr - torch.log1p(-pd), BIG)
    return RadarCandidates(
        scores=torch.cat([zero[:, None], meas], dim=1), x_bar=x_bar,
        P_bar=P_bar, K=K, P_hat=P_hat,
        gated_counts=gate.sum(dim=1, dtype=torch.int32),
        used_meas=gate.any(dim=0))


def gate_and_score_reference(x, P, cnllr, pd, mask, z, zmask,
                             radar_period, q_scale, r_var, eta2, lambda_ex):
    """The twin's first three outputs:
    (scores [N, 1+M], x_bar [N,4], P_bar [N,4,4])."""
    return radar_candidates_reference(x, P, cnllr, pd, mask, z, zmask,
                                      radar_period, q_scale, r_var, eta2,
                                      lambda_ex)[:3]


def _lib():
    from ..kernels import build
    lib = build.load("gate_score")
    if lib.gate_score_launch.argtypes is None:
        lib.gate_score_launch.argtypes = _ARGTYPES
        lib.gate_score_launch.restype = _INT
        lib.gate_score_occupancy.argtypes = [ctypes.POINTER(_INT)] * 2
        lib.gate_score_occupancy.restype = _INT
    return lib


def occupancy(device=None):
    """(SMs of the device, blocks of K1 each SM can hold at once), as the
    CUDA runtime reports them.  Builds the kernel if needed."""
    sms, per_sm = _INT(0), _INT(0)
    with torch.cuda.device(device):
        if _lib().gate_score_occupancy(ctypes.byref(sms),
                                       ctypes.byref(per_sm)) != 0:
            raise RuntimeError("gate_score: the occupancy query failed")
    return sms.value, per_sm.value


def _check(name, t, dtype, shape, align, dev):
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"radar_candidates: {name} must be a contiguous "
                         f"{dtype} tensor of shape {shape} on {dev}, "
                         f"aligned to {align} bytes; got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def empty_outputs(N, M, dev) -> RadarCandidates:
    """Outputs for one launch: everything uninitialised except
    ``used_meas``, which the kernel only sets and so must start at zero."""
    f32 = dict(dtype=torch.float32, device=dev)
    return RadarCandidates(
        scores=torch.empty((N, M + 1), **f32),
        x_bar=torch.empty((N, 4), **f32),
        P_bar=torch.empty((N, 4, 4), **f32),
        K=torch.empty((N, 4, 2), **f32),
        P_hat=torch.empty((N, 4, 4), **f32),
        gated_counts=torch.empty((N,), dtype=torch.int32, device=dev),
        used_meas=torch.zeros((M,), dtype=torch.bool, device=dev))


def launch(out: RadarCandidates, x, P, cnllr, pd, mask, z, zmask, dt,
           q_scale, r_var, eta2, lambda_ex):
    """Launch K1 on the current stream into ``out`` (from
    ``empty_outputs``).  ``dt`` is a 0-d f32 tensor on the device; the
    other scalars go by value.  Nothing is copied from the host."""
    global launches
    dev = x.device
    N, M = x.shape[0], z.shape[0]
    # alignment: the kernel loads x and P as float4 and z as float2, and
    # stores the per-leaf float outputs as float4
    for name, t, dtype, shape, align in (
            ("x", x, torch.float32, (N, 4), 16),
            ("P", P, torch.float32, (N, 4, 4), 16),
            ("cnllr", cnllr, torch.float32, (N,), 4),
            ("pd", pd, torch.float32, (N,), 4),
            ("mask", mask, torch.bool, (N,), 1),
            ("z", z, torch.float32, (M, 2), 8),
            ("zmask", zmask, torch.bool, (M,), 1),
            ("dt", dt, torch.float32, (), 4),
            ("scores", out.scores, torch.float32, (N, M + 1), 4),
            ("x_bar", out.x_bar, torch.float32, (N, 4), 16),
            ("P_bar", out.P_bar, torch.float32, (N, 4, 4), 16),
            ("K", out.K, torch.float32, (N, 4, 2), 16),
            ("P_hat", out.P_hat, torch.float32, (N, 4, 4), 16),
            ("gated_counts", out.gated_counts, torch.int32, (N,), 4),
            ("used_meas", out.used_meas, torch.bool, (M,), 1)):
        _check(name, t, dtype, shape, align, dev)
    if N == 0:
        return
    fn = _lib().gate_score_launch
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), P.data_ptr(), cnllr.data_ptr(), pd.data_ptr(),
                 mask.data_ptr(), z.data_ptr(), zmask.data_ptr(),
                 dt.data_ptr(), q_scale, r_var, eta2,
                 math.log(max(float(lambda_ex), 1e-20)),
                 *(t.data_ptr() for t in out), N, M, stream)
    if err != 0:
        raise RuntimeError(f"gate_score kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1


def radar_candidates(x, P, cnllr, pd, mask, z, zmask, radar_period,
                     q_scale, r_var, eta2, lambda_ex) -> RadarCandidates:
    """x [N,4], P [N,4,4], cnllr/pd/mask [N], z [M,2], zmask [M];
    ``radar_period`` a float or a 0-d tensor (a device value, the per-scan
    dt, is never read back).  CPU tensors take the plain twin; CUDA
    tensors take the kernel."""
    dev = x.device
    if dev.type == "cpu":
        return radar_candidates_reference(x, P, cnllr, pd, mask, z, zmask,
                                          radar_period, q_scale, r_var,
                                          eta2, lambda_ex)
    if dev.type != "cuda":
        raise ValueError(f"radar_candidates: no path for device {dev}")
    out = empty_outputs(x.shape[0], z.shape[0], dev)
    launch(out, x, P, cnllr, pd, mask, z, zmask,
           pv.as_time(radar_period, dev), q_scale, r_var, eta2, lambda_ex)
    return out


def gate_and_score(x, P, cnllr, pd, mask, z, zmask, radar_period,
                   q_scale, r_var, eta2, lambda_ex):
    """Signature of gate_and_score_pallas.  Returns
    (scores [N, M+1], x_bar [N,4], P_bar [N,4,4]): the first three
    outputs of ``radar_candidates``, from the same launch."""
    return radar_candidates(x, P, cnllr, pd, mask, z, zmask, radar_period,
                            q_scale, r_var, eta2, lambda_ex)[:3]

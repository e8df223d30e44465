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

Under grow's spatial pre-gate every target brings its own measurements:
with ``z_sub [T, Km, 2]``, ``zmask_sub [T, Km]``, ``zidx [T, Km]`` and
``leaves_per_target`` the kernel's second entry point gates leaf ``n``
against row ``n // leaves_per_target`` of ``z_sub`` (what
``radar_candidates_planes(..., z_sub, zmask_sub)`` computes), the plane is
``[N, 1 + Km]``, and ``used_meas`` stays on the real measurement axis
through ``zidx``.  ``launches_pregate`` counts that entry point's share of
``launches``.  The same entry point steps a batch of scenarios, one
"target" per scenario (core/grow.py): then ``radar_period`` is a ``[T]``
tensor, each target's own time step.  That entry point runs on a tile
plan made here (``sub_plan``): tiles of R leaves that run across targets,
the lanes that walk a row's columns, the grid, the shared memory and
whether blocks persist with a two-stage ring.  The launcher recomputes
the plan's shared-memory layout and refuses a plan that disagrees.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from ..models import pv
from . import kalman as k

BIG = 1e9
launches = 0          # kernel launches made (CUDA tensors only)
launches_pregate = 0  # of those, launches of the per-target entry point

_PTR, _F32, _INT = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
_ARGTYPES = [_PTR] * 8 + [_F32] * 4 + [_PTR] * 7 + [_INT, _INT, _PTR]
_ARGTYPES_SUB = [_PTR] * 9 + [_F32] * 4 + [_PTR] * 7 + [_INT] * 13 + [_PTR]

# The per-target kernel's tile plan (csrc/gate_score.cu, design point 6).
SUB_MAX_THREADS = 256        # a block's most threads (SUB_MAX_THREADS)
SMEM_BLOCK_LIMIT = 232_448   # shared memory one H100 block may opt into
SMEM_SM = 233_472            # shared memory of one H100 SM
SMEM_BLOCK_RESERVED = 1_024  # what the runtime keeps of it per block
H100_SMS = 132
SUB_ALIGN = 128              # a staged buffer's placement (SUB_ALIGN)
SUB_SLOTS = SUB_MAX_THREADS // 32  # count partials per row (SUB_SLOTS)
SUB_COLS = 4                 # columns a thread works on at once (SUB_COLS)


class SubPlan(NamedTuple):
    """How one launch of the per-target kernel cuts its work."""
    rows: int        # R: leaves per tile, a multiple of 16
    threads: int     # threads per block
    cols_log2: int   # 2**cols_log2 threads share a row's columns
    tiles: int       # ceil(N / R)
    grid: int        # blocks: one per tile, or persistent ones
    smem: int        # bytes of dynamic shared memory per block
    targets: int     # the most targets one tile touches
    stages: int      # 2: persistent blocks with a two-stage ring
    staged: bool     # the targets' columns and the plane tile in shared
    #                  memory (False at Km >= 256 and where even 16 rows
    #                  do not fit: the plane is stored directly)


def _round_up(nbytes, align):
    return -(-nbytes // align) * align


def _round16(nbytes):
    return _round_up(nbytes, 16)


def sub_smem_bytes(rows, targets, Km, stages, staged):
    """Dynamic shared memory of one block, as the kernel lays it out
    (``sub_layout`` in csrc/gate_score.cu): two mbarriers, 32 bytes of row
    and SUB_SLOTS count partials per row, one mark per (target, column),
    rounded up to SUB_ALIGN, then ``stages`` copies of the stage, each
    buffer in a region SUB_ALIGN bytes longer than it, rounded up to
    SUB_ALIGN bytes."""
    def region(nbytes):
        return _round_up(nbytes, SUB_ALIGN) + SUB_ALIGN
    z = targets * Km
    stage = sum(map(region, (rows * 16, rows * 64, rows * 4, rows * 4,
                             rows)))
    if staged:
        stage += sum(map(region, (z * 8, z, z * 4, rows * (Km + 1) * 4)))
    stage += sum(map(region, (rows * 16, rows * 64, rows * 32, rows * 64,
                              rows * 4)))
    head = 16 + rows * (32 + 4 * SUB_SLOTS) + (z if staged else 0)
    return _round_up(head, SUB_ALIGN) + stages * stage


def sub_threads(Km):
    """Threads per block: 128 where a tile's work is a long stream of
    columns (Km >= 256) or few (Km <= 32), so that four blocks share an
    SM; 256 between.  Measured on the H100 (PERF.md, Findings)."""
    return 128 if Km <= 32 or Km >= 256 else 256


def sub_rows(N, Km, sms=H100_SMS):
    """Leaves per tile: 16 at Km >= 256, else 64, or fewer where the
    shape would not give every SM a tile (N below 64 per SM)."""
    if Km >= 256:
        return 16
    return min(64, max(16, _round16(-(-N // sms))))


def sub_staged(Km):
    """Whether the plane tile is staged in shared memory and written by
    bulk copy (Km < 256), or stored directly, its columns read from global
    memory (Km >= 256, where a row is over a kilobyte: measured 1 % faster
    at Km = 512 on the H100, PERF.md Findings)."""
    return Km < 256


def sub_stages(tiles, Km, sms=H100_SMS):
    """2 (persistent blocks, two-stage ring) where there are at least
    eight tiles per SM and 32 < Km < 256; else 1 (a block per tile)."""
    return 2 if tiles >= 8 * sms and 32 < Km < 256 else 1


def _cols_log2(rows, Km, threads):
    """How many threads share a row's columns (a power of two up to the
    block, leaving each thread at most 32 rows, one bit each in a word;
    a thread takes SUB_COLS columns at a time): the count that gives each
    thread the fewest pair steps (its rows times its columns), the widest
    among equals."""
    best = None
    for lg in range(threads.bit_length() - 1, -1, -1):
        cs = 1 << lg
        rows_each = -(-rows // (threads // cs))
        steps = rows_each * -(-Km // (cs * SUB_COLS)) * SUB_COLS
        if rows_each <= 32 and (best is None or steps < best[0]):
            best = (steps, lg)
    return best[1]


def sub_plan(T, L, Km, sms=H100_SMS, blocks_per_sm=None, rows=None,
             stages=None, threads=None, staged=None) -> SubPlan:
    """The tile plan of the per-target kernel for T targets of L leaves
    against Km columns each.  ``rows``, ``stages``, ``threads`` and
    ``staged`` override ``sub_rows`` / ``sub_stages`` / ``sub_threads`` /
    ``sub_staged``.  A persistent grid holds ``sms`` times
    ``blocks_per_sm`` blocks (the CUDA runtime's figure on the card; here
    estimated from shared memory and threads when None).  Where the plan
    does not fit a block's shared memory it takes fewer stages, then 16
    rows, then stores the plane directly (``staged`` False)."""
    N = T * L
    threads = threads or sub_threads(Km)
    R0 = min(rows or sub_rows(N, Km, sms), max(16, _round16(N)))
    S0 = stages or sub_stages(-(-N // R0), Km, sms)
    tries = ((R0, S0, True), (R0, 1, True), (16, S0, True), (16, 1, True),
             (16, S0, False), (16, 1, False))
    if not (sub_staged(Km) if staged is None else staged):
        tries = ((R0, S0, False), (R0, 1, False)) + tries[-2:]
    for R, S, staged in tries:
        targets = min(T, (R + L - 2) // L + 1)
        smem = sub_smem_bytes(R, targets, Km, S, staged)
        if smem <= SMEM_BLOCK_LIMIT:
            break
    tiles = -(-N // R)
    grid = tiles
    if S == 2:
        if blocks_per_sm is None:
            blocks_per_sm = min(2048 // threads,
                                SMEM_SM // (smem + SMEM_BLOCK_RESERVED))
        grid = min(tiles, max(1, blocks_per_sm) * sms)
    return SubPlan(rows=R, threads=threads,
                   cols_log2=_cols_log2(R, Km, threads), tiles=tiles,
                   grid=grid, smem=smem, targets=targets, stages=S,
                   staged=staged)


class RadarCandidates(NamedTuple):
    """Everything grow's radar branch reads of one scan's candidates."""
    scores: torch.Tensor        # [N, 1+M] f32; column 0 the zero hypothesis
    #                             ([N, 1+Km] with per-target measurements)
    x_bar: torch.Tensor         # [N, 4]
    P_bar: torch.Tensor         # [N, 4, 4]
    K: torch.Tensor             # [N, 4, 2] radar gain
    P_hat: torch.Tensor         # [N, 4, 4] covariance after a radar update
    gated_counts: torch.Tensor  # [N] i32 gated measurements per leaf
    used_meas: torch.Tensor     # [M] bool gated by any live leaf


def radar_candidates_reference(x, P, cnllr, pd, mask, z, zmask,
                               radar_period, q_scale, r_var, eta2,
                               lambda_ex, z_sub=None, zmask_sub=None,
                               zidx=None, leaves_per_target=None
                               ) -> RadarCandidates:
    """Plain torch twin (counterpart of the JAX gate_and_score_reference,
    pymht_tpu/ops/gate_kernel.py:205-223, extended with precalc's K and
    P_hat and the gate's reductions): the einsum Kalman path, with
    kalman.nllr's unclamped det.

    x [N,4], P [N,4,4], cnllr/pd [N] f32, mask [N] bool, z [M,2],
    zmask [M] bool; radar_period a float or 0-d tensor.  With ``z_sub``
    [T,Km,2], ``zmask_sub`` [T,Km], ``zidx`` [T,Km] and
    ``leaves_per_target`` = N // T, leaf n meets row n // L of ``z_sub``
    and ``used_meas`` [M] is scattered through ``zidx``; there
    ``radar_period`` may also be a [T] tensor, target t's time step."""
    dev = x.device
    A = pv.Phi(radar_period, dev)
    Q = pv.Q(radar_period, q_scale, dev)
    R = torch.eye(2, dtype=torch.float32, device=dev) * r_var
    if A.dim() == 3:                     # one time step per target
        L = _sub_shape(x, z_sub, leaves_per_target)[1]
        A, Q = A.repeat_interleave(L, 0), Q.repeat_interleave(L, 0)
        x_bar = torch.einsum('nij,nj->ni', A, x)
        P_bar = torch.einsum('nij,njk,nlk->nil', A, P, A) + Q
    else:
        x_bar, P_bar = k.predict(A, Q, x, P)
    z_hat, S, S_inv, K, P_hat = k.precalc(pv.C_RADAR(dev), R, x_bar, P_bar)
    if z_sub is None:
        zt, zm = k.residuals(z, z_hat), zmask[None, :]
    else:
        T, L = _sub_shape(x, z_sub, leaves_per_target)
        zt = (z_sub[:, None] - z_hat.view(T, L, 1, 2)).reshape(
            T * L, -1, 2)                                      # [N,Km,2]
        zm = zmask_sub.repeat_interleave(L, dim=0)             # [N,Km]
    nis = k.nis(zt, S_inv)
    nllr_m = k.nllr(lambda_ex, pd, S, nis)
    gate = (nis <= eta2) & zm & mask[:, None]
    meas = torch.where(gate, cnllr[:, None] + nllr_m, BIG)
    zero = torch.where(mask, cnllr - torch.log1p(-pd), BIG)
    if z_sub is None:
        used = gate.any(dim=0)
    else:
        M = z.shape[0]
        any_l = gate.view(T, L, -1).any(dim=1)                 # [T,Km]
        used = torch.zeros((M + 1,), dtype=torch.bool, device=dev)
        # a fill, not ``used[idx] = True``: no Python value to copy in
        used.index_fill_(0, torch.where(any_l, zidx.long(), M).reshape(-1),
                         True)
        used = used[:M]
    return RadarCandidates(
        scores=torch.cat([zero[:, None], meas], dim=1), x_bar=x_bar,
        P_bar=P_bar, K=K, P_hat=P_hat,
        gated_counts=gate.sum(dim=1, dtype=torch.int32),
        used_meas=used)


def _sub_shape(x, z_sub, leaves_per_target):
    """(T, L) of a per-target call; raises unless N = T * L."""
    T, L = z_sub.shape[0], leaves_per_target
    if not L or L < 1 or T * L != x.shape[0]:
        raise ValueError(
            f"radar_candidates: z_sub has {T} targets, so x must hold "
            f"{T} * leaves_per_target leaves; got {x.shape[0]} leaves and "
            f"leaves_per_target={leaves_per_target}")
    return T, L


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
        lib.gate_score_sub_launch.argtypes = _ARGTYPES_SUB
        lib.gate_score_sub_launch.restype = _INT
        lib.gate_score_occupancy.argtypes = [ctypes.POINTER(_INT)] * 2
        lib.gate_score_occupancy.restype = _INT
        lib.gate_score_sub_occupancy.argtypes = (
            [_INT] * 3 + [ctypes.POINTER(_INT)] * 2)
        lib.gate_score_sub_occupancy.restype = _INT
        lib.gate_score_sub_startup_launch.argtypes = [_INT] * 3 + [_PTR]
        lib.gate_score_sub_startup_launch.restype = _INT
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


def sub_occupancy(plan: SubPlan, device=None):
    """(SMs of the device, blocks of the per-target kernel each SM holds
    at once at ``plan``'s threads and shared memory), as the CUDA runtime
    reports them."""
    sms, per_sm = _INT(0), _INT(0)
    with torch.cuda.device(device):
        err = _lib().gate_score_sub_occupancy(
            plan.threads, plan.smem, int(plan.staged), ctypes.byref(sms),
            ctypes.byref(per_sm))
    if err != 0:
        raise RuntimeError(f"gate_score: the per-target occupancy query "
                           f"failed: CUDA error {err}")
    return sms.value, per_sm.value


@functools.lru_cache(maxsize=256)
def card_plan(device_index, T, L, Km, rows=None, stages=None,
              threads=None, staged=None) -> SubPlan:
    """``sub_plan`` with the SMs and the occupancy of the card."""
    kw = dict(rows=rows, stages=stages, threads=threads, staged=staged)
    plan = sub_plan(T, L, Km, **kw)
    sms, per_sm = sub_occupancy(plan, device_index)
    return sub_plan(T, L, Km, sms=sms, blocks_per_sm=per_sm, **kw)


def launch_startup(plan: SubPlan, device=None):
    """Launch an empty kernel at ``plan``'s grid, block and shared memory
    on the current stream: the floor under a launch of the per-target
    kernel.  Not a K1 launch, and not counted."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().gate_score_sub_startup_launch(plan.grid, plan.threads,
                                                   plan.smem, stream)
    if err != 0:
        raise RuntimeError(f"gate_score: the start-up launch failed: CUDA "
                           f"error {err}")


def _check(name, t, dtype, shape, align, dev):
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"radar_candidates: {name} must be a contiguous "
                         f"{dtype} tensor of shape {shape} on {dev}, "
                         f"aligned to {align} bytes; got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def empty_outputs(N, M, dev, Km=None) -> RadarCandidates:
    """Outputs for one launch: everything uninitialised except
    ``used_meas``, which the kernel only sets and so must start at zero.
    ``Km``: columns of a per-target call (the plane is [N, 1 + Km];
    ``used_meas`` keeps the real M)."""
    f32 = dict(dtype=torch.float32, device=dev)
    return RadarCandidates(
        scores=torch.empty((N, (M if Km is None else Km) + 1), **f32),
        x_bar=torch.empty((N, 4), **f32),
        P_bar=torch.empty((N, 4, 4), **f32),
        K=torch.empty((N, 4, 2), **f32),
        P_hat=torch.empty((N, 4, 4), **f32),
        gated_counts=torch.empty((N,), dtype=torch.int32, device=dev),
        used_meas=torch.zeros((M,), dtype=torch.bool, device=dev))


def launch(out: RadarCandidates, x, P, cnllr, pd, mask, z, zmask, dt,
           q_scale, r_var, eta2, lambda_ex, z_sub=None, zmask_sub=None,
           zidx=None, leaves_per_target=None, plan=None):
    """Launch K1 on the current stream into ``out`` (from
    ``empty_outputs``).  ``dt`` is a 0-d f32 tensor on the device, or for
    the per-target entry point also ``[T]`` (one time step per target;
    an expanded scalar, stride 0, is read without a copy); the other
    scalars go by value.  Nothing is copied from the host.
    With ``z_sub`` the per-target entry point is launched (``out`` from
    ``empty_outputs(N, M, dev, Km)``; ``zidx`` int32 with values in
    [0, M)), on ``plan`` (a ``SubPlan``; by default ``card_plan``'s).
    Raises for a shape the kernel's 32-bit leaf and measurement indices
    cannot address."""
    global launches, launches_pregate
    dev = x.device
    N, M = x.shape[0], z.shape[0]
    if 16 * N >= 2 ** 31 or M >= 2 ** 31:
        raise ValueError(f"radar_candidates: {N} leaves and {M} measurements "
                         f"exceed the kernel's int32 indices (16 N and M "
                         f"must stay below 2^31)")
    sub = z_sub is not None
    if sub:
        T, L = _sub_shape(x, z_sub, leaves_per_target)
        Km = z_sub.shape[1]
        if Km < 1 or zmask_sub is None or zidx is None:
            raise ValueError("radar_candidates: z_sub needs Km >= 1 columns "
                             "and both zmask_sub and zidx")
        dt_step = dt.stride(0) if dt.dim() == 1 else 0
        if dt.dim() == 1 and (dt.shape[0] != T or dt_step not in (0, 1)):
            raise ValueError(f"radar_candidates: dt must be 0-d or one step "
                             f"per target, [{T}] with stride 0 or 1; got "
                             f"shape {tuple(dt.shape)}, stride {dt.stride()}")
        dt_one = dt[:1] if dt.dim() == 1 else dt   # dtype, device, alignment
        per_target = (("z_sub", z_sub, torch.float32, (T, Km, 2), 8),
                      ("zmask_sub", zmask_sub, torch.bool, (T, Km), 1),
                      ("zidx", zidx, torch.int32, (T, Km), 4),
                      ("dt", dt_one, torch.float32, tuple(dt_one.shape), 4))
        leaf_align = 4
    else:
        Km, per_target = M, (("dt", dt, torch.float32, (), 4),)
        leaf_align = 16
    # alignment: the shared-scan kernel loads x and P as float4; both
    # entry points read z as float2 and store the per-leaf float outputs
    # as float4.  The per-target kernel copies its inputs in bulk from any
    # address: a buffer's part before its first 16-byte boundary goes by
    # plain loads (csrc/gate_score.cu, design point 6c)
    for name, t, dtype, shape, align in (
            ("x", x, torch.float32, (N, 4), leaf_align),
            ("P", P, torch.float32, (N, 4, 4), leaf_align),
            ("cnllr", cnllr, torch.float32, (N,), 4),
            ("pd", pd, torch.float32, (N,), 4),
            ("mask", mask, torch.bool, (N,), 1),
            ("z", z, torch.float32, (M, 2), 8),
            ("zmask", zmask, torch.bool, (M,), 1),
            *per_target,
            ("scores", out.scores, torch.float32, (N, Km + 1), 4),
            ("x_bar", out.x_bar, torch.float32, (N, 4), 16),
            ("P_bar", out.P_bar, torch.float32, (N, 4, 4), 16),
            ("K", out.K, torch.float32, (N, 4, 2), 16),
            ("P_hat", out.P_hat, torch.float32, (N, 4, 4), 16),
            ("gated_counts", out.gated_counts, torch.int32, (N,), 4),
            ("used_meas", out.used_meas, torch.bool, (M,), 1)):
        _check(name, t, dtype, shape, align, dev)
    if N == 0:
        return
    lib = _lib()
    leaves = [t.data_ptr() for t in (x, P, cnllr, pd, mask)]
    scalars = (q_scale, r_var, eta2, math.log(max(float(lambda_ex), 1e-20)))
    outs = [t.data_ptr() for t in out]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if sub:
            p = plan or card_plan(torch.cuda.current_device(), T, L, Km)
            err = lib.gate_score_sub_launch(
                *leaves, z_sub.data_ptr(), zmask_sub.data_ptr(),
                zidx.data_ptr(), dt.data_ptr(), *scalars, *outs, T, L, Km, M,
                dt_step, p.rows, p.threads, p.cols_log2, p.grid, p.smem,
                p.targets, p.stages, int(p.staged), stream)
            if err == -1:
                raise RuntimeError(f"gate_score: the per-target kernel "
                                   f"refused the tile plan {p}")
        else:
            err = lib.gate_score_launch(
                *leaves, z.data_ptr(), zmask.data_ptr(), dt.data_ptr(),
                *scalars, *outs, N, M, stream)
    if err != 0:
        raise RuntimeError(f"gate_score kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    launches_pregate += int(sub)


def radar_candidates(x, P, cnllr, pd, mask, z, zmask, radar_period,
                     q_scale, r_var, eta2, lambda_ex, z_sub=None,
                     zmask_sub=None, zidx=None,
                     leaves_per_target=None) -> RadarCandidates:
    """x [N,4], P [N,4,4], cnllr/pd/mask [N], z [M,2], zmask [M];
    ``radar_period`` a float or a 0-d tensor (a device value, the per-scan
    dt, is never read back).  ``z_sub`` [T,Km,2], ``zmask_sub`` [T,Km],
    ``zidx`` [T,Km] i32 and ``leaves_per_target`` select the per-target
    pass (module docstring), where ``radar_period`` may also be [T].  CPU
    tensors take the plain twin; CUDA tensors take the kernel."""
    dev = x.device
    sub = dict(z_sub=z_sub, zmask_sub=zmask_sub, zidx=zidx,
               leaves_per_target=leaves_per_target)
    if dev.type == "cpu":
        return radar_candidates_reference(x, P, cnllr, pd, mask, z, zmask,
                                          radar_period, q_scale, r_var,
                                          eta2, lambda_ex, **sub)
    if dev.type != "cuda":
        raise ValueError(f"radar_candidates: no path for device {dev}")
    out = empty_outputs(x.shape[0], z.shape[0], dev,
                        Km=None if z_sub is None else z_sub.shape[1])
    launch(out, x, P, cnllr, pd, mask, z, zmask,
           pv.as_time(radar_period, dev), q_scale, r_var, eta2, lambda_ex,
           **sub)
    return out


def gate_and_score(x, P, cnllr, pd, mask, z, zmask, radar_period,
                   q_scale, r_var, eta2, lambda_ex):
    """Signature of gate_and_score_pallas.  Returns
    (scores [N, M+1], x_bar [N,4], P_bar [N,4,4]): the first three
    outputs of ``radar_candidates``, from the same launch."""
    return radar_candidates(x, P, cnllr, pd, mask, z, zmask, radar_period,
                            q_scale, r_var, eta2, lambda_ex)[:3]

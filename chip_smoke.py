#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pymht_tpu_torch) on one GPU.

    python3 chip_smoke.py              # from the root of the repository
    python3 chip_smoke.py --k1-guard   # phases 1-3 only

Phases, in order; any failure raises and the script exits non-zero:

1. the card: torch's device name and nvidia-smi's name and power limit;
2. build: K1 (csrc/gate_score.cu) compiled by nvcc for sm_90a;
3. kernel: K1's seven outputs against its plain torch twin on the card,
   at the bench shape (4096 leaves x 512 measurements), at every other
   shape a later phase launches it at (2048 x 512 after degrade(),
   1024 x 64 and 512 x 64 under 'ipm') and at ragged and edge shapes:
   identical gating, counts and used mask, the rest within
   the stated tolerance (K1_RTOL, K1_ATOL, K1_PHAT_ULPS).  Then its times at the bench shape (CUDA
   events behind a device spin): the kernel alone (back-to-back
   launches into the same buffers, and into rotating buffers that
   exceed the L2), one wrapper call, the twin, and the kernel's bound
   (its input and output bytes over the card's published 3.35 TB/s).
   The same for K1's per-target entry point (the spatial pre-gate's
   ``z_sub [T, Km, 2]``) at T=128, L=32, Km=64 and at edge shapes.
   Then K1 inside guard bands (``guard_check``) at every one of those
   shapes, the swarm's and the saturation points': each of
   K1_GUARD_REPS launches bit for bit an unguarded call's, every band
   untouched (the card runs no sanitizer); ``--k1-guard`` stops here;
4. slice: bench.py's seeded 100-target scene (T=128, L=32, M=512, W=7)
   stepped through ``Tracker(method='lagrangian', use_ais=False)`` on the
   card, with K1's launch count read around that run, then the same
   scene through the port on the CPU (plain twins): same track ids and
   selected labels, states within tolerance, every selection feasible,
   no NaN, track quality above its floor;
5. AIS: bench.py's AIS-fusion scene (the same shapes with A=32 messages
   per scan and G=2, every target with a transponder) through
   ``Tracker(use_ais=True)`` on the card and on the CPU: the same checks,
   on (measurement, MMSI) labels, at least one fused and one pure-AIS
   association among the selected labels, K1 launched once per scan, and
   no host sync inside grow;
6. pre-gate: the AIS scene with ``radar_cand_width=64`` for 5 scans, card
   against CPU (must agree) and against the un-pre-gated card run
   (reported), with the launches of K1's per-target entry point counted;
7. stream: the AIS scene through ``Tracker.stream(chunk=4)`` on the card
   against the stepped card run of phase 5 and against the same stream on
   the CPU (ids, labels, confirmed archives, states), K1 once per scan,
   ms/scan and host reads per scan beside the stepped path's;
8. dynamic window and degrade: the radar-only scene streamed with the
   on-device window and ``prune_similar`` for 8 scans, ``degrade()`` by
   hand (L 32 -> 16), then the rest: card against CPU, the forest's
   invariants after every chunk, the selected estimate unchanged by the
   conversion, K1 at N = 2048 after it, track quality above its floor;
   and one more grow, merge and window under the CUDA sync debug mode;
9. roof: a short streamed run with ``degrade_on_overload`` and a scripted
   clock that reports an overlong second and third chunk: ``degrade()``
   fires once, after the second;
10. scatter: ``select`` on the AIS phase's last grown forest with the
    scatter formulations forced against the dense ones (must agree), then
    both builds timed at the bench shape and on a seeded swarm forest
    (T=2048, L=16, M=4096, A=8, W=7);
11. smoother: ``get_smooth_tracks`` (pure RTS, and 5 EM iterations in
    'full' mode) on the card tracker of phase 4 against the CPU tracker's;
12. ipm: examples/demo_tracking.py's scene (T=32, L=32, M=64, A=8, W=7,
    six targets with transponders, 21 scans) through ``Tracker(method=
    'ipm', use_ais=True)``, the class's default solver, on the card and on
    the CPU: every scan feasible, objectives within 1e-4 (1 + |obj|),
    the same final track ids, track quality above its floor, the
    interior-point solver entered at least once, K1 once per scan and
    held against its twin on the leaves and measurements of two of those
    scans; one conflicted select timed and its device operations counted.
    Then eval_configs.py's ``2_ipm_xcheck`` scene for 16 scans with
    ``'ipm'`` beside ``'lagrangian'``: objectives within 0.1 % of each
    other, K1 against its twin on a scan's tensors.  This second run is no
    check of the interior-point solver: it prints the scans on which a
    solver ran, and on this scene no scan leaves the fast path, so both
    methods return the independent optimum.  The solver is held to the
    CPU run above and to the oracles in phase 14;
13. pure: the radar-only bench scene for 5 scans with
    ``method='lagrangian_pure'``, card against CPU;
14. gap: the ``'lagrangian'`` selection on the last grown forest of the
    radar-only and of the AIS bench scene against the scipy/HiGHS oracle
    (gap <= 1e-3, optimality proven), and the ``'ipm'`` selection on the
    demo scene's last conflicted forest against HiGHS and against the
    native branch-and-bound (csrc/exact_solver.cpp, built here);
15. checkpoint: the AIS scene streamed on the card in chunks of 4, saved
    after two chunks, loaded into a new Tracker on the card and finished
    on both: states bitwise equal; the same file loaded on the CPU
    against the CPU stream;
16. xml: ``store_run(smooth=True)`` of the demo run, written and parsed
    back;
17. mc: eval_configs.py's Monte-Carlo configuration (T=8, L=16, M=28,
    W=6, 4 targets, 10 scans, an 800 m radar, sigma_Q 0.05) at BASELINE
    config 4's B=256 scenarios (``utils/scenes.mc_scene``, drawn on a CPU
    generator and moved to the card) through ``parallel.montecarlo.
    run_batch``: K1 launched once per batched scan (its per-target entry
    point, one "target" per scenario), batched grow without a host sync;
    the card against the port's batched run on the CPU and against
    scenarios 0 and 255 stepped alone on the card through ``scan_step``
    (track masks and integer state equal, floats within STATE_RTOL /
    STATE_ATOL); ``tracks_alive`` / ``expected`` / ``median_err`` as
    eval_configs.py prints them; K1 against its twin at the batched shape
    (seeded, and on two real scans' tensors), with its times and bound;
    ms per batched scan, scenario-scans per second and host reads;
18. mc-bench: B=32 scenarios at bench.py's shapes and parameters (T=128,
    L=32, M=512, W=7, 100 targets, a 2 km radar, 13 scans;
    ``scenes.mc_bench_scene``) the same way, against scenarios 0 and 31
    stepped alone on the card (the CPU is too slow at this size), with
    the run's peak device memory;
19. mc-ais: B=32 draws of the AIS-fusion scene (T=128, L=32, M=512,
    A=32, G=2, W=7, 12 scans; ``scenes.bench_ais_batch``, each padded by
    a Tracker and pre-initialised with its seeds and MMSIs) through
    ``make_batched_step(method='lagrangian', use_ais=True)``: K1 once per
    batched scan, every selection feasible, scenarios 0 and 31 against
    themselves stepped alone on the card (labels, selected leaves,
    states, objectives), a B=4, 4-scan batch against its CPU run, K1
    against its twin at the batch's shape (seeded and on two real scans)
    and timed against its bound; ms per batched scan, host reads, peak
    device memory;
20. mc-pregate: the mc-bench batch (B=32) with ``radar_cand_width=64``
    through ``run_batch``: K1's per-target entry point with B * T = 4096
    targets of Km = 64 columns on the flat [B * M] axis, the rest as
    phase 18;
21. mc-ipm: B=8 draws of the demo scene (T=32, L=32, M=64, A=8, W=7, 21
    scans) under ``make_batched_step(method='ipm', use_ais=True)``: the
    interior-point solver entered, every scan feasible, every scenario
    against itself stepped alone under 'ipm' on the card, K1 at the
    batch's shape; then 'lagrangian_pure' on the same batch for 5 scans
    from the state after 12, every scenario against itself alone;
22. sharded-1: tests/test_sharded_swarm.py's scene (T=1024 slots, 600
    targets, L=8, M=512, A=32, G=2, W=5, seed 42, 4 scans,
    ``utils/scenes.swarm_shard_scene``) through ``parallel.sharded_tracker.
    make_sharded_tracker_step`` at one NCCL rank: K1 once per scan at
    N=8192 and held against its twin on two scans' tensors, the
    replicated state's digests equal after every scan, against the
    unsharded ``scan_step`` on the card (the JAX test's contract: feasible,
    objectives within 1e-3, at least 99.5 % of the labels equal, AIS labels
    and states equal where they are) and against the same sharded step on
    the CPU (one gloo rank); ms/scan, host reads, collectives and bytes
    per scan beside the unsharded step's; K1 timed at N=8192 against its
    bound; the state after 2 scans saved.  Then bench.py's radar-only
    scene (13 scans) through the sharded step: track quality above the
    radar-only floor, ms/scan beside the unsharded step's; then the same
    step on the card and on the CPU in lockstep: the scans where the two
    part and, at the first, grow and the distributed select on each device
    from the CPU's state (on the same forest the select must decide the
    same on both);
23. sharded-2: two ranks spawned on the one card, gloo on CUDA tensors
    (NCCL refuses two ranks on one GPU): the swarm scene at 2 x 512 target
    slots for 3 scans, digests after each, every K1 launch (N=4096 per
    rank) held against its twin on its scan's tensors, the gathered
    outputs equal to sharded-1's; sharded-1's checkpoint restored by rows
    (``load_state(shard=)``) and its next scan equal to sharded-1's; the
    measurement exchange over the two ranks; ``dryrun(2)`` on the 1 x 2
    and 2 x 1 meshes against ``make_batched_step``.  Their times are those
    of two processes sharing one GPU over a host transport, not of
    several cards;
24. swarm: the swarm benchmark (``scripts/bench_swarm.run`` at its
    defaults: BASELINE config 5, 1000 targets in T=1024 slots, L=16,
    M=2048, A=128, W=6, G=2, the pre-gate at Km=64, 8 scans streamed
    through ``scan_many`` a warm-up and 3 times, then the oracle's forest):
    K1's per-target entry point once per scan at N=16,384, Km=64, held
    against its twin on a scan's tensors and on seeded ones and timed
    against its bound; the first 3 scans' tracks and (measurement, MMSI)
    labels against the port's CPU run; coverage and rms above their
    floors (set from tests/jax_swarm_reference.py); the exact oracle's gap
    under a 60 s limit (<= 1e-3 when HiGHS proves the optimum);
25. scripts: every script and example of the port through its ``main``
    on the card: eval_configs (small), bench_saturation at T=1024 and
    4096, ab_distributed_select and bench_scaling at one NCCL rank,
    demo_tracking and demo_streaming_deployment with --no-plot; each
    prints its lines; K1's launch shapes counted, and K1 against its twin
    and timed at the saturation points (N=16T, M=2T).

The line before the last is one JSON object describing each kernel of
the path; the last line is ``{"ok": true, "device": {...}}``.  There is
no CPU fallback: without a CUDA device the script exits with code 1.
Every collective and rendezvous of the sharded phases times out after
SHARD_TIMEOUT_S, so ranks that diverge fail the run instead of hanging.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np

# Track quality floor on the bench scene.  The JAX package (pymht_tpu,
# CPU, method='lagrangian') scores coverage 0.99615 and rms 4.0456 m on
# this scene (all 13 scans); the floor sits a little below.
MIN_COVERAGE = 0.99
MAX_RMS = 4.5
# The same for the AIS-fusion scene: the JAX package (CPU,
# method='lagrangian', use_ais=True) scores coverage 0.99308 and rms
# 3.7472 m on it (all 13 scans, 3 false tracks).
MIN_COVERAGE_AIS = 0.985
MAX_RMS_AIS = 4.2
PREGATE_KM = 64
PREGATE_SCANS = 5
# The dynamic-window-and-degrade run of the radar-only scene (streamed
# with the on-device window and prune_similar, beam halved by hand after
# DEGRADE_AFTER scans).  The JAX package (CPU, the same steps:
# tests/jax_degrade_reference.py) scores coverage 0.99462 and rms
# 4.1965 m on it (13 scans, no false track; 42 targets with a shrunk
# window at the switch, 71 at the end).
STREAM_CHUNK = 4
DEGRADE_AFTER = 8
MIN_COVERAGE_DEGRADE = 0.99
MAX_RMS_DEGRADE = 4.5
ROOF_SCANS, ROOF_CHUNK = 8, 2
# Smoothed tracks, card against CPU: the same measurements, initial
# states within STATE_ATOL; 16 steps of f32 filtering and smoothing, and
# with EM five refits of Q and R that feed rounding back.
SMOOTH_RTOL, SMOOTH_ATOL = 1e-3, 5e-2
# The demo scene under 'ipm'.  The JAX package (CPU, Tracker(method='ipm',
# use_ais=True): tests/jax_ipm_reference.py) scores coverage 0.84921 and
# rms 4.2082 m on it (21 scans, no false track; the initiator starts all
# six tracks, which costs the first scans' coverage) and enters the
# solver on 7 scans.
MIN_COVERAGE_IPM = 0.84
MAX_RMS_IPM = 4.6
IPM_OBJ_RTOL = 1e-4
XCHECK_SCANS = 16
PURE_SCANS = 5
GAP_LIMIT = 1e-3             # the 0.1 % contract against the exact oracle
SWARM = dict(max_targets=2048, max_leaves=16, max_meas=4096, max_ais=8,
             window=7)

# K1 against its twin: gating decisions, per-leaf counts and the used
# mask identical; scores, x_bar, P_bar, K and P_hat within these (f32;
# the kernel's closed-form predict and update round differently from the
# twin's einsums).
K1_RTOL, K1_ATOL = 1e-5, 1e-4
# P_hat = P_bar - K S K' cancels: a leaf that coasted for several scans
# has a predicted variance in the thousands of m^2 and an updated one of
# about ten, so P_hat inherits the rounding of P_bar.  Its absolute
# tolerance is therefore never less than this many f32 ulps of the
# leaf's largest |P_bar| (which passes K1_ATOL only above ~100 m^2: not
# on the seeded inputs, only on some leaves of real scans).
K1_PHAT_ULPS = 8
# Published peaks of one H100 SXM, for the kernel's bound.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# Card run against CPU run of the whole slice: labels identical; track
# states within these (13 scans of f32 filtering on ~1 km positions).
STATE_RTOL, STATE_ATOL = 1e-4, 1e-2
OBJ_RTOL = 1e-4


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------
# kernel phase
# ----------------------------------------------------------------------

def k1_inputs(seed, N, M, device, zmask_all=None, mask_all=None):
    """Leaves scattered over a few hundred metres, half of them with a
    measurement where they will be (so gates fire), the rest clutter."""
    import torch
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 100, (N, 4)).astype(np.float32)
    P = np.broadcast_to(np.diag([6.25, 6.25, 1.875, 1.875]),
                        (N, 4, 4)).astype(np.float32)
    P = P + rng.uniform(0, 1, (N, 1, 1)).astype(np.float32) * np.eye(4)
    cnllr = rng.normal(0, 1, N).astype(np.float32)
    pd = np.full(N, 0.9, np.float32)
    mask = rng.uniform(size=N) < 0.9
    z = rng.normal(0, 100, (M, 2)).astype(np.float32)
    k = min(M, N) // 2
    z[:k] = x[:k, :2] + x[:k, 2:] * 2.5 + rng.normal(0, 2.0, (k, 2))
    zmask = rng.uniform(size=M) < 0.95
    if zmask_all is not None:
        zmask[:] = zmask_all
    if mask_all is not None:
        mask[:] = mask_all
    return [torch.from_numpy(np.ascontiguousarray(a, dtype=a.dtype))
            .to(device) for a in (x, P.astype(np.float32), cnllr, pd, mask,
                                  z, zmask)]


def k1_sub_inputs(seed, T, L, Km, M, device, mask_targets=False):
    """A forest for K1's per-target entry point: the L leaves of a target
    lie within metres of each other, each target has a measurement where
    it will be, and its Km nearest valid measurements (grow's pre-gate)
    make ``z_sub``, ``zmask_sub`` and ``zidx``; with ``mask_targets``
    every third target has all its columns masked."""
    import torch
    rng = np.random.default_rng(seed)
    N = T * L
    xt = rng.normal(0, 300, (T, 1, 4))
    x = (xt + rng.normal(0, 2, (T, L, 4))).reshape(N, 4).astype(np.float32)
    P = (np.diag([6.25, 6.25, 1.875, 1.875])
         + rng.uniform(0, 1, (N, 1, 1)) * np.eye(4)).astype(np.float32)
    cnllr = rng.normal(0, 1, N).astype(np.float32)
    pd = np.full(N, 0.9, np.float32)
    mask = rng.uniform(size=N) < 0.9
    z = rng.normal(0, 300, (M, 2)).astype(np.float32)
    k = min(M, T)
    pred = xt[:, 0, :2] + 2.5 * xt[:, 0, 2:]
    z[:k] = pred[:k] + rng.normal(0, 2, (k, 2))
    zmask = rng.uniform(size=M) < 0.95
    d2 = ((z[None] - pred[:, None]) ** 2).sum(-1)
    d2[:, ~zmask] = np.inf
    zidx = np.argsort(d2, axis=1, kind="stable")[:, :Km]
    zmask_sub = zmask[zidx] & np.isfinite(np.take_along_axis(d2, zidx, 1))
    if mask_targets:
        zmask_sub[::3] = False

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    inp = [dev(a) for a in (x, P, cnllr, pd, mask, z, zmask)]
    return inp, dict(z_sub=dev(z[zidx]), zmask_sub=dev(zmask_sub),
                     zidx=dev(zidx.astype(np.int32)), leaves_per_target=L)


def median_ms(fn, reps=30, warmup=3):
    """Median device time of ``fn`` between two CUDA events.  Each rep
    first queues a ~25 ms device spin, so the host has enqueued all of
    ``fn``'s launches before the start event runs: the time is then the
    device's, not the host's enqueue rate (which varies between hosts and
    dominates a 7 us kernel behind a few small wrapper ops)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def kernel_alone_ms(gk, inp, dt, scalars, n_sets, launches=200, reps=7,
                    sub=None):
    """Device time of one K1 launch: ``launches`` back-to-back launches
    between two events, queued behind the device spin, over their count
    (a single 3-7 us launch between events measures the events).  The
    launches rotate over ``n_sets`` sets of output buffers: one set keeps
    the 8.4 MB plane hot in the 50 MB L2, eight sets (76 MB) make every
    launch write lines that the L2 does not hold.  ``sub``: the
    per-target arguments, for that entry point."""
    import torch
    N, M = inp[0].shape[0], inp[5].shape[0]
    sub = sub or {}
    Km = sub["z_sub"].shape[1] if sub else None
    outs = [gk.empty_outputs(N, M, "cuda", Km=Km) for _ in range(n_sets)]

    def burst():
        for i in range(launches):
            gk.launch(outs[i % n_sets], *inp, dt, *scalars, **sub)

    burst()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        a.record()
        burst()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return float(np.median(times))


def k1_bound(N, M):
    """The least time the card could take for K1 at this shape: every
    input byte read once and every output byte written once at the HBM
    rate, against ~15 flops per pair and ~150 per leaf at the f32 rate."""
    bytes_in = N * (16 + 64 + 4 + 4 + 1) + M * (8 + 1) + 4
    bytes_out = N * (4 * (M + 1) + 16 + 64 + 32 + 64 + 4) + M
    t_bytes = 1e3 * (bytes_in + bytes_out) / HBM_BYTES_PER_S
    t_flops = 1e3 * (15.0 * N * M + 150.0 * N) / F32_FLOP_PER_S
    return dict(bytes=bytes_in + bytes_out, bound_ms=max(t_bytes, t_flops),
                bound_by="bytes" if t_bytes >= t_flops else "operations")


def k1_sub_bound(T, L, Km, M, n_dt=1):
    """The same for the per-target entry point: it reads the leaves,
    ``n_dt`` time steps (one, or one per target for a batch of scenarios)
    and the per-target z_sub, zmask_sub and zidx (not the scan's z and
    zmask), and writes the [N, 1 + Km] plane, the per-leaf outputs and
    the used mask of the real M measurements."""
    N = T * L
    bytes_in = (N * (16 + 64 + 4 + 4 + 1) + 4 * n_dt
                + T * Km * (8 + 1 + 4))
    bytes_out = N * (4 * (Km + 1) + 16 + 64 + 32 + 64 + 4) + M
    t_bytes = 1e3 * (bytes_in + bytes_out) / HBM_BYTES_PER_S
    t_flops = 1e3 * (15.0 * N * Km + 150.0 * N) / F32_FLOP_PER_S
    return dict(bytes=bytes_in + bytes_out, bound_ms=max(t_bytes, t_flops),
                bound_by="bytes" if t_bytes >= t_flops else "operations")


def report_gate_difference(gk, name, inp, dt, args, sub, s, s_r, n_diff):
    """What a failing gate comparison leaves behind, before it raises: the
    count again on the host, the first rows that differ, the non-finite
    scores of each side, and whether a second launch on the same inputs
    repeats the first."""
    import torch
    g, g_r = (s < gk.BIG * 0.5).cpu(), (s_r < gk.BIG * 0.5).cpu()
    diff = g != g_r
    rows = diff.any(dim=1).nonzero().flatten()
    again = gk.radar_candidates(*inp, dt, **args, **sub)
    torch.cuda.synchronize()
    print(f"K1 {name}: the card counted {n_diff} differing gates of "
          f"{g.numel()}; the host counts {int(diff.sum())}, in "
          f"{rows.numel()} rows (first {rows[:8].tolist()}); non-finite "
          f"scores: kernel {int((~s.isfinite()).sum())}, twin "
          f"{int((~s_r.isfinite()).sum())}; a second launch on the same "
          f"inputs gives the same scores: {torch.equal(again.scores, s)}",
          flush=True)


def check_against_twin(gk, name, inp, dt, args, sub=None):
    """One K1 call against its twin on the same inputs: gating, counts
    and used identical, the rest within K1_RTOL / K1_ATOL.  Returns
    (max |err|, the twin's gate)."""
    import torch
    BIG = gk.BIG
    sub = sub or {}
    out = gk.radar_candidates(*inp, dt, **args, **sub)
    ref = gk.radar_candidates_reference(*inp, dt, **args, **sub)
    torch.cuda.synchronize()
    s, s_r = out.scores, ref.scores
    g, g_r = s < BIG * 0.5, s_r < BIG * 0.5
    n_diff = int((g != g_r).sum())
    if n_diff:
        report_gate_difference(gk, name, inp, dt, args, sub, s, s_r, n_diff)
    check(n_diff == 0, f"K1 {name}: {n_diff} gating decisions differ")
    check(torch.equal(s[~g_r], s_r[~g_r]),
          f"K1 {name}: ungated scores are not exactly {BIG}")
    check(torch.equal(out.gated_counts, ref.gated_counts)
          and out.gated_counts.dtype == torch.int32,
          f"K1 {name}: per-leaf gated counts differ")
    check(torch.equal(out.used_meas, ref.used_meas),
          f"K1 {name}: used-measurement masks differ")
    check(int(out.gated_counts.sum()) == int(g_r[:, 1:].sum()),
          f"K1 {name}: counts are not the gate's row sums")
    pairs = [(s[g_r], s_r[g_r], "scores")] + [
        (getattr(out, f), getattr(ref, f), f)
        for f in ("x_bar", "P_bar", "K", "P_hat")]
    err = 0.0
    eps = float(torch.finfo(torch.float32).eps)
    scale = ref.P_bar.abs().amax(dim=(1, 2), keepdim=True)       # [N,1,1]
    atol_phat = (K1_PHAT_ULPS * eps * scale).clamp_min(K1_ATOL)
    for a, b, what in pairs:
        atol = atol_phat if what == "P_hat" else K1_ATOL
        check(bool(((a - b).abs() <= atol + K1_RTOL * b.abs()).all()),
              f"K1 {name}: {what} differ beyond rtol {K1_RTOL} "
              f"atol {K1_ATOL}" + (f" (or {K1_PHAT_ULPS} ulps of the "
                                   f"leaf's |P_bar|)" * (what == "P_hat")))
        if a.numel():
            err = max(err, float((a - b).abs().max()))
    if not sub:
        s3 = gk.gate_and_score(*inp, dt, **args)
        check(len(s3) == 3 and all(torch.equal(a, b)
                                   for a, b in zip(s3, out[:3])),
              f"K1 {name}: gate_and_score is not the same pass")
    print(f"K1 {name}: scores {tuple(s.shape)}, gated="
          f"{int(g_r[:, 1:].sum())} used={int(ref.used_meas.sum())} of "
          f"{ref.used_meas.numel()}: gating, counts and used identical, "
          f"max |err| {err:.3g}")
    return err, g_r


def kernel_times(gk, inp, dt, args, sub=None):
    """Device times at one shape: one wrapper call, the twin, and the
    kernel alone with its plane hot in the L2 and flushed."""
    sub = sub or {}
    scalars = (args["q_scale"], args["r_var"], args["eta2"],
               args["lambda_ex"])
    return dict(
        ms=median_ms(lambda: gk.radar_candidates(*inp, dt, **args, **sub)),
        plain_ms=median_ms(
            lambda: gk.radar_candidates_reference(*inp, dt, **args, **sub)),
        kernel_ms=kernel_alone_ms(gk, inp, dt, scalars, n_sets=1, sub=sub),
        kernel_flushed_ms=kernel_alone_ms(gk, inp, dt, scalars, n_sets=8,
                                          sub=sub))


K1_ARGS = dict(q_scale=1.0, r_var=6.25, eta2=5.99, lambda_ex=3e-5)
# (name, N, M, k1_inputs' keywords) of the shared-scan entry point
K1_CASES = [("bench", 4096, 512, {}), ("half beam", 2048, 512, {}),
            # the shapes of the 'ipm' runs: the demo scene (T=32, L=32,
            # M=64) and 2_ipm_xcheck (T=16); M is below a block's threads
            ("demo scene", 1024, 64, {}), ("xcheck scene", 512, 64, {}),
            ("ragged", 4095, 512, {}),
            ("ragged, N % 4 = 2", 4094, 512, {}),
            ("one measurement", 4096, 1, {}),
            ("measurements masked", 4096, 512, {"zmask_all": False}),
            ("leaves masked", 4096, 512, {"mask_all": False})]
# (name, T, L, Km, M, targets masked) of the per-target entry point: bench
# leaves, a tile smaller than the kernel's 16 rows, a ragged L, targets
# with every column masked, one column, and more columns than a block has
# threads
K1_SUB_CASES = [("per target, bench", 128, 32, 64, 512, False),
                ("per target, L=8", 16, 8, 8, 32, False),
                ("per target, ragged L=20", 12, 20, 16, 48, False),
                ("per target, targets masked", 128, 32, 64, 512, True),
                ("per target, Km=1", 9, 5, 1, 17, False),
                ("per target, Km=300", 3, 33, 300, 512, False)]


def kernel_phase():
    """Returns (shared-scan entry point's numbers at the bench shape, the
    per-target entry point's at T=128, L=32, Km=64, the shared-scan entry
    point's kernel-alone time and bound at the half beam, N=2048)."""
    import torch
    from pymht_tpu_torch.ops import gate_kernel as gk
    args, dt = K1_ARGS, torch.full((), 2.5, device="cuda")
    res, res_half, err_all = {}, {}, 0.0
    scalars = tuple(args.values())
    for i, (name, N, M, kw) in enumerate(K1_CASES):
        inp = k1_inputs(i, N, M, "cuda", **kw)
        err, g_r = check_against_twin(gk, name, inp, dt, args)
        if name in ("demo scene", "xcheck scene"):
            check(bool(g_r[:, 1:].any()), f"K1 {name}: nothing gated")
        err_all = max(err_all, err)
        if name == "half beam":
            res_half = dict(max_err=err, **k1_bound(N, M),
                            kernel_ms=kernel_alone_ms(gk, inp, dt, scalars,
                                                      n_sets=1))
        if name == "bench":
            res = dict(max_err=err,
                       gated_share=float(g_r[:, 1:].float().mean()),
                       **kernel_times(gk, inp, dt, args), **k1_bound(N, M))

    res_sub = {}
    for i, (name, T, L, Km, M, masked) in enumerate(K1_SUB_CASES):
        inp, sub = k1_sub_inputs(i, T, L, Km, M, "cuda", masked)
        n0 = gk.launches_pregate
        err, g_r = check_against_twin(gk, name, inp, dt, args, sub)
        check(gk.launches_pregate == n0 + 1,
              f"K1 {name}: the per-target entry point was not launched")
        check(bool(g_r[:, 1:].any()), f"K1 {name}: nothing gated")
        err_all = max(err_all, err)
        if name == "per target, bench":
            res_sub = dict(max_err=err,
                           gated_share=float(g_r[:, 1:].float().mean()),
                           **kernel_times(gk, inp, dt, args, sub),
                           **k1_sub_bound(T, L, Km, M))
    res["max_err_all"] = err_all
    return res, res_sub, res_half


# ----------------------------------------------------------------------
# guard phase: K1's reads and writes inside guard bands
# ----------------------------------------------------------------------

GUARD_BYTES = 4096    # band on each side of every buffer of a guarded launch
IN_FILL = 0xFF        # an input's bands: NaN as f32, -1 as i32
OUT_FILL = 0xA5       # an output's bands, and its interior before a launch
K1_GUARD_REPS = 8     # guarded launches at each shape


def banded(shape, dtype, fill, device):
    """(a tensor of ``shape`` GUARD_BYTES into a byte buffer filled with
    ``fill``, the buffer)."""
    import torch
    nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    buf = torch.full((nbytes + 2 * GUARD_BYTES,), fill, dtype=torch.uint8,
                     device=device)
    return buf[GUARD_BYTES:GUARD_BYTES + nbytes].view(dtype).view(shape), buf


def bands_intact(buf, fill):
    return bool((buf[:GUARD_BYTES] == fill).all()
                and (buf[-GUARD_BYTES:] == fill).all())


def as_bytes(t):
    import torch
    return t.contiguous().view(-1).view(torch.uint8)


def guard_check(gk, name, inp, dt, args, sub=None, reps=K1_GUARD_REPS):
    """K1's memory discipline at one shape, as far as the card shows it
    without a sanitizer.  Every input sits between bands of IN_FILL, every
    output between bands of OUT_FILL; ``reps`` launches, each into outputs
    refilled with OUT_FILL (``used`` zeroed).  Each launch's seven outputs
    must be bit for bit those of one unguarded wrapper call (a read outside
    an input brings in NaN or another neighbour; a race parts launches),
    every output element must be written, and every band must stay as it
    was (a write outside an output)."""
    import torch
    sub = sub or {}
    base = gk.radar_candidates(*inp, dt, **args, **sub)

    def guarded_copy(t):
        v, buf = banded(tuple(t.shape), t.dtype, IN_FILL, t.device)
        v.copy_(t)
        return v, buf

    g_inp = [guarded_copy(t) for t in (*inp, dt)]
    g_sub = {k: guarded_copy(v) for k, v in sub.items()
             if hasattr(v, "data_ptr")}
    outs = [banded(tuple(f.shape), f.dtype, OUT_FILL, f.device)
            for f in base]
    out = gk.RadarCandidates(*(v for v, _ in outs))
    kw = {k: (g_sub[k][0] if k in g_sub else v) for k, v in sub.items()}
    for r in range(reps):
        for _, buf in outs:
            buf.fill_(OUT_FILL)
        out.used_meas.zero_()
        gk.launch(out, *(v for v, _ in g_inp), *args.values(), **kw)
        torch.cuda.synchronize()
        for f, (v, buf), b in zip(base._fields, outs, base):
            bad = int((as_bytes(v) != as_bytes(b)).sum())
            check(bad == 0, f"K1 guard {name}, launch {r}: {bad} bytes of "
                            f"{f} differ from the unguarded call's")
            check(bands_intact(buf, OUT_FILL),
                  f"K1 guard {name}, launch {r}: written outside {f}")
        for what, (_, buf) in zip(("x", "P", "cnllr", "pd", "mask", "z",
                                   "zmask", "dt", *g_sub), (*g_inp,
                                                           *g_sub.values())):
            check(bands_intact(buf, IN_FILL),
                  f"K1 guard {name}, launch {r}: written around input {what}")
    return reps


def k1_guard_cases():
    """Every shape the guard phase takes, with its inputs made on demand:
    (name, a function giving (inputs, per-target arguments or {}))."""
    cases = []
    for i, (name, N, M, kw) in enumerate(K1_CASES):
        cases.append((name, lambda i=i, N=N, M=M, kw=kw: (
            k1_inputs(i, N, M, "cuda", **kw), {})))
    for i, (name, T, L, Km, M, masked) in enumerate(K1_SUB_CASES):
        cases.append((name, lambda i=i, c=(T, L, Km, M, masked):
                      k1_sub_inputs(i, *c[:4], "cuda", c[4])))
    # the swarm benchmark's per-target shape and the saturation points'
    # shared-scan shapes
    cases.append(("per target, swarm", lambda: k1_sub_inputs(
        31, 1024, 16, 64, 2048, "cuda")))
    for i, T in enumerate(SAT_POINTS):
        cases.append((f"saturation T={T}", lambda i=i, T=T: (
            k1_inputs(40 + i, 16 * T, 2 * T, "cuda"), {})))
    return cases


def guard_phase(card):
    """K1 inside guard bands (``guard_check``) at every shape of the kernel
    phase, at the swarm benchmark's and at the saturation points'."""
    import torch
    from pymht_tpu_torch.ops import gate_kernel as gk
    dt = torch.full((), 2.5, device="cuda")
    t0, n = time.perf_counter(), 0
    for name, make in k1_guard_cases():
        inp, sub = make()
        n += guard_check(gk, name, inp, dt, K1_ARGS, sub)
        del inp, sub
    torch.cuda.empty_cache()
    print(f"K1 guard: {n} launches at {len(k1_guard_cases())} shapes inside "
          f"{GUARD_BYTES}-byte guard bands, each bit for bit the unguarded "
          f"call's, every band intact ({time.perf_counter() - t0:.1f} s, "
          f"{card})", flush=True)


@contextlib.contextmanager
def noting_k1_launches(gk):
    """Inside the block, every K1 launch leaves its arguments in the list
    this yields, as (the seven leaf and measurement tensors, dt, the four
    scalars by name, the per-target arguments): what ``check_against_twin``
    takes.  The tensors are copies, since the tracker may reuse theirs."""
    noted, real = [], gk.launch
    names = ("q_scale", "r_var", "eta2", "lambda_ex")

    def keep(t):
        return t.clone() if hasattr(t, "clone") else t

    def noting(out, *a, **sub):
        noted.append(([keep(t) for t in a[:7]], keep(a[7]),
                      dict(zip(names, a[8:12])),
                      {k: keep(v) for k, v in sub.items() if v is not None}))
        return real(out, *a, **sub)

    gk.launch = noting
    try:
        yield noted
    finally:
        gk.launch = real


def check_noted_launches(gk, noted, what, shape, picks):
    """Hold K1 against its twin on the tensors of real scans: ``noted`` from
    ``noting_k1_launches``, every launch at ``shape`` (N, M), the launches
    ``picks`` compared.  Made after the run's launch count was read.
    Returns the largest |err|."""
    for inp, _, _, _ in noted:
        check((inp[0].shape[0], inp[5].shape[0]) == shape,
              f"{what}: K1 was launched at N={inp[0].shape[0]}, "
              f"M={inp[5].shape[0]}, not at {shape}")
    n0, err = gk.launches, 0.0
    for i in picks:
        inp, dt, args, sub = noted[i]
        e, g_r = check_against_twin(gk, f"{what}, scan {i}'s tensors", inp,
                                    dt, args, sub)
        check(bool(g_r[:, 1:].any()), f"{what}, scan {i}: nothing gated")
        err = max(err, e)
    check(gk.launches > n0, f"{what}: the comparison launched no kernel")
    return err


# ----------------------------------------------------------------------
# slice phase
# ----------------------------------------------------------------------

def run_tracker(device, shapes, params, scans, seeds, use_ais=False,
                groups=(), mmsi=None, method="lagrangian"):
    """Step ``scans`` (with ``groups[i]`` the AIS messages of scan i)
    through the port's Tracker on ``device``; ``seeds=None`` leaves every
    track to the initiator."""
    import torch
    from pymht_tpu_torch import Tracker
    tracker = Tracker(shapes, params, method=method, use_ais=use_ais,
                      device=device)
    if seeds is not None:
        tracker.pre_initialize(scans[0].time - params.radar_period, seeds,
                               mmsi=mmsi)
    outs, wall = [], []
    for i, s in enumerate(scans):
        t0 = time.perf_counter()
        outs.append(tracker.add_measurement_list(
            s.time, s.measurements,
            ais_messages=groups[i] if i < len(groups) else []))
        if device == "cuda":
            torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    return tracker, outs, wall


def check_run(outs, what):
    for i, out in enumerate(outs):
        check(bool(out.sel_feasible), f"{what} scan {i}: selection infeasible")
        for name, a in zip(out._fields, out):
            check(not (a.dtype.kind == "f" and np.isnan(a).any()),
                  f"{what} scan {i}: NaN in {name}")


def check_card_against_cpu(gpu, gpu_outs, cpu, cpu_outs, what,
                           other="the CPU run"):
    """Same track ids, same selected (measurement, MMSI) labels and the
    same confirmed archives per scan, states and objective within
    tolerance."""
    check(sorted(gpu.get_tracks()) == sorted(cpu.get_tracks())
          and sorted(gpu.terminated) == sorted(cpu.terminated),
          f"{what}: ends with other track ids than {other}")
    check(len(gpu_outs) == len(cpu_outs), f"{what}: scan counts differ")
    for i, (g, c) in enumerate(zip(gpu_outs, cpu_outs)):
        check(np.array_equal(g.track_mask, c.track_mask)
              and np.array_equal(g.track_id, c.track_id),
              f"{what} scan {i}: track slots or ids differ from {other}")
        live = g.track_mask
        check(np.array_equal(g.sel_hist_meas[live], c.sel_hist_meas[live])
              and np.array_equal(g.sel_hist_mmsi[live],
                                 c.sel_hist_mmsi[live]),
              f"{what} scan {i}: selected (measurement, MMSI) labels differ "
              f"from {other}")
        check(np.array_equal(g.confirmed_mask, c.confirmed_mask)
              and np.array_equal(g.confirmed_meas, c.confirmed_meas)
              and np.array_equal(g.confirmed_mmsi, c.confirmed_mmsi)
              and np.array_equal(g.dead, c.dead),
              f"{what} scan {i}: confirmed archives differ from {other}")
        check(np.allclose(g.track_x[live], c.track_x[live],
                          rtol=STATE_RTOL, atol=STATE_ATOL)
              and np.allclose(g.confirmed_x, c.confirmed_x,
                              rtol=STATE_RTOL, atol=STATE_ATOL),
              f"{what} scan {i}: track states differ from {other}")
        check(math.isclose(float(g.sel_obj), float(c.sel_obj),
                           rel_tol=OBJ_RTOL, abs_tol=1e-3),
              f"{what} scan {i}: selection objective differs from {other}")


def quality(tracker, sim_list, params, what, min_coverage, max_rms):
    from pymht_tpu_torch.utils import metrics
    m = metrics.evaluate(tracker, sim_list, params.radar_period,
                         p0=(0.0, 0.0), radar_range=params.radar_range)
    print(f"{what}: {len(tracker.scan_times)} scans, "
          f"{len(tracker.get_tracks())} tracks, coverage "
          f"{m['track_percent']:.5f} (floor {min_coverage}), rms "
          f"{m['rms']:.4f} m (ceiling {max_rms}), false tracks "
          f"{m['n_false_tracks']}")
    check(m["track_percent"] >= min_coverage and m["rms"] <= max_rms,
          f"{what}: track quality below the floor: {m}")
    return m


def slice_phase():
    from pymht_tpu_torch.ops import gate_kernel as gk
    from pymht_tpu_torch.utils.scenes import bench_scene
    shapes, params, scans, sim_list, seeds = bench_scene()

    gk.launches = gk.launches_pregate = 0
    gpu, gpu_outs, wall = run_tracker("cuda", shapes, params, scans, seeds)
    launches = gk.launches
    check(launches == len(scans) and gk.launches_pregate == 0,
          f"K1 launched {launches} times over {len(scans)} scans")
    check_run(gpu_outs, "slice")
    cpu, cpu_outs, _ = run_tracker("cpu", shapes, params, scans, seeds)
    check_card_against_cpu(gpu, gpu_outs, cpu, cpu_outs, "slice")
    m = quality(gpu, sim_list, params, "slice", MIN_COVERAGE, MAX_RMS)
    grown = grow_makes_no_host_sync(gpu, scans[-1], [])
    return dict(launches=launches,
                ms_per_scan=1e3 * float(np.median(wall[2:])),
                syncs=gpu.host_syncs, n_scans=len(scans), metrics=m,
                gpu=gpu, cpu=cpu, grown=grown)


def selected_labels(outs):
    """Per scan, the selected (track id, measurement, MMSI) triples of
    the current column."""
    rows = []
    for out in outs:
        live = out.track_mask
        rows.append(list(zip(out.track_id[live].tolist(),
                             out.sel_hist_meas[live, -1].tolist(),
                             out.sel_hist_mmsi[live, -1].tolist())))
    return rows


def grow_makes_no_host_sync(tracker, scan, messages):
    """One more grow on the tracker's final forest with the CUDA sync
    debug mode set to raise, followed by the similar-state merge and the
    on-device window trigger: grow (pre-gate, K1, the AIS chain, the
    beam), ``prune_similar`` and ``shrink_windows`` must not read a device
    value on the host.  Returns the grown forest."""
    import torch
    from pymht_tpu_torch.core.grow import grow
    from pymht_tpu_torch.core.merge import prune_similar
    from pymht_tpu_torch.core.tracker import shrink_windows
    packed = tracker._pack_inputs(float(scan.time) - tracker.t0
                                  + tracker.params.radar_period,
                                  scan.measurements, messages)
    sc, ais = tracker._unpack_inputs(packed)
    fresh = torch.zeros_like(tracker.state.tgt_mask)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        g = grow(tracker.state, sc, ais, tracker.shapes, tracker.params)
        st = prune_similar(g.state, tracker.shapes, tracker.params)
        st = shrink_windows(st, g.gated_counts, fresh, tracker.params)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(bool(st.leaf_mask.any()), "grow under sync debug: no leaf")
    check(bool((st.tgt_window <= tracker.params.N).all()),
          "window under sync debug: a window grew")
    return g.state


def ais_phase():
    from pymht_tpu_torch.ops import gate_kernel as gk
    from pymht_tpu_torch.utils.scenes import bench_scene_ais
    shapes, params, scans, groups, sim_list, seeds, mmsi = bench_scene_ais()
    kw = dict(use_ais=True, groups=groups, mmsi=mmsi)

    gk.launches = gk.launches_pregate = 0
    gpu, gpu_outs, wall = run_tracker("cuda", shapes, params, scans, seeds,
                                      **kw)
    launches = gk.launches
    check(launches == len(scans) and gk.launches_pregate == 0,
          f"AIS: K1 launched {launches} times over {len(scans)} scans")
    check_run(gpu_outs, "AIS")
    labels = selected_labels(gpu_outs)
    fused = sum(m > 0 and mm != 0 for row in labels for _, m, mm in row)
    pure = sum(m == 0 and mm != 0 for row in labels for _, m, mm in row)
    check(fused >= 1 and pure >= 1,
          f"AIS: {fused} fused and {pure} pure-AIS associations selected; "
          f"the phase needs at least one of each")
    grown = grow_makes_no_host_sync(gpu, scans[-1], groups[0])
    cpu, cpu_outs, _ = run_tracker("cpu", shapes, params, scans, seeds, **kw)
    check_card_against_cpu(gpu, gpu_outs, cpu, cpu_outs, "AIS")
    m = quality(gpu, sim_list, params, "AIS", MIN_COVERAGE_AIS, MAX_RMS_AIS)
    n_msgs = [min(len(g), shapes.max_ais) for g in gpu.ais_history]
    print(f"AIS: messages per scan {n_msgs}; selected associations: "
          f"{fused} fused, {pure} pure AIS; grow, prune_similar and the "
          f"on-device window read no device value on the host")

    # ---- the spatial pre-gate on the same scene ----------------------
    import dataclasses
    shapes_p = dataclasses.replace(shapes, radar_cand_width=PREGATE_KM)
    short = scans[:PREGATE_SCANS]
    gk.launches = gk.launches_pregate = 0
    gpu_p, gpu_p_outs, _ = run_tracker("cuda", shapes_p, params, short,
                                       seeds, **kw)
    launches_p = gk.launches_pregate
    check(launches_p == len(short) and gk.launches == len(short),
          f"pre-gate: K1's per-target entry point launched {launches_p} "
          f"times over {len(short)} scans ({gk.launches} launches in all)")
    check_run(gpu_p_outs, "pre-gate")
    cpu_p, cpu_p_outs, _ = run_tracker("cpu", shapes_p, params, short, seeds,
                                       **kw)
    check_card_against_cpu(gpu_p, gpu_p_outs, cpu_p, cpu_p_outs, "pre-gate")
    same = sum(a == b for a, b in zip(selected_labels(gpu_p_outs), labels))
    print(f"pre-gate (radar_cand_width={PREGATE_KM}, {len(short)} scans): "
          f"card run matches the CPU run; {same} of {len(short)} scans "
          f"select the labels of the un-pre-gated run (they agree when "
          f"every gated measurement is among a target's {PREGATE_KM} "
          f"nearest)")
    return dict(launches=launches, launches_pregate=launches_p,
                ms_per_scan=1e3 * float(np.median(wall[2:])),
                syncs=gpu.host_syncs, n_scans=len(scans),
                n_scans_pregate=len(short), metrics=m, fused=fused,
                pure=pure, pregate_scans_equal=same, gpu=gpu,
                gpu_outs=gpu_outs, grown=grown)


# ----------------------------------------------------------------------
# streaming, the dynamic window, degrade, the roof trigger
# ----------------------------------------------------------------------

def flatten(chunks):
    """The per-scan StepOutputs of a list of per-chunk stacked ones."""
    from pymht_tpu_torch.core.tracker import StepOutputs
    return [StepOutputs(*(f[j] for f in c))
            for c in chunks for j in range(len(c.track_mask))]


def new_tracker(device, shapes, params, scans, seeds, mmsi=None, **kw):
    from pymht_tpu_torch import Tracker
    tracker = Tracker(shapes, params, method="lagrangian", device=device,
                      **kw)
    tracker.pre_initialize(scans[0].time - params.radar_period, seeds,
                           mmsi=mmsi)
    return tracker


class CheckingClock:
    """A clock for ``Tracker._clock`` that checks the forest's invariants
    at every reading (``stream`` reads it once before and once after each
    chunk) and leaves the time the checks took out of what it reports."""

    def __init__(self, tracker):
        self.tracker, self.spent = tracker, 0.0

    def __call__(self):
        t0 = time.perf_counter()
        self.tracker.check_integrity()
        self.spent += time.perf_counter() - t0
        return time.perf_counter() - self.spent


def stream_all(tracker, scans, groups=None, **kw):
    """``scans`` through ONE ``stream`` call in chunks of STREAM_CHUNK.
    Returns (per-scan outputs, wall seconds per scan of each chunk, as
    ``stream`` logged them: its clock closes a chunk after the fetch of
    the chunk's outputs, which waits for the device)."""
    n0 = len(tracker.runtime_log)
    outs = flatten(tracker.stream(scans, groups, chunk=STREAM_CHUNK, **kw))
    log = tracker.runtime_log[n0:]
    check(len(log) == len(scans), "stream: the runtime log does not hold "
                                  "one entry per scan")
    return outs, [log[i0] for i0 in range(0, len(scans), STREAM_CHUNK)]


def stream_phase(ais):
    """``ais``: what ais_phase returned (its stepped card run is the
    reference)."""
    from pymht_tpu_torch.ops import gate_kernel as gk
    from pymht_tpu_torch.utils.scenes import bench_scene_ais
    shapes, params, scans, groups, _, seeds, mmsi = bench_scene_ais()
    groups = [groups[i] if i < len(groups) else []
              for i in range(len(scans))]
    kw = dict(mmsi=mmsi, use_ais=True, dynamic_window=False)

    # every transfer of the streamed run, noted beside sync's count
    from pymht_tpu_torch import sync
    from pymht_tpu_torch.core import tracker as tracker_mod
    moved = {"to_device": 0, "to_host": 0}
    real_up, real_fetch = tracker_mod._to_device, sync.fetch

    def noting_up(host, device):
        moved["to_device"] += 1
        return real_up(host, device)

    def noting_fetch(t):
        moved["to_host"] += 1
        return real_fetch(t)

    gpu = new_tracker("cuda", shapes, params, scans, seeds, **kw)
    gk.launches = gk.launches_pregate = 0
    tracker_mod._to_device, sync.fetch = noting_up, noting_fetch
    try:
        gpu_outs, per_scan = stream_all(gpu, scans, groups)
    finally:
        tracker_mod._to_device, sync.fetch = real_up, real_fetch
    launches = gk.launches
    n_chunks = -(-len(scans) // STREAM_CHUNK)
    check(moved == {"to_device": n_chunks, "to_host": n_chunks},
          f"stream: {moved} transfers over {n_chunks} chunks, not one each "
          f"way per chunk")
    check(launches == len(scans) and gk.launches_pregate == 0,
          f"stream: K1 launched {launches} times over {len(scans)} scans")
    check_run(gpu_outs, "stream")
    gpu.check_integrity()
    check_card_against_cpu(gpu, gpu_outs, ais["gpu"], ais["gpu_outs"],
                           "stream", other="the stepped card run")
    cpu = new_tracker("cpu", shapes, params, scans, seeds, **kw)
    cpu_outs, _ = stream_all(cpu, scans, groups)
    check_card_against_cpu(gpu, gpu_outs, cpu, cpu_outs, "stream",
                           other="the stream on the CPU")
    check([c[0] for c in gpu.chunk_syncs]
          == [len(scans[i:i + STREAM_CHUNK])
              for i in range(0, len(scans), STREAM_CHUNK)],
          "stream: chunk_syncs does not list the chunks")
    reads = sum(c[1] for c in gpu.chunk_syncs)
    return dict(launches=launches, n_scans=len(scans),
                ms_per_scan=1e3 * float(np.median(per_scan[1:])),
                ms_per_scan_first_chunk=1e3 * per_scan[0],
                syncs_per_scan=reads / len(scans), gpu=gpu,
                gpu_outs=gpu_outs, cpu=cpu, cpu_outs=cpu_outs)


def degrade_run(device, launch_sizes=None):
    """The radar-only scene streamed with the on-device window and
    prune_similar; the beam is halved by hand after DEGRADE_AFTER scans."""
    from pymht_tpu_torch.utils.scenes import bench_scene
    shapes, params, scans, sim_list, seeds = bench_scene()
    tr = new_tracker(device, shapes, params, scans, seeds, use_ais=False,
                     prune_similar=True)
    tr._clock = CheckingClock(tr)       # the invariants after every chunk
    outs, per_scan = stream_all(tr, scans[:DEGRADE_AFTER],
                                dynamic_window=True)
    shrunk = int(((tr.state.tgt_window < params.N) & tr.state.tgt_mask).sum())
    ids0, x0 = tr.get_track_states()
    check(tr.degrade(), "degrade: the beam did not shrink")
    ids1, x1 = tr.get_track_states()
    L = shapes.max_leaves // 2
    check(tr.shapes.max_leaves == L
          and tuple(tr.state.leaf_mask.shape) == (shapes.max_targets, L),
          "degrade: shapes and state do not follow the new beam")
    check(np.array_equal(ids0, ids1) and np.array_equal(x0, x1),
          "degrade: the selected estimate changed across the conversion")
    tr.check_integrity()
    outs2, per_scan2 = stream_all(tr, scans[DEGRADE_AFTER:],
                                  dynamic_window=True)
    shrunk2 = int(((tr.state.tgt_window < params.N) & tr.state.tgt_mask).sum())
    return dict(tracker=tr, outs=outs + outs2, sim_list=sim_list,
                params=params, n_scans=len(scans),
                ms_before=[round(1e3 * t, 2) for t in per_scan],
                ms_after=[round(1e3 * t, 2) for t in per_scan2],
                shrunk=(shrunk, shrunk2), L=(shapes.max_leaves, L),
                T=shapes.max_targets)


def degrade_phase():
    from pymht_tpu_torch.ops import gate_kernel as gk
    # the leaves of every K1 launch of the run, noted beside the count
    sizes, real_launch = [], gk.launch

    def noting_launch(out, x, *args, **kw):
        sizes.append(x.shape[0])
        return real_launch(out, x, *args, **kw)

    gk.launches = gk.launches_pregate = 0
    gk.launch = noting_launch
    try:
        gpu = degrade_run("cuda")
    finally:
        gk.launch = real_launch
    launches = gk.launches
    n, T, (L0, L1) = gpu["n_scans"], gpu["T"], gpu["L"]
    check(launches == n and sizes == [T * L0] * DEGRADE_AFTER
          + [T * L1] * (n - DEGRADE_AFTER),
          f"degrade: K1 launched {launches} times over {n} scans at "
          f"N = {sorted(set(sizes))}")
    check_run(gpu["outs"], "degrade")
    cpu = degrade_run("cpu")
    check_card_against_cpu(gpu["tracker"], gpu["outs"], cpu["tracker"],
                           cpu["outs"], "degrade")
    check(gpu["shrunk"] == cpu["shrunk"],
          "degrade: the card and the CPU shrank other windows")
    m = quality(gpu["tracker"], gpu["sim_list"], gpu["params"],
                "dynamic window and degrade", MIN_COVERAGE_DEGRADE,
                MAX_RMS_DEGRADE)
    return dict(launches=launches, launches_half_beam=sizes.count(T * L1),
                n_scans=n, metrics=m, shrunk=gpu["shrunk"],
                ms_before=gpu["ms_before"], ms_after=gpu["ms_after"])


def roof_phase():
    """``degrade_on_overload`` under a scripted clock: chunks 1 and 2 (of
    0..3) are reported as taking 90 % of the radar period per scan.  The
    first chunk of a call is never a load signal, so chunk 0 would not
    fire either way; chunk 1 fires; chunk 2 is the chunk after a degrade
    and is not checked."""
    from pymht_tpu_torch.ops import gate_kernel as gk
    from pymht_tpu_torch.utils.scenes import bench_scene
    shapes, params, scans, _, seeds = bench_scene()
    scans = scans[:ROOF_SCANS]
    long = 0.9 * params.radar_period * ROOF_CHUNK
    script = [long, long, long, 0.01]
    tr = new_tracker("cuda", shapes, params, scans, seeds, use_ais=False,
                     degrade_on_overload=True)
    reads = iter(t for k, sec in enumerate(script)
                 for t in (1e3 * k, 1e3 * k + sec))
    tr._clock = lambda: next(reads)
    fired, real_degrade = [], tr.degrade

    def noting_degrade(*a, **kw):
        fired.append(len(tr.scan_times))
        return real_degrade(*a, **kw)

    tr.degrade = noting_degrade
    gk.launches = gk.launches_pregate = 0
    outs = flatten(tr.stream(scans, chunk=ROOF_CHUNK))
    launches = gk.launches
    check(launches == len(scans), f"roof: K1 launched {launches} times")
    check(fired == [2 * ROOF_CHUNK],
          f"roof: degrade() fired after scans {fired}, not once after "
          f"scan {2 * ROOF_CHUNK}")
    check(tr.shapes.max_leaves == shapes.max_leaves // 2,
          "roof: the beam is not half the original")
    check(next(reads, None) is None, "roof: the clock was not read twice "
                                     "per chunk")
    check_run(outs, "roof")
    tr.check_integrity()
    print(f"roof: {len(scans)} scans in chunks of {ROOF_CHUNK}, the clock "
          f"scripted to {[round(s / ROOF_CHUNK, 3) for s in script]} s per "
          f"scan against a {params.radar_period} s period: degrade() fired "
          f"after scans {fired} (L {shapes.max_leaves} -> "
          f"{tr.shapes.max_leaves}); runtime log: {tr.runtime.summary()}")
    return dict(launches=launches, n_scans=len(scans))


# ----------------------------------------------------------------------
# the scatter formulations of select
# ----------------------------------------------------------------------

@contextlib.contextmanager
def forced_scatter(sel_mod):
    """Both size switches of select at 0: the scatter builds."""
    saved = sel_mod._USAGE_DENSE_LIMIT, sel_mod._INT32_WALL
    sel_mod._USAGE_DENSE_LIMIT = sel_mod._INT32_WALL = 0
    try:
        yield
    finally:
        sel_mod._USAGE_DENSE_LIMIT, sel_mod._INT32_WALL = saved


@contextlib.contextmanager
def forced_dense(sel_mod):
    """select's dense-compare limit above any shape: the dense builds of
    ``_hist_usage`` and ``_selection_feasible`` (at the swarm shape the
    former compares T*L*W*(M+A) = 0.94e9 elements, beyond the default
    limit)."""
    saved = sel_mod._USAGE_DENSE_LIMIT
    sel_mod._USAGE_DENSE_LIMIT = 1 << 62
    try:
        yield
    finally:
        sel_mod._USAGE_DENSE_LIMIT = saved


def swarm_forest(seed, device):
    """A seeded forest at swarm width: every target's leaves draw their
    labels from two measurements of its own, every 16th target also from
    its neighbour's (so ~1,800 of the 28,728 slots are contested, under
    select's cap of 2,048); ~70 % live leaves; an AIS label on 2 % of the
    nodes."""
    import torch
    from pymht_tpu_torch.core.config import TrackerParams, TrackerShapes
    from pymht_tpu_torch.core.state import empty_state
    shapes, params = TrackerShapes(**SWARM), TrackerParams()
    T, L, W = shapes.max_targets, shapes.max_leaves, shapes.window
    rng = np.random.default_rng(seed)
    own = 2 * np.arange(T)[:, None, None] + rng.integers(1, 3, (T, L, W))
    share = (np.arange(T) % 16 == 0)[:, None, None] \
        & (rng.random((T, L, W)) < 0.5)
    hist_meas = np.where(share, own + 2, own)
    hist_meas = np.where(rng.random((T, L, W)) < 0.2, 0, hist_meas)
    hist_ais = np.where(rng.random((T, L, W)) < 0.02,
                        rng.integers(1, shapes.max_ais + 1, (T, L, W)), 0)
    leaf_mask = rng.random((T, L)) < 0.7
    leaf_mask[:, 0] = True

    def dev(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).to(device)

    st = empty_state(shapes, params, device)
    return shapes, params, st.replace(
        hist_meas=dev(hist_meas, torch.int32),
        hist_ais=dev(hist_ais, torch.int32),
        leaf_mask=dev(leaf_mask, torch.bool),
        leaf_cnllr=dev(rng.normal(0, 2, (T, L)), torch.float32),
        tgt_mask=torch.ones(T, dtype=torch.bool, device=device),
        tgt_depth=torch.full((T,), W, dtype=torch.int32, device=device),
        tgt_id=torch.arange(T, dtype=torch.int32, device=device))


def wall_ms(fn, reps=7):
    """Median wall time of ``fn`` closed by a synchronize (these builds
    are a handful of device ops, some with host reads in between, so the
    host's clock is the one a caller feels)."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def build_times(sel_mod, state, shapes, params):
    """Wall ms of the dense and the scatter build of each function that
    has both, in the order dense, scatter, scatter, dense (the mean of
    each pair is kept)."""
    sel0 = sel_mod.leaf_scores(state, params).argmin(dim=1)
    usage = sel_mod._hist_usage(state, shapes)
    big = state.tgt_mask
    fns = {
        "_hist_usage": lambda dense: sel_mod._hist_usage(state, shapes),
        "_selection_feasible": lambda dense: sel_mod._selection_feasible(
            state, shapes, sel0),
        "cluster": lambda dense: sel_mod.cluster(state, shapes),
        # select_hybrid shares the dense usage tensor with cluster, so the
        # dense build is timed without it
        "select_hybrid's Uc": lambda dense: sel_mod._contested_leaf_usage(
            state, shapes, big, 256, usage if dense else None),
    }
    out = {}
    for name, fn in fns.items():
        ms = {True: [], False: []}
        for dense in (True, False, False, True):
            if dense:
                with forced_dense(sel_mod):
                    ms[dense].append(wall_ms(lambda: fn(True)))
            else:
                with forced_scatter(sel_mod):
                    ms[dense].append(wall_ms(lambda: fn(False)))
        out[name] = (float(np.mean(ms[True])), float(np.mean(ms[False])))
    return out


def scatter_phase(ais, card):
    """``ais``: what ais_phase returned; its last grown forest (after
    grow, before select) is the bench-shape input."""
    import torch
    from pymht_tpu_torch.core import select as sel_mod
    from pymht_tpu_torch.utils.scenes import bench_scene_ais
    shapes, params = bench_scene_ais()[:2]
    state = ais["grown"]
    for fast_path in (True, False):
        d = sel_mod.select(state, shapes, params, method="lagrangian",
                           fast_path=fast_path)
        with forced_scatter(sel_mod):
            s = sel_mod.select(state, shapes, params, method="lagrangian",
                               fast_path=fast_path)
        torch.cuda.synchronize()
        for name in ("sel", "labels", "n_clusters", "feasible"):
            check(torch.equal(getattr(d, name), getattr(s, name)),
                  f"scatter (fast_path={fast_path}): {name} differs between "
                  f"the builds")
        check(math.isclose(float(d.obj), float(s.obj), rel_tol=OBJ_RTOL,
                           abs_tol=1e-3),
              f"scatter (fast_path={fast_path}): objectives differ")
    n_clusters = int(d.n_clusters)
    conflict = not bool(sel_mod._independent_best(state, shapes, params)[2])
    print(f"scatter: select on the AIS scene's last grown forest "
          f"({n_clusters} clusters, independent optima "
          f"{'in conflict' if conflict else 'conflict-free'}): sel, labels, "
          f"n_clusters and feasibility identical between the dense and the "
          f"scatter builds, with and without the fast path")

    sw_shapes, sw_params, sw_state = swarm_forest(0, "cuda")
    T, L, W = sw_state.hist_meas.shape
    check(T * L * W * (sw_shapes.max_meas + sw_shapes.max_ais)
          > sel_mod._USAGE_DENSE_LIMIT,
          "scatter: the swarm shape does not cross the dense limit")
    with forced_dense(sel_mod):
        d = sel_mod._hist_usage(sw_state, sw_shapes)
    with forced_scatter(sel_mod):
        s = sel_mod._hist_usage(sw_state, sw_shapes)
    check(torch.equal(d, s) and bool(d.any()),
          "scatter: swarm usage differs between the builds")
    check(torch.equal(sel_mod._hist_usage(sw_state, sw_shapes), s),
          "scatter: swarm usage by the default build differs")
    del d, s
    res = {}
    for what, args in (("bench", (state, shapes, params)),
                       ("swarm", (sw_state, sw_shapes, sw_params))):
        res[what] = build_times(sel_mod, *args)
        T, L, W = args[0].hist_meas.shape
        print(f"select builds, {what} shape (T={T}, L={L}, W={W}, "
              f"M={args[1].max_meas}, A={args[1].max_ais}), wall ms dense / "
              f"scatter, {card}: "
              + "; ".join(f"{k} {v[0]:.3f} / {v[1]:.3f}"
                          for k, v in res[what].items()))
    return res


def smoother_phase(gpu, cpu, card):
    """``gpu``, ``cpu``: the slice phase's trackers after its 13 scans."""
    import torch
    res = {}
    for em_iters, em_mode in ((0, "scalar"), (5, "full")):
        kw = dict(em_iters=em_iters, em_mode=em_mode,
                  include_terminated=True)
        gpu.get_smooth_tracks(**kw)                    # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = gpu.get_smooth_tracks(**kw)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        want = cpu.get_smooth_tracks(**kw)
        check(sorted(got) == sorted(want), "smoother: track ids differ from "
                                           "the CPU run")
        n_ok, n_max = 0, 0
        for tid, (pos, vel, ok) in got.items():
            pos_c, vel_c, ok_c = want[tid]
            check(ok == ok_c and pos.shape == pos_c.shape,
                  f"smoother: track {tid} differs in length or status")
            if not ok:
                continue
            n_ok += 1
            n_max = max(n_max, len(pos))
            check(np.isfinite(pos).all() and np.isfinite(vel).all(),
                  f"smoother: track {tid} is not finite")
            check(np.allclose(pos, pos_c, rtol=SMOOTH_RTOL, atol=SMOOTH_ATOL),
                  f"smoother (em_iters={em_iters}): positions of track "
                  f"{tid} differ from the CPU run by "
                  f"{np.abs(pos - pos_c).max():.3g} m")
        check(n_ok >= 50, f"smoother: only {n_ok} tracks were smoothed")
        n_pad = 1 << (n_max - 1).bit_length()
        print(f"smoother (em_iters={em_iters}, em_mode={em_mode!r}): "
              f"{n_ok} tracks padded to {n_pad} steps in one call, "
              f"{ms:.2f} ms wall on the card ({card}); positions within "
              f"rtol {SMOOTH_RTOL} / atol {SMOOTH_ATOL} m of the CPU run")
        res[(em_iters, em_mode)] = ms
    return res


# ----------------------------------------------------------------------
# the other solvers, the oracles, checkpoint/resume, the XML export
# ----------------------------------------------------------------------

def device_ops(fn):
    """(wall ms, device operations) of one call of ``fn`` on the card:
    the kernels and copies a ``torch.profiler`` trace counts."""
    import torch
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return ms, sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)


def check_objectives(a_outs, b_outs, what, rtol):
    check(len(a_outs) == len(b_outs), f"{what}: scan counts differ")
    for i, (a, b) in enumerate(zip(a_outs, b_outs)):
        oa, ob = float(a.sel_obj), float(b.sel_obj)
        check(abs(oa - ob) <= rtol * (1.0 + abs(ob)),
              f"{what} scan {i}: objectives {oa} and {ob} differ beyond "
              f"{rtol} (1 + |obj|)")


def solver_ran(outs):
    """Scans on which the solver ran: the fast path returns bound == obj."""
    return [i for i, o in enumerate(outs)
            if float(o.sel_obj) != float(o.sel_bound)]


def ipm_phase(card):
    import torch
    from pymht_tpu_torch.core import select as sel_mod
    from pymht_tpu_torch.ops import gate_kernel as gk
    from pymht_tpu_torch.utils.scenes import demo_scene, xcheck_scene
    shapes, params, scans, groups, sim_list = demo_scene()
    kw = dict(use_ais=True, groups=groups, method="ipm")

    # the forests that reach the interior-point solver, noted as they
    # pass with the index of their scan
    solved, slow, real_ipm = [], [], sel_mod.select_ipm

    def noting_ipm(state, *a, **k):
        solved.append(state)
        slow.append(int(state.scan_idx) - 1)     # grow has counted it
        return real_ipm(state, *a, **k)

    gk.launches = gk.launches_pregate = 0
    sel_mod.select_ipm = noting_ipm
    try:
        with noting_k1_launches(gk) as noted:
            gpu, gpu_outs, wall = run_tracker("cuda", shapes, params, scans,
                                              None, **kw)
    finally:
        sel_mod.select_ipm = real_ipm
    launches = gk.launches
    check(gpu.method == "ipm", "ipm: the tracker runs another method")
    check(launches == len(scans) and gk.launches_pregate == 0,
          f"ipm: K1 launched {launches} times over {len(scans)} scans")
    check_run(gpu_outs, "ipm")
    check(len(solved) >= 1, "ipm: the interior-point solver never ran (no "
                            "scan left the fast path)")
    # K1 on the tensors it was really given: a conflicted scan and the last
    err_k1 = check_noted_launches(
        gk, noted, "ipm (demo scene)",
        (shapes.max_targets * shapes.max_leaves, shapes.max_meas),
        sorted({slow[-1], len(scans) - 1}))
    cpu, cpu_outs, _ = run_tracker("cpu", shapes, params, scans, None, **kw)
    check_objectives(gpu_outs, cpu_outs, "ipm (card against CPU)",
                     IPM_OBJ_RTOL)
    check(sorted(gpu.get_tracks()) == sorted(cpu.get_tracks())
          and sorted(gpu.terminated) == sorted(cpu.terminated),
          "ipm: ends with other track ids than the CPU run")
    same = sum(a == b for a, b in zip(selected_labels(gpu_outs),
                                      selected_labels(cpu_outs)))
    quality(gpu, sim_list, params, "ipm (demo scene)", MIN_COVERAGE_IPM,
            MAX_RMS_IPM)
    ms, ops = device_ops(lambda: real_ipm(solved[-1], shapes, params))
    fast = [i for i in range(2, len(scans)) if i not in slow]
    print(f"ipm (demo scene, T=32, L=32, M=64, A=8, W=7) on the card: the "
          f"solver ran on scans {slow}; {same} of {len(scans)} scans select "
          f"the CPU run's labels; wall ms/scan "
          f"{1e3 * float(np.median([wall[i] for i in slow])):.2f} on those, "
          f"{1e3 * float(np.median([wall[i] for i in fast])):.2f} on the "
          f"others; host reads per scan median "
          f"{np.median([gpu.host_syncs[i] for i in slow]):.0f} on those, "
          f"{np.median([gpu.host_syncs[i] for i in fast]):.0f} on the "
          f"others; one select_ipm on the last conflicted forest: "
          f"{ms:.1f} ms wall, {ops} device operations ({card})")

    # ---- 'ipm' beside 'lagrangian' on eval_configs.py's 2_ipm_xcheck ----
    shapes_x, params_x, scans_x, _ = xcheck_scene()
    scans_x = scans_x[:XCHECK_SCANS]
    gk.launches = gk.launches_pregate = 0
    runs = {}
    with noting_k1_launches(gk) as noted_x:
        for method in ("ipm", "lagrangian"):
            tr, outs, w = run_tracker("cuda", shapes_x, params_x, scans_x,
                                      None, method=method)
            check_run(outs, f"xcheck ({method})")
            runs[method] = (tr, outs, w)
    launches_x = gk.launches
    check(launches_x == 2 * len(scans_x),
          f"xcheck: K1 launched {launches_x} times over 2 x {len(scans_x)} "
          f"scans")
    check_objectives(runs["ipm"][1], runs["lagrangian"][1],
                     "xcheck ('ipm' against 'lagrangian')", GAP_LIMIT)
    check(sorted(runs["ipm"][0].get_tracks())
          == sorted(runs["lagrangian"][0].get_tracks()),
          "xcheck: 'ipm' and 'lagrangian' end with other track ids")
    err_k1 = max(err_k1, check_noted_launches(
        gk, noted_x, "xcheck",
        (shapes_x.max_targets * shapes_x.max_leaves, shapes_x.max_meas),
        [len(scans_x) - 1]))
    print(f"xcheck (2_ipm_xcheck, T=16, L=32, M=64, {len(scans_x)} scans) on "
          f"the card: 'ipm' and 'lagrangian' feasible on every scan, "
          f"objectives within {GAP_LIMIT} (1 + |obj|) of each other; the "
          f"solver ran on scans {solver_ran(runs['ipm'][1])} ('ipm') and "
          f"{solver_ran(runs['lagrangian'][1])} ('lagrangian'); wall ms/scan "
          f"{1e3 * float(np.median(runs['ipm'][2][2:])):.2f} and "
          f"{1e3 * float(np.median(runs['lagrangian'][2][2:])):.2f} ({card})")
    torch.cuda.synchronize()
    return dict(launches=launches, launches_xcheck=launches_x,
                n_scans=len(scans), n_scans_xcheck=2 * len(scans_x),
                k1_max_err=err_k1, gpu=gpu, forest=solved[-1], shapes=shapes, params=params)


def pure_phase(card):
    from pymht_tpu_torch.core import select as sel_mod
    from pymht_tpu_torch.ops import gate_kernel as gk
    from pymht_tpu_torch.utils.scenes import bench_scene
    shapes, params, scans, _, seeds = bench_scene()
    scans = scans[:PURE_SCANS]
    solved, real = [], sel_mod.select_lagrangian

    def noting(state, *a, **k):
        solved.append(state)
        return real(state, *a, **k)

    gk.launches = gk.launches_pregate = 0
    sel_mod.select_lagrangian = noting
    try:
        gpu, gpu_outs, wall = run_tracker("cuda", shapes, params, scans,
                                          seeds, method="lagrangian_pure")
    finally:
        sel_mod.select_lagrangian = real
    launches = gk.launches
    check(launches == len(scans) and gk.launches_pregate == 0,
          f"pure: K1 launched {launches} times over {len(scans)} scans")
    check_run(gpu_outs, "pure")
    check(len(solved) >= 1, "pure: the Lagrangian never ran")
    cpu, cpu_outs, _ = run_tracker("cpu", shapes, params, scans, seeds,
                                   method="lagrangian_pure")
    check_card_against_cpu(gpu, gpu_outs, cpu, cpu_outs, "pure")
    ms, ops = device_ops(lambda: real(solved[-1], shapes, params))
    print(f"pure ('lagrangian_pure', radar-only bench scene, {len(scans)} "
          f"scans) on the card: labels equal the CPU run's; the Lagrangian "
          f"ran on {len(solved)} scans; wall ms/scan "
          f"{1e3 * float(np.median(wall[2:])):.2f}, host reads per scan "
          f"median {np.median(gpu.host_syncs[2:]):.0f}; one "
          f"select_lagrangian on the last conflicted forest: {ms:.1f} ms "
          f"wall, {ops} device operations ({card})")
    return dict(launches=launches, n_scans=len(scans))


def gap_phase(res, ais, ipm):
    """The selections on the card against the exact oracles: ``res``,
    ``ais`` and ``ipm`` are what slice_phase, ais_phase and ipm_phase
    returned (their grown forests, before select)."""
    from pymht_tpu_torch import native
    from pymht_tpu_torch.core import select as sel_mod
    from pymht_tpu_torch.kernels import build
    from pymht_tpu_torch.utils import oracle
    from pymht_tpu_torch.utils.scenes import bench_scene, bench_scene_ais
    t0 = time.perf_counter()
    so = build.build("exact_solver")
    native.get_lib()
    print(f"build: exact_solver.cpp in {time.perf_counter() - t0:.2f} s "
          f"(0 if already built) -> {so.name}")
    gaps = {}
    for what, state, (shapes, params) in (
            ("radar-only bench forest", res["grown"], bench_scene()[:2]),
            ("AIS bench forest", ais["grown"], bench_scene_ais()[:2])):
        check(state.leaf_mask.device.type == "cuda",
              f"gap ({what}): the forest is not on the card")
        sel = sel_mod.select(state, shapes, params, method="lagrangian")
        check(bool(sel.feasible), f"gap ({what}): selection infeasible")
        conflict = not bool(sel_mod._independent_best(state, shapes,
                                                      params)[2])
        t0 = time.perf_counter()
        gap = oracle.selection_gap(state.replace(sel_leaf=sel.sel), shapes,
                                   params)
        sec = time.perf_counter() - t0
        check(gap is not None, f"gap ({what}): the HiGHS oracle did not "
                               f"prove optimality")
        check(-1e-6 <= gap <= GAP_LIMIT,
              f"gap ({what}): 'lagrangian' is {gap} from the optimum")
        gaps[what] = gap
        ms, ops = device_ops(lambda: sel_mod.select(
            state, shapes, params, method="lagrangian"))
        print(f"gap ({what}, independent optima "
              f"{'in conflict' if conflict else 'conflict-free'}): "
              f"'lagrangian' on the card is {gap:.3g} from the proven HiGHS "
              f"optimum (limit {GAP_LIMIT}; oracle {sec:.1f} s on the host); "
              f"that select: {ms:.1f} ms wall, {ops} device operations")

    state, shapes, params = ipm["forest"], ipm["shapes"], ipm["params"]
    sel = sel_mod.select(state, shapes, params, method="ipm")
    check(bool(sel.feasible), "gap (demo forest): 'ipm' infeasible")
    state = state.replace(sel_leaf=sel.sel)
    problem = oracle.host_problem(state, shapes, params)   # one transfer
    gap = oracle.selection_gap(state, shapes, params, problem=problem)
    check(gap is not None and -1e-6 <= gap <= GAP_LIMIT,
          f"gap (demo forest): 'ipm' is {gap} from the HiGHS optimum")
    _, obj_m, _ = oracle.milp_select_oracle(state, shapes, params,
                                            problem=problem)
    _, obj_n, proven = oracle.native_select_oracle(state, shapes, params,
                                                   problem=problem)
    check(proven, "gap (demo forest): the native branch-and-bound did not "
                  "prove optimality")
    check(abs(obj_m - obj_n) <= 1e-6 * (1.0 + abs(obj_m)),
          f"gap (demo forest): the oracles disagree: HiGHS {obj_m}, native "
          f"{obj_n}")
    gaps["demo forest ('ipm')"] = gap
    print(f"gap (demo scene's last conflicted forest): 'ipm' on the card is "
          f"{gap:.3g} from the optimum; HiGHS {obj_m:.6f} and the native "
          f"branch-and-bound {obj_n:.6f} agree, both proven")
    return gaps


def same_tracker_state(a, b, what):
    """Two trackers bit for bit: device state, initiator, archives."""
    import dataclasses
    import torch
    for ta, tb in ((a.state, b.state), (a.init_state, b.init_state)):
        for f in dataclasses.fields(ta):
            check(torch.equal(getattr(ta, f.name), getattr(tb, f.name)),
                  f"{what}: {f.name} differs")
    check(a.scan_times == b.scan_times, f"{what}: scan times differ")
    for da, db in ((a.archives, b.archives), (a.terminated, b.terminated)):
        check(sorted(da) == sorted(db), f"{what}: track ids differ")
        for tid, x in da.items():
            y = db[tid]
            check((x.times, x.meas, x.mmsi, x.status)
                  == (y.times, y.meas, y.mmsi, y.status)
                  and np.array_equal(np.asarray(x.states),
                                     np.asarray(y.states)),
                  f"{what}: the archive of track {tid} differs")


def checkpoint_phase(stream):
    """``stream``: what stream_phase returned (its card and CPU runs of
    the whole AIS scene are the references)."""
    import os
    import tempfile
    from pymht_tpu_torch.ops import gate_kernel as gk
    from pymht_tpu_torch.utils import checkpoint
    from pymht_tpu_torch.utils.scenes import bench_scene_ais
    shapes, params, scans, groups, _, seeds, mmsi = bench_scene_ais()
    groups = [groups[i] if i < len(groups) else []
              for i in range(len(scans))]
    cut = 2 * STREAM_CHUNK
    gk.launches = gk.launches_pregate = 0
    first = new_tracker("cuda", shapes, params, scans, seeds, mmsi=mmsi,
                        use_ais=True)
    outs, _ = stream_all(first, scans[:cut], groups[:cut])
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ckpt", "tracker")
        checkpoint.save(first, path)
        size = sum(os.path.getsize(path + ext) for ext in (".npz", ".json"))
        resumed = checkpoint.load(path)             # no device: the card
        on_cpu = checkpoint.load(path, device="cpu")
    check(resumed.device.type == "cuda" and on_cpu.device.type == "cpu"
          and resumed.method == "lagrangian",
          "checkpoint: load() did not restore the device or the method")
    same_tracker_state(first, resumed, "checkpoint (as loaded)")
    outs_a, _ = stream_all(first, scans[cut:], groups[cut:])
    outs_b, _ = stream_all(resumed, scans[cut:], groups[cut:])
    launches = gk.launches
    check(launches == len(scans) + len(scans) - cut,
          f"checkpoint: K1 launched {launches} times")
    same_tracker_state(first, resumed, "checkpoint (both finished)")
    for i, (a, b) in enumerate(zip(outs_a, outs_b)):
        check(all(np.array_equal(x, y) for x, y in zip(a, b)),
              f"checkpoint scan {cut + i}: outputs differ after the resume")
    check_card_against_cpu(first, outs + outs_a, stream["gpu"],
                           stream["gpu_outs"], "checkpoint",
                           other="the uninterrupted card stream")
    outs_c, _ = stream_all(on_cpu, scans[cut:], groups[cut:])
    check_card_against_cpu(on_cpu, outs_c, stream["cpu"],
                           stream["cpu_outs"][cut:], "checkpoint on the CPU",
                           other="the CPU stream")
    print(f"checkpoint: the AIS scene streamed in chunks of {STREAM_CHUNK}, "
          f"saved after {cut} scans ({size} bytes), loaded onto the card and "
          f"finished: state, initiator and archives bit for bit those of "
          f"the run that went on; loaded with device='cpu' it ends as the "
          f"CPU stream does")
    return dict(launches=launches, n_scans=len(scans) + len(scans) - cut)


def xml_phase(tracker):
    """``tracker``: the card tracker of the ipm phase after its run."""
    import os
    import tempfile
    import xml.etree.ElementTree as ET
    from pymht_tpu_torch.utils import xml_io
    scenario = ET.Element(xml_io.SCENARIO)
    xml_io.store_tracker_settings(scenario, tracker.shapes, tracker.params,
                                  method=tracker.method)
    xml_io.store_run(scenario, tracker, smooth=True, i=0)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "out", "run.xml")
        xml_io.write_element_to_file(path, scenario)
        size = os.path.getsize(path)
        run = ET.parse(path).getroot().find(xml_io.RUN)
    seqs = tracker._track_measurement_sequences(include_terminated=True)
    tracks = {int(t.attrib[xml_io.ID]): t for t in run.findall(xml_io.TRACK)}
    check(sorted(tracks) == sorted(seqs) and len(tracks) >= 6,
          f"xml: tracks {sorted(tracks)} exported, the tracker has "
          f"{sorted(seqs)}")
    n_smooth = 0
    for tid, (times, _, _, _) in seqs.items():
        t = tracks[tid]
        check(int(t.attrib[xml_io.LENGTH]) == len(times)
              and len(t.find(xml_io.STATES).findall(xml_io.STATE))
              == len(times), f"xml: track {tid} has another length")
        sm = t.find(xml_io.SMOOTHED_STATES)
        if sm is not None:
            n_smooth += 1
            check(len(sm.findall(xml_io.STATE)) == len(times),
                  f"xml: smoothed track {tid} has another length")
    total = run.find(xml_io.RUNTIME).find("Total")
    check(total is not None and float(total.attrib[xml_io.MEAN]) > 0,
          "xml: no runtime element")
    check(n_smooth >= 6, f"xml: only {n_smooth} tracks carry smoothed states")
    print(f"xml: store_run(smooth=True) of the demo run written ({size} "
          f"bytes) and parsed back: {len(tracks)} tracks with their lengths, "
          f"{n_smooth} with smoothed states, a runtime element")

# ----------------------------------------------------------------------
# scenario batches: the Monte-Carlo runner
# ----------------------------------------------------------------------

MC_BATCH = 256               # BASELINE config 4
MC_BENCH_BATCH = 32


def k1_batch_inputs(seed, B, TL, M, device):
    """K1's inputs as grow hands them over for a batch of B scenarios: TL
    leaves per scenario against that scenario's own M measurements (half
    of them where a leaf will be) at its own time step; one "target" per
    scenario.  Returns (the seven tensors, dt [B], the per-target
    arguments)."""
    import torch
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 100, (B, TL, 4)).astype(np.float32)
    P = (np.diag([6.25, 6.25, 1.875, 1.875])
         + rng.uniform(0, 1, (B, TL, 1, 1)) * np.eye(4)).astype(np.float32)
    cnllr = rng.normal(0, 1, (B, TL)).astype(np.float32)
    pd = np.full((B, TL), 0.9, np.float32)
    mask = rng.uniform(size=(B, TL)) < 0.9
    dt = rng.uniform(2.0, 3.0, B).astype(np.float32)
    z = rng.normal(0, 100, (B, M, 2)).astype(np.float32)
    k = min(M, TL) // 2
    z[:, :k] = (x[:, :k, :2] + dt[:, None, None] * x[:, :k, 2:]
                + rng.normal(0, 2.0, (B, k, 2)))
    zmask = rng.uniform(size=(B, M)) < 0.95

    def dev(a, shape):
        return torch.from_numpy(np.ascontiguousarray(a).reshape(shape)) \
            .to(device)

    inp = [dev(x, (-1, 4)), dev(P, (-1, 4, 4)), dev(cnllr, (-1,)),
           dev(pd, (-1,)), dev(mask, (-1,)), dev(z, (-1, 2)),
           dev(zmask, (-1,))]
    sub = dict(z_sub=dev(z, (B, M, 2)), zmask_sub=dev(zmask, (B, M)),
               zidx=dev(np.arange(B * M, dtype=np.int32), (B, M)),
               leaves_per_target=TL)
    return inp, dev(dt, (B,)), sub


def one_scenario(tree, b):
    """Scenario ``b`` of a batched state or initiator state."""
    import dataclasses
    return tree.replace(**{f.name: getattr(tree, f.name)[b]
                           for f in dataclasses.fields(tree)})


def check_batched_state(a, b, what):
    """Integer and boolean fields equal, floats within STATE_RTOL /
    STATE_ATOL (two states as numpy dicts)."""
    for name, x in a.items():
        y = b[name]
        if np.issubdtype(x.dtype, np.floating):
            check(np.allclose(x, y, rtol=STATE_RTOL, atol=STATE_ATOL),
                  f"{what}: {name} differs (max |err| "
                  f"{float(np.abs(x - y).max()):.3g})")
        else:
            check(np.array_equal(x, y), f"{what}: {name} differs")


def stepped_alone(sc, shapes, params, picks, state_b, xs, ms, what):
    """Scenarios ``picks`` of the batch stepped alone on the card through
    ``scan_step`` (the unbatched step, launches not counted), against
    the batched card run: track masks equal on every scan, states within
    tolerance, final states field by field."""
    import torch
    from pymht_tpu_torch.core.grow import Scan
    from pymht_tpu_torch.core.state import state_to_numpy
    from pymht_tpu_torch.core.tracker import scan_step
    from pymht_tpu_torch.parallel import montecarlo as mc
    st0, ist0 = mc.initial_states(sc, shapes, params)
    for b in picks:
        st, ist = one_scenario(st0, b), one_scenario(ist0, b)
        for s in range(sc.z.shape[1]):
            st, ist, out = scan_step(
                st, ist, Scan(sc.z[b, s], sc.z_mask[b, s], sc.times[s]),
                None, shapes, params, method="lagrangian", use_ais=False)
            check(torch.equal(out.track_mask, ms[s, b]),
                  f"{what}: scenario {b} alone, scan {s}: track masks "
                  f"differ from the batch's")
            check(torch.allclose(out.track_x, xs[s, b], rtol=STATE_RTOL,
                                 atol=STATE_ATOL),
                  f"{what}: scenario {b} alone, scan {s}: track states "
                  f"differ from the batch's")
        check_batched_state(state_to_numpy(st),
                            state_to_numpy(one_scenario(state_b, b)),
                            f"{what}: scenario {b} alone, final state")
    print(f"{what}: scenarios {list(picks)} stepped alone on the card = "
          f"the batch's on every scan")


def mc_quality(sc, xs, ms, what):
    """eval_configs.py's run_montecarlo numbers."""
    K = sc.truth.shape[2]
    msk, x = ms.cpu().numpy(), xs.cpu().numpy()
    truth = sc.truth.cpu().numpy()
    errs = [float(np.linalg.norm(x[-1, b, k, :2] - truth[b, -1, k, :2]))
            for b in range(msk.shape[1]) for k in range(K) if msk[-1, b, k]]
    out = {"tracks_alive": int(msk[-1, :, :K].sum()),
           "expected": msk.shape[1] * K,
           "median_err": round(float(np.median(errs)), 2) if errs else None}
    print(f"{what}: {json.dumps(out)}")
    return out


def batched_grow_makes_no_host_sync(state_b, scan_b, shapes, params):
    import torch
    from pymht_tpu_torch.core.grow import grow
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        g = grow(state_b, scan_b, None, shapes, params)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(bool(g.state.leaf_mask.any()), "batched grow under sync debug: "
          "no leaf")


def batched_phase(what, scene, batch, picks, on_cpu, km=0):
    """One batched configuration: the counted card run of ``run_batch``
    (K1's launches noted), a second card run timed, the checks, and K1
    against its twin and timed at the batched shape.  ``km``: the
    spatial pre-gate's radar_cand_width (K1 then has B * T targets of L
    leaves and Km columns)."""
    import dataclasses
    import torch
    from pymht_tpu_torch import sync
    from pymht_tpu_torch.core.state import state_to_numpy
    from pymht_tpu_torch.ops import gate_kernel as gk
    from pymht_tpu_torch.parallel import montecarlo as mc
    shapes, params, sc_cpu = scene(batch=batch)
    shapes = dataclasses.replace(shapes, radar_cand_width=km)
    sc = mc.McScenario(*(a.to("cuda") for a in sc_cpu))
    B, S = sc.z.shape[:2]
    T, L, M = shapes.max_targets, shapes.max_leaves, shapes.max_meas

    gk.launches = gk.launches_pregate = 0
    n_sync = sync.count
    with noting_k1_launches(gk) as noted:
        state_b, xs, ms = mc.run_batch(sc, shapes, params)
    launches, launches_p = gk.launches, gk.launches_pregate
    torch.cuda.synchronize()
    reads = sync.count - n_sync
    check(launches == S and launches_p == S,
          f"{what}: K1 launched {launches} times ({launches_p} through the "
          f"per-target entry point) over {S} batched scans")
    check(not xs.isnan().any() and bool(ms[-1].any()),
          f"{what}: NaN or no track")

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state_2, xs_2, ms_2 = mc.run_batch(sc, shapes, params)
    torch.cuda.synchronize()
    ms_per_scan = 1e3 * (time.perf_counter() - t0) / S
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    check(torch.equal(ms_2, ms), f"{what}: a second card run differs")

    batched_grow_makes_no_host_sync(mc.initial_states(sc, shapes, params)[0],
                                    mc.scan_batch(sc, 0), shapes, params)
    if on_cpu:
        st_c, xs_c, ms_c = mc.run_batch(sc_cpu, shapes, params)
        check(torch.equal(ms.cpu(), ms_c),
              f"{what}: track masks differ from the CPU run")
        check(torch.allclose(xs.cpu(), xs_c, rtol=STATE_RTOL,
                             atol=STATE_ATOL),
              f"{what}: track states differ from the CPU run")
        check_batched_state(state_to_numpy(state_b), state_to_numpy(st_c),
                            f"{what}: card against CPU, final states")
        print(f"{what}: card = CPU run (masks on all {S} scans, states "
              f"within tolerance)")
    stepped_alone(sc, shapes, params, picks, state_b, xs, ms, what)
    q = mc_quality(sc, xs, ms, what)

    err, times, bound = k1_at_batch_shape(gk, what, noted, B, T, L, M, km,
                                          (1, S - 1))
    print(f"{what}: B={B}, {S} batched scans, {ms_per_scan:.2f} ms per "
          f"batched scan ({1e3 * B / ms_per_scan:.1f} scenario-scans/s; "
          f"second run, wall clock), {reads / S:.2f} host reads per batched "
          f"scan, peak device memory {peak_gib:.3f} GiB; K1 launches "
          f"{launches}; K1 at N={B * T * L}, Km={km or M}: kernel alone "
          f"{1e3 * times['kernel_ms']:.3f} us hot, "
          f"{1e3 * times['kernel_flushed_ms']:.3f} us flushed, wrapper "
          f"{1e3 * times['ms']:.3f} us, twin {1e3 * times['plain_ms']:.3f} "
          f"us; bound {1e3 * bound['bound_ms']:.3f} us ({bound['bytes']} "
          f"bytes, by {bound['bound_by']}); max |err| {err:.3g} "
          f"({card_line()})")
    return dict(launches=launches, n_scans=S, ms_per_scan=ms_per_scan,
                reads_per_scan=reads / S, peak_gib=peak_gib, max_err=err,
                quality=q, **times, bound_ms=bound["bound_ms"],
                bound_bytes=bound["bytes"])


def mc_phase():
    from pymht_tpu_torch.utils.scenes import mc_scene
    return batched_phase("mc", mc_scene, MC_BATCH, (0, MC_BATCH - 1),
                         on_cpu=True)


def mc_bench_phase():
    from pymht_tpu_torch.utils.scenes import mc_bench_scene
    return batched_phase("mc-bench", mc_bench_scene, MC_BENCH_BATCH,
                         (0, MC_BENCH_BATCH - 1), on_cpu=False)


def k1_pregate_batch_inputs(seed, B, T, L, M, Km, device):
    """K1's inputs as grow hands them over for a pre-gated batch: B * T
    targets of L leaves (a target's leaves within metres of each other),
    each with the Km measurements of its own scenario's scan nearest its
    prediction (``zidx`` on the flat [B * M] axis) and its scenario's
    time step.  Returns (the seven tensors, dt [B * T], the per-target
    arguments)."""
    import torch
    rng = np.random.default_rng(seed)
    dt = rng.uniform(2.0, 3.0, B).astype(np.float32)
    xt = rng.normal(0, 300, (B, T, 1, 4))
    x = (xt + rng.normal(0, 2, (B, T, L, 4))).astype(np.float32)
    P = (np.diag([6.25, 6.25, 1.875, 1.875])
         + rng.uniform(0, 1, (B, T, L, 1, 1)) * np.eye(4)).astype(np.float32)
    cnllr = rng.normal(0, 1, (B, T, L)).astype(np.float32)
    pd = np.full((B, T, L), 0.9, np.float32)
    mask = rng.uniform(size=(B, T, L)) < 0.9
    pred = xt[:, :, 0, :2] + dt[:, None, None] * xt[:, :, 0, 2:]  # [B,T,2]
    z = rng.normal(0, 300, (B, M, 2)).astype(np.float32)
    k = min(M, T)
    z[:, :k] = pred[:, :k] + rng.normal(0, 2, (B, k, 2))
    zmask = rng.uniform(size=(B, M)) < 0.95
    d2 = ((z[:, None] - pred[:, :, None]) ** 2).sum(-1)           # [B,T,M]
    d2 = np.where(zmask[:, None], d2, np.inf)
    zidx = np.argsort(d2, axis=-1, kind="stable")[..., :Km]
    z_sub = np.take_along_axis(z[:, None], zidx[..., None], 2)
    zmask_sub = np.take_along_axis(np.broadcast_to(zmask[:, None],
                                                   (B, T, M)), zidx, 2)
    flat = (zidx + M * np.arange(B)[:, None, None]).astype(np.int32)

    def dev(a, shape):
        return torch.from_numpy(np.ascontiguousarray(a).reshape(shape)) \
            .to(device)

    inp = [dev(x, (-1, 4)), dev(P, (-1, 4, 4)), dev(cnllr, (-1,)),
           dev(pd, (-1,)), dev(mask, (-1,)), dev(z, (-1, 2)),
           dev(zmask, (-1,))]
    sub = dict(z_sub=dev(z_sub, (B * T, Km, 2)),
               zmask_sub=dev(zmask_sub, (B * T, Km)),
               zidx=dev(flat, (B * T, Km)), leaves_per_target=L)
    return inp, dev(np.repeat(dt, T), (B * T,)), sub


def k1_at_batch_shape(gk, what, noted, B, T, L, M, km, picks):
    """K1 held against its twin at a batch's shape, seeded and on the
    tensors of the batch's real scans ``picks`` (``noted``), then timed
    against its bound.  Without the pre-gate (``km`` 0) one "target" per
    scenario; with it B * T targets of Km columns.  Returns (max |err|,
    the times, the bound)."""
    args = dict(q_scale=1.0, r_var=6.25, eta2=5.99, lambda_ex=3e-5)
    if km:
        inp, dt, sub = k1_pregate_batch_inputs(17, B, T, L, M, km, "cuda")
        bound = k1_sub_bound(B * T, L, km, B * M, n_dt=B * T)
    else:
        inp, dt, sub = k1_batch_inputs(17, B, T * L, M, "cuda")
        bound = k1_sub_bound(B, T * L, M, B * M, n_dt=B)
    err, g_r = check_against_twin(gk, f"{what}, seeded", inp, dt, args, sub)
    check(bool(g_r[:, 1:].any()), f"K1 {what}: nothing gated")
    for inp_n, _, _, sub_n in noted:
        check(sub_n.get("leaves_per_target") == (L if km else T * L),
              f"{what}: K1 was not launched at the batch's per-target shape")
    err = max(err, check_noted_launches(gk, noted, what, (B * T * L, B * M),
                                        picks))
    return err, kernel_times(gk, inp, dt, args, sub), bound


def step_batch(bs, shapes, method, use_ais, scans, start=None, kept=None):
    """A ``BatchScene`` through ``make_batched_step`` over ``scans``, from
    its initial states or ``start`` (state, initiator state).  Returns
    (state, initiator state, per-scan outputs, host reads per scan); the
    dict ``kept`` maps a scan count to the (state, initiator state) after
    that many scans, filled in as they pass."""
    from pymht_tpu_torch import sync
    from pymht_tpu_torch.parallel.scenario import make_batched_step
    step = make_batched_step(shapes, bs.params, method=method,
                             use_ais=use_ais)
    st, ist = (bs.state, bs.init_state) if start is None else start
    outs, reads = [], []
    for i, s in enumerate(scans):
        n0 = sync.count
        st, ist, o = step(st, ist, *bs.scan(s))
        outs.append(o)
        reads.append(sync.count - n0)
        if kept is not None and i + 1 in kept:
            kept[i + 1] = (st, ist)
    return st, ist, outs, reads


def check_scenarios_alone(bs, shapes, method, use_ais, picks, scans, st_b,
                          outs_b, what, start=None):
    """Scenarios ``picks`` of a ``BatchScene`` stepped alone through
    ``scan_step`` (launches not counted) against the batch's outputs:
    labels, selected leaves, masks and ids equal, floats within
    STATE_RTOL / STATE_ATOL, objectives within OBJ_RTOL (1 + |obj|), the
    final states field by field.  Under 'ipm' the bound is not compared:
    in f32 the root LP stops a round earlier or later with batched
    products, and its value is then that round's iterate (ROADMAP,
    queue 3).  Returns the scenario-scans on which the solver ran."""
    import torch
    from pymht_tpu_torch.core.grow import AisBatch, Scan
    from pymht_tpu_torch.core.state import state_to_numpy
    from pymht_tpu_torch.core.tracker import scan_step
    n_solved = 0
    for b in picks:
        st, ist, sc, ai = bs.scenario(b)
        if start is not None:
            st, ist = one_scenario(start[0], b), one_scenario(start[1], b)
        for i, s in enumerate(scans):
            st, ist, o = scan_step(st, ist, Scan(*(f[s] for f in sc)),
                                   AisBatch(*(f[s] for f in ai)), shapes,
                                   bs.params, method=method,
                                   use_ais=use_ais)
            ob = type(o)(*(f[b] for f in outs_b[i]))
            n_solved += float(o.sel_obj) != float(o.sel_bound)
            for name in o._fields:
                x, y = getattr(o, name), getattr(ob, name)
                w = f"{what}: scenario {b} alone, scan {s}: {name}"
                if name == "sel_obj":
                    check(abs(float(x) - float(y))
                          <= OBJ_RTOL * (1.0 + abs(float(y))), w)
                elif name == "sel_bound":
                    check(method == "ipm" or abs(float(x) - float(y))
                          <= OBJ_RTOL * (1.0 + abs(float(y))), w)
                elif x.dtype.is_floating_point:
                    check(torch.allclose(x, y, rtol=STATE_RTOL,
                                         atol=STATE_ATOL), w)
                else:
                    check(torch.equal(x, y), w)
        check_batched_state(state_to_numpy(st),
                            state_to_numpy(one_scenario(st_b, b)),
                            f"{what}: scenario {b} alone, final state")
    print(f"{what}: scenarios {list(picks)} stepped alone on the card = "
          f"the batch's on every scan (labels, selected leaves, states, "
          f"objectives)")
    return n_solved


def scene_batch_phase(what, bs, method, picks, cpu_batch=None, km=0,
                      solver=None, kept=None):
    """A ``BatchScene`` with the AIS branch on: the counted card run
    (K1's launches noted; with ``solver``, the name of a select function
    whose calls are counted), a second card run timed, the checks
    (scenarios ``picks`` alone on the card; with ``cpu_batch`` = (B, S)
    the first B scenarios' first S scans against the CPU), and K1 at the
    batch's shape.  Returns the phase's numbers; ``kept`` as for
    ``step_batch``, from the counted run."""
    import dataclasses
    import torch
    from pymht_tpu_torch.core import select as sel_mod
    from pymht_tpu_torch.core.state import state_to_numpy
    from pymht_tpu_torch.ops import gate_kernel as gk
    shapes = dataclasses.replace(bs.shapes, radar_cand_width=km)
    B, S = bs.scans.z.shape[:2]
    T, L, M = shapes.max_targets, shapes.max_leaves, shapes.max_meas
    scans = range(S)

    calls, real = [], getattr(sel_mod, solver) if solver else None
    if solver:
        def noting(state, *a, **k):
            calls.append(1)
            return real(state, *a, **k)
        setattr(sel_mod, solver, noting)
    gk.launches = gk.launches_pregate = 0
    try:
        with noting_k1_launches(gk) as noted:
            st_b, ist_b, outs, reads = step_batch(bs, shapes, method, True,
                                                  scans, kept=kept)
    finally:
        if solver:
            setattr(sel_mod, solver, real)
    launches, launches_p = gk.launches, gk.launches_pregate
    torch.cuda.synchronize()
    check(launches == S and launches_p == S,
          f"{what}: K1 launched {launches} times ({launches_p} through the "
          f"per-target entry point) over {S} batched scans")
    check(not any(bool(o.track_x.isnan().any()) for o in outs)
          and bool(outs[-1].track_mask.any()), f"{what}: NaN or no track")
    check(all(bool(o.sel_feasible.all()) for o in outs),
          f"{what}: a scenario's selection is infeasible")
    check(not solver or len(calls) >= 1, f"{what}: {solver} never ran")

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st_2, _, outs_2, _ = step_batch(bs, shapes, method, True, scans)
    torch.cuda.synchronize()
    ms_per_scan = 1e3 * (time.perf_counter() - t0) / S
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(torch.equal(a.track_mask, b.track_mask)
              and torch.equal(a.sel_hist_meas, b.sel_hist_meas)
              for a, b in zip(outs, outs_2)),
          f"{what}: a second card run differs")

    n_solved = check_scenarios_alone(bs, shapes, method, True, picks, scans,
                                     st_b, outs, what)
    if cpu_batch:
        Bc, Sc = cpu_batch
        sub = bs._replace(
            state=one_scenario(bs.state, slice(0, Bc)),
            init_state=one_scenario(bs.init_state, slice(0, Bc)),
            scans=type(bs.scans)(*(f[:Bc] for f in bs.scans)),
            ais=type(bs.ais)(*(f[:Bc] for f in bs.ais)))
        st_g, _, o_g, _ = step_batch(sub, shapes, method, True, range(Sc))
        st_c, _, o_c, _ = step_batch(sub.to("cpu"), shapes, method, True,
                                     range(Sc))
        for s, (a, c) in enumerate(zip(o_g, o_c)):
            check(torch.equal(a.sel_hist_meas.cpu(), c.sel_hist_meas)
                  and torch.equal(a.sel_hist_mmsi.cpu(), c.sel_hist_mmsi)
                  and torch.equal(a.track_mask.cpu(), c.track_mask),
                  f"{what}: B={Bc} scan {s}: labels differ from the CPU run")
            check(torch.allclose(a.track_x.cpu(), c.track_x,
                                 rtol=STATE_RTOL, atol=STATE_ATOL),
                  f"{what}: B={Bc} scan {s}: states differ from the CPU run")
        check_batched_state(state_to_numpy(st_g), state_to_numpy(st_c),
                            f"{what}: B={Bc} card against CPU, final state")
        print(f"{what}: B={Bc}, {Sc} scans: card = CPU run (labels, masks, "
              f"states)")
    # a middle and the last scan: the demo scene's first scans have no
    # track yet, so no leaf to gate
    err, times, bound = k1_at_batch_shape(gk, what, noted, B, T, L, M, km,
                                          (S // 2, S - 1))
    n_sel = sum(int((o.sel_hist_mmsi[..., -1] > 0).sum()) for o in outs)
    print(f"{what}: B={B}, {S} batched scans, {ms_per_scan:.2f} ms per "
          f"batched scan ({1e3 * B / ms_per_scan:.1f} scenario-scans/s; "
          f"second run, wall clock), {np.mean(reads):.2f} host reads per "
          f"batched scan (median {np.median(reads):.0f}, max {max(reads)}), "
          f"peak device memory {peak_gib:.3f} GiB; {n_sel} selected AIS "
          f"labels; a solver ran on {n_solved} scenario-scans of those "
          f"stepped alone"
          + (f" ({len(calls)} batched calls of {solver})" if solver else "")
          + f"; K1 launches {launches}; K1 at N={B * T * L}, Km={km or M}: "
          f"kernel alone {1e3 * times['kernel_ms']:.3f} us hot, "
          f"{1e3 * times['kernel_flushed_ms']:.3f} us flushed, wrapper "
          f"{1e3 * times['ms']:.3f} us, twin {1e3 * times['plain_ms']:.3f} "
          f"us; bound {1e3 * bound['bound_ms']:.3f} us ({bound['bytes']} "
          f"bytes, by {bound['bound_by']}); max |err| {err:.3g} "
          f"({card_line()})")
    return dict(launches=launches, n_scans=S, ms_per_scan=ms_per_scan,
                reads_per_scan=float(np.mean(reads)), peak_gib=peak_gib,
                max_err=err, **times, bound_ms=bound["bound_ms"],
                bound_bytes=bound["bytes"])


MC_AIS_BATCH, MC_AIS_SCANS = 32, 12
MC_PREGATE_BATCH = 32
MC_IPM_BATCH = 8
MC_PURE_FROM, MC_PURE_SCANS = 12, 5


def mc_ais_phase():
    from pymht_tpu_torch.utils.scenes import bench_ais_batch
    bs = bench_ais_batch(MC_AIS_BATCH, n_scans=MC_AIS_SCANS - 1)
    return scene_batch_phase("mc-ais", bs, "lagrangian",
                             (0, MC_AIS_BATCH - 1), cpu_batch=(4, 4))


def mc_pregate_phase():
    from pymht_tpu_torch.utils.scenes import mc_bench_scene
    return batched_phase("mc-pregate", mc_bench_scene, MC_PREGATE_BATCH,
                         (0, MC_PREGATE_BATCH - 1), on_cpu=False,
                         km=PREGATE_KM)


def mc_ipm_phase():
    """B draws of the demo scene under 'ipm' with the AIS branch, every
    scenario held to itself stepped alone; then 'lagrangian_pure' on the
    same batch from the state after MC_PURE_FROM scans."""
    import torch
    from pymht_tpu_torch.core import select as sel_mod
    from pymht_tpu_torch.ops import gate_kernel as gk
    from pymht_tpu_torch.utils.scenes import demo_batch
    bs = demo_batch(MC_IPM_BATCH)
    kept = {MC_PURE_FROM: None}
    r = scene_batch_phase("mc-ipm", bs, "ipm", range(MC_IPM_BATCH),
                          solver="select_ipm", kept=kept)
    # 'lagrangian_pure' from the state after MC_PURE_FROM scans of 'ipm'
    start = kept[MC_PURE_FROM]
    scans = range(MC_PURE_FROM, MC_PURE_FROM + MC_PURE_SCANS)
    calls, real = [], sel_mod.select_lagrangian

    def noting(state, *a, **k):
        calls.append(1)
        return real(state, *a, **k)

    gk.launches = gk.launches_pregate = 0
    sel_mod.select_lagrangian = noting
    try:
        st_p, _, outs_p, reads_p = step_batch(bs, bs.shapes,
                                              "lagrangian_pure", True, scans,
                                              start)
    finally:
        sel_mod.select_lagrangian = real
    launches_p = gk.launches
    torch.cuda.synchronize()
    check(launches_p == MC_PURE_SCANS
          and gk.launches_pregate == MC_PURE_SCANS,
          f"mc-pure: K1 launched {launches_p} times over {MC_PURE_SCANS} "
          f"batched scans")
    check(len(calls) >= 1, "mc-pure: the Lagrangian never ran")
    check(all(bool(o.sel_feasible.all()) for o in outs_p),
          "mc-pure: a scenario's selection is infeasible")
    check_scenarios_alone(bs, bs.shapes, "lagrangian_pure", True,
                          range(MC_IPM_BATCH), scans, st_p, outs_p,
                          "mc-pure", start=start)
    print(f"mc-pure ('lagrangian_pure', the mc-ipm batch, scans "
          f"{scans.start}-{scans.stop - 1}): the Lagrangian ran in "
          f"{len(calls)} batched calls; host reads per batched scan "
          f"{reads_p}; K1 launches {launches_p}")
    r.update(launches_pure=launches_p, n_scans_pure=MC_PURE_SCANS)
    return r


# ----------------------------------------------------------------------
# sharded phases: the target-sharded step on torch.distributed
# ----------------------------------------------------------------------

SHARD_SCANS = 4            # swarm scans at one rank
SHARD2_SCANS = 3           # at two ranks sharing the card
SHARD_CKPT_AFTER = 2       # sharded-1 saved after this many scans
SHARD_TIMEOUT_S = 120      # bounds every rendezvous and collective
SWARM_N_TARGETS = 600
# sharded against unsharded (tests/test_sharded_swarm.py's contract: the
# sharded select has no exact tiers 1-2 and reduces in another order)
SWARM_MIN_AGREE = 0.995
SWARM_OBJ_RTOL = 1e-3
SWARM_STATE_ATOL = 1e-3
SHARD_OUTPUTS = ("track_mask", "track_id", "track_x", "sel_hist_meas",
                 "sel_obj", "sel_bound", "sel_feasible", "dead",
                 "confirmed_mask", "confirmed_x", "confirmed_meas")


def scene_inputs(scene, device, n_scans, use_ais):
    """(shapes, params, state, initiator state, [(Scan, AisBatch or None)]
    per scan, sim_list, Tracker) of a seeded scene, pre-initialised by the
    Tracker on ``device``, the scans padded by its make_stream_inputs."""
    from pymht_tpu_torch import Tracker
    from pymht_tpu_torch.core.grow import AisBatch, Scan
    if use_ais:
        shapes, params, scans, groups, sim_list, seeds, mmsi = scene()
    else:
        (shapes, params, scans, sim_list, seeds), groups, mmsi = \
            scene(), None, None
    scans = scans[:n_scans]
    tr = Tracker(shapes, params, method="lagrangian", use_ais=use_ais,
                 device=device)
    tr.pre_initialize(scans[0].time - params.radar_period, seeds, mmsi=mmsi)
    scan_b, ais_b = tr.make_stream_inputs(scans, groups)
    per = [(Scan(*(f[i] for f in scan_b)),
            AisBatch(*(f[i] for f in ais_b)) if use_ais else None)
           for i in range(len(scans))]
    return shapes, params, tr.state, tr.init_state, per, sim_list, tr


def swarm_inputs(device, n_scans=SHARD_SCANS):
    from pymht_tpu_torch.utils.scenes import swarm_shard_scene
    return scene_inputs(swarm_shard_scene, device, n_scans, True)


def sel_ais_of(st):
    """The AIS label of each target's selected leaf in the newest column
    (what tests/test_sharded_swarm.py compares)."""
    import torch
    return st.hist_ais[torch.arange(st.sel_leaf.shape[0],
                                    device=st.sel_leaf.device),
                       st.sel_leaf.long(), -1]


def run_sharded(axis, shapes, params, local, istate, inputs, use_ais,
                keep_after=None):
    """``inputs`` through ``make_sharded_tracker_step`` from this rank's
    share ``local`` of a forest.  Per scan: the step timed alone (wall clock,
    synchronised on a card), its host reads, collectives and their bytes;
    then the outputs gathered (numpy, the whole forest's layout, with
    ``sel_ais``) and the replicated state's digests held equal over the
    ranks.  Returns (local state, initiator state, per-scan outputs,
    stats, the gathered (state, initiator state) after ``keep_after``
    scans)."""
    import torch
    from pymht_tpu_torch import sync
    from pymht_tpu_torch.parallel.collectives import check_replicated
    from pymht_tpu_torch.parallel.sharded_tracker import (
        gather_outputs, gather_state, make_sharded_tracker_step)
    cuda = local.leaf_x.is_cuda
    step = make_sharded_tracker_step(axis, shapes, params, use_ais=use_ais)
    st, ist = local, istate
    outs, kept = [], None
    stats = dict(ms=[], reads=[], collectives=[], bytes=[])
    for k, (sc, ab) in enumerate(inputs):
        if cuda:
            torch.cuda.synchronize()
        r0, c0, b0 = sync.count, axis.count, axis.bytes
        t0 = time.perf_counter()
        st, ist, o = step(st, ist, sc, ab)
        if cuda:
            torch.cuda.synchronize()
        stats["ms"].append(1e3 * (time.perf_counter() - t0))
        stats["reads"].append(sync.count - r0)
        stats["collectives"].append(axis.count - c0)
        stats["bytes"].append(axis.bytes - b0)
        o = gather_outputs(o, axis)
        o["sel_ais"] = axis.all_gather(sel_ais_of(st))
        outs.append({key: v.cpu().numpy() for key, v in o.items()})
        check_replicated(axis, [st.lam, st.next_id, st.scan_idx, st.time,
                                *(getattr(ist, f.name) for f in
                                  dataclasses.fields(ist))],
                         f"sharded step, scan {k}")
        if keep_after == k + 1:
            kept = (gather_state(st, axis), ist)
    return st, ist, outs, stats, kept


def run_unsharded(shapes, params, state, istate, inputs, use_ais):
    """The same scans through the single-device ``scan_step``: the
    sharded run's outputs (numpy), the steps' wall ms and host reads."""
    import torch
    from pymht_tpu_torch import sync
    from pymht_tpu_torch.core.tracker import scan_step
    st, ist, outs, walls, reads = state, istate, [], [], []
    for sc, ab in inputs:
        torch.cuda.synchronize()
        r0, t0 = sync.count, time.perf_counter()
        st, ist, o = scan_step(st, ist, sc, ab, shapes, params,
                               method="lagrangian", use_ais=use_ais)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        reads.append(sync.count - r0)
        d = {f: getattr(o, f).cpu().numpy() for f in SHARD_OUTPUTS}
        d["sel_ais"] = sel_ais_of(st).cpu().numpy()
        outs.append(d)
    return outs, walls, reads


def check_shard_run(outs, what):
    for k, o in enumerate(outs):
        check(bool(o["sel_feasible"]), f"{what} scan {k}: infeasible")
        check(all(not np.isnan(v).any() for v in o.values()
                  if v.dtype.kind == "f"), f"{what} scan {k}: NaN")
        check(bool(o["track_mask"].any()), f"{what} scan {k}: no track")


def check_shard_same(a_outs, b_outs, what, other):
    """Two runs of the sharded step: the same tracks, labels, AIS labels,
    deaths and confirmed labels on every scan, states within STATE_RTOL /
    STATE_ATOL, objectives within OBJ_RTOL."""
    check(len(a_outs) == len(b_outs), f"{what}: scan counts differ")
    for k, (a, b) in enumerate(zip(a_outs, b_outs)):
        for f in ("track_mask", "track_id", "sel_ais", "dead",
                  "confirmed_mask", "sel_feasible"):
            check(np.array_equal(a[f], b[f]),
                  f"{what} scan {k}: {f} differs from {other}")
        live = a["track_mask"]
        check(np.array_equal(a["sel_hist_meas"][live],
                             b["sel_hist_meas"][live])
              and np.array_equal(a["confirmed_meas"][a["confirmed_mask"]],
                                 b["confirmed_meas"][b["confirmed_mask"]]),
              f"{what} scan {k}: labels differ from {other}")
        check(np.allclose(a["track_x"][live], b["track_x"][live],
                          rtol=STATE_RTOL, atol=STATE_ATOL),
              f"{what} scan {k}: states differ from {other}")
        check(math.isclose(float(a["sel_obj"]), float(b["sel_obj"]),
                           rel_tol=OBJ_RTOL, abs_tol=1e-3),
              f"{what} scan {k}: objective differs from {other}")


def check_swarm_contract(single, sharded, what):
    """tests/test_sharded_swarm.py's contract on the seeded targets'
    slots: feasible, objective within SWARM_OBJ_RTOL, at least
    SWARM_MIN_AGREE of the selected labels equal, and where they are
    the AIS labels equal and the states within SWARM_STATE_ATOL.
    Returns the agreeing share per scan."""
    n, shares = SWARM_N_TARGETS, []
    for k, (a, b) in enumerate(zip(single, sharded)):
        check(bool(b["sel_feasible"]), f"{what} scan {k}: infeasible")
        oa, ob = float(a["sel_obj"]), float(b["sel_obj"])
        check(abs(oa - ob) <= SWARM_OBJ_RTOL * (1 + abs(oa)),
              f"{what} scan {k}: objective {ob} against {oa}")
        same = (a["sel_hist_meas"][:n, -1] == b["sel_hist_meas"][:n, -1])
        shares.append(float(same.mean()))
        check(shares[-1] >= SWARM_MIN_AGREE,
              f"{what} scan {k}: only {shares[-1]:.4f} of the labels agree")
        check(np.array_equal(a["sel_ais"][:n][same], b["sel_ais"][:n][same]),
              f"{what} scan {k}: AIS labels differ")
        check(np.allclose(a["track_x"][:n][same], b["track_x"][:n][same],
                          rtol=0, atol=SWARM_STATE_ATOL),
              f"{what} scan {k}: states differ")
    return shares


def to_device(tree, device):
    """A state dataclass or a NamedTuple of tensors on ``device``,
    contiguous (K1 takes only contiguous leaves; a CPU op may leave other
    strides than its CUDA counterpart)."""
    if dataclasses.is_dataclass(tree):
        return tree.replace(**{f.name: getattr(tree, f.name).to(device)
                               .contiguous()
                               for f in dataclasses.fields(tree)})
    return type(tree)(*(f.to(device).contiguous() for f in tree))


def sharded_parts(axis, cpu_axis, shapes, params, st0, ist0, inputs):
    """The sharded step on the card (NCCL) and on the CPU (gloo) in
    lockstep from the same start: per scan the collectives on each and the
    objectives' difference.  At the first scan where the two part (tracks,
    labels or the number of collectives), grow and the distributed select
    run on each device from the CPU's state before that scan: whether the
    grown forests differ (the largest |difference| of the live leaves'
    scores), and whether the distributed select, given the SAME forest on
    both devices, selects the same leaves with the same objective, bound
    and collectives.  Returns what it found."""
    from pymht_tpu_torch.core.grow import grow
    from pymht_tpu_torch.parallel.distributed_select import (
        distributed_select_compact)
    from pymht_tpu_torch.parallel.sharded_tracker import (
        make_sharded_tracker_step, shard_state)
    step_g = make_sharded_tracker_step(axis, shapes, params)
    step_c = make_sharded_tracker_step(cpu_axis, shapes, params)
    sg, ig = shard_state(st0, axis), ist0
    sc, ic = to_device(sg, "cpu"), to_device(ig, "cpu")
    found = dict(first_part=None, first_label_part=None,
                 collectives_card=[], collectives_cpu=[], obj_diff=[])
    for k, (scan, _) in enumerate(inputs):
        pre = sc
        scan_c = to_device(scan, "cpu")
        n_g, n_c = axis.count, cpu_axis.count
        sg, ig, og = step_g(sg, ig, scan, None)
        sc, ic, oc = step_c(sc, ic, scan_c, None)
        n_g, n_c = axis.count - n_g, cpu_axis.count - n_c
        found["collectives_card"].append(n_g)
        found["collectives_cpu"].append(n_c)
        og = {key: v.cpu().numpy() for key, v in og.items()}
        oc = {key: v.numpy() for key, v in oc.items()}
        found["obj_diff"].append(float(og["sel_obj"]) - float(oc["sel_obj"]))
        live = oc["track_mask"]
        same_labels = (np.array_equal(og["track_mask"], live)
                       and np.array_equal(og["sel_hist_meas"][live],
                                          oc["sel_hist_meas"][live]))
        if not same_labels and found["first_label_part"] is None:
            found.update(first_label_part=k, labels_differ=int(
                (og["sel_hist_meas"][live, -1]
                 != oc["sel_hist_meas"][live, -1]).sum()))
        if (n_g == n_c and same_labels) or found["first_part"] is not None:
            continue
        found.update(first_part=k, obj_card=float(og["sel_obj"]),
                     obj_cpu=float(oc["sel_obj"]))
        # grow from the CPU's state before scan k, on both devices
        gc = grow(pre, scan_c, None, shapes, params).state
        gg = grow(to_device(pre, "cuda"), scan, None, shapes, params).state
        lm = gc.leaf_mask.numpy()
        found.update(
            grow_labels_equal=bool(
                np.array_equal(gg.leaf_mask.cpu().numpy(), lm)
                and np.array_equal(gg.hist_meas.cpu().numpy()[lm],
                                   gc.hist_meas.numpy()[lm])),
            grow_score_max_diff=float(np.abs(
                gg.leaf_cnllr.cpu().numpy()[lm]
                - gc.leaf_cnllr.numpy()[lm]).max()))
        # the distributed select on the same (CPU-grown) forest, then each
        # device on the forest it grew itself
        for what, forest_g in (("same_forest", to_device(gc, "cuda")),
                               ("own_forests", gg)):
            n_g, n_c = axis.count, cpu_axis.count
            rg = distributed_select_compact(forest_g, shapes, params, axis)
            n_g = axis.count - n_g
            rc = distributed_select_compact(gc, shapes, params, cpu_axis)
            found[what] = dict(
                sel_equal=bool(np.array_equal(rg[0].cpu().numpy(),
                                              rc[0].numpy())),
                obj_card=float(rg[1]), obj_cpu=float(rc[1]),
                lb_card=float(rg[2]), lb_cpu=float(rc[2]),
                collectives_card=n_g,
                collectives_cpu=cpu_axis.count - n_c)
    return found

def sharded_bench_scene(axis, cpu_axis, card):
    """bench.py's radar-only scene (13 scans) through the sharded step at
    one rank, its K1 launches counted, its track quality held to the
    radar-only floor through the scene's own Tracker's archive, its
    ms/scan beside the unsharded scan_step's on the same scans; then the
    same step on the CPU in lockstep (``sharded_parts``)."""
    from types import SimpleNamespace
    from pymht_tpu_torch.ops import gate_kernel as gk
    from pymht_tpu_torch.parallel.sharded_tracker import (gather_state,
                                                          shard_state)
    from pymht_tpu_torch.utils import metrics
    from pymht_tpu_torch.utils.scenes import bench_scene
    shapes, params, st0, ist0, inputs, sim_list, tr = scene_inputs(
        bench_scene, "cuda", None, False)
    gk.launches = gk.launches_pregate = 0
    st, _, outs, stats, _ = run_sharded(axis, shapes, params,
                                        shard_state(st0, axis), ist0,
                                        inputs, use_ais=False)
    launches = gk.launches
    check(launches == len(outs) and gk.launches_pregate == 0,
          f"sharded-1 bench scene: K1 launched {launches} times over "
          f"{len(outs)} scans")
    check_shard_run(outs, "sharded-1 bench scene")
    _, walls, reads = run_unsharded(shapes, params, st0, ist0, inputs,
                                    False)
    # the Tracker's own archive of the gathered outputs, as its step keeps it
    for (sc, _), o in zip(inputs, outs):
        tr.scan_times.append(float(sc.time))
        tr._absorb_outputs(SimpleNamespace(**o), n_scans=len(tr.scan_times))
    tr.state = gather_state(st, axis)
    m = metrics.evaluate(tr, sim_list, params.radar_period,
                         p0=(0.0, 0.0), radar_range=params.radar_range)
    print(f"sharded-1 bench scene (T=128, L=32, M=512, W=7, {len(outs)} "
          f"scans, one NCCL rank): coverage {m['track_percent']:.5f} "
          f"(floor {MIN_COVERAGE}), rms {m['rms']:.4f} m (ceiling "
          f"{MAX_RMS}), false tracks {m['n_false_tracks']}; "
          f"{np.median(stats['ms'][2:]):.2f} ms/scan sharded against "
          f"{np.median(walls[2:]):.2f} unsharded scan_step (medians of "
          f"scans 3-{len(outs)}, wall clock); K1 launches {launches}; per "
          f"scan: host reads {stats['reads']} sharded, {reads} unsharded; "
          f"collectives {stats['collectives']}, bytes {stats['bytes']} "
          f"({card})")
    check(m["track_percent"] >= MIN_COVERAGE and m["rms"] <= MAX_RMS,
          f"sharded-1 bench scene: track quality below the floor: {m}")
    parts = sharded_parts(axis, cpu_axis, shapes, params, st0, ist0, inputs)
    print(f"sharded-1 bench scene, card against CPU in lockstep: "
          f"{json.dumps(parts)}")
    if parts["first_part"] is not None:
        # where the two part, the select given the same forest must decide
        # the same on both devices: the part comes from the values carried
        # into that scan (PERF.md, section 6), not from its decisions
        same = parts["same_forest"]
        check(same["sel_equal"]
              and same["collectives_card"] == same["collectives_cpu"]
              and math.isclose(same["obj_card"], same["obj_cpu"],
                               rel_tol=OBJ_RTOL),
              f"sharded-1 bench scene: the distributed select parts on the "
              f"same forest: {same}")
    return dict(metrics=m, parts=parts,
                ms_per_scan=float(np.median(stats["ms"][2:])),
                unsharded_ms_per_scan=float(np.median(walls[2:])),
                n_scans=len(outs), launches=launches, reads=stats["reads"],
                unsharded_reads=reads, collectives=stats["collectives"],
                bytes=stats["bytes"])


def sharded1_phase(card, ckpt_path):
    """sharded-1: the swarm scene through make_sharded_tracker_step at one
    NCCL rank on the card, against the unsharded card step and against
    the same sharded step on the CPU (one gloo rank); K1 against its twin
    on real scans' tensors at N = 8192; the state after SHARD_CKPT_AFTER
    scans saved to ``ckpt_path`` for sharded-2; then the bench scene."""
    import torch
    import torch.distributed as dist
    from pymht_tpu_torch.ops import gate_kernel as gk
    from pymht_tpu_torch.parallel.collectives import Axis
    from pymht_tpu_torch.parallel.sharded_tracker import shard_state
    from pymht_tpu_torch.scripts._common import free_port, init_rank
    from pymht_tpu_torch.utils import checkpoint
    torch.cuda.set_device(0)
    init_rank("nccl", 0, 1, free_port(), timeout=SHARD_TIMEOUT_S)
    try:
        axis = Axis()
        check(dist.get_backend() == "nccl" and axis.size == 1,
              "sharded-1: not one NCCL rank")
        cpu_axis = Axis(dist.new_group([0], backend="gloo"))
        shapes, params, st0, ist0, inputs, _, _ = swarm_inputs("cuda")
        N = shapes.max_targets * shapes.max_leaves
        gk.launches = gk.launches_pregate = 0
        with noting_k1_launches(gk) as noted:
            st, ist, outs, stats, kept = run_sharded(
                axis, shapes, params, shard_state(st0, axis), ist0, inputs,
                use_ais=True, keep_after=SHARD_CKPT_AFTER)
        launches = gk.launches
        check(launches == SHARD_SCANS and gk.launches_pregate == 0,
              f"sharded-1: K1 launched {launches} times over {SHARD_SCANS} "
              f"scans")
        check_shard_run(outs, "sharded-1")
        checkpoint.save_state(ckpt_path, *kept)

        single, walls, reads = run_unsharded(shapes, params, st0, ist0,
                                             inputs, True)
        shares = check_swarm_contract(single, outs,
                                      "sharded-1 against scan_step")
        sh_c, pa_c, st_c, ist_c, in_c, _, _ = swarm_inputs("cpu")
        _, _, outs_c, _, _ = run_sharded(cpu_axis, sh_c, pa_c,
                                         shard_state(st_c, cpu_axis), ist_c,
                                         in_c, use_ais=True)
        check_shard_same(outs, outs_c, "sharded-1", "the CPU run")
        err = check_noted_launches(gk, noted, "sharded-1", (N, 512),
                                   (0, SHARD_SCANS - 1))
        args = dict(q_scale=1.0, r_var=6.25, eta2=5.99, lambda_ex=3e-5)
        inp = k1_inputs(23, N, 512, "cuda")
        dt = torch.full((), 2.5, device="cuda")
        e, _ = check_against_twin(gk, f"N={N} seeded", inp, dt, args)
        times = kernel_times(gk, inp, dt, args)
        bound = k1_bound(N, 512)
        fused = sum(int((o["sel_ais"] > 0).sum()) for o in outs)
        print(f"sharded-1 (swarm scene T=1024, {SWARM_N_TARGETS} targets, "
              f"L=8, M=512, A=32, G=2, {SHARD_SCANS} scans, one NCCL rank): "
              f"{np.median(stats['ms'][1:]):.2f} ms/scan (median of scans "
              f"2-{SHARD_SCANS}, wall clock) against "
              f"{np.median(walls[1:]):.2f} for the unsharded scan_step; host "
              f"reads per scan {stats['reads']} ({reads} unsharded), "
              f"collectives per scan "
              f"{stats['collectives']}, bytes per scan {stats['bytes']}; K1 "
              f"launches {launches} at N={N}, M=512; labels agreeing with "
              f"scan_step {shares}; = the CPU run (gloo); {fused} selected "
              f"AIS labels ({card})")
        print(f"K1 at N={N}, M=512 (one rank's grow at T=1024, L=8), device "
              f"time: kernel alone {1e3 * times['kernel_ms']:.3f} us hot, "
              f"{1e3 * times['kernel_flushed_ms']:.3f} us flushed, wrapper "
              f"{1e3 * times['ms']:.3f} us, twin "
              f"{1e3 * times['plain_ms']:.3f} us; bound "
              f"{1e3 * bound['bound_ms']:.3f} us ({bound['bytes']} bytes, by "
              f"{bound['bound_by']}); max |err| {max(err, e):.3g} ({card})")
        bench = sharded_bench_scene(axis, cpu_axis, card)
    finally:
        dist.destroy_process_group()
    return dict(launches=launches + bench["launches"],
                launches_swarm=launches, n_scans=SHARD_SCANS
                + bench["n_scans"], outs=outs, max_err=max(err, e),
                ms_per_scan=float(np.median(stats["ms"][1:])),
                unsharded_ms_per_scan=float(np.median(walls[1:])),
                reads=stats["reads"], unsharded_reads=reads,
                collectives=stats["collectives"], bytes=stats["bytes"],
                agree=shares, bench=bench,
                k1_ms=times["ms"], k1_kernel_ms=times["kernel_ms"],
                k1_plain_ms=times["plain_ms"], k1_bound_ms=bound["bound_ms"],
                k1_bound_by=bound["bound_by"])


def shard2_rank(rank, port, workdir, ckpt_path):
    """One of sharded-2's two ranks on the one card (gloo on CUDA
    tensors); writes its results to ``workdir``."""
    import torch
    import torch.distributed as dist
    from pymht_tpu_torch.kernels import build
    from pymht_tpu_torch.ops import gate_kernel as gk
    from pymht_tpu_torch.parallel import multihost
    from pymht_tpu_torch.parallel.collectives import Axis
    from pymht_tpu_torch.parallel.sharded_tracker import shard_state
    from pymht_tpu_torch.utils import checkpoint
    torch.backends.cuda.matmul.allow_tf32 = False
    check(multihost.initialize(f"127.0.0.1:{port}", 2, rank,
                               backend="gloo", timeout=SHARD_TIMEOUT_S),
          "sharded-2: initialize")
    check(torch.cuda.current_device() == rank % torch.cuda.device_count(),
          "sharded-2: the rank's device")
    build.build("gate_score")          # built by the parent: loads it
    axis = Axis()
    res = {}
    shapes, params, st0, ist0, inputs, _, _ = swarm_inputs(
        "cuda", SHARD2_SCANS)
    N = shapes.max_targets // 2 * shapes.max_leaves
    gk.launches = gk.launches_pregate = 0
    with noting_k1_launches(gk) as noted:
        _, _, outs, stats, _ = run_sharded(axis, shapes, params,
                                           shard_state(st0, axis), ist0,
                                           inputs, use_ais=True)
    res["launches"] = gk.launches
    check(res["launches"] == SHARD2_SCANS,
          f"sharded-2 rank {rank}: K1 launched {res['launches']} times")
    res["max_err"] = check_noted_launches(
        gk, noted, f"sharded-2 rank {rank}", (N, 512),
        range(SHARD2_SCANS))
    res.update(stats)

    # sharded-1's checkpoint, restored by rows, and its next scan
    st, ist = checkpoint.load_state(ckpt_path, shard=axis)
    _, _, resumed, _, _ = run_sharded(
        axis, shapes, params, st, ist,
        inputs[SHARD_CKPT_AFTER:SHARD_CKPT_AFTER + 1], use_ais=True)

    # the measurement exchange
    z_local = np.stack([np.full(4, 100.0 * rank, np.float32),
                        np.arange(4, dtype=np.float32)], axis=1)
    z, m = multihost.gather_local_measurements(
        z_local, np.array([True, True, True, False]), 8)
    want = {(100.0 * r, float(v)) for r in range(2) for v in range(3)}
    check(int(m.sum()) == 6 and {tuple(r) for r in z[m]} == want,
          "sharded-2: gather_local_measurements")

    # dryrun(2) on both meshes against make_batched_step
    for mesh in ((1, 2), (2, 1)):
        dry_err = dryrun_against_batched(*mesh)
        res[f"dryrun_{mesh[0]}x{mesh[1]}_err"] = dry_err
    if rank == 0:
        np.savez(f"{workdir}/outs.npz",
                 **{f"scan{k}.{key}": v for k, o in enumerate(outs)
                    for key, v in o.items()},
                 **{f"resumed.{key}": v for key, v in resumed[0].items()})
    with open(f"{workdir}/rank{rank}.json", "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
    check("jax" not in sys.modules and not [
        m for m in sys.modules if m.split(".")[0] == "pymht_tpu"],
        f"sharded-2 rank {rank} imported jax or the JAX package")


def dryrun_against_batched(scen, clus):
    """``dryrun(2)`` on a (scen, clus) mesh against make_batched_step on
    its inputs: this rank's blocks within 1e-5.  Returns the max |err|."""
    import torch
    from pymht_tpu_torch.parallel import multihost, scenario as sc_mod
    st, ist, out = sc_mod.dryrun(2, scen, clus)
    inp = sc_mod.dryrun_inputs(sc_mod.DRYRUN_SHAPES, sc_mod.DRYRUN_PARAMS,
                               scen, "cuda")
    ref = sc_mod.make_batched_step(sc_mod.DRYRUN_SHAPES,
                                   sc_mod.DRYRUN_PARAMS)(*inp)
    mesh = multihost.hybrid_mesh(scen, clus)
    _, shard = sc_mod.make_sharded_step(mesh, sc_mod.DRYRUN_SHAPES,
                                        sc_mod.DRYRUN_PARAMS)
    r_st, r_ist, _, _ = shard(ref[0], ref[1], inp[2])
    err = 0.0
    for a, b in ((st, r_st), (ist, r_ist)):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            check(x.shape == y.shape and torch.allclose(
                x.float(), y.float(), rtol=1e-5, atol=1e-5),
                f"dryrun(2) on {scen}x{clus}: {f.name} differs from "
                f"make_batched_step")
            if x.numel():
                err = max(err, float((x.float() - y.float()).abs().max()))
    check(bool(out.sel_feasible.all()), f"dryrun(2) on {scen}x{clus}")
    return err


def sharded2_phase(s1, ckpt_path, card):
    """sharded-2: two ranks on the one card over gloo, spawned; their
    gathered outputs against sharded-1's, the checkpoint resumed by rows,
    the measurement exchange and dryrun(2) on both meshes."""
    import tempfile
    import torch.multiprocessing as mp
    from pymht_tpu_torch.scripts._common import free_port
    with tempfile.TemporaryDirectory() as d:
        ctx = mp.start_processes(shard2_rank, args=(free_port(), d,
                                                    ckpt_path),
                                 nprocs=2, join=False, start_method="spawn")
        deadline = time.perf_counter() + 6 * SHARD_TIMEOUT_S
        try:
            while not ctx.join(timeout=5):
                check(time.perf_counter() < deadline,
                      "sharded-2: the ranks did not finish in time")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        ranks = [json.load(open(f"{d}/rank{r}.json")) for r in range(2)]
        data = np.load(f"{d}/outs.npz")
        outs = [{key: data[f"scan{k}.{key}"] for key in s1["outs"][0]}
                for k in range(SHARD2_SCANS)]
        resumed = {key: data[f"resumed.{key}"] for key in s1["outs"][0]}
    check_shard_same(outs, s1["outs"][:SHARD2_SCANS], "sharded-2",
                     "sharded-1")
    check_shard_same([resumed], [s1["outs"][SHARD_CKPT_AFTER]],
                     "sharded-2 resumed from sharded-1's checkpoint",
                     "sharded-1's next scan")
    r0 = ranks[0]
    print(f"sharded-2 (the swarm scene, two ranks of 512 targets sharing "
          f"the card over gloo, {SHARD2_SCANS} scans): gathered outputs = "
          f"sharded-1's; replicated-state digests equal after every scan; "
          f"sharded-1's checkpoint after {SHARD_CKPT_AFTER} scans restored "
          f"by rows and stepped = sharded-1's scan {SHARD_CKPT_AFTER + 1}; "
          f"rank 0: {np.median(r0['ms'][1:]):.2f} ms/scan (two processes "
          f"sharing one GPU, host transport: no multi-card speed), host "
          f"reads {r0['reads']}, collectives {r0['collectives']}, bytes "
          f"{r0['bytes']} per scan; K1 launches per rank "
          f"{[r['launches'] for r in ranks]} at N=4096, M=512, max |err| "
          f"{max(r['max_err'] for r in ranks):.3g}; dryrun(2) on 1x2 and "
          f"2x1 = make_batched_step (max |err| "
          f"{max(r[k] for r in ranks for k in r if k.startswith('dryrun')):.3g}"
          f"); gather_local_measurements over the two ranks ({card})")
    return dict(launches=sum(r["launches"] for r in ranks),
                launches_per_rank=[r["launches"] for r in ranks],
                n_scans=SHARD2_SCANS,
                max_err=max(r["max_err"] for r in ranks),
                ms_per_scan=float(np.median(r0["ms"][1:])),
                reads=r0["reads"], collectives=r0["collectives"],
                bytes=r0["bytes"])


# ----------------------------------------------------------------------
# swarm phase (BASELINE config 5 at the JAX script's width)
# ----------------------------------------------------------------------

# The swarm benchmark's scene (utils/scenes.swarm_scene at its defaults:
# 1000 targets in T=1024 slots, L=16, M=2048, A=128, W=6, G=2, the
# pre-gate at Km=64, 8 scans).  The JAX package (CPU, scan_many with
# method='lagrangian' and AIS: tests/jax_swarm_reference.py) scores a
# one-to-one coverage of 0.992875 and an rms of 3.9560 m on it (999
# tracks alive at the last scan); the floors sit a little below.
SWARM_SCANS = 8
SWARM_CPU_SCANS = 3          # scans held to the port's CPU run
MIN_COVERAGE_SWARM = 0.992
MAX_RMS_SWARM = 4.0
SWARM_ORACLE_LIMIT = 60.0    # seconds of HiGHS on the swarm forest


def swarm_phase(card):
    """bench_swarm's ``run`` on the card at its defaults: K1's per-target
    entry point once per scan at N = 16,384, Km = 64 (and held against
    its twin on one scan's tensors and on seeded ones, timed against its
    bound); the first SWARM_CPU_SCANS scans' tracks and labels (radar and
    MMSI) against the port's CPU run; coverage and rms above their
    floors; the oracle gap under SWARM_ORACLE_LIMIT."""
    import torch
    from pymht_tpu_torch.core.tracker import outputs_to_host
    from pymht_tpu_torch.ops import gate_kernel as gk
    from pymht_tpu_torch.scripts import bench_swarm
    from pymht_tpu_torch.utils import scenes
    scene = scenes.swarm_scene(n_scans=SWARM_SCANS)
    shapes = scene.shapes
    T, L, Km, M = (shapes.max_targets, shapes.max_leaves,
                   shapes.radar_cand_width, shapes.max_meas)
    knobs = dict(bench_swarm.DEFAULTS, n_scans=SWARM_SCANS,
                 oracle_limit=SWARM_ORACLE_LIMIT)
    gk.launches = gk.launches_pregate = 0
    t0 = time.perf_counter()
    with noting_k1_launches(gk) as noted:
        res, outs = bench_swarm.run(torch.device("cuda"), knobs, scene)
    launches, launches_sub = gk.launches, gk.launches_pregate
    wall_s = time.perf_counter() - t0
    # a warm-up and 3 timed streams of 8 scans, then the oracle's forest:
    # 7 scans streamed and one grown
    runs = 4 * SWARM_SCANS + SWARM_SCANS
    check(launches == launches_sub == runs,
          f"swarm: K1's per-target entry point launched {launches_sub} "
          f"times ({launches} in all) over {runs} scans")
    check(res["k1_launches_per_scan"] == 1.0,
          f"swarm: {res['k1_launches_per_scan']} K1 launches per scan")
    err = check_noted_launches(gk, noted, "swarm", (T * L, M), (3,))
    for inp, _, _, sub in noted:
        check(tuple(sub["z_sub"].shape) == (T, Km, 2),
              f"swarm: K1 ran at z_sub {tuple(sub['z_sub'].shape)}")
    del noted
    check(all(bool(f) for f in outs.sel_feasible), "swarm: infeasible scan")
    check(not any(np.isnan(f).any() for f in outs if f.dtype.kind == "f"),
          "swarm: NaN in the outputs")

    # the port's CPU run of the first scans
    tr_c, scan_c, ais_c = bench_swarm.stream_inputs(
        scene, torch.device("cpu"), True, n_scans=SWARM_CPU_SCANS)
    cpu = outputs_to_host(bench_swarm.stream(tr_c, scan_c, ais_c, True)[2])
    for k in range(SWARM_CPU_SCANS):
        live = outs.track_mask[k]
        check(np.array_equal(live, cpu.track_mask[k])
              and np.array_equal(outs.track_id[k][live],
                                 cpu.track_id[k][live]),
              f"swarm scan {k}: tracks differ from the CPU run")
        for f in ("sel_hist_meas", "sel_hist_mmsi"):
            check(np.array_equal(getattr(outs, f)[k][live],
                                 getattr(cpu, f)[k][live]),
                  f"swarm scan {k}: {f} differs from the CPU run")
        check(np.allclose(outs.track_x[k][live], cpu.track_x[k][live],
                          rtol=STATE_RTOL, atol=STATE_ATOL),
              f"swarm scan {k}: states differ from the CPU run")
        check(math.isclose(float(outs.sel_obj[k]), float(cpu.sel_obj[k]),
                           rel_tol=OBJ_RTOL, abs_tol=1e-3),
              f"swarm scan {k}: objective differs from the CPU run")
    fused = int((outs.sel_hist_mmsi[:, :, -1] > 0).sum())
    check(fused > 0, "swarm: no selected AIS label")
    check(res["truth_coverage"] >= MIN_COVERAGE_SWARM
          and res["rms_matched_m"] <= MAX_RMS_SWARM,
          f"swarm: quality below the floor: coverage "
          f"{res['truth_coverage']}, rms {res['rms_matched_m']}")
    gap, proven = res["opt_gap_vs_exact_oracle"], res["oracle_proven_optimal"]
    if proven:
        check(gap is not None and gap <= GAP_LIMIT,
              f"swarm: gap {gap} against the proven optimum")

    # K1 at the swarm shape: seeded, timed, against its bound
    args = K1_ARGS
    dt = torch.full((), 2.5, device="cuda")
    inp, sub = k1_sub_inputs(31, T, L, Km, M, "cuda")
    e, _ = check_against_twin(gk, f"per target, swarm (T={T}, L={L}, "
                              f"Km={Km}, M={M})", inp, dt, args, sub)
    times = kernel_times(gk, inp, dt, args, sub)
    bound = k1_sub_bound(T, L, Km, M)
    print(f"swarm (bench_swarm at its defaults: {res['n_targets']} targets, "
          f"T={T}, L={L}, M={M}, A={shapes.max_ais}, Km={Km}, AIS, "
          f"{SWARM_SCANS} scans streamed): {res['value']} ms/scan (median of "
          f"3 streams after a warm-up), host reads per scan "
          f"{res['host_reads_per_scan']}, K1 per-target launches "
          f"{launches_sub} ({res['k1_launches_per_scan']} per scan); "
          f"coverage {res['truth_coverage']} (floor {MIN_COVERAGE_SWARM}), "
          f"rms {res['rms_matched_m']} m (ceiling {MAX_RMS_SWARM}), "
          f"{res['tracks_alive_last_scan']} tracks at the last scan, "
          f"{fused} selected AIS labels; median dual gap "
          f"{res['median_dual_gap']}; oracle_proven_optimal: {proven}, gap "
          f"{gap} (HiGHS limit {SWARM_ORACLE_LIMIT} s); smoothing "
          f"{res['smooth_1000tracks_one_dispatch_ms']} ms; scans 1-"
          f"{SWARM_CPU_SCANS} = the CPU run; {wall_s:.1f} s in all ({card})")
    print(json.dumps({"swarm": res}))
    print(f"K1 per target at the swarm shape (N={T * L}, Km={Km}, M={M}), "
          f"device time: kernel alone {1e3 * times['kernel_ms']:.3f} us hot, "
          f"{1e3 * times['kernel_flushed_ms']:.3f} us over 8 sets; wrapper "
          f"{1e3 * times['ms']:.3f} us, twin {1e3 * times['plain_ms']:.3f} "
          f"us; bound {1e3 * bound['bound_ms']:.3f} us ({bound['bytes']} "
          f"bytes, by {bound['bound_by']}); max |err| {max(err, e):.3g} "
          f"({card})")
    return dict(res=res, launches=launches, n_scans=runs,
                max_err=max(err, e), shape=(T * L, Km, M), **times, **bound)


# ----------------------------------------------------------------------
# scripts phase
# ----------------------------------------------------------------------

SAT_POINTS = (1024, 4096)    # bench_saturation points run on the card


@contextlib.contextmanager
def environment(**env):
    """``os.environ`` with ``env`` set inside the block."""
    import os
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def run_script(gk, name, main_fn, argv, env):
    """One script's ``main`` in this process, on the card (its default),
    with its knobs: (its output lines, K1 launches as (entry point, N, M,
    Km), seconds)."""
    import io
    gk.launches = gk.launches_pregate = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with environment(**env), noting_k1_launches(gk) as noted, \
            contextlib.redirect_stdout(buf):
        main_fn(argv)
    shapes = [("per target" if "z_sub" in sub else "shared", inp[0].shape[0],
               inp[5].shape[0], sub["z_sub"].shape[1] if sub else None)
              for inp, _, _, sub in noted]
    del noted
    check(gk.launches == len(shapes), f"{name}: K1 counted {gk.launches} "
          f"launches, {len(shapes)} noted")
    out = buf.getvalue().splitlines()
    print(f"scripts: {name} {' '.join(argv)} "
          f"{' '.join(f'{k}={v}' for k, v in env.items())}: exit 0 in "
          f"{time.perf_counter() - t0:.1f} s, {len(shapes)} K1 launches")
    for line in out:
        print(f"  {line}")
    return out, shapes, time.perf_counter() - t0


def json_lines(out):
    return [json.loads(line) for line in out if line.startswith("{")]


def scripts_phase(card, workdir):
    """The port's scripts and examples on the card through their ``main``:
    eval_configs (small), bench_saturation at SAT_POINTS, the A/B of the
    distributed selects and the scaling bench at one NCCL rank, both
    examples with --no-plot.  Each must print its lines; K1 at the
    saturation points' shapes against its twin, timed, with its bound."""
    import torch
    from pymht_tpu_torch.examples import (demo_streaming_deployment,
                                          demo_tracking)
    from pymht_tpu_torch.ops import gate_kernel as gk
    from pymht_tpu_torch.scripts import (ab_distributed_select,
                                         bench_saturation, bench_scaling,
                                         eval_configs)
    launch_shapes, seconds = {}, {}

    def run(name, fn, argv=(), **env):
        out, shapes, s = run_script(gk, name, fn, list(argv), env)
        launch_shapes[name], seconds[name] = shapes, s
        return out

    ev = json_lines(run("eval_configs", eval_configs.main))
    check([c["config"] for c in ev] == [
        "1_crossing", "2_10tgt_clutter", "3_50tgt_dense", "4_mc_batch",
        "5_ais_swarm", "2_ipm_xcheck"], "eval_configs: configs missing")
    check(ev[3]["tracks_alive"] >= 0.9 * ev[3]["expected"],
          f"eval_configs: Monte-Carlo tracks lost: {ev[3]}")
    sat = json_lines(run("bench_saturation", bench_saturation.main,
                         SAT_POINTS=",".join(map(str, SAT_POINTS)),
                         SAT_REPS="1"))
    check([r.get("targets") for r in sat[:-1]] == list(SAT_POINTS)
          and sat[-1]["metric"] == "chip_saturation_curve"
          and all("error" not in r for r in sat[:-1]),
          f"bench_saturation: {sat}")
    ab = json_lines(run("ab_distributed_select",
                        ab_distributed_select.main))[-1]
    check(ab["shape"]["ranks"] == 1 and ab["converged"]["full"]["feasible"]
          and ab["converged"]["compact"]["feasible"],
          f"ab_distributed_select: {ab['converged']}")
    check(ab["obj_rel_delta"] <= ab_distributed_select.OBJ_RTOL,
          f"ab_distributed_select: 'full' and 'compact' objectives differ "
          f"by {ab['obj_rel_delta']} (relative): {ab['converged']}")
    sc = json_lines(run("bench_scaling", bench_scaling.main))
    check(len(sc) == 1 and sc[0]["devices"] == 1 and sc[0]["value"] > 0,
          f"bench_scaling: {sc}")
    demo = run("demo_tracking", demo_tracking.main,
               ["--no-plot", "--out", workdir])
    check(any("active tracks after 21 scans" in line for line in demo),
          "demo_tracking: no track summary")
    stream = run("demo_streaming_deployment", demo_streaming_deployment.main)
    check(any(line == "checkpoint resume bitwise-identical: True"
              for line in stream), "demo_streaming_deployment: resume")

    # K1 at the saturation points: every launch there at N=16T, M=2T
    args = K1_ARGS
    dt = torch.full((), 2.5, device="cuda")
    sat_k1, err = {}, 0.0
    for i, T in enumerate(SAT_POINTS):
        N, M = 16 * T, 2 * T
        n = sum(1 for s in launch_shapes["bench_saturation"]
                if s[:3] == ("shared", N, M))
        check(n > 0, f"bench_saturation: K1 never ran at N={N}, M={M}")
        inp = k1_inputs(40 + i, N, M, "cuda")
        e, _ = check_against_twin(gk, f"saturation T={T}", inp, dt, args)
        err = max(err, e)
        sat_k1[T] = dict(launches=n, **kernel_times(gk, inp, dt, args),
                         **k1_bound(N, M))
        r = sat_k1[T]
        print(f"K1 at the saturation point T={T} (N={N}, M={M}), device "
              f"time: kernel alone {1e3 * r['kernel_ms']:.3f} us hot, "
              f"{1e3 * r['kernel_flushed_ms']:.3f} us over 8 sets; wrapper "
              f"{1e3 * r['ms']:.3f} us, twin {1e3 * r['plain_ms']:.3f} us; "
              f"bound {1e3 * r['bound_ms']:.3f} us ({r['bytes']} bytes, by "
              f"{r['bound_by']}); {n} launches in the script ({card})")
        del inp
        torch.cuda.empty_cache()
    launches = {k: len(v) for k, v in launch_shapes.items()}
    print(f"scripts: K1 launches {launches}; seconds "
          f"{ {k: round(v, 1) for k, v in seconds.items()} } ({card})")
    return dict(launch_shapes=launch_shapes, launches=launches,
                sat_k1=sat_k1, max_err=err, saturation=sat, ab=ab,
                scaling=sc, seconds=seconds)


def kernels_line(k1, k1p, k1h, res, ais, stream, deg, roof, ipm, pure, ckpt,
                 gaps, mc, mcb, mca, mcp, mci, s1, s2, swarm, scripts):
    """The line before the card's: K1's two entry points, each with its
    launches on the main paths (counted from 0 around each phase's run),
    the shapes it ran at, its largest |err| against the twin, its times
    and its bound."""
    def script_shapes(entry):
        seen = {}
        for name, shapes in scripts["launch_shapes"].items():
            for e, N, M, Km in shapes:
                if e == entry:
                    key = (name, N, M if Km is None else Km)
                    seen[key] = seen.get(key, 0) + 1
        return [dict(phase=f"scripts/{n}", N=N, cols=c, launches=k)
                for (n, N, c), k in seen.items()]

    shared_phases = [("slice", res, 4096, 512), ("ais", ais, 4096, 512),
                     ("stream", stream, 4096, 512),
                     ("degrade", deg, "4096 then 2048", 512),
                     ("roof", roof, 4096, 512), ("ipm demo", ipm, 1024, 64),
                     ("pure", pure, 4096, 512),
                     ("checkpoint", ckpt, 4096, 512),
                     ("sharded-1", s1, "8192 swarm, 4096 bench", 512),
                     ("sharded-2", s2, "4096 per rank", 512)]
    shared_shapes = [dict(phase=n, N=N, cols=M, launches=r["launches"])
                     for n, r, N, M in shared_phases]
    shared_shapes.append(dict(phase="ipm xcheck", N=512, cols=64,
                              launches=ipm["launches_xcheck"]))
    shared_shapes += script_shapes("shared")
    sub_phases = [("pre-gate", ais["launches_pregate"], 4096, 64),
                  ("mc", mc["launches"], 32768, 28),
                  ("mc-bench", mcb["launches"], 131072, 512),
                  ("mc-ais", mca["launches"], 131072, 512),
                  ("mc-pregate", mcp["launches"], 131072, 64),
                  ("mc-ipm", mci["launches"], 8192, 64),
                  ("mc-pure", mci["launches_pure"], 8192, 64),
                  ("swarm", swarm["launches"], 16384, 64)]
    sub_shapes = [dict(phase=n, N=N, cols=c, launches=k)
                  for n, k, N, c in sub_phases] + script_shapes("per target")
    sat = {f"saturation_T{T}_{key}": r[key]
           for T, r in scripts["sat_k1"].items()
           for key in ("kernel_ms", "kernel_flushed_ms", "ms", "plain_ms",
                       "bound_ms", "bound_by", "launches")}
    shared = {
        "name": "gate_score",
        "route": "cuda",
        "source": "pymht_tpu_torch/csrc/gate_score.cu",
        "replaces": "pymht_tpu/ops/gate_kernel.py:34",
        "launches": sum(d["launches"] for d in shared_shapes),
        "shapes": shared_shapes,
        # over every comparison with the twin at this entry point: the
        # kernel phase's shapes, the real scans of the 'ipm' runs and of
        # the sharded phases, the saturation points
        "max_abs_err": max(k1["max_err_all"], ipm["k1_max_err"],
                           s1["max_err"], s2["max_err"], scripts["max_err"]),
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": None,
        "kernel_ms": k1["kernel_ms"],
        "kernel_flushed_ms": k1["kernel_flushed_ms"],
        "half_beam_kernel_ms": k1h["kernel_ms"],
        "half_beam_bound_ms": k1h["bound_ms"],
        "oracle_gaps": gaps,
        "sharded_1_ms": s1["k1_ms"],
        "sharded_1_kernel_ms": s1["k1_kernel_ms"],
        "sharded_1_plain_ms": s1["k1_plain_ms"],
        "sharded_1_bound_ms": s1["k1_bound_ms"],
        "sharded_2_bound_ms": k1_bound(4096, 512)["bound_ms"],
        **sat}
    sub = {
        "name": "gate_score_sub",
        "route": "cuda",
        "source": "pymht_tpu_torch/csrc/gate_score.cu",
        "replaces": "pymht_tpu/ops/gate_kernel.py:34 (per-target columns, "
                    "the counterpart of pymht_tpu/ops/ais_fused.py:438)",
        "launches": sum(d["launches"] for d in sub_shapes),
        "shapes": sub_shapes,
        # the kernel phase's shapes, the batches (seeded and real scans)
        # and the swarm benchmark (seeded and a real scan)
        "max_abs_err": max(k1p["max_err"], mc["max_err"], mcb["max_err"],
                           mca["max_err"], mcp["max_err"], mci["max_err"],
                           swarm["max_err"]),
        # at the swarm benchmark's shape, T=1024, L=16, Km=64, M=2048
        "ms": swarm["ms"],
        "plain_ms": swarm["plain_ms"],
        "bound_ms": swarm["bound_ms"],
        "bound_by": swarm["bound_by"],
        "library_ms": None,
        "kernel_ms": swarm["kernel_ms"],
        "kernel_flushed_ms": swarm["kernel_flushed_ms"],
        "bench_pregate_ms": k1p["ms"],
        "bench_pregate_kernel_ms": k1p["kernel_ms"],
        "bench_pregate_plain_ms": k1p["plain_ms"],
        "bench_pregate_bound_ms": k1p["bound_ms"],
        **{f"{key}_{name}": r[name]
           for key, r in (("mc", mc), ("mc_bench", mcb), ("batch_ais", mca),
                          ("batch_pregate", mcp), ("batch_ipm", mci))
           for name in ("ms", "kernel_ms", "kernel_flushed_ms", "plain_ms",
                        "bound_ms")},
        **{f"batch_{key}_{name}": r[name]
           for key, r in (("ais", mca), ("pregate", mcp), ("ipm", mci))
           for name in ("ms_per_scan", "reads_per_scan", "peak_gib")}}
    return {"kernels": [shared, sub]}


def main(argv):
    import os
    import tempfile
    import torch
    t_start = time.perf_counter()
    if argv not in ([], ["--k1-guard"]):
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    guard_only = argv == ["--k1-guard"]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a "
              "GPU", file=sys.stderr)
        return 1
    from pymht_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")

    t0 = time.perf_counter()
    so = build.build("gate_score")
    print(f"build: gate_score.cu in {time.perf_counter() - t0:.2f} s "
          f"(0 if already built) -> {so.name}")
    print(so.with_suffix(".log").read_text().strip())

    from pymht_tpu_torch.ops import gate_kernel as gk
    sms, per_sm = gk.occupancy()
    print(f"K1 occupancy: {per_sm} blocks of 256 threads per SM on {sms} "
          f"SMs ({per_sm * 256} of 2048 thread slots); one block "
          f"per 16 leaves, so {sms * per_sm} blocks run at once")
    torch.cuda.synchronize()
    k1, k1p, k1h = kernel_phase()
    print(f"K1 at bench shape (N=4096, M=512, gated share "
          f"{k1['gated_share']:.5f}), device time, {card}: kernel alone "
          f"{1e3 * k1['kernel_ms']:.3f} us with the plane hot in L2 "
          f"(200 back-to-back launches into one set of buffers, median of "
          f"7), {1e3 * k1['kernel_flushed_ms']:.3f} us flushed (rotating "
          f"over 8 sets, 76 MB); one wrapper call "
          f"{1e3 * k1['ms']:.3f} us, plain twin "
          f"{1e3 * k1['plain_ms']:.3f} us (median of 30); bound "
          f"{1e3 * k1['bound_ms']:.3f} us ({k1['bytes']} bytes at 3.35 "
          f"TB/s, bound by {k1['bound_by']}): the kernel reaches "
          f"{k1['bound_ms'] / k1['kernel_ms']:.3f} of it hot, "
          f"{k1['bound_ms'] / k1['kernel_flushed_ms']:.3f} flushed")

    print(f"K1 at the half beam (N=2048, M=512, the shape after degrade()), "
          f"device time, {card}: kernel alone "
          f"{1e3 * k1h['kernel_ms']:.3f} us hot; bound "
          f"{1e3 * k1h['bound_ms']:.3f} us ({k1h['bytes']} bytes): the "
          f"kernel reaches {k1h['bound_ms'] / k1h['kernel_ms']:.3f} of it")
    print(f"K1 per target (T=128, L=32, Km=64, M=512, gated share "
          f"{k1p['gated_share']:.5f}), device time, {card}: kernel alone "
          f"{1e3 * k1p['kernel_ms']:.3f} us hot, "
          f"{1e3 * k1p['kernel_flushed_ms']:.3f} us over 8 sets of buffers; "
          f"one wrapper call {1e3 * k1p['ms']:.3f} us, plain twin "
          f"{1e3 * k1p['plain_ms']:.3f} us; bound "
          f"{1e3 * k1p['bound_ms']:.3f} us ({k1p['bytes']} bytes at 3.35 "
          f"TB/s, bound by {k1p['bound_by']}): the kernel reaches "
          f"{k1p['bound_ms'] / k1p['kernel_ms']:.3f} of it")
    guard_phase(card)
    if guard_only:
        print(f"chip_smoke --k1-guard: {time.perf_counter() - t_start:.1f} s "
              f"in all")
        return 0

    res = slice_phase()
    ais = ais_phase()
    stream = stream_phase(ais)
    deg = degrade_phase()
    roof = roof_phase()
    scatter_phase(ais, card)
    smoother_phase(res["gpu"], res["cpu"], card)
    ipm = ipm_phase(card)
    pure = pure_phase(card)
    gaps = gap_phase(res, ais, ipm)
    ckpt = checkpoint_phase(stream)
    xml_phase(ipm["gpu"])
    mc = mc_phase()
    mcb = mc_bench_phase()
    mca = mc_ais_phase()
    mcp = mc_pregate_phase()
    mci = mc_ipm_phase()
    with tempfile.TemporaryDirectory() as d:
        s1_path = os.path.join(d, "sharded-1")
        s1 = sharded1_phase(card, s1_path)
        s2 = sharded2_phase(s1, s1_path, card)
        swarm = swarm_phase(card)
        scripts = scripts_phase(card, d)
    for what, r in (("slice (radar only)", res), ("AIS scene", ais)):
        syncs = r["syncs"]
        print(f"{what} on the card: {r['ms_per_scan']:.2f} ms/scan (median "
              f"of scans 3-{r['n_scans']}, wall clock, stepped path), host "
              f"syncs per scan median {np.median(syncs):.0f} (min "
              f"{min(syncs)}, max {max(syncs)}); K1 launches "
              f"{r['launches']} ({card})")

    print(f"stream (AIS scene, chunks of {STREAM_CHUNK}) on the card: "
          f"{stream['ms_per_scan']:.2f} ms/scan (median of the chunks after "
          f"the first, which took {stream['ms_per_scan_first_chunk']:.2f}) "
          f"against {ais['ms_per_scan']:.2f} stepped in this run; host reads "
          f"per scan {stream['syncs_per_scan']:.2f} against "
          f"{np.mean(ais['syncs']):.2f} stepped (one output fetch per chunk, "
          f"not per scan); K1 launches {stream['launches']} ({card})")
    print(f"dynamic window and degrade (radar-only scene, prune_similar, "
          f"chunks of {STREAM_CHUNK}) on the card: "
          f"ms/scan of each chunk {deg['ms_before']} at L=32 (the first "
          f"pays the warm-up), {deg['ms_after']} at L=16 after degrade(); "
          f"targets with a shrunk window: {deg['shrunk'][0]} "
          f"before the switch, {deg['shrunk'][1]} at the end; K1 launches "
          f"{deg['launches']}, the last {deg['launches_half_beam']} at "
          f"N = 2048 ({card})")

    check("jax" not in sys.modules, "the port imported jax")
    check(not [m for m in sys.modules
               if m == "pymht_tpu" or m.startswith("pymht_tpu.")],
          "the port imported the JAX package (pymht_tpu)")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(card)
    print(json.dumps(kernels_line(k1, k1p, k1h, res, ais, stream, deg, roof,
                                  ipm, pure, ckpt, gaps, mc, mcb, mca, mcp,
                                  mci, s1, s2, swarm, scripts)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pymht_tpu_torch) on one GPU.

    python3 chip_smoke.py          # from the root of the repository

Phases, in order; any failure raises and the script exits non-zero:

1. the card: torch's device name and nvidia-smi's name and power limit;
2. build: K1 (csrc/gate_score.cu) compiled by nvcc for sm_90a;
3. kernel: K1's seven outputs against its plain torch twin on the card,
   at the bench shape (4096 leaves x 512 measurements) and at ragged and
   edge shapes: identical gating, counts and used mask, the rest within
   the stated tolerance.  Then its times at the bench shape (CUDA
   events behind a device spin): the kernel alone (back-to-back
   launches into the same buffers, and into rotating buffers that
   exceed the L2), one wrapper call, the twin, and the kernel's bound
   (its input and output bytes over the card's published 3.35 TB/s).
   The same for K1's per-target entry point (the spatial pre-gate's
   ``z_sub [T, Km, 2]``) at T=128, L=32, Km=64 and at edge shapes;
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
   (reported), with the launches of K1's per-target entry point counted.

The line before the last is one JSON object describing each kernel of
the path; the last line is ``{"ok": true, "device": {...}}``.  There is
no CPU fallback: without a CUDA device the script exits with code 1.
"""
from __future__ import annotations

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

# K1 against its twin: gating decisions, per-leaf counts and the used
# mask identical; scores, x_bar, P_bar, K and P_hat within these (f32;
# the kernel's closed-form predict and update round differently from the
# twin's einsums).
K1_RTOL, K1_ATOL = 1e-5, 1e-4
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


def k1_sub_bound(T, L, Km, M):
    """The same for the per-target entry point: it reads the leaves, dt
    and the per-target z_sub, zmask_sub and zidx (not the scan's z and
    zmask), and writes the [N, 1 + Km] plane, the per-leaf outputs and
    the used mask of the real M measurements."""
    N = T * L
    bytes_in = N * (16 + 64 + 4 + 4 + 1) + 4 + T * Km * (8 + 1 + 4)
    bytes_out = N * (4 * (Km + 1) + 16 + 64 + 32 + 64 + 4) + M
    t_bytes = 1e3 * (bytes_in + bytes_out) / HBM_BYTES_PER_S
    t_flops = 1e3 * (15.0 * N * Km + 150.0 * N) / F32_FLOP_PER_S
    return dict(bytes=bytes_in + bytes_out, bound_ms=max(t_bytes, t_flops),
                bound_by="bytes" if t_bytes >= t_flops else "operations")


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
    for a, b, what in pairs:
        check(torch.allclose(a, b, rtol=K1_RTOL, atol=K1_ATOL),
              f"K1 {name}: {what} differ beyond rtol {K1_RTOL} "
              f"atol {K1_ATOL}")
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


def kernel_phase():
    """Returns (shared-scan entry point's numbers at the bench shape, the
    per-target entry point's at T=128, L=32, Km=64)."""
    import torch
    from pymht_tpu_torch.ops import gate_kernel as gk
    args = dict(q_scale=1.0, r_var=6.25, eta2=5.99, lambda_ex=3e-5)
    dt = torch.full((), 2.5, device="cuda")
    cases = [("bench", 4096, 512, {}), ("ragged", 4095, 512, {}),
             ("ragged, N % 4 = 2", 4094, 512, {}),
             ("one measurement", 4096, 1, {}),
             ("measurements masked", 4096, 512, {"zmask_all": False}),
             ("leaves masked", 4096, 512, {"mask_all": False})]
    res = {}
    for i, (name, N, M, kw) in enumerate(cases):
        inp = k1_inputs(i, N, M, "cuda", **kw)
        err, g_r = check_against_twin(gk, name, inp, dt, args)
        if name == "bench":
            res = dict(max_err=err,
                       gated_share=float(g_r[:, 1:].float().mean()),
                       **kernel_times(gk, inp, dt, args), **k1_bound(N, M))

    # the per-target entry point: bench leaves, a tile smaller than the
    # kernel's 16 rows, a ragged L, targets with every column masked,
    # one column, and more columns than a block has threads
    sub_cases = [("per target, bench", 128, 32, 64, 512, False),
                 ("per target, L=8", 16, 8, 8, 32, False),
                 ("per target, ragged L=20", 12, 20, 16, 48, False),
                 ("per target, targets masked", 128, 32, 64, 512, True),
                 ("per target, Km=1", 9, 5, 1, 17, False),
                 ("per target, Km=300", 3, 33, 300, 512, False)]
    res_sub = {}
    for i, (name, T, L, Km, M, masked) in enumerate(sub_cases):
        inp, sub = k1_sub_inputs(i, T, L, Km, M, "cuda", masked)
        n0 = gk.launches_pregate
        err, g_r = check_against_twin(gk, name, inp, dt, args, sub)
        check(gk.launches_pregate == n0 + 1,
              f"K1 {name}: the per-target entry point was not launched")
        check(bool(g_r[:, 1:].any()), f"K1 {name}: nothing gated")
        if name == "per target, bench":
            res_sub = dict(max_err=err,
                           gated_share=float(g_r[:, 1:].float().mean()),
                           **kernel_times(gk, inp, dt, args, sub),
                           **k1_sub_bound(T, L, Km, M))
    return res, res_sub


# ----------------------------------------------------------------------
# slice phase
# ----------------------------------------------------------------------

def run_tracker(device, shapes, params, scans, seeds, use_ais=False,
                groups=(), mmsi=None):
    """Step ``scans`` (with ``groups[i]`` the AIS messages of scan i)
    through the port's Tracker on ``device``."""
    import torch
    from pymht_tpu_torch import Tracker
    tracker = Tracker(shapes, params, method="lagrangian", use_ais=use_ais,
                      device=device)
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


def check_card_against_cpu(gpu, gpu_outs, cpu, cpu_outs, what):
    """Same track ids, same selected (measurement, MMSI) labels per scan,
    states and objective within tolerance."""
    check(sorted(gpu.get_tracks()) == sorted(cpu.get_tracks()),
          f"{what}: card and CPU runs end with different track ids")
    for i, (g, c) in enumerate(zip(gpu_outs, cpu_outs)):
        check(np.array_equal(g.track_mask, c.track_mask)
              and np.array_equal(g.track_id, c.track_id),
              f"{what} scan {i}: track slots or ids differ from the CPU run")
        live = g.track_mask
        check(np.array_equal(g.sel_hist_meas[live], c.sel_hist_meas[live])
              and np.array_equal(g.sel_hist_mmsi[live],
                                 c.sel_hist_mmsi[live]),
              f"{what} scan {i}: selected (measurement, MMSI) labels differ "
              f"from the CPU run")
        check(np.allclose(g.track_x[live], c.track_x[live],
                          rtol=STATE_RTOL, atol=STATE_ATOL),
              f"{what} scan {i}: track states differ from the CPU run")
        check(math.isclose(float(g.sel_obj), float(c.sel_obj),
                           rel_tol=OBJ_RTOL, abs_tol=1e-3),
              f"{what} scan {i}: selection objective differs from the CPU "
              f"run")


def quality(tracker, sim_list, params, what, min_coverage, max_rms):
    from pymht_tpu_torch.utils import metrics
    m = metrics.evaluate(tracker, sim_list, params.radar_period,
                         p0=(0.0, 0.0), radar_range=params.radar_range)
    print(f"{what}: {len(tracker.scan_times)} scans, "
          f"{len(tracker.get_tracks())} tracks, coverage "
          f"{m['track_percent']:.5f} (floor {min_coverage}), rms "
          f"{m['rms']:.4f} m (ceiling {max_rms}), false tracks "
          f"{m['n_false_tracks']}; card run matches the CPU run")
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
    return dict(launches=launches,
                ms_per_scan=1e3 * float(np.median(wall[2:])),
                syncs=gpu.host_syncs, n_scans=len(scans), metrics=m)


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
    debug mode set to raise: grow (pre-gate, K1, the AIS chain, the beam)
    must not read a device value on the host."""
    import torch
    from pymht_tpu_torch.core.grow import grow
    packed = tracker._pack_inputs(float(scan.time) - tracker.t0
                                  + tracker.params.radar_period,
                                  scan.measurements, messages)
    sc, ais = tracker._unpack_inputs(packed)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        g = grow(tracker.state, sc, ais, tracker.shapes, tracker.params)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(bool(g.state.leaf_mask.any()), "grow under sync debug: no leaf")


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
    grow_makes_no_host_sync(gpu, scans[-1], groups[0])
    cpu, cpu_outs, _ = run_tracker("cpu", shapes, params, scans, seeds, **kw)
    check_card_against_cpu(gpu, gpu_outs, cpu, cpu_outs, "AIS")
    m = quality(gpu, sim_list, params, "AIS", MIN_COVERAGE_AIS, MAX_RMS_AIS)
    n_msgs = [min(len(g), shapes.max_ais) for g in gpu.ais_history]
    print(f"AIS: messages per scan {n_msgs}; selected associations: "
          f"{fused} fused, {pure} pure AIS; grow reads no device value on "
          f"the host")

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
                pure=pure, pregate_scans_equal=same)


def main():
    import torch
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
    k1, k1p = kernel_phase()
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

    print(f"K1 per target (T=128, L=32, Km=64, M=512, gated share "
          f"{k1p['gated_share']:.5f}), device time, {card}: kernel alone "
          f"{1e3 * k1p['kernel_ms']:.3f} us hot, "
          f"{1e3 * k1p['kernel_flushed_ms']:.3f} us over 8 sets of buffers; "
          f"one wrapper call {1e3 * k1p['ms']:.3f} us, plain twin "
          f"{1e3 * k1p['plain_ms']:.3f} us; bound "
          f"{1e3 * k1p['bound_ms']:.3f} us ({k1p['bytes']} bytes at 3.35 "
          f"TB/s, bound by {k1p['bound_by']}): the kernel reaches "
          f"{k1p['bound_ms'] / k1p['kernel_ms']:.3f} of it")

    res = slice_phase()
    ais = ais_phase()
    for what, r in (("slice (radar only)", res), ("AIS scene", ais)):
        syncs = r["syncs"]
        print(f"{what} on the card: {r['ms_per_scan']:.2f} ms/scan (median "
              f"of scans 3-{r['n_scans']}, wall clock, stepped path), host "
              f"syncs per scan median {np.median(syncs):.0f} (min "
              f"{min(syncs)}, max {max(syncs)}); K1 launches "
              f"{r['launches']} ({card})")

    check("jax" not in sys.modules, "the port imported jax")
    check(not [m for m in sys.modules
               if m == "pymht_tpu" or m.startswith("pymht_tpu.")],
          "the port imported the JAX package (pymht_tpu)")
    print(card)
    print(json.dumps({"kernels": [{
        "name": "gate_score",
        "route": "cuda",
        "source": "pymht_tpu_torch/csrc/gate_score.cu",
        "replaces": "pymht_tpu/ops/gate_kernel.py:34",
        # launches on the main paths: the radar-only slice and the AIS
        # scene (shared-scan entry point), then the pre-gated AIS scans
        # (per-target entry point)
        "launches": res["launches"] + ais["launches"],
        "launches_slice": res["launches"],
        "launches_ais": ais["launches"],
        "launches_pregate": ais["launches_pregate"],
        "launches_per_scan": (res["launches"] + ais["launches"])
        / (res["n_scans"] + ais["n_scans"]),
        "max_abs_err": max(k1["max_err"], k1p["max_err"]),
        "ms": k1["ms"],
        "kernel_ms": k1["kernel_ms"],
        "kernel_flushed_ms": k1["kernel_flushed_ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": None,
        "pregate_ms": k1p["ms"],
        "pregate_kernel_ms": k1p["kernel_ms"],
        "pregate_kernel_flushed_ms": k1p["kernel_flushed_ms"],
        "pregate_plain_ms": k1p["plain_ms"],
        "pregate_bound_ms": k1p["bound_ms"],
        "pregate_bound_by": k1p["bound_by"],
        "pregate_max_abs_err": k1p["max_err"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Monte-Carlo scenario generation and batched tracking (counterpart of
pymht_tpu/parallel/montecarlo.py).

Whole scenario batches are drawn on one device ([B, ...] tensors with
static clutter caps and masks) and tracked by the batched step
(``scenario.make_batched_step``): BASELINE config 4, 256 randomized
scenarios stepped together.  On the card ``run_batch`` replays one
captured graph of the batched step per scan (the counterpart of the JAX
function's ``lax.scan``), from ``core/graph.GRAPHS``.  The draws follow
the JAX function's semantics with an explicit ``torch.Generator``; JAX's
PRNG streams cannot be reproduced, so the same seed gives other numbers
than there.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import graph as graph_mod
from ..core.config import TrackerParams, TrackerShapes
from ..core.grow import Scan
from ..core.state import insert_targets
from ..core.tracker import _resolve_device
from ..models import pv
from .scenario import batch_states, make_batched_step

SPEEDS = torch.tensor([1, 10, 12, 15, 28, 35], dtype=torch.float32) * 0.5


class McScenario(NamedTuple):
    truth: torch.Tensor     # [B, S, K, 4] truth states per scan
    z: torch.Tensor         # [B, S, M, 2] measurements
    z_mask: torch.Tensor    # [B, S, M]
    times: torch.Tensor     # [S]


def generate(key, batch: int, n_targets: int, n_scans: int,
             shapes: TrackerShapes, params: TrackerParams,
             radar_range: float, sigma_R: float = 2.5,
             sigma_Q: float = 0.1, P_d: float = None,
             clutter_rate: float = None,
             lambda_local: float = 0.0, local_cap: int = 2,
             device=None) -> McScenario:
    """Batched scenario generation with the host simulator's semantics
    (uniform-in-disc starts within 0.8 of the range, discrete speed set,
    CV truth with process noise, P_d thinning, per-target local clutter
    at 3 sigma_R, Poisson-capped uniform global clutter).  ``local_cap``
    bounds local-clutter points per target per scan.

    ``key`` is a ``torch.Generator`` (the draws run on its device) or an
    int seed for a new generator on ``device``: the GPU unless the caller
    names another; with no CUDA device ``None`` raises."""
    if isinstance(key, torch.Generator):
        gen = key
    else:
        gen = torch.Generator(device=_resolve_device(device, "generate"))
        gen.manual_seed(int(key))
    dev = gen.device
    B, K, S = batch, n_targets, n_scans
    M = shapes.max_meas
    period = params.radar_period
    P_d = params.P_d if P_d is None else P_d
    lam = params.lambda_phi if clutter_rate is None else clutter_rate
    mean_clutter = lam * math.pi * radar_range ** 2

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def poisson(rate, *shape):
        return torch.poisson(torch.full(shape, float(rate), device=dev),
                             generator=gen)

    # initial states
    heading = rand(B, K) * 2 * math.pi
    dist = rand(B, K) * radar_range * 0.8
    pos = torch.stack([dist * torch.cos(heading), dist * torch.sin(heading)],
                      -1)
    vh = rand(B, K) * 2 * math.pi
    sp = SPEEDS.to(dev)[torch.randint(0, len(SPEEDS), (B, K), generator=gen,
                                      device=dev)]
    vel = torch.stack([sp * torch.cos(vh), sp * torch.sin(vh)], -1)
    x = torch.cat([pos, vel], -1)                                # [B,K,4]

    # truth propagation with process noise
    F = pv.Phi(period, dev)
    Q = pv.Q(period, sigma_Q, dev)
    Lq = torch.linalg.cholesky(Q + 1e-9 * torch.eye(4, device=dev))
    truth = []
    for _ in range(S):
        x = x @ F.T + randn(B, K, 4) @ Lq.T
        truth.append(x)
    truth = torch.stack(truth, 1)                                # [B,S,K,4]

    # measurements: target returns + clutter, padded to M
    z_t = truth[..., :2] + sigma_R * randn(B, S, K, 2)
    in_rng = torch.linalg.vector_norm(truth[..., :2], dim=-1) <= radar_range
    det = (rand(B, S, K) <= P_d) & in_rng

    # local clutter: Poisson(lambda_local) points per in-range target at
    # 3 sigma_R around its true position
    Cl = local_cap if lambda_local > 0.0 else 0
    if Cl:
        n_loc = poisson(lambda_local, B, S, K)
        l_xy = (truth[..., None, :2]
                + 3.0 * sigma_R * randn(B, S, K, Cl, 2))
        l_mask = ((torch.arange(Cl, device=dev) < n_loc[..., None])
                  & in_rng[..., None])
        l_xy, l_mask = l_xy.reshape(B, S, K * Cl, 2), l_mask.reshape(
            B, S, K * Cl)
    else:
        l_xy = torch.zeros((B, S, 0, 2), device=dev)
        l_mask = torch.zeros((B, S, 0), dtype=torch.bool, device=dev)

    n_clutter_max = M - K - K * Cl
    if n_clutter_max <= 0:
        raise ValueError(f"generate: max_meas {M} leaves no room for clutter "
                         f"beside {K} targets and {K * Cl} local points")
    c_xy = (rand(B, S, n_clutter_max, 2) * 2.0 - 1.0) * radar_range
    c_ok = torch.linalg.vector_norm(c_xy, dim=-1) <= radar_range
    n_clutter = poisson(mean_clutter, B, S)
    c_mask = ((torch.arange(n_clutter_max, device=dev) < n_clutter[..., None])
              & c_ok)

    z = torch.cat([z_t, l_xy, c_xy], dim=2)                      # [B,S,M,2]
    z_mask = torch.cat([det, l_mask, c_mask], dim=2)
    times = (torch.arange(S, dtype=torch.float32, device=dev) + 1) * period
    return McScenario(truth=truth, z=z, z_mask=z_mask, times=times)


def initial_states(scenario: McScenario, shapes: TrackerShapes,
                   params: TrackerParams):
    """(state, initiator state) of the batch before its first scan, on
    the scenario's device: each scenario's targets pre-initialised from
    truth at the first scan time (truth[:, 0] is the state at times[0];
    the first tracked scan then predicts with dt=0, which is exact)."""
    B, _, K = scenario.truth.shape[:3]
    dev = scenario.z.device
    state_b, istate_b = batch_states(shapes, params, B, device=dev)
    T = shapes.max_targets
    k = min(K, T)
    xs = torch.zeros((B, T, 4), device=dev)
    xs[:, :k] = scenario.truth[:, 0, :k]
    state_b = insert_targets(
        state_b, xs, pv.P0(dev).expand(B, T, 4, 4),
        (torch.arange(T, device=dev) < K).expand(B, T),
        torch.zeros((B, T), dtype=torch.int32, device=dev),
        scenario.times[0], params)
    return state_b, istate_b


def scan_batch(scenario: McScenario, s: int) -> Scan:
    """Scan ``s`` of every scenario, as the batched step takes it."""
    B = scenario.z.shape[0]
    return Scan(z=scenario.z[:, s], mask=scenario.z_mask[:, s],
                time=scenario.times[s].expand(B).contiguous())


def run_batch(scenario: McScenario, shapes: TrackerShapes,
              params: TrackerParams, method: str = 'lagrangian'):
    """Track every scenario of the batch, one batched ``scan_step`` per
    scan with nothing fetched in between, on the scenario's device, with
    any of the four selection methods (radar only, as the JAX function).
    Returns (final states, track_x [S, B, T, 4], track_mask [S, B, T]).

    On the card, for a method ``graph.graphable`` names, the initial
    states are loaded into the step's graph once (captured on first use
    into ``graph.GRAPHS``), the graph is replayed once per scan with
    nothing read in between, and each scan's ``track_x`` and
    ``track_mask`` are copied into row s of the stacked outputs; the
    final states returned are copies of the graph's."""
    step = make_batched_step(shapes, params, method=method, use_ais=False,
                             graphs=graph_mod.GRAPHS)
    state_b, istate_b = initial_states(scenario, shapes, params)
    S = scenario.z.shape[1]
    g = step.graph(state_b, istate_b)
    if g is not None:
        g.load(state_b, istate_b)
        xs = ms = None
        for s in range(S):
            out = g(scan_batch(scenario, s))
            if xs is None:
                xs = out.track_x.new_empty((S, *out.track_x.shape))
                ms = out.track_mask.new_empty((S, *out.track_mask.shape))
            xs[s].copy_(out.track_x)
            ms[s].copy_(out.track_mask)
        return graph_mod.clone_state(g.state), xs, ms
    xs, ms = [], []
    for s in range(S):
        state_b, istate_b, out = step(state_b, istate_b,
                                      scan_batch(scenario, s))
        xs.append(out.track_x)
        ms.append(out.track_mask)
    return state_b, torch.stack(xs), torch.stack(ms)

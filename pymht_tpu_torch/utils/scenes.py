"""Seeded scenes shared by the port's smoke run and profiler."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..core.config import TrackerParams, TrackerShapes
from . import simulator as sim


def _bench_config(max_meas: int = 512, **shape_kw):
    shapes = TrackerShapes(max_targets=128, max_leaves=32, max_meas=max_meas,
                           window=7, max_prelim=64, max_initiators=max_meas,
                           **shape_kw)
    params = TrackerParams(radar_period=2.5, P_d=0.9, lambda_phi=2e-5,
                           lambda_nu=1e-5, N=5, radar_range=2000.0)
    return shapes, params


def bench_scene(n_targets: int = 100, n_scans: int = 12, seed: int = 1234,
                max_meas: int = 512, radar_cand_width: int = 0):
    """bench.py's scene (bench.py:53-89): T=128, L=32, M = ``max_meas``
    measurements and as many initiators (512), W=7, 64 prelims, the
    pre-gate at Km = ``radar_cand_width`` (0: off); ``n_targets`` seeded
    targets in a 2 km radar with clutter, ``n_scans + 1`` scans.

    Returns (shapes, params, scans, sim_list, seeds): ``seeds`` are the
    targets' states back-propagated one period, for
    ``Tracker.pre_initialize(scans[0].time - period, seeds)``."""
    shapes, params = _bench_config(max_meas, max_ais=8,
                                   radar_cand_width=radar_cand_width)
    period, radar_range = params.radar_period, params.radar_range
    rng = np.random.default_rng(seed)
    targets = sim.generate_initial_targets(rng, n_targets, (0.0, 0.0),
                                           radar_range, 0.9, 0.1)
    sim_list = sim.simulate_targets(rng, targets, sim_time=n_scans * period,
                                    dt=period)
    scans = sim.simulate_scans(rng, sim_list, period, sigma_R=2.5,
                               lambda_phi=2e-5, radar_range=radar_range,
                               p0=(0.0, 0.0), lambda_local=0.5)
    F_inv = np.eye(4)
    F_inv[0, 2] = F_inv[1, 3] = -period
    seeds = [F_inv @ t.state for t in targets]
    return shapes, params, scans, sim_list, seeds


def bench_scene_ais(n_targets: int = 100, n_scans: int = 12,
                    seed: int = 4321, max_ais: int = 32,
                    ais_per_leaf: int = 2, max_meas: int = 512,
                    radar_cand_width: int = 0):
    """bench.py's AIS-fusion scene (bench.py:164-213): the shapes of
    ``bench_scene`` (``max_meas``, ``radar_cand_width`` as there) with A
    = ``max_ais`` messages per scan and G = ``ais_per_leaf``; every
    seeded target carries a transponder (``P_r`` = 0.9) reporting at
    class-A intervals.

    Returns (shapes, params, scans, ais_groups, sim_list, seeds, mmsi):
    ``ais_groups[i]`` are the messages for ``scans[i]`` (fewer groups
    than scans is possible: a scan past the last group has none);
    ``seeds`` and ``mmsi`` go to ``Tracker.pre_initialize(scans[0].time -
    period, seeds, mmsi=mmsi)``."""
    shapes, params = _bench_config(max_meas, max_ais=max_ais,
                                   ais_per_leaf=ais_per_leaf,
                                   radar_cand_width=radar_cand_width)
    period, radar_range = params.radar_period, params.radar_range
    rng = np.random.default_rng(seed)
    targets = sim.generate_initial_targets(rng, n_targets, (0.0, 0.0),
                                           radar_range, 0.9, 0.1,
                                           assign_mmsi=True, P_r=0.9)
    sim_list = sim.simulate_targets(rng, targets, sim_time=n_scans * period,
                                    dt=period)
    scans = sim.simulate_scans(rng, sim_list, period, sigma_R=2.5,
                               lambda_phi=2e-5, radar_range=radar_range,
                               p0=(0.0, 0.0), lambda_local=0.5)
    ais_groups = sim.simulate_ais(rng, sim_list, period,
                                  init_time=sim_list[0][0].time)
    F_inv = np.eye(4)
    F_inv[0, 2] = F_inv[1, 3] = -period
    seeds = [F_inv @ t.state for t in targets]
    return (shapes, params, scans, ais_groups, sim_list, seeds,
            [t.mmsi for t in targets])


def swarm_shard_scene(n_scans: int = 4, seed: int = 42,
                      n_targets: int = 600):
    """The target-sharded swarm scene of tests/test_sharded_swarm.py:27-45
    (BASELINE config 5 at the JAX test's cut): T=1024 slots, L=8, M=512,
    A=32, W=5, G=2, N=3; ``n_targets`` seeded targets, half with
    transponders, in a 12 km radar (spread over half of it), local
    clutter 0.1 per target.

    Returns (shapes, params, scans, ais_groups, sim_list, seeds, mmsi),
    the last two for ``Tracker.pre_initialize(scans[0].time - period,
    seeds, mmsi=mmsi)``."""
    period, radar_range = 2.5, 12000.0
    shapes = TrackerShapes(max_targets=1024, max_leaves=8, max_meas=512,
                           max_ais=32, window=5, max_prelim=32,
                           max_initiators=64, ais_per_leaf=2)
    params = TrackerParams(radar_period=period, P_d=0.9, lambda_phi=1.5e-6,
                           lambda_nu=1e-6, N=3, radar_range=radar_range)
    rng = np.random.default_rng(seed)
    targets = sim.generate_initial_targets(
        rng, n_targets, (0.0, 0.0), radar_range * 0.5, 0.9, 0.1,
        assign_mmsi=True, P_r=0.5)
    sim_list = sim.simulate_targets(rng, targets, sim_time=n_scans * period,
                                    dt=period)
    scans = sim.simulate_scans(rng, sim_list, period, sigma_R=2.5,
                               lambda_phi=1.5e-6, radar_range=radar_range,
                               p0=(0.0, 0.0), lambda_local=0.1)
    ais_groups = sim.simulate_ais(rng, sim_list, period,
                                  init_time=sim_list[0][0].time)
    F_inv = np.eye(4)
    F_inv[0, 2] = F_inv[1, 3] = -period
    return (shapes, params, scans, ais_groups, sim_list,
            [F_inv @ t.state for t in targets], [t.mmsi for t in targets])


class SwarmScene(NamedTuple):
    """What ``swarm_scene`` draws: the configuration, the scans and AIS
    groups (``ais_groups[i]`` for ``scans[i]``; a scan past the last group
    has none), the simulator's truth, the seeds and MMSIs for
    ``Tracker.pre_initialize(scans[0].time - period, seeds, mmsi=mmsi)``,
    the targets' initial states (the smoother's priors) and the generator
    after the draws (bench_swarm.py draws the smoother's detection mask
    from it)."""
    shapes: TrackerShapes
    params: TrackerParams
    scans: list
    ais_groups: list
    sim_list: list
    seeds: list
    mmsi: list
    x0: np.ndarray
    rng: np.random.Generator


def swarm_scene(n_targets: int = 1000, n_scans: int = 8, m_cap: int = 2048,
                a_cap: int = 128, pregate: int = 64, use_ais: bool = True,
                seed: int = 77, t_cap: int = 1024,
                ais_prefilter: int = 0) -> SwarmScene:
    """bench_swarm.py's scene (BASELINE config 5, "1000-target swarm with
    AIS priors"; bench_swarm.py:42-95): T = ``t_cap`` slots, L=16,
    M = ``m_cap``, A = ``a_cap``, W=6, G=2, 64 prelims, 512 initiators,
    the per-target pre-gate at Km = ``pregate`` (0: off); a 12 km radar,
    P_d 0.9, lambda_phi 1.5e-6, N=4; min(``n_targets``, T - 16) seeded
    targets over 85 % of the range, half with transponders, local clutter
    0.2 per target, ``n_scans`` scans.  The defaults draw what the JAX
    script draws, seed for seed; the messages are drawn either way, and
    without ``use_ais`` none is handed over (``ais_groups`` is empty)."""
    period, radar_range = 2.5, 12000.0
    shapes = TrackerShapes(
        max_targets=t_cap, max_leaves=16, max_meas=m_cap, max_ais=a_cap,
        window=6, max_prelim=64, max_initiators=512, ais_per_leaf=2,
        ais_prefilter_width=ais_prefilter, radar_cand_width=pregate)
    params = TrackerParams(radar_period=period, P_d=0.9, lambda_phi=1.5e-6,
                           lambda_nu=1e-6, N=4, radar_range=radar_range)
    n_tgt = min(n_targets, t_cap - 16)
    rng = np.random.default_rng(seed)
    targets = sim.generate_initial_targets(
        rng, n_tgt, (0.0, 0.0), radar_range * 0.85, 0.9, 0.1,
        assign_mmsi=True, P_r=0.5)
    sim_list = sim.simulate_targets(rng, targets, sim_time=n_scans * period,
                                    dt=period)
    scans = sim.simulate_scans(rng, sim_list, period, sigma_R=2.5,
                               lambda_phi=1.5e-6, radar_range=radar_range,
                               p0=(0.0, 0.0), lambda_local=0.2)
    ais_groups = sim.simulate_ais(rng, sim_list, period,
                                  init_time=sim_list[0][0].time)
    F_inv = np.eye(4)
    F_inv[0, 2] = F_inv[1, 3] = -period
    return SwarmScene(shapes, params, scans[:n_scans],
                      ais_groups if use_ais else [], sim_list,
                      [F_inv @ t.state for t in targets],
                      [t.mmsi for t in targets],
                      np.array([t.state for t in targets], np.float32), rng)


def saturation_scene(T_cap: int, beam: int = 16, pregate: int = 0,
                     n_scans: int = 4):
    """One point of bench_saturation.py's curve (bench_saturation.py:
    53-75): T = ``T_cap`` slots, L = ``beam``, M = 2T, A=16, W=6, G=2, 64
    prelims, 512 initiators, the pre-gate at min(``pregate``, 2T) (0:
    off); a radar of 12 km x sqrt(T / 1024), so that the density of
    targets and clutter stays that of the swarm scene; T - 16 targets
    (seed 7) over 85 % of the range, local clutter 0.2 per target, no
    transponders, ``n_scans`` scans.

    Returns (shapes, params, scans, sim_list, seeds)."""
    period = 2.5
    radar_range = 12000.0 * float(np.sqrt(T_cap / 1024.0))
    shapes = TrackerShapes(
        max_targets=T_cap, max_leaves=beam, max_meas=2 * T_cap, max_ais=16,
        window=6, max_prelim=64, max_initiators=512, ais_per_leaf=2,
        radar_cand_width=min(pregate, 2 * T_cap) if pregate else 0)
    params = TrackerParams(radar_period=period, P_d=0.9, lambda_phi=1.5e-6,
                           lambda_nu=1e-6, N=4, radar_range=radar_range)
    rng = np.random.default_rng(7)
    targets = sim.generate_initial_targets(
        rng, T_cap - 16, (0.0, 0.0), radar_range * 0.85, 0.9, 0.1)
    sim_list = sim.simulate_targets(rng, targets, sim_time=n_scans * period,
                                    dt=period)
    scans = sim.simulate_scans(rng, sim_list, period, sigma_R=2.5,
                               lambda_phi=1.5e-6, radar_range=radar_range,
                               p0=(0.0, 0.0), lambda_local=0.2)
    F_inv = np.eye(4)
    F_inv[0, 2] = F_inv[1, 3] = -period
    return (shapes, params, scans[:n_scans], sim_list,
            [F_inv @ t.state for t in targets])


def demo_scene(n_targets: int = 6, n_scans: int = 20, seed: int = 42,
               clutter: float = 2e-6):
    """examples/demo_tracking.py's scene at its defaults: T=32, L=32,
    M=64, A=8, W=7, N=5; six seeded targets with transponders in a 1 km
    radar, 20 scans, no pre-initialisation (the initiator starts every
    track).  What the demo runs ``Tracker(method='ipm', use_ais=True)``
    on.

    Returns (shapes, params, scans, ais_groups, sim_list):
    ``ais_groups[i]`` are the messages handed over with ``scans[i]``."""
    period, radar_range = 2.5, 1000.0
    shapes = TrackerShapes(max_targets=32, max_leaves=32, max_meas=64,
                           max_ais=8, window=7, max_prelim=32,
                           max_initiators=64)
    params = TrackerParams(radar_period=period, P_d=0.9, lambda_phi=clutter,
                           lambda_nu=1e-5, N=5, radar_range=radar_range)
    rng = np.random.default_rng(seed)
    targets = sim.generate_initial_targets(rng, n_targets, (0., 0.),
                                           radar_range * 0.7, 0.9, 0.1,
                                           assign_mmsi=True)
    sim_list = sim.simulate_targets(rng, targets, sim_time=n_scans * period,
                                    dt=period)
    scans = sim.simulate_scans(rng, sim_list, period, sigma_R=2.5,
                               lambda_phi=clutter, radar_range=radar_range,
                               p0=(0., 0.))
    groups = sim.simulate_ais(rng, sim_list, period, sim_list[0][0].time)
    by_scan = {}
    for g in groups:
        tmax = max(m.time for m in g)
        for s in scans:
            if s.time > tmax:
                by_scan.setdefault(s.time, []).extend(g)
                break
    ais_groups = [[m for m in by_scan.get(s.time, [])
                   if s.time - period < m.time < s.time] for s in scans]
    return shapes, params, scans, ais_groups, sim_list


def xcheck_scene(n_targets: int = 10, n_scans: int = 16, seed: int = 7,
                 clutter: float = 2e-6):
    """eval_configs.py's ``2_ipm_xcheck`` scene (its ``build_scene`` at
    the ``small`` shapes): T=16, L=32, M=64, A=4, W=7, N=5; ten seeded
    targets in clutter at P_d = 0.9, radar only, no pre-initialisation.

    Returns (shapes, params, scans, sim_list)."""
    period, radar_range, P_d = 2.5, 1000.0, 0.9
    shapes = TrackerShapes(max_targets=16, max_leaves=32, max_meas=64,
                           max_ais=4, window=7, max_prelim=16,
                           max_initiators=64)
    params = TrackerParams(radar_period=period, P_d=P_d, lambda_phi=clutter,
                           lambda_nu=1e-5, N=5, radar_range=radar_range)
    rng = np.random.default_rng(seed)
    targets = sim.generate_initial_targets(rng, n_targets, (0., 0.),
                                           radar_range * 0.6, P_d, 0.1,
                                           assign_mmsi=False)
    sim_list = sim.simulate_targets(rng, targets, sim_time=n_scans * period,
                                    dt=period)
    scans = sim.simulate_scans(rng, sim_list, period, sigma_R=2.5,
                               lambda_phi=clutter, radar_range=radar_range,
                               p0=(0., 0.), P_d=P_d, local_clutter=True,
                               global_clutter=True)
    return shapes, params, scans, sim_list


def _mc_draw(shapes, params, batch, n_targets, n_scans, seed, **kw):
    import torch
    from ..parallel import montecarlo as mc
    return mc.generate(torch.Generator().manual_seed(seed), batch, n_targets,
                       n_scans, shapes, params, params.radar_range, **kw)


def mc_scene(batch: int = 256, n_targets: int = 4, n_scans: int = 10,
             seed: int = 0):
    """eval_configs.py's ``run_montecarlo`` configuration (its shape rule
    at ``n_targets``: T = max(8, K + 4), L=16, M = K + 24, A=2, W=6, 8
    prelims, M initiators; an 800 m radar, P_d 0.9, lambda_phi 1e-6,
    N=4, sigma_Q 0.05) at BASELINE config 4's ``batch`` of 256 scenarios.
    Drawn by ``parallel.montecarlo.generate`` on a CPU generator seeded
    with ``seed`` (move it to the card with ``.to``).

    Returns (shapes, params, scenario)."""
    K = n_targets
    shapes = TrackerShapes(max_targets=max(8, K + 4), max_leaves=16,
                           max_meas=K + 24, max_ais=2, window=6,
                           max_prelim=8, max_initiators=K + 24)
    params = TrackerParams(radar_period=2.5, P_d=0.9, lambda_phi=1e-6,
                           lambda_nu=1e-5, N=4, radar_range=800.0)
    return shapes, params, _mc_draw(shapes, params, batch, K, n_scans, seed,
                                    sigma_Q=0.05)


def mc_bench_scene(batch: int = 32, n_targets: int = 100, n_scans: int = 13,
                   seed: int = 0):
    """``batch`` scenarios at bench.py's shapes and parameters (those of
    ``bench_scene``: T=128, L=32, M=512, W=7, A=8, 64 prelims, 512
    initiators; a 2 km radar, lambda_phi 2e-5, P_d 0.9, N=5), each with
    ``n_targets`` targets and half a local clutter point per target per
    scan, drawn like ``mc_scene`` (``n_scans`` scans).

    Returns (shapes, params, scenario)."""
    shapes, params = _bench_config(max_ais=8)
    return shapes, params, _mc_draw(shapes, params, batch, n_targets,
                                    n_scans, seed, lambda_local=0.5)


class BatchScene(NamedTuple):
    """B seeded draws of one scene as the batched step takes them: each
    draw padded by a ``Tracker``'s own ``_pad_scan`` / ``_pad_ais`` and
    stacked, each scenario pre-initialised with its seeds and MMSIs.
    ``scans.time`` and ``ais.time`` are relative to each draw's origin
    (``origins[b]``, a Tracker's ``t0``)."""
    shapes: object
    params: object
    state: object           # TrackerState, [B, ...]
    init_state: object      # InitiatorState, [B, ...]
    scans: object           # Scan: z [B, S, M, 2], mask [B, S, M], time [B, S]
    ais: object             # AisBatch, [B, S, A, ...]
    sim_lists: list         # per draw, the simulator's truth
    origins: list           # per draw, the time origin t0

    def scan(self, s):
        """(Scan, AisBatch) of scan ``s`` of every scenario: [B, ...]."""
        return _at(self.scans, s), _at(self.ais, s)

    def to(self, device):
        """The same scene on ``device``."""
        import dataclasses

        def move(tree):
            if dataclasses.is_dataclass(tree):
                return tree.replace(**{f.name: getattr(tree, f.name).to(
                    device) for f in dataclasses.fields(tree)})
            return type(tree)(*(f.to(device) for f in tree))

        return self._replace(state=move(self.state),
                             init_state=move(self.init_state),
                             scans=move(self.scans), ais=move(self.ais))

    def scenario(self, b):
        """(state, initiator state, Scan [S, ...], AisBatch [S, ...]) of
        scenario ``b`` alone."""
        return (_pick(self.state, b), _pick(self.init_state, b),
                _pick(self.scans, b), _pick(self.ais, b))


def _at(tup, s):
    return type(tup)(*(f[:, s] for f in tup))


def _pick(tree, b):
    import dataclasses
    if dataclasses.is_dataclass(tree):
        return tree.replace(**{f.name: getattr(tree, f.name)[b]
                               for f in dataclasses.fields(tree)})
    return type(tree)(*(f[b] for f in tree))


def batch_scene(shapes, params, draws, device=None) -> BatchScene:
    """Stack ``draws``, each (scans, ais_groups, seeds, mmsi, sim_list)
    (``seeds=None``: no pre-initialisation, the initiator starts every
    track), into a ``BatchScene`` on ``device`` (the GPU unless named).
    Every draw must have the same number of scans."""
    import dataclasses

    import torch

    from ..core.grow import AisBatch, Scan
    from ..core.tracker import Tracker, _resolve_device

    device = _resolve_device(device, "batch_scene")

    period = params.radar_period
    M = shapes.max_meas
    states, istates, zs, ais, sims, origins = [], [], [], [], [], []
    for scans, groups, seeds, mmsi, sim_list in draws:
        tr = Tracker(shapes, params, method="lagrangian", use_ais=True,
                     device="cpu")
        if seeds is not None:
            tr.pre_initialize(scans[0].time - period, seeds, mmsi=mmsi)
        else:
            tr.t0 = float(scans[0].time) - period
        zs.append(np.stack([tr._pad_scan(float(sc.time) - tr.t0,
                                         sc.measurements) for sc in scans]))
        ais.append([np.stack(f) for f in zip(*(
            tr._pad_ais(list(groups[i]) if i < len(groups) else [])
            for i in range(len(scans))))])
        states.append(tr.state)
        istates.append(tr.init_state)
        sims.append(sim_list)
        origins.append(tr.t0)
    packed = torch.from_numpy(np.stack(zs))                # [B, S, M+1, 2]
    scan = Scan(z=packed[:, :, :M].contiguous(),
                mask=torch.arange(M) < packed[:, :, M, :1].int(),
                time=packed[:, :, M, 1].contiguous())
    ais_b = AisBatch(*(torch.from_numpy(np.stack(f))
                       for f in zip(*ais)))

    def stack(trees):
        return trees[0].replace(**{f.name: torch.stack(
            [getattr(t, f.name) for t in trees]).to(device)
            for f in dataclasses.fields(trees[0])})

    return BatchScene(shapes, params, stack(states), stack(istates),
                      Scan(*(f.to(device) for f in scan)),
                      AisBatch(*(f.to(device) for f in ais_b)), sims,
                      origins)


def bench_ais_batch(batch: int = 32, seed: int = 4321, device=None,
                    **kw) -> BatchScene:
    """``batch`` draws of ``bench_scene_ais`` (T=128, L=32, M=512, A=32,
    G=2, W=7; ``kw`` passes its other arguments), draw b with seed
    ``seed + b``, pre-initialised with its 100 seeds and MMSIs."""
    draws = []
    for b in range(batch):
        (shapes, params, scans, groups, sim_list, seeds,
         mmsi) = bench_scene_ais(seed=seed + b, **kw)
        draws.append((scans, groups, seeds, mmsi, sim_list))
    return batch_scene(shapes, params, draws, device)


def demo_batch(batch: int = 8, seed: int = 42, device=None,
               **kw) -> BatchScene:
    """``batch`` draws of ``demo_scene`` (T=32, L=32, M=64, A=8, W=7, six
    targets with transponders; ``kw`` passes its other arguments), draw b
    with seed ``seed + b``; no pre-initialisation, as the demo."""
    draws = []
    for b in range(batch):
        shapes, params, scans, groups, sim_list = demo_scene(seed=seed + b,
                                                             **kw)
        draws.append((scans, groups, None, None, sim_list))
    return batch_scene(shapes, params, draws, device)

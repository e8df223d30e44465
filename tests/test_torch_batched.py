"""The port's scenario batch against its own unbatched functions (port
only; the JAX side of batching is held in tests/test_torch_montecarlo.py).

``make_batched_step`` over four scenarios must give, scan by scan and
scenario by scenario, what ``scan_step`` gives for that scenario alone:
the scenes are chosen so that on one scan some scenarios take select's
fast path and others its solver, one has a cluster of more than four
targets (tier 3), the initiator's auctions run different numbers of
rounds, and the scenarios are stepped to different scan times (so K1
gets one time step per scenario).  Then ``select`` on stacked forests,
``auction_assign`` on stacked cost matrices and K1's plain twin through
the batched call (without and with the pre-gate), each against its
unbatched self; B=1; and what the batched step refuses.

Integer and boolean outputs must be equal; float outputs within
STATE_RTOL / STATE_ATOL (the batched twin predicts with one transition
matrix per leaf, the unbatched one with one per scan: the same f32
arithmetic summed in another order).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pymht_tpu_torch import sync  # noqa: E402
from pymht_tpu_torch.core import select as tsel  # noqa: E402
from pymht_tpu_torch.core.config import (  # noqa: E402
    TrackerParams, TrackerShapes)
from pymht_tpu_torch.core.grow import Scan, grow  # noqa: E402
from pymht_tpu_torch.core.initiator import empty_initiator  # noqa: E402
from pymht_tpu_torch.core.state import (  # noqa: E402
    empty_state, insert_targets)
from pymht_tpu_torch.core.tracker import scan_step  # noqa: E402
from pymht_tpu_torch.models import pv  # noqa: E402
from pymht_tpu_torch.ops import gate_kernel as gk  # noqa: E402
from pymht_tpu_torch.ops.assignment import auction_assign  # noqa: E402
from pymht_tpu_torch.parallel.scenario import (  # noqa: E402
    batch_states, make_batched_step)
from pymht_tpu_torch.utils import simulator as sim  # noqa: E402

SHAPES = TrackerShapes(max_targets=12, max_leaves=16, max_meas=48,
                       max_ais=2, window=5, max_prelim=8, max_initiators=48)
PARAMS = TrackerParams(radar_period=2.5, P_d=0.9, lambda_phi=4e-5,
                       lambda_nu=1e-5, N=3, radar_range=400.0)
N_SCANS = 8
STATE_RTOL, STATE_ATOL = 1e-5, 2e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Thousands of tiny ops: no intra-op thread pool (six test workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _converging(rng, n, radius, speed):
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return [sim.SimTarget(state=np.array([radius * np.cos(a),
                                          radius * np.sin(a),
                                          -speed * np.cos(a),
                                          -speed * np.sin(a)]),
                          time=0.0, P_d=0.9, sigma_Q=0.5) for a in ang]


def _scene(kind, seed):
    """(scans as (time, z) pairs, seeds): 'converging' 8 targets meet in
    clutter (clusters up to 7: tier 3), 'separated' 3 targets far apart
    (fast path), 'crossing' 2 targets cross (tier 2), 'initiate' 3
    targets nobody seeded (the initiator's auctions).  Each scene has its
    own scan period, so the scenarios' time steps differ."""
    rng = np.random.default_rng(seed)
    period = {'converging': 2.5, 'separated': 2.0, 'crossing': 3.0,
              'initiate': 2.5}[kind]
    if kind == 'converging':
        tgts, lam_loc = _converging(rng, 8, 60.0, 6.0), 1.0
    elif kind == 'crossing':
        tgts, lam_loc = _converging(rng, 2, 40.0, 5.0), 0.5
    else:
        tgts = [sim.SimTarget(state=np.array([x, y, vx, vy]), time=0.0,
                              P_d=0.95, sigma_Q=0.2)
                for x, y, vx, vy in ((-200, -150, 5, 1), (150, 100, -3, 4),
                                     (0, 220, 4, -4))]
        lam_loc = 0.0
    sim_list = sim.simulate_targets(rng, tgts, sim_time=N_SCANS * period,
                                    dt=period)
    scans = sim.simulate_scans(rng, sim_list, period, sigma_R=2.5,
                               lambda_phi=4e-5, radar_range=400.0,
                               p0=(0.0, 0.0), lambda_local=lam_loc)
    F_inv = np.eye(4)
    F_inv[0, 2] = F_inv[1, 3] = -period
    seeds = [] if kind == 'initiate' else [F_inv @ t.state for t in tgts]
    return ([(float(s.time), np.asarray(s.measurements, np.float32)
              .reshape(-1, 2)) for s in scans[:N_SCANS]], seeds, period)


KINDS = ('converging', 'separated', 'crossing', 'initiate')
SEEDS = (13, 12, 13, 14)


def _padded(z):
    M = SHAPES.max_meas
    n = min(len(z), M)
    zz = np.zeros((M, 2), np.float32)
    zz[:n] = z[:n]
    return zz, np.arange(M) < n


def _seeded_state(seeds, t0):
    """One scenario's empty state with ``seeds`` inserted at time t0."""
    T = SHAPES.max_targets
    x = np.zeros((T, 4), np.float32)
    x[:len(seeds)] = np.asarray(seeds, np.float32).reshape(-1, 4)
    st = empty_state(SHAPES, PARAMS, "cpu")
    return insert_targets(
        st, torch.from_numpy(x), pv.P0("cpu").expand(T, 4, 4),
        torch.arange(T) < len(seeds), torch.zeros(T, dtype=torch.int32),
        torch.tensor(t0, dtype=torch.float32), PARAMS)


def _stack(trees):
    """Stack a list of equal trees (dataclasses, tuples) on a new axis 0."""
    first = trees[0]
    if dataclasses.is_dataclass(first):
        return first.replace(**{f.name: torch.stack(
            [getattr(t, f.name) for t in trees])
            for f in dataclasses.fields(first)})
    return type(first)(*[torch.stack(f) for f in zip(*trees)])


def _assert_tree_equal(a, b, what):
    """``a`` (one scenario of a batch) against ``b`` (the same scenario
    alone): integer and boolean fields equal, floats within tolerance."""
    names = ([f.name for f in dataclasses.fields(a)]
             if dataclasses.is_dataclass(a) else a._fields)
    for name in names:
        x, y = getattr(a, name), getattr(b, name)
        assert x.shape == y.shape and x.dtype == y.dtype, (what, name)
        if x.dtype.is_floating_point:
            np.testing.assert_allclose(x.numpy(), y.numpy(),
                                       rtol=STATE_RTOL, atol=STATE_ATOL,
                                       err_msg=f"{what}: {name}")
        else:
            np.testing.assert_array_equal(x.numpy(), y.numpy(),
                                          err_msg=f"{what}: {name}")


@pytest.fixture(scope="module")
def runs():
    """The four scenes stepped alone and as one batch, with per-scan
    host reads, which scenario left the fast path and which ran tier 3."""
    scenes = [_scene(k, seed) for k, seed in zip(KINDS, SEEDS)]
    tier3, solved = [], []
    real, real_hybrid = tsel._compact_lagrangian, tsel.select_hybrid

    def noting(f, Uc, lam0, spine, eff_tgt, *a, **k):
        tier3.append(eff_tgt.any(dim=-1).clone())
        return real(f, Uc, lam0, spine, eff_tgt, *a, **k)

    def noting_hybrid(*a, **k):
        solved.append(True)
        return real_hybrid(*a, **k)

    tsel._compact_lagrangian = noting
    tsel.select_hybrid = noting_hybrid
    try:
        alone = []
        for scans, seeds, period in scenes:
            st = _seeded_state(seeds, scans[0][0] - period)
            ist = empty_initiator(SHAPES, "cpu")
            outs, reads, big, solver = [], [], [], []
            for t, z in scans:
                zz, m = _padded(z)
                scan = Scan(torch.from_numpy(zz), torch.from_numpy(m),
                            torch.tensor(t, dtype=torch.float32))
                n0, k0, s0 = sync.count, len(tier3), len(solved)
                st, ist, out = scan_step(st, ist, scan, None, SHAPES, PARAMS,
                                         method='lagrangian', use_ais=False)
                reads.append(sync.count - n0)
                big.append(len(tier3) > k0 and bool(tier3[-1]))
                solver.append(len(solved) > s0)
                outs.append((st, ist, out))
            alone.append(dict(outs=outs, reads=reads, big=big,
                              solver=solver))

        step = make_batched_step(SHAPES, PARAMS)
        st_b = _stack([_seeded_state(seeds, scans[0][0] - period)
                       for scans, seeds, period in scenes])
        ist_b = _stack([empty_initiator(SHAPES, "cpu")] * len(scenes))
        batched, b_reads = [], []
        for i in range(N_SCANS):
            pads = [_padded(sc[0][i][1]) for sc in scenes]
            scan_b = Scan(torch.from_numpy(np.stack([p[0] for p in pads])),
                          torch.from_numpy(np.stack([p[1] for p in pads])),
                          torch.tensor([sc[0][i][0] for sc in scenes],
                                       dtype=torch.float32))
            n0 = sync.count
            st_b, ist_b, out_b = step(st_b, ist_b, scan_b)
            b_reads.append(sync.count - n0)
            batched.append((st_b, ist_b, out_b))
    finally:
        tsel._compact_lagrangian = real
        tsel.select_hybrid = real_hybrid
    return scenes, alone, batched, b_reads


def _pick(tree, b):
    if dataclasses.is_dataclass(tree):
        return tree.replace(**{f.name: getattr(tree, f.name)[b]
                               for f in dataclasses.fields(tree)})
    return type(tree)(*[f[b] for f in tree])


def test_scenes_take_different_branches(runs):
    """The scenes do what the batch test needs of them."""
    _, alone, _, _ = runs
    fast_and_solver = [i for i in range(N_SCANS)
                       if len({a['solver'][i] for a in alone}) == 2]
    assert fast_and_solver, "no scan mixes the fast path and the solver"
    assert any(alone[0]['big']), "the converging scene never reaches tier 3"
    assert not any(alone[1]['big'])
    reads = np.array([a['reads'] for a in alone])       # [scenario, scan]
    assert any(len(set(reads[:, i])) > 2 for i in range(N_SCANS))
    confirmed = [int(a['outs'][-1][0].tgt_mask.sum()) for a in alone]
    assert confirmed[3] >= 1, "the initiator confirmed nothing"


@pytest.mark.parametrize("b", range(len(KINDS)), ids=KINDS)
def test_batched_step_equals_each_scenario_alone(runs, b):
    _, alone, batched, _ = runs
    for i in range(N_SCANS):
        st_b, ist_b, out_b = batched[i]
        st, ist, out = alone[b]['outs'][i]
        what = f"scenario {KINDS[b]}, scan {i}"
        _assert_tree_equal(_pick(out_b, b), out, what + " outputs")
        _assert_tree_equal(_pick(st_b, b), st, what + " state")
        _assert_tree_equal(_pick(ist_b, b), ist, what + " initiator")


def test_batched_reads_follow_the_slowest_scenario(runs):
    """One host read per loop test and branch of the batch: at least the
    reads of the scenario that needs most alone, far fewer than all
    scenarios' reads together."""
    _, alone, _, b_reads = runs
    reads = np.array([a['reads'] for a in alone])
    assert (np.asarray(b_reads) >= reads.max(axis=0)).all()
    assert sum(b_reads) < reads.sum()


def test_batch_of_one_equals_the_unbatched_step(runs):
    scenes, alone, _, _ = runs
    scans, seeds, period = scenes[0]
    step = make_batched_step(SHAPES, PARAMS)
    st = _stack([_seeded_state(seeds, scans[0][0] - period)])
    ist = _stack([empty_initiator(SHAPES, "cpu")])
    for i, (t, z) in enumerate(scans):
        zz, m = _padded(z)
        st, ist, out = step(st, ist, Scan(
            torch.from_numpy(zz)[None], torch.from_numpy(m)[None],
            torch.tensor([t], dtype=torch.float32)))
        _assert_tree_equal(_pick(out, 0), alone[0]['outs'][i][2],
                           f"B=1, scan {i}")
        _assert_tree_equal(_pick(st, 0), alone[0]['outs'][i][0],
                           f"B=1, scan {i} state")


@pytest.mark.parametrize("method", ["lagrangian", "greedy"])
@pytest.mark.parametrize("scatter", [False, True], ids=["dense", "scatter"])
def test_select_on_stacked_forests(runs, method, scatter, monkeypatch):
    """``select`` on the converging scene's grown forests, stacked,
    against each forest alone; with ``scatter`` the scatter builds of the
    usage tensors are forced."""
    scenes, alone, _, _ = runs
    scans, _, _ = scenes[0]
    forests = []
    for i in range(1, N_SCANS):
        zz, m = _padded(scans[i][1])
        forests.append(grow(alone[0]['outs'][i - 1][0], Scan(
            torch.from_numpy(zz), torch.from_numpy(m),
            torch.tensor(scans[i][0], dtype=torch.float32)), None,
            SHAPES, PARAMS).state)
    if scatter:
        monkeypatch.setattr(tsel, "_USAGE_DENSE_LIMIT", 0)
        monkeypatch.setattr(tsel, "_INT32_WALL", 0)
    res_b = tsel.select(_stack(forests), SHAPES, PARAMS, method=method)
    n_conflicted = 0
    for k, f in enumerate(forests):
        res = tsel.select(f, SHAPES, PARAMS, method=method)
        _assert_tree_equal(_pick(res_b, k), res, f"forest {k}")
        n_conflicted += not bool(tsel._independent_best(f, SHAPES,
                                                        PARAMS)[2])
    assert 0 < n_conflicted < len(forests)


def test_auction_on_stacked_cost_matrices():
    """Matrices whose auctions, greedy fills and augmentations take
    different numbers of rounds, stacked, against each alone."""
    rng = np.random.default_rng(3)
    R, C = 10, 14
    costs, valids = [], []
    for density in (0.15, 0.4, 0.8, 1.0):
        a = rng.uniform(0, 100, (R, 2))
        b = rng.uniform(0, 100, (C, 2))
        cost = np.linalg.norm(a[:, None] - b[None], axis=2)
        costs.append(cost.astype(np.float32))
        valids.append(rng.uniform(size=(R, C)) < density)
    valids[3][:, :] = False                   # nothing to assign
    cost_b = torch.from_numpy(np.stack(costs))
    valid_b = torch.from_numpy(np.stack(valids))
    n0 = sync.count
    got = auction_assign(cost_b, valid_b, max_iters=4000)
    reads_b = sync.count - n0
    reads = []
    for k in range(len(costs)):
        n0 = sync.count
        want = auction_assign(cost_b[k], valid_b[k], max_iters=4000)
        reads.append(sync.count - n0)
        assert torch.equal(got[k], want), k
    assert len(set(reads)) > 1 and max(reads) <= reads_b < sum(reads)
    # and under an iteration cap that stops some auctions early
    got = auction_assign(cost_b, valid_b, max_iters=3)
    for k in range(len(costs)):
        assert torch.equal(got[k], auction_assign(cost_b[k], valid_b[k],
                                                  max_iters=3)), k


def test_k1_twin_through_the_batched_call():
    """K1's plain twin, called as grow calls it for a batch (one "target"
    per scenario, each with its own time step), against the unbatched
    twin on each scenario."""
    rng = np.random.default_rng(8)
    B, T, L, M = 3, 4, 8, 24
    x = rng.normal(0, 60, (B, T * L, 4)).astype(np.float32)
    P = np.broadcast_to(np.diag([6.25, 6.25, 1.875, 1.875]),
                        (B, T * L, 4, 4)).astype(np.float32)
    cnllr = rng.normal(0, 1, (B, T * L)).astype(np.float32)
    pd = np.full((B, T * L), 0.9, np.float32)
    mask = rng.uniform(size=(B, T * L)) < 0.9
    dt = np.array([2.5, 2.0, 3.1], np.float32)
    z = rng.normal(0, 60, (B, M, 2)).astype(np.float32)
    k = M // 2          # half the measurements where leaves will be
    z[:, :k] = (x[:, :k, :2] + dt[:, None, None] * x[:, :k, 2:]
                + rng.normal(0, 2, (B, k, 2)))
    zmask = rng.uniform(size=(B, M)) < 0.95
    args = dict(q_scale=1.0, r_var=6.25, eta2=5.99, lambda_ex=3e-5)
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (x, P, cnllr, pd, mask, z, zmask)]
    got = gk.radar_candidates(
        t[0].reshape(-1, 4), t[1].reshape(-1, 4, 4), t[2].reshape(-1),
        t[3].reshape(-1), t[4].reshape(-1), t[5].reshape(-1, 2),
        t[6].reshape(-1), torch.from_numpy(dt), **args,
        z_sub=t[5], zmask_sub=t[6],
        zidx=torch.arange(B * M, dtype=torch.int32).view(B, M),
        leaves_per_target=T * L)
    assert got.scores.shape == (B * T * L, M + 1)
    assert got.used_meas.shape == (B * M,)
    n_gated = 0
    for b in range(B):
        want = gk.radar_candidates(*(a[b] for a in t),
                                   torch.tensor(dt[b]), **args)
        rows = slice(b * T * L, (b + 1) * T * L)
        g, g_w = got.scores[rows] < gk.BIG / 2, want.scores < gk.BIG / 2
        assert torch.equal(g, g_w)
        n_gated += int(g[:, 1:].sum())
        np.testing.assert_allclose(got.scores[rows][g].numpy(),
                                   want.scores[g_w].numpy(), rtol=1e-5,
                                   atol=1e-4)
        for f in ("x_bar", "P_bar", "K", "P_hat"):
            np.testing.assert_allclose(getattr(got, f)[rows].numpy(),
                                       getattr(want, f).numpy(),
                                       rtol=1e-5, atol=1e-4, err_msg=f)
        assert torch.equal(got.gated_counts[rows], want.gated_counts)
        assert torch.equal(got.used_meas.view(B, M)[b], want.used_meas)
    assert n_gated > 0
    # the time steps matter: scenario 1 at scenario 0's step predicts
    # other positions
    other = gk.radar_candidates(*(a[1] for a in t), torch.tensor(dt[0]),
                                **args)
    assert not torch.allclose(other.x_bar,
                              got.x_bar[T * L:2 * T * L])


def test_wrapper_refuses_what_the_kernel_cannot_index():
    """The launch checks refuse a leaf count whose 16 * N, or a
    measurement count that, passes 2^31, before any pointer reaches the
    kernel; and a per-target dt of the wrong length."""
    N, M = 1 << 27, 4
    x = torch.empty(1, 1).expand(N, 4)       # never read: shapes only
    with pytest.raises(ValueError, match="int32 indices"):
        gk.launch(gk.empty_outputs(0, M, "cpu"), x, x, x, x, x,
                  torch.empty(M, 2), torch.empty(M, dtype=torch.bool),
                  torch.tensor(2.5), 1.0, 6.25, 5.99, 2e-5)
    T, L, Km = 2, 4, 3
    out = gk.empty_outputs(T * L, 6, "cpu", Km=Km)
    leaves = [torch.zeros(T * L, 4), torch.zeros(T * L, 4, 4),
              torch.zeros(T * L), torch.zeros(T * L),
              torch.zeros(T * L, dtype=torch.bool)]
    sub = dict(z_sub=torch.zeros(T, Km, 2),
               zmask_sub=torch.zeros(T, Km, dtype=torch.bool),
               zidx=torch.zeros(T, Km, dtype=torch.int32),
               leaves_per_target=L)
    with pytest.raises(ValueError, match="one step per target"):
        gk.launch(out, *leaves, torch.zeros(6, 2),
                  torch.zeros(6, dtype=torch.bool), torch.zeros(T + 1),
                  1.0, 6.25, 5.99, 2e-5, **sub)


def test_make_batched_step_refuses_unbatched_options():
    """Nothing of the JAX step's options is refused any more (the AIS
    branch, 'ipm' / 'lagrangian_pure' and the pre-gate are held in
    tests/test_torch_batched_options.py); what is still refused is an
    unknown method, with the dispatcher's ValueError."""
    for kw in (dict(use_ais=True), dict(method='ipm'),
               dict(method='lagrangian_pure'),
               dict(use_ais=True, method='ipm')):
        assert callable(make_batched_step(SHAPES, PARAMS, **kw))
    assert callable(make_batched_step(
        dataclasses.replace(SHAPES, radar_cand_width=8), PARAMS))
    step = make_batched_step(SHAPES, PARAMS, method='simplex')
    st, ist = batch_states(SHAPES, PARAMS, 2, device="cpu")
    M = SHAPES.max_meas
    with pytest.raises(ValueError, match="unknown selection method"):
        step(st, ist, Scan(torch.zeros(2, M, 2),
                           torch.zeros(2, M, dtype=torch.bool),
                           torch.ones(2)))


def _pregate_batch_inputs(seed, B, T, L, M, Km):
    """K1's inputs as grow hands them over for a batch of B pre-gated
    scenarios: B * T targets of L leaves, each with Km columns of its own
    scenario's scan (its nearest measurements), indexed on the flat
    [B * M] axis (``zidx`` offset by b * M), and each target its
    scenario's time step.  Returns (the seven tensors, dt [B * T], the
    per-target arguments, and per scenario the unbatched call's
    arguments)."""
    rng = np.random.default_rng(seed)
    dt = rng.uniform(2.0, 3.0, B).astype(np.float32)
    x = rng.normal(0, 60, (B, T, L, 4)).astype(np.float32)
    x[..., 2:] = rng.normal(0, 3, (B, T, 1, 2))
    x[..., :2] = x[:, :, :1, :2] + rng.normal(0, 3, (B, T, L, 2))
    P = np.broadcast_to(np.diag([6.25, 6.25, 1.875, 1.875]),
                        (B, T, L, 4, 4)).astype(np.float32)
    cnllr = rng.normal(0, 1, (B, T, L)).astype(np.float32)
    pd = np.full((B, T, L), 0.9, np.float32)
    mask = rng.uniform(size=(B, T, L)) < 0.9
    pred = x[:, :, 0, :2] + dt[:, None, None] * x[:, :, 0, 2:]    # [B,T,2]
    z = rng.normal(0, 60, (B, M, 2)).astype(np.float32)
    z[:, :T] = pred + rng.normal(0, 2, (B, T, 2))
    zmask = rng.uniform(size=(B, M)) < 0.95
    d2 = ((z[:, None] - pred[:, :, None]) ** 2).sum(-1)           # [B,T,M]
    d2 = np.where(zmask[:, None], d2, np.inf)
    zidx = np.argsort(d2, axis=-1, kind="stable")[..., :Km]       # [B,T,Km]
    z_sub = np.take_along_axis(z[:, None], zidx[..., None], 2)
    zmask_sub = np.take_along_axis(zmask[:, None].repeat(T, 1), zidx, 2)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        x.reshape(-1, 4), P.reshape(-1, 4, 4), cnllr.reshape(-1),
        pd.reshape(-1), mask.reshape(-1), z.reshape(-1, 2),
        zmask.reshape(-1))]
    flat = (zidx + M * np.arange(B)[:, None, None]).astype(np.int32)
    sub = dict(z_sub=torch.from_numpy(z_sub.reshape(B * T, Km, 2).copy()),
               zmask_sub=torch.from_numpy(zmask_sub.reshape(B * T, Km)
                                          .copy()),
               zidx=torch.from_numpy(flat.reshape(B * T, Km).copy()),
               leaves_per_target=L)
    dt_t = torch.from_numpy(dt).reshape(B, 1).expand(B, T).reshape(B * T)
    alone = [([torch.from_numpy(np.ascontiguousarray(a[b])).reshape(
        (T * L,) + a.shape[3:]) for a in (x, P, cnllr, pd, mask)]
        + [torch.from_numpy(z[b]), torch.from_numpy(zmask[b])],
        torch.tensor(dt[b]),
        dict(z_sub=torch.from_numpy(np.ascontiguousarray(z_sub[b])),
             zmask_sub=torch.from_numpy(np.ascontiguousarray(zmask_sub[b])),
             zidx=torch.from_numpy(zidx[b].astype(np.int32)),
             leaves_per_target=L)) for b in range(B)]
    return t, dt_t, sub, alone


K1_ARGS = dict(q_scale=1.0, r_var=6.25, eta2=5.99, lambda_ex=3e-5)


def _same_candidates(got, want, what):
    g, g_w = got.scores < gk.BIG / 2, want.scores < gk.BIG / 2
    assert torch.equal(g, g_w), what
    np.testing.assert_allclose(got.scores[g].cpu().numpy(),
                               want.scores[g_w].cpu().numpy(), rtol=1e-5,
                               atol=1e-4, err_msg=what)
    for f in ("x_bar", "P_bar", "K", "P_hat"):
        np.testing.assert_allclose(getattr(got, f).cpu().numpy(),
                                   getattr(want, f).cpu().numpy(),
                                   rtol=1e-5, atol=1e-4,
                                   err_msg=f"{what}: {f}")
    assert torch.equal(got.gated_counts.cpu(), want.gated_counts.cpu()), what
    return int(g[:, 1:].sum())


def test_k1_twin_through_the_batched_pregate_call():
    """K1's plain twin called as grow calls it for a pre-gated batch (B *
    T targets, columns on the flat [B * M] axis, one time step per
    target) against the unbatched pre-gated twin on each scenario."""
    B, T, L, M, Km = 3, 4, 8, 40, 6
    t, dt, sub, alone = _pregate_batch_inputs(9, B, T, L, M, Km)
    got = gk.radar_candidates(*t, dt, **K1_ARGS, **sub)
    assert got.scores.shape == (B * T * L, Km + 1)
    assert got.used_meas.shape == (B * M,)
    n_gated = 0
    for b, (inp, dt_b, sub_b) in enumerate(alone):
        want = gk.radar_candidates(*inp, dt_b, **K1_ARGS, **sub_b)
        rows = slice(b * T * L, (b + 1) * T * L)
        n_gated += _same_candidates(
            type(got)(*(f[rows] for f in got[:6]), got.used_meas),
            want._replace(used_meas=want.used_meas), f"scenario {b}")
        assert torch.equal(got.used_meas.view(B, M)[b], want.used_meas)
    assert n_gated > 0 and bool(got.used_meas.any())


@pytest.mark.cuda
def test_k1_kernel_on_the_batched_pregate_call():
    """The same call on the card: K1's per-target entry point at the
    batched pre-gate's shape (flat ``zidx`` offsets, ``dt`` per target)
    against its twin on the same tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    B, T, L, M, Km = 4, 16, 32, 128, 16
    t, dt, sub, _ = _pregate_batch_inputs(10, B, T, L, M, Km)
    t = [a.cuda() for a in t]
    dt = dt.contiguous().cuda()
    sub = {k: v.cuda() if isinstance(v, torch.Tensor) else v
           for k, v in sub.items()}
    n0, p0 = gk.launches, gk.launches_pregate
    got = gk.radar_candidates(*t, dt, **K1_ARGS, **sub)
    torch.cuda.synchronize()
    assert (gk.launches, gk.launches_pregate) == (n0 + 1, p0 + 1)
    want = gk.radar_candidates_reference(*t, dt, **K1_ARGS, **sub)
    assert _same_candidates(got, want, "batched pre-gate") > 0
    assert torch.equal(got.used_meas, want.used_meas)


def test_batch_states_need_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batch_states(SHAPES, PARAMS, 2)
    st, ist = batch_states(SHAPES, PARAMS, 3, device="cpu")
    assert st.leaf_x.shape == (3, 12, 16, 4) and st.lam.shape == (3, 5 * 50)
    assert ist.p_x.shape == (3, 8, 4) and ist.has_time.shape == (3,)
    assert (st.hist_meas == -1).all() and (ist.p_meas_idx == -1).all()

"""The port's ``'ipm'`` and ``'lagrangian_pure'`` selections and the
dispatcher ``select`` for all four methods against the JAX package (both
``Tracker(method='ipm')``s scan by scan: tests/test_torch_tracker_ipm.py).

Forests are grown scan by scan by the port on the CPU and handed to JAX
field by field through numpy: a radar-only scene (8 targets converging
on one point in clutter: clusters of up to 7 targets) and an AIS scene
(two pairs of ships 5 m apart sharing AIS messages, so conflicts sit on
AIS slots).

Required per forest: the same ``sel``, or else both feasible with
objectives within 1e-4 (1 + |obj|); objective and bound within that
tolerance; the same cluster labels.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from pymht_tpu.core import select as jsel  # noqa: E402
from pymht_tpu.core import config as jconfig  # noqa: E402
from pymht_tpu.core.state import TrackerState as JState  # noqa: E402
from pymht_tpu.utils import simulator as sim  # noqa: E402
from pymht_tpu_torch import sync  # noqa: E402
from pymht_tpu_torch.core import select as tsel  # noqa: E402
from pymht_tpu_torch.core.config import (  # noqa: E402
    TrackerParams, TrackerShapes)
from pymht_tpu_torch.core.grow import grow as tgrow  # noqa: E402
from pymht_tpu_torch.core.state import state_to_numpy  # noqa: E402
from pymht_tpu_torch.core.tracker import Tracker  # noqa: E402
from pymht_tpu_torch.utils.simulator import AisMessage  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The solvers are thousands of tiny ops: torch's intra-op thread pool
    adds only contention when several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_cfg(cfg):
    """The JAX package's config class of the same name, from the port's
    numbers."""
    return getattr(jconfig, type(cfg).__name__)(**dataclasses.asdict(cfg))


def to_jax(tstate):
    return JState(**{k: jnp.asarray(v)
                     for k, v in state_to_numpy(tstate).items()})


def _grown(tr, feed):
    """Post-grow states (before selection) of every scan but the first."""
    out = []
    for i, (t, z, msgs) in enumerate(feed):
        if i >= 1:
            scan, ais = tr._unpack_inputs(tr._pack_inputs(t - tr.t0, z, msgs))
            out.append(tgrow(tr.state, scan, ais, tr.shapes, tr.params).state)
        tr.add_measurement_list(t, z, ais_messages=msgs)
    return out


def converging(n_scans, seed=5):
    """Eight seeded targets converging on one point in clutter."""
    shapes = TrackerShapes(max_targets=12, max_leaves=16, max_meas=48,
                           max_ais=2, window=5, max_prelim=8,
                           max_initiators=48)
    params = TrackerParams(radar_period=2.5, P_d=0.9, lambda_phi=4e-5,
                           lambda_nu=1e-5, N=3, radar_range=400.0)
    period = params.radar_period
    ang = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    tgts = [sim.SimTarget(state=np.array([60 * np.cos(a), 60 * np.sin(a),
                                          -6 * np.cos(a), -6 * np.sin(a)]),
                          time=0.0, P_d=0.9, sigma_Q=0.5) for a in ang]
    rng = np.random.default_rng(seed)
    sim_list = sim.simulate_targets(rng, tgts, sim_time=n_scans * period,
                                    dt=period)
    scans = sim.simulate_scans(rng, sim_list, period, sigma_R=2.5,
                               lambda_phi=4e-5, radar_range=400.0,
                               p0=(0.0, 0.0), lambda_local=1.0)
    F_inv = np.eye(4)
    F_inv[0, 2] = F_inv[1, 3] = -period
    return shapes, params, scans, [F_inv @ t.state for t in tgts]


def radar_scene():
    shapes, params, scans, seeds = converging(8)
    tr = Tracker(shapes, params, method='lagrangian', use_ais=False,
                 device='cpu')
    tr.pre_initialize(scans[0].time - params.radar_period, seeds)
    return shapes, params, _grown(tr, [(s.time, s.measurements, ())
                                       for s in scans])


def ais_scene():
    shapes = TrackerShapes(max_targets=6, max_leaves=16, max_meas=12,
                           max_ais=4, window=5, max_prelim=8,
                           max_initiators=12, ais_per_leaf=2)
    params = TrackerParams(radar_period=2.5, P_d=0.9, lambda_phi=1e-5,
                           lambda_nu=1e-6, N=3, radar_range=1e4,
                           cnllr_upper_limit=1e9,
                           score_upper_limit_scale=1e6)
    period = params.radar_period
    rng = np.random.default_rng(12)
    xs = [np.array([0.0, 0.0, 5.0, 0.0]), np.array([0.0, 5.0, 5.0, 0.0]),
          np.array([200.0, 100.0, -4.0, 2.0]),
          np.array([203.0, 104.0, -4.0, 2.0]),
          np.array([-150.0, -80.0, 0.0, 6.0])]
    F = np.eye(4)
    F[0, 2] = F[1, 3] = period
    Fa = np.eye(4)
    Fa[0, 2] = Fa[1, 3] = period * 0.6
    tr = Tracker(shapes, params, method='lagrangian', use_ais=True,
                 ais_initialization=False, device='cpu')
    tr.pre_initialize(0.0, xs)
    feed = []
    for i in range(7):
        t = (i + 1) * period
        # one message per pair per scan, from one of its two ships, and
        # one from the lone ship; the tracks start without an MMSI
        msgs = [AisMessage(state=Fa @ xs[k]
                           + rng.normal(0, 1.0, 4) * [1, 1, .1, .1],
                           time=t - period * 0.4, mmsi=300000001 + k,
                           highAccuracy=bool(k % 2))
                for k in (int(rng.integers(0, 2)), 2 + int(rng.integers(0, 2)),
                          4)]
        xs = [F @ x for x in xs]
        z = np.stack([x[:2] + rng.normal(0, 1.5, 2) for x in xs
                      if rng.random() < 0.9]
                     + [rng.uniform(-200, 250, 2) for _ in range(3)])
        feed.append((t, z.astype(np.float32), msgs))
    return shapes, params, _grown(tr, feed)


@pytest.fixture(scope="module", params=["radar", "ais"])
def scene(request):
    shapes, params, forests = {"radar": radar_scene,
                               "ais": ais_scene}[request.param]()
    n_conflicted = sum(not bool(tsel._independent_best(st, shapes, params)[2])
                       for st in forests)
    assert n_conflicted >= 3            # the scene exercises the solvers
    if request.param == "ais":
        assert any(int(st.hist_ais.max()) > 0 for st in forests)
    return (shapes, params, jax_cfg(shapes), jax_cfg(params), forests,
            [to_jax(st) for st in forests])


# The bound of 'ipm' is the objective of the root LP's last iterate.  In
# f32 the normal equations lose definiteness a few rounds before the
# tolerance is met (both packages then keep the last good iterate, at a
# complementarity of 1e-2 to 1e-5), and XLA's Cholesky and LAPACK's give
# up one round apart on some forests: the two bounds then differ (by at
# most 5.5e-3 (1 + |obj|) on these scenes, on five of the fourteen
# forests by more than 1e-3) while selection and objective agree.  So
# every forest is held to IPM_BOUND_RTOL, and most of each scene's to the
# 1e-3 of the other solvers.
IPM_BOUND_RTOL = 1e-2


def _check(res_t, res_j, lam_tol=None, bound_rtol=1e-3):
    obj_j = float(res_j.obj)
    tol = 1e-4 * (1.0 + abs(obj_j))
    assert bool(res_t.feasible) == bool(res_j.feasible)
    assert res_t.sel.dtype == torch.int32
    if not np.array_equal(res_t.sel.numpy(), np.asarray(res_j.sel)):
        assert bool(res_t.feasible) and bool(res_j.feasible)
    assert abs(float(res_t.obj) - obj_j) <= tol
    assert abs(float(res_t.bound) - float(res_j.bound)) \
        <= bound_rtol * (1.0 + abs(obj_j))
    np.testing.assert_array_equal(res_t.labels.numpy(),
                                  np.asarray(res_j.labels))
    assert int(res_t.n_clusters) == int(res_j.n_clusters)
    if lam_tol is not None:
        np.testing.assert_allclose(res_t.lam.numpy(), np.asarray(res_j.lam),
                                   rtol=lam_tol, atol=lam_tol)


def test_select_ipm_matches_jax(scene):
    shapes, params, jshapes, jparams, forests, jforests = scene
    ipm_j = jax.jit(lambda st: jsel.select_ipm(st, jshapes, jparams))
    n_same = n_tight = 0
    for tst, jst in zip(forests, jforests):
        res_t = tsel.select_ipm(tst, shapes, params)
        res_j = jax.device_get(ipm_j(jst))
        _check(res_t, res_j, bound_rtol=IPM_BOUND_RTOL)
        assert bool(res_t.feasible)
        n_same += np.array_equal(res_t.sel.numpy(), np.asarray(res_j.sel))
        scale = 1.0 + abs(float(res_j.obj))
        n_tight += abs(float(res_t.bound) - float(res_j.bound)) <= 1e-3 * scale
        # an early-stopped root LP still bounds the objective it rounds to
        assert float(res_t.bound) <= float(res_t.obj) + 1e-2 * scale
        # the duals pass through untouched
        assert torch.equal(res_t.lam, tst.lam)
    assert n_same >= len(forests) - 1
    assert n_tight > len(forests) // 2


LAG_VARIANTS = ["default", "participate", "lam0", "no_clusters"]


@pytest.mark.parametrize("variant", LAG_VARIANTS)
def test_select_lagrangian_matches_jax(scene, variant):
    shapes, params, jshapes, jparams, forests, jforests = scene
    rng = np.random.default_rng(3)
    S = forests[0].lam.shape[0]
    # every forest with the defaults, the conflicted middle of the run
    # with the options
    pick = slice(None) if variant == "default" else slice(2, 5)
    for tst, jst in zip(forests[pick], jforests[pick]):
        kw_t, kw_j = {}, {}
        if variant == "participate":
            # a union of whole clusters: the targets of every cluster of
            # two or more
            labels, _ = tsel.cluster(tst, shapes)
            part = tsel.cluster_sizes(labels, tst.tgt_mask) >= 2
            kw_t = dict(participate=part, obj_offset=-3.5)
            kw_j = dict(participate=jnp.asarray(part.numpy()),
                        obj_offset=-3.5)
        elif variant == "lam0":
            lam0 = np.where(rng.random(S) < 0.1, rng.random(S), 0.0) \
                .astype(np.float32)
            kw_t = dict(lam0=torch.from_numpy(lam0), iters=20, patience=3)
            kw_j = dict(lam0=jnp.asarray(lam0), iters=20, patience=3)
        elif variant == "no_clusters":
            kw_t = kw_j = dict(with_clusters=False, repair_cadence=2)
        res_t = tsel.select_lagrangian(tst, shapes, params, **kw_t)
        # not under jit: on forests where the loop does not converge the
        # duals are chaotic, and XLA's fusions under jit round otherwise
        res_j = jax.device_get(jsel.select_lagrangian(jst, jshapes, jparams,
                                                      **kw_j))
        _check(res_t, res_j, lam_tol=1e-3)
        np.testing.assert_array_equal(res_t.sel.numpy(),
                                      np.asarray(res_j.sel))
        if variant == "no_clusters":
            assert int(res_t.n_clusters) == -1 and not res_t.labels.any()


@pytest.mark.parametrize("fast_path", [True, False])
@pytest.mark.parametrize("method", ["ipm", "lagrangian", "lagrangian_pure",
                                    "greedy"])
def test_select_dispatches_all_methods(scene, method, fast_path):
    shapes, params, jshapes, jparams, forests, jforests = scene
    sel_j = jax.jit(lambda st: jsel.select(st, jshapes, jparams,
                                           method=method,
                                           fast_path=fast_path))
    for tst, jst in zip(forests[1:4], jforests[1:4]):
        res_t = tsel.select(tst, shapes, params, method=method,
                            fast_path=fast_path)
        _check(res_t, jax.device_get(sel_j(jst)),
               bound_rtol=IPM_BOUND_RTOL if method == 'ipm' else 1e-3)


def test_select_defaults_are_the_jax_packages(scene):
    """``select`` defaults to 'ipm' on both sides; without clusters the
    slow branch of 'ipm' and 'lagrangian_pure' returns the dispatcher's
    placeholder labels, as in JAX."""
    import inspect
    for fn_t, fn_j in ((tsel.select, jsel.select),
                       (tsel.select_ipm, jsel.select_ipm),
                       (tsel.select_lagrangian, jsel.select_lagrangian)):
        dt = {k: p.default for k, p in
              inspect.signature(fn_t).parameters.items()}
        dj = {k: p.default for k, p in
              inspect.signature(fn_j).parameters.items()}
        assert dt == dj, fn_t.__name__
    shapes, params, _, _, forests, _ = scene
    tst = next(st for st in forests
               if not bool(tsel._independent_best(st, shapes, params)[2]))
    a = tsel.select(tst, shapes, params)
    b = tsel.select(tst, shapes, params, method='ipm')
    assert torch.equal(a.sel, b.sel) and float(a.obj) == float(b.obj)
    for method in ("ipm", "lagrangian_pure"):
        res = tsel.select(tst, shapes, params, method=method,
                          compute_clusters=False)
        assert int(res.n_clusters) == -1 and not res.labels.any()
    with pytest.raises(ValueError):
        tsel.select(tst, shapes, params, method="simplex")


def test_select_lagrangian_reads_one_flag_per_round(scene):
    """Host reads of the pure Lagrangian: one per iteration, one more on
    the repair cadence, one per repair round after the first; bounded by
    the loop's budget."""
    shapes, params, _, _, forests, _ = scene
    for tst in forests:
        n0 = sync.count
        tsel.select_lagrangian(tst, shapes, params, iters=10,
                               with_clusters=False)
        # seed repair <= 7, then per iteration 1 + (cadence: 1 + <= 7)
        assert 1 <= sync.count - n0 <= 7 + 1 + 10 + 3 * 8

"""The port's target-sharded tracker step (pymht_tpu_torch/parallel/
sharded_tracker.py) against the JAX package's and against the port's own
single-device ``scan_step``.

The scenes are tests/test_distributed_select.py's sharded-step tests:
radar only (also with ``prune_similar``), AIS fusion with AIS-aided
initiation, and the on-device dynamic window.  JAX's
``make_sharded_tracker_step`` steps them on its virtual CPU mesh in this
process (radar only at 2 and 4 devices, the others at 4); the port's
steps them once per module on four gloo CPU ranks, at 2 and 4 ranks,
checking after every scan that the replicated state (duals, next id,
initiator state) is bitwise equal on every rank.  Against JAX at the
same rank count: labels, AIS labels, track ids and ``next_id`` equal,
states within 1e-4, ``tgt_window`` equal.  Against the port's
single-device step (whose slots of new targets differ: insertion is
round-robin over the ranks), the same per track id.

A reduced swarm scene (T=64, 40 live targets, M=64, AIS on) runs at 2
ranks against the single-device step; there the AIS association density
must use the global live-target count: grown with each rank's local
count, the AIS candidates score otherwise.

A lifecycle scene (a track leaving the radar's range, two initiated)
runs too, and for every scene the gathered outputs, absorbed by the
Tracker's own archive (``Tracker._absorb_outputs``), archive what the
single-device step's outputs do.
"""
import contextlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from pymht_tpu.core import initiator as jinit  # noqa: E402
from pymht_tpu.core.config import (  # noqa: E402
    TrackerParams as JParams, TrackerShapes as JShapes)
from pymht_tpu.core.grow import (  # noqa: E402
    AisBatch as JAisBatch, Scan as JScan, empty_ais as jempty_ais)
from pymht_tpu.core.state import (  # noqa: E402
    empty_state as jempty_state, insert_targets as jinsert)
from pymht_tpu.models import pv as jpv  # noqa: E402
from pymht_tpu.parallel.sharded_tracker import (  # noqa: E402
    make_sharded_tracker_step as jmake_step)
from pymht_tpu_torch.core import initiator as initiator_mod  # noqa: E402
from pymht_tpu_torch.core.config import (  # noqa: E402
    TrackerParams, TrackerShapes)
from pymht_tpu_torch.core.grow import AisBatch, Scan  # noqa: E402
from pymht_tpu_torch.core.state import state_from_numpy  # noqa: E402
from pymht_tpu_torch.core.tracker import Tracker, scan_step  # noqa: E402
from pymht_tpu_torch.utils import simulator as sim  # noqa: E402
from tests.torch_dist_worker import (  # noqa: E402
    config_json, launch, numpy_fields)

STATE_ATOL = 1e-4
# the step outputs a Tracker's track archive reads (_absorb_outputs)
ARCHIVE_FIELDS = ("track_mask", "track_id", "dead", "dead_reason",
                  "sel_hist_valid", "sel_hist_x", "sel_hist_meas",
                  "sel_hist_mmsi", "confirmed_mask", "confirmed_x",
                  "confirmed_meas", "confirmed_mmsi", "inserted_mask",
                  "inserted_id", "inserted_P")
LIMITLESS = dict(radar_range=float('inf'), cnllr_upper_limit=1e9,
                 score_upper_limit_scale=1e6)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def jax_compiles_once():
    """JAX's ``make_sharded_tracker_step`` and ``make_distributed_select``
    wrap their function in a new ``shard_map`` on every call, so
    ``jax.jit`` traces and compiles every scan anew (3-5 s each on the
    CPU).  Inside this block ``jax.shard_map`` hands back the same wrapped
    function for the same (function, mesh): each step compiles once, and
    no number changes."""
    real, memo = jax.shard_map, {}

    def shard_map(f, *args, mesh, **kw):
        if (f, id(mesh)) not in memo:
            memo[(f, id(mesh))] = (real(f, *args, mesh=mesh, **kw), mesh)
        return memo[(f, id(mesh))][0]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "shard_map", shard_map)
        yield


def _placed(tree, mesh, spec):
    """``tree`` on ``mesh`` with ``spec(x)``: the first scan's inputs laid
    out as the step's outputs are, so that one compile serves every
    scan."""
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, NamedSharding(mesh, spec(x))), tree)


def _seed(shapes, params, xs, mmsi=None):
    """The JAX forest with the targets ``xs`` in its first slots."""
    T = shapes.max_targets
    x = np.zeros((T, 4), np.float32)
    x[:len(xs)] = xs
    mask = np.arange(T) < len(xs)
    mm = np.zeros(T, np.int32)
    if mmsi is not None:
        mm[:len(mmsi)] = mmsi
    return jinsert(jempty_state(shapes, params), jnp.asarray(x),
                   jnp.broadcast_to(jpv.P0, (T, 4, 4)), jnp.asarray(mask),
                   jnp.asarray(mm), jnp.asarray(0.0), params)


def _padded(z, M, t):
    zp = np.zeros((M, 2), np.float32)
    zp[:len(z)] = z
    return dict(z=zp, mask=np.arange(M) < len(z),
                time=np.asarray(t, np.float32))


def _radar_scene():
    """test_sharded_scan_step_matches_single_device's scene."""
    kw = dict(max_targets=8, max_leaves=8, max_meas=16, max_ais=2, window=5)
    pkw = dict(radar_period=2.5, P_d=0.9, lambda_phi=1e-6, lambda_nu=1e-6,
               N=3, **LIMITLESS)
    rng = np.random.default_rng(5)
    xs = np.zeros((4, 4), np.float32)
    for i in range(4):
        xs[i, :2] = [30 * i, 3.0 * (i % 2)]
        xs[i, 2:] = [2.0, 0.0]
    scans = []
    for k in range(4):
        t = 2.5 * (k + 1)
        z = np.concatenate([
            xs[:, :2] + xs[:, 2:] * t + rng.normal(0, 1.0, (4, 2)),
            xs[:2, :2] + xs[:2, 2:] * t + np.array([0., 2.5])
            + rng.normal(0, 1.0, (2, 2))]).astype(np.float32)
        scans.append(_padded(z, 16, t))
    return kw, pkw, xs, None, scans, None


def _ais_scene():
    """test_sharded_scan_step_matches_single_device_with_ais's scene: two
    targets with transponders, one message of no track."""
    kw = dict(max_targets=8, max_leaves=8, max_meas=16, max_ais=4,
              window=5, max_prelim=8, max_initiators=16, ais_per_leaf=2)
    pkw = dict(radar_period=2.5, P_d=0.9, lambda_phi=1e-6, lambda_nu=1e-6,
               N=3, **LIMITLESS)
    rng = np.random.default_rng(9)
    xs = np.zeros((4, 4), np.float32)
    for i in range(4):
        xs[i, :2] = [40 * i, 4.0 * (i % 2)]
        xs[i, 2:] = [2.0, 0.5]
    mmsi = np.array([111000001, 111000002, 0, 0], np.int32)
    scans, batches = [], []
    for k in range(4):
        t = 2.5 * (k + 1)
        z = (xs[:, :2] + xs[:, 2:] * t
             + rng.normal(0, 1.0, (4, 2))).astype(np.float32)
        scans.append(_padded(z, 16, t))
        ast = np.zeros((4, 4), np.float32)
        ast[0] = xs[0] + np.concatenate([xs[0, 2:] * (t - 0.9), [0, 0]])
        ast[1] = xs[1] + np.concatenate([xs[1, 2:] * (t - 1.4), [0, 0]])
        ast[2] = [500.0 + 2.0 * t, 300.0, 2.0, 0.0]
        batches.append(dict(
            state=ast,
            time=np.asarray([t - 0.9, t - 1.4, t - 1.0, 0.0], np.float32),
            mmsi=np.asarray([111000001, 111000002, 222000009, 0], np.int32),
            high_accuracy=np.asarray([True, False, True, False]),
            mask=np.asarray([True, True, True, False])))
    return kw, pkw, xs, mmsi, scans, batches


def _window_scene():
    """test_sharded_dynamic_window_matches_single_device's scene: one
    clutter-saturated target, one coasting."""
    kw = dict(max_targets=8, max_leaves=4, max_meas=16, max_ais=2, window=6)
    pkw = dict(radar_period=2.5, P_d=0.9, lambda_phi=1e-6, lambda_nu=1e-6,
               N=4, **LIMITLESS)
    rng = np.random.default_rng(2)
    xs = np.array([[0.0, 0.0, 1.0, 0.0], [200.0, 200.0, -1.0, 0.0]],
                  np.float32)
    scans = []
    for k in range(5):
        t = 2.5 * (k + 1)
        z = (np.array([[t, 0.0]])
             + rng.normal(0, 1.5, (8, 2))).astype(np.float32)
        scans.append(_padded(z, 16, t))
    return kw, pkw, xs, None, scans, None


def _lifecycle_scene():
    """Tracks that end and begin: of two seeded targets one leaves the
    radar's range (dies OutOfRange at scan 2); two unseeded ones are
    initiated from scan 4 and dealt round-robin over the ranks, so their
    slots differ from the single-device step's."""
    kw = dict(max_targets=8, max_leaves=8, max_meas=16, max_ais=2, window=4)
    pkw = dict(radar_period=2.5, P_d=0.9, lambda_phi=1e-6, lambda_nu=1e-6,
               N=3, radar_range=300.0)
    rng = np.random.default_rng(11)
    xs = np.array([[250.0, 0.0, 15.0, 0.0], [0.0, 50.0, 0.0, 2.0]],
                  np.float32)
    new = np.array([[-100.0, -100.0, 3.0, 1.0], [100.0, -150.0, -2.0, 2.0]],
                   np.float32)
    scans = []
    for k in range(9):
        t = 2.5 * (k + 1)
        pos = [p for p in xs[:, :2] + xs[:, 2:] * t if np.hypot(*p) < 300]
        pos += list(new[:, :2] + new[:, 2:] * t)
        z = (np.array(pos) + rng.normal(0, 1.0, (len(pos), 2))).astype(
            np.float32)
        scans.append(_padded(z, 16, t))
    return kw, pkw, xs, None, scans, None


# case -> (scene, step options, the port's rank counts, JAX's)
CASES = {
    "radar": (_radar_scene, {}, (2, 4), (2, 4)),
    "ais": (_ais_scene, dict(use_ais=True), (2, 4), (4,)),
    "window": (_window_scene, dict(dynamic_window=True), (2, 4), (4,)),
    "prune": (_radar_scene, dict(prune_similar=True), (2, 4), (4,)),
    "lifecycle": (_lifecycle_scene, {}, (2, 4), (2,)),
}
JAX_RUNS = [(c, n) for c, (_, _, _, jr) in CASES.items() for n in jr]
PORT_RUNS = [(c, n) for c, (_, _, pr, _) in CASES.items() for n in pr]


def _jax_run(scene, opts, n):
    kw, pkw, xs, mmsi, scans, batches = scene
    shapes, params = JShapes(**kw), JParams(**pkw)
    mesh = Mesh(np.array(jax.devices()[:n]), ('cluster',))
    step = jmake_step(mesh, shapes, params, **opts)
    T = shapes.max_targets
    st = _placed(_seed(shapes, params, xs, mmsi), mesh,
                 lambda x: P('cluster') if x.ndim and x.shape[0] == T
                 else P())
    ist = _placed(jinit.empty_initiator(shapes), mesh, lambda x: P())
    outs = []
    for k, sc in enumerate(scans):
        ab = (JAisBatch(**{f: jnp.asarray(v) for f, v in batches[k].items()})
              if batches else jempty_ais(shapes))
        st, ist, o = step(st, ist, JScan(**{f: jnp.asarray(v)
                                            for f, v in sc.items()}), ab)
        o = {f: np.asarray(v) for f, v in o.items()}
        o["sel_ais"] = np.asarray(st.hist_ais)[
            np.arange(shapes.max_targets), np.asarray(st.sel_leaf), -1]
        outs.append(o)
    final = {f: np.asarray(getattr(st, f))
             for f in ("tgt_window", "tgt_id", "next_id")}
    return outs, final


def _port_single(shapes, params, state, scans, ais, opts):
    """The port's single-device scan_step on the same inputs."""
    st, ist = state, initiator_mod.empty_initiator(shapes, "cpu")
    outs = []
    for sc, ab in zip(scans, ais):
        st, ist, o = scan_step(st, ist, sc, ab, shapes, params,
                               method='lagrangian',
                               use_ais=opts.get("use_ais", False),
                               dynamic_window=opts.get("dynamic_window",
                                                       False),
                               prune_similar=opts.get("prune_similar", False))
        o = {f: getattr(o, f).numpy()
             for f in ("track_x", "sel_obj", *ARCHIVE_FIELDS)}
        o["sel_ais"] = st.hist_ais[torch.arange(st.sel_leaf.shape[0]),
                                   st.sel_leaf.long(), -1].numpy()
        o["post_id"] = st.tgt_id.numpy()
        outs.append(o)
    return outs, {f: getattr(st, f).numpy()
                  for f in ("tgt_window", "tgt_id", "next_id")}


def _archive(outs):
    """``Tracker._absorb_outputs`` run over a run's outputs, on an object
    with only the attributes it reads: (live archives, terminated
    archives, initial covariances), each by track id."""
    from types import SimpleNamespace
    ar = SimpleNamespace(shapes=SimpleNamespace(
        window=outs[0]["sel_hist_meas"].shape[1]), scan_times=[],
        archives={}, terminated={}, init_P={})
    for k, o in enumerate(outs):
        ar.scan_times.append(float(k))
        Tracker._absorb_outputs(ar, SimpleNamespace(
            **{f: o[f] for f in ARCHIVE_FIELDS}), n_scans=k + 1)
    return ar.archives, ar.terminated, ar.init_P


def _torch_inputs(scene):
    kw, pkw, xs, mmsi, scans, batches = scene
    ts = [Scan(**{f: torch.from_numpy(np.asarray(v)) for f, v in s.items()})
          for s in scans]
    ta = ([AisBatch(**{f: torch.from_numpy(v) for f, v in b.items()})
           for b in batches] if batches else [None] * len(scans))
    return ts, ta


def _swarm_scene():
    """A cut of tests/test_sharded_swarm.py's scene: T=64 slots, 40 live
    targets, half with transponders, M=64, A=32, G=2, W=5, seed 42, in a
    2 km radar (so that no scan overflows M)."""
    shapes = TrackerShapes(max_targets=64, max_leaves=8, max_meas=64,
                           max_ais=32, window=5, max_prelim=32,
                           max_initiators=64, ais_per_leaf=2)
    params = TrackerParams(radar_period=2.5, P_d=0.9, lambda_phi=1.5e-6,
                           lambda_nu=1e-6, N=3, radar_range=2000.0)
    n_tgt, n_scans, period = 40, 3, 2.5
    rng = np.random.default_rng(42)
    targets = sim.generate_initial_targets(
        rng, n_tgt, (0.0, 0.0), params.radar_range * 0.5, 0.9, 0.1,
        assign_mmsi=True, P_r=0.5)
    sim_list = sim.simulate_targets(rng, targets,
                                    sim_time=n_scans * period, dt=period)
    scans = sim.simulate_scans(rng, sim_list, period, sigma_R=2.5,
                               lambda_phi=1.5e-6,
                               radar_range=params.radar_range,
                               p0=(0.0, 0.0), lambda_local=0.1)
    groups = sim.simulate_ais(rng, sim_list, period,
                              init_time=sim_list[0][0].time)
    F_inv = np.eye(4)
    F_inv[0, 2] = F_inv[1, 3] = -period
    tr = Tracker(shapes, params, use_ais=True, device="cpu")
    tr.pre_initialize(scans[0].time - period,
                      [F_inv @ t.state for t in targets],
                      mmsi=[t.mmsi for t in targets])
    scan_b, ais_b = tr.make_stream_inputs(scans[:n_scans], groups[:n_scans])
    return (shapes, params, tr.state,
            [Scan(*(f[i] for f in scan_b)) for i in range(n_scans)],
            [AisBatch(*(f[i] for f in ais_b)) for i in range(n_scans)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case through JAX, the port's single-device step and the
    port's ranks (one launch)."""
    scenes = {c: spec[0]() for c, spec in CASES.items()}
    with jax_compiles_once():
        jax_out = {(c, n): _jax_run(scenes[c], CASES[c][1], n)
                   for c, n in JAX_RUNS}
    inputs, single = {}, {}
    for c, (_, opts, ranks, _) in CASES.items():
        kw, pkw, xs, mmsi, scans, batches = scenes[c]
        shapes, params = JShapes(**kw), JParams(**pkw)
        seed = numpy_fields(_seed(shapes, params, xs, mmsi))
        inputs.update({f"{c}.state.{k}": v for k, v in seed.items()})
        for k, sc in enumerate(scans):
            inputs.update({f"{c}.scan{k}.{f}": v for f, v in sc.items()})
            if batches:
                inputs.update({f"{c}.ais{k}.{f}": v
                               for f, v in batches[k].items()})
        inputs[f"{c}.config"] = config_json(shapes, params)
        inputs[f"{c}.opts"] = np.array(json.dumps(dict(
            n_scans=len(scans), ranks=list(ranks), step=opts)))
        ts, ta = _torch_inputs(scenes[c])
        single[c] = _port_single(TrackerShapes(**kw), TrackerParams(**pkw),
                                 state_from_numpy(seed, "cpu"), ts, ta, opts)
    shapes, params, state, scans, ais = _swarm_scene()
    inputs.update(numpy_fields(state, "swarm.state."))
    for k, (sc, ab) in enumerate(zip(scans, ais)):
        inputs.update(numpy_fields(sc, f"swarm.scan{k}."))
        inputs.update(numpy_fields(ab, f"swarm.ais{k}."))
    inputs["swarm.config"] = config_json(shapes, params)
    inputs["swarm.opts"] = np.array(json.dumps(dict(
        n_scans=len(scans), ranks=[2], step=dict(use_ais=True),
        swarm=True)))
    single["swarm"] = _port_single(shapes, params, state, scans, ais,
                                   dict(use_ais=True))
    inputs["cases"] = np.array(",".join([*CASES, "swarm"]))
    d = tmp_path_factory.mktemp("sharded_tracker")
    np.savez(d / "in.npz", **inputs)
    outs = launch("tracker", 4, str(d / "in.npz"), str(d))
    return jax_out, single, outs[0]


def _port_scans(port, case, n):
    k, outs = 0, []
    while f"{case}.{n}.scan{k}.track_mask" in port:
        pre = f"{case}.{n}.scan{k}."
        outs.append({key[len(pre):]: v for key, v in port.items()
                     if key.startswith(pre)})
        k += 1
    pre = f"{case}.{n}.final."
    return outs, {key[len(pre):]: v for key, v in port.items()
                  if key.startswith(pre)}


@pytest.mark.parametrize("case,n", JAX_RUNS)
def test_matches_jax(runs, case, n):
    jax_out, _, port = runs
    (j_outs, j_final), (p_outs, p_final) = jax_out[(case, n)], \
        _port_scans(port, case, n)
    assert len(p_outs) == len(j_outs)
    for k, (j, p) in enumerate(zip(j_outs, p_outs)):
        what = f"{case} at {n} ranks, scan {k}"
        live = j["track_mask"]
        for f in ("track_mask", "track_id", "sel_ais", "dead",
                  "confirmed_mask", "confirmed_meas"):
            np.testing.assert_array_equal(p[f], j[f], err_msg=f"{what} {f}")
        np.testing.assert_array_equal(p["sel_hist_meas"][live],
                                      j["sel_hist_meas"][live], err_msg=what)
        np.testing.assert_allclose(p["track_x"][live], j["track_x"][live],
                                   rtol=0, atol=STATE_ATOL, err_msg=what)
        assert bool(p["sel_feasible"]) == bool(j["sel_feasible"])
        assert abs(float(p["sel_obj"]) - float(j["sel_obj"])) \
            <= 1e-5 * (1 + abs(float(j["sel_obj"]))), what
    for f in ("tgt_window", "tgt_id", "next_id"):
        np.testing.assert_array_equal(p_final[f], j_final[f],
                                      err_msg=f"{case} at {n} ranks {f}")


def _by_track(o, sel_ais_ok):
    """{track id: (labels, AIS label or None, state)} of the live tracks;
    the AIS label only where the slot still holds that track after the
    step."""
    out = {}
    for t in np.flatnonzero(o["track_mask"]):
        tid = int(o["track_id"][t])
        ais = int(o["sel_ais"][t]) if sel_ais_ok[t] else None
        out[tid] = (tuple(o["sel_hist_meas"][t]), ais, o["track_x"][t])
    return out


def _check_against_single(single, p_outs, p_final, p_ids, what):
    s_outs, s_final = single
    assert len(p_outs) == len(s_outs)
    for k, (s, p) in enumerate(zip(s_outs, p_outs)):
        a = _by_track(s, s["post_id"] == s["track_id"])
        b = _by_track(p, p_ids[k] == p["track_id"])
        assert sorted(a) == sorted(b), f"{what} scan {k}: track ids"
        for tid in a:
            assert a[tid][0] == b[tid][0], f"{what} scan {k} track {tid}"
            if a[tid][1] is not None and b[tid][1] is not None:
                assert a[tid][1] == b[tid][1], \
                    f"{what} scan {k} track {tid}: AIS label"
            np.testing.assert_allclose(b[tid][2], a[tid][2], rtol=0,
                                       atol=STATE_ATOL,
                                       err_msg=f"{what} scan {k} {tid}")
        assert abs(float(p["sel_obj"]) - float(s["sel_obj"])) \
            <= 1e-4 * (1 + abs(float(s["sel_obj"]))), f"{what} scan {k}"
    assert int(p_final["next_id"]) == int(s_final["next_id"]), what
    live = p_final["tgt_id"] >= 0
    assert sorted(p_final["tgt_id"][live]) == \
        sorted(s_final["tgt_id"][s_final["tgt_id"] >= 0]), what
    # each live track keeps its window
    win_p = dict(zip(p_final["tgt_id"][live], p_final["tgt_window"][live]))
    win_s = {i: w for i, w in zip(s_final["tgt_id"], s_final["tgt_window"])
             if i >= 0}
    assert win_p == win_s, what


def _post_ids(port, case, n, n_scans):
    """The slot ids after each scan: the next scan's pre-step ids (the
    last scan's from the final state)."""
    outs, final = _port_scans(port, case, n)
    ids = [outs[k + 1]["track_id"] for k in range(n_scans - 1)]
    return ids + [final["tgt_id"]]


@pytest.mark.parametrize("case,n", PORT_RUNS + [("swarm", 2)])
def test_matches_single_device_step(runs, case, n):
    _, single, port = runs
    p_outs, p_final = _port_scans(port, case, n)
    _check_against_single(single[case], p_outs, p_final,
                          _post_ids(port, case, n, len(p_outs)),
                          f"{case} at {n} ranks")


@pytest.mark.parametrize("case,n", PORT_RUNS + [("swarm", 2)])
def test_gathered_outputs_feed_the_tracker_archive(runs, case, n):
    """The sharded step's gathered outputs, absorbed by the Tracker's own
    archive, archive what the single-device step's do: the same track
    ids live and terminated (with their status), the same confirmed and
    final-window labels, times and MMSIs, states within STATE_ATOL, the
    same initial covariances."""
    _, single, port = runs
    p_outs, _ = _port_scans(port, case, n)
    got, want = _archive(p_outs), _archive(single[case][0])
    what = f"{case} at {n} ranks"
    for g, w in zip(got[:2], want[:2]):
        assert sorted(g) == sorted(w), what
        for tid in w:
            a, b = g[tid], w[tid]
            assert (a.times, a.meas, a.mmsi, a.status) == \
                (b.times, b.meas, b.mmsi, b.status), f"{what} track {tid}"
            np.testing.assert_allclose(
                np.reshape(a.states, (-1, 4)), np.reshape(b.states, (-1, 4)),
                rtol=0, atol=STATE_ATOL, err_msg=f"{what} track {tid}")
    assert sorted(got[2]) == sorted(want[2]), what
    for tid, P_ in want[2].items():
        np.testing.assert_allclose(got[2][tid], P_, rtol=0, atol=STATE_ATOL,
                                   err_msg=f"{what} track {tid}")
    assert want[0], f"{what}: no track archived"


def test_the_scenes_take_their_branches(runs):
    """AIS fusion happened in the AIS scene, the window shrank for the
    saturated target and not for the coasting one, and the swarm scene
    made an AIS association."""
    jax_out, single, port = runs
    ais_outs, _ = _port_scans(port, "ais", 4)
    assert any((o["sel_ais"][o["track_mask"]] > 0).any() for o in ais_outs)
    _, final = _port_scans(port, "window", 4)
    assert final["tgt_window"][0] < 4 and final["tgt_window"][1] == 4
    sw, _ = _port_scans(port, "swarm", 2)
    assert any((o["sel_ais"][o["track_mask"]] > 0).any() for o in sw)


def test_swarm_ais_density_is_global(runs):
    """Grown with each rank's local live-target count instead of the
    global one, the AIS candidates would score otherwise: the sharded
    step's agreement with the single-device step depends on it."""
    _, _, port = runs
    g, loc = port["swarm.2.grow_global"], port["swarm.2.grow_local"]
    assert g.shape == loc.shape == (64, 8)
    assert not np.array_equal(g, loc)

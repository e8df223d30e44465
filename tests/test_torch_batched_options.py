"""The port's batched step with the options it took last: the AIS branch,
the spatial pre-gate and the 'ipm' / 'lagrangian_pure' solvers, alone and
together, against the JAX package's vmapped step
(``jax.jit(pymht_tpu.parallel.scenario.make_batched_step(...))``, one
compile per configuration in a module fixture) and against each scenario
stepped alone in the port; then ``run_batch(method='ipm')`` against the
JAX function, and two scenarios that share an MMSI.

Three numpy-seeded scenarios, each with its own scan period, go into one
batch: 'pairs' (two pairs of ships 5 m apart whose AIS messages either
ship may take, so the conflicts sit on AIS slots, and a lone ship),
'converging' (six targets meeting in clutter: radar conflicts; one
reports by AIS) and 'initiate' (two targets far apart, the fast path, and
a ship nobody seeded whose AIS messages start a track).  The unseeded
ship shares its MMSI with the reporting ship of 'converging'.

Required, scan by scan: integer and boolean outputs and states equal
(labels, selected leaves, masks, ids); floats within STATE_RTOL /
STATE_ATOL; objectives within 1e-4 (1 + |obj|); the 'ipm' bound within
IPM_BOUND_RTOL (1 + |obj|), as tests/test_torch_select_ipm.py holds it.
In f32 the root LP of 'ipm' loses definiteness before its optimum, and
XLA's and LAPACK's Cholesky give up one round apart on some programs
(ROADMAP, queue 3): the "bound" is then that round's primal iterate and
lies ABOVE the objective.  Where both compared bounds lie above their
objectives they are only required to (on the 'pairs' forest of scan 1
under every option the port's root LP stops after 4 rounds, XLA's after
5, and the two values differ by 1.6 % of 1 + |obj|).  The batch must
equal each scenario stepped alone in the port on the same terms.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from pymht_tpu.core import config as jconfig  # noqa: E402
from pymht_tpu.core import grow as jgrow  # noqa: E402
from pymht_tpu.core.initiator import InitiatorState as JInit  # noqa: E402
from pymht_tpu.core import tracker as jtracker  # noqa: E402
from pymht_tpu.core.state import TrackerState as JState  # noqa: E402
from pymht_tpu.parallel import montecarlo as jmc  # noqa: E402
from pymht_tpu.parallel import scenario as jscenario  # noqa: E402
from pymht_tpu_torch import sync  # noqa: E402
from pymht_tpu_torch.core.config import (  # noqa: E402
    TrackerParams, TrackerShapes)
from pymht_tpu_torch.core.grow import AisBatch, Scan  # noqa: E402
from pymht_tpu_torch.core.state import (  # noqa: E402
    initiator_to_numpy, state_to_numpy)
from pymht_tpu_torch.core.tracker import scan_step  # noqa: E402
from pymht_tpu_torch.parallel import montecarlo as mc  # noqa: E402
from pymht_tpu_torch.parallel.scenario import make_batched_step  # noqa: E402
from pymht_tpu_torch.utils import simulator as sim  # noqa: E402
from pymht_tpu_torch.utils.scenes import batch_scene  # noqa: E402

SHAPES = TrackerShapes(max_targets=8, max_leaves=8, max_meas=32, max_ais=4,
                       window=5, max_prelim=8, max_initiators=32,
                       ais_per_leaf=2)
PARAMS = TrackerParams(radar_period=2.5, P_d=0.9, lambda_phi=4e-5,
                       lambda_nu=1e-5, N=3, radar_range=400.0)
KM = 8                         # radar_cand_width of the pre-gated cases
N_SCANS = 5
SHARED_MMSI = 309999999
STATE_RTOL, STATE_ATOL = 1e-5, 2e-3
OBJ_RTOL = 1e-4
IPM_BOUND_RTOL = 1e-2

# (method, use_ais, radar_cand_width) of each case
CASES = {"ais": ("lagrangian", True, 0),
         "pregate": ("lagrangian", False, KM),
         "ipm": ("ipm", False, 0),
         "lagrangian_pure": ("lagrangian_pure", False, 0),
         "all": ("ipm", True, KM)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Thousands of tiny ops: no intra-op thread pool (six test workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KINDS = ("pairs", "converging", "initiate")


class _Scan(tuple):
    """What ``batch_scene`` reads of a simulated scan."""
    time = property(lambda s: s[0])
    measurements = property(lambda s: s[1])


def _draw(kind, seed):
    """(scans, AIS groups, seeds, MMSIs, truth) of one scenario."""
    rng = np.random.default_rng(seed)
    period = {"pairs": 2.5, "converging": 2.0, "initiate": 3.0}[kind]
    F = np.eye(4)
    F[0, 2] = F[1, 3] = period
    Fa = np.eye(4)
    Fa[0, 2] = Fa[1, 3] = 0.6 * period
    if kind == "pairs":
        xs = [np.array(v, float) for v in (
            (0, 0, 5, 0), (0, 5, 5, 0), (200, 100, -4, 2), (203, 104, -4, 2),
            (-150, -80, 0, 6))]
        n_seeded, talkers = 5, None
    elif kind == "converging":
        ang = np.linspace(0, 2 * np.pi, 6, endpoint=False)
        xs = [np.array([40 * np.cos(a), 40 * np.sin(a), -4 * np.cos(a),
                        -4 * np.sin(a)]) for a in ang]
        n_seeded, talkers = 6, (2,)
    else:
        xs = [np.array(v, float) for v in (
            (-250, 150, 3, 0), (220, -180, 0, 4), (30, -60, -2, 3))]
        n_seeded, talkers = 2, (2,)
    mmsi = [301000001 + 1000000 * KINDS.index(kind) + k
            for k in range(len(xs))]
    if kind != "pairs":
        mmsi[2] = SHARED_MMSI          # the other scenario's ship has it too
    scans, groups, truth = [], [], []
    F_inv = np.linalg.inv(F)
    seeds = [F_inv @ x for x in xs[:n_seeded]]
    for i in range(N_SCANS):
        t = (i + 1) * period
        if talkers is None:            # one ship of each pair and the lone
            who = (int(rng.integers(0, 2)), 2 + int(rng.integers(0, 2)), 4)
        else:
            who = talkers
        groups.append([sim.AisMessage(
            state=Fa @ xs[k] + rng.normal(0, 1.0, 4) * [1, 1, .1, .1],
            time=t - 0.4 * period, mmsi=mmsi[k], highAccuracy=bool(k % 2))
            for k in who])
        xs = [F @ x for x in xs]
        truth.append([x.copy() for x in xs])
        z = [x[:2] + rng.normal(0, 1.5, 2) for x in xs
             if rng.random() < 0.9]
        z += [rng.uniform(-200, 200, 2) for _ in range(4)]
        scans.append(_Scan((t, np.asarray(z, np.float32))))
    return (scans, groups, seeds, None if kind == "pairs" else
            mmsi[:n_seeded], truth)



@pytest.fixture(scope="module")
def scene():
    return batch_scene(SHAPES, PARAMS, [_draw(k, 20 + i)
                                        for i, k in enumerate(KINDS)])


def _shapes(km):
    return dataclasses.replace(SHAPES, radar_cand_width=km)


def _jax_cfg(cfg):
    return getattr(jconfig, type(cfg).__name__)(**dataclasses.asdict(cfg))


def _to_jax(tree, cls):
    return cls(**{k: jnp.asarray(v) for k, v in tree.items()})


_CACHE = {}


def _cached(fn):
    """One run per scene and configuration in this module."""
    def run(scene, *args):
        key = (fn.__name__, id(scene), args)
        if key not in _CACHE:
            _CACHE[key] = fn(scene, *args)
        return _CACHE[key]
    return run


@_cached
def _run_port(scene, method, use_ais, km):
    """The batch through the port's batched step: per scan (state,
    initiator state, outputs, host reads)."""
    step = make_batched_step(_shapes(km), PARAMS, method=method,
                             use_ais=use_ais)
    st, ist, out = scene.state, scene.init_state, []
    for s in range(N_SCANS):
        n0 = sync.count
        st, ist, o = step(st, ist, *scene.scan(s))
        out.append((st, ist, o, sync.count - n0))
    return out


def _run_alone(scene, b, method, use_ais, km):
    st, ist, scans, ais = scene.scenario(b)
    out = []
    for s in range(N_SCANS):
        n0 = sync.count
        st, ist, o = scan_step(st, ist, Scan(*(f[s] for f in scans)),
                               AisBatch(*(f[s] for f in ais)), _shapes(km),
                               PARAMS, method=method, use_ais=use_ais)
        out.append((st, ist, o, sync.count - n0))
    return out


@_cached
def _run_jax(scene, method, use_ais, km):
    step = jax.jit(jscenario.make_batched_step(
        _jax_cfg(_shapes(km)), _jax_cfg(PARAMS), method=method,
        use_ais=use_ais))
    st = _to_jax(state_to_numpy(scene.state), JState)
    ist = _to_jax(initiator_to_numpy(scene.init_state), JInit)
    out = []
    for s in range(N_SCANS):
        sc, ais = scene.scan(s)
        st, ist, o = step(st, ist,
                          jgrow.Scan(*(jnp.asarray(f.numpy()) for f in sc)),
                          jgrow.AisBatch(*(jnp.asarray(f.numpy())
                                           for f in ais)))
        out.append(jax.device_get((st, ist, o)))
    return out


def _run_jax_alone(scene, b, method, use_ais, km):
    """Scenario ``b`` alone through the JAX package's jitted scan_step."""
    step = jax.jit(lambda st, ist, sc, ais: jtracker.scan_step(
        st, ist, sc, ais, _jax_cfg(_shapes(km)), _jax_cfg(PARAMS),
        method=method, use_ais=use_ais))
    st, ist, scans, ais = scene.scenario(b)
    st = _to_jax(state_to_numpy(st), JState)
    ist = _to_jax(initiator_to_numpy(ist), JInit)
    out = []
    for s in range(N_SCANS):
        st, ist, o = step(st, ist,
                          jgrow.Scan(*(jnp.asarray(f[s].numpy())
                                       for f in scans)),
                          jgrow.AisBatch(*(jnp.asarray(f[s].numpy())
                                           for f in ais)))
        out.append(jax.device_get((st, ist, o)))
    return out


@pytest.fixture(scope="module", params=list(CASES))
def runs(request, scene):
    """One case: the port's batch, each scenario alone, the JAX batch."""
    method, use_ais, km = CASES[request.param]
    port = _run_port(scene, method, use_ais, km)
    alone = [_run_alone(scene, b, method, use_ais, km)
             for b in range(len(KINDS))]
    return request.param, port, alone, _run_jax(scene, method, use_ais, km)


def _fields(tree):
    if isinstance(tree, dict):
        return tree
    if dataclasses.is_dataclass(tree):
        return {f.name: getattr(tree, f.name)
                for f in dataclasses.fields(tree)}
    return dict(zip(tree._fields, tree))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_close(a, b, what, ipm):
    """Field by field: integers and booleans equal, floats within
    tolerance; the selection's objective and bound by their own."""
    fa, fb = _fields(a), _fields(b)
    assert set(fa) == set(fb), what
    for name, x in fa.items():
        x, y = _np(x), _np(fb[name])
        assert x.shape == y.shape, (what, name)
        if name in ("sel_obj", "sel_bound"):
            tol = (IPM_BOUND_RTOL if ipm and name == "sel_bound"
                   else OBJ_RTOL)
            ok = np.abs(x - y) <= tol * (1.0 + np.abs(y))
            if ipm and name == "sel_bound":    # both early-stopped iterates
                ok |= (_above(x, _np(fa["sel_obj"]))
                       & _above(y, _np(fb["sel_obj"])))
            assert ok.all(), (what, name, x, y)
        elif np.issubdtype(x.dtype, np.floating):
            np.testing.assert_allclose(x, y, rtol=STATE_RTOL,
                                       atol=STATE_ATOL,
                                       err_msg=f"{what}: {name}")
        else:
            np.testing.assert_array_equal(x, y, err_msg=f"{what}: {name}")


def _above(bound, obj):
    """Where an 'ipm' bound lies above its objective: the root LP
    stopped before its optimum, and the value is no bound."""
    return bound > obj + OBJ_RTOL * (1.0 + np.abs(obj))


def _pick(tree, b):
    return {k: _np(v)[b] for k, v in _fields(tree).items()}


def _differs(a, b, ipm):
    try:
        _assert_close(a, b, "", ipm)
    except AssertionError:
        return True
    return False


def test_batch_matches_the_jax_vmapped_step(runs, scene):
    """Scenario by scenario and scan by scan against the JAX batch.  Under
    'lagrangian_pure' a subgradient loop that stops at its iteration cap
    short of the 0.1 % gap ends on duals that depend on rounding, and
    XLA's vmapped program rounds otherwise than its per-scenario one: on
    such a scenario the JAX package disagrees with itself, and the port's
    batch is held to the JAX per-scenario step (jitted) instead."""
    case, port, _, jx = runs
    method, use_ais, km = CASES[case]
    ipm = method == "ipm"
    own = {}
    for b, kind in enumerate(KINDS):
        for s in range(N_SCANS):
            jb = [_pick(t, b) for t in jx[s]]
            if method == "lagrangian_pure" and _differs(
                    _pick(port[s][2], b), jb[2], ipm):
                if b not in own:
                    own[b] = _run_jax_alone(scene, b, method, use_ais, km)
                ja = [_fields(t) for t in own[b][s]]
                assert _differs(ja[2], jb[2], ipm), \
                    f"{case}, {kind}, scan {s}: differs from the JAX batch"
                assert float(ja[2]["sel_bound"]) < float(ja[2]["sel_obj"])
                jb = ja
            what = f"{case}, scenario {kind}, scan {s}"
            for x, y, part in zip(port[s][:3], jb,
                                  ("state", "initiator", "outputs")):
                _assert_close(_pick(x, b), y, f"{what} {part}", ipm)
    assert len(own) <= 1


def test_batch_equals_each_scenario_alone(runs):
    case, port, alone, _ = runs
    ipm = CASES[case][0] == "ipm"
    for b, kind in enumerate(KINDS):
        for s in range(N_SCANS):
            st, ist, o, _ = port[s]
            st1, ist1, o1, _ = alone[b][s]
            what = f"{case}, scenario {kind}, scan {s}"
            _assert_close(_pick(o, b), _fields(o1), what + " outputs", ipm)
            _assert_close(_pick(st, b), _fields(st1), what + " state", ipm)
            _assert_close(_pick(ist, b), _fields(ist1), what + " initiator",
                          ipm)


def test_cases_exercise_their_option(runs):
    """Each case reaches what it is there for: a solver on some scan
    where another scenario takes the fast path, AIS labels selected with
    the AIS branch, and host reads that follow the slowest scenario, not
    all of them together.  (Under 'ipm' the batch's interior-point
    solves may end a round before or after the same solves alone, and
    branch-and-bound may then pop another number of nodes: the batched
    products round otherwise.  There the batch is only held between the
    fewest reads of a scenario alone and the sum.)"""
    case, port, alone, _ = runs
    method, use_ais, km = CASES[case]
    solved = np.array([[float(a[s][2].sel_obj) != float(a[s][2].sel_bound)
                        for s in range(N_SCANS)] for a in alone])
    assert (solved.any(axis=0) & ~solved.all(axis=0)).any(), \
        f"{case}: no scan mixes the fast path and the solver"
    if use_ais:
        assert any(bool((o.sel_hist_mmsi[..., -1] > 0).any())
                   for _, _, o, _ in port), f"{case}: no AIS label selected"
    reads = np.array([[a[s][3] for s in range(N_SCANS)] for a in alone])
    b_reads = np.array([p[3] for p in port])
    least = reads.min(axis=0) if method == "ipm" else reads.max(axis=0)
    assert (b_reads >= least).all(), (b_reads, reads)
    assert b_reads.sum() < reads.sum()


def test_shared_mmsi_stays_in_its_scenario(scene):
    """The used-MMSI filter of initiation works per scenario: 'initiate'
    seeds a prelim from the unseeded ship's first message on a scan where
    a leaf of 'converging' has just taken the same MMSI, as it does alone
    and in the JAX batch."""
    method, use_ais, km = CASES["ais"]
    port = _run_port(scene, method, use_ais, km)
    b_conv, b_init = KINDS.index("converging"), KINDS.index("initiate")
    alone = _run_alone(scene, b_init, method, use_ais, km)
    jx = _run_jax(scene, method, use_ais, km)
    st, ist, _, _ = port[0]
    assert bool((scene.ais.mmsi[b_init, 0] == SHARED_MMSI).any())
    assert bool(((st.hist_mmsi[b_conv, ..., -1] == SHARED_MMSI)
                 & st.leaf_mask[b_conv]).any()), \
        "'converging' did not take the shared MMSI on the first scan"
    assert bool((ist.p_mask[b_init]
                 & (ist.p_mmsi[b_init] == SHARED_MMSI)).any()), \
        "'initiate' did not seed a prelim from the shared MMSI"
    for s in range(N_SCANS):
        st, ist, _, _ = port[s]
        for name in ("p_mmsi", "p_mask"):
            np.testing.assert_array_equal(
                getattr(ist, name)[b_init].numpy(),
                getattr(alone[s][1], name).numpy())
            np.testing.assert_array_equal(
                getattr(ist, name).numpy(), np.asarray(getattr(jx[s][1],
                                                               name)))
        np.testing.assert_array_equal(st.tgt_mmsi.numpy(),
                                      np.asarray(jx[s][0].tgt_mmsi))
    assert bool((port[-1][0].tgt_mmsi[b_init] == SHARED_MMSI).any())


@pytest.fixture(scope="module")
def mc_draw():
    shape_kw = dict(max_targets=8, max_leaves=8, max_meas=24, max_ais=2,
                    window=5, max_prelim=8, max_initiators=24)
    param_kw = dict(radar_period=2.5, P_d=0.95, lambda_phi=1e-6,
                    lambda_nu=1e-5, N=3, radar_range=300.0)
    shapes, params = jconfig.TrackerShapes(**shape_kw), \
        jconfig.TrackerParams(**param_kw)
    sc = jmc.generate(jax.random.PRNGKey(3), batch=3, n_targets=4,
                      n_scans=5, shapes=shapes, params=params,
                      radar_range=300.0, sigma_Q=0.05, lambda_local=0.5)
    res = jax.device_get(jmc.run_batch(sc, shapes, params, method="ipm"))
    return (TrackerShapes(**shape_kw), TrackerParams(**param_kw),
            jax.device_get(sc), res)


def test_run_batch_ipm_matches_jax(mc_draw):
    shapes, params, sc_j, (state_j, xs_j, ms_j) = mc_draw
    sc = mc.McScenario(*(torch.from_numpy(np.array(a)) for a in sc_j))
    state_b, xs, ms = mc.run_batch(sc, shapes, params, method="ipm")
    np.testing.assert_array_equal(ms.numpy(), np.asarray(ms_j))
    np.testing.assert_allclose(xs.numpy(), np.asarray(xs_j), rtol=1e-4,
                               atol=1e-2)
    _assert_close(state_b, state_j, "run_batch('ipm') final state", True)
    assert ms[-1].sum() >= 8

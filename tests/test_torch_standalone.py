"""The port stands alone: no file of ``pymht_tpu_torch`` (nor
``chip_smoke.py``) imports ``jax`` or the JAX package ``pymht_tpu``, and
its own copies of the host modules (config, simulator, metrics, helpers,
containers, ais_io, timing, integrity and the polar model's constants)
agree with the JAX package's on the same seeded inputs — bit for bit,
since both are the same numpy arithmetic.  The copies of the exact
solvers' C++ source and of the XML writer differ from their originals
only where stated (utils/oracle.py, utils/checkpoint.py and
utils/xml_io.py are held to the JAX package's in
tests/test_torch_oracle.py, test_torch_checkpoint.py and
test_torch_xml_io.py).
"""
import dataclasses
import pathlib
import re

import numpy as np
import pytest

pytest.importorskip("torch")

from pymht_tpu.core import config as jconfig  # noqa: E402
from pymht_tpu.models import polar as jpolar  # noqa: E402
from pymht_tpu.utils import (  # noqa: E402
    ais_io as jais_io, containers as jcontainers, helpers as jhelpers,
    integrity as jintegrity, metrics as jmetrics, simulator as jsim,
    timing as jtiming)
from pymht_tpu_torch.core import config as tconfig  # noqa: E402
from pymht_tpu_torch.models import polar as tpolar  # noqa: E402
from pymht_tpu_torch.utils import (  # noqa: E402
    ais_io as tais_io, containers as tcontainers, helpers as thelpers,
    integrity as tintegrity, metrics as tmetrics, simulator as tsim,
    timing as ttiming)

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO_ROOT / "pymht_tpu_torch").rglob("*.py")) \
    + [REPO_ROOT / "chip_smoke.py", REPO_ROOT / "tests" / "torch_dist_worker.py"]
# an import statement naming jax or pymht_tpu as a whole word (so
# pymht_tpu_torch itself passes), at any indentation
FORBIDDEN = re.compile(
    r"^\s*(?:from|import)\s+(?:jax|jaxlib|flax|pymht_tpu)(?:\.|\s|,|$)", re.M)

# Fields of the JAX package's TrackerShapes that the port leaves out:
# pregate_approx selects jax.lax.approx_min_k, a TPU partial reduce (the
# port's pre-gate is exact top-k only).
DROPPED_FIELDS = {"TrackerShapes": {"pregate_approx"}, "TrackerParams": set()}


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO_ROOT)))
def test_no_import_of_jax_or_the_jax_package(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path}: {hits}"


def test_port_files_cover_the_solver_and_persistence_modules():
    names = {str(p.relative_to(REPO_ROOT)) for p in PORT_FILES}
    for want in ("ops/lp.py", "utils/oracle.py", "utils/checkpoint.py",
                 "utils/xml_io.py", "native/__init__.py"):
        assert f"pymht_tpu_torch/{want}" in names, want


def test_port_files_cover_the_parallel_modules():
    """Scenario batching, the Monte-Carlo runner and the multi-device
    modules are the port's own files, under the import scan above (as is
    the rank program of the multi-rank tests)."""
    names = {str(p.relative_to(REPO_ROOT)) for p in PORT_FILES}
    for want in ("parallel/__init__.py", "parallel/scenario.py",
                 "parallel/montecarlo.py", "batch.py",
                 "parallel/collectives.py", "parallel/distributed_select.py",
                 "parallel/sharded_tracker.py", "parallel/multihost.py"):
        assert f"pymht_tpu_torch/{want}" in names, want


def _code_lines(path, comment):
    """The lines of a source file below its leading comment block."""
    lines = path.read_text().splitlines()
    start = next(i for i, l in enumerate(lines)
                 if l.strip() and not l.startswith(comment))
    return lines[start:]


def test_exact_solver_source_is_the_jax_packages():
    """csrc/exact_solver.cpp: the JAX package's native/exact_solver.cpp
    line for line below the header comment."""
    ours = _code_lines(REPO_ROOT / "pymht_tpu_torch/csrc/exact_solver.cpp",
                       "//")
    theirs = _code_lines(REPO_ROOT / "pymht_tpu/native/exact_solver.cpp",
                         "//")
    assert ours == theirs and len(ours) > 100


def test_xml_io_source_differs_only_in_the_model_matrices():
    """utils/xml_io.py: the JAX package's file but for the docstring's
    head and the five lines of ``_sinv_sequence`` that build the model
    matrices (numpy on the host from the port's torch constructors)."""
    import difflib
    ours = (REPO_ROOT / "pymht_tpu_torch/utils/xml_io.py").read_text()
    theirs = (REPO_ROOT / "pymht_tpu/utils/xml_io.py").read_text()
    changed = [l for l in difflib.unified_diff(
        theirs.splitlines(), ours.splitlines(), lineterm="", n=0)
        if l[:1] in "+-" and l[:3] not in ("+++", "---")]
    assert 0 < len(changed) <= 16, changed
    assert all("pv." in l or "XML" in l or "counterpart" in l
               or "vocabulary" in l or "standard library" in l
               for l in changed), changed


def test_scan_finds_a_forbidden_import():
    """The scan itself: it flags the JAX package and jax, not the port."""
    assert FORBIDDEN.search("from pymht_tpu.utils import simulator")
    assert FORBIDDEN.search("    import pymht_tpu")
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert not FORBIDDEN.search("from pymht_tpu_torch.utils import metrics")
    assert not FORBIDDEN.search("import pymht_tpu_torch")
    assert len(PORT_FILES) > 20


@pytest.mark.parametrize("name", ["TrackerShapes", "TrackerParams"])
def test_config_fields_and_defaults(name):
    jcls, tcls = getattr(jconfig, name), getattr(tconfig, name)
    jf = {f.name: f.default for f in dataclasses.fields(jcls)}
    tf = {f.name: f.default for f in dataclasses.fields(tcls)}
    assert set(jf) - set(tf) == DROPPED_FIELDS[name]
    assert set(tf) <= set(jf)
    assert [n for n in jf if n in tf] == list(tf)          # same order
    for n, default in tf.items():
        assert default == jf[n], n


CONFIG_CASES = [
    ("TrackerShapes", {}, ["ais_fuse_width"]),
    ("TrackerShapes", dict(max_targets=128, max_leaves=32, max_meas=512,
                           max_ais=8, ais_per_leaf=3, radar_cand_width=64),
     ["ais_fuse_width"]),
    ("TrackerParams", {}, ["lambda_ex", "score_upper_limit",
                           "merge_threshold", "gamma_initiator"]),
    ("TrackerParams", dict(P_d=0.9, lambda_phi=2e-5, lambda_nu=1e-5,
                           gate_probability=0.95,
                           score_upper_limit_scale=0.5),
     ["lambda_ex", "score_upper_limit", "merge_threshold",
      "gamma_initiator"]),
]


@pytest.mark.parametrize("name,kw,props", CONFIG_CASES)
def test_config_derived_properties(name, kw, props):
    j, t = getattr(jconfig, name)(**kw), getattr(tconfig, name)(**kw)
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    for p in props:
        assert getattr(t, p) == getattr(j, p), p


def test_config_rejects_what_the_jax_config_rejects():
    for kw in (dict(window=1), dict(max_leaves=1),
               dict(max_meas=8, radar_cand_width=9)):
        with pytest.raises(AssertionError):
            jconfig.TrackerShapes(**kw)
        with pytest.raises(AssertionError):
            tconfig.TrackerShapes(**kw)


def _scene(sim, seed):
    rng = np.random.default_rng(seed)
    targets = sim.generate_initial_targets(rng, 6, (10.0, -5.0), 300.0, 0.9,
                                           0.1, assign_mmsi=True, P_r=0.9)
    sim_list = sim.simulate_targets(rng, targets, sim_time=25.0, dt=2.5)
    scans = sim.simulate_scans(rng, sim_list, 2.5, sigma_R=2.5,
                               lambda_phi=2e-5, radar_range=300.0,
                               p0=(10.0, -5.0), lambda_local=0.5)
    # AIS reports fall between radar scans: a finer truth for them
    fine = sim.simulate_targets(rng, targets, sim_time=25.0, dt=0.5)
    ais = sim.simulate_ais(rng, fine, 2.5, init_time=0.0,
                           id_scrambling=True)
    return targets, sim_list, scans, ais


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_simulator_is_bit_identical(seed):
    tj, lj, sj, aj = _scene(jsim, seed)
    tt, lt, st, at = _scene(tsim, seed)
    assert len(tt) == len(tj)
    for a, b in zip(tt, tj):
        np.testing.assert_array_equal(a.state, b.state)
        assert (a.time, a.P_d, a.sigma_Q, a.mmsi) == \
            (b.time, b.P_d, b.sigma_Q, b.mmsi)
    assert len(lt) == len(lj)
    for row_t, row_j in zip(lt, lj):
        for a, b in zip(row_t, row_j):
            np.testing.assert_array_equal(a.state, b.state)
            assert a.time == b.time
    assert len(st) == len(sj) and len(st) >= 5
    for a, b in zip(st, sj):
        assert a.time == b.time
        assert a.measurements.dtype == b.measurements.dtype
        np.testing.assert_array_equal(a.measurements, b.measurements)
    assert len(at) == len(aj) and sum(map(len, at)) >= 3
    for row_t, row_j in zip(at, aj):
        assert len(row_t) == len(row_j)
        for a, b in zip(row_t, row_j):
            assert (a.time, a.mmsi, a.highAccuracy) == \
                (b.time, b.mmsi, b.highAccuracy)
            np.testing.assert_array_equal(a.state, b.state)
    cj, rj = jsim.find_center_and_range(lj)
    ct, rt = tsim.find_center_and_range(lt)
    np.testing.assert_array_equal(np.asarray(ct), np.asarray(cj))
    assert rt == rj


class _Run:
    """What metrics.evaluate and helpers.backtrack_measurement_numbers
    read of a finished tracker: ``t0`` and the per-track sequences."""

    def __init__(self, seqs, t0):
        self._seqs, self.t0 = seqs, t0

    def _track_measurement_sequences(self, include_terminated=False):
        return self._seqs


def _tracked_run(sim_list, seed):
    """Tracks that follow the first four truths with noise, one of them
    late, plus one false track."""
    rng = np.random.default_rng(seed)
    t0 = 1.5
    seqs = {}
    for k in range(4):
        rows = sim_list[(2 if k == 3 else 0):]
        seqs[k] = ([r[k].time - t0 for r in rows],
                   [int(v) for v in rng.integers(0, 5, len(rows))],
                   [r[k].state + rng.normal(0, 1.0, 4) for r in rows],
                   [0] * len(rows))
    seqs[9] = ([r[0].time - t0 for r in sim_list], [1] * len(sim_list),
               [np.array([900.0, 900.0, 0.0, 0.0])] * len(sim_list),
               [0] * len(sim_list))
    return _Run(seqs, t0)


@pytest.mark.parametrize("seed", [0, 3])
def test_metrics_evaluate_equal(seed):
    _, sim_list, _, _ = _scene(tsim, seed)
    run = _tracked_run(sim_list, seed)
    kw = dict(p0=(10.0, -5.0), radar_range=300.0)
    mj = jmetrics.evaluate(run, sim_list, 2.5, **kw)
    mt = tmetrics.evaluate(run, sim_list, 2.5, **kw)
    assert mt.keys() == mj.keys()
    for key in mj:
        np.testing.assert_array_equal(np.asarray(mt[key]),
                                      np.asarray(mj[key]), err_msg=key)
    assert mt["n_false_tracks"] >= 1 and 0.0 < mt["track_percent"] <= 1.0
    np.testing.assert_array_equal(tmetrics.truth_positions(sim_list),
                                  jmetrics.truth_positions(sim_list))


def test_helpers_equal():
    for n in range(0, 9):
        for k in range(-1, n + 2):
            assert thelpers.binomial(n, k) == jhelpers.binomial(n, k)
    for g in range(0, 5):
        for w in range(1, 6):
            assert thelpers.expected_hypotheses(g, w) == \
                jhelpers.expected_hypotheses(g, w)
    _, sim_list, _, _ = _scene(tsim, 1)
    run = _tracked_run(sim_list, 1)
    assert thelpers.backtrack_measurement_numbers(run) == \
        jhelpers.backtrack_measurement_numbers(run)
    assert thelpers.backtrack_measurement_numbers(run, track_id=2) == \
        jhelpers.backtrack_measurement_numbers(run, track_id=2)


@pytest.mark.parametrize("cls", ["Position", "Velocity"])
def test_containers_equal(cls):
    rng = np.random.default_rng(5)
    J, T = getattr(jcontainers, cls), getattr(tcontainers, cls)
    for _ in range(5):
        a, b = rng.normal(0, 10, 2), rng.normal(0, 10, 2)
        for op in (lambda c: (c(*a) + c(*b)).to_array(),
                   lambda c: (c(*a) - c(b)).to_array(),
                   lambda c: (3.0 * c(*a)).to_array(),
                   lambda c: (c(*a) / 4.0).to_array(),
                   lambda c: c(*a).norm(), lambda c: repr(c(*a)),
                   lambda c: hash(c(*a)), lambda c: c(*a) == c(a),
                   lambda c: list(c(*a))):
            np.testing.assert_array_equal(op(T), op(J))
        if cls == "Position":
            assert T(*a).distance_to(b) == J(*a).distance_to(b)
            assert T(*a).in_range_of(b, 12.0) == J(*a).in_range_of(b, 12.0)
        else:
            assert T(*a).speed() == J(*a).speed()
            assert T(*a).heading_deg() == J(*a).heading_deg()


@pytest.mark.parametrize("seed", [0, 7])
def test_ais_io_equal(seed):
    """dedup_latest_per_mmsi and the group stream release the same
    messages in the same order as the JAX package's copies."""
    _, _, scans, groups = _scene(tsim, seed)
    rng = np.random.default_rng(seed)
    # duplicates: every group also gets older and newer copies of some
    # of its messages
    dup = []
    for g in groups:
        extra = [tsim.AisMessage(state=m.state + 1.0,
                                 time=m.time + rng.choice([-0.4, 0.4]),
                                 mmsi=m.mmsi, highAccuracy=m.highAccuracy)
                 for m in g[::2]]
        dup.append(list(g) + extra)
    assert sum(map(len, dup)) > sum(map(len, groups))
    for g in dup:
        a, b = tais_io.dedup_latest_per_mmsi(g), jais_io.dedup_latest_per_mmsi(g)
        assert len(a) == len(b) == len({m.mmsi for m in g})
        assert all(x is y for x, y in zip(a, b))
    st, sj = tais_io.AisMessageStream(dup), jais_io.AisMessageStream(dup)
    released = 0
    for s in scans:
        a, b = st.get_measurements(s.time), sj.getMeasurements(s.time)
        assert len(a) == len(b) and all(x is y for x, y in zip(a, b))
        released += len(a)
    assert released > 0
    assert tais_io.AisMessageStream([]).get_measurements(0.0) == []


def test_polar_constants_equal():
    """models/polar.py: the random-walk constants, and the radar model it
    re-exports from the port's own pv."""
    assert (tpolar.sigma_hdg, tpolar.sigma_speed) == \
        (jpolar.sigma_hdg, jpolar.sigma_speed)
    assert tpolar.sigmaR_RADAR_tracker == jpolar.sigmaR_RADAR_tracker
    np.testing.assert_array_equal(tpolar.C_RADAR("cpu").numpy(),
                                  np.asarray(jpolar.C_RADAR))
    np.testing.assert_array_equal(tpolar.H_radar("cpu").numpy(),
                                  np.asarray(jpolar.H_radar))
    np.testing.assert_array_equal(tpolar.P0("cpu").numpy(),
                                  np.asarray(jpolar.P0))
    np.testing.assert_array_equal(tpolar.R_RADAR("cpu").numpy(),
                                  np.asarray(jpolar.R_RADAR()))
    np.testing.assert_array_equal(tpolar.Phi(2.5).numpy(),
                                  np.asarray(jpolar.Phi(2.5)))
    assert tpolar.__name__.startswith("pymht_tpu_torch.")


def test_ais_model_covariance_equal():
    """models/ais.py: R for a flag and for a batch of flags."""
    import torch
    from pymht_tpu.models import ais as jais
    from pymht_tpu_torch.models import ais as tais
    flags = np.array([True, False, False, True])
    np.testing.assert_array_equal(
        tais.R(torch.from_numpy(flags), "cpu").numpy(),
        np.stack([np.asarray(jais.R(bool(f))) for f in flags]))
    for f in (True, False):
        np.testing.assert_array_equal(tais.R(f, "cpu").numpy(),
                                      np.asarray(jais.R(f)))
    assert (tais.sigmaR_AIS_true_highAccuracy,
            tais.sigmaR_AIS_true_lowAccuracy) == \
        (jais.sigmaR_AIS_true_highAccuracy, jais.sigmaR_AIS_true_lowAccuracy)


def test_runtime_log_equal():
    """utils/timing.RuntimeLog: the same recordings give the same
    averages, watchdog counts and summary line."""
    assert ttiming.PHASES == jtiming.PHASES
    rng = np.random.default_rng(2)
    for scale in (0.1, 1.0, 2.0):        # none, soft and hard violations
        a, b = ttiming.RuntimeLog(2.5), jtiming.RuntimeLog(2.5)
        for _ in range(20):
            phase = str(rng.choice(["Total", "Process", "Optim", "Other"]))
            sec = float(rng.uniform(0, 2.0)) * scale
            a.record(phase, sec)
            b.record(phase, sec)
        assert (a.violations, a.soft_violations) == \
            (b.violations, b.soft_violations)
        assert a.averages() == b.averages() and a.summary() == b.summary()
    assert ttiming.RuntimeLog.__module__.startswith("pymht_tpu_torch.")


def _grown_tracker():
    import torch  # noqa: F401
    from pymht_tpu_torch.core.tracker import Tracker
    shapes = tconfig.TrackerShapes(max_targets=6, max_leaves=8, max_meas=12,
                                   max_ais=2, window=5, max_prelim=4,
                                   max_initiators=12)
    params = tconfig.TrackerParams(radar_period=2.5, P_d=0.9,
                                   lambda_phi=1e-5, lambda_nu=1e-6, N=3,
                                   radar_range=1e4)
    tr = Tracker(shapes, params, method='lagrangian', use_ais=False,
                 device='cpu')
    x0 = [np.array([0.0, 0.0, 5.0, 0.0]), np.array([0.0, 6.0, 5.0, 0.0]),
          np.array([300.0, 0.0, 0.0, -4.0])]
    tr.pre_initialize(0.0, x0)
    rng = np.random.default_rng(8)
    for i in range(4):
        t = 2.5 * (i + 1)
        z = np.stack([x[:2] + x[2:] * t + rng.normal(0, 1.5, 2) for x in x0]
                     + [rng.uniform(-20, 60, 2) for _ in range(3)])
        tr.add_measurement_list(t, z, check_integrity=True)
    return tr


class _JaxView:
    """The port tracker's forest as the JAX package's integrity check
    reads it: numpy arrays under the same field names."""

    def __init__(self, tracker):
        from types import SimpleNamespace
        self.shapes = tracker.shapes
        self.state = SimpleNamespace(**{
            f.name: getattr(tracker.state, f.name).numpy()
            for f in dataclasses.fields(tracker.state)})


INTEGRITY_FAULTS = {
    "none": lambda st, t, live: {},
    "leaf_on_free_target": lambda st, t, live: dict(
        tgt_mask=st.tgt_mask & (np.arange(len(st.tgt_mask)) != t)),
    "selected_leaf_dead": lambda st, t, live: dict(
        leaf_mask=_without(st.leaf_mask, t, int(st.sel_leaf[t]))),
    "duplicate_ids": lambda st, t, live: dict(
        tgt_id=np.where(st.tgt_mask, 7, st.tgt_id).astype(np.int32)),
    "twin_histories": lambda st, t, live: dict(
        hist_meas=_copy_row(st.hist_meas, t, live[0], live[1]),
        hist_ais=_copy_row(st.hist_ais, t, live[0], live[1])),
    "label_before_birth": lambda st, t, live: dict(
        tgt_depth=np.where(np.arange(len(st.tgt_depth)) == t, 1,
                           st.tgt_depth).astype(np.int32)),
    "two_mmsi_on_a_path": lambda st, t, live: dict(
        hist_mmsi=_two_mmsi(st.hist_mmsi, t, live[0])),
    "history_score_out_of_step": lambda st, t, live: dict(
        leaf_cnllr=st.leaf_cnllr + 1.0),
}


def _without(mask, t, leaf):
    out = mask.copy()
    out[t, leaf] = False
    return out


def _copy_row(a, t, src, dst):
    out = a.copy()
    out[t, dst] = out[t, src]
    return out


def _two_mmsi(a, t, leaf):
    out = a.copy()
    out[t, leaf, -1], out[t, leaf, -2] = 111, 222
    return out


@pytest.mark.parametrize("fault", list(INTEGRITY_FAULTS))
def test_integrity_check_equal(fault):
    """utils/integrity.check_state_integrity: the port's copy (torch
    state) and the JAX package's (the same arrays as numpy) accept the
    grown forest and reject the same broken ones."""
    import torch
    tr = _grown_tracker()
    view = _JaxView(tr)
    live_per_target = view.state.leaf_mask.sum(axis=1)
    t = int(np.argmax(live_per_target))
    live = np.nonzero(view.state.leaf_mask[t])[0]
    assert len(live) >= 2
    changes = INTEGRITY_FAULTS[fault](view.state, t, live)
    for k, v in changes.items():
        setattr(view.state, k, v)
    tr.state = tr.state.replace(**{k: torch.from_numpy(v)
                                   for k, v in changes.items()})
    if fault == "none":
        tintegrity.check_state_integrity(tr)
        jintegrity.check_state_integrity(view)
        return
    with pytest.raises(AssertionError):
        jintegrity.check_state_integrity(view)
    with pytest.raises(AssertionError):
        tintegrity.check_state_integrity(tr)
    with pytest.raises(AssertionError):
        tr.checkIntegrity()


# ----------------------------------------------------------------------
# utils/ref_oracle.py and utils/plotting.py
# ----------------------------------------------------------------------

def _eval_scene(sim_mod, n_targets, clutter, use_ais, seed=7, n_scans=10):
    """eval_configs.build_scene's draws (config 2, and config 5 with
    AIS) at 10 scans."""
    period, radar_range = 2.5, 1000.0 if not use_ais else 1500.0
    rng = np.random.default_rng(seed)
    targets = sim_mod.generate_initial_targets(
        rng, n_targets, (0., 0.), radar_range * 0.6, 0.9, 0.1,
        assign_mmsi=use_ais)
    sim_list = sim_mod.simulate_targets(rng, targets,
                                        sim_time=n_scans * period, dt=period)
    scans = sim_mod.simulate_scans(rng, sim_list, period, sigma_R=2.5,
                                   lambda_phi=clutter,
                                   radar_range=radar_range, p0=(0., 0.),
                                   P_d=0.9)
    groups = (sim_mod.simulate_ais(rng, sim_list, period,
                                   sim_list[0][0].time) if use_ais else [])
    return sim_list, scans, groups


def _oracle_run(mod, config, scans, groups):
    """RefOracle with initiation and termination over the scans, its AIS
    messages those of the elapsed period."""
    oracle = mod.RefOracle(config.TrackerParams(
        radar_period=2.5, P_d=0.9, lambda_phi=2e-6, lambda_nu=1e-5, N=4,
        radar_range=1500.0), initiate=True, terminate=True)
    stream = jais_io.AisMessageStream(groups)
    rows = []
    for s in scans:
        msgs = [mod.AisMsg(state=np.asarray(g.state, float),
                           time=float(g.time), mmsi=int(g.mmsi),
                           high_accuracy=bool(g.highAccuracy))
                for g in stream.get_measurements(s.time)
                if s.time - 2.5 < g.time < s.time]
        oracle.step(s.time, s.measurements, msgs)
        rows.append((oracle.selected(), oracle.objective()))
    return oracle, rows


@pytest.mark.parametrize("n_targets,clutter,use_ais",
                         [(10, 2e-6, False), (8, 1e-6, True)],
                         ids=["clutter", "ais"])
def test_ref_oracle_equal(n_targets, clutter, use_ais):
    """The port's reference-decision oracle (its own copy, on the port's
    model matrices) makes the JAX package's decisions on the same scenes,
    to the bit: selections, objectives, confirm and kill events, the
    archived sequences and the metrics read through MetricsAdapter."""
    from pymht_tpu.utils import ref_oracle as jref
    from pymht_tpu_torch.utils import ref_oracle as tref
    sim_list, scans, groups = _eval_scene(tsim, n_targets, clutter, use_ais)
    oj, rows_j = _oracle_run(jref, jconfig, scans, groups)
    ot, rows_t = _oracle_run(tref, tconfig, scans, groups)
    assert len(rows_t) == len(rows_j) == len(scans)
    for (sel_t, obj_t), (sel_j, obj_j) in zip(rows_t, rows_j):
        assert obj_t == obj_j
        assert len(sel_t) == len(sel_j)
        for a, b in zip(sel_t, sel_j):
            assert [x for x in a if not isinstance(x, np.ndarray)] == \
                [x for x in b if not isinstance(x, np.ndarray)]
            for x, y in zip(a, b):
                if isinstance(x, np.ndarray):
                    np.testing.assert_array_equal(x, y)
    assert [e[:3] for e in ot.events] == [e[:3] for e in oj.events]
    assert any(e[0] == "confirm" for e in ot.events)
    mj = jmetrics.evaluate(jref.MetricsAdapter(oj), sim_list, 2.5,
                           p0=(0., 0.), radar_range=1500.0)
    mt = tmetrics.evaluate(tref.MetricsAdapter(ot), sim_list, 2.5,
                           p0=(0., 0.), radar_range=1500.0)
    assert mt == mj and mt["track_percent"] > 0.3
    if use_ais:
        assert any(mm for sel, _ in rows_t for _t, _m, mm, *_ in sel)


def test_ref_oracle_source_differs_only_in_the_model_matrices():
    """utils/ref_oracle.py: the JAX package's file below its docstring,
    but for the lines that take the model matrices (f32 torch tensors on
    the CPU, as float64 numpy)."""
    import difflib
    path = "utils/ref_oracle.py"

    def code(root):
        text = (REPO_ROOT / root / path).read_text()
        return text[text.index("from __future__"):].splitlines()

    changed = [l for l in difflib.unified_diff(
        code("pymht_tpu"), code("pymht_tpu_torch"), lineterm="", n=0)
        if l[:1] in "+-" and l[:3] not in ("+++", "---")]
    assert 0 < len(changed) <= 60, changed
    assert all("pv." in l or "ais_model." in l or "_f64" in l
               or "_CPU" in l or "torch" in l or "else pv" in l
               or "numpy" in l or not l[1:].strip()
               or l[1:].strip().startswith("#")
               for l in changed), changed


class _Msg:
    state = np.array([5.0, 6.0, 0.0, 0.0])


def _line_data(ax):
    return [np.asarray(line.get_xydata()) for line in ax.get_lines()]


def test_plotting_draws_what_the_jax_package_draws():
    """The eleven plot_* functions of the port on a port Tracker draw the
    lines, texts and ellipses that the JAX package's draw on a JAX
    Tracker stepped through the same scans (positions within 1e-3 m)."""
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from pymht_tpu import Tracker as JTracker
    from pymht_tpu.utils import plotting as jplot
    from pymht_tpu_torch import Tracker as TTracker
    from pymht_tpu_torch.utils import plotting as tplot
    rng = np.random.default_rng(4)
    targets = tsim.generate_initial_targets(rng, 3, (0., 0.), 300.0, 0.9,
                                            0.1)
    sim_list = tsim.simulate_targets(rng, targets, sim_time=6 * 2.5, dt=2.5)
    scans = tsim.simulate_scans(rng, sim_list, 2.5, sigma_R=2.0,
                                lambda_phi=0.0, radar_range=500.0,
                                p0=(0., 0.), local_clutter=False,
                                global_clutter=False)
    kw = dict(max_targets=8, max_leaves=16, max_meas=16, max_ais=2,
              window=6, max_prelim=8, max_initiators=16)
    pk = dict(radar_period=2.5, P_d=0.9, lambda_phi=1e-8, lambda_nu=1e-6,
              radar_range=500.0)
    trj = JTracker(jconfig.TrackerShapes(**kw), jconfig.TrackerParams(**pk),
                   method="lagrangian", use_ais=False)
    trt = TTracker(tconfig.TrackerShapes(**kw), tconfig.TrackerParams(**pk),
                   method="lagrangian", use_ais=False, device="cpu")
    for s in scans:
        trj.add_measurement_list(s.time, s.measurements)
        trt.add_measurement_list(s.time, s.measurements)
    axes = []
    for mod, tr in ((jplot, trj), (tplot, trt)):
        fig, ax = plt.subplots()
        mod.plot_ground_truth(ax, sim_list)
        mod.plot_measurements(ax, scans)
        mod.plot_tracks(ax, tr, smooth=True)
        mod.plot_validation_regions(ax, tr)
        mod.plot_velocity_arrows(ax, tr)
        mod.plot_hypotheses(ax, tr)
        mod.plot_terminated_tracks(ax, tr)
        mod.plot_ais_updates(ax, [[_Msg()]])
        mod.plot_initial_targets(ax, [t.state for t in targets])
        mod.plot_track(ax, [0.0, 2.5], [[0., 0., 1., 1.], [2.5, 2.5, 1., 1.]],
                       track_id=7, terminated=True)
        mod.plot_validation_ellipse(ax, np.zeros(2), np.eye(2) * 4.0, 9.0)
        axes.append(ax)
    (aj, at) = axes
    lj, lt = _line_data(aj), _line_data(at)
    assert len(lt) == len(lj) and len(lt) > 20
    for a, b in zip(lt, lj):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)
    assert [t.get_text() for t in at.texts] == [t.get_text()
                                                 for t in aj.texts]
    def patches(ax):       # ellipses and arrows, in data coordinates
        return [(type(p).__name__, p.get_patch_transform().transform(
            p.get_path().vertices)) for p in ax.patches]

    pj, pt = patches(aj), patches(at)
    assert [n for n, _ in pt] == [n for n, _ in pj]
    assert sum(n == "Ellipse" for n, _ in pt) >= 3
    for (_, a), (_, b) in zip(pt, pj):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-3)
    plt.close("all")

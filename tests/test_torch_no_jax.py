"""The port imports torch and never jax nor the JAX package: a fresh
interpreter in which importing jax or pymht_tpu raises runs the port's
Tracker for a few scans, radar only and then with AIS fusion, AIS
initiation and the spatial pre-gate, and then streams a run with
``prune_similar`` and the on-device window, degrades the beam, checks the
forest and smooths the tracks; then runs the default ``'ipm'`` and
``'lagrangian_pure'``, both exact oracles, a checkpoint round trip and
the XML export; then draws a Monte-Carlo batch and tracks it with the
batched step (parallel/), and steps a few scans through the target-sharded
step on one gloo rank.  A second interpreter does the same for the
modules and scripts of the last slice: the reference-decision oracle,
plotting, the swarm and saturation benchmarks, the evaluation configs,
the A/B and scaling scripts and both examples."""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROGRAM = r"""
import sys
sys.modules['jax'] = None          # any 'import jax' now raises ImportError
sys.modules['pymht_tpu'] = None    # and so does the JAX package
import numpy as np
from pymht_tpu_torch import Tracker, TrackerShapes, TrackerParams
from pymht_tpu_torch.ops import gate_kernel
from pymht_tpu_torch.kernels import build
from pymht_tpu_torch.utils import simulator as sim, metrics
shapes = TrackerShapes(max_targets=8, max_leaves=8, max_meas=16, max_ais=2,
                       window=5, max_prelim=8, max_initiators=16)
params = TrackerParams(radar_period=2.5, P_d=0.9, lambda_phi=1e-5,
                       lambda_nu=1e-5, N=3, radar_range=500.0)
rng = np.random.default_rng(0)
targets = sim.generate_initial_targets(rng, 3, (0.0, 0.0), 200.0, 0.9, 0.1)
sim_list = sim.simulate_targets(rng, targets, sim_time=10.0, dt=2.5)
scans = sim.simulate_scans(rng, sim_list, 2.5, sigma_R=2.5, lambda_phi=1e-5,
                           radar_range=500.0, p0=(0.0, 0.0))
tr = Tracker(shapes, params, method='lagrangian', device='cpu')
for s in scans:
    tr.add_measurement_list(s.time, s.measurements)
assert len(tr.get_tracks()) >= 1
# the AIS slice: fusion, AIS initiation, the group stream, the pre-gate
import dataclasses
from pymht_tpu_torch.utils.ais_io import AisMessageStream
from pymht_tpu_torch.models import polar
rng = np.random.default_rng(1)
targets = sim.generate_initial_targets(rng, 3, (0.0, 0.0), 200.0, 0.9, 0.1,
                                       assign_mmsi=True, P_r=1.0)
sim_list = sim.simulate_targets(rng, targets, sim_time=12.5, dt=2.5)
scans = sim.simulate_scans(rng, sim_list, 2.5, sigma_R=2.5, lambda_phi=1e-5,
                           radar_range=500.0, p0=(0.0, 0.0))
fine = sim.simulate_targets(rng, targets, sim_time=12.5, dt=0.5)
stream = AisMessageStream(sim.simulate_ais(rng, fine, 2.5, init_time=0.0))
tr = Tracker(dataclasses.replace(shapes, max_ais=4, radar_cand_width=6),
             params, method='lagrangian', device='cpu')
assert tr.use_ais and tr.ais_initialization
F_inv = np.eye(4)
F_inv[0, 2] = F_inv[1, 3] = -2.5
tr.pre_initialize(scans[0].time - 2.5, [F_inv @ t.state for t in targets[:2]],
                  mmsi=[t.mmsi for t in targets[:2]])
n_msgs = 0
for s in scans:
    msgs = stream.get_measurements(s.time)
    n_msgs += len(msgs)
    out = tr.add_measurement_list(s.time, s.measurements, ais_messages=msgs)
    assert bool(out.sel_feasible)
assert n_msgs >= 3 and len(tr.get_tracks()) >= 2
assert any(any(t['confirmed_mmsi'] + t['window_mmsi'])
           for t in tr.get_tracks().values())
# the streaming slice: stream, prune_similar, the on-device window,
# degrade, check_integrity, the runtime log and the smoother
tr = Tracker(dataclasses.replace(shapes, max_ais=4), params,
             method='lagrangian', device='cpu', prune_similar=True,
             degrade_on_overload=True)
tr.pre_initialize(scans[0].time - 2.5, [F_inv @ t.state for t in targets[:2]],
                  mmsi=[t.mmsi for t in targets[:2]])
stream = AisMessageStream(sim.simulate_ais(rng, fine, 2.5, init_time=0.0))
groups = [stream.get_measurements(s.time) for s in scans]
outs = tr.stream(scans[:4], groups[:4], chunk=3, dynamic_window=True)
assert [len(c.track_mask) for c in outs] == [3, 1]
tr.check_integrity()
assert tr.degrade() and tr.shapes.max_leaves == 4
outs = tr.stream(scans[4:], groups[4:], chunk=3)
tr.check_integrity()
assert all(c.sel_feasible.all() for c in outs)
assert len(tr.runtime_log) == len(scans) and tr.get_runtime_average()['Total'] > 0
smooth = tr.get_smooth_tracks(em_iters=2, em_mode='full')
assert len(smooth) >= 2 and any(ok for _, _, ok in smooth.values())
assert len(tr.profile_phases(scans[-1].time + 2.5, scans[-1].measurements)) == 6
# the solver and persistence slice: the default method, the pure
# Lagrangian, the oracles, checkpoint/resume and the XML export
import os, tempfile
import xml.etree.ElementTree as ET
import torch
torch.set_num_threads(1)     # thousands of tiny ops: no thread pool
from pymht_tpu_torch import native
from pymht_tpu_torch.utils import checkpoint, oracle, xml_io
for method in ('ipm', 'lagrangian_pure'):
    tr = Tracker(dataclasses.replace(shapes, max_ais=4), params, device='cpu',
                 **({} if method == 'ipm' else dict(method=method)))
    assert tr.method == method
    tr.pre_initialize(scans[0].time - 2.5, [F_inv @ t.state for t in targets],
                      mmsi=[t.mmsi for t in targets])
    for s, g in zip(scans[:4], groups):
        assert bool(tr.add_measurement_list(s.time, s.measurements,
                                            ais_messages=g).sel_feasible)
gap = oracle.selection_gap(tr.state, tr.shapes, tr.params)
assert gap is not None and gap <= 1e-3, gap
assert oracle.native_select_oracle(tr.state, tr.shapes, tr.params)[2]
assert native.solve_lap_jv(np.array([[1.0, 2.0], [0.0, 5.0]]))[1] == 2.0
with tempfile.TemporaryDirectory() as d:
    checkpoint.save(tr, os.path.join(d, 'ck'))
    back = checkpoint.load(os.path.join(d, 'ck'), device='cpu')
    assert back.scan_times == tr.scan_times and back.method == tr.method
    a = tr.add_measurement_list(scans[4].time, scans[4].measurements, groups[4])
    b = back.add_measurement_list(scans[4].time, scans[4].measurements,
                                  groups[4])
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    root = ET.Element(xml_io.SCENARIO)
    xml_io.store_run(root, tr, smooth=True)
    xml_io.write_element_to_file(os.path.join(d, 'run.xml'), root)
    run = ET.parse(os.path.join(d, 'run.xml')).getroot().find(xml_io.RUN)
    assert len(run.findall(xml_io.TRACK)) >= 2
# scenario batching: a Monte-Carlo batch through the batched step
from pymht_tpu_torch.parallel import montecarlo as mc
sc = mc.generate(torch.Generator().manual_seed(0), 3, 2, 4, shapes, params,
                 300.0)
st, xs, ms = mc.run_batch(sc, shapes, params)
assert xs.shape == (4, 3, 8, 4) and int(ms[-1].sum()) >= 4
assert st.leaf_x.shape == (3, 8, 8, 4)
# multi-device: one gloo rank on the CPU through the target-sharded
# step, the distributed select, a sharded restore, the measurement
# exchange and the scenario x cluster dry run
import datetime, socket
import torch.distributed as dist
from pymht_tpu_torch.core import initiator
from pymht_tpu_torch.core.grow import Scan
from pymht_tpu_torch.parallel import multihost, scenario
from pymht_tpu_torch.parallel.collectives import Axis
from pymht_tpu_torch.parallel.distributed_select import make_distributed_select
from pymht_tpu_torch.parallel.sharded_tracker import (
    gather_state, make_sharded_tracker_step, shard_state)
with socket.socket() as sock:
    sock.bind(('127.0.0.1', 0))
    port = sock.getsockname()[1]
dist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{port}',
                        world_size=1, rank=0,
                        timeout=datetime.timedelta(seconds=60))
axis = Axis()
tr = Tracker(shapes, params, method='lagrangian', use_ais=False, device='cpu')
tr.pre_initialize(scans[0].time - 2.5, [F_inv @ t.state for t in targets])
step = make_sharded_tracker_step(axis, shapes, params)
st, ist = shard_state(tr.state, axis), tr.init_state
scan_b = tr.make_stream_inputs(scans[:3])[0]
for i in range(3):
    st, ist, out = step(st, ist, Scan(*(f[i] for f in scan_b)))
    assert bool(out['sel_feasible'])
assert make_distributed_select(axis, shapes, params, impl='full')(st)[3]
assert axis.count > 0 and axis.bytes > 0
with tempfile.TemporaryDirectory() as d:
    checkpoint.save_state(os.path.join(d, 'st'), gather_state(st, axis), ist)
    back, _ = checkpoint.load_state(os.path.join(d, 'st'), device='cpu',
                                    shard=axis)
    assert torch.equal(back.leaf_x, st.leaf_x)
z, m = multihost.gather_local_measurements(np.ones((3, 2)), [1, 0, 1], 4,
                                           device='cpu')
assert m.tolist() == [True, True, False, False]
assert scenario.dryrun(1, device='cpu')[0].leaf_x.shape == (1, 8, 8, 4)
dist.destroy_process_group()
loaded = sorted(m for m in sys.modules
                if (m in ('jax', 'pymht_tpu')
                    or m.startswith(('jax.', 'jaxlib', 'flax', 'pymht_tpu.')))
                and sys.modules[m] is not None)
assert not loaded, loaded
print('ok')
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    res = subprocess.run([sys.executable, "-c", PROGRAM], cwd=REPO_ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


SCRIPTS_PROGRAM = r"""
import sys
sys.modules['jax'] = None
sys.modules['pymht_tpu'] = None
import os, tempfile
import numpy as np
import torch
torch.set_num_threads(1)
from pymht_tpu_torch.core.config import TrackerParams
from pymht_tpu_torch.utils import plotting, scenes
from pymht_tpu_torch.utils.ref_oracle import AisMsg, MetricsAdapter, RefOracle
from pymht_tpu_torch.scripts import (ab_distributed_select, bench,
                                     bench_saturation, bench_scaling,
                                     bench_swarm, eval_configs)
from pymht_tpu_torch.examples import demo_streaming_deployment, demo_tracking
oracle = RefOracle(TrackerParams(radar_period=2.5), initiate=True)
for k in range(4):
    oracle.step(2.5 * (k + 1), np.array([[10.0 * k, 0.0], [0.0, 50.0]]),
                [AisMsg(state=np.array([10.0 * k, 0.0, 4.0, 0.0]),
                        time=2.5 * k + 1.0, mmsi=200000001)])
assert oracle.sequences() is not None and MetricsAdapter(oracle) is not None
os.environ.update(SWARM_ORACLE='0', SAT_POINTS='32', SAT_SCANS='2',
                  SAT_REPS='1', BENCH_TARGETS='4', BENCH_SCANS='2',
                  BENCH_MEAS='64')
bench_swarm.scene_of = lambda k: scenes.swarm_scene(12, 2, 1024, 16, t_cap=32)
bench_swarm.main(['--device', 'cpu'])
bench_saturation.main(['--device', 'cpu'])
bench.main(['--device', 'cpu'])
m = eval_configs.run_config('1_crossing', 2, 0.0, 1.0, 5, eval_configs.SMALL,
                            radar_range=2000.0, device='cpu')
assert m['n_tracked'] == 2
with tempfile.TemporaryDirectory() as d:
    demo_tracking.main(['--device', 'cpu', '--targets', '2', '--scans', '2',
                        '--out', d, '--no-plot'])
demo_streaming_deployment.main(['--device', 'cpu', '--targets', '4',
                                '--scans', '2', '--chunk', '2'])
loaded = sorted(m for m in sys.modules
                if (m in ('jax', 'pymht_tpu')
                    or m.startswith(('jax.', 'jaxlib', 'flax', 'pymht_tpu.')))
                and sys.modules[m] is not None)
assert not loaded, loaded
print('ok')
"""


def test_scripts_and_examples_run_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    res = subprocess.run([sys.executable, "-c", SCRIPTS_PROGRAM],
                         cwd=REPO_ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")

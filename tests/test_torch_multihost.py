"""The port's multi-process runtime (pymht_tpu_torch/parallel/
multihost.py) and its scenario x cluster sharded step
(parallel/scenario.py), the twins of tests/test_multihost.py,
tests/multihost_worker.py and tests/test_multichip.py.

Four gloo CPU ranks, launched once per module, each ``initialize()`` from
the ``PYMHT_COORDINATOR`` / ``PYMHT_NUM_PROCS`` / ``PYMHT_PROC_ID``
variables and build a 2 x 2 ('scenario', 'cluster') mesh.  They exchange
measurements, step two scenarios for five scans through
``make_sharded_step`` against ``make_batched_step`` on the whole batch
(equal within 1e-5), run ``dryrun(4)``, and restore a checkpoint written
by the JAX package by rows.  In this process: ``initialize`` with one
process is a no-op, and without CUDA it refuses to pick a device or to
run NCCL on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from pymht_tpu.core import initiator as jinit  # noqa: E402
from pymht_tpu.core.config import (  # noqa: E402
    TrackerParams as JParams, TrackerShapes as JShapes)
from pymht_tpu.core.state import (  # noqa: E402
    empty_state as jempty_state, insert_targets as jinsert)
from pymht_tpu.models import pv as jpv  # noqa: E402
from pymht_tpu.utils import checkpoint as jckpt  # noqa: E402
from pymht_tpu_torch.core.config import (  # noqa: E402
    TrackerParams, TrackerShapes)
from pymht_tpu_torch.parallel import multihost  # noqa: E402
from tests.torch_dist_worker import config_json, launch  # noqa: E402

SHAPES = TrackerShapes(max_targets=8, max_leaves=8, max_meas=8, max_ais=2,
                       window=4, max_prelim=8, max_initiators=8)
PARAMS = TrackerParams(radar_period=1.0, N=2)
N_SCANS = 5


def _scans():
    """Two scenarios of three targets each crossing the scene, with two
    clutter points per scan: tracks initiate, and then select runs."""
    rng = np.random.default_rng(3)
    p0 = rng.uniform(-100, 100, (2, 3, 2))
    v = rng.normal(0, 5, (2, 3, 2))
    out = []
    for k in range(N_SCANS):
        z = np.zeros((2, SHAPES.max_meas, 2), np.float32)
        z[:, :3] = p0 + v * (k + 1) + rng.normal(0, 1.0, (2, 3, 2))
        z[:, 3:5] = rng.uniform(-300, 300, (2, 2, 2))
        z[:, 5:] = rng.normal(0, 50, (2, 3, 2))
        out.append(z)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("multihost")
    # a checkpoint written by the JAX package: five targets, each slot's
    # rows distinct
    shapes = JShapes(max_targets=8, max_leaves=4, max_meas=8, max_ais=2,
                     window=4)
    params = JParams(N=2)
    xs = np.arange(32, dtype=np.float32).reshape(8, 4)
    st = jinsert(jempty_state(shapes, params), jnp.asarray(xs),
                 jnp.broadcast_to(jpv.P0, (8, 4, 4)),
                 jnp.asarray(np.arange(8) < 5), jnp.zeros(8, jnp.int32),
                 jnp.asarray(0.0), params)
    jckpt.save_state(str(d / "ckpt"), st, jinit.empty_initiator(shapes))
    inputs = {"config": config_json(SHAPES, PARAMS),
              "ckpt": np.array(str(d / "ckpt"))}
    inputs.update({f"scan{k}.z": z for k, z in enumerate(_scans())})
    np.savez(d / "in.npz", **inputs)
    return launch("multihost", 4, str(d / "in.npz"), str(d)), \
        np.load(str(d / "ckpt") + ".npz")


def test_initialize_and_mesh(ranks):
    """Each rank initialised from the PYMHT_* variables; the mesh is
    process-major: rank r at (r // 2, r % 2)."""
    outs, _ = ranks
    for r, o in enumerate(outs):
        assert str(o["mesh_names"]) == "scenario,cluster"
        np.testing.assert_array_equal(o["mesh"], [2, 2, r // 2, 2, r % 2, 2])


def test_gather_local_measurements(ranks):
    outs, _ = ranks
    want = {(10.0 * p, float(v)) for p in range(4) for v in (1, 2)}
    for o in outs:
        assert o["z_mask"].sum() == 8
        assert {tuple(r) for r in o["z"][o["z_mask"]]} == want
        # 32 valid returns into 12 slots: rank 0's eight, then rank 1's
        # first four
        np.testing.assert_array_equal(o["z_over"][:, 0], [0] * 8 + [1] * 4)
        np.testing.assert_array_equal(o["z_over"][:, 1],
                                      list(range(8)) + list(range(4)))


def test_make_sharded_step_matches_batched(ranks):
    """Sharding is a layout: every rank's blocks of the state, the
    initiator state and the outputs equal those of make_batched_step on
    the whole batch, scan by scan."""
    outs, _ = ranks
    n_tracks = 0
    for o in outs:
        refs = [k for k in o if k.startswith("mh.") and k.endswith(".ref")]
        assert len(refs) > 30
        for k in refs:
            np.testing.assert_allclose(o[k[:-4] + ".got"], o[k], rtol=1e-5,
                                       atol=1e-5, err_msg=k)
        n_tracks += int(o[f"mh.scan{N_SCANS - 1}.state.tgt_mask.ref"].sum())
    assert n_tracks > 0, "no track initiated: select never ran"


def test_dryrun_4(ranks):
    outs, _ = ranks
    for o in outs:
        for f in ("leaf_cnllr", "p_x"):
            np.testing.assert_allclose(o[f"dryrun.{f}.got"],
                                       o[f"dryrun.{f}.ref"], rtol=1e-5,
                                       atol=1e-5)


def test_dryrun_swarm_cluster_4(ranks):
    """The swarm-shaped scan split over four ranks against the
    single-device step on the same inputs (tests/test_sharded_swarm.py's
    contract on the 600 live targets: feasible, objective within 1e-3,
    at least 99.5 % of the labels equal, states equal where they are)."""
    from pymht_tpu_torch.core.tracker import scan_step
    from pymht_tpu_torch.parallel.scenario import swarm_cluster_inputs
    outs, _ = ranks
    shapes, params, st, ist, scan, ais = swarm_cluster_inputs("cpu")
    _, _, ref = scan_step(st, ist, scan, ais, shapes, params,
                          method="lagrangian", use_ais=True)
    for o in outs:
        assert bool(o["swarm.sel_feasible"])
        obj = float(ref.sel_obj)
        assert abs(float(o["swarm.sel_obj"]) - obj) <= 1e-3 * (1 + abs(obj))
        same = (o["swarm.sel_hist_meas"][:600, -1]
                == ref.sel_hist_meas[:600, -1].numpy())
        assert same.mean() >= 0.995
        np.testing.assert_allclose(o["swarm.track_x"][:600][same],
                                   ref.track_x[:600].numpy()[same], rtol=0,
                                   atol=1e-3)
    np.testing.assert_array_equal(outs[1]["swarm.track_x"],
                                  outs[0]["swarm.track_x"])


def test_load_state_shard_of_a_jax_checkpoint(ranks):
    """Restored by rows on the cluster axis (2 ranks) and on the whole
    world (4): each rank holds its rows, the gathered state is the file's,
    the replicated fields whole."""
    outs, data = ranks
    full = data["state.leaf_x"]
    for r, o in enumerate(outs):
        for key, n, idx in (("cluster", 2, r % 2), ("world", 4, r)):
            rows = 8 // n
            np.testing.assert_array_equal(
                o[f"ckpt.{key}.rows"], full[idx * rows:(idx + 1) * rows])
            np.testing.assert_array_equal(o[f"ckpt.{key}.gathered"], full)
            np.testing.assert_array_equal(o[f"ckpt.{key}.lam"],
                                          data["state.lam"])
            np.testing.assert_array_equal(o[f"ckpt.{key}.p_x"],
                                          data["init.p_x"])


_ENV = ("PYMHT_COORDINATOR", "PYMHT_NUM_PROCS", "PYMHT_PROC_ID",
        "MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK")


@pytest.fixture
def clean_env(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def test_initialize_single_process_is_a_no_op(clean_env):
    assert multihost.initialize() is False
    assert multihost.initialize("127.0.0.1:1", 1, 0) is False
    clean_env.setenv("WORLD_SIZE", "1")
    assert multihost.initialize() is False
    assert not torch.distributed.is_initialized()


def test_initialize_needs_cuda_or_a_named_cpu(clean_env):
    """Several processes and no device named: the rank's GPU, or an
    error; never gloo on the CPU in its place."""
    clean_env.setenv("PYMHT_COORDINATOR", "127.0.0.1:1")
    clean_env.setenv("PYMHT_NUM_PROCS", "2")
    clean_env.setenv("PYMHT_PROC_ID", "0")
    clean_env.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize()
    with pytest.raises(ValueError, match="NCCL needs a CUDA device"):
        multihost.initialize(device="cpu")
    assert not torch.distributed.is_initialized()


def test_torchrun_variables(clean_env):
    """torchrun's variables stand in for the PYMHT_* ones."""
    clean_env.setenv("MASTER_ADDR", "127.0.0.1")
    clean_env.setenv("WORLD_SIZE", "2")
    clean_env.setenv("RANK", "1")
    clean_env.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize()
    clean_env.delenv("RANK")
    with pytest.raises(ValueError, match="process's id"):
        multihost.initialize(device="cpu", backend="gloo")


@pytest.fixture
def one_rank():
    """A gloo group of this process alone, destroyed afterwards."""
    import datetime
    from tests.torch_dist_worker import _free_port
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


def test_axis_reductions_leave_their_inputs_alone(one_rank):
    """Reductions return new tensors (bools as int32 counts, inputs made
    contiguous), gathers concatenate along the named axis, and every
    collective is counted with its bytes."""
    from pymht_tpu_torch.parallel.collectives import (
        Axis, check_replicated, digest, psum)
    ax = Axis()
    assert (ax.index, ax.size, ax.count, ax.bytes) == (0, 1, 0, 0)
    mask = torch.tensor([True, False, True])
    got = ax.psum(mask)
    assert got.dtype == torch.int32 and got.tolist() == [1, 0, 1]
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4).T   # strided
    for fn in (ax.psum, ax.pmin, ax.pmax):
        y = fn(x)
        assert y.data_ptr() != x.data_ptr() and torch.equal(y, x)
        assert y.is_contiguous()
    assert ax.psum(torch.tensor(2.5)).item() == 2.5            # 0-d
    g = ax.all_gather(x, dim=1)
    assert g.shape == (4, 3) and torch.equal(g, x)
    assert ax.count == 6
    assert ax.bytes == 3 * 4 + 3 * 48 + 4 + 48    # the mask as int32
    assert psum(None, x) is x                                  # one device
    with pytest.raises(ValueError, match="is not the"):
        multihost.hybrid_mesh(2, 2, device_type="cpu")
    a, b = torch.arange(5), torch.arange(5).flip(0)
    assert not torch.equal(digest([a]), digest([b]))
    check_replicated(ax, [a, mask])


def test_replicate_to_global():
    """A tree of host-identical numpy arrays (NamedTuple, state dataclass)
    on the named device, structure and values kept."""
    from pymht_tpu_torch.core.grow import Scan
    from pymht_tpu_torch.core.state import empty_state
    sc = Scan(z=np.ones((3, 2), np.float32), mask=np.ones(3, bool),
              time=np.float32(2.5) * np.ones((), np.float32))
    st = empty_state(SHAPES, PARAMS, "cpu")
    got_sc, got_st = multihost.replicate_to_global((sc, st), device="cpu")
    assert isinstance(got_sc, Scan) and got_sc.z.dtype == torch.float32
    assert torch.equal(got_sc.mask, torch.ones(3, dtype=torch.bool))
    assert type(got_st) is type(st) and torch.equal(got_st.lam, st.lam)

"""The port's target-sharded selection (pymht_tpu_torch/parallel/
distributed_select.py) against the JAX package's on its virtual CPU mesh.

The states are tests/test_distributed_select.py's: the conflicted
forest, the conflict-dense "monster" forest whose independent decode is
infeasible, and the conflict-free forest of its fast-path test.  JAX's
``make_distributed_select``, compact and full, runs on 2 and 4 virtual
devices in this process; the port's runs once per module on four gloo
CPU ranks (the 2-rank cases on a group of ranks 0-1), compact and full,
and compact again with the scatter contested build forced
(``select._INT32_WALL = 0``), which is held to JAX's dense build.  The
selections and feasibility must be equal, objective and bound within
1e-5 (1 + |obj|), and the duals within 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from pymht_tpu.core.grow import Scan, grow  # noqa: E402
from pymht_tpu.core.select import _independent_best  # noqa: E402
from pymht_tpu.core.state import empty_state, insert_targets  # noqa: E402
from pymht_tpu.models import pv  # noqa: E402
from pymht_tpu.parallel.distributed_select import (  # noqa: E402
    make_distributed_select)
from tests.test_distributed_select import (  # noqa: E402
    PARAMS, SHAPES, _conflicted_state, _monster_state)
from tests.test_torch_sharded_tracker import (  # noqa: E402
    jax_compiles_once)
from tests.torch_dist_worker import (  # noqa: E402
    config_json, launch, numpy_fields)

STATES = ("conflicted", "monster", "conflict_free")
RANKS = (2, 4)
RTOL = 1e-5


def _conflict_free_state():
    """test_compact_fast_path_conflict_free's forest: far-apart targets,
    no shared gates."""
    rng = np.random.default_rng(4)
    state = empty_state(SHAPES, PARAMS)
    xs = np.zeros((8, 4), np.float32)
    for i in range(8):
        xs[i, :2] = [300.0 * i, 200.0 * (i % 2)]
        xs[i, 2:] = [1.0, 0.0]
    state = insert_targets(state, jnp.asarray(xs),
                           jnp.broadcast_to(pv.P0, (8, 4, 4)),
                           jnp.ones(8, bool), jnp.zeros(8, jnp.int32),
                           jnp.asarray(0.0), PARAMS)
    z = (xs[:, :2] + xs[:, 2:] * 2.5
         + rng.normal(0, 1.0, (8, 2))).astype(np.float32)
    zp = np.zeros((16, 2), np.float32)
    zp[:8] = z
    mask = np.zeros(16, bool)
    mask[:8] = True
    scan = Scan(z=jnp.asarray(zp), mask=jnp.asarray(mask),
                time=jnp.asarray(2.5, jnp.float32))
    return grow(state, scan, None, SHAPES, PARAMS,
                use_gate_kernel=False).state


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's results and the port's, every case, from one launch."""
    states = {"conflicted": _conflicted_state(),
              "monster": _monster_state(),
              "conflict_free": _conflict_free_state()}
    jax_out = {}
    with jax_compiles_once():
        for n in RANKS:
            mesh = Mesh(np.array(jax.devices()[:n]), ('cluster',))
            for impl in ("compact", "full"):
                run = make_distributed_select(mesh, SHAPES, PARAMS, impl=impl)
                for name, st in states.items():
                    jax_out[(name, impl, n)] = [np.asarray(a)
                                                for a in run(st)]
    inputs = {"config": config_json(SHAPES, PARAMS),
              "names": np.array(",".join(STATES))}
    for name, st in states.items():
        inputs.update(numpy_fields(st, f"{name}."))
    d = tmp_path_factory.mktemp("dist_select")
    np.savez(d / "in.npz", **inputs)
    outs = launch("select", 4, str(d / "in.npz"), str(d))
    _, _, feas0 = _independent_best(states["monster"], SHAPES, PARAMS)
    return jax_out, outs, bool(feas0)


def _check(port, ref, what):
    sel, obj, lb, feas, lam = ref
    np.testing.assert_array_equal(port["sel"], sel, err_msg=what)
    assert bool(port["feas"]) == bool(feas), what
    tol = RTOL * (1 + abs(float(obj)))
    assert abs(float(port["obj"]) - float(obj)) <= tol, \
        (what, float(port["obj"]), float(obj))
    assert abs(float(port["lb"]) - float(lb)) <= tol, \
        (what, float(port["lb"]), float(lb))
    np.testing.assert_allclose(port["lam"], lam, rtol=0, atol=RTOL,
                               err_msg=what)


def _port(outs, name, key, n):
    """Rank 0's results; the global ones must be equal on every rank of
    the group."""
    pre = f"{name}.{key}.{n}."
    res = {k[len(pre):]: v for k, v in outs[0].items() if k.startswith(pre)}
    for r in range(1, n):
        for k, v in res.items():
            np.testing.assert_array_equal(outs[r][pre + k], v,
                                          err_msg=f"rank {r} {pre}{k}")
    return res


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("impl", ("compact", "full"))
@pytest.mark.parametrize("name", STATES)
def test_matches_jax(runs, name, impl, n):
    jax_out, outs, _ = runs
    _check(_port(outs, name, impl, n), jax_out[(name, impl, n)],
           f"{name} {impl} at {n} ranks")


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("name", STATES)
def test_forced_scatter_build_matches_jax_dense(runs, name, n):
    jax_out, outs, _ = runs
    _check(_port(outs, name, "scatter", n), jax_out[(name, "compact", n)],
           f"{name} scatter build at {n} ranks")


def test_monster_needs_the_repair(runs):
    """The conflict-dense forest starts infeasible, and every port run on
    it ends feasible."""
    _, outs, feas0 = runs
    assert not feas0
    for key in ("compact", "full", "scatter"):
        for n in RANKS:
            assert bool(_port(outs, "monster", key, n)["feas"]), (key, n)


def test_conflict_free_takes_the_fast_path(runs):
    """On the conflict-free forest the compact select returns the
    independent optimum: bound equal to objective, duals untouched."""
    _, outs, _ = runs
    for n in RANKS:
        res = _port(outs, "conflict_free", "compact", n)
        assert float(res["obj"]) == float(res["lb"])
        assert not res["lam"].any()

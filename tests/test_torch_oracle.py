"""The port's exact oracles (utils/oracle.py: scipy/HiGHS; native/: the
C++ branch-and-bound and the Jonker-Volgenant LAP) against the JAX
package's on the same forests and instances, and against each other.

Objectives must agree to 1e-6 (both sides solve the same 0/1 program in
float64); every oracle must prove optimality.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from scipy.optimize import linear_sum_assignment  # noqa: E402

from pymht_tpu import native as jnative  # noqa: E402
from pymht_tpu.utils import oracle as joracle  # noqa: E402
from pymht_tpu_torch import native as tnative, sync  # noqa: E402
from pymht_tpu_torch.core import select as tsel  # noqa: E402
from pymht_tpu_torch.kernels import build  # noqa: E402
from pymht_tpu_torch.utils import oracle as toracle  # noqa: E402
from test_torch_select_ipm import (  # noqa: E402
    ais_scene, jax_cfg, radar_scene, to_jax)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The solvers are thousands of tiny ops: torch's intra-op thread pool
    adds only contention when several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["radar", "ais"])
def scene(request):
    shapes, params, forests = {"radar": radar_scene,
                               "ais": ais_scene}[request.param]()
    return shapes, params, forests[1:6]


def test_milp_oracle_matches_jax(scene):
    shapes, params, forests = scene
    for tst in forests:
        n0 = sync.count
        sel_t, obj_t, opt_t = toracle.milp_select_oracle(tst, shapes, params)
        assert sync.count - n0 == 1             # one fetch of the problem
        sel_j, obj_j, opt_j = joracle.milp_select_oracle(
            to_jax(tst), jax_cfg(shapes), jax_cfg(params))
        assert opt_t and opt_j
        assert abs(obj_t - obj_j) <= 1e-9
        np.testing.assert_array_equal(sel_t, sel_j)


def test_native_oracle_matches_highs(scene):
    shapes, params, forests = scene
    for tst in forests:
        sel_m, obj_m, opt_m = toracle.milp_select_oracle(tst, shapes, params)
        sel_n, obj_n, opt_n = toracle.native_select_oracle(tst, shapes,
                                                           params)
        assert opt_m and opt_n
        assert abs(obj_m - obj_n) <= 1e-6
        f, _, tgt, _, _, _ = toracle.host_problem(tst, shapes, params)
        assert abs(sum(f[t, sel_n[t]] for t in range(len(tgt)) if tgt[t])
                   - obj_n) <= 1e-6


@pytest.mark.parametrize("method", ["lagrangian", "ipm", "lagrangian_pure"])
def test_selection_gap_matches_jax(scene, method):
    """The gap of the port's selection, by the port's oracle and by the
    JAX package's on the same forest: the same number, inside the 0.1 %
    contract for the production solver and for 'ipm'."""
    shapes, params, forests = scene
    for tst in forests[:3]:
        res = tsel.select(tst, shapes, params, method=method)
        assert bool(res.feasible)
        tst = tst.replace(sel_leaf=res.sel)
        n0 = sync.count
        gap_t = toracle.selection_gap(tst, shapes, params)
        assert sync.count - n0 == 1             # one fetch of the problem
        gap_j = joracle.selection_gap(to_jax(tst), jax_cfg(shapes),
                                      jax_cfg(params))
        assert gap_t is not None and gap_j is not None
        assert abs(gap_t - gap_j) <= 1e-9
        assert gap_t >= -1e-6
        if method != "lagrangian_pure":
            assert gap_t <= 1e-3, gap_t


def test_selection_gap_is_none_without_a_proof(scene, monkeypatch):
    shapes, params, forests = scene
    monkeypatch.setattr(toracle, "milp_select_oracle",
                        lambda *a, **k: (np.zeros(1, int), 0.0, False))
    assert toracle.selection_gap(forests[0], shapes, params) is None


def _random_instance(seed):
    """tests/test_native.py's instance."""
    rng = np.random.default_rng(seed)
    T, L, R = int(rng.integers(2, 8)), 6, int(rng.integers(3, 12))
    f = rng.normal(0, 2, (T, L))
    leaf_rows = []
    for t in range(T):
        for l in range(L):
            leaf_rows.append([] if l == 0 else sorted(rng.choice(
                R, rng.integers(0, 3), replace=False).tolist()))
    return f, leaf_rows, R


@pytest.mark.parametrize("seed", range(6))
def test_native_bnb_matches_the_jax_packages(seed):
    f, leaf_rows, R = _random_instance(seed)
    if seed == 5:
        f[1, 2:] = np.inf                       # masked leaves
    sel_t, obj_t, opt_t = tnative.solve_ilp_exact(f, leaf_rows, R)
    sel_j, obj_j, opt_j = jnative.solve_ilp_exact(f, leaf_rows, R)
    assert opt_t and opt_j and obj_t == obj_j
    np.testing.assert_array_equal(sel_t, sel_j)
    used = [r for t, l in enumerate(sel_t)
            for r in leaf_rows[t * f.shape[1] + l]]
    assert len(used) == len(set(used))
    # a node budget of one proves nothing
    assert not tnative.solve_ilp_exact(f, leaf_rows, R, max_nodes=1)[2]


@pytest.mark.parametrize("seed", range(4))
def test_native_lap_matches_scipy_and_the_jax_packages(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 20))
    cost = rng.uniform(0, 100, (n, n))
    col_t, total_t = tnative.solve_lap_jv(cost)
    col_j, total_j = jnative.solve_lap_jv(cost)
    r, c = linear_sum_assignment(cost)
    assert abs(total_t - cost[r, c].sum()) < 1e-9 and total_t == total_j
    np.testing.assert_array_equal(col_t, col_j)
    assert sorted(col_t.tolist()) == list(range(n))


def test_native_library_is_built_from_the_ports_source(monkeypatch):
    """The library comes from csrc/exact_solver.cpp, lands in the
    git-ignored build directory under a name that hashes the source, and
    a failing build raises instead of falling back."""
    so = build.library_path("exact_solver")
    assert so.parent == build.BUILD_DIR and so.is_file()
    assert so.with_suffix(".log").is_file()
    assert build.build("exact_solver") == so
    assert build.library_path("gate_score") != so
    with pytest.raises(FileNotFoundError):
        build.library_path("no_such_source")
    monkeypatch.setattr(build, "HOST_FLAGS",
                        build.HOST_FLAGS + ("-no-such-flag-xyz",))
    assert build.library_path("exact_solver") != so
    with pytest.raises(RuntimeError, match="exact_solver.cpp"):
        build.build("exact_solver")

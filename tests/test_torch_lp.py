"""The port's LP / branch-and-bound solver (pymht_tpu_torch/ops/lp.py)
against the JAX package's (pymht_tpu/ops/lp.py) on the random MHT-shaped
instances of tests/test_lp.py, made from numpy seeds.

Tolerances: ``solve_lp`` x within 2e-3, objective within 1e-4 relative,
iteration count within 2 (the two Choleskys round differently; the one
padded instance on which their step guards decide differently has a test
of its own with what agrees there);
``round_and_repair``, ``coordinate_descent`` and ``lagrangian_polish``
select the same leaves, bounds within 1e-4; ``solve_ilp`` selects the
same leaves on seeds 0-9.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from pymht_tpu.ops import lp as jlp  # noqa: E402
from pymht_tpu_torch import sync  # noqa: E402
from pymht_tpu_torch.ops import lp as tlp  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The solvers are thousands of tiny ops: torch's intra-op thread pool
    adds only contention when several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _instance(seed, T=None, L=8, R=None, max_rows_per_leaf=3):
    """tests/test_lp.py's instance: T targets of L leaves, R single-use
    rows, each leaf on up to three of them, leaf 0 of each target free."""
    rng = np.random.default_rng(seed)
    T = T or int(rng.integers(2, 10))
    R = R or int(rng.integers(4, 16))
    n = T * L
    f = rng.normal(0.0, 2.0, n).astype(np.float32)
    A_eq = np.zeros((T, n), np.float32)
    for t in range(T):
        A_eq[t, t * L:(t + 1) * L] = 1
    A_in = np.zeros((R, n), np.float32)
    for j in range(n):
        for row in rng.choice(R, rng.integers(0, max_rows_per_leaf + 1),
                              replace=False):
            A_in[row, j] = 1
    for t in range(T):
        A_in[:, t * L] = 0
    return dict(f=f, A_eq=A_eq, b_eq=np.ones(T, np.float32), A_in=A_in,
                b_in=np.ones(R, np.float32), var_mask=np.ones(n, bool),
                eq_mask=np.ones(T, bool), in_mask=np.ones(R, bool)), T, L, R


LP_ARGS = ("f", "A_eq", "b_eq", "A_in", "b_in", "var_mask", "eq_mask",
           "in_mask")


def _both(inst, names=LP_ARGS):
    return ([jnp.asarray(inst[k]) for k in names],
            [torch.from_numpy(inst[k]) for k in names])


def _padded(inst, T, L, R):
    """The instance embedded in a larger padded problem."""
    n = T * L
    pn, pp, pr = n + 16, T + 4, R + 8
    out = dict(f=np.zeros(pn, np.float32), A_eq=np.zeros((pp, pn), np.float32),
               b_eq=np.zeros(pp, np.float32),
               A_in=np.zeros((pr, pn), np.float32),
               b_in=np.ones(pr, np.float32), var_mask=np.zeros(pn, bool),
               eq_mask=np.zeros(pp, bool), in_mask=np.zeros(pr, bool))
    out["f"][:n] = inst["f"]
    out["A_eq"][:T, :n] = inst["A_eq"]
    out["b_eq"][:T] = inst["b_eq"]
    out["A_in"][:R, :n] = inst["A_in"]
    out["var_mask"][:n] = True
    out["eq_mask"][:T] = True
    out["in_mask"][:R] = True
    return out


def _check_lp(sol_t, sol_j):
    np.testing.assert_allclose(sol_t.x.numpy(), np.asarray(sol_j.x),
                               atol=2e-3)
    obj_j = float(sol_j.obj)
    assert abs(float(sol_t.obj) - obj_j) <= 1e-4 * (1.0 + abs(obj_j))
    assert abs(int(sol_t.iters) - int(sol_j.iters)) <= 2
    assert float(sol_t.mu) < 1e-4


@pytest.mark.parametrize("seed", range(6))
def test_solve_lp_matches_jax(seed):
    inst, T, L, R = _instance(seed)
    ja, ta = _both(inst)
    n0 = sync.count
    sol_t = tlp.solve_lp(*ta)
    assert sync.count - n0 == int(sol_t.iters) + 1     # one read per round
    _check_lp(sol_t, jlp.solve_lp(*ja))


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 5, 6, 7])
def test_solve_lp_padding_matches_jax(seed):
    inst, T, L, R = _instance(seed)
    pad = _padded(inst, T, L, R)
    ja, ta = _both(pad)
    sol_t, sol_j = tlp.solve_lp(*ta), jlp.solve_lp(*ja)
    _check_lp(sol_t, sol_j)
    assert not sol_t.x.numpy()[T * L:].any()
    plain = tlp.solve_lp(*_both(inst)[1])
    assert abs(float(plain.obj) - float(sol_t.obj)) < 2e-3


def test_solve_lp_padding_where_the_choleskys_part():
    """Padded seed 4 is the instance on which the two packages' step
    guards decide differently: the JAX solver's sixth and last step comes
    out non-finite and is rejected, so it stops at a complementarity of
    3e-4; LAPACK's factor through torch is finite, the step is taken and
    the port ends at 2e-7.  Both stop at the same count.  The port's
    iterate is held to what does agree: the JAX iterate within 6e-3 in x
    and 2e-3 (1 + |obj|) in objective (5.1e-3 and 1.0e-3 observed), and
    the unpadded solves of both packages, which converge, within the
    usual 1e-4 (1 + |obj|)."""
    inst, T, L, R = _instance(4)
    ja, ta = _both(_padded(inst, T, L, R))
    sol_t, sol_j = tlp.solve_lp(*ta), jlp.solve_lp(*ja)
    assert abs(int(sol_t.iters) - int(sol_j.iters)) <= 2
    assert float(sol_t.mu) < 1e-4
    assert float(sol_t.mu) <= float(sol_j.mu)      # the port went no less far
    np.testing.assert_allclose(sol_t.x.numpy(), np.asarray(sol_j.x),
                               atol=6e-3)
    obj_t, obj_j = float(sol_t.obj), float(sol_j.obj)
    assert abs(obj_t - obj_j) <= 2e-3 * (1.0 + abs(obj_j))
    assert not sol_t.x.numpy()[T * L:].any()       # no padded variable moves
    assert not np.asarray(sol_j.x)[T * L:].any()
    ja0, ta0 = _both(inst)
    for plain in (tlp.solve_lp(*ta0), jlp.solve_lp(*ja0)):
        assert abs(obj_t - float(plain.obj)) \
            <= 1e-4 * (1.0 + abs(float(plain.obj)))
    np.testing.assert_allclose(sol_t.x.numpy()[:T * L],
                               tlp.solve_lp(*ta0).x.numpy(), atol=2e-3)


def test_solve_lp_max_iters_is_a_python_bound():
    inst, T, L, R = _instance(0)
    ja, ta = _both(inst)
    sol_t, sol_j = tlp.solve_lp(*ta, max_iters=3), jlp.solve_lp(*ja,
                                                                max_iters=3)
    assert int(sol_t.iters) == int(sol_j.iters) == 3
    np.testing.assert_allclose(sol_t.x.numpy(), np.asarray(sol_j.x),
                               atol=2e-3)


def test_non_pd_normal_matrix_keeps_the_last_iterate(monkeypatch):
    """A normal matrix that is not positive definite must not raise: the
    factor comes back NaN (as ``jnp.linalg.cholesky``'s does), the step
    is rejected, the last good iterate is kept and the loop ends."""
    bad = torch.tensor([[1.0, 2.0], [2.0, 1.0]])
    assert torch.isnan(tlp._cholesky_or_nan(bad)).all()
    assert np.isnan(np.asarray(jnp.linalg.cholesky(bad.numpy()))).any()
    good = tlp._cholesky_or_nan(torch.eye(2) * 4.0)
    np.testing.assert_array_equal(good.numpy(), 2.0 * np.eye(2))

    # the third factorisation of a solve fails, the way LAPACK reports
    # it: a partly written factor and a non-zero info
    inst, T, L, R = _instance(2)
    ta = _both(inst)[1]
    two = tlp.solve_lp(*ta, max_iters=2)
    real, calls = torch.linalg.cholesky_ex, []

    def failing(M, **kw):
        calls.append(kw)
        Lc, info = real(M, **kw)
        if len(calls) == 3:
            return Lc * 0.5, torch.ones_like(info)
        return Lc, info

    monkeypatch.setattr(torch.linalg, "cholesky_ex", failing)
    sol = tlp.solve_lp(*ta)
    assert len(calls) == 3 and all(kw == dict(check_errors=False)
                                   for kw in calls)
    assert int(sol.iters) == 3
    np.testing.assert_array_equal(sol.x.numpy(), two.x.numpy())
    assert float(sol.mu) == float(two.mu)


def test_full_f32_matmul_restores_the_callers_setting():
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        for setting in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = setting
            with tlp.full_f32_matmul():
                assert torch.backends.cuda.matmul.allow_tf32 is False
            assert torch.backends.cuda.matmul.allow_tf32 is setting
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _repair_args(inst, T, L, seed, mask_targets):
    rng = np.random.default_rng(100 + seed)
    tgt = np.ones(T, bool)
    if mask_targets:
        tgt[rng.integers(0, T)] = False
    tau = rng.random(T * L).astype(np.float32)
    return tau, tgt


@pytest.mark.parametrize("banned", [False, True])
@pytest.mark.parametrize("seed", range(5))
def test_round_and_repair_matches_jax(seed, banned):
    inst, T, L, R = _instance(seed)
    tau, tgt = _repair_args(inst, T, L, seed, mask_targets=banned)
    b0 = None
    if banned:
        b0 = np.random.default_rng(seed).random((T, L)) < 0.2
        b0[:, 0] = False
    n0 = sync.count
    sel_t, feas_t = tlp.round_and_repair(
        torch.from_numpy(tau), torch.from_numpy(inst["f"]),
        torch.from_numpy(inst["A_in"]), torch.from_numpy(inst["in_mask"]),
        T, L, torch.from_numpy(tgt),
        banned0=None if b0 is None else torch.from_numpy(b0))
    assert sync.count == n0                            # fixed trip: no read
    sel_j, feas_j = jlp.round_and_repair(
        jnp.asarray(tau), jnp.asarray(inst["f"]), jnp.asarray(inst["A_in"]),
        jnp.asarray(inst["in_mask"]), T, L, jnp.asarray(tgt),
        banned0=None if b0 is None else jnp.asarray(b0))
    np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_j))
    assert bool(feas_t) == bool(feas_j)


@pytest.mark.parametrize("seed", range(5))
def test_coordinate_descent_matches_jax(seed):
    inst, T, L, R = _instance(seed)
    _, tgt = _repair_args(inst, T, L, seed, mask_targets=seed % 2 == 1)
    sel0 = np.zeros(T, np.int32)           # the free leaves: feasible
    n0 = sync.count
    sel_t = tlp.coordinate_descent(
        torch.from_numpy(inst["f"]), torch.from_numpy(inst["A_in"]),
        torch.from_numpy(inst["in_mask"]), T, L, torch.from_numpy(tgt),
        torch.from_numpy(sel0).long())
    assert sync.count == n0
    sel_j = jlp.coordinate_descent(
        jnp.asarray(inst["f"]), jnp.asarray(inst["A_in"]),
        jnp.asarray(inst["in_mask"]), T, L, jnp.asarray(tgt),
        jnp.asarray(sel0))
    np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_j))
    assert (sel_t.numpy() != sel0).any()


@pytest.mark.parametrize("seed", range(4))
def test_lagrangian_polish_matches_jax(seed):
    inst, T, L, R = _instance(seed)
    tgt = np.ones(T, bool)
    n0 = sync.count
    out_t = tlp.lagrangian_polish(
        torch.from_numpy(inst["f"]), torch.from_numpy(inst["A_in"]),
        torch.from_numpy(inst["in_mask"]), T, L, torch.from_numpy(tgt),
        torch.zeros(T, dtype=torch.int64), torch.tensor(float("inf")),
        torch.tensor(False))
    assert sync.count == n0
    out_j = jlp.lagrangian_polish(
        jnp.asarray(inst["f"]), jnp.asarray(inst["A_in"]),
        jnp.asarray(inst["in_mask"]), T, L, jnp.asarray(tgt),
        jnp.zeros(T, jnp.int32), jnp.asarray(jnp.inf, jnp.float32),
        jnp.asarray(False))
    np.testing.assert_array_equal(out_t[0].numpy(), np.asarray(out_j[0]))
    assert bool(out_t[2]) and bool(out_j[2])
    for a, b in zip((out_t[1], out_t[3]), (out_j[1], out_j[3])):
        assert abs(float(a) - float(b)) <= 1e-4 * (1.0 + abs(float(b)))


@pytest.mark.parametrize("seed", range(10))
def test_solve_ilp_matches_jax(seed):
    inst, T, L, R = _instance(seed)
    ja, ta = _both(inst)
    tgt = np.ones(T, bool)
    n0 = sync.count
    sel_t, feas_t, obj_t, bound_t = tlp.solve_ilp(
        *ta, T, L, torch.from_numpy(tgt), budget=8)
    reads = sync.count - n0
    sel_j, feas_j, obj_j, bound_j = jlp.solve_ilp(
        *ja, T, L, jnp.asarray(tgt), budget=8)
    assert bool(feas_t) and bool(feas_j)
    obj_j = float(obj_j)
    # a differing selection would have to score the same
    assert abs(float(obj_t) - obj_j) <= 1e-4 * (1.0 + abs(obj_j))
    np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_j))
    assert abs(float(bound_t) - float(bound_j)) \
        <= 1e-3 * (1.0 + abs(float(bound_j)))
    assert float(bound_t) <= float(obj_t) + 1e-2 * (1.0 + abs(obj_j))
    # at most 8 nodes of at most 30 interior-point rounds, one read each
    assert reads <= 8 * 32


def test_solve_ilp_conflict_forces_split():
    """Two targets, both preferring the same measurement: only one may
    keep it."""
    f = np.array([-5.0, -1.0, -4.0, -1.0], np.float32)
    A_eq = np.array([[1, 1, 0, 0], [0, 0, 1, 1]], np.float32)
    A_in = np.array([[1, 0, 1, 0]], np.float32)
    t = torch.from_numpy
    sel, feas, obj, _ = tlp.solve_ilp(
        t(f), t(A_eq), torch.ones(2), t(A_in), torch.ones(1),
        torch.ones(4, dtype=torch.bool), torch.ones(2, dtype=torch.bool),
        torch.ones(1, dtype=torch.bool), 2, 2,
        torch.ones(2, dtype=torch.bool), budget=4)
    assert bool(feas)
    assert sel.tolist() == [0, 1]
    assert abs(float(obj) + 6.0) < 1e-4


def test_first_extremum_on_exact_ties():
    """``argmax`` / ``argmin`` return the FIRST extremum as ``jnp`` does,
    on floats, on casts of bools and with -inf masks; and the functions
    built on them agree with JAX on instances made of exact ties."""
    vals = np.array([3.0, 7.0, 7.0, -2.0, 7.0, -2.0], np.float32)
    assert int(torch.from_numpy(vals).argmax()) == int(jnp.argmax(vals)) == 1
    assert int(torch.from_numpy(vals).argmin()) == int(jnp.argmin(vals)) == 3
    act = np.array([True, True, False, True, False])
    assert int(torch.from_numpy(act).int().argmin()) \
        == int(jnp.argmin(jnp.asarray(act))) == 2
    ninf = np.full(5, -np.inf, np.float32)
    assert int(torch.from_numpy(ninf).argmax()) == int(jnp.argmax(ninf)) == 0
    rows = np.tile(vals, (3, 1))
    np.testing.assert_array_equal(
        torch.from_numpy(rows).argmax(dim=1).numpy(),
        np.asarray(jnp.argmax(rows, axis=1)))

    # every leaf of every target scores the same and weighs the same; all
    # leaves but the last two of each target sit on the one shared row
    T, L = 4, 6
    f = np.full(T * L, -1.0, np.float32)
    tau = np.full(T * L, 0.5, np.float32)
    A_in = np.zeros((2, T * L), np.float32)
    A_in[0].reshape(T, L)[:, :L - 2] = 1
    in_mask, tgt = np.ones(2, bool), np.ones(T, bool)
    sel_t, feas_t = tlp.round_and_repair(
        torch.from_numpy(tau), torch.from_numpy(f), torch.from_numpy(A_in),
        torch.from_numpy(in_mask), T, L, torch.from_numpy(tgt))
    sel_j, feas_j = jlp.round_and_repair(
        jnp.asarray(tau), jnp.asarray(f), jnp.asarray(A_in),
        jnp.asarray(in_mask), T, L, jnp.asarray(tgt))
    np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_j))
    assert bool(feas_t) and bool(feas_j)
    cd_t = tlp.coordinate_descent(
        torch.from_numpy(f), torch.from_numpy(A_in),
        torch.from_numpy(in_mask), T, L, torch.from_numpy(tgt), sel_t)
    cd_j = jlp.coordinate_descent(
        jnp.asarray(f), jnp.asarray(A_in), jnp.asarray(in_mask), T, L,
        jnp.asarray(tgt), sel_j)
    np.testing.assert_array_equal(cd_t.numpy(), np.asarray(cd_j))

"""Host-side exact selection oracles for gap validation (counterpart of
pymht_tpu/utils/oracle.py).

The production solve runs on the device.  For validation there are two
host oracles: the native C++ branch-and-bound (pymht_tpu_torch/native,
good for small instances, with a proven-optimal flag) and this
scipy/HiGHS MILP formulation, which scales to full bench-size forests in
seconds.  Both read a TrackerState on any device after ONE transfer.
"""
from __future__ import annotations

import numpy as np


def host_problem(state, shapes, params):
    """The selection problem of ``state`` as numpy, after one transfer:
    (f [T, L] float64 leaf scores, leaf_mask [T, L], tgt_mask [T],
    slots_flat [T, L, 2W] single-use slot ids, n_slots, sel_leaf [T])."""
    from ..core.select import _slot_index, leaf_scores
    from ..core.tracker import tensors_to_host
    slots, n_slots = _slot_index(state, shapes)
    T, L = state.leaf_mask.shape
    f, lmask, tgt, slots_flat, sel = tensors_to_host(
        [leaf_scores(state, params), state.leaf_mask, state.tgt_mask,
         slots.reshape(T, L, -1).int(), state.sel_leaf])
    return f.astype(np.float64), lmask, tgt, slots_flat, n_slots, sel


def _leaf_rows(problem):
    """Per flat leaf j = t * L + l of an active target, the sorted
    single-use slots it takes; [] for dead leaves and inactive targets."""
    _, lmask, tgt, slots_flat, n_slots, _ = problem
    T, L = lmask.shape
    return [sorted(set(int(x) for x in slots_flat[t, l] if x < n_slots))
            if tgt[t] and lmask[t, l] else []
            for t in range(T) for l in range(L)]


def milp_select_oracle(state, shapes, params, time_limit=120.0,
                       problem=None):
    """Exact global-hypothesis selection via scipy.optimize.milp (HiGHS).

    Returns (sel [T], objective_over_active_targets, proven_optimal).
    Mirrors the on-device problem exactly: one leaf per target,
    single-use (window-scan, measurement) slots.  ``problem``: what
    ``host_problem`` returned for this state, to share one transfer
    between several oracle calls.
    """
    from scipy import sparse
    from scipy.optimize import milp, LinearConstraint, Bounds

    if problem is None:
        problem = host_problem(state, shapes, params)
    f, lmask, tgt, _, n_slots, _ = problem
    T, L = f.shape
    n = T * L
    fo = np.where(lmask, f, 1e7).reshape(-1)
    for t in range(T):
        if not tgt[t]:
            fo[t * L] = 0.0
    rows, cols = [], []
    for j, slots in enumerate(_leaf_rows(problem)):
        rows += slots
        cols += [j] * len(slots)
    A_in = sparse.csr_matrix((np.ones(len(rows)), (rows, cols)),
                             shape=(n_slots, n))
    A_eq = sparse.csr_matrix(
        (np.ones(n), (np.arange(n) // L, np.arange(n))), shape=(T, n))
    cons = [LinearConstraint(A_eq, 1, 1),
            LinearConstraint(A_in, -np.inf, 1)]
    res = milp(fo, constraints=cons, integrality=np.ones(n),
               bounds=Bounds(0, 1), options={'time_limit': time_limit})
    if res.x is None:
        return None, float('nan'), False
    sel = res.x.reshape(T, L).argmax(axis=1)
    obj = float(sum(fo[t * L + sel[t]] for t in range(T) if tgt[t]))
    return sel, obj, bool(res.status == 0)


def native_select_oracle(state, shapes, params, max_nodes=2_000_000,
                         problem=None):
    """The same problem through the native branch-and-bound
    (native.solve_ilp_exact).  Returns (sel [T], objective over the
    active targets, proven_optimal); inactive targets select leaf 0.
    ``problem`` as in ``milp_select_oracle``."""
    from .. import native
    if problem is None:
        problem = host_problem(state, shapes, params)
    f, lmask, tgt, _, n_slots, _ = problem
    fo = np.where(lmask & tgt[:, None], f, np.inf)
    fo[~tgt, 0] = 0.0
    sel, obj, optimal = native.solve_ilp_exact(fo, _leaf_rows(problem),
                                               n_slots, max_nodes=max_nodes)
    return sel, obj, optimal


def selection_gap(state, shapes, params, time_limit=120.0, problem=None):
    """Relative gap of the state's current selection (``sel_leaf``) vs
    the MILP oracle on the same forest; None if the oracle failed or did
    not prove optimality.  ``problem`` as in ``milp_select_oracle``."""
    if problem is None:
        problem = host_problem(state, shapes, params)
    sel_o, obj_o, optimal = milp_select_oracle(state, shapes, params,
                                               time_limit, problem=problem)
    if sel_o is None or not optimal:
        return None
    f, _, tgt, _, _, sel_dev = problem
    obj_dev = float(sum(f[t, sel_dev[t]] for t in range(f.shape[0])
                        if tgt[t]))
    return (obj_dev - obj_o) / max(1.0, abs(obj_o))

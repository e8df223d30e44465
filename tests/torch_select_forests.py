"""Small selection forests with a known open certificate, for
``tests/test_torch_select_finish.py`` and ``tests/test_torch_tracing.py``
(port only, on the CPU).  Not collected by pytest."""
import numpy as np
import torch

from pymht_tpu_torch import Tracker, TrackerParams, TrackerShapes
from pymht_tpu_torch.core.state import empty_state


def forest(shapes, params, hist_meas, cnllr, spine):
    """A port TrackerState on the CPU whose forest is given explicitly
    (``hist_meas`` [targets, leaves, W], ``cnllr`` with inf for no leaf)."""
    st = empty_state(shapes, params, "cpu")
    Ta, La, W = np.asarray(hist_meas).shape
    T, L = shapes.max_targets, shapes.max_leaves
    hm = np.full((T, L, W), -1, np.int32)
    hm[:Ta, :La] = hist_meas
    cn = np.asarray(cnllr, np.float32)
    lm = np.zeros((T, L), bool)
    lm[:Ta, :La] = np.isfinite(cn)
    cnp = np.zeros((T, L), np.float32)
    cnp[:Ta, :La] = np.where(np.isfinite(cn), cn, 0.0)
    tm = np.zeros(T, bool)
    tm[:Ta] = True
    sp = np.zeros(T, np.int32)
    sp[:Ta] = spine
    depth = np.count_nonzero(hm[:, 0] >= 0, axis=1).astype(np.int32)
    return st.replace(
        hist_meas=torch.from_numpy(hm), leaf_cnllr=torch.from_numpy(cnp),
        leaf_mask=torch.from_numpy(lm), tgt_mask=torch.from_numpy(tm),
        spine_leaf=torch.from_numpy(sp), tgt_depth=torch.from_numpy(depth),
        sel_leaf=torch.from_numpy(sp))


def truncation_forest():
    """Cause (a): two targets sharing measurement 1, whose best joint
    choice lies outside tier 2's top-2 candidates (the optimum 4.0,
    tier 2 alone 5.0)."""
    shapes = TrackerShapes(max_targets=4, max_leaves=4, max_meas=16,
                           max_ais=2, window=6, max_prelim=4,
                           max_initiators=8)
    params = TrackerParams(radar_period=1.0, N=5)
    N, pad = params.N, [-1] * 4
    hist = [[pad + [2, 1], pad + [3, 1], pad + [4, 2], pad + [5, 0]],
            [pad + [6, 1], pad + [7, 0], [-1] * 6, [-1] * 6]]
    cnllr = [[1.0 * N, 1.1 * N, 3.0 * N, 5.0 * N],
             [1.0 * N, 4.0 * N, np.inf, np.inf]]
    return (forest(shapes, params, hist, cnllr, np.asarray([3, 1])),
            shapes, params)


SHAPES_BIG = TrackerShapes(max_targets=16, max_leaves=16, max_meas=32,
                           max_ais=2, window=6, max_prelim=8,
                           max_initiators=32)
PARAMS_BIG = TrackerParams(radar_period=1.0, P_d=0.9, lambda_phi=1e-5,
                           lambda_nu=1e-5, radar_range=500.0)


def dense_cluster():
    """The forest after 8 scans of 8 targets 6 m apart with a false
    return between each pair (tests/test_torch_selection_adversarial.py's
    scans), stepped by the port's Tracker: one cluster of 8 targets,
    tier 3's case."""
    rng = np.random.default_rng(11)
    n, spacing = 8, 6.0
    base = np.array([[0.0, spacing * i, 3.0, 0.0] for i in range(n)])
    tr = Tracker(SHAPES_BIG, PARAMS_BIG, method="lagrangian", use_ais=False,
                 device="cpu")
    tr.pre_initialize(0.0, base)
    for k in range(8):
        t = (k + 1) * 1.0
        zs = [b[:2] + b[2:] * t + rng.normal(0, 1.2, 2) for b in base]
        zs += [base[i][:2] + base[i][2:] * t + np.array([0.0, spacing / 2])
               + rng.normal(0, 1.0, 2) for i in range(n - 1)]
        tr.add_measurement_list(t, np.stack(zs))
    return tr.state

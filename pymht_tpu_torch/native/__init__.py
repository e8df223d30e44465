"""ctypes bindings for the native exact solvers: the branch-and-bound
hypothesis-selection oracle and the Jonker-Volgenant LAP (counterpart of
pymht_tpu/native).  ``csrc/exact_solver.cpp`` is compiled at first use by
``kernels/build.py``; a failed build raises, nothing falls back."""
from __future__ import annotations

import ctypes

import numpy as np

from ..kernels import build

_lib = None


def get_lib():
    global _lib
    if _lib is not None:
        return _lib
    lib = build.load("exact_solver")
    lib.solve_ilp_exact.restype = ctypes.c_double
    lib.solve_ilp_exact.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        np.ctypeslib.ndpointer(np.float64, flags='C'),
        np.ctypeslib.ndpointer(np.int32, flags='C'),
        np.ctypeslib.ndpointer(np.int32, flags='C'),
        ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int32, flags='C'),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.solve_lap_jv.restype = ctypes.c_double
    lib.solve_lap_jv.argtypes = [
        ctypes.c_int,
        np.ctypeslib.ndpointer(np.float64, flags='C'),
        np.ctypeslib.ndpointer(np.int32, flags='C'),
    ]
    _lib = lib
    return lib


def solve_ilp_exact(f, leaf_rows, n_rows, max_nodes=2_000_000):
    """Exact hypothesis-selection oracle.

    f: [T, L] costs (np.inf / >=1e8 for masked leaves);
    leaf_rows: list of lists, the single-use row ids used by each leaf
    (flattened [T*L]); n_rows: number of single-use rows.
    Returns (sel [T], objective, proven_optimal).
    """
    lib = get_lib()
    T, L = f.shape
    fc = np.ascontiguousarray(
        np.where(np.isfinite(f), f, 1e9).astype(np.float64).reshape(-1))
    fc = np.minimum(fc, 1e9)
    ptr = np.zeros(T * L + 1, np.int32)
    rows = []
    for j, rr in enumerate(leaf_rows):
        rows.extend(rr)
        ptr[j + 1] = len(rows)
    rows = np.ascontiguousarray(np.asarray(rows, np.int32).reshape(-1))
    if rows.size == 0:
        rows = np.zeros(1, np.int32)
    sel = np.zeros(T, np.int32)
    opt = ctypes.c_int32(0)
    obj = lib.solve_ilp_exact(T, L, n_rows, fc, rows,
                              np.ascontiguousarray(ptr), max_nodes, sel,
                              ctypes.byref(opt))
    return sel, float(obj), bool(opt.value)


def solve_lap_jv(cost):
    """Exact square LAP (Jonker-Volgenant).  cost: [n, n] float."""
    lib = get_lib()
    n = cost.shape[0]
    c = np.ascontiguousarray(np.asarray(cost, np.float64).reshape(-1))
    out = np.zeros(n, np.int32)
    total = lib.solve_lap_jv(n, c, out)
    return out, float(total)

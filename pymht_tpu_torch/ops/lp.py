"""LP and truncated branch-and-bound solver for the global-hypothesis
selection ILP (counterpart of pymht_tpu/ops/lp.py):

    min f^T tau   s.t.  A1 tau <= 1   (measurement used at most once)
                        A2 tau  = 1   (exactly one leaf per target)
                        tau in {0,1}

The LP relaxation of the whole problem (all clusters at once: the blocks
are independent, so one padded solve covers every cluster) is solved by
an infeasible-start primal-dual interior-point method whose
per-iteration work is a Cholesky factorisation of the constraint-space
normal equations.  ``round_and_repair`` turns the fractional solution
into a feasible integral one; ``solve_ilp`` branches on fractional
variables with a fixed node budget and polishes the incumbent.

Where the JAX functions exit a ``while_loop`` on a device value the
loops here read ONE combined flag per iteration (``sync.flag``); the
fixed-trip loops read nothing.  Every data-dependent index stays on the
device (compares against ``arange``, ``index_select``), and ``argmax`` /
``argmin`` return the first extremum, as ``jnp`` does.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from .. import sync

f32 = torch.float32
INF = float("inf")


class LpSolution(NamedTuple):
    x: torch.Tensor          # [n] primal solution (the tau variables)
    obj: torch.Tensor        # [] objective value
    iters: torch.Tensor      # [] iterations used
    mu: torch.Tensor         # [] final complementarity


@contextlib.contextmanager
def full_f32_matmul():
    """TF32 off for the matmuls inside: the normal equations carry a
    scaling clipped to [1e-8, 1e8], which 10 mantissa bits do not hold.
    The caller's setting is restored on the way out."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _cholesky_or_nan(M):
    """The lower Cholesky factor of ``M``, all NaN where ``M`` is not
    positive definite (``jnp.linalg.cholesky``'s behaviour): no
    exception, no host read."""
    Lc, info = torch.linalg.cholesky_ex(M, check_errors=False)
    return torch.where(info != 0, torch.nan, Lc)


def _alpha_max(v, dv):
    """Largest step in [0,1] keeping v + a*dv >= (1-0.9995) v."""
    neg = dv < 0
    ratio = torch.where(neg, -v / torch.where(neg, dv, -1.0), INF)
    return torch.clamp(0.9995 * ratio.amin(), max=1.0)


def solve_lp(f, A_eq, b_eq, A_in, b_in, var_mask, eq_mask, in_mask,
             max_iters: int = 30, tol: float = 2e-6):
    """Solve  min f.x  s.t.  A_eq x = b_eq, A_in x <= b_in, 0 <= x.

    ``*_mask`` flag valid variables/rows (padding rows must have zero
    coefficients; they are neutralised here).  Infeasible-start
    primal-dual path following with Mehrotra-style adaptive centering;
    the normal-equations matrix is regularised so padded (zero) rows
    stay benign.  A step that comes out non-finite (past convergence the
    normal equations degenerate and the factorisation fails) is rejected:
    the last good iterate is kept and the loop ends.  One host read per
    iteration.
    """
    dev = f.device
    n, p, r = f.shape[0], b_eq.shape[0], b_in.shape[0]

    # Neutralise padding: invalid vars get cost 1 and a zero column,
    # invalid rows become 0 = 0 / 0 <= 1.
    A_eq = torch.where(eq_mask[:, None] & var_mask[None, :], A_eq.to(f32), 0.0)
    A_in = torch.where(in_mask[:, None] & var_mask[None, :], A_in.to(f32), 0.0)
    b_eq = torch.where(eq_mask, b_eq.to(f32), 0.0)
    b_in = torch.where(in_mask, b_in.to(f32), 1.0)
    f = torch.where(var_mask, f.to(f32), 1.0)

    # Standard form with slacks: xs = [x; s], A = [[A_eq, 0], [A_in, I]].
    m, nv = p + r, n + r
    A = torch.zeros((m, nv), dtype=f32, device=dev)
    A[:p, :n] = A_eq
    A[p:, :n] = A_in
    A[p:, n:] = torch.eye(r, dtype=f32, device=dev)
    At = A.T
    b = torch.cat([b_eq, b_in])
    c = torch.cat([f, torch.zeros((r,), dtype=f32, device=dev)])
    reg = 1e-6 * torch.eye(m, dtype=f32, device=dev)   # normal-eq. regulariser

    x = torch.ones((nv,), dtype=f32, device=dev)
    z = torch.ones((nv,), dtype=f32, device=dev)
    y = torch.zeros((m,), dtype=f32, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)

    with full_f32_matmul():
        it = 0
        while it < max_iters:
            rp = b - A @ x
            mu = torch.dot(x, z) / nv
            if not sync.flag(ok & ((mu > tol) | (rp.abs().amax() > 1e-4))):
                break
            rd = c - At @ y - z
            # One factorisation of M = A D A^T + delta I serves the
            # predictor and the corrector: D depends on (x, z) only.
            zc = torch.clamp(z, min=1e-12)
            d = torch.clamp(x / zc, 1e-8, 1e8)
            Lc = _cholesky_or_nan((A * d[None, :]) @ At + reg)

            def nt_solve(rhs_mu):
                """One Newton solve of the KKT system via the normal
                equations, for the target complementarity ``rhs_mu``."""
                rhs = rp + A @ (d * rd - rhs_mu / zc)
                dy = torch.cholesky_solve(rhs[:, None], Lc)[:, 0]
                dx = d * (At @ dy - rd) + rhs_mu / zc
                dz = (rhs_mu - z * dx) / torch.clamp(x, min=1e-12)
                return dx, dy, dz

            # Affine (predictor) direction
            dx_a, _, dz_a = nt_solve(-x * z)
            ap, ad = _alpha_max(x, dx_a), _alpha_max(z, dz_a)
            mu_aff = torch.dot(x + ap * dx_a, z + ad * dz_a) / nv
            sigma = torch.clamp((mu_aff / torch.clamp(mu, min=1e-15)) ** 3,
                                1e-4, 0.9)
            # Corrector
            dx, dy, dz = nt_solve(sigma * mu - x * z - dx_a * dz_a)
            ap, ad = _alpha_max(x, dx), _alpha_max(z, dz)
            x_new, y_new, z_new = x + ap * dx, y + ad * dy, z + ad * dz
            ok = (torch.isfinite(x_new).all() & torch.isfinite(y_new).all()
                  & torch.isfinite(z_new).all())
            x = torch.where(ok, x_new, x)
            y = torch.where(ok, y_new, y)
            z = torch.where(ok, z_new, z)
            it += 1

    tau = torch.where(var_mask, x[:n], 0.0)
    return LpSolution(x=tau, obj=torch.dot(f, tau),
                      iters=torch.full((), it, dtype=torch.int32, device=dev),
                      mu=torch.dot(x, z) / nv)


def _onehot(sel, L, tgt_mask):
    """[T*L] f32: 1 at each masked-in target's selected leaf."""
    hot = torch.arange(L, device=sel.device)[None, :] == sel[:, None]
    return (hot & tgt_mask[:, None]).reshape(-1).to(f32)


def solve_ilp(f, A_eq, b_eq, A_in, b_in, var_mask, eq_mask, in_mask,
              T, L, tgt_mask, budget: int = 12, lp_iters: int = 30):
    """Truncated best-first branch-and-bound with LP bounding.

    The common case (the LP relaxation of the assignment polytope is
    integral) exits after a single interior-point solve.  Fractional
    cases branch on the most fractional variable (ban it vs. force it,
    both expressible as ban masks thanks to the one-leaf-per-target
    equality rows) with a fixed node budget, then a Lagrangian
    subgradient and a coordinate-descent polish tighten the incumbent.
    Returns (sel [T], feasible, obj, lower_bound); the gap certificate
    is (obj - lower_bound).  One host read per node after the root.
    """
    BIG = 1e4
    EPS = 1e-5
    n = f.shape[0]
    POOL = budget + 2
    dev = f.device
    f = f.to(f32)
    ar_n = torch.arange(n, device=dev)
    ar_pool = torch.arange(POOL, device=dev)
    f_valid = torch.where(var_mask, f, 0.0)

    def lp_round(bans):
        f_eff = torch.where(bans, f + BIG, f)
        sol = solve_lp(f_eff, A_eq, b_eq, A_in, b_in,
                       var_mask, eq_mask, in_mask, max_iters=lp_iters)
        sel, feas = round_and_repair(sol.x, f_eff, A_in, in_mask,
                                     T, L, tgt_mask,
                                     banned0=bans.reshape(T, L))
        obj = torch.dot(f_valid, _onehot(sel, L, tgt_mask))
        frac = torch.where(var_mask & ~bans,
                           -(sol.x - 0.5).abs(), -INF)      # peak at 0.5
        j_frac = frac.argmax()
        integral = torch.where(var_mask, (sol.x - sol.x.round()).abs(),
                               0.0).amax() < 0.01
        return sel, feas, obj, sol.obj, j_frac, integral

    def insert(pool, bans, prio, expand):
        """Place a node into the first inactive slot; if none, replace
        the worst (highest-priority) active node if strictly better.
        Nothing changes unless ``expand``."""
        pool_bans, pool_prio, pool_act = pool
        has_free = (~pool_act).any()
        free_slot = pool_act.int().argmin()                  # first False
        worst = torch.where(pool_act, pool_prio, -INF).argmax()
        slot = torch.where(has_free, free_slot, worst)
        at_worst = ar_pool == worst
        prio_worst = torch.where(at_worst, pool_prio, 0.0).sum()
        do = expand & (has_free | (prio < prio_worst))
        put = (ar_pool == slot) & do
        return (torch.where(put[:, None], bans[None, :], pool_bans),
                torch.where(put, prio, pool_prio), pool_act | put)

    # Node pool: ban masks + parent-bound priority; the root sits in
    # slot 0.
    pool = (torch.zeros((POOL, n), dtype=torch.bool, device=dev),
            torch.where(ar_pool == 0, -INF, INF).to(f32),
            ar_pool == 0)
    best_sel = torch.zeros((T,), dtype=torch.int64, device=dev)
    best_obj = torch.full((), INF, dtype=f32, device=dev)
    best_feas = torch.zeros((), dtype=torch.bool, device=dev)
    bound = torch.zeros((), dtype=f32, device=dev)

    for it in range(budget):
        pool_bans, pool_prio, pool_act = pool
        if it > 0:
            open_bound = torch.where(pool_act, pool_prio, INF).amin()
            if not sync.flag(pool_act.any() & (open_bound < best_obj - EPS)):
                break
        # Pop the best-bound node.
        popped = ar_pool == torch.where(pool_act, pool_prio, INF).argmin()
        bans = (pool_bans & popped[:, None]).any(dim=0)
        pool = (pool_bans, pool_prio, pool_act & ~popped)

        sel, feas, obj, lp_obj, j_frac, integral = lp_round(bans)
        better = feas & ((obj < best_obj) | ~best_feas)
        best_sel = torch.where(better, sel, best_sel)
        best_obj = torch.where(better, obj, best_obj)
        best_feas = best_feas | feas
        if it == 0:
            bound = lp_obj

        # Branch if fractional and the node bound beats the incumbent.
        expand = ~integral & (lp_obj < best_obj - EPS)
        # Child A: ban j_frac.  Child B: force j_frac == ban every other
        # leaf of its target.
        is_j = ar_n == j_frac
        same_tgt = (ar_n // L) == (j_frac // L)
        pool = insert(pool, bans | is_j, lp_obj, expand)
        pool = insert(pool, bans | (same_tgt & ~is_j), lp_obj, expand)

    # Lagrangian subgradient polish (it cannot improve on an integral LP
    # optimum, but running it is branch-free).
    f_pol = torch.where(var_mask, f, BIG)
    best_sel, best_obj, best_feas, lag_lb = lagrangian_polish(
        f_pol, A_in, in_mask, T, L, tgt_mask, best_sel, best_obj, best_feas)
    bound = torch.maximum(bound, lag_lb)

    # Final monotone polish: exact per-target re-optimisation.
    best_sel = coordinate_descent(f_pol, A_in, in_mask, T, L, tgt_mask,
                                  best_sel)
    best_obj = torch.dot(f_valid, _onehot(best_sel, L, tgt_mask))
    return best_sel, best_feas, best_obj, bound


def lagrangian_polish(f, A_in, in_mask, T, L, tgt_mask,
                      best_sel, best_obj, best_feas,
                      iters: int = 80, theta: float = 1.5):
    """Subgradient ascent on the measurement-usage constraints.

    Dualising A_in tau <= 1 decomposes the problem per target (pick the
    leaf minimising reduced cost f + lambda^T a_l), so every iteration is
    a masked argmin + matvec, no factorisation.  Each decode is repaired
    to feasibility and the best incumbent kept; the dual value gives a
    lower bound.  Fixed trip count: no host read.
    """
    dev = f.device
    r = in_mask.shape[0]
    fT = f.reshape(T, L)
    f_act = torch.where(tgt_mask[:, None], fT, 0.0).reshape(-1)
    lam = torch.zeros((r,), dtype=f32, device=dev)
    best_lb = torch.full((), -INF, dtype=f32, device=dev)

    for _ in range(iters):
        # decode: per-target argmin of the reduced cost
        red = fT + (A_in.T @ lam).reshape(T, L)
        red = torch.where(tgt_mask[:, None], red, INF)
        sel = red.argmin(dim=1)
        lb = torch.where(tgt_mask, red.amin(dim=1), 0.0).sum() - lam.sum()
        best_lb = torch.maximum(best_lb, lb)
        onehot = _onehot(sel, L, tgt_mask)
        g = torch.where(in_mask, A_in @ onehot - 1.0, 0.0)    # subgradient
        # Repair conflicts on the raw decode to harvest an incumbent:
        # the decode seeds round_and_repair as the "LP weights".
        sel_use, feas_use = round_and_repair(onehot, f, A_in, in_mask,
                                             T, L, tgt_mask)
        obj = torch.dot(f_act, _onehot(sel_use, L, tgt_mask))
        better = feas_use & ((obj < best_obj) | ~best_feas)
        best_sel = torch.where(better, sel_use, best_sel)
        best_obj = torch.where(better, obj, best_obj)
        best_feas = best_feas | feas_use
        # Polyak-style step towards the incumbent value.
        gnorm2 = torch.clamp(torch.dot(g, g), min=1e-6)
        gap_est = torch.where(best_feas, best_obj - lb, 1.0)
        step = theta * torch.clamp(gap_est, min=1e-3) / gnorm2
        lam = torch.clamp(lam + step * g, min=0.0)
    return best_sel, best_obj, best_feas, best_lb


def coordinate_descent(f, A_in, in_mask, T, L, tgt_mask, sel,
                       sweeps: int = 3):
    """Per-target exact re-optimisation given the other targets' choices.

    Monotonically improves a feasible integral selection: for each target
    in turn, pick its min-cost leaf among those not conflicting with the
    current usage of every other target.  O(T * L * r) per sweep, 3 * T
    sequential steps, no host read.
    """
    fT = f.reshape(T, L)
    sel = sel.clone()
    for _ in range(sweeps):
        for t in range(T):
            usage = A_in @ _onehot(sel, L, tgt_mask)              # [r]
            own = A_in.index_select(1, t * L + sel[t:t + 1])[:, 0] \
                * tgt_mask[t]
            others = usage - own
            a_t = A_in[:, t * L:(t + 1) * L].T                    # [L, r]
            # leaf l feasible iff others + a_l <= 1 on all valid rows
            ok = ((others[None, :] + a_t) * in_mask[None, :]
                  <= 1.0 + 1e-3).all(dim=1)                        # [L]
            cost = torch.where(ok, fT[t], INF)
            sel[t] = torch.where(tgt_mask[t] & torch.isfinite(cost.amin()),
                                 cost.argmin(), sel[t])
    return sel


def round_and_repair(tau, f, A_in, in_mask, T, L, tgt_mask,
                     repair_iters: int = 16, banned0=None):
    """Round the fractional LP solution to one leaf per target and repair
    measurement conflicts greedily.

    tau: [T*L]; f: [T*L]; A_in: [r, T*L] measurement-usage rows.
    Returns sel [T] leaf index per target and a feasibility flag.

    Repair loop (fixed trip count, no host read): while some measurement
    row is claimed by >1 selected leaf, the worst-scoring conflicting
    target abandons its leaf (the leaf is masked out) and re-picks its
    next-best by LP weight.
    """
    dev = tau.device
    fT = f.reshape(T, L)
    # Prefer high LP weight; break near-ties toward lower cost.
    score = torch.where(tgt_mask[:, None], tau.reshape(T, L) - 1e-4 * fT,
                        -INF)
    banned = (torch.zeros((T, L), dtype=torch.bool, device=dev)
              if banned0 is None else banned0)
    tb = torch.arange(T, device=dev)
    lb = torch.arange(L, device=dev)
    base = tb * L

    def pick(banned):
        return torch.where(banned, -INF, score).argmax(dim=1)         # [T]

    def overused(sel):
        usage = A_in @ _onehot(sel, L, tgt_mask)                       # [r]
        return (usage > 1.5) & in_mask

    sel = pick(banned)
    for _ in range(repair_iters):
        viol = overused(sel)                               # rows overused
        any_viol = viol.any()
        # For each target: does its selected leaf sit on a violated row?
        sel_cols = A_in.index_select(1, base + sel)                # [r, T]
        in_conflict = ((sel_cols * viol[:, None]).sum(dim=0) > 0) & tgt_mask
        # Worst conflicting target = largest objective contribution.
        fsel = fT[tb, sel]
        worst = torch.where(in_conflict, fsel, -INF).argmax()
        hit = ((tb == worst)[:, None] & (lb[None, :] == sel[:, None])
               & any_viol)
        banned = banned | hit
        sel = torch.where(any_viol, pick(banned), sel)

    return sel, ~overused(sel).any()

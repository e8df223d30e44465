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

Every function also takes a batch of problems (leading scenario axes on
``f``, the masks, ``A_in`` and the selections; ``A_eq``, ``b_eq`` and
``b_in`` may be shared), as under ``jax.vmap``: a loop reads once per
round whether any problem continues, and a problem that has exited keeps
its iterate.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from .. import sync
from ..batch import lead_index

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


def _mv(A, x):
    """A @ x for [..., r, n] x [..., n]: a matrix-vector product for one
    problem, a batched product for many."""
    return A @ x if x.dim() == 1 else (A @ x[..., None])[..., 0]


def _dot(a, b):
    """a . b over the last axis (``torch.dot`` for one problem)."""
    return torch.dot(a, b) if a.dim() == 1 else (a * b).sum(dim=-1)


def _cholesky_or_nan(M):
    """The lower Cholesky factor of ``M`` [..., m, m], all NaN where ``M``
    is not positive definite (``jnp.linalg.cholesky``'s behaviour): no
    exception, no host read."""
    Lc, info = torch.linalg.cholesky_ex(M, check_errors=False)
    return torch.where((info != 0)[..., None, None], torch.nan, Lc)


def _alpha_max(v, dv):
    """Largest step in [0,1] keeping v + a*dv >= (1-0.9995) v."""
    neg = dv < 0
    ratio = torch.where(neg, -v / torch.where(neg, dv, -1.0), INF)
    return torch.clamp(0.9995 * ratio.amin(dim=-1), max=1.0)


def solve_lp(f, A_eq, b_eq, A_in, b_in, var_mask, eq_mask, in_mask,
             max_iters: int = 30, tol: float = 2e-6, active=None):
    """Solve  min f.x  s.t.  A_eq x = b_eq, A_in x <= b_in, 0 <= x.

    ``*_mask`` flag valid variables/rows (padding rows must have zero
    coefficients; they are neutralised here).  Infeasible-start
    primal-dual path following with Mehrotra-style adaptive centering;
    the normal-equations matrix is regularised so padded (zero) rows
    stay benign.  A step that comes out non-finite (past convergence the
    normal equations degenerate and the factorisation fails) is rejected:
    the last good iterate is kept and the loop ends.  One host read per
    iteration.  For a batch of problems (leading axes on ``f``) the loop
    runs while any problem continues; ``active`` [batch] leaves the
    others out from the start (their iterate is the initial point).
    """
    dev = f.device
    n, p, r = f.shape[-1], b_eq.shape[-1], b_in.shape[-1]

    # Neutralise padding: invalid vars get cost 1 and a zero column,
    # invalid rows become 0 = 0 / 0 <= 1.
    A_eq = torch.where(eq_mask[..., :, None] & var_mask[..., None, :],
                       A_eq.to(f32), 0.0)
    A_in = torch.where(in_mask[..., :, None] & var_mask[..., None, :],
                       A_in.to(f32), 0.0)
    b_eq = torch.where(eq_mask, b_eq.to(f32), 0.0)
    b_in = torch.where(in_mask, b_in.to(f32), 1.0)
    f = torch.where(var_mask, f.to(f32), 1.0)
    lead = f.shape[:-1]
    batched = bool(lead)

    # Standard form with slacks: xs = [x; s], A = [[A_eq, 0], [A_in, I]].
    m, nv = p + r, n + r
    A = torch.zeros((*lead, m, nv), dtype=f32, device=dev)
    A[..., :p, :n] = A_eq
    A[..., p:, :n] = A_in
    A[..., p:, n:] = torch.eye(r, dtype=f32, device=dev)
    At = A.mT
    b = torch.cat([b_eq.expand(*lead, p), b_in.expand(*lead, r)], dim=-1)
    c = torch.cat([f, torch.zeros((*lead, r), dtype=f32, device=dev)], -1)
    reg = 1e-6 * torch.eye(m, dtype=f32, device=dev)   # normal-eq. regulariser

    x = torch.ones((*lead, nv), dtype=f32, device=dev)
    z = torch.ones((*lead, nv), dtype=f32, device=dev)
    y = torch.zeros((*lead, m), dtype=f32, device=dev)
    ok = torch.ones(lead, dtype=torch.bool, device=dev)
    iters = (torch.zeros(lead, dtype=torch.int32, device=dev) if batched
             else None)

    with full_f32_matmul():
        it = 0
        while it < max_iters:
            rp = b - _mv(A, x)
            mu = _dot(x, z) / nv
            go = ok & ((mu > tol) | (rp.abs().amax(dim=-1) > 1e-4))
            if not batched:
                if not sync.flag(go):
                    break
            else:
                if active is not None:
                    go = go & active
                if not sync.flag(go.any()):
                    break
            rd = c - _mv(At, y) - z
            # One factorisation of M = A D A^T + delta I serves the
            # predictor and the corrector: D depends on (x, z) only.
            zc = torch.clamp(z, min=1e-12)
            d = torch.clamp(x / zc, 1e-8, 1e8)
            Lc = _cholesky_or_nan((A * d[..., None, :]) @ At + reg)

            def nt_solve(rhs_mu):
                """One Newton solve of the KKT system via the normal
                equations, for the target complementarity ``rhs_mu``."""
                rhs = rp + _mv(A, d * rd - rhs_mu / zc)
                dy = torch.cholesky_solve(rhs[..., None], Lc)[..., 0]
                dx = d * (_mv(At, dy) - rd) + rhs_mu / zc
                dz = (rhs_mu - z * dx) / torch.clamp(x, min=1e-12)
                return dx, dy, dz

            # Affine (predictor) direction
            dx_a, _, dz_a = nt_solve(-x * z)
            ap, ad = _alpha_max(x, dx_a), _alpha_max(z, dz_a)
            mu_aff = _dot(x + ap[..., None] * dx_a,
                          z + ad[..., None] * dz_a) / nv
            sigma = torch.clamp((mu_aff / torch.clamp(mu, min=1e-15)) ** 3,
                                1e-4, 0.9)
            # Corrector
            dx, dy, dz = nt_solve((sigma * mu)[..., None] - x * z
                                  - dx_a * dz_a)
            ap, ad = _alpha_max(x, dx), _alpha_max(z, dz)
            x_new = x + ap[..., None] * dx
            y_new = y + ad[..., None] * dy
            z_new = z + ad[..., None] * dz
            ok_new = (torch.isfinite(x_new).all(dim=-1)
                      & torch.isfinite(y_new).all(dim=-1)
                      & torch.isfinite(z_new).all(dim=-1))
            take = ok_new & go if batched else ok_new
            x = torch.where(take[..., None], x_new, x)
            y = torch.where(take[..., None], y_new, y)
            z = torch.where(take[..., None], z_new, z)
            if batched:      # a problem that has exited keeps its carry
                ok = torch.where(go, ok_new, ok)
                iters = iters + go.int()
            else:
                ok = ok_new
            it += 1

    tau = torch.where(var_mask, x[..., :n], 0.0)
    return LpSolution(x=tau, obj=_dot(f, tau),
                      iters=iters if batched else torch.full(
                          (), it, dtype=torch.int32, device=dev),
                      mu=_dot(x, z) / nv)


def _onehot(sel, L, tgt_mask):
    """[..., T*L] f32: 1 at each masked-in target's selected leaf."""
    hot = torch.arange(L, device=sel.device) == sel[..., None]
    return (hot & tgt_mask[..., None]).flatten(-2).to(f32)


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
    is (obj - lower_bound).  One host read per node after the root.  For
    a batch of problems a node is popped while any problem has work left;
    a problem without keeps its pool and incumbent, and its LP is left
    out of the node's solve.
    """
    BIG = 1e4
    EPS = 1e-5
    lead = f.shape[:-1]
    n = f.shape[-1]
    POOL = budget + 2
    dev = f.device
    f = f.to(f32)
    ar_n = torch.arange(n, device=dev)
    ar_pool = torch.arange(POOL, device=dev)
    f_valid = torch.where(var_mask, f, 0.0)

    def lp_round(bans, active):
        f_eff = torch.where(bans, f + BIG, f)
        sol = solve_lp(f_eff, A_eq, b_eq, A_in, b_in,
                       var_mask, eq_mask, in_mask, max_iters=lp_iters,
                       active=active)
        sel, feas = round_and_repair(sol.x, f_eff, A_in, in_mask,
                                     T, L, tgt_mask,
                                     banned0=bans.reshape(*lead, T, L))
        obj = _dot(f_valid, _onehot(sel, L, tgt_mask))
        frac = torch.where(var_mask & ~bans,
                           -(sol.x - 0.5).abs(), -INF)      # peak at 0.5
        j_frac = frac.argmax(dim=-1)
        integral = torch.where(var_mask, (sol.x - sol.x.round()).abs(),
                               0.0).amax(dim=-1) < 0.01
        return sel, feas, obj, sol.obj, j_frac, integral

    def insert(pool, bans, prio, expand):
        """Place a node into the first inactive slot; if none, replace
        the worst (highest-priority) active node if strictly better.
        Nothing changes unless ``expand``."""
        pool_bans, pool_prio, pool_act = pool
        has_free = (~pool_act).any(dim=-1)
        free_slot = pool_act.int().argmin(dim=-1)           # first False
        worst = torch.where(pool_act, pool_prio, -INF).argmax(dim=-1)
        slot = torch.where(has_free, free_slot, worst)
        at_worst = ar_pool == worst[..., None]
        prio_worst = torch.where(at_worst, pool_prio, 0.0).sum(dim=-1)
        do = expand & (has_free | (prio < prio_worst))
        put = (ar_pool == slot[..., None]) & do[..., None]
        return (torch.where(put[..., None], bans[..., None, :], pool_bans),
                torch.where(put, prio[..., None], pool_prio),
                pool_act | put)

    # Node pool: ban masks + parent-bound priority; the root sits in
    # slot 0.
    pool = (torch.zeros((*lead, POOL, n), dtype=torch.bool, device=dev),
            torch.where(ar_pool == 0, -INF, INF).to(f32).expand(*lead, POOL),
            (ar_pool == 0).expand(*lead, POOL))
    best_sel = torch.zeros((*lead, T), dtype=torch.int64, device=dev)
    best_obj = torch.full(lead, INF, dtype=f32, device=dev)
    best_feas = torch.zeros(lead, dtype=torch.bool, device=dev)
    bound = torch.zeros(lead, dtype=f32, device=dev)

    for it in range(budget):
        pool_bans, pool_prio, pool_act = pool
        active = None
        if it > 0:
            open_bound = torch.where(pool_act, pool_prio, INF).amin(dim=-1)
            go = pool_act.any(dim=-1) & (open_bound < best_obj - EPS)
            if not lead:
                if not sync.flag(go):
                    break
            else:
                if not sync.flag(go.any()):
                    break
                active = go
        # Pop the best-bound node.
        popped = ar_pool == torch.where(pool_act, pool_prio,
                                        INF).argmin(dim=-1)[..., None]
        bans = (pool_bans & popped[..., None]).any(dim=-2)
        new_pool = (pool_bans, pool_prio, pool_act & ~popped)

        sel, feas, obj, lp_obj, j_frac, integral = lp_round(bans, active)
        better = feas & ((obj < best_obj) | ~best_feas)
        new_sel = torch.where(better[..., None], sel, best_sel)
        new_obj = torch.where(better, obj, best_obj)
        new_feas = best_feas | feas
        if it == 0:
            bound = lp_obj

        # Branch if fractional and the node bound beats the incumbent.
        expand = ~integral & (lp_obj < new_obj - EPS)
        # Child A: ban j_frac.  Child B: force j_frac == ban every other
        # leaf of its target.
        is_j = ar_n == j_frac[..., None]
        same_tgt = (ar_n // L) == (j_frac // L)[..., None]
        new_pool = insert(new_pool, bans | is_j, lp_obj, expand)
        new_pool = insert(new_pool, bans | (same_tgt & ~is_j), lp_obj, expand)
        new = (new_pool, new_sel, new_obj, new_feas)
        if active is not None:
            new = sync.select(active, new, (pool, best_sel, best_obj,
                                            best_feas))
        pool, best_sel, best_obj, best_feas = new

    # Lagrangian subgradient polish (it cannot improve on an integral LP
    # optimum, but running it is branch-free).
    f_pol = torch.where(var_mask, f, BIG)
    best_sel, best_obj, best_feas, lag_lb = lagrangian_polish(
        f_pol, A_in, in_mask, T, L, tgt_mask, best_sel, best_obj, best_feas)
    bound = torch.maximum(bound, lag_lb)

    # Final monotone polish: exact per-target re-optimisation.
    best_sel = coordinate_descent(f_pol, A_in, in_mask, T, L, tgt_mask,
                                  best_sel)
    best_obj = _dot(f_valid, _onehot(best_sel, L, tgt_mask))
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
    lead = f.shape[:-1]
    r = in_mask.shape[-1]
    fT = f.reshape(*lead, T, L)
    f_act = torch.where(tgt_mask[..., None], fT, 0.0).flatten(-2)
    lam = torch.zeros((*lead, r), dtype=f32, device=dev)
    best_lb = torch.full(lead, -INF, dtype=f32, device=dev)

    for _ in range(iters):
        # decode: per-target argmin of the reduced cost
        red = fT + _mv(A_in.mT, lam).reshape(*lead, T, L)
        red = torch.where(tgt_mask[..., None], red, INF)
        sel = red.argmin(dim=-1)
        lb = (torch.where(tgt_mask, red.amin(dim=-1), 0.0).sum(dim=-1)
              - lam.sum(dim=-1))
        best_lb = torch.maximum(best_lb, lb)
        onehot = _onehot(sel, L, tgt_mask)
        g = torch.where(in_mask, _mv(A_in, onehot) - 1.0, 0.0)  # subgradient
        # Repair conflicts on the raw decode to harvest an incumbent:
        # the decode seeds round_and_repair as the "LP weights".
        sel_use, feas_use = round_and_repair(onehot, f, A_in, in_mask,
                                             T, L, tgt_mask)
        obj = _dot(f_act, _onehot(sel_use, L, tgt_mask))
        better = feas_use & ((obj < best_obj) | ~best_feas)
        best_sel = torch.where(better[..., None], sel_use, best_sel)
        best_obj = torch.where(better, obj, best_obj)
        best_feas = best_feas | feas_use
        # Polyak-style step towards the incumbent value.
        gnorm2 = torch.clamp(_dot(g, g), min=1e-6)
        gap_est = torch.where(best_feas, best_obj - lb, 1.0)
        step = theta * torch.clamp(gap_est, min=1e-3) / gnorm2
        lam = torch.clamp(lam + step[..., None] * g, min=0.0)
    return best_sel, best_obj, best_feas, best_lb


def _columns(A_in, cols):
    """Columns ``cols [..., k]`` of ``A_in [..., r, n]``: [..., r, k]."""
    if cols.dim() == 1:
        return A_in.index_select(1, cols)
    return torch.gather(A_in, -1, cols[..., None, :].expand(
        *cols.shape[:-1], A_in.shape[-2], cols.shape[-1]))


def coordinate_descent(f, A_in, in_mask, T, L, tgt_mask, sel,
                       sweeps: int = 3):
    """Per-target exact re-optimisation given the other targets' choices.

    Monotonically improves a feasible integral selection: for each target
    in turn, pick its min-cost leaf among those not conflicting with the
    current usage of every other target.  O(T * L * r) per sweep, 3 * T
    sequential steps, no host read.
    """
    lead = f.shape[:-1]
    fT = f.reshape(*lead, T, L)
    sel = sel.clone()
    for _ in range(sweeps):
        for t in range(T):
            usage = _mv(A_in, _onehot(sel, L, tgt_mask))              # [r]
            own = _columns(A_in, t * L + sel[..., t:t + 1])[..., 0] \
                * tgt_mask[..., t, None]
            others = usage - own
            a_t = A_in[..., :, t * L:(t + 1) * L].mT                  # [L, r]
            # leaf l feasible iff others + a_l <= 1 on all valid rows
            ok = ((others[..., None, :] + a_t) * in_mask[..., None, :]
                  <= 1.0 + 1e-3).all(dim=-1)                           # [L]
            cost = torch.where(ok, fT[..., t, :], INF)
            sel[..., t] = torch.where(
                tgt_mask[..., t] & torch.isfinite(cost.amin(dim=-1)),
                cost.argmin(dim=-1), sel[..., t])
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
    lead = tau.shape[:-1]
    fT = f.reshape(*lead, T, L)
    # Prefer high LP weight; break near-ties toward lower cost.
    score = torch.where(tgt_mask[..., None],
                        tau.reshape(*lead, T, L) - 1e-4 * fT, -INF)
    banned = (torch.zeros((*lead, T, L), dtype=torch.bool, device=dev)
              if banned0 is None else banned0)
    tb = torch.arange(T, device=dev)
    lb = torch.arange(L, device=dev)
    base = tb * L
    bi = lead_index(lead, dev, extra=1)

    def pick(banned):
        return torch.where(banned, -INF, score).argmax(dim=-1)        # [T]

    def overused(sel):
        usage = _mv(A_in, _onehot(sel, L, tgt_mask))                   # [r]
        return (usage > 1.5) & in_mask

    sel = pick(banned)
    for _ in range(repair_iters):
        viol = overused(sel)                               # rows overused
        any_viol = viol.any(dim=-1)
        # For each target: does its selected leaf sit on a violated row?
        sel_cols = _columns(A_in, base + sel)                      # [r, T]
        in_conflict = (((sel_cols * viol[..., :, None]).sum(dim=-2) > 0)
                       & tgt_mask)
        # Worst conflicting target = largest objective contribution.
        fsel = fT[(*bi, tb, sel)]
        worst = torch.where(in_conflict, fsel, -INF).argmax(dim=-1)
        hit = ((tb == worst[..., None])[..., None]
               & (lb == sel[..., None]) & any_viol[..., None, None])
        banned = banned | hit
        sel = torch.where(any_viol[..., None], pick(banned), sel)

    return sel, ~overused(sel).any(dim=-1)

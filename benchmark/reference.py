"""The plain reference of one tracker scan, and the judge that holds a
scan of the system under test to it.

One scan of a track-oriented MHT tracker with a beam of L hypotheses per
target, as the configuration files state it (pyMHT's model: the radar
and AIS Kalman updates and scores of tracker.py:309-552 and
pyTarget.py:227-330, exact global hypothesis selection over single-use
(scan, measurement) and (scan, message) slots, termination, N-scan
pruning and m-of-n initiation, m_of_n.py:24-478), written as plain torch
operations on whole tensors in a dtype of the caller's choice: float64
for the judge, bfloat16 for the control.  It imports nothing of the
system under test.  Selection is exact (scipy's HiGHS, per cluster);
assignment in the initiator is exact (scipy's linear_sum_assignment).

The reference follows the system step by step: ``step`` takes the
system's state before a scan (field names and encodings of the system's
state: ``hist_meas`` -1 none, 0 missed, m+1 measurement m) and works the
scan out again from it and from the scan's inputs, which the benchmark
drew.  ``judge`` compares the system's state and outputs after the scan
with that, following the system's own selection where the exact
optimum is not unique to rounding, and returns the numbers compared.

Where the system gates each target against its Km nearest measurements
(the spatial pre-gate), the reference gates against all of them: the
two agree whenever every measurement a target gates lies among its Km
nearest, and a scan where that fails shows as a gating mismatch.
"""
from __future__ import annotations

import math

import numpy as np
import torch

LOG2PI = math.log(2.0 * math.pi)
SIGMA_Q = 1.0                  # process noise scale the tracker assumes
R_RADAR = 2.5 ** 2             # radar variance the tracker assumes (m^2)
R_AIS = (1.0 ** 2, 3.0 ** 2)   # AIS variance, high / low accuracy
P0_DIAG = (2.5 ** 2, 2.5 ** 2, 0.3 * 2.5 ** 2, 0.3 * 2.5 ** 2)
AMBIGUOUS = 1e-3               # relative margin within which f32 and
                               # f64 may rank or gate differently
DECIDED = 1e-2                 # a relative difference past which two
                               # states are different decisions


class Cfg:
    """Shapes and parameters of a ``benchmark/configs/*.json`` file."""

    def __init__(self, cfg: dict):
        s, p = cfg["shapes"], cfg["params"]
        self.T, self.L, self.M = s["max_targets"], s["max_leaves"], \
            s["max_meas"]
        self.A, self.W = s["max_ais"], s["window"]
        self.P = s["max_prelim"]
        self.G = s["ais_per_leaf"] or s["max_ais"]
        self.use_ais = bool(cfg["use_ais"])
        self.p = dict(p)
        self.N = p["N"]
        self.lambda_ex = p["lambda_phi"] + p["lambda_nu"]
        self.merge_threshold = 4.0 * R_RADAR
        self.gamma = -2.0 * math.log(1.0 - p["gate_probability"])
        self.score_limit = -math.log(1.0 - p["P_d"]) \
            * p["score_upper_limit_scale"]


# -- model ---------------------------------------------------------------

def phi(dt):
    """[..., 4, 4] constant-velocity transition for time steps ``dt``."""
    one, z = torch.ones_like(dt), torch.zeros_like(dt)
    return torch.stack([torch.stack([one, z, dt, z], -1),
                        torch.stack([z, one, z, dt], -1),
                        torch.stack([z, z, one, z], -1),
                        torch.stack([z, z, z, one], -1)], -2)


def q_mat(dt):
    """Process noise for ``dt`` (pyMHT's kernel, T^3/3 off-diagonal)."""
    T2 = dt * dt
    T3, T4, z = T2 * dt / 3.0, T2 * T2 / 4.0, torch.zeros_like(dt)
    return torch.stack([torch.stack([T4, z, T3, z], -1),
                        torch.stack([z, T4, z, T3], -1),
                        torch.stack([T3, z, T2, z], -1),
                        torch.stack([z, T3, z, T2], -1)], -2) * SIGMA_Q


def predict(x, P, dt):
    F = phi(dt)
    return ((F @ x[..., None])[..., 0],
            F @ P @ F.transpose(-1, -2) + q_mat(dt))


def inv2(S):
    a, b, c, d = S[..., 0, 0], S[..., 0, 1], S[..., 1, 0], S[..., 1, 1]
    det = a * d - b * c
    return torch.stack([torch.stack([d, -b], -1),
                        torch.stack([-c, a], -1)], -2) / det[..., None,
                                                             None], det


def inv4(S):
    """Inverse and determinant of [..., 4, 4] by 2x2 blocks."""
    A, B, C, D = S[..., :2, :2], S[..., :2, 2:], S[..., 2:, :2], \
        S[..., 2:, 2:]
    Ai, dA = inv2(A)
    CAi = C @ Ai
    Mi, dM = inv2(D - CAi @ B)
    F = Ai @ B @ Mi
    return torch.cat([torch.cat([Ai + F @ CAi, -F], -1),
                      torch.cat([-Mi @ CAi, Mi], -1)], -2), dA * dM


def quad(v, Si):
    return (v * (Si @ v[..., None])[..., 0]).sum(-1)


def p0(like):
    return torch.diag(torch.tensor(P0_DIAG, dtype=like.dtype,
                                   device=like.device))


# -- grow ------------------------------------------------------------------

def _topk_small(v, k):
    """The k smallest of the last axis (+inf padding) and their index."""
    k = min(k, v.shape[-1])
    val, idx = torch.topk(v, k, dim=-1, largest=False, sorted=True)
    return val, idx


def grow(S, scan, ais, c: Cfg, chunk: int = 64):
    """The forest after one scan's growth and beam, with what the judge
    needs beside it.  ``S``: the state (dict of tensors, the dtype of the
    computation for reals); ``scan``: z [M, 2], mask [M], time []; ``ais``:
    dict state [A, 4], time [A], mmsi [A], high [A], mask [A] or None."""
    T, L, M, W = c.T, c.L, c.M, c.W
    dev, dt_ = S["leaf_x"].device, S["leaf_x"].dtype
    inf = torch.tensor(float("inf"), dtype=dt_, device=dev)
    dt = scan["time"] - S["time"]
    z, zm = scan["z"], scan["mask"]
    n_live = S["tgt_mask"].sum().to(dt_)
    new = {k: [] for k in ("x", "P", "score", "meas", "ais", "mmsi",
                           "parent", "valid")}
    used = torch.zeros(M, dtype=torch.bool, device=dev)
    amb_m = torch.zeros(M, dtype=torch.bool, device=dev)
    gated, amb_gate, amb_beam = [], [], []
    eta2, eta2a = c.p["eta2"], c.p["eta2_ais"]
    log_lex = math.log(c.lambda_ex)
    for t0 in range(0, T, chunk):
        sl = slice(t0, min(T, t0 + chunk))
        x, P = S["leaf_x"][sl], S["leaf_P"][sl]
        cn, live = S["leaf_cnllr"][sl], S["leaf_mask"][sl]
        pd = S["tgt_pd"][sl][:, None]
        tn = x.shape[0]
        xb, Pb = predict(x, P, dt)
        Si, det = inv2(Pb[..., :2, :2] + R_RADAR * torch.eye(
            2, dtype=dt_, device=dev))
        K = Pb[..., :, :2] @ Si                                  # [t,L,4,2]
        Ph = Pb - K @ Pb[..., :2, :]
        zt = z[None, None] - xb[..., None, :2]                   # [t,L,M,2]
        nis = quad(zt, Si[..., None, :, :])
        ok = zm[None, None] & live[..., None]
        gate = (nis <= eta2) & ok
        near = ok & ((nis - eta2).abs() <= AMBIGUOUS * eta2)
        used |= gate.flatten(0, 1).any(0)
        amb_m |= near.flatten(0, 1).any(0)
        gated.append(gate.sum((1, 2)))
        amb_gate.append(near.sum((1, 2)))
        logt = log_lex + 0.5 * (2 * LOG2PI + torch.log(det)) \
            - torch.log(pd)
        s_r = torch.where(gate, cn[..., None] + 0.5 * nis
                          + logt[..., None], inf)
        s_0 = torch.where(live, cn - torch.log1p(-pd), inf)
        radar = torch.cat([s_0[..., None], s_r], -1)             # [t,L,1+M]
        Cr = 1 + M
        blocks = [radar.reshape(tn, L * Cr)]
        if ais is not None:
            G = c.G
            lm = torch.maximum(S["hist_mmsi"][sl].amax(-1),
                               S["tgt_mmsi"][sl][:, None])       # [t,L]
            adm = (ais["mask"][None, None] & live[..., None]
                   & ((lm[..., None] == 0)
                      | (lm[..., None] == ais["mmsi"][None, None])))
            dT1 = ais["time"] - S["time"]                        # [A]
            r_a = torch.where(ais["high"], R_AIS[0], R_AIS[1]).to(dt_)
            xb1, Pb1 = predict(x[..., None, :], P[..., None, :, :],
                               dT1)                              # [t,L,A]
            S1 = Pb1 + r_a[:, None, None] * torch.eye(4, dtype=dt_,
                                                      device=dev)
            S1i, det1 = inv4(S1)
            d1 = ais["state"] - xb1
            nis1 = quad(d1, S1i)
            gate1 = (nis1 <= eta2a) & adm
            nis1g, gi = _topk_small(torch.where(gate1, nis1, inf), G)
            g_ok = torch.isfinite(nis1g)                          # [t,L,G]

            def pick(a):
                return torch.gather(a, 2, gi.reshape(
                    gi.shape + (1,) * (a.dim() - 3)).expand(
                        gi.shape + a.shape[3:]))

            pb, s1i, xb1g, d1g = pick(Pb1), pick(S1i), pick(xb1), pick(d1)
            xh = xb1g + (pb @ (s1i @ d1g[..., None]))[..., 0]
            ph = pb - pb @ s1i @ pb
            lam_ais = n_live * c.p["P_ais"] / (math.pi
                                                * c.p["radar_range"] ** 2)
            nllr1 = (0.5 * nis1g + torch.log(torch.clamp(lam_ais,
                                                         min=1e-20))
                     + 0.5 * (4 * LOG2PI + torch.log(pick(det1))))
            dt2 = scan["time"] - ais["time"][gi]                  # [t,L,G]
            xb2, Pb2 = predict(xh, ph, dt2)
            S2i, det2 = inv2(Pb2[..., :2, :2] + R_RADAR * torch.eye(
                2, dtype=dt_, device=dev))
            K2 = Pb2[..., :, :2] @ S2i
            Ph2 = Pb2 - K2 @ Pb2[..., :2, :]
            zt2 = z - xb2[..., None, :2]                          # [t,L,G,M,2]
            nis2 = quad(zt2, S2i[..., None, :, :])
            gate2 = (nis2 <= eta2) & zm & g_ok[..., None]
            logt2 = log_lex + 0.5 * (2 * LOG2PI + torch.log(det2)) \
                - torch.log(pd)[..., None]
            fused = torch.where(gate2, cn[..., None, None]
                                + 0.5 * nllr1[..., None]
                                + 0.5 * (0.5 * nis2 + logt2[..., None]),
                                inf)
            pure = torch.where(g_ok & ~gate2.any(-1), cn[..., None] + nllr1,
                               inf)
            blocks.append(torch.cat([pure[..., None], fused], -1)
                          .reshape(tn, L * G * Cr))
        # the beam: the L best candidates, the previous selection's zero
        # hypothesis forced in (the feasibility spine)
        vals, ids, src = [], [], []
        for b, blk in enumerate(blocks):
            v, i = _topk_small(blk, L + 1)
            vals.append(v)
            ids.append(i)
            src.append(torch.full_like(i, b))
        v, order = _topk_small(torch.cat(vals, -1), L + 1)
        cid = torch.gather(torch.cat(ids, -1), -1, order)
        csrc = torch.gather(torch.cat(src, -1), -1, order)
        if v.shape[-1] > L:
            amb_beam.append(torch.isfinite(v[:, L - 1])
                            & (v[:, L] - v[:, L - 1] <= AMBIGUOUS
                               * torch.clamp(v[:, L - 1].abs(), min=1.0)))
        else:
            amb_beam.append(torch.zeros(tn, dtype=torch.bool, device=dev))
        v, cid, csrc = v[:, :L], cid[:, :L], csrc[:, :L]
        sel = S["sel_leaf"][sl].long().clamp(0, L - 1)
        ar = torch.arange(tn, device=dev)
        has0 = live[ar, sel]
        hit = (csrc == 0) & (cid == sel[:, None] * Cr)
        force = has0 & ~hit.any(-1)
        v[:, L - 1] = torch.where(force, s_0[ar, sel], v[:, L - 1])
        cid[:, L - 1] = torch.where(force, sel * Cr, cid[:, L - 1])
        csrc[:, L - 1] = torch.where(force, 0, csrc[:, L - 1])
        # payloads
        is_ais = csrc == 1
        per = G * Cr if ais is not None else Cr
        parent = torch.where(is_ais, cid // per, cid // Cr)
        slot = torch.where(is_ais, cid % per, cid % Cr)
        g = torch.where(is_ais, slot // Cr, 0)
        sub = torch.where(is_ais, slot % Cr, slot)       # 0 zero/pure, 1+m
        m = (sub - 1).clamp(0, M - 1)
        a2 = ar[:, None]
        xr = xb[a2, parent] + (K[a2, parent] @ (
            z[m] - xb[a2, parent][..., :2])[..., None])[..., 0]
        nx = torch.where((sub == 0)[..., None], xb[a2, parent], xr)
        nP = torch.where((sub == 0)[..., None, None], Pb[a2, parent],
                         Ph[a2, parent])
        mmsi = torch.zeros_like(parent)
        aidx = torch.zeros_like(parent)
        if ais is not None:
            xa = xb2[a2, parent, g]
            xf = xa + (K2[a2, parent, g] @ (z[m] - xa[..., :2])[..., None]
                       )[..., 0]
            nx = torch.where(is_ais[..., None],
                             torch.where((sub == 0)[..., None], xa, xf), nx)
            nP = torch.where(is_ais[..., None, None], Ph2[a2, parent, g], nP)
            aidx = torch.where(is_ais, gi[a2, parent, g] + 1, 0)
            mmsi = torch.where(is_ais, ais["mmsi"][(aidx - 1).clamp(min=0)],
                               0)
        valid = torch.isfinite(v) & S["tgt_mask"][sl][:, None]
        for k, val in (("x", nx), ("P", nP), ("score", v),
                       ("meas", torch.where(sub == 0, 0, m + 1)),
                       ("ais", aidx), ("mmsi", mmsi), ("parent", parent),
                       ("valid", valid)):
            new[k].append(val)
    new = {k: torch.cat(v) for k, v in new.items()}
    valid, parent = new["valid"], new["parent"]
    ar = torch.arange(T, device=dev)[:, None]

    def roll(h, col, fill):
        r = torch.cat([h[ar, parent][:, :, 1:], col[..., None]], -1)
        return torch.where(valid[..., None], r, fill)

    zero = torch.zeros((), dtype=dt_, device=dev)
    G2 = dict(S)
    G2.update(
        leaf_x=torch.where(valid[..., None], new["x"], zero),
        leaf_P=torch.where(valid[..., None, None], new["P"], zero),
        leaf_cnllr=torch.where(valid, new["score"], zero),
        leaf_mask=valid,
        hist_meas=roll(S["hist_meas"], new["meas"], -1),
        hist_ais=roll(S["hist_ais"], new["ais"], 0),
        hist_mmsi=roll(S["hist_mmsi"], new["mmsi"], 0),
        hist_cnllr=roll(S["hist_cnllr"], new["score"], zero),
        hist_x=torch.where(valid[..., None, None], torch.cat(
            [S["hist_x"][ar, parent][:, :, 1:], new["x"][:, :, None]], 2),
            zero),
        tgt_depth=torch.where(S["tgt_mask"],
                              torch.clamp(S["tgt_depth"] + 1, max=W),
                              S["tgt_depth"]),
        time=scan["time"])
    aux = dict(used=used, amb_meas=amb_m, gated=torch.cat(gated),
               amb_gate=torch.cat(amb_gate), amb_beam=torch.cat(amb_beam))
    return G2, aux


# -- selection ---------------------------------------------------------------

def leaf_f(S, c: Cfg):
    f = (S["leaf_cnllr"] - S["tgt_root_cnllr"][:, None]) / c.N
    return torch.where(S["leaf_mask"], f, torch.inf)


def slots(S, c: Cfg):
    """[T, L, 2W] single-use slot ids (-1 none): radar (w, m) as
    w (M + A) + m, AIS message a as w (M + A) + M + a."""
    W, per = c.W, c.M + c.A
    w = torch.arange(W, device=S["hist_meas"].device) * per
    r = torch.where(S["hist_meas"] >= 1, w + S["hist_meas"] - 1, -1)
    a = torch.where(S["hist_ais"] >= 1, w + c.M + S["hist_ais"] - 1, -1)
    return torch.cat([r, a], -1)


def select_exact(S, c: Cfg):
    """The optimum of one leaf per live target under single-use slots:
    (sel [T] long, objective), per cluster of targets sharing a slot;
    singletons by their best leaf, the rest by HiGHS."""
    from scipy import sparse
    from scipy.optimize import Bounds, LinearConstraint, milp
    f = leaf_f(S, c).double().cpu().numpy()
    live = S["leaf_mask"].cpu().numpy()
    tm = S["tgt_mask"].cpu().numpy()
    sl = slots(S, c).cpu().numpy()
    T, L = live.shape
    sel = np.where(tm, np.argmin(np.where(live, f, np.inf), 1), 0)
    # union-find over targets that share a slot
    parent = np.arange(T)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    owner = {}
    for t in np.nonzero(tm)[0]:
        for s in np.unique(sl[t][live[t]]):
            if s < 0:
                continue
            o = owner.setdefault(int(s), t)
            if o != t:
                a, b = find(o), find(t)
                if a != b:
                    parent[a] = b
    groups = {}
    for t in np.nonzero(tm)[0]:
        groups.setdefault(find(t), []).append(t)
    for members in groups.values():
        if len(members) == 1:
            continue
        var = [(t, l) for t in members for l in np.nonzero(live[t])[0]]
        cost = np.array([f[t, l] for t, l in var])
        sid, rows, cols = {}, [], []
        for j, (t, l) in enumerate(var):
            for s in np.unique(sl[t, l]):
                if s >= 0:
                    rows.append(sid.setdefault(int(s), len(sid)))
                    cols.append(j)
        A1 = sparse.csr_matrix((np.ones(len(rows)), (rows, cols)),
                               shape=(len(sid), len(var)))
        ti = {t: i for i, t in enumerate(members)}
        A2 = sparse.csr_matrix((np.ones(len(var)),
                                ([ti[t] for t, _ in var], range(len(var)))),
                               shape=(len(members), len(var)))
        res = milp(cost, integrality=np.ones(len(var)), bounds=Bounds(0, 1),
                   constraints=[LinearConstraint(A2, 1, 1),
                                LinearConstraint(A1, -np.inf, 1)])
        if res.status != 0 or res.x is None:
            raise RuntimeError(f"reference selection: HiGHS status "
                               f"{res.status}: {res.message}")
        for j in np.nonzero(res.x > 0.5)[0]:
            sel[var[j][0]] = var[j][1]
    obj = float(np.where(tm, f[np.arange(T), sel], 0.0).sum())
    return torch.as_tensor(sel, device=S["leaf_mask"].device), obj


def feasible(S, c: Cfg, sel) -> bool:
    s = slots(S, c)[torch.arange(c.T, device=sel.device), sel]
    s = s[S["tgt_mask"]].flatten()
    s = s[s >= 0]
    return bool(s.unique().numel() == s.numel())


# -- terminate and N-scan prune -----------------------------------------------

def terminate(S, c: Cfg, sel):
    ar = torch.arange(c.T, device=sel.device)
    x, cn = S["leaf_x"][ar, sel], S["leaf_cnllr"][ar, sel]
    rng = torch.sqrt((x[:, 0] - c.p["position"][0]) ** 2
                     + (x[:, 1] - c.p["position"][1]) ** 2)
    score = (cn - S["tgt_root_cnllr"]) / (c.N + 1)
    tests = ((rng, c.p["radar_range"]), (score, c.score_limit),
             (cn, c.p["cnllr_upper_limit"]))
    bad = [v > lim for v, lim in tests]
    near = torch.zeros_like(bad[0])
    for v, lim in tests:
        near |= (v - lim).abs() <= AMBIGUOUS * max(1.0, abs(lim))
    near &= S["tgt_mask"]
    dead = S["tgt_mask"] & (bad[0] | bad[1] | bad[2])
    reason = torch.where(bad[0], 1, torch.where(bad[1], 2,
                                                torch.where(bad[2], 3, 0)))
    reason = torch.where(dead, reason, 0)
    S = dict(S, tgt_mask=S["tgt_mask"] & ~dead,
             leaf_mask=S["leaf_mask"] & ~dead[:, None],
             tgt_id=torch.where(dead, -1, S["tgt_id"]))
    return S, dead, reason, near


def prune(S, c: Cfg, sel):
    W = c.W
    dev = sel.device
    ar = torch.arange(c.T, device=dev)
    depth = S["tgt_depth"]
    ncut = torch.clamp(depth - S["tgt_window"], min=0)
    w = torch.arange(W, device=dev)[None]
    cut = (w >= (W - depth)[:, None]) & (w < (W - depth + ncut)[:, None])
    sm, sa = S["hist_meas"][ar, sel], S["hist_ais"][ar, sel]
    smm, sc = S["hist_mmsi"][ar, sel], S["hist_cnllr"][ar, sel]
    sx = S["hist_x"][ar, sel]
    agree = ((S["hist_meas"] == sm[:, None]) & (S["hist_ais"] == sa[:, None])
             & (S["hist_mmsi"] == smm[:, None]))
    keep = (agree | ~cut[:, None]).all(-1)
    last = (W - depth + ncut - 1).clamp(0, W - 1)
    c3 = cut[:, None]
    zero = torch.zeros((), dtype=S["leaf_x"].dtype, device=dev)
    out = dict(confirmed_mask=cut & S["tgt_mask"][:, None], confirmed_x=sx,
               confirmed_meas=sm, confirmed_mmsi=smm)
    S = dict(S, leaf_mask=S["leaf_mask"] & keep,
             hist_meas=torch.where(c3, -1, S["hist_meas"]),
             hist_ais=torch.where(c3, 0, S["hist_ais"]),
             hist_mmsi=torch.where(c3, 0, S["hist_mmsi"]),
             hist_cnllr=torch.where(c3, zero, S["hist_cnllr"]),
             hist_x=torch.where(c3[..., None], zero, S["hist_x"]),
             tgt_depth=depth - ncut,
             tgt_root_cnllr=torch.where(ncut > 0, sc[ar, last],
                                        S["tgt_root_cnllr"]),
             tgt_mmsi=torch.maximum(S["tgt_mmsi"],
                                    torch.where(cut, smm, 0).amax(-1)))
    return S, out


# -- m-of-n initiation --------------------------------------------------------

def assign(cost, valid):
    """Maximum-cardinality, then minimum-cost assignment of rows to
    columns over the ``valid`` pairs (pyMHT's GNN with its big-M padding,
    m_of_n.py:24-104): row -> column, -1 unassigned."""
    from scipy.optimize import linear_sum_assignment
    cost, valid = cost.double().cpu().numpy(), valid.cpu().numpy()
    out = np.full(cost.shape[0], -1)
    rows, cols = np.nonzero(valid.any(1))[0], np.nonzero(valid.any(0))[0]
    if len(rows):
        sub = np.where(valid[np.ix_(rows, cols)], cost[np.ix_(rows, cols)],
                       np.inf)
        big = 10.0 * (1.0 + np.abs(sub[np.isfinite(sub)]).sum()) \
            * (len(rows) + len(cols))
        r, cc = linear_sum_assignment(np.where(np.isfinite(sub), sub, big))
        for i, j in zip(r, cc):
            if np.isfinite(sub[i, j]):
                out[rows[i]] = cols[j]
    return torch.as_tensor(out)


def _insert_rows(dst_mask, src_mask):
    """The k-th valid source row into the k-th free destination slot."""
    free = ~dst_mask
    rank_d = torch.cumsum(free.long(), 0) - 1
    rank_s = torch.cumsum(src_mask.long(), 0) - 1
    match = free[:, None] & src_mask[None] & (rank_d[:, None]
                                              == rank_s[None])
    return match.any(1), match.long().argmax(1)


def _nis_dedup(cx, cmask, px, pP, pmask):
    Si, _ = inv4(pP + R_AIS[1] * torch.eye(4, dtype=pP.dtype,
                                           device=pP.device))
    d = cx[:, None] - px[None]
    close = (quad(d, Si[None]) <= 1.0) & pmask[None]
    return cmask & ~close.any(1)


def _dedup_edge(cx, cmask, px, pP, pmask):
    """Candidates whose duplicate test (``_nis_dedup``) lies within
    ``AMBIGUOUS`` of its threshold for some prelim."""
    Si, _ = inv4(pP + R_AIS[1] * torch.eye(4, dtype=pP.dtype,
                                           device=pP.device))
    q = quad(cx[:, None] - px[None], Si[None])
    return cmask & (((q - 1.0).abs() <= AMBIGUOUS) & pmask[None]).any(1)


def _tied(cost, valid):
    """[rows, columns] the valid entries whose cost lies within
    ``AMBIGUOUS`` (relative) of another valid entry of the same row."""
    big = torch.tensor(float("inf"), dtype=cost.dtype, device=cost.device)
    v, idx = torch.sort(torch.where(valid, cost, big), dim=-1)
    close = (v[:, 1:] - v[:, :-1]).abs() \
        <= AMBIGUOUS * torch.clamp(v[:, 1:].abs(), min=1.0)
    close &= torch.isfinite(v[:, 1:])
    upper, lower = torch.zeros_like(valid), torch.zeros_like(valid)
    upper.scatter_(1, idx[:, 1:], close)
    lower.scatter_(1, idx[:, :-1], close)
    return upper | lower


def _close_costs(cost, valid):
    """[columns] the columns an assignment of rows to columns may take
    either way on near-equal costs: tied within a row, or within a
    column."""
    return _tied(cost, valid).any(0) | _tied(cost.T, valid.T).any(1)


def initiate(I, z, zmask, time, ais, c: Cfg, zall=None):
    """One scan of the m-of-n initiator on the measurements no leaf gated
    (and, with ``ais``, the messages that may seed prelims).  Returns the
    initiator after the scan, the confirmed (x, P, mask, mmsi) and the
    links the judge needs: which of the valid measurements ``zall`` each
    prelim and each one-point initiator could take (``reach_p`` [P, M],
    ``reach_i`` [I, M]), the measurements on the edge of one of those
    decisions (``edge_m`` [M]: a gate's or a pairing range's edge, a
    near-equal distance within one row, a pair candidate on the edge of
    the duplicate test), the prelims on the edge of the speed test
    (``edge_p`` [P]) and the messages on the edge of the duplicate test
    (``edge_ais`` [A])."""
    if zall is None:
        zall = zmask
    dev, dt_ = z.device, z.dtype
    p = c.p
    I = dict(I)
    dt = torch.where(I["has_time"], time - I["last_time"],
                     torch.tensor(p["radar_period"], dtype=dt_, device=dev))
    px, pP = predict(I["p_x"], I["p_P"], dt)
    pm = I["p_mask"]
    zero = torch.zeros((), dtype=dt_, device=dev)
    px, pP = torch.where(pm[:, None], px, zero), \
        torch.where(pm[:, None, None], pP, zero)
    pmm, pmi = I["p_mmsi"], I["p_meas_idx"]
    p_m, p_n = I["p_m"], I["p_n"]
    edge_ais = None
    if ais is not None:
        dTa = time - ais["time"]
        F = phi(dTa)
        ax = (F @ ais["state"][..., None])[..., 0]
        aP = F @ p0(ax) @ F.transpose(-1, -2) + q_mat(dTa)
        held = torch.where(pm, pmm, -1)
        new = ais["mask"] & ~(ais["mmsi"][:, None] == held[None]).any(1)
        edge_ais = _dedup_edge(ax, new, px, pP, pm)
        new = _nis_dedup(ax, new, px, pP, pm)
        take, src = _insert_rows(pm, new)
        px = torch.where(take[:, None], ax[src], px)
        pP = torch.where(take[:, None, None], aP[src], pP)
        p_m, p_n = torch.where(take, 0, p_m), torch.where(take, 0, p_n)
        pmm = torch.where(take, ais["mmsi"][src], pmm)
        pmi = torch.where(take, -1, pmi)
        pm = pm | take
    # gate and assign measurements to prelims
    Si, _ = inv2(pP[:, :2, :2] + R_RADAR * torch.eye(2, dtype=dt_,
                                                     device=dev))
    K = pP[:, :, :2] @ Si
    Ph = pP - K @ pP[:, :2, :]
    zt = z[None] - px[:, None, :2]
    nis = quad(zt, Si[:, None])
    gate = (nis <= c.gamma) & zmask[None] & pm[:, None]
    dz = torch.linalg.vector_norm(zt, dim=-1)
    reach_p = (nis <= c.gamma * (1.0 + AMBIGUOUS)) & zall[None] \
        & pm[:, None]
    edge_m = ((nis >= c.gamma * (1.0 - AMBIGUOUS)) & reach_p).any(0) \
        | _close_costs(dz, reach_p)
    a1 = assign(dz, gate).to(dev)
    got = a1 >= 0
    am = a1.clamp(0, c.M - 1)
    ar = torch.arange(c.P, device=dev)
    px = torch.where(got[:, None], px + (K @ zt[ar, am][..., None])[..., 0],
                     px)
    pP = torch.where(got[:, None, None], Ph, pP)
    p_m, p_n = p_m + got.long(), p_n + pm.long()
    pmi = torch.where(got, a1, -1)
    claimed = torch.zeros(c.M, dtype=torch.bool, device=dev)
    claimed[a1[got]] = True
    # m-of-n
    speed = torch.linalg.vector_norm(px[:, 2:], dim=-1)
    fast = speed > 1.5 * p["max_speed"]
    edge_p = pm & ((speed - 1.5 * p["max_speed"]).abs()
                   <= AMBIGUOUS * 1.5 * p["max_speed"])
    conf = pm & (p_m >= p["M_required"]) & ~fast
    dead = pm & (fast | ((p_n >= p["N_checks"]) & (p_m < p["M_required"])))
    out = (px, pP, conf, torch.where(conf, pmm, 0))
    pm = pm & ~(conf | dead)
    # pair the rest with the previous scan's one-point initiators
    un1 = zmask & ~claimed
    d = torch.linalg.vector_norm(z[None] - I["i_pos"][:, None], dim=-1)
    g2 = ((d <= p["max_speed"] * dt) & un1[None] & I["i_mask"][:, None]
          & I["has_time"])
    reach_i = ((d <= p["max_speed"] * dt * (1.0 + AMBIGUOUS)) & zall[None]
               & I["i_mask"][:, None] & I["has_time"])
    edge_m |= ((d >= p["max_speed"] * dt * (1.0 - AMBIGUOUS))
               & reach_i).any(0) | _close_costs(d, reach_i)
    a2 = assign(d, g2).to(dev)
    paired = a2 >= 0
    zp = z[a2.clamp(0, c.M - 1)]
    vel = (zp - I["i_pos"]) / torch.clamp(dt, min=1e-6)
    cx = torch.cat([zp, vel], -1)
    on_edge = _dedup_edge(cx, paired, px, pP, pm)
    edge_m[a2[on_edge]] = True
    ok = _nis_dedup(cx, paired, px, pP, pm)
    take, src = _insert_rows(pm, ok)
    px = torch.where(take[:, None], cx[src], px)
    pP = torch.where(take[:, None, None], p0(px), pP)
    p_m, p_n = torch.where(take, 0, p_m), torch.where(take, 0, p_n)
    pmm, pmi = torch.where(take, 0, pmm), torch.where(take, -1, pmi)
    pm = pm | take
    claimed[a2[paired]] = True
    un2 = zmask & ~claimed
    take3, src3 = _insert_rows(torch.zeros_like(I["i_mask"]), un2)
    I.update(p_x=px, p_P=pP, p_m=p_m, p_n=p_n, p_mask=pm, p_mmsi=pmm,
             p_meas_idx=pmi, i_pos=torch.where(take3[:, None], z[src3],
                                               zero),
             i_mask=take3, last_time=time,
             has_time=torch.ones_like(I["has_time"]))
    links = dict(reach_p=reach_p, reach_i=reach_i, edge_m=edge_m & zall,
                 edge_p=edge_p, edge_ais=edge_ais)
    return I, out, links


def merge_new(x, mask, mmsi, thr):
    """Each new target joins the first within ``thr``; representatives
    take their group's mean state."""
    K = x.shape[0]
    d = torch.linalg.vector_norm(x[:, None, :2] - x[None, :, :2], dim=-1)
    close = (d < thr) & mask[:, None] & mask[None]
    first = close.long().argmax(1)
    ar = torch.arange(K, device=x.device)
    rep = first == ar
    mem = (first[:, None] == ar[None]).to(x.dtype) * mask[:, None]
    mean = (mem.T @ x) / torch.clamp(mem.sum(0)[:, None], min=1.0)
    keep = mask & rep
    return torch.where(keep[:, None], mean, x), keep, torch.where(keep, mmsi,
                                                                  0)


def insert(S, x, P, mask, mmsi, time, c: Cfg):
    free = ~S["tgt_mask"]
    rank_f = torch.cumsum(free.long(), 0) - 1
    rank_n = torch.cumsum(mask.long(), 0) - 1
    match = free[:, None] & mask[None] & (rank_f[:, None] == rank_n[None])
    take, src = match.any(1), match.long().argmax(1)
    dt_, dev = S["leaf_x"].dtype, S["leaf_x"].device
    zero = torch.zeros((), dtype=dt_, device=dev)
    t1, t2, t3 = take[:, None], take[:, None, None], take[:, None, None, None]
    first = torch.zeros_like(S["leaf_mask"])
    first[:, 0] = True
    rx = torch.zeros_like(S["leaf_x"])
    rx[:, 0] = x[src]
    rP = torch.zeros_like(S["leaf_P"])
    rP[:, 0] = P[src]
    return dict(
        S, time=torch.maximum(S["time"], time),
        leaf_x=torch.where(t2, rx, S["leaf_x"]),
        leaf_P=torch.where(t3, rP, S["leaf_P"]),
        leaf_cnllr=torch.where(t1, zero, S["leaf_cnllr"]),
        leaf_mask=torch.where(t1, first, S["leaf_mask"]),
        hist_meas=torch.where(t2, -1, S["hist_meas"]),
        hist_ais=torch.where(t2, 0, S["hist_ais"]),
        hist_mmsi=torch.where(t2, 0, S["hist_mmsi"]),
        hist_cnllr=torch.where(t2, zero, S["hist_cnllr"]),
        hist_x=torch.where(t3, zero, S["hist_x"]),
        tgt_mask=S["tgt_mask"] | take,
        tgt_id=torch.where(take, S["next_id"] + rank_f, S["tgt_id"]),
        tgt_root_cnllr=torch.where(take, zero, S["tgt_root_cnllr"]),
        tgt_depth=torch.where(take, 0, S["tgt_depth"]),
        tgt_window=torch.where(take, c.N, S["tgt_window"]),
        tgt_pd=torch.where(take, torch.tensor(c.p["P_d"], dtype=dt_,
                                              device=dev), S["tgt_pd"]),
        tgt_mmsi=torch.where(take, mmsi[src], S["tgt_mmsi"]),
        sel_leaf=torch.where(take, 0, S["sel_leaf"]),
        next_id=S["next_id"] + mask.sum()), take


# -- one scan -----------------------------------------------------------------

def step(S, I, scan, ais, c: Cfg, select=None):
    """One scan from the state ``S`` and initiator ``I`` (dicts of
    tensors; reals in the dtype of the computation).  ``select(G)`` maps
    the grown forest to (sel [T] long, objective); by default the exact
    optimum.  Returns (state, initiator, outputs, notes)."""
    G, aux = grow(S, scan, ais if c.use_ais else None, c)
    sel, obj = (select or (lambda g: select_exact(g, c)))(G)
    sel = sel.to(G["leaf_mask"].device).long()
    ar = torch.arange(c.T, device=sel.device)
    W = c.W
    out = dict(
        track_mask=G["tgt_mask"], track_id=G["tgt_id"],
        track_x=G["leaf_x"][ar, sel], track_cnllr=G["leaf_cnllr"][ar, sel],
        sel_hist_valid=(torch.arange(W, device=sel.device)[None]
                        >= (W - G["tgt_depth"])[:, None])
        & G["tgt_mask"][:, None],
        sel_hist_x=G["hist_x"][ar, sel], sel_hist_meas=G["hist_meas"][ar, sel],
        sel_hist_mmsi=G["hist_mmsi"][ar, sel],
        gated_counts=aux["gated"], used_meas=aux["used"], sel_obj=obj)
    G["sel_leaf"] = sel
    Sx, dead, reason, near = terminate(G, c, sel)
    Sx, conf = prune(Sx, c, sel)
    out.update(dead=dead, dead_reason=reason, **conf)
    zmask = scan["mask"] & ~aux["used"]
    ais_init = None
    if c.use_ais and ais is not None:
        cur = torch.where(Sx["leaf_mask"], Sx["hist_mmsi"][..., -1], 0)
        ais_init = dict(ais, mask=ais["mask"] & ~(
            ais["mmsi"][:, None] == cur.flatten()[None]).any(1))
    I2, (nx, nP, nmask, nmmsi), links = initiate(
        I, scan["z"], zmask, scan["time"], ais_init, c, zall=scan["mask"])
    nx, nmask, nmmsi = merge_new(nx, nmask, nmmsi, c.merge_threshold)
    lp = Sx["leaf_x"][..., :2].reshape(-1, 2)
    dn = torch.linalg.vector_norm(nx[:, None, :2] - lp[None], dim=-1)
    nmask = nmask & ~((dn < c.merge_threshold)
                      & Sx["leaf_mask"].reshape(-1)[None]).any(1)
    prev = Sx["tgt_mask"]
    S2, _ = insert(Sx, nx, nP, nmask, nmmsi, scan["time"], c)
    out.update(inserted_mask=S2["tgt_mask"] & ~prev,
               leaf_counts=S2["leaf_mask"].sum(1),
               n_leaves=S2["leaf_mask"].sum())
    notes = dict(aux, near_life=near, links=links, grown=G)
    return S2, I2, out, notes


# -- the judge ---------------------------------------------------------------

def to_ref(d: dict, dtype, device) -> dict:
    """A state, initiator or input given as numpy arrays, as tensors for
    the reference: reals in ``dtype``, integers as int64."""
    out = {}
    for k, v in d.items():
        t = torch.as_tensor(np.asarray(v), device=device)
        if t.is_floating_point():
            t = t.to(dtype)
        elif t.dtype != torch.bool:
            t = t.long()
        out[k] = t
    return out


def to_numpy(d: dict) -> dict:
    """A reference state or output as numpy in the system's dtypes
    (float32, int32, bool), to stand in for the system's."""
    out = {}
    for k, v in d.items():
        if not isinstance(v, torch.Tensor):
            v = torch.tensor(v)
        v = v.detach().cpu()
        if v.is_floating_point():
            v = v.float()
        elif v.dtype != torch.bool:
            v = v.int()
        out[k] = v.numpy()
    return out


def _leaf_keys(S, t) -> dict:
    """Live leaves of target ``t`` keyed by their label history."""
    live = np.nonzero(S["leaf_mask"][t])[0]
    keys = np.concatenate([S["hist_meas"][t], S["hist_ais"][t],
                           S["hist_mmsi"][t]], -1).astype(np.int64)
    return {keys[l].tobytes(): l for l in live}


def _rel(a, b) -> float:
    """Largest |a - b| / max(1, |b|) (0 for empty arrays)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.size == 0:
        return 0.0
    return float((np.abs(a - b) / np.maximum(1.0, np.abs(b))).max())


NUMBERS = ("gate_mismatch", "beam_mismatch", "life_mismatch",
           "init_mismatch", "sel_mismatch", "sel_gap", "score_err",
           "state_err")


def judge(pre, pre_init, scan, ais, c: Cfg, post, post_init, out,
          device="cpu") -> dict:
    """The numbers of ``NUMBERS`` for one scan of the system: ``pre`` /
    ``pre_init`` its state and initiator before the scan, ``post`` /
    ``post_init`` / ``out`` after it (numpy dicts named by the system's
    fields), ``scan`` / ``ais`` the inputs it was handed (numpy, padded).
    Counts are of disagreements beyond rounding; ``sel_gap`` is the
    system's selection against the exact optimum as (objective -
    optimum) / max(1, |optimum|); the errors are relative, max(1, |ref|).
    ``parts`` holds the largest relative error of each kind of state
    behind ``state_err``."""
    f64 = torch.float64
    S, I = to_ref(pre, f64, device), to_ref(pre_init, f64, device)
    sc = to_ref(scan, f64, device)
    ai = to_ref(ais, f64, device) if ais is not None else None
    G, aux = grow(S, sc, ai if c.use_ais else None, c)
    ambig = (aux["amb_beam"] | (aux["amb_gate"] > 0)).cpu().numpy()
    n = dict.fromkeys(NUMBERS, 0.0)
    # the system's selection, found in the reference's forest by its
    # labels (the closest score where labels tie)
    Gn = {k: v.cpu().numpy() for k, v in G.items()}
    f = leaf_f(G, c).cpu().numpy()
    sel = np.zeros(c.T, np.int64)
    lost = np.zeros(c.T, bool)
    for t in np.nonzero(Gn["tgt_mask"])[0]:
        same = (Gn["leaf_mask"][t]
                & (Gn["hist_meas"][t] == out["sel_hist_meas"][t]).all(-1)
                & (Gn["hist_mmsi"][t] == out["sel_hist_mmsi"][t]).all(-1))
        cand = np.nonzero(same)[0]
        if len(cand) == 0:
            lost[t] = True
            sel[t] = int(np.argmin(f[t]))
            continue
        sel[t] = cand[np.argmin(np.abs(Gn["leaf_cnllr"][t, cand]
                                       - out["track_cnllr"][t]))]
    n["sel_mismatch"] += float((lost & ~ambig).sum())
    sel_t = torch.as_tensor(sel, device=device)
    if not feasible(G, c, sel_t):
        n["sel_mismatch"] += 1
    tm = Gn["tgt_mask"]
    obj = float(f[np.arange(c.T), sel][tm].sum())
    _, opt = select_exact(G, c)
    n["sel_gap"] = max(0.0, (obj - opt) / max(1.0, abs(opt)))
    n["score_err"] = _rel(out["sel_obj"], obj)
    # the rest of the scan, under the system's selection
    S2, I2, ref, notes = step(S, I, sc, ai, c,
                              select=lambda g: (sel_t, obj))
    ref = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
           for k, v in ref.items()}
    S2 = {k: v.cpu().numpy() for k, v in S2.items()}
    I2 = {k: v.cpu().numpy() for k, v in I2.items()}
    amb_gate = aux["amb_gate"].cpu().numpy()
    amb_meas = aux["amb_meas"].cpu().numpy()
    gd = np.abs(out["gated_counts"].astype(np.int64) - ref["gated_counts"])
    n["gate_mismatch"] = float(np.maximum(gd - amb_gate, 0).sum()
                               + ((out["used_meas"] != ref["used_meas"])
                                  & ~amb_meas).sum())
    # termination, pruning and the outputs of the live tracks
    near = notes["near_life"].cpu().numpy()
    life = ((out["dead"] != ref["dead"])
            | (out["dead_reason"] != ref["dead_reason"])) & ~near
    conf = ((out["confirmed_mask"] != ref["confirmed_mask"]).any(-1)
            | ((out["confirmed_meas"] != ref["confirmed_meas"])
               & ref["confirmed_mask"]).any(-1))
    n["life_mismatch"] = float((life | (conf & ~ambig)).sum())
    live = tm & ~lost
    parts = dict(track_x=_rel(out["track_x"][live], ref["track_x"][live]))
    n["score_err"] = max(n["score_err"], _rel(out["track_cnllr"][live],
                                              ref["track_cnllr"][live]))
    # the initiator, row by row, leaving out the rows that a decision on
    # the edge may have changed
    bad, excused, p_err, i_err, differ, births_moved = initiator_rows(
        pre_init, post_init, I2, scan, ais, notes, ambig | near, post, c)
    n["init_mismatch"] = float(bad)
    parts.update(prelims=p_err, initiators=i_err)
    # the forest after the scan, target by target, leaf by leaf; where a
    # prelim that could confirm was decided otherwise, or on an edge, the
    # targets born in the scan on either side follow from that decision
    # and are left out
    new_t = out["inserted_mask"] | ref["inserted_mask"]
    if not births_moved:
        new_t = np.zeros_like(new_t)
    excused += int(new_t.sum())
    for k in ("tgt_mask", "tgt_id", "tgt_depth", "tgt_mmsi"):
        n["life_mismatch"] += float(((post[k] != S2[k]) & ~new_t).sum())
    n["life_mismatch"] += float(((out["inserted_mask"]
                                  != ref["inserted_mask"]) & ~new_t).sum())
    n["excused"], n["differ"] = excused, differ
    errs_c, errs_x, errs_p = [], [], []
    both = post["tgt_mask"] & S2["tgt_mask"] & ~new_t
    for t in np.nonzero(both)[0]:
        kp, kr = _leaf_keys(post, t), _leaf_keys(S2, t)
        if kp.keys() != kr.keys():
            n["beam_mismatch"] += float(not ambig[t])
            continue
        lp = np.array(list(kp.values()))
        lr = np.array([kr[k] for k in kp])
        errs_c.append(_rel(post["leaf_cnllr"][t, lp], S2["leaf_cnllr"][t, lr]))
        errs_x.append(_rel(post["leaf_x"][t, lp], S2["leaf_x"][t, lr]))
        errs_p.append(_rel(post["leaf_P"][t, lp], S2["leaf_P"][t, lr]))
    n["score_err"] = max([n["score_err"], *errs_c,
                          _rel(post["tgt_root_cnllr"][both],
                               S2["tgt_root_cnllr"][both])])
    parts.update(leaf_x=max(errs_x, default=0.0),
                 leaf_P=max(errs_p, default=0.0))
    n["state_err"] = max(n["state_err"], *parts.values())
    n["parts"] = parts
    return n


def _components(reach, seeds):
    """[M] the measurements joined to one of ``seeds`` [M] through rows
    of the [rows, M] masks in ``reach``: the rows' decisions are joint
    assignments, so a change on the edge may move any of them."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    M = seeds.shape[0]
    rows, cols, base = [], [], M
    for r in reach:
        i, j = np.nonzero(r)
        rows.append(i + base)
        cols.append(j)
        base += r.shape[0]
    i, j = np.concatenate(rows), np.concatenate(cols)
    g = coo_matrix((np.ones(len(i)), (i, j)), shape=(base, base))
    _, label = connected_components(g, directed=False)
    return np.isin(label[:M], label[:M][seeds])


def _origin(pos, z, zmask, tol=1e-3):
    """[k] the index of the valid row of ``z`` each row of ``pos`` [k, 2]
    was taken from (its position, to ``tol`` m), or -1."""
    if len(pos) == 0:
        return np.zeros(0, np.int64)
    d = np.linalg.norm(pos[:, None].astype(np.float64)
                       - z[None].astype(np.float64), axis=-1)
    d[:, ~zmask] = np.inf
    j = d.argmin(1)
    return np.where(d[np.arange(len(pos)), j] <= tol, j, -1)


def initiator_rows(pre_i, sys_i, ref_i, scan, ais, notes, amb_t, post,
                   c: Cfg):
    """The initiator's rows after a scan, the system's (``sys_i``) against
    the reference's (``ref_i``), both from ``pre_i``: a prelim that lived
    before the scan by its slot; a prelim seeded by an AIS message by its
    MMSI; one made from a pair of returns, and a one-point initiator, by
    the measurement it was taken from.  A row differs when it is on one
    side only or its counts, MMSI or measurement differ.  Left out: rows
    that a decision on the edge may have changed, i.e. those joined by the
    prelims' gates and the pairing ranges to a measurement on the edge of
    a leaf's gate or of one of the initiator's decisions, prelims on the
    edge of the speed test, messages on the edge of the duplicate test or
    carried by a leaf of a target ``amb_t`` whose gate, beam or
    termination was on the edge; and, where a table is full, the rows
    past the first that the order of insertion may drop.  Returns (rows
    that differ, rows left out, the largest relative error of the
    prelims' and of the initiators' states among the rows matched, a
    line on each row that differs, and whether a prelim that could
    confirm in this scan differs or was left out)."""
    lk = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
          for k, v in notes["links"].items()}
    z, zm = scan["z"], scan["mask"].astype(bool)
    seeds = (notes["amb_meas"].cpu().numpy() | lk["edge_m"]) & zm
    taint = _components([lk["reach_p"], lk["reach_i"]], seeds)
    bad = excused = 0
    p_err, i_err = [0.0], [0.0]
    # prelims that lived before the scan, slot by slot
    was = pre_i["p_mask"].astype(bool)
    hit = (lk["reach_p"] & taint[None]).any(1) | lk["edge_p"]
    surv = [s["p_mask"] & (s["p_n"] > 0) & was for s in (sys_i, ref_i)]
    differ = []

    def _span(key, part):
        """A pair's distance from its initiator to its measurement."""
        if part != 1:
            return ""
        m, f = key
        return (f", {np.linalg.norm(z[m] - pre_i['i_pos'][f]):.4f} m "
                "apart")

    can = was & (pre_i["p_m"] >= c.p["M_required"] - 1)
    births_moved = False
    for k in np.nonzero(was)[0]:
        if hit[k]:
            excused += 1
            births_moved |= bool(can[k])
        elif surv[0][k] != surv[1][k] or (surv[1][k] and any(
                sys_i[f][k] != ref_i[f][k]
                for f in ("p_m", "p_n", "p_mmsi", "p_meas_idx"))):
            bad += 1
            births_moved |= bool(can[k])
            differ.append(f"prelim slot {k}: kept {surv[0][k]} / "
                          f"{surv[1][k]}, measurement "
                          f"{sys_i['p_meas_idx'][k]} / "
                          f"{ref_i['p_meas_idx'][k]}")
        elif surv[1][k]:
            p_err.append(_rel(sys_i["p_x"][k], ref_i["p_x"][k]))
    # messages whose prelim a decision on the edge may have moved
    moved_mmsi = set()
    G = notes["grown"]
    for side in (post, G):
        hm, lm = (np.asarray(side[k].cpu() if isinstance(side[k],
                                                          torch.Tensor)
                             else side[k]) for k in ("hist_mmsi",
                                                     "leaf_mask"))
        for t in np.nonzero(amb_t)[0]:
            moved_mmsi.update(int(m)
                              for m in hm[t][lm[t].astype(bool), -1])
    if lk["edge_ais"] is not None and ais is not None:
        moved_mmsi.update(int(m) for m in ais["mmsi"][lk["edge_ais"]])
    # prelims new in this scan (seeded by a message, or by a pair) and
    # one-point initiators, matched by their key
    # a prelim that a full table could not take is left out
    full_p = [bool(s["p_mask"].all()) for s in (sys_i, ref_i)]
    full_i = [bool(s["i_mask"].all()) for s in (sys_i, ref_i)]
    # a prelim made from a pair is keyed by its measurement and by the
    # one-point initiator its velocity came from
    dt = (float(scan["time"]) - float(pre_i["last_time"])
          if bool(pre_i["has_time"]) else float(c.p["radar_period"]))
    i_was = pre_i["i_mask"].astype(bool)
    keyed = []
    for s in (sys_i, ref_i):
        live = s["p_mask"].astype(bool)
        a = np.nonzero(live & ~was & (s["p_n"] > 0))[0]
        q = np.nonzero(live & (s["p_n"] == 0))[0]
        i = np.nonzero(s["i_mask"].astype(bool))[0]
        px = s["p_x"][q].astype(np.float64)
        oq = _origin(px[:, :2], z, zm)
        fro = _origin(px[:, :2] - px[:, 2:] * dt, pre_i["i_pos"], i_was,
                      tol=0.05)
        oi = _origin(s["i_pos"][i], z, zm)
        # a row taken from no measurement, or no initiator, is wrong
        bad += int((oq < 0).sum() + (fro < 0).sum() + (oi < 0).sum())
        keyed.append((
            {int(s["p_mmsi"][k]): k for k in a},
            {(int(m), int(f)): k for m, f, k in zip(oq, fro, q)
             if m >= 0 and f >= 0},
            {int(m): k for m, k in zip(oi, i) if m >= 0}))
    for part in range(3):
        ks, kr = keyed[0][part], keyed[1][part]
        cut = None
        if part == 2 and any(full_i):
            # one-point initiators fill the table in the order of their
            # measurements: past a full table the k-th of one side may be
            # the (k+1)-th of the other, so compare below both sides' last
            cut = min(max(ks, default=-1), max(kr, default=-1))
        for key in ks.keys() | kr.keys():
            if part == 0:
                skip = key in moved_mmsi
            else:
                skip = bool(taint[key[0] if part == 1 else key])
            skip = skip or (part < 2 and any(full_p) and not (
                key in ks and key in kr)) or (cut is not None and key > cut)
            if skip:
                excused += 1
                continue
            if key not in ks or key not in kr:
                bad += 1
                differ.append(f"{('message', 'pair', 'point')[part]} "
                              f"{key} on the "
                              f"{'system' if key in ks else 'reference'}"
                              f"'s side only{_span(key, part)}")
                continue
            a, b = ks[key], kr[key]
            if part == 2:
                i_err.append(_rel(sys_i["i_pos"][a], ref_i["i_pos"][b]))
                continue
            if any(sys_i[f][a] != ref_i[f][b]
                   for f in ("p_m", "p_n", "p_mmsi", "p_meas_idx")):
                if part == 0 and hit[b]:
                    excused += 1
                else:
                    bad += 1
                    differ.append(f"message {key}: counts or measurement")
                continue
            p_err.append(_rel(sys_i["p_x"][a], ref_i["p_x"][b]))
    return bad, excused, max(p_err), max(i_err), differ, births_moved


def control(pre, pre_init, scan, ais, c: Cfg, dtype=torch.bfloat16,
            device="cpu"):
    """The reference computed in ``dtype`` in the system's place: its
    (post, post_init, out) as numpy in the system's formats."""
    S, I = to_ref(pre, dtype, device), to_ref(pre_init, dtype, device)
    sc = to_ref(scan, dtype, device)
    ai = to_ref(ais, dtype, device) if ais is not None else None
    S2, I2, out, _ = step(S, I, sc, ai, c)
    return to_numpy(S2), to_numpy(I2), to_numpy(out)

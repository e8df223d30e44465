"""Matplotlib visualisation of tracker output (counterpart of
pymht_tpu/utils/plotting.py).

Covers the reference's plotting family (tracker.py:1291-1397,
pyTarget.py:533-743, the classDefinitions plot methods): active and
terminated tracks with ID labels and start/end markers, raw measurement
overlays, validation-region ellipses from the innovation covariance,
velocity arrows, smoothed-track overlays and ground-truth trails.  Every
function draws on an axes the caller supplies, from a ``Tracker`` or host
data; device tensors are copied to the host.  ``matplotlib`` is imported
only where a function needs it (the GPU machine may have none), so the
caller chooses the backend (``matplotlib.use('Agg')`` when headless).
"""
from __future__ import annotations

import numpy as np


def _np(t):
    """A tracker tensor (on any device) as numpy."""
    return t.detach().cpu().numpy()


def _best_text_position(nv):
    """Label placement quadrant rule (reference helpFunctions.py:7-29)."""
    heading = (np.degrees(np.arctan2(nv[0], nv[1])) + 360.0) % 360.0
    quadrant = int(2 + (heading - 90) // 90)
    return {1: ('right', 'top'), 2: ('right', 'bottom'),
            3: ('left', 'bottom'), 4: ('left', 'top')}.get(
        quadrant, ('center', 'center'))


def plot_track(ax, times, states, track_id=None, color=None,
               mark_start=True, mark_end=True, smooth_overlay=None,
               terminated=False):
    xs = np.asarray(states)
    if xs.ndim != 2 or len(xs) == 0:
        return
    ax.plot(xs[:, 0], xs[:, 1], '-', c=color, linewidth=1.2)
    if smooth_overlay is not None and len(smooth_overlay):
        so = np.asarray(smooth_overlay)
        ax.plot(so[:, 0], so[:, 1], '--', c=color, linewidth=1.0, alpha=0.8)
    if mark_start:
        ax.plot(xs[0, 0], xs[0, 1], '*', mfc='black', mec='black')
    if mark_end:
        ax.plot(xs[-1, 0], xs[-1, 1], 'H', mfc='none', mec='black')
        if terminated:
            ax.plot(xs[-1, 0], xs[-1, 1], '*', mec='red', mfc='none')
    if track_id is not None and xs.shape[1] >= 4:
        v = xs[0, 2:4]
        nv = v / max(np.linalg.norm(v), 1e-9)
        ha, va = _best_text_position(nv)
        ax.text(xs[0, 0], xs[0, 1], f"T{track_id}", fontsize=9,
                horizontalalignment=ha, verticalalignment=va)


def plot_tracks(ax, tracker, colors=None, smooth=False,
                include_terminated=True):
    """All tracks of a Tracker: confirmed + window states."""
    colors = colors or ['r', 'g', 'b', 'c', 'm', 'y', 'k']
    smoothed = tracker.get_smooth_tracks(include_terminated=True) \
        if smooth else {}
    seqs = tracker._track_measurement_sequences(
        include_terminated=include_terminated)
    term_ids = set(tracker.terminated)
    for i, (tid, (times, labels, states, _mmsi)) in \
            enumerate(sorted(seqs.items())):
        overlay = None
        if tid in smoothed and smoothed[tid][2]:
            overlay = smoothed[tid][0]
        plot_track(ax, times, states, track_id=tid,
                   color=colors[i % len(colors)],
                   smooth_overlay=overlay, terminated=tid in term_ids)


def plot_measurements(ax, scans, color='black', alpha=0.5):
    """Raw scans overlay (reference ScanList.plotFast)."""
    for z in scans:
        z = np.asarray(getattr(z, 'measurements', z))
        if len(z):
            ax.plot(z[:, 0], z[:, 1], '.', color=color, alpha=alpha,
                    markersize=2)


def plot_validation_ellipse(ax, z_hat, S, eta2, **kw):
    """Gate ellipse from innovation covariance
    (reference _plotCovarianceEllipse, pyTarget.py:535-553)."""
    from matplotlib.patches import Ellipse
    S = np.asarray(S)
    lam, vec = np.linalg.eigh(S)
    angle = np.degrees(np.arctan2(vec[1, 0], vec[0, 0]))
    ell = Ellipse(xy=(z_hat[0], z_hat[1]),
                  width=2 * np.sqrt(max(lam[0], 0) * eta2),
                  height=2 * np.sqrt(max(lam[1], 0) * eta2),
                  angle=angle, linewidth=1.5)
    ell.set_facecolor('none')
    ell.set_linestyle('dotted')
    ell.set_alpha(kw.get('alpha', 0.5))
    ax.add_artist(ell)
    return ell


def plot_validation_regions(ax, tracker, eta2=None):
    """Gate ellipses around every active track's predicted measurement
    (the port's ``ops/kalman`` on CPU tensors)."""
    import torch

    from ..models import pv
    from ..ops import kalman as k
    cpu = torch.device("cpu")
    eta2 = eta2 or tracker.params.eta2
    st = tracker.state
    mask = _np(st.tgt_mask)
    sel = _np(st.sel_leaf)
    leaf_x, leaf_P = st.leaf_x.cpu(), st.leaf_P.cpu()
    A = pv.Phi(tracker.params.radar_period, cpu)
    Q = pv.Q(tracker.params.radar_period, device=cpu)
    for t in np.nonzero(mask)[0]:
        x = leaf_x[t, sel[t]]
        P = leaf_P[t, sel[t]]
        xb, Pb = k.predict(A, Q, x, P)
        zh, S, _, _, _ = k.precalc(pv.C_RADAR(cpu), pv.R_RADAR(cpu), xb, Pb)
        plot_validation_ellipse(ax, zh.numpy(), S.numpy(), eta2)


def plot_velocity_arrows(ax, tracker, scale=1.0):
    st = tracker.state
    mask = _np(st.tgt_mask)
    sel = _np(st.sel_leaf)
    x = _np(st.leaf_x)
    for t in np.nonzero(mask)[0]:
        s = x[t, sel[t]]
        ax.arrow(s[0], s[1], s[2] * scale, s[3] * scale,
                 head_width=0.5, fc='none', ec='k', alpha=0.4,
                 length_includes_head=True)


def plot_hypotheses(ax, tracker, color='gray', sel_color='red',
                    alpha=0.35):
    """Draw every live hypothesis branch's window trajectory per target,
    highlighting the selected leaf — the reference's hypothesis-tree
    track plot (tracker.py:1291-1309, pyTarget.plotTrack family)."""
    st = tracker.state
    mask = _np(st.tgt_mask)
    lmask = _np(st.leaf_mask)
    hist_x = _np(st.hist_x)
    depth = _np(st.tgt_depth)
    sel = _np(st.sel_leaf)
    W = hist_x.shape[2]
    for t in np.nonzero(mask)[0]:
        w0 = W - int(depth[t])
        for l in np.nonzero(lmask[t])[0]:
            xy = hist_x[t, l, w0:, :2]
            if len(xy) < 1:
                continue
            if l == sel[t]:
                ax.plot(xy[:, 0], xy[:, 1], '-', color=sel_color,
                        linewidth=1.2, zorder=3)
            else:
                ax.plot(xy[:, 0], xy[:, 1], '-', color=color,
                        linewidth=0.5, alpha=alpha, zorder=2)


def plot_ground_truth(ax, sim_list, colors=None, label=True):
    """Truth trails (reference SimList.plot)."""
    n_targets = len(sim_list[0])
    arr = np.array([[t.cartesian_state() for t in sample]
                    for sample in sim_list])
    for k in range(n_targets):
        ax.plot(arr[:, k, 0], arr[:, k, 1], '.', alpha=0.6,
                markersize=2,
                color=None if colors is None else colors[k % len(colors)])
        if label:
            v = arr[0, k, 2:4]
            nv = v / max(np.linalg.norm(v), 1e-9)
            ha, va = _best_text_position(nv)
            ax.text(arr[0, k, 0], arr[0, k, 1], f"G{k}", fontsize=8,
                    horizontalalignment=ha, verticalalignment=va)


def plot_terminated_tracks(ax, tracker, color='0.5'):
    """Only the terminated tracks, end-marked red (reference
    plotTerminatedTracks, tracker.py:1321-1329)."""
    for tid, arch in sorted(tracker.terminated.items()):
        if arch.states:
            plot_track(ax, arch.times, arch.states, track_id=tid,
                       color=color, terminated=True)


def plot_ais_updates(ax, ais_history, color='tab:orange', alpha=0.7):
    """AIS message positions, one marker per message (reference
    plotLastAisUpdate/plotAllAisUpdates, tracker.py:1366-1381).
    ``ais_history`` is an iterable of per-scan message lists (each
    message has .state); the Tracker records it as ``ais_history``."""
    pts = [np.asarray(m.state)[:2]
           for group in ais_history for m in (group or [])]
    if pts:
        pts = np.stack(pts)
        ax.plot(pts[:, 0], pts[:, 1], 'x', c=color, alpha=alpha,
                markersize=5)


def plot_initial_targets(ax, states, **kw):
    """Initial target positions (reference plotInitialTargets,
    tracker.py:1387-1397)."""
    xs = np.asarray([np.asarray(s)[:2] for s in states])
    if len(xs):
        ax.plot(xs[:, 0], xs[:, 1], 'k+', markersize=8, **kw)

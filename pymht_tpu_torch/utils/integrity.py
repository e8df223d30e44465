"""Structural invariants of the forest state (the port's own copy of
pymht_tpu/utils/integrity.py), checked with numpy on the host.  Used by
the tests every scan and exposed as ``Tracker.check_integrity()``.
"""
import numpy as np


def check_state_integrity(tracker):
    """Raise AssertionError if the tracker's forest breaks an invariant.
    The beam width is read from the state, so a tracker whose beam was
    shrunk or expanded is checked as it stands."""
    st = tracker.state
    W = tracker.shapes.window

    def host(t):
        return t.cpu().numpy()

    tgt_mask = host(st.tgt_mask)
    leaf_mask = host(st.leaf_mask)
    depth = host(st.tgt_depth)
    hist_meas = host(st.hist_meas)
    hist_ais = host(st.hist_ais)
    hist_mmsi = host(st.hist_mmsi)
    cnllr = host(st.leaf_cnllr)
    hist_cnllr = host(st.hist_cnllr)
    sel = host(st.sel_leaf)
    ids = host(st.tgt_id)
    tgt_mmsi = host(st.tgt_mmsi)

    # leaves only on active targets
    assert not (leaf_mask & ~tgt_mask[:, None]).any()
    # every active target has >= 1 leaf
    assert (leaf_mask.any(axis=1) | ~tgt_mask).all()
    # selected leaf is live
    for t in np.nonzero(tgt_mask)[0]:
        assert leaf_mask[t, sel[t]]
    # track ids unique among active
    active_ids = ids[tgt_mask]
    assert len(set(active_ids.tolist())) == len(active_ids)
    # depth bounds + column alignment: valid labels exactly in the last
    # `depth` columns
    for t in np.nonzero(tgt_mask)[0]:
        assert 0 <= depth[t] <= W
        live = np.nonzero(leaf_mask[t])[0]
        for leaf in live:
            labels = hist_meas[t, leaf]
            assert (labels[:W - depth[t]] == -1).all(), (t, leaf, labels)
            assert (labels[W - depth[t]:] >= 0).all(), (t, leaf, labels)
        # distinct leaves have distinct window histories (trie property)
        sigs = {tuple(hist_meas[t, leaf].tolist())
                + tuple(hist_ais[t, leaf].tolist()) for leaf in live}
        assert len(sigs) == len(live)
        # single MMSI per path
        for leaf in live:
            ms = set(hist_mmsi[t, leaf][hist_mmsi[t, leaf] > 0].tolist())
            if tgt_mmsi[t] > 0:
                ms.add(int(tgt_mmsi[t]))
            assert len(ms) <= 1, (t, leaf, ms)
    # finite scores; history cnllr of last column == leaf cnllr
    assert np.isfinite(cnllr[leaf_mask]).all()
    np.testing.assert_allclose(hist_cnllr[:, :, -1][leaf_mask],
                               cnllr[leaf_mask], rtol=1e-5)

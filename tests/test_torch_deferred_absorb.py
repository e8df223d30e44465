"""The deferred archive update of ``Tracker.add_measurement_list``: a
stepped scan's outputs are absorbed into the track archive at the next
call, after that call has launched its own step, or at the first read
of the archive before then.  Held, call by call, to a tracker that
absorbs each scan's outputs before its call returns, on a swarm scene
with AIS (the benchmark's configuration cut for the CPU) and on a
radar-only scene: the archive, the tracks, the XML export and a
checkpoint round trip are the same, and nothing written into the arrays
a call returns reaches the archive."""
import dataclasses
import sys
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pymht_tpu_torch import Tracker, TrackerParams, TrackerShapes  # noqa: E402
from pymht_tpu_torch.core.tracker import TrackArchive  # noqa: E402
from pymht_tpu_torch.utils import checkpoint, scenes  # noqa: E402
from pymht_tpu_torch.utils import xml_io  # noqa: E402

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
N_SCANS = 12


class Immediate(Tracker):
    """The reference: each call's outputs are in the archive when the
    call returns."""

    def add_measurement_list(self, *a, **kw):
        out = super().add_measurement_list(*a, **kw)
        self.flush()
        return out


def swarm_ais():
    """(Tracker arguments, pre_initialize arguments, scans as (t, z,
    messages)) of the benchmark's swarm, cut for the CPU."""
    sys.path.insert(0, str(BENCH))
    try:
        from small import small
        import stream as stream_mod
    finally:
        sys.path.remove(str(BENCH))
    cfg, traffic = small("swarm1000")
    p = dict(cfg["params"])
    p["position"] = tuple(p["position"])
    params = TrackerParams(**p)
    st = stream_mod.Stream(traffic, dict(period=params.radar_period,
                                         range=params.radar_range),
                           2147483901)
    blk = st.block(0)
    x0, mmsi = st.initial
    return (dict(shapes=TrackerShapes(**cfg["shapes"]), params=params,
                 method=cfg["method"], use_ais=True),
            ((0.0, x0), dict(mmsi=mmsi)),
            [(blk.times[i], blk.z[i], blk.ais[i]) for i in range(N_SCANS)])


def radar_only():
    """bench.py's radar scene (T=128, L=32, W=7) at 24 seeded targets."""
    shapes, params, scans, _, seeds = scenes.bench_scene(n_targets=24,
                                                         n_scans=N_SCANS)
    return (dict(shapes=shapes, params=params, method="lagrangian",
                 use_ais=False),
            ((scans[0].time - params.radar_period, seeds), {}),
            [(s.time, s.measurements, None) for s in scans[:N_SCANS]])


def _same(a, b, where="."):
    """Equal trees of dicts, sequences, TrackArchives and arrays, bit for
    bit."""
    if isinstance(a, TrackArchive):
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, (np.ndarray, np.generic, torch.Tensor)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=where)
    else:
        assert a == b, where


def _xml(tracker) -> bytes:
    """The tracker's run as the XML export writes it, its wall-clock
    runtimes left out."""
    root = ET.Element("run")
    xml_io.store_run(root, tracker)
    for run in root:
        for rt in run.findall(xml_io.RUNTIME):
            run.remove(rt)
    return ET.tostring(root)


def _round_trip(tracker, path) -> dict:
    """The archive of ``tracker`` saved and loaded again."""
    checkpoint.save(tracker, path)
    back = checkpoint.load(path, device="cpu")
    return dict(archives=back.archives, terminated=back.terminated,
                scan_times=back.scan_times)


def _assert_same_archive(ref, tr, path):
    """What a reader of the archive sees, ``tr`` against ``ref``; the
    tracks first, so that a pending scan's absence shows there."""
    _same(ref.get_tracks(), tr.get_tracks(), "get_tracks")
    _same(ref.archives, tr.archives, "archives")
    _same(ref.terminated, tr.terminated, "terminated")
    _same(ref.init_P, tr.init_P, "init_P")
    _same(ref._track_measurement_sequences(True),
          tr._track_measurement_sequences(True), "sequences")
    assert _xml(tr) == _xml(ref)
    _same(_round_trip(ref, f"{path}/ref"), _round_trip(tr, f"{path}/tr"),
          "checkpoint")


@pytest.mark.parametrize("scene, every, pipelined", [
    (swarm_ais, 1, False), (swarm_ais, 3, False),
    (radar_only, 1, False), (radar_only, 3, False),
    (radar_only, N_SCANS, True)],
    ids=["swarm-ais-every-call", "swarm-ais-every-third",
         "radar-every-call", "radar-every-third",
         "radar-pipelined-at-end"])
def test_deferred_archive_equals_immediate(scene, every, pipelined,
                                           tmp_path):
    """Read every call, each call's absorb runs on the read; read every
    third, the others run behind the next call's replay.  After each
    stepped call the outputs are scribbled over (the caller's own).  With
    ``pipeline_outputs``, ``get_tracks()`` after the last call holds the
    last scan."""
    torch.set_num_threads(1)
    kw, (pre_a, pre_kw), scans = scene()
    ref = Immediate(device="cpu", **kw)
    tr = Tracker(device="cpu", pipeline_outputs=pipelined, **kw)
    for tracker in (ref, tr):
        tracker.pre_initialize(*pre_a, **pre_kw)
    for i, (t, z, msgs) in enumerate(scans):
        a = ref.add_measurement_list(t, z, msgs)
        b = tr.add_measurement_list(t, z, msgs)
        _same(a._asdict(), b._asdict(), f"outputs of scan {i}")
        if not pipelined:
            for f in b:
                f[...] = ~f if f.dtype == bool else f + 7
        if (i + 1) % every == 0:
            _assert_same_archive(ref, tr, tmp_path / str(i))
    assert len(ref.archives) >= 3 and ref.init_P
    if not pipelined:           # one read a call, at the same place
        assert tr.host_syncs == ref.host_syncs
    assert len(tr.scan_times) == N_SCANS

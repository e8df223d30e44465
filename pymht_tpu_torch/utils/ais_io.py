"""Host-side AIS message stream utilities (the port's own copy of
pymht_tpu/utils/ais_io.py).

Mirrors the reference pyMHT's AIS container contracts
(pymht/utils/classDefinitions.py:497-626):

* ``AisMessageStream`` — the AisMessagesList iteration contract: groups
  of messages are released once their whole group is at or before the
  queried scan time (getMeasurements, classDefinitions.py:522-533).
* ``dedup_latest_per_mmsi`` — AisMessageList's constructor behaviour:
  duplicate MMSIs keep only the newest message
  (classDefinitions.py:599-617).
"""
from __future__ import annotations

from collections import Counter


def dedup_latest_per_mmsi(messages):
    """Duplicate MMSIs keep only the latest message."""
    counts = Counter(m.mmsi for m in messages)
    out = []
    latest = {}
    for m in messages:
        if counts[m.mmsi] == 1:
            continue
        if m.mmsi not in latest or m.time > latest[m.mmsi].time:
            latest[m.mmsi] = m
    for m in messages:
        if counts[m.mmsi] == 1 or latest.get(m.mmsi) is m:
            out.append(m)
    return out


class AisMessageStream:
    """Release AIS message groups per radar scan.

    Usage::

        stream = AisMessageStream(groups)   # e.g. simulator.simulate_ais
        for scan in scans:
            msgs = stream.get_measurements(scan.time)
            tracker.add_measurement_list(scan.time, scan.measurements, msgs)
    """

    def __init__(self, groups):
        self._groups = list(groups)
        self._idx = 0

    def get_measurements(self, scan_time):
        if self._idx >= len(self._groups):
            return []
        group = self._groups[self._idx]
        if all(m.time <= scan_time for m in group):
            self._idx += 1
            return dedup_latest_per_mmsi(group)
        return []

    getMeasurements = get_measurements

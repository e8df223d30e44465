"""The device (H100): the share of the time inside the tracker's calls
in which the step graph was not running, 1 - (sum of the step-graph
events) / (sum of the host-clock calls), over the same scans (the
profiled stretch left out).  The scan's upload and output fetch count as
idle."""


def read(tr):
    busy, calls = sum(tr["replay_ms"]) / 1e3, sum(tr["call_s"])
    if not tr["replay_ms"] or calls <= 0:
        return None
    return 100.0 * (1.0 - busy / calls)

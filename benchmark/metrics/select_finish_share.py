"""Select, the exact finish (``core/select.finish``): exact finishes
entered over selections that reached tier 3's Lagrangian, in %.  Both are
process-wide counters of the program (``utils/timing.counters``), since
the process began, warm-up and the profiled stretch included; the run's
own process holds them, so they are read from the port's loaded module.
Tier 2's truncated enumeration opens most finishes on dense small
clusters, so the share can pass 100 %.  None where the program keeps no
such counters, or no selection reached tier 3."""
import sys


def counters():
    """The loaded program's counters, or None."""
    timing = sys.modules.get("pymht_tpu_torch.utils.timing")
    read = getattr(timing, "counters", None)
    return read() if read is not None else None


def read(tr):
    c = counters()
    if not c or not c.get("select_tier3"):
        return None
    return 100.0 * c["finish_entered"] / c["select_tier3"]

"""Select, the exact finish: iterations of its branch-and-bound loop (the
device's WHILE node, ``finish.search``) per finish entered.  Both are
process-wide counters of the program (``utils/timing.counters``), since
the process began, warm-up and the profiled stretch included; the run's
own process holds them, so they are read from the port's loaded module.
None where the program keeps no such counters, or no finish ran."""
import sys


def read(tr):
    timing = sys.modules.get("pymht_tpu_torch.utils.timing")
    counters = getattr(timing, "counters", None)
    c = counters() if counters is not None else None
    if not c or not c.get("finish_entered"):
        return None
    return c["finish_iters"] / c["finish_entered"]

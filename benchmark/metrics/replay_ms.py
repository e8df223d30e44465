"""Step graph layer (``core/graph.StepGraph``): mean device ms of one
call of the captured step (its inputs copied in, then the replay),
between CUDA events around ``StepGraph.__call__``, over the window's
scans outside the profiled stretch."""


def read(tr):
    ev = tr["replay_ms"]
    return sum(ev) / len(ev) if ev else None

"""Loops on the device (``kernels/graph_flow``, ``csrc/graph_flow.cu``):
runs of the condition kernel per scan, one per conditional node entered
and one more per WHILE iteration, as the device counts them."""


def read(tr):
    return tr["flow_runs"] / tr["scans"] if tr["scans"] else None

"""Host API layer (``Tracker.add_measurement_list``): host reads of
device values per scan of the window (``pymht_tpu_torch.sync.count``),
each of which drains the card's queue."""


def read(tr):
    return tr["host_reads"] / tr["scans"] if tr["scans"] else None

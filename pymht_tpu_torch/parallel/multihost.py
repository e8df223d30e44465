"""Multi-process runtime on ``torch.distributed`` (counterpart of
pymht_tpu/parallel/multihost.py).

* ``initialize``  — process bootstrap: one rank per device, the rendezvous
  at a TCP address.  The backend is NCCL for a CUDA device unless the
  caller names another (gloo, e.g. for two ranks sharing one card, or for
  CPU ranks); nothing falls back to another backend or to the CPU.
* ``hybrid_mesh`` — a ``DeviceMesh`` with ('scenario', 'cluster')
  dimensions, process-major: consecutive ranks (the devices of one host)
  form a 'cluster' group, so the selection collectives, made every
  Lagrangian iteration, stay on a host's fast links, and independent
  scenarios, which need no traffic, span the hosts.
* ``gather_local_measurements`` — the measurement exchange: every rank
  ingests its own radar feed and every target shard gates against the
  union, a fixed-width all-gather of the padded buffers.
* ``replicate_to_global`` — a tree of host-identical arrays on each
  rank's device.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.tracker import _resolve_device
from .collectives import Axis


def _env_int(*names) -> Optional[int]:
    for n in names:
        if n in os.environ:
            return int(os.environ[n])
    return None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device=None, backend: Optional[str] = None,
               timeout: float = 600.0) -> bool:
    """Join a multi-process run: ``init_process_group`` at
    ``tcp://<coordinator_address>`` (host:port) with ``num_processes``
    ranks, this one ``process_id``.

    The arguments fall back to ``PYMHT_COORDINATOR`` / ``PYMHT_NUM_PROCS``
    / ``PYMHT_PROC_ID``, then to torchrun's ``MASTER_ADDR:MASTER_PORT`` /
    ``WORLD_SIZE`` / ``RANK``.  ``device`` None means this rank's GPU,
    ``cuda:{LOCAL_RANK % device_count}`` (LOCAL_RANK defaulting to the
    rank), made the current device; it raises without CUDA.  ``backend``
    None means NCCL, which needs a CUDA device; a CPU rank names gloo.
    ``timeout`` (seconds) bounds the rendezvous and every collective, so
    ranks that diverge fail instead of hanging.

    Returns True if a multi-process group was initialised, False for a
    single process (nothing to do; callers share one code path)."""
    coordinator_address = coordinator_address or os.environ.get(
        "PYMHT_COORDINATOR")
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("PYMHT_NUM_PROCS", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("PYMHT_PROC_ID", "RANK")
    if num_processes is None or num_processes <= 1:
        return False
    if coordinator_address is None or process_id is None:
        raise ValueError("initialize: a multi-process run needs the "
                         "coordinator address and this process's id")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("initialize: no CUDA device is available and "
                               "none was named; name device='cpu' and "
                               "backend='gloo' for CPU ranks")
        local = _env_int("LOCAL_RANK")
        local = process_id if local is None else local
        device = torch.device("cuda", local % torch.cuda.device_count())
    device = torch.device(device)
    backend = backend or "nccl"
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("initialize: NCCL needs a CUDA device; name "
                         "backend='gloo' for CPU ranks")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout))
    return True


def hybrid_mesh(scenario: Optional[int] = None,
                cluster: Optional[int] = None, device_type: str = "cuda"):
    """('scenario', 'cluster') ``DeviceMesh`` over the initialised ranks,
    process-major (rank r sits at (r // cluster, r % cluster)).
    Defaults: ``cluster`` = ranks per host (``LOCAL_WORLD_SIZE``, else 1),
    ``scenario`` = the rest.  The groups of its dimensions use the
    default group's backend."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if cluster is None:
        cluster = (world // scenario if scenario is not None
                   else _env_int("LOCAL_WORLD_SIZE") or 1)
    if scenario is None:
        scenario = world // cluster
    if scenario * cluster != world:
        raise ValueError(f"hybrid_mesh: {scenario} x {cluster} is not the "
                         f"{world} ranks")
    return init_device_mesh(device_type, (scenario, cluster),
                            mesh_dim_names=("scenario", "cluster"))


def gather_local_measurements(z_local: np.ndarray, mask_local: np.ndarray,
                              max_meas: int, axis: Optional[Axis] = None,
                              device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Every rank's padded radar returns in one global scan.

    ``z_local [M_l, 2]`` / ``mask_local [M_l]`` are this rank's padded
    measurements (the same M_l on every rank); the result is the same
    ``[max_meas, 2]`` / ``[max_meas]`` on every rank of ``axis`` (None:
    all ranks, or this process alone if none was initialised), valid
    entries packed first in rank order.  Overflow beyond ``max_meas`` is
    dropped deterministically, the lowest ranks' entries kept first (the
    padding contract of Tracker._pad_scan).  The buffers travel on
    ``device`` (None: the GPU, which NCCL needs)."""
    z_local = np.asarray(z_local, np.float32).reshape(-1, 2)
    mask_local = np.asarray(mask_local, bool).reshape(-1)
    if axis is None and dist.is_initialized():
        axis = Axis()
    if axis is not None and axis.size > 1:
        dev = _resolve_device(device, "gather_local_measurements")
        z_all = axis.all_gather(torch.from_numpy(z_local).to(dev))
        m_all = axis.all_gather(torch.from_numpy(mask_local).to(dev))
        z_local, mask_local = z_all.cpu().numpy(), m_all.cpu().numpy()
    z_valid = z_local[mask_local]
    n = min(len(z_valid), max_meas)
    z = np.zeros((max_meas, 2), np.float32)
    z[:n] = z_valid[:n]
    mask = np.zeros((max_meas,), bool)
    mask[:n] = True
    return z, mask


def replicate_to_global(tree, device=None):
    """A tree (tuples, NamedTuples, the state dataclasses) of
    host-identical arrays as tensors on this rank's ``device`` (None: the
    GPU).  Every rank must pass the same values: same seed, same
    configuration."""
    dev = _resolve_device(device, "replicate_to_global")

    def put(x):
        if isinstance(x, (np.ndarray, torch.Tensor)):
            return torch.as_tensor(x, device=dev)
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(
                x, **{f.name: put(getattr(x, f.name))
                      for f in dataclasses.fields(x)})
        if isinstance(x, tuple):
            items = [put(v) for v in x]
            return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
        return x

    return put(tree)

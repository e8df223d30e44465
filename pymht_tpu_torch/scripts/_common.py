"""What the port's scripts share: the device argument, the hardware they
report, timing closed by a device synchronise, one-to-one quality against
truth, and ranks of a process group on one host."""
from __future__ import annotations

import argparse
import datetime
import os
import socket
import subprocess
import tempfile
import time

import numpy as np
import torch

from ..core.tracker import _resolve_device

GATE_M = 20.0     # one-to-one matching gate of the quality scores


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "kernels' plain twins)")
    return ap


def device_of(name, who: str) -> torch.device:
    """The script's device: the GPU unless named (with its index, which
    ``torch.cuda.set_device`` needs); raises without one."""
    device = _resolve_device(name, who)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def synchronize(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def hardware(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them, or the
    CPU's thread count."""
    if device.type != "cuda":
        return f"cpu ({torch.get_num_threads()} threads), plain twins"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i",
                          str(device.index or 0)],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip()


def timed(fn, device: torch.device, reps: int = 3):
    """(wall seconds of each of ``reps`` calls after one warm-up, each
    closed by a device synchronise; the last result)."""
    out = fn()
    synchronize(device)
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        synchronize(device)
        walls.append(time.perf_counter() - t0)
    return walls, out


def one_to_one(track_x, track_ok, truth, gate: float = GATE_M):
    """Per scan, a one-to-one Hungarian match of truth to selected tracks
    inside ``gate`` (bench_swarm.py's score: nearest-track matching lets
    one track cover several truths of a dense swarm).  ``track_x [S, T,
    4]``, ``track_ok [S, T]``, ``truth [S, K, 4]`` (numpy).  Returns
    (coverage, rms of the matched distances)."""
    from scipy.optimize import linear_sum_assignment
    matched, sq = 0, []
    for i in range(min(len(track_x), truth.shape[0])):
        tp = track_x[i][track_ok[i]][:, :2]
        if not len(tp):
            continue
        d = np.linalg.norm(truth[i][:, None, :2] - tp[None], axis=2)
        # ungated pairs all cost the gate: the assignment never prefers
        # them to a gated pair, and they are discarded below
        ri, ci = linear_sum_assignment(np.minimum(d, gate))
        dm = d[ri, ci]
        hit = dm < gate
        matched += int(hit.sum())
        sq.extend((dm[hit] ** 2).tolist())
    coverage = matched / float(truth.shape[0] * truth.shape[1])
    rms = float(np.sqrt(np.mean(sq))) if sq else float("nan")
    return coverage, rms


def truth_of(sim_list, n_scans: int) -> np.ndarray:
    """[S, K, 4] truth states of the first ``n_scans`` samples."""
    return np.array([[t.cartesian_state() for t in sample]
                     for sample in sim_list[:n_scans]])


# ----------------------------------------------------------------------
# Ranks on one host
# ----------------------------------------------------------------------

RANK_TIMEOUT_S = 300     # bounds the rendezvous and every collective


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_rank(backend: str, rank: int, world: int, port: int,
              timeout: float = RANK_TIMEOUT_S):
    """Join the process group of ``world`` ranks on this host's ``port``;
    ``timeout`` (seconds) bounds the rendezvous and every collective."""
    import torch.distributed as dist
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))


def _rank_main(rank, fn, world, port, backend, device, out_dir, args):
    import json

    import torch.distributed as dist
    if device.type == "cpu":
        # one intra-op thread per rank: ranks share the host's cores
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(device)
    init_rank(backend, rank, world, port)
    try:
        result = fn(rank, world, device, *args)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(out_dir, "result.json"), "w") as fh:
            json.dump(result, fh)


def run_ranks(fn, world: int, device: torch.device, *args):
    """``fn(rank, world, device, *args)`` on ``world`` ranks of one
    process group and rank 0's (JSON-able) result.  One rank on a GPU
    runs in this process over NCCL; otherwise every rank is a spawned
    process, over gloo (CPU ranks, or ranks sharing one card, which NCCL
    refuses).  ``fn`` must be importable (a module-level function)."""
    import json

    import torch.distributed as dist
    if world == 1 and device.type == "cuda":
        torch.cuda.set_device(device)
        init_rank("nccl", 0, 1, free_port())
        try:
            return fn(0, 1, device, *args)
        finally:
            dist.destroy_process_group()
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as out_dir:
        mp.start_processes(_rank_main, args=(fn, world, free_port(), "gloo",
                                             device, out_dir, args),
                           nprocs=world, join=True, start_method="spawn")
        with open(os.path.join(out_dir, "result.json")) as fh:
            return json.load(fh)

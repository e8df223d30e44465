"""The benchmark's traffic: a continuous radar stream, with AIS messages,
drawn from a seed in deterministic blocks.

The model is that of the port's simulator (``utils/simulator.py``, after
the reference pyMHT's ``simulator.py:18-199``), vectorised over targets:

* targets move at constant velocity with process noise Q(dt) * sigma_Q,
  start at a bearing uniform on [0, 360) and a distance uniform on
  [0, ``spawn_radius``], on a uniform course at a speed from pyMHT's set;
* a target is detected with probability ``P_d``, at its position plus
  N(0, sigma_R^2 I); each detection brings Poisson(``lambda_local``)
  local returns at N(0, (3 sigma_R)^2 I) around the target, and each scan
  Poisson(``lambda_phi`` pi R^2) global returns uniform over the radar
  disc; a scan's returns are shuffled;
* with ``ais``, every target carries a unique MMSI and reports its state
  at the speed-dependent interval of its transponder class, with noise of
  sigma 1 (high accuracy, probability ``p_high``) or 3, received with
  probability ``P_r``; the messages between two scans go with the later.

Unlike the simulator's fixed clip, the stream never ends and its
population stays at ``n_targets``: a target that leaves the spawn disc
is replaced at once by a new one drawn as at the start (with a new
MMSI).  Block ``b`` of ``block_scans`` scans is drawn from a generator
keyed by (seed, b) and from the targets as block ``b - 1`` left them, so
the traffic depends on the seed alone, never on how fast it is consumed.
This module imports nothing of the system under test.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

KNOT = 0.514444
SPEEDS = np.array([1, 10, 12, 15, 28, 35], np.float64) * 0.5   # m/s


class AisMessage:
    """One transponder report, with the attributes ``Tracker`` reads."""
    __slots__ = ("time", "state", "mmsi", "highAccuracy")

    def __init__(self, time, state, mmsi, high):
        self.time, self.state = time, state
        self.mmsi, self.highAccuracy = mmsi, high


class Block(NamedTuple):
    """``n`` consecutive scans: ``times[i]`` (s), ``z[i]`` [n_i, 2] f32,
    ``ais[i]`` a list of AisMessage (empty without AIS), ``births[i]``
    targets replaced after scan i."""
    times: np.ndarray
    z: list
    ais: list
    births: np.ndarray


def key(seed: int, *parts: int) -> np.random.Generator:
    """A generator keyed by the run's seed (any whole number) and parts."""
    return np.random.default_rng([seed % (1 << 64), *parts])


def phi(dt) -> np.ndarray:
    """Constant-velocity transition [..., 4, 4] for time steps ``dt``."""
    dt = np.asarray(dt, np.float64)
    F = np.broadcast_to(np.eye(4), dt.shape + (4, 4)).copy()
    F[..., 0, 2] = F[..., 1, 3] = dt
    return F


def q_matrix(dt: float, sigma: float) -> np.ndarray:
    """The simulator's process noise (its T^3/3 off-diagonal kept)."""
    T2, T3, T4 = dt * dt, dt ** 3 / 3.0, dt ** 4 / 4.0
    return np.array([[T4, 0, T3, 0], [0, T4, 0, T3],
                     [T3, 0, T2, 0], [0, T3, 0, T2]], np.float64) * sigma


def report_interval(speed, ais_class: str) -> np.ndarray:
    """AIS reporting interval (s) by speed, the simulator's table."""
    kn = np.asarray(speed) / KNOT
    if ais_class == "A":
        return np.select([kn > 23, kn > 14, kn > 0], [2.0, 4.0, 6.0], 60.0)
    if ais_class == "B":
        return np.select([kn > 23, kn > 14, kn > 2], [10.0, 5.0, 30.0],
                         180.0)
    raise ValueError(f"unknown AIS class {ais_class!r}")


class Stream:
    """The stream of one run.  ``traffic``: the mix's parameters (a
    ``benchmark/traffic/*.json`` file); ``radar``: ``period``, ``range``
    of the configuration.  ``initial`` holds the targets' states and MMSIs
    at time 0, the first scan is at ``period``; ``block(b)`` must be
    asked for in order 0, 1, 2, ..."""

    def __init__(self, traffic: dict, radar: dict, seed: int):
        self.tr, self.seed = traffic, seed
        self.period = float(radar["period"])
        self.range = float(radar["range"])
        self.ais_on = traffic.get("ais") is not None
        self._chol = np.linalg.cholesky(
            q_matrix(self.period, traffic["sigma_Q"]) + 1e-12 * np.eye(4))
        rng = key(seed, 0)
        n = int(traffic["n_targets"])
        self.x = self._spawn(rng, n)
        self._used = set()
        self.mmsi = self._new_mmsi(rng, n)
        self.next_report = np.zeros(n)
        if self.ais_on:
            interval = self._interval(self.x)
            self.next_report = rng.uniform(0.0, 1.0, n) * interval
        self.t = 0.0
        self.initial = (self.x.copy(), self.mmsi.copy())
        self._next_block = 0

    # -- targets ------------------------------------------------------
    def _spawn(self, rng, n) -> np.ndarray:
        bearing = np.radians(90.0 - rng.uniform(0.0, 360.0, n))
        dist = rng.uniform(0.0, self.tr["spawn_radius"], n)
        course = np.radians(90.0 - rng.uniform(0.0, 360.0, n))
        speed = rng.choice(SPEEDS, n)
        return np.stack([dist * np.cos(bearing), dist * np.sin(bearing),
                         speed * np.cos(course), speed * np.sin(course)], 1)

    def _new_mmsi(self, rng, n) -> np.ndarray:
        out = np.zeros(n, np.int64)
        if not self.ais_on:
            return out
        for i in range(n):
            while True:
                m = int(rng.integers(100_000_000, 999_999_999))
                if m not in self._used:
                    self._used.add(m)
                    out[i] = m
                    break
        return out

    def _interval(self, x) -> np.ndarray:
        return report_interval(np.hypot(x[:, 2], x[:, 3]),
                               self.tr["ais"]["class"])

    # -- one scan -----------------------------------------------------
    def _scan(self, rng, t_prev, t):
        tr, x = self.tr, self.x
        n = len(x)
        # AIS reports due in (t_prev, t], from the truth at t_prev
        msgs = []
        if self.ais_on:
            a = tr["ais"]
            interval = self._interval(x)
            k = np.maximum(0, np.floor((t - self.next_report) / interval)
                           + 1).astype(np.int64)
            k = np.where(self.next_report <= t, k, 0)
            who = np.repeat(np.arange(n), k)
            nth = np.concatenate([np.arange(c) for c in k]) if k.sum() \
                else np.zeros(0, np.int64)
            times = self.next_report[who] + nth * interval[who]
            self.next_report = self.next_report + k * interval
            order = np.argsort(times, kind="stable")
            who, times = who[order], times[order]
            state = np.einsum("nij,nj->ni", phi(times - t_prev), x[who])
            high = rng.uniform(0.0, 1.0, len(who)) < a["p_high"]
            sigma = np.where(high, a["sigma_hi"], a["sigma_lo"])
            state = state + rng.normal(0.0, 1.0, (len(who), 4)) \
                * sigma[:, None]
            got = rng.uniform(0.0, 1.0, len(who)) < a["P_r"]
            msgs = [AisMessage(float(tm), s, int(m), bool(h))
                    for tm, s, m, h, g in zip(times, state, self.mmsi[who],
                                              high, got) if g]
        # truth to time t
        x = x @ phi(t - t_prev).T \
            + rng.normal(0.0, 1.0, (n, 4)) @ self._chol.T
        # detections and clutter
        det = rng.uniform(0.0, 1.0, n) < tr["P_d"]
        det &= np.hypot(x[:, 0], x[:, 1]) <= self.range
        sr = tr["sigma_R"]
        zd = x[det, :2] + rng.normal(0.0, sr, (int(det.sum()), 2))
        n_loc = rng.poisson(tr["lambda_local"], int(det.sum()))
        zl = (np.repeat(x[det, :2], n_loc, axis=0)
              + rng.normal(0.0, 3.0 * sr, (int(n_loc.sum()), 2)))
        n_glob = rng.poisson(tr["lambda_phi"] * math.pi * self.range ** 2)
        r = self.range * np.sqrt(rng.uniform(0.0, 1.0, n_glob))
        ang = rng.uniform(0.0, 2.0 * math.pi, n_glob)
        zg = np.stack([r * np.cos(ang), r * np.sin(ang)], 1)
        z = np.concatenate([zd, zl, zg])
        z = z[rng.permutation(len(z))].astype(np.float32)
        # leavers are replaced by new targets
        out = np.hypot(x[:, 0], x[:, 1]) > tr["spawn_radius"]
        n_out = int(out.sum())
        if n_out:
            x[out] = self._spawn(rng, n_out)
            if self.ais_on:
                for m in self.mmsi[out]:
                    self._used.discard(int(m))
                self.mmsi[out] = self._new_mmsi(rng, n_out)
                self.next_report[out] = t + rng.uniform(0.0, 1.0, n_out) \
                    * self._interval(x[out])
        self.x = x
        return z, msgs, n_out

    def block(self, b: int) -> Block:
        """Scans ``b * block_scans`` to ``(b + 1) * block_scans - 1``."""
        if b != self._next_block:
            raise ValueError(f"Stream.block: asked for block {b}, the "
                             f"next is {self._next_block}")
        self._next_block += 1
        rng = key(self.seed, 1, b)
        n = int(self.tr["block_scans"])
        times, zs, groups, births = np.zeros(n), [], [], np.zeros(n, int)
        for i in range(n):
            t_prev, t = self.t, self.t + self.period
            z, msgs, births[i] = self._scan(rng, t_prev, t)
            self.t = t
            times[i] = t
            zs.append(z)
            groups.append(msgs)
        return Block(times, zs, groups, births)

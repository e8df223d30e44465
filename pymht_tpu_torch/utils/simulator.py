"""Seeded Monte-Carlo radar + AIS scenario generator.

Behavioural mirror of the reference simulator
(the reference pyMHT's pymht/utils/simulator.py): uniform-in-disc initial
targets with a discrete speed set, CV truth propagation with process
noise, P_d-thinned noisy position measurements with local (per-target,
3-sigma) and global (uniform-in-disc) Poisson clutter, shuffled float32
scans, and class-A/B AIS reporting with reception probability, accuracy
flag and optional MMSI scrambling.

Uses numpy's Generator API (explicitly seeded) — scenario generation is
host-side workload creation, not the device compute path.  This is the
port's own copy of pymht_tpu/utils/simulator.py: the same seed gives
bit-identical targets and scans.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np

KNOT = 0.514444


@dataclasses.dataclass
class SimTarget:
    """Cartesian constant-velocity ground-truth target
    (reference SimTargetCartesian, classDefinitions.py:86-150)."""
    state: np.ndarray          # [4] float64
    time: float
    P_d: float
    sigma_Q: float
    mmsi: Optional[int] = None
    ais_class: str = 'B'
    time_of_last_ais: float = -math.inf
    P_r: float = 1.0

    def in_range(self, p0, r):
        return np.linalg.norm(self.state[:2] - np.asarray(p0)) <= r

    def speed_ms(self):
        return float(np.linalg.norm(self.state[2:4]))

    def cartesian_state(self):
        return self.state


@dataclasses.dataclass
class SimTargetPolar(SimTarget):
    """Polar ground-truth target: state = [east, north, heading_deg,
    speed]; heading/speed random walk (reference SimTargetPolar,
    classDefinitions.py:153-238)."""
    heading_change_mean: float = 0.0
    sigma_hdg: float = 3.0
    sigma_speed: float = 0.8

    def cartesian_velocity(self):
        theta = math.radians((90.0 - self.state[2] + 360.0) % 360.0)
        return np.array([self.state[3] * math.cos(theta),
                         self.state[3] * math.sin(theta)])

    def cartesian_state(self):
        return np.concatenate([self.state[:2], self.cartesian_velocity()])

    def speed_ms(self):
        return float(self.state[3])

    def step(self, rng, dt):
        nxt = self.state.copy()
        nxt[:2] += dt * self.cartesian_velocity()
        nxt[2] = (nxt[2] + dt * rng.normal(self.heading_change_mean,
                                           self.sigma_hdg) + 360.0) % 360.0
        nxt[3] = max(0.0, nxt[3] + dt * rng.normal(0.0, self.sigma_speed))
        return dataclasses.replace(self, state=nxt, time=self.time + dt)


@dataclasses.dataclass
class MeasurementList:
    time: float
    measurements: np.ndarray   # [n, 2] float32


@dataclasses.dataclass
class AisMessage:
    time: float
    state: np.ndarray          # [4]
    mmsi: int
    highAccuracy: bool = False


def _phi(T):
    return np.array([[1, 0, T, 0], [0, 1, 0, T],
                     [0, 0, 1, 0], [0, 0, 0, 1]], dtype=np.float64)


def _q(T, sigma):
    T2, T3, T4 = T * T, T ** 3 / 3.0, T ** 4 / 4.0
    return np.array([[T4, 0, T3, 0], [0, T4, 0, T3],
                     [T3, 0, T2, 0], [0, T3, 0, T2]], np.float64) * sigma


def _pol2cart(bearing_deg, dist):
    ang = math.radians((90.0 - bearing_deg + 360.0) % 360.0)
    return dist * math.cos(ang), dist * math.sin(ang)


def generate_initial_targets(rng, n_targets, center, radar_range, P_d,
                             sigma_Q, assign_mmsi=False, time0=0.0,
                             P_r=1.0):
    """Uniform-in-0.8R disc positions, discrete ~knots speed set
    (reference simulator.py:18-43)."""
    speeds = np.array([1, 10, 12, 15, 28, 35], np.float64) * 0.5
    used = set()
    out = []
    for _ in range(n_targets):
        px, py = _pol2cart(rng.uniform(0, 360), rng.uniform(0, radar_range * 0.8))
        vx, vy = _pol2cart(rng.uniform(0, 360), rng.choice(speeds))
        mmsi = None
        if assign_mmsi:
            while True:
                mmsi = int(rng.integers(100000000, 999999999))
                if mmsi not in used:
                    used.add(mmsi)
                    break
        out.append(SimTarget(
            state=np.array([px + center[0], py + center[1], vx, vy]),
            time=time0, P_d=P_d, sigma_Q=sigma_Q, mmsi=mmsi, P_r=P_r))
    return out


def simulate_targets(rng, initial, sim_time, dt):
    """Propagate truth with per-step process noise
    (reference simulator.py:45-56).  Handles Cartesian (CV + process
    noise) and polar (heading/speed random walk) targets."""
    sim_list = [initial]
    steps = int(math.ceil(sim_time / dt))
    F = _phi(dt)
    for _ in range(steps):
        nxt = []
        for tgt in sim_list[-1]:
            if isinstance(tgt, SimTargetPolar):
                nxt.append(tgt.step(rng, dt))
            else:
                Q = _q(dt, tgt.sigma_Q)
                w = rng.multivariate_normal(np.zeros(4), Q)
                nxt.append(dataclasses.replace(
                    tgt, state=F @ tgt.state + w, time=tgt.time + dt))
        sim_list.append(nxt)
    return sim_list


def simulate_scans(rng, sim_list, radar_period, sigma_R, lambda_phi,
                   radar_range=None, p0=None, P_d=None,
                   local_clutter=True, global_clutter=True,
                   lambda_local=1.0, shuffle=True,
                   include_initial_time=True):
    """P_d thinning + noise + local/global Poisson clutter
    (reference simulator.py:58-110)."""
    area = math.pi * radar_range ** 2 if radar_range else 0.0
    g_rate = lambda_phi * area
    scans = []
    last = None
    skipped_first = False
    for targets in sim_list:
        t = targets[0].time
        if last is None:
            if not include_initial_time and not skipped_first:
                skipped_first = True
                last = t
                continue
            last = t
        else:
            if t - last >= radar_period:
                last = t
            else:
                continue
        meas = []
        for tgt in targets:
            visible = rng.uniform() <= (P_d if P_d is not None else tgt.P_d)
            in_range = (tgt.in_range(p0, radar_range)
                        if radar_range is not None and p0 is not None else True)
            if visible and in_range:
                meas.append(tgt.state[:2] + rng.multivariate_normal(
                    np.zeros(2), np.eye(2) * sigma_R ** 2))
                if local_clutter:
                    for _ in range(rng.poisson(lambda_local)):
                        meas.append(tgt.state[:2] + rng.multivariate_normal(
                            np.zeros(2), np.eye(2) * (3 * sigma_R) ** 2))
        if radar_range is not None and p0 is not None and global_clutter:
            for _ in range(rng.poisson(g_rate)):
                while True:
                    xy = rng.uniform(-radar_range, radar_range, 2)
                    if np.linalg.norm(xy) <= radar_range:
                        break
                meas.append(np.asarray(p0) + xy)
        if shuffle and meas:
            order = rng.permutation(len(meas))
            meas = [meas[i] for i in order]
        scans.append(MeasurementList(
            time=t,
            measurements=np.asarray(meas, np.float32).reshape(len(meas), 2)))
    return scans


def _ais_report_interval(speed_ms, ais_class):
    """Class A/B reporting intervals (reference simulator.py:175-199)."""
    kn = speed_ms / KNOT
    if ais_class.upper() == 'A':
        if kn > 23:
            return 2
        if kn > 14:
            return 4
        if kn > 0:
            return 6
        return 60
    if ais_class.upper() == 'B':
        if kn > 23:
            return 10
        if kn > 14:
            return 5
        if kn > 2:
            return 30
        return 60 * 3
    raise ValueError("aisClass must be 'A' or 'B'")


def simulate_ais(rng, sim_list, radar_period, init_time,
                 noise=True, id_scrambling=False, integer_time=True,
                 sigma_hi=1.0, sigma_lo=3.0):
    """AIS message stream grouped per radar period
    (reference simulator.py:112-173).  Returns a list of lists of
    AisMessage, one group per radar period boundary."""
    groups = []
    temp = []
    for i, sim in enumerate(sim_list[1:]):
        for j, tgt in enumerate(sim):
            if tgt.mmsi is None:
                continue
            if integer_time:
                msg_time = math.floor(tgt.time)
                dT = msg_time - tgt.time
                state = _phi(dT) @ tgt.state
            else:
                msg_time = tgt.time
                state = tgt.state.copy()
            interval = _ais_report_interval(tgt.speed_ms(), tgt.ais_class)
            should_send = ((msg_time - tgt.time_of_last_ais >= interval)
                           and ((msg_time - init_time) % radar_period != 0))
            if not should_send:
                if i + 2 < len(sim_list):
                    sim_list[i + 2][j].time_of_last_ais = tgt.time_of_last_ais
                continue
            if i + 2 < len(sim_list):
                sim_list[i + 2][j].time_of_last_ais = float(msg_time)
            high = True
            if noise:
                high = rng.uniform() > 0.5
                sigma = sigma_hi if high else sigma_lo
                state = state + rng.multivariate_normal(
                    np.zeros(4), np.eye(4) * sigma ** 2)
            mmsi = tgt.mmsi + 10 if (id_scrambling and rng.uniform() > 0.5) \
                else tgt.mmsi
            if rng.uniform() <= tgt.P_r:
                temp.append(AisMessage(time=float(msg_time),
                                       state=state.astype(np.float64),
                                       mmsi=int(mmsi), highAccuracy=bool(high)))
        sim_time = sim[0].time
        if (sim_time - init_time) % radar_period == 0:
            if temp:
                groups.append(temp[:])
                temp = []
    return groups


def find_center_and_range(sim_list):
    """Bounding-circle of the scenario (reference simulator.py:201-216)."""
    states = np.array([t.state for sim in sim_list for t in sim])
    mn, mx = states[:, :2].min(0), states[:, :2].max(0)
    p0 = (mn + mx) / 2
    r = float(np.linalg.norm(np.maximum(np.abs(mx - p0), np.abs(mn - p0))))
    return p0, r

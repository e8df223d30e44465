"""Static tracker configuration (the port's own copy of
pymht_tpu/core/config.py: same names, defaults and derived properties,
numpy only, and one parameter of the port's own, ``selection_gap``).

Two kinds of parameters:

* ``TrackerShapes`` — static padding capacities of the fixed-shape
  step (max targets, leaves per target, measurements per scan, AIS
  messages, association-window depth).  Everything data-dependent in the
  reference (number of leaves, gated measurements, cluster sizes, ILP
  dimensions) becomes a masked, padded axis here.
* ``TrackerParams`` — numeric parameters mirroring the reference Tracker
  kwargs (the reference pyMHT's pymht/tracker.py:41-127): P_d, gate sizes
  eta2/eta2_ais, clutter densities, window length N, score limits,
  initiator m/n settings.
"""
from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class TrackerShapes:
    max_targets: int = 32        # T: padded target axis
    max_leaves: int = 64         # L: hypothesis beam width per target
    max_meas: int = 64           # M: padded radar measurements per scan
    max_ais: int = 8             # A: padded AIS messages per scan
    window: int = 7              # W: history columns (>= N_max + 1)
    # m/n initiator capacities
    max_prelim: int = 32         # P: preliminary tracks
    max_initiators: int = 64     # I: one-point initiators
    # G: AIS fusion candidates kept per leaf after the stage-1 AIS gate
    # (0 = exhaustive, i.e. G = max_ais).  The stage-1 gate + MMSI
    # consistency typically admit <= 1-2 messages per leaf, so a small G
    # shrinks the stage-2 fusion tensors from [T,L,A,M,...] to
    # [T,L,G,M,...] without changing decisions in practice (reference
    # fuses every stage-1-gated message, tracker.py:417-552; G < A is a
    # score beam on that set).
    ais_per_leaf: int = 0
    # Gp: stage-1 prefilter width (0 = exact full-A sweep).  When
    # 0 < Gp < A the expensive 4x4 stage-1 NIS runs on only the Gp best
    # messages per leaf under a provable NIS lower bound
    # (|z|^2/trace(S)); exclusion by the bound is lossless, the top-Gp
    # truncation is a score beam like ais_per_leaf.  Worth ~5x on the
    # stage-1 sweep at swarm shapes (A=128); pointless for small A.
    ais_prefilter_width: int = 0
    # Km: per-target compressed radar-measurement axis in grow
    # (0 = off, full M).  When 0 < Km < M, each target's candidate
    # planes run over only its Km NEAREST measurements (one exact top-k by
    # distance to the selected leaf's prediction, gathered ONCE at the
    # input side — not mid-chain), shrinking every [T,L,M]/[T,L,G,M]
    # plane and the beam top_k by M/Km.  A score-beam approximation of
    # the same class as ais_per_leaf: exact whenever every gated
    # measurement of a target is among its Km nearest (true in practice
    # — the chi2 gate radius is metres, Km-th-nearest distances are
    # hundreds of metres at swarm densities).  Targets the O(T*M) grow
    # wall past the 2048-target saturation knee.
    radar_cand_width: int = 0

    def __post_init__(self):
        assert self.window >= 2
        assert self.max_leaves >= 2
        assert 0 <= self.ais_per_leaf <= self.max_ais
        assert 0 <= self.ais_prefilter_width <= self.max_ais
        assert 0 <= self.radar_cand_width <= self.max_meas

    @property
    def ais_fuse_width(self):
        """Effective G: compressed AIS axis width in grow."""
        return self.ais_per_leaf or self.max_ais


@dataclass(frozen=True)
class TrackerParams:
    radar_period: float = 2.5
    P_d: float = 0.8                      # tracker.py:50
    lambda_phi: float = 4e-6              # false-alarm density
    lambda_nu: float = 1e-4               # new-target density
    eta2: float = 5.99                    # radar gate, chi2_2 95%
    eta2_ais: float = 9.45                # AIS gate (tracker.py:111)
    N: int = 5                            # N-scan window (tracker.py:112)
    # Track termination (tracker.py:115-116, 891-916)
    score_upper_limit_scale: float = 0.8  # scoreUpperLimit = -ln(1-P_d)*scale
    cnllr_upper_limit: float = 3.0
    # Similar-state merge threshold (tracker.py:117)
    prune_threshold: float = 4.0
    # Radar geometry
    position: tuple = (0.0, 0.0)
    radar_range: float = float('inf')
    # Initiator (tracker.py:62-65, m_of_n.py:216-228)
    max_speed: float = 20.0
    M_required: int = 2
    N_checks: int = 3
    gate_probability: float = 0.99        # m_of_n.py:13-16
    # AIS association priors (tracker.py:108-109)
    P_r: float = 0.95
    P_ais: float = 0.5
    # Per-target growth time budget driving the dynamic window
    # (tracker.py:47-48, 918-928: maxTargetGrowTime = 200 ms)
    max_target_time: float = 0.2
    # The relative optimality gap that the 'lagrangian' selection
    # certifies, obj - bound <= selection_gap * max(1, |obj|), through its
    # exact finish (the north star's 0.1 %, BASELINE.md).  The JAX
    # package's selection certifies none.
    selection_gap: float = 1e-3

    @property
    def lambda_ex(self):
        return self.lambda_phi + self.lambda_nu

    @property
    def score_upper_limit(self):
        return -np.log(1.0 - self.P_d) * self.score_upper_limit_scale

    @property
    def merge_threshold(self):
        # 4 * sigmaR^2 neighbourhood for duplicate initial targets
        # (tracker.py:65)
        from ..models.constants import sigmaR_RADAR_tracker
        return 4.0 * sigmaR_RADAR_tracker ** 2

    @property
    def gamma_initiator(self):
        # chi2(df=2).ppf(gate_probability) without a scipy dependency at
        # runtime: for df=2 the chi-square ppf is -2 ln(1-p).
        return float(-2.0 * np.log(1.0 - self.gate_probability))

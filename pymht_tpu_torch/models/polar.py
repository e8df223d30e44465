"""Polar ground-truth simulation model (the port's own copy of
pymht_tpu/models/polar.py): the radar observation and CV transition of
the PV model, plus the heading/speed random-walk noise of the polar
simulator targets."""
from .constants import default_dtype, sigmaR_RADAR_tracker  # noqa: F401
from .pv import C_RADAR, P0, Phi, R_RADAR  # noqa: F401

H_radar = C_RADAR

sigma_hdg = 3.0    # deg/s heading random-walk std-dev
sigma_speed = 0.8  # m/s^2 speed random-walk std-dev

"""Model constants, as plain Python floats (counterpart of
pymht_tpu/models/constants.py, which needs no array library)."""
import torch

default_dtype = torch.float32

N_OBS_AIS = 4        # AIS observes the full state

sigmaR_RADAR_tracker = 2.5   # measurement std-dev assumed by the tracker
sigmaQ_tracker = 1.0         # process noise scale assumed by the tracker

# 4 * sigmaR^2 neighbourhood for duplicate initial targets; the port's
# value of TrackerParams.merge_threshold (which would import the JAX
# constants module).
merge_threshold = 4.0 * sigmaR_RADAR_tracker ** 2

"""Model constants, as plain Python floats (counterpart of
pymht_tpu/models/constants.py, which needs no array library)."""
import torch

default_dtype = torch.float32

N_OBS_AIS = 4        # AIS observes the full state

sigmaR_RADAR_tracker = 2.5   # measurement std-dev assumed by the tracker
sigmaQ_tracker = 1.0         # process noise scale assumed by the tracker

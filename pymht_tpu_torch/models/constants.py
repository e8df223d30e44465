"""Model constants, as plain Python floats (counterpart of
pymht_tpu/models/constants.py, which needs no array library)."""
import torch

default_dtype = torch.float32

N_STATE = 4          # [east, north, v_east, v_north]
N_OBS_RADAR = 2      # radar observes position only
N_OBS_AIS = 4        # AIS observes the full state

sigmaR_RADAR_tracker = 2.5   # measurement std-dev assumed by the tracker
sigmaR_RADAR_true = 2.5      # measurement std-dev used by the simulator
sigmaQ_tracker = 1.0         # process noise scale assumed by the tracker
sigmaQ_true = 1.0            # process noise scale used by the simulator

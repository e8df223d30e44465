"""The JAX package's objectives for the A/B of the distributed selections
on the small instance that tests/test_torch_scripts_ranks.py gives the
port's ``scripts/ab_distributed_select``.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/jax_ab_reference.py

tools/ab_distributed_select.py's instance builder and selections ('full',
and 'compact' with the fast path off at CAP=512) under the production
exits (60 iterations), on 2 virtual CPU devices, at T=64 slots with 60
targets, L=8, M=64, A=32, W=6.  On an instance this small the full-slot
selection stops at its iteration cap before it converges, so the two
objectives differ (on the tool's own instance they are equal:
DIST_SELECT_AB_r05.json).  Prints one JSON object.  Not collected by
pytest.
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=2")
sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import ab_distributed_select as ab  # noqa: E402
from pymht_tpu.core.config import TrackerParams, TrackerShapes  # noqa: E402


def main():
    shapes = TrackerShapes(max_targets=64, max_leaves=8, max_meas=64,
                           max_ais=32, window=6)
    params = TrackerParams(radar_period=2.5, P_d=0.85, lambda_phi=2e-6,
                           lambda_nu=1e-6, N=4)
    state = ab.build_state(shapes, params, 60)
    mesh = Mesh(np.array(jax.devices()[:2]), ('cluster',))
    res = {}
    for impl in ("full", "compact"):
        kw = ({"fast_path": False, "contested_cap": 512}
              if impl == "compact" else {})
        _, obj, lb, feas, _ = ab.make_select(mesh, shapes, params, impl,
                                             iters=60, **kw)(state)
        res[impl] = {"obj": float(obj), "lb": float(lb),
                     "feasible": bool(feas)}
    print(json.dumps(res))


if __name__ == "__main__":
    main()

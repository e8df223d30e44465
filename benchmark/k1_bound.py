"""The least time an NVIDIA H100 could take for K1, the gate-and-score
pass of grow, at a shape: every input byte read once and every output
byte written once at the card's HBM rate, against ~15 flops per
(leaf, measurement) pair and ~150 per leaf at its float32 rate (the
published peaks of the SXM part at 700 W).  It counts the work K1's
contract asks for, whatever implements it.  A frozen copy of
``chip_smoke.py``'s ``k1_bound`` and ``k1_sub_bound``."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def _bound(bytes_in, bytes_out, pairs, leaves):
    t_bytes = 1e3 * (bytes_in + bytes_out) / HBM_BYTES_PER_S
    t_flops = 1e3 * (15.0 * pairs + 150.0 * leaves) / F32_FLOP_PER_S
    return dict(bytes=bytes_in + bytes_out, bound_ms=max(t_bytes, t_flops),
                bound_by="bytes" if t_bytes >= t_flops else "operations")


def k1_bound(N, M):
    """The shared-scan entry point: N leaves against one scan of M."""
    bytes_in = N * (16 + 64 + 4 + 4 + 1) + M * (8 + 1) + 4
    bytes_out = N * (4 * (M + 1) + 16 + 64 + 32 + 64 + 4) + M
    return _bound(bytes_in, bytes_out, N * M, N)


def k1_sub_bound(T, L, Km, M, n_dt=1):
    """The per-target entry point: T targets of L leaves, each against
    its own Km measurements (``z_sub``, ``zmask_sub``, ``zidx``), with
    ``n_dt`` time steps, writing the [T L, 1 + Km] plane and the used
    mask of the scan's M measurements."""
    N = T * L
    bytes_in = N * (16 + 64 + 4 + 4 + 1) + 4 * n_dt + T * Km * (8 + 1 + 4)
    bytes_out = N * (4 * (Km + 1) + 16 + 64 + 32 + 64 + 4) + M
    return _bound(bytes_in, bytes_out, N * Km, N)


def bound_of(config: dict) -> dict:
    """K1's bound at a configuration's shapes: the per-target entry point
    under the spatial pre-gate, the shared-scan one otherwise."""
    s = config["shapes"]
    T, L, M, Km = (s["max_targets"], s["max_leaves"], s["max_meas"],
                   s["radar_cand_width"])
    if 0 < Km < M:
        return k1_sub_bound(T, L, Km, M)
    return k1_bound(T * L, M)

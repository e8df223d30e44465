"""The tile plan of K1's per-target kernel (``gate_kernel.sub_plan``), held
on the CPU to what the kernel (csrc/gate_score.cu, design point 6)
assumes of it: tiles of R leaves, R a multiple of 16, that cover the flat
N = T * L axis once whatever L is, blocks that walk every tile once, a
full tile's plane starting on a 16-byte boundary (so that one bulk copy
writes it), no tile touching more targets than its staged columns hold,
and shared memory that fits one H100 block.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from pymht_tpu_torch.ops import gate_kernel as gk  # noqa: E402

LEAVES = (1, 5, 16, 32, 33, 1024, 4096)


def _targets(L):
    """Enough targets that tiles cross target boundaries at every L."""
    return 3 if L >= 1024 else -(-600 // L) + 2


def _check_plan(p, T, L, Km, sms=gk.H100_SMS, blocks_per_sm=None):
    N = T * L
    R = p.rows
    assert R >= 16 and R % 16 == 0
    assert p.threads % 32 == 0 and 32 <= p.threads <= 256
    cols = 1 << p.cols_log2
    assert 1 <= cols <= p.threads and p.threads % cols == 0
    assert -(-R // (p.threads // cols)) <= 32    # a bit per row of a thread
    assert p.stages in (1, 2)
    assert p.tiles == -(-N // R)
    assert 1 <= p.grid <= p.tiles
    if p.stages == 1:
        assert p.grid == p.tiles          # one tile per block
    elif blocks_per_sm is not None:
        assert p.grid <= max(1, blocks_per_sm) * sms
    # every leaf in exactly one tile
    starts = np.arange(p.tiles, dtype=np.int64) * R
    ends = np.minimum(starts + R, N)
    cover = np.zeros(N + 1, np.int64)
    np.add.at(cover, starts, 1)
    np.add.at(cover, ends, -1)
    assert (np.cumsum(cover)[:N] == 1).all()
    assert (ends > starts).all()
    # the persistent walk (tile k = b, b + grid, ...) takes each tile once
    walked = np.concatenate([np.arange(b, p.tiles, p.grid)
                             for b in range(p.grid)])
    assert np.array_equal(np.sort(walked), np.arange(p.tiles))
    # only the last tile is ragged, and every full tile's plane range
    # starts 16-byte aligned in a 16-byte-aligned plane
    full = (ends - starts) == R
    assert full[:-1].all()
    assert (starts[full] * (Km + 1) * 4 % 16 == 0).all()
    # no tile touches more targets than its staged columns hold
    span = (ends - 1) // L - starts // L + 1
    assert span.max() <= p.targets <= T
    # shared memory: the kernel's layout, within an H100 block's opt-in
    assert p.smem == gk.sub_smem_bytes(R, p.targets, Km, p.stages, p.staged)
    assert p.smem <= gk.SMEM_BLOCK_LIMIT


@pytest.mark.parametrize("L", LEAVES)
def test_sub_plan_invariants(L):
    """Km = 1 ... 600 at each L: the invariants above, with the plan's own
    occupancy estimate and with the counts a card may report."""
    T = _targets(L)
    for Km in range(1, 601):
        _check_plan(gk.sub_plan(T, L, Km), T, L, Km)
    for Km in (1, 15, 28, 64, 512, 600):
        for per_sm in (1, 2, 3):
            p = gk.sub_plan(T, L, Km, sms=132, blocks_per_sm=per_sm)
            _check_plan(p, T, L, Km, 132, per_sm)


@pytest.mark.parametrize("rows,stages,threads", [
    (16, 1, 256), (32, 2, 256), (64, 1, 128), (128, 2, 256)])
def test_sub_plan_overrides(rows, stages, threads):
    """The variants ``chip_smoke.py --k1-ab`` times keep the invariants,
    and take what they are asked for where it fits."""
    for T, L, Km in ((128, 32, 64), (1024, 16, 64), (256, 128, 28),
                     (8, 1024, 64), (4096, 32, 64), (32, 4096, 512)):
        p = gk.sub_plan(T, L, Km, rows=rows, stages=stages,
                        threads=threads)
        _check_plan(p, T, L, Km)
        assert p.threads == threads and p.staged == (Km < 256)
        if gk.sub_smem_bytes(rows, p.targets, Km, stages, p.staged) \
                <= gk.SMEM_BLOCK_LIMIT:
            assert (p.rows, p.stages) == (rows, stages)


def test_sub_plan_stages_nothing_it_cannot_hold():
    """A plane tile that even 16 rows cannot stage goes out directly
    (``staged`` False), with shared memory for the leaves alone; below
    Km = 256 what fits is staged, and from Km = 256 on the plane goes out
    directly unless staging is asked for."""
    for T, L, Km in ((2, 16, 4000), (5, 1, 2000), (1, 4096, 100_000)):
        p = gk.sub_plan(T, L, Km, staged=True)
        _check_plan(p, T, L, Km)
        assert not p.staged and p.rows == 16
        assert p.smem < 48 * 1024
    for T, L, Km in ((2, 16, 255), (100, 1, 200), (4096, 32, 64)):
        assert gk.sub_plan(T, L, Km).staged
    for T, L, Km in ((2, 16, 2000), (100, 1, 600), (32, 4096, 512)):
        assert not gk.sub_plan(T, L, Km).staged
        assert gk.sub_plan(T, L, Km, staged=True).staged


def test_sub_plan_columns_leave_no_thread_idle_at_the_main_shapes():
    """The threads that share a row's columns, SUB_COLS columns each,
    divide the main paths' columns: 16 threads at Km = 64 (4 rows each at
    R = 64), 128 at Km = 512, 8 at the Monte-Carlo configuration's
    Km = 28."""
    assert gk.sub_plan(4096, 32, 64).cols_log2 == 4
    assert gk.sub_plan(32, 4096, 512).cols_log2 == 7
    assert gk.sub_plan(256, 128, 28).cols_log2 == 3


def test_sub_smem_bytes_counts_every_region():
    """The layout by hand for one small plan: 16 bytes of mbarriers, 32
    bytes of row and 4 per count partial per row, the marks, rounded to
    128, and each buffer's region rounded up to 128 bytes plus 128."""
    R, nt, Km = 16, 2, 3
    slots = gk.SUB_MAX_THREADS // 32

    def region(b):
        return -(-b // 128) * 128 + 128

    def head(z):
        return -(-(16 + R * (32 + 4 * slots) + z) // 128) * 128

    stage = sum(map(region, (R * 16, R * 64, R * 4, R * 4, R,
                             nt * Km * 8, nt * Km, nt * Km * 4,
                             R * (Km + 1) * 4, R * 16, R * 64, R * 32,
                             R * 64, R * 4)))
    assert gk.sub_smem_bytes(R, nt, Km, 2, True) == \
        head(nt * Km) + 2 * stage
    direct = sum(map(region, (R * 16, R * 64, R * 4, R * 4, R, R * 16,
                              R * 64, R * 32, R * 64, R * 4)))
    assert gk.sub_smem_bytes(R, nt, Km, 1, False) == head(0) + direct

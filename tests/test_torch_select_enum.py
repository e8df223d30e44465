"""Tier 2 of the selection: the card's kernel (``ops/enum_kernel``,
``csrc/enum_small.cu``) and its plain twin (``core/select._enum_planes``
over ``_enum_buckets``, the CPU path).

On the CPU, the kernel's algorithm written out in numpy (``walk``: per
bucket only the C^k combinations of its k members, conflict rows, the
prefixes in order, the lowest index among the least values) equals the
twin's ``(best, val)`` bit for bit, on buckets of 0, 2, 3 and 4 members,
dead leaves at ``BIG``, a bucket whose every combination conflicts and
planted equal scores, windows of 12, 14 and 18 slot columns; and the
counters ``enum_buckets`` and ``enum_calls`` count the small clusters of
the selection forests and tier 2's one solve a selection.  On a card
(``-m cuda``) the kernel equals the twin bit for bit on the same cases
(the window of 18 columns takes the kernel's instance that reads slots
from shared memory, at C = 16 and 32), at both benchmark cells' shapes
and on a batch of 256 scenarios, in one launch counted on the device,
captured as eagerly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pymht_tpu_torch.core import select as tsel  # noqa: E402
from pymht_tpu_torch.ops import enum_kernel as ek  # noqa: E402
from pymht_tpu_torch.utils import timing  # noqa: E402

import torch_select_forests as forests  # noqa: E402

K = tsel.K_ENUM


def buckets(seed, lead, T, L, C, W2, sizes, per_col=24, ties=(), clash=(),
            dead=0.1):
    """Tier 2's inputs, seeded: (cand_f [*lead, T, C], cand_idx, slots
    [*lead, T, L, W2], members [*lead, T // 2, K], n_slots).  Bucket b of
    every scenario holds ``sizes[b]`` targets (0 past the list).  Slot ids
    per window column come from a few measurements, so members conflict
    often; ``dead`` of the scores are ``BIG``.  The buckets in ``ties``
    score 0.5 or 1.0 on every candidate (many equal sums); those in
    ``clash`` put one slot on every candidate of every member, so every
    combination conflicts."""
    rng = np.random.default_rng(seed)
    nb, B, W = int(np.prod(lead)), T // 2, W2 // 2
    n_slots = W * per_col
    cols = np.arange(W)[None, None, :] * per_col
    radar = cols + rng.integers(0, 10, (nb, T, L, W))
    radar = np.where(rng.uniform(size=radar.shape) < 0.5, n_slots, radar)
    ais = cols + 20 + rng.integers(0, 3, (nb, T, L, W))
    ais = np.where(rng.uniform(size=ais.shape) < 0.8, n_slots, ais)
    slots = np.stack([radar, ais], -1).reshape(nb, T, L, W2)
    f = rng.normal(0, 2, (nb, T, C)).astype(np.float32)
    f = np.where(rng.uniform(size=f.shape) < dead, np.float32(tsel.BIG), f)
    cand_idx = np.stack([np.stack([rng.permutation(L)[:C] for _ in range(T)])
                         for _ in range(nb)])
    members = np.full((nb, B, K), T, np.int64)
    for s in range(nb):
        pool = list(rng.permutation(T))
        for b, k in enumerate(sizes):
            m = sorted(pool.pop() for _ in range(k))
            members[s, b, :k] = m
            if b in ties:
                f[s, m] = rng.choice(np.float32([0.5, 1.0]), (k, C))
            if b in clash:
                slots[s, m, :, 0] = 0
    return (torch.from_numpy(f).reshape(*lead, T, C),
            torch.from_numpy(cand_idx).reshape(*lead, T, C),
            torch.from_numpy(slots).reshape(*lead, T, L, W2),
            torch.from_numpy(members).reshape(*lead, B, K), n_slots)


def walk(cand_f, cand_idx, slots, members, n_slots):
    """The kernel's algorithm, bucket by bucket, in numpy f32."""
    *lead, T, C = cand_f.shape
    L, W2 = slots.shape[-2:]
    B = members.shape[-2]
    cf = cand_f.cpu().numpy().reshape(-1, T, C)
    ci = cand_idx.cpu().numpy().reshape(-1, T, C)
    sl = slots.cpu().numpy().reshape(-1, T, L, W2)
    mb = members.cpu().numpy().reshape(-1, B, K)
    best = np.zeros(mb.shape[:2], np.int64)
    val = np.zeros(mb.shape[:2], np.float32)
    for s, b in np.ndindex(*mb.shape[:2]):
        m = mb[s, b]
        k = 0
        while k < K and m[k] < T:
            k += 1
        if k == 0:
            continue
        fs = [cf[s, m[i]] for i in range(k)]                   # [C] each
        ss = [sl[s, m[i]][ci[s, m[i]]] for i in range(k)]      # [C, W2]
        conf = {(i, j): ((ss[i][:, None, :, None] == ss[j][None, :, None, :])
                         & (ss[i][:, None, :, None] < n_slots)).any((2, 3))
                for i in range(k) for j in range(i + 1, k)}
        bv, bj = np.float32(np.inf), 0
        for pf in range(C ** (k - 1)):
            d = [(pf // C ** (k - 2 - i)) % C for i in range(k - 1)]
            if any(conf[x, y][d[x], d[y]]
                   for x in range(k - 1) for y in range(x + 1, k - 1)):
                continue
            allowed = np.ones(C, bool)
            for x in range(k - 1):
                allowed &= ~conf[x, k - 1][d[x]]
            if k >= 2:
                pre = fs[0][d[0]]
                for x in range(1, k - 1):
                    pre = pre + fs[x][d[x]]
                v = pre + fs[k - 1]
            else:
                v = fs[0].copy()
            for _ in range(k, K):
                v = v + np.float32(0.0)
            v = np.where(allowed, v, np.float32(np.inf))
            c = int(np.argmin(v))
            if v[c] < bv:
                bv, bj = v[c], pf * C + c
        best[s, b], val[s, b] = bj * C ** (K - k), bv
    return (torch.from_numpy(best).reshape(*lead, B),
            torch.from_numpy(val).reshape(*lead, B))


def same(a, b):
    """Bit for bit: the indices equal and the values' bits equal."""
    return (torch.equal(a[0].cpu(), b[0].cpu())
            and torch.equal(a[1].cpu().view(torch.int32),
                            b[1].cpu().view(torch.int32)))


SIZES = [4, 0, 2, 3, 4, 2, 0, 3, 2, 4]
TIES, CLASH = (4, 5), (8,)
# (seed, C, W2): both C of the cases, both cells' windows; a window past
# the kernel's REG_W2 = 16 register columns, at C = 16 and the most, 32
CASES = [(1, 2, 12), (2, 2, 14), (3, 16, 12), (4, 16, 14), (9, 16, 18),
         (10, 32, 18)]


def case(seed, C, W2):
    """A case's buckets over 24 targets of max(16, C) leaves."""
    return buckets(seed, (), 24, max(16, C), C, W2, SIZES, ties=TIES,
                   clash=CLASH)


@pytest.mark.parametrize("seed,C,W2", CASES)
def test_walk_equals_the_planes(seed, C, W2):
    """Only C^k combinations per bucket, prefixes and a mask walk: the
    twin's (best, val) bit for bit, on every kind of bucket."""
    inp = case(seed, C, W2)
    ref = tsel._enum_planes(*inp)
    assert same(walk(*inp), ref)
    best, val = ref
    assert best[1] == best[6] == 0
    assert (val[1], val[6]) == (0.0, 0.0)                     # empty buckets
    assert best[8] == 0 and val[8] == float("inf")            # every pair clashes
    assert torch.isfinite(val[[0, 2, 3, 4, 5, 7, 9]]).any()


@pytest.mark.parametrize("C", [2, 16])
def test_walk_keeps_the_lowest_index_of_equal_scores(C):
    """Every candidate scores 1.0 and nothing conflicts: every
    combination ties, and the lowest flat index (0) wins; with the first
    member's first candidate dearer, the next combination of the walk."""
    inp = list(buckets(5, (), 12, 16, C, 12, [4, 3, 2]))
    inp[0] = torch.ones_like(inp[0])
    inp[2] = torch.full_like(inp[2], inp[4])                  # no slots
    ref = tsel._enum_planes(*inp)
    assert same(walk(*inp), ref)
    assert ref[0][:3].tolist() == [0, 0, 0]
    m = inp[3][0, 0]
    inp[0][m, 0] = 2.0
    ref = tsel._enum_planes(*inp)
    assert same(walk(*inp), ref)
    assert ref[0][0] == C ** 3                                # digits 1,0,0,0


def test_walk_on_a_batch():
    """Leading axes: each scenario's buckets read their own rows."""
    inp = buckets(6, (3, 2), 10, 16, 4, 12, [2, 3, 4, 0], ties=(0,),
                  clash=(1,))
    assert same(walk(*inp), tsel._enum_planes(*inp))


def small_clusters(st, shapes):
    """The clusters of 2..K_ENUM live targets of a forest."""
    labels, _ = tsel.cluster(st, shapes)
    size = tsel.cluster_sizes(labels, st.tgt_mask)
    small = st.tgt_mask & (size >= 2) & (size <= K)
    return len(set(labels[small].tolist()))


def forest_cases():
    trunc, shapes, params = forests.truncation_forest()
    return [("truncation", trunc, shapes, params),
            ("dense", forests.dense_cluster(), forests.SHAPES_BIG,
             forests.PARAMS_BIG)]


def tier2_counts(device=None):
    """(``enum_buckets``, ``enum_calls``) of ``device`` (all: None)."""
    c = timing.counters(device)
    return np.array([c["enum_buckets"], c["enum_calls"]])


@pytest.mark.parametrize("i", [0, 1])
def test_counter_counts_the_small_clusters(i):
    """``enum_buckets`` adds tier 2's non-empty buckets, one per small
    cluster, and ``enum_calls`` one, per selection."""
    name, st, shapes, params = forest_cases()[i]
    c0 = tier2_counts("cpu")
    tsel.select_hybrid(st, shapes, params)
    n, calls = tier2_counts("cpu") - c0
    assert n == small_clusters(st, shapes), name
    assert calls == 1
    if name == "truncation":
        assert n == 1


def test_wrapper_takes_only_the_card():
    """The wrapper launches or raises: no path for a CPU tensor."""
    inp = buckets(7, (), 8, 16, 4, 12, [2])
    with pytest.raises(ValueError, match="CUDA"):
        ek.enum_small(*inp)


# -- on the card ------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    ek.prepare(torch.device("cuda"))
    return torch.device("cuda")


def on(inp, dev):
    return [t.to(dev) if isinstance(t, torch.Tensor) else t for t in inp]


def swarm_sizes(rng, B, n):
    return list(rng.choice([2, 2, 2, 3, 3, 4], n)) + [0] * (B - n)


# (name, lead, T, L, C, W2, sizes): the swarm cell's shape, the coastal
# cell's, Monte-Carlo's batch of 256 scenarios of 4 buckets
CARD_SHAPES = [
    ("swarm", (), 1024, 16, 16, 12,
     swarm_sizes(np.random.default_rng(0), 512, 60)),
    ("coastal", (), 128, 32, 16, 14,
     swarm_sizes(np.random.default_rng(1), 64, 12)),
    ("mc", (256,), 8, 16, 16, 12, [2, 2, 0, 0]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("seed,C,W2", CASES)
def test_card_kernel_equals_the_twin(card, seed, C, W2):
    """The CPU cases on the card: kernel against the twin (on the card
    and on the CPU) and the walk, bit for bit, in one launch as the
    device counts it."""
    inp = case(seed, C, W2)
    timing.ready(card)
    c0 = tier2_counts(card)
    got = ek.enum_small(*on(inp, card))
    torch.cuda.synchronize()
    filled = sum(1 for s in SIZES if s)
    assert (tier2_counts(card) - c0).tolist() == [filled, 1]
    assert same(got, tsel._enum_planes(*on(inp, card)))
    assert same(got, tsel._enum_planes(*inp))
    assert same(got, walk(*inp))


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_SHAPES, ids=lambda c: c[0])
def test_card_kernel_at_the_cells_shapes(card, case):
    """Both cells' shapes and a batch: bit for bit the twin's, one launch,
    the counter adds the non-empty buckets, and a captured replay gives
    the eager call's outputs and counts."""
    name, lead, T, L, C, W2, sizes = case
    nb = int(np.prod(lead))
    inp = on(buckets(11, lead, T, L, C, W2, sizes, ties=(0,), clash=(1,)),
             card)
    filled = int((inp[3][..., 0] < T).sum())
    assert filled == nb * sum(1 for s in sizes if s)
    timing.ready(card)
    c0 = tier2_counts(card)
    got = ek.enum_small(*inp)
    torch.cuda.synchronize()
    assert (tier2_counts(card) - c0).tolist() == [filled, 1]
    assert same(got, tsel._enum_planes(*inp)), name
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        cap = ek.enum_small(*inp)
    for t in cap:
        t.fill_(-1)
    c0 = tier2_counts(card)
    g.replay()
    torch.cuda.synchronize()
    assert (tier2_counts(card) - c0).tolist() == [filled, 1]
    assert same(cap, got)


@pytest.mark.cuda
@pytest.mark.parametrize("i", [0, 1])
def test_card_counter_agrees_with_the_cpu(card, i):
    """``select_hybrid`` on a forest on the card and on the CPU: the same
    selection, and the same counts of small clusters and of solves."""
    from pymht_tpu_torch.core.state import state_from_numpy, state_to_numpy
    name, st, shapes, params = forest_cases()[i]
    counts, res = [], []
    for dev in ("cpu", card):
        s = state_from_numpy(state_to_numpy(st), dev)
        timing.ready(torch.device(dev))
        c0 = tier2_counts(dev)
        res.append(tsel.select_hybrid(s, shapes, params))
        counts.append((tier2_counts(dev) - c0).tolist())
    assert counts[0] == counts[1] == [small_clusters(st, shapes), 1], name
    if name == "truncation":          # tier 2 alone: the same selection
        assert torch.equal(res[0].sel, res[1].sel.cpu())
        assert float(res[0].obj) == float(res[1].obj)


@pytest.mark.cuda
def test_card_wrapper_refuses_what_the_kernel_cannot_take(card):
    inp = on(buckets(8, (), 8, 40, 33, 12, [2]), card)
    with pytest.raises(ValueError, match="C=33"):
        ek.enum_small(*inp)

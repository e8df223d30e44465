"""K1 (gate and score): the port's plain twin against the JAX Pallas
kernel (interpret mode) and the JAX reference, on the inputs of
tests/test_gate_kernel.py; and, on a card, the CUDA kernel against the
twin.

Tolerances: states and scores are compared at rtol 1e-4 / atol 1e-3 (the
JAX kernel test's), x_bar at 1e-5 / 1e-4; gating decisions must be
identical.  The seven-output twin (``radar_candidates_reference``) is
held against the JAX package's fused planes
(``radar_candidates_planes``) at rtol 1e-5 / atol 1e-4: both are f32,
one by einsum, one in closed form.  The same holds for the per-target
entry point (``z_sub``, ``zmask_sub``, ``zidx``) against
``radar_candidates_planes(z_sub=...)``.

The JAX package is imported inside the tests that use it, so the card
test also runs where only torch is installed:
``python -m pytest --noconftest -m cuda tests/test_torch_gate_kernel.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pymht_tpu_torch.ops import gate_kernel as tk  # noqa: E402

BIG = tk.BIG
ARGS = dict(radar_period=2.5, q_scale=1.0, r_var=6.25, eta2=5.99,
            lambda_ex=2e-5)


def _inputs(seed=0, N=32, M=24):
    """The inputs of tests/test_gate_kernel.py, as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 100, (N, 4)).astype(np.float32)
    P = np.broadcast_to(np.diag(np.float32([6.25, 6.25, 1.875, 1.875])),
                        (N, 4, 4)).copy()                  # pv.P0
    P += rng.uniform(0, 1, (N, 1, 1)).astype(np.float32) * np.eye(4)
    cnllr = rng.normal(0, 1, N).astype(np.float32)
    pd = np.full(N, 0.85, np.float32)
    mask = rng.uniform(size=N) < 0.9
    z = rng.normal(0, 100, (M, 2)).astype(np.float32)
    k = min(M, N) // 2
    z[:k] = x[:k, :2] + x[:k, 2:] * 2.5 + rng.normal(0, 2.0, (k, 2))
    zmask = rng.uniform(size=M) < 0.95
    return [x, P.astype(np.float32), cnllr, pd, mask, z.astype(np.float32),
            zmask]


def _torch(inp, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in inp]


def _assert_same(s, xb, pb, s_ref, xb_ref, pb_ref):
    s, s_ref = np.asarray(s), np.asarray(s_ref)
    np.testing.assert_allclose(np.asarray(xb), np.asarray(xb_ref),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(pb), np.asarray(pb_ref),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(s >= BIG * 0.5, s_ref >= BIG * 0.5)
    gated = s_ref < BIG * 0.5
    np.testing.assert_allclose(s[gated], s_ref[gated], rtol=1e-4, atol=1e-3)


@pytest.fixture
def jax_gk():
    pytest.importorskip("jax")
    from pymht_tpu.ops import gate_kernel
    return gate_kernel


@pytest.mark.parametrize("seed", range(3))
def test_twin_matches_jax_kernel_and_reference(jax_gk, seed):
    inp = _inputs(seed)
    out = tk.gate_and_score(*_torch(inp), **ARGS)
    assert out[0].shape == (32, 25)
    out = [o.numpy() for o in out]
    _assert_same(*out, *jax_gk.gate_and_score_pallas(
        *inp, **ARGS, tile_n=16, interpret=True))
    _assert_same(*out, *jax_gk.gate_and_score_reference(*inp, **ARGS))


def test_twin_padding_rows(jax_gk):
    """N = 20 is not a multiple of the Pallas tile: the ragged tile."""
    inp = _inputs(5, N=20, M=8)
    out = [o.numpy() for o in tk.gate_and_score(*_torch(inp), **ARGS)]
    _assert_same(*out, *jax_gk.gate_and_score_pallas(
        *inp, **ARGS, tile_n=16, interpret=True))


def test_device_time_step_matches_float():
    """dt as a 0-d tensor (grow's per-scan scan.time - state.time) gives
    the same result as a Python float."""
    inp = _torch(_inputs(1))
    args = dict(ARGS)
    a = tk.gate_and_score(*inp, **args)
    args["radar_period"] = torch.tensor(2.5)
    b = tk.gate_and_score(*inp, **args)
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0)


def _planes(inp, T, L, period=2.5, eta2=ARGS["eta2"], lambda_ex=2e-5,
            z_sub=None, zmask_sub=None, zidx=None):
    """The JAX package's fused radar planes on the same inputs, laid out
    as a [T, L] forest (pd per target, as in grow); with ``z_sub`` the
    per-target planes and grow's scatter of the used mask through
    ``zidx`` (pymht_tpu/core/grow.py:548-554)."""
    import jax.numpy as jnp
    from types import SimpleNamespace
    from pymht_tpu.ops.ais_fused import radar_candidates_planes
    x, P, cnllr, pd, mask, z, zmask = inp
    state = SimpleNamespace(
        leaf_x=jnp.asarray(x.reshape(T, L, 4)),
        leaf_P=jnp.asarray(P.reshape(T, L, 4, 4)),
        leaf_mask=jnp.asarray(mask.reshape(T, L)),
        tgt_pd=jnp.asarray(pd.reshape(T, L)[:, 0]),
        time=jnp.asarray(1.0, jnp.float32))
    scan = SimpleNamespace(z=jnp.asarray(z), mask=jnp.asarray(zmask),
                           time=jnp.asarray(1.0 + period, jnp.float32))
    # lambda_phi + lambda_nu = lambda_ex
    params = SimpleNamespace(eta2=eta2, lambda_ex=lambda_ex)
    if z_sub is None:
        out = radar_candidates_planes(state, scan, params)
        used = jnp.any(out[4], axis=(0, 1))                 # [M]
    else:
        out = radar_candidates_planes(state, scan, params,
                                      z_sub=jnp.asarray(z_sub),
                                      zmask_sub=jnp.asarray(zmask_sub))
        M = z.shape[0]
        scat = jnp.where(jnp.any(out[4], axis=1), jnp.asarray(zidx), M)
        used = jnp.zeros((M + 1,), bool).at[scat.reshape(-1)].set(True)[:M]
    gate = out[4]
    counts = jnp.sum(gate, axis=2, dtype=jnp.int32)         # [T, L]
    return [np.asarray(o) for o in out] + [np.asarray(counts),
                                           np.asarray(used)]


# (seed, T, L, M, all measurements masked)
CANDIDATE_CASES = [(0, 4, 8, 24, False), (1, 8, 8, 16, False),
                   (2, 2, 10, 1, False), (3, 4, 8, 24, True),
                   (4, 5, 4, 7, False)]


@pytest.mark.parametrize("seed,T,L,M,masked", CANDIDATE_CASES)
def test_candidates_twin_matches_jax_planes(jax_gk, seed, T, L, M, masked):
    """All seven outputs of the twin against radar_candidates_planes and
    jnp reductions of its gate: gate, counts and used identical; x_bar,
    P_bar, K, P_hat within rtol 1e-5 / atol 1e-4; scores against
    cnllr + nllr_m where gated, exactly BIG elsewhere."""
    tol = dict(rtol=1e-5, atol=1e-4)
    N = T * L
    inp = _inputs(seed, N=N, M=M)
    if M == 1:
        inp[5][0] = inp[0][0, :2] + inp[0][0, 2:] * 2.5    # z on leaf 0
        inp[4][0] = inp[6][0] = True
    if masked:
        inp[6][:] = False
    x_bar, P_bar, K, P_hat, gate, nllr_m, counts, used = _planes(inp, T, L)
    out = tk.radar_candidates(*_torch(inp), **ARGS)
    assert isinstance(out, tk.RadarCandidates)
    assert out.scores.shape == (N, M + 1) and out.K.shape == (N, 4, 2)
    assert out.gated_counts.dtype == torch.int32
    assert out.used_meas.dtype == torch.bool
    np.testing.assert_allclose(out.x_bar.numpy(), x_bar.reshape(N, 4), **tol)
    np.testing.assert_allclose(out.P_bar.numpy(), P_bar.reshape(N, 4, 4),
                               **tol)
    np.testing.assert_allclose(out.K.numpy(), K.reshape(N, 4, 2), **tol)
    np.testing.assert_allclose(out.P_hat.numpy(), P_hat.reshape(N, 4, 4),
                               **tol)
    s = out.scores.numpy()
    g = gate.reshape(N, M)
    np.testing.assert_array_equal(s[:, 1:] < BIG * 0.5, g)
    assert (s[:, 1:][~g] == np.float32(BIG)).all()
    want = (inp[2][:, None] + nllr_m.reshape(N, M))[g]
    np.testing.assert_allclose(s[:, 1:][g], want, **tol)
    np.testing.assert_array_equal(out.gated_counts.numpy(),
                                  counts.reshape(N))
    np.testing.assert_array_equal(out.used_meas.numpy(), used)
    if masked:
        assert not g.any() and not used.any() and not counts.any()
    else:
        assert g.any() and used.any()
    # the three-output entry point is the same pass
    for a, b in zip(tk.gate_and_score(*_torch(inp), **ARGS), out[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _per_target(inp, T, L, Km, seed, mask_targets=()):
    """Each target's Km nearest valid measurements to its first leaf's
    prediction (grow's pre-gate): z_sub, zmask_sub, zidx as numpy."""
    x, z, zmask = inp[0], inp[5], inp[6]
    M = z.shape[0]
    first = x.reshape(T, L, 4)[:, 0]
    pred = first[:, :2] + 2.5 * first[:, 2:]
    d2 = ((z[None] - pred[:, None]) ** 2).sum(-1)
    d2[:, ~zmask] = np.inf
    zidx = np.argsort(d2, axis=1, kind="stable")[:, :Km]
    zmask_sub = zmask[zidx] & np.isfinite(np.take_along_axis(d2, zidx, 1))
    # a masked column may point anywhere: scramble those indices
    rng = np.random.default_rng(seed)
    zidx = np.where(zmask_sub, zidx, rng.integers(0, M, zidx.shape))
    for t in mask_targets:
        zmask_sub[t] = False
    return (np.ascontiguousarray(z[zidx]), zmask_sub,
            zidx.astype(np.int32))


def _cluster_leaves(inp, T, L, seed):
    """Make the L leaves of a target neighbours (a real forest), so that
    a target's nearest measurements matter to all of them."""
    rng = np.random.default_rng(100 + seed)
    x = inp[0].reshape(T, L, 4)
    x[:] = x[:, :1] + rng.normal(0, 1.5, x.shape).astype(np.float32)
    M = inp[5].shape[0]
    k = min(M, T)
    inp[5][:k] = x[:k, 0, :2] + 2.5 * x[:k, 0, 2:] \
        + rng.normal(0, 2.0, (k, 2)).astype(np.float32)
    inp[6][:k] = True


# (seed, T, L, M, Km, targets whose columns are all masked); the last
# three: one leaf per target, L = 5 at Km = 64, an odd Km
PER_TARGET_CASES = [(0, 4, 8, 24, 6, ()), (1, 8, 8, 16, 15, ()),
                    (2, 3, 20, 32, 8, ()), (3, 4, 8, 24, 6, (0, 2)),
                    (4, 5, 4, 7, 1, ()), (5, 6, 5, 12, 12, ()),
                    (6, 40, 1, 96, 64, ()), (7, 12, 5, 80, 64, ()),
                    (8, 9, 6, 40, 21, ())]


@pytest.mark.parametrize("seed,T,L,M,Km,masked", PER_TARGET_CASES)
def test_per_target_twin_matches_jax_planes(jax_gk, seed, T, L, M, Km,
                                            masked):
    """The twin with z_sub / zmask_sub / zidx against
    radar_candidates_planes(z_sub=...) and grow's scatter of the used
    mask: gate, counts and used identical, the rest within rtol 1e-5 /
    atol 1e-4; used stays on the real measurement axis."""
    tol = dict(rtol=1e-5, atol=1e-4)
    N = T * L
    inp = _inputs(seed, N=N, M=M)
    _cluster_leaves(inp, T, L, seed)
    z_sub, zmask_sub, zidx = _per_target(inp, T, L, Km, seed, masked)
    x_bar, P_bar, K, P_hat, gate, nllr_m, counts, used = _planes(
        inp, T, L, z_sub=z_sub, zmask_sub=zmask_sub, zidx=zidx)
    sub = dict(z_sub=torch.from_numpy(z_sub),
               zmask_sub=torch.from_numpy(zmask_sub),
               zidx=torch.from_numpy(zidx), leaves_per_target=L)
    out = tk.radar_candidates(*_torch(inp), **ARGS, **sub)
    assert out.scores.shape == (N, Km + 1)
    assert out.used_meas.shape == (M,) and out.used_meas.dtype == torch.bool
    for name, want in (("x_bar", x_bar), ("P_bar", P_bar), ("K", K),
                       ("P_hat", P_hat)):
        got = getattr(out, name).numpy()
        np.testing.assert_allclose(got, want.reshape(got.shape),
                                   err_msg=name, **tol)
    s = out.scores.numpy()
    g = gate.reshape(N, Km)
    np.testing.assert_array_equal(s[:, 1:] < BIG * 0.5, g)
    assert (s[:, 1:][~g] == np.float32(BIG)).all()
    np.testing.assert_allclose(
        s[:, 1:][g], (inp[2][:, None] + nllr_m.reshape(N, Km))[g], **tol)
    np.testing.assert_array_equal(out.gated_counts.numpy(),
                                  counts.reshape(N))
    np.testing.assert_array_equal(out.used_meas.numpy(), used)
    assert g.any() and used.any()
    for t in masked:
        assert not g.reshape(T, L, Km)[t].any()
    # the shared-scan pass gates a superset: every used measurement here
    # is used there too
    full = tk.radar_candidates(*_torch(inp), **ARGS)
    assert not (out.used_meas & ~full.used_meas).any()
    if Km == M:      # all measurements kept: the same gate, re-ordered
        assert torch.equal(out.used_meas, full.used_meas)
        assert torch.equal(out.gated_counts, full.gated_counts)


def _sub_args(inp, T, L, Km, seed, device="cpu"):
    z_sub, zmask_sub, zidx = _per_target(inp, T, L, Km, seed)
    return dict(z_sub=torch.from_numpy(z_sub).to(device),
                zmask_sub=torch.from_numpy(zmask_sub).to(device),
                zidx=torch.from_numpy(zidx).to(device), leaves_per_target=L)


def test_per_target_dt_equals_one_target_at_a_time():
    """The twin with one time step per target ([T] radar_period, as a
    batch of scenarios passes it) against the twin run on each target
    alone with its own scalar step: gating, counts and used identical,
    the rest within f32 rounding of two einsum orders."""
    T, L, M, Km = 6, 5, 24, 6
    inp = _inputs(9, N=T * L, M=M)
    _cluster_leaves(inp, T, L, 9)
    steps = np.float32([1.0, 1.75, 2.5, 3.25, 1.0, 1.75])
    sub = _sub_args(inp, T, L, Km, 9)
    args = dict(ARGS, radar_period=torch.from_numpy(steps))
    out = tk.radar_candidates(*_torch(inp), **args, **sub)
    assert out.scores.shape == (T * L, Km + 1)
    used = torch.zeros(M, dtype=torch.bool)
    for t in range(T):
        rows = slice(t * L, (t + 1) * L)
        one = tk.radar_candidates(
            *[torch.from_numpy(np.ascontiguousarray(a[rows])) for a in
              inp[:5]], *_torch(inp[5:]),
            **dict(ARGS, radar_period=float(steps[t])),
            z_sub=sub["z_sub"][t:t + 1], zmask_sub=sub["zmask_sub"][t:t + 1],
            zidx=sub["zidx"][t:t + 1], leaves_per_target=L)
        g, g1 = out.scores[rows] < BIG * 0.5, one.scores < BIG * 0.5
        assert torch.equal(g, g1)
        assert torch.equal(out.gated_counts[rows], one.gated_counts)
        torch.testing.assert_close(out.scores[rows][g1], one.scores[g1])
        for name in ("x_bar", "P_bar", "K", "P_hat"):
            torch.testing.assert_close(getattr(out, name)[rows],
                                       getattr(one, name), msg=name)
        used |= one.used_meas
    assert torch.equal(out.used_meas, used) and used.any()
    # the steps differ, so a target stepped at its neighbour's gates else
    shifted = tk.radar_candidates(
        *_torch(inp), **dict(ARGS, radar_period=torch.from_numpy(
            np.roll(steps, 1))), **sub)
    assert not torch.equal(shifted.scores < BIG * 0.5,
                           out.scores < BIG * 0.5)


def test_per_target_wrapper_refuses_bad_arguments():
    """launch() checks the per-target tensors before any pointer reaches
    the kernel."""
    T, L, M, Km = 4, 8, 24, 6
    inp = _inputs(0, N=T * L, M=M)
    z_sub, zmask_sub, zidx = _per_target(inp, T, L, Km, 0)
    inp = _torch(inp)
    out = tk.empty_outputs(T * L, M, "cpu", Km=Km)
    assert out.scores.shape == (T * L, Km + 1)
    dt = torch.tensor(2.5)
    scal = (1.0, 6.25, 5.99, 2e-5)
    good = dict(z_sub=torch.from_numpy(z_sub),
                zmask_sub=torch.from_numpy(zmask_sub),
                zidx=torch.from_numpy(zidx), leaves_per_target=L)
    for bad, match in (
            (dict(zidx=good["zidx"].long()), "zidx must be"),
            (dict(zmask_sub=good["zmask_sub"][:, :-1]), "zmask_sub must be"),
            (dict(z_sub=good["z_sub"].transpose(0, 1)), "leaves"),
            (dict(leaves_per_target=L - 1), "leaves_per_target"),
            (dict(leaves_per_target=None), "leaves_per_target"),
            (dict(zidx=None), "zidx")):
        with pytest.raises(ValueError, match=match):
            tk.launch(out, *inp, dt, *scal, **{**good, **bad})
    with pytest.raises(ValueError, match="scores must be"):
        tk.launch(tk.empty_outputs(T * L, M, "cpu"), *inp, dt, *scal, **good)
    assert not out.used_meas.any()


def test_candidates_gate_is_score_below_big():
    """Counts and used are reductions of (score < BIG / 2)."""
    inp = _torch(_inputs(6, N=64, M=24))
    out = tk.radar_candidates(*inp, **ARGS)
    gate = out.scores[:, 1:] < BIG * 0.5
    assert gate.any()
    assert torch.equal(out.gated_counts, gate.sum(1, dtype=torch.int32))
    assert torch.equal(out.used_meas, gate.any(0))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """launch() checks device, dtype, shape and contiguity before any
    pointer reaches the kernel (it raises before it needs a card)."""
    inp = _torch(_inputs(0))
    out = tk.empty_outputs(32, 24, "cpu")
    dt = torch.tensor(2.5)
    scal = (1.0, 6.25, 5.99, 2e-5)
    bad = list(inp)
    bad[0] = bad[0].double()
    with pytest.raises(ValueError, match="x must be"):
        tk.launch(out, *bad, dt, *scal)
    bad = list(inp)
    bad[1] = bad[1].transpose(1, 2)
    with pytest.raises(ValueError, match="P must be"):
        tk.launch(out, *bad, dt, *scal)
    with pytest.raises(ValueError, match="scores must be"):
        tk.launch(tk.empty_outputs(32, 23, "cpu"), *inp, dt, *scal)
    with pytest.raises(ValueError, match="dt must be"):
        tk.launch(out, *inp, torch.tensor([2.5]), *scal)
    assert not out.used_meas.any()


@pytest.mark.cuda
@pytest.mark.parametrize("N,M", [(4096, 512), (4095, 1), (20, 8),
                                 (4094, 511)])
def test_kernel_matches_twin_on_card(N, M):
    """The CUDA kernel against the plain twin, on the card, all seven
    outputs (identical gating, counts and used; scores, x_bar, P_bar, K
    and P_hat within rtol 1e-5 / atol 1e-4).  N = 4094 leaves a last
    tile whose length is not a multiple of 4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    inp = _torch(_inputs(0, N=N, M=M), "cuda")
    n0 = tk.launches
    out = tk.radar_candidates(*inp, **ARGS)
    torch.cuda.synchronize()
    assert tk.launches == n0 + 1
    ref = tk.radar_candidates_reference(*inp, **ARGS)
    for name in ("x_bar", "P_bar", "K", "P_hat"):
        torch.testing.assert_close(getattr(out, name), getattr(ref, name),
                                   rtol=1e-5, atol=1e-4, msg=name)
    g, g_r = out.scores < BIG * 0.5, ref.scores < BIG * 0.5
    assert torch.equal(g, g_r)
    assert torch.equal(out.scores[~g_r], ref.scores[~g_r])
    torch.testing.assert_close(out.scores[g_r], ref.scores[g_r], rtol=1e-5,
                               atol=1e-4)
    assert torch.equal(out.gated_counts, ref.gated_counts)
    assert torch.equal(out.used_meas, ref.used_meas)
    s3 = tk.gate_and_score(*inp, **ARGS)
    assert tk.launches == n0 + 2 and torch.equal(s3[0], out.scores)


@pytest.mark.cuda
@pytest.mark.parametrize("T,L,M,Km,masked", [
    (128, 32, 512, 64, ()), (16, 8, 32, 8, ()), (12, 20, 48, 16, ()),
    (128, 32, 512, 64, tuple(range(0, 128, 3))), (9, 5, 17, 1, ()),
    (3, 33, 512, 300, ())])
def test_per_target_kernel_matches_twin_on_card(T, L, M, Km, masked):
    """The per-target entry point of the CUDA kernel against the twin on
    the card: bench leaves (L = 32), a tile smaller than the kernel's 16
    rows (L = 8, 5), ragged tiles (L = 20, 33), targets with every column
    masked, Km = 1, and more columns than threads (Km = 300)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    N = T * L
    inp = _inputs(T, N=N, M=M)
    _cluster_leaves(inp, T, L, T)
    z_sub, zmask_sub, zidx = _per_target(inp, T, L, Km, T, masked)
    inp = _torch(inp, "cuda")
    sub = dict(z_sub=torch.from_numpy(z_sub).cuda(),
               zmask_sub=torch.from_numpy(zmask_sub).cuda(),
               zidx=torch.from_numpy(zidx).cuda(), leaves_per_target=L)
    n0, p0 = tk.launches, tk.launches_pregate
    out = tk.radar_candidates(*inp, **ARGS, **sub)
    torch.cuda.synchronize()
    assert (tk.launches, tk.launches_pregate) == (n0 + 1, p0 + 1)
    ref = tk.radar_candidates_reference(*inp, **ARGS, **sub)
    assert out.scores.shape == (N, Km + 1)
    for name in ("x_bar", "P_bar", "K", "P_hat"):
        torch.testing.assert_close(getattr(out, name), getattr(ref, name),
                                   rtol=1e-5, atol=1e-4, msg=name)
    g, g_r = out.scores < BIG * 0.5, ref.scores < BIG * 0.5
    assert torch.equal(g, g_r) and g_r[:, 1:].any()
    assert torch.equal(out.scores[~g_r], ref.scores[~g_r])
    torch.testing.assert_close(out.scores[g_r], ref.scores[g_r], rtol=1e-5,
                               atol=1e-4)
    assert torch.equal(out.gated_counts, ref.gated_counts)
    assert torch.equal(out.used_meas, ref.used_meas)


def _misaligned(t, shift):
    """A copy of ``t`` whose data starts ``shift`` bytes past a 16-byte
    boundary."""
    nbytes = t.numel() * t.element_size()
    buf = torch.empty(nbytes + 32, dtype=torch.uint8, device=t.device)
    at = (-buf.data_ptr()) % 16 + shift
    v = buf[at:at + nbytes].view(t.dtype).view(t.shape)
    v.copy_(t)
    return v


# the per-target kernel's edges (csrc/gate_score.cu, design point 6):
# (T, L, M, Km, option) -- tiles across targets (L = 1, 5, 33), one time
# step per target, odd Km, Km = 1 at L = 1, a ragged last tile at
# Km = 512, one target per scenario at L = 4096 on a flat [B * M] axis,
# every input off a 16-byte boundary, and a plane too wide to stage
EDGE_CASES = [(300, 1, 512, 64, None), (77, 5, 512, 64, None),
              (40, 33, 512, 64, None), (64, 5, 256, 16, "dt"),
              (200, 1, 256, 28, "dt"), (50, 7, 128, 15, None),
              (100, 1, 64, 1, None), (37, 3, 600, 512, None),
              (3, 4096, 512, 512, "batch"), (20, 16, 96, 33, "unaligned"),
              (2, 16, 4096, 4000, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("T,L,M,Km,option", EDGE_CASES)
def test_per_target_kernel_edges_on_card(T, L, M, Km, option):
    """The redesigned per-target kernel against the twin on the card at
    its edges: gating, counts and used identical, the rest within rtol
    1e-5 / atol 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    N = T * L
    args = dict(ARGS)
    inp = _inputs(T + L, N=N, M=M)
    if option == "batch":     # one target per scenario, zidx on [T * M]
        inp = _torch(inp, "cuda")
        sub = dict(z_sub=inp[5].view(1, M, 2).repeat(T, 1, 1),
                   zmask_sub=inp[6].view(1, M).repeat(T, 1),
                   zidx=torch.arange(T * M, dtype=torch.int32,
                                     device="cuda").view(T, M),
                   leaves_per_target=L)
        args["radar_period"] = torch.linspace(2.5, 3.0, T, device="cuda")
        inp[5] = inp[5].repeat(T, 1)
        inp[6] = inp[6].repeat(T)
    else:
        _cluster_leaves(inp, T, L, T)
        sub = _sub_args(inp, T, L, Km, T, "cuda")
        inp = _torch(inp, "cuda")
        if option == "dt":
            args["radar_period"] = 1.0 + 0.75 * (
                torch.arange(T, device="cuda") % 4).float()
        if option == "unaligned":
            inp = [_misaligned(t, s) for t, s in zip(inp, (4, 4, 4, 8, 1,
                                                           8, 1))]
            sub = {k: _misaligned(v, dict(z_sub=8, zmask_sub=3, zidx=4)[k])
                   if torch.is_tensor(v) else v for k, v in sub.items()}
    p0 = tk.launches_pregate
    out = tk.radar_candidates(*inp, **args, **sub)
    torch.cuda.synchronize()
    assert tk.launches_pregate == p0 + 1
    ref = tk.radar_candidates_reference(*inp, **args, **sub)
    for name in ("x_bar", "P_bar", "K", "P_hat"):
        torch.testing.assert_close(getattr(out, name), getattr(ref, name),
                                   rtol=1e-5, atol=1e-4, msg=name)
    g, g_r = out.scores < BIG * 0.5, ref.scores < BIG * 0.5
    assert torch.equal(g, g_r) and g_r[:, 1:].any()
    assert torch.equal(out.scores[~g_r], ref.scores[~g_r])
    torch.testing.assert_close(out.scores[g_r], ref.scores[g_r], rtol=1e-5,
                               atol=1e-4)
    assert torch.equal(out.gated_counts, ref.gated_counts)
    assert torch.equal(out.used_meas, ref.used_meas)

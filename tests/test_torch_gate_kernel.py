"""K1 (gate and score): the port's plain twin against the JAX Pallas
kernel (interpret mode) and the JAX reference, on the inputs of
tests/test_gate_kernel.py; and, on a card, the CUDA kernel against the
twin.

Tolerances: states and scores are compared at rtol 1e-4 / atol 1e-3 (the
JAX kernel test's), x_bar at 1e-5 / 1e-4; gating decisions must be
identical.

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


@pytest.mark.cuda
@pytest.mark.parametrize("N,M", [(4096, 512), (4095, 1), (20, 8)])
def test_kernel_matches_twin_on_card(N, M):
    """The CUDA kernel against the plain twin, on the card (identical
    gating, scores within rtol 1e-5 / atol 1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    inp = _torch(_inputs(0, N=N, M=M), "cuda")
    n0 = tk.launches
    s, xb, pb = tk.gate_and_score(*inp, **ARGS)
    torch.cuda.synchronize()
    assert tk.launches == n0 + 1
    s_r, xb_r, pb_r = tk.gate_and_score_reference(*inp, **ARGS)
    torch.testing.assert_close(xb, xb_r, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(pb, pb_r, rtol=1e-5, atol=1e-4)
    g, g_r = s < BIG * 0.5, s_r < BIG * 0.5
    assert torch.equal(g, g_r)
    torch.testing.assert_close(s[g_r], s_r[g_r], rtol=1e-5, atol=1e-4)

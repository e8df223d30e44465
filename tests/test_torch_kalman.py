"""Models and Kalman primitives of the port against pymht_tpu.models /
pymht_tpu.ops.kalman on the same seeded inputs (f32; rtol 1e-5,
atol 1e-4 except where stated)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from pymht_tpu.models import ais as jais, pv as jpv  # noqa: E402
from pymht_tpu.ops import kalman as jk  # noqa: E402
from pymht_tpu_torch.models import ais as tais, pv as tpv  # noqa: E402
from pymht_tpu_torch.ops import kalman as tk  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-4)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(tol or TOL))


def _spd(rng, shape, n):
    a = rng.normal(0, 1, shape + (n, n)).astype(np.float32)
    return (a @ np.swapaxes(a, -1, -2) + n * np.eye(n, dtype=np.float32))


@pytest.mark.parametrize("T", [0.0, 1.0, 2.5, np.array([0.5, 2.5, 7.0])])
def test_models(T):
    Tt = torch.as_tensor(np.asarray(T, np.float32))
    _close(tpv.Phi(Tt), jpv.Phi(T), rtol=0, atol=0)
    _close(tpv.Q(Tt), jpv.Q(T), rtol=1e-6, atol=0)
    _close(tpv.Q(Tt, 0.3), jpv.Q(T, 0.3), rtol=1e-6, atol=0)
    _close(tpv.R_RADAR("cpu"), jpv.R_RADAR(), rtol=0, atol=0)
    _close(tpv.C_RADAR("cpu"), jpv.C_RADAR, rtol=0, atol=0)
    _close(tpv.P0("cpu"), jpv.P0, rtol=0, atol=0)
    for hi in (True, False):
        _close(tais.R(hi, "cpu"), jais.R(hi), rtol=0, atol=0)


@pytest.mark.parametrize("seed", range(2))
def test_inverses_and_dets(seed):
    rng = np.random.default_rng(seed)
    for n in (2, 4):
        S = _spd(rng, (5, 3), n)
        St = torch.from_numpy(S)
        _close(tk.inv_psd(St), jk.inv_psd(jnp.asarray(S)), rtol=1e-4,
               atol=1e-5)
        _close(tk.det_psd(St), jk.det_psd(jnp.asarray(S)), rtol=1e-4,
               atol=0)
    S2 = torch.from_numpy(_spd(rng, (4,), 2))
    _close(tk.inv2x2(S2), jk.inv2x2(jnp.asarray(S2.numpy())), rtol=1e-5,
           atol=0)
    _close(tk.det2x2(S2), jk.det2x2(jnp.asarray(S2.numpy())), rtol=1e-5,
           atol=0)
    S4 = torch.from_numpy(_spd(rng, (4,), 4))
    _close(tk.inv4x4(S4), jk.inv4x4(jnp.asarray(S4.numpy())), rtol=1e-4,
           atol=1e-5)


@pytest.mark.parametrize("seed", range(2))
def test_filter_chain(seed):
    """predict -> precalc -> residuals -> nis -> nllr / nllr_missed."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 50, (6, 5, 4)).astype(np.float32)
    P = _spd(rng, (6, 5), 4)
    z = rng.normal(0, 50, (7, 2)).astype(np.float32)
    pd = rng.uniform(0.5, 0.95, (6, 5)).astype(np.float32)
    A, Q = jpv.Phi(2.5), jpv.Q(2.5)
    C, R = jpv.C_RADAR, jpv.R_RADAR()
    xb_j, Pb_j = jk.predict(A, Q, x, P)
    xb_t, Pb_t = tk.predict(tpv.Phi(2.5), tpv.Q(2.5), torch.from_numpy(x),
                            torch.from_numpy(P))
    _close(xb_t, xb_j)
    _close(Pb_t, Pb_j)
    pj = jk.precalc(C, R, xb_j, Pb_j)
    pt = tk.precalc(tpv.C_RADAR("cpu"), tpv.R_RADAR("cpu"), xb_t, Pb_t)
    for a, b in zip(pt, pj):
        _close(a, b)
    zt_j = jk.residuals(z, pj[0])
    zt_t = tk.residuals(torch.from_numpy(z), pt[0])
    _close(zt_t, zt_j)
    nis_j, nis_t = jk.nis(zt_j, pj[2]), tk.nis(zt_t, pt[2])
    _close(nis_t, nis_j, rtol=1e-4, atol=1e-3)
    for lam in (2e-5, 0.0):
        _close(tk.nllr(lam, torch.from_numpy(pd), pt[1], nis_t),
               jk.nllr(lam, pd, pj[1], nis_j), rtol=1e-4, atol=1e-3)
    _close(tk.nllr_missed(torch.from_numpy(pd)), jk.nllr_missed(pd))

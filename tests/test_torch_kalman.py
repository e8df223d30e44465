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


@pytest.mark.parametrize("seed", range(2))
def test_filter_update_and_nllr_ais(seed):
    """filter_update (one update per residual) and the AIS NLLR on the
    same seeded predictions, 2x2 radar and 4x4 AIS innovations."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 50, (6, 5, 4)).astype(np.float32)
    P = _spd(rng, (6, 5), 4)
    z = rng.normal(0, 50, (7, 2)).astype(np.float32)
    xb_j, Pb_j = jk.predict(jpv.Phi(2.5), jpv.Q(2.5), x, P)
    xb_t, Pb_t = tk.predict(tpv.Phi(2.5), tpv.Q(2.5), torch.from_numpy(x),
                            torch.from_numpy(P))
    pj = jk.precalc(jpv.C_RADAR, jpv.R_RADAR(), xb_j, Pb_j)
    pt = tk.precalc(tpv.C_RADAR("cpu"), tpv.R_RADAR("cpu"), xb_t, Pb_t)
    zt_j = jk.residuals(z, pj[0])
    zt_t = tk.residuals(torch.from_numpy(z), pt[0])
    upd_t = tk.filter_update(xb_t, pt[3], zt_t)
    assert upd_t.shape == (6, 5, 7, 4)
    _close(upd_t, jk.filter_update(xb_j, pj[3], zt_j), rtol=1e-4, atol=1e-3)
    _close(tk.nllr_ais(pt[1], tk.nis(zt_t, pt[2])),
           jk.nllr_ais(pj[1], jk.nis(zt_j, pj[2])), rtol=1e-4, atol=1e-3)
    # the AIS model's full-state innovation
    a = rng.normal(0, 50, (3, 4)).astype(np.float32)
    for hi in (True, False):
        pja = jk.precalc(jais.C, jais.R(hi), xb_j, Pb_j)
        pta = tk.precalc(tais.C("cpu"), tais.R(hi, "cpu"), xb_t, Pb_t)
        nj = jk.nis(jk.residuals(a, pja[0]), pja[2])
        nt = tk.nis(tk.residuals(torch.from_numpy(a), pta[0]), pta[2])
        _close(tk.nllr_ais(pta[1], nt), jk.nllr_ais(pja[1], nj), rtol=1e-4,
               atol=1e-3)
        _close(tk.filter_update(xb_t, pta[3],
                                tk.residuals(torch.from_numpy(a), pta[0])),
               jk.filter_update(xb_j, pja[3], jk.residuals(a, pja[0])),
               rtol=1e-4, atol=1e-3)


def test_public_model_constants():
    from pymht_tpu.models import constants as jc
    from pymht_tpu_torch.models import constants as tc
    for name in ("N_STATE", "N_OBS_RADAR", "N_OBS_AIS", "sigmaR_RADAR_true",
                 "sigmaQ_true", "sigmaR_RADAR_tracker", "sigmaQ_tracker"):
        assert getattr(tc, name) == getattr(jc, name), name
    _close(tpv.H_radar("cpu"), jpv.H_radar, rtol=0, atol=0)
    _close(tpv.GPS_COVARIANCE_PRECISE("cpu"), jpv.GPS_COVARIANCE_PRECISE,
           rtol=0, atol=0)
    _close(tais.C("cpu"), jais.C, rtol=0, atol=0)
    _close(tais.Phi(2.5), jais.Phi(2.5), rtol=0, atol=0)

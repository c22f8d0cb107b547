"""Port parity: IMU preintegration, the PnP factors and motion-only VI PnP,
pvio_torch vs pvio_tpu on the CPU at float64.

Tolerances: preintegration and factor values 1e-12 relative to each
field's magnitude (same recursions, float64, other summation order; the
tree path also pairs in the reference's order); the PnP state after 10
Levenberg-Marquardt iterations 1e-9 (each step's Cholesky solve amplifies
the reassociation differences by the system's condition number).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvio_tpu.estimation import factors as Jf, pnp as Jpnp
from pvio_tpu.geometry import lie as Jlie
from pvio_tpu.imu import preintegration as Jpre
from pvio_tpu.map import window as Jwin
from pvio_tpu.utils.autodiff import value_and_jacfwd as J_vjf
from pvio_torch.estimation import factors as Tf, pnp as Tpnp
from pvio_torch.imu import preintegration as Tpre
from pvio_torch.map import window as Twin
from pvio_torch.utils.autodiff import value_and_jacfwd as T_vjf
from tests.test_torch_geometry import _bench_window
from tests.test_torch_harness import assert_close, assert_rel, t64, tree_to_numpy

torch.set_num_threads(2)
TOL = 1e-12


def _imu(rng, N=64, n=37):
    ts = np.zeros(N)
    ts[:n] = np.sort(rng.uniform(0.0, 0.05, n))
    ws = np.zeros((N, 3))
    accs = np.zeros((N, 3))
    ws[:n] = rng.normal(size=(n, 3)) * 0.8
    accs[:n] = rng.normal(size=(n, 3)) * 2.0 + np.array([0, 0, 9.81])
    mask = np.arange(N) < n
    return ts, ws, accs, mask, 0.0525


def _noise(mod, conv):
    return mod.ImuNoise(*(conv(np.eye(3) * s) for s in (1e-4, 1e-2, 1e-6, 1e-4)))


@pytest.mark.parametrize("assoc", [True, False], ids=["tree", "scan"])
def test_preintegrate_matches_reference(assoc):
    rng = np.random.default_rng(41)
    ts, ws, accs, mask, tt = _imu(rng)
    bg, ba = rng.normal(size=3) * 0.01, rng.normal(size=3) * 0.05
    dj = Jpre.preintegrate(*(jnp.asarray(x) for x in (ts, ws, accs, mask, tt, bg, ba)),
                           _noise(Jpre, jnp.asarray), assoc=assoc)
    dt = Tpre.preintegrate(*(t64(x) for x in (ts, ws, accs, mask, tt, bg, ba)),
                           _noise(Tpre, t64), assoc=assoc)
    for f in Tpre.PreintDelta._fields:
        assert_rel(getattr(dt, f), getattr(dj, f), TOL, f)
    # the port's tree and its scan agree with each other too, to 1e-11: the
    # tree reassociates 37 sequential steps into log-depth products
    ds = Tpre.preintegrate(*(t64(x) for x in (ts, ws, accs, mask, tt, bg, ba)),
                           _noise(Tpre, t64), assoc=not assoc)
    for f in ("q", "p", "v", "cov", "dp_dbg", "dv_dba"):
        assert_rel(getattr(ds, f), getattr(dt, f), 1e-11, f"tree vs scan {f}")
    q2, p2, v2, _, _ = Tpre.predict(dt, *(t64(x) for x in (
        [0.9, 0.1, -0.3, 0.2] / np.linalg.norm([0.9, 0.1, -0.3, 0.2]), [1, 2, 3.0],
        [0.1, 0, -0.2], bg, ba)))
    r2 = Jpre.predict(dj, *(jnp.asarray(x) for x in (
        [0.9, 0.1, -0.3, 0.2] / np.linalg.norm([0.9, 0.1, -0.3, 0.2]), [1, 2, 3.0],
        [0.1, 0, -0.2], bg, ba)))
    for a, b, n in zip((q2, p2, v2), r2, "qpv"):
        assert_close(a, b, TOL, f"predict {n}")


def test_fit_span_and_sqrt_inv_covariance_match_reference():
    rng = np.random.default_rng(42)
    ts = np.sort(rng.uniform(0, 0.3, 151))
    ws, accs = rng.normal(size=(151, 3)), rng.normal(size=(151, 3))
    for a, b in zip(Tpre.fit_span(ts, ws, accs, 0.31, 40), Jpre.fit_span(ts, ws, accs, 0.31, 40)):
        assert np.array_equal(a, b)
    A = rng.normal(size=(15, 15))
    cov = A @ A.T * np.logspace(-8, -2, 15)[:, None] * np.logspace(-8, -2, 15)[None, :] + 1e-14 * np.eye(15)
    assert_rel(Tpre.sqrt_inv_covariance(t64(cov)), Jpre.sqrt_inv_covariance(jnp.asarray(cov)),
               1e-9, "sqrt_inv_cov (condition ~1e6 amplifies reassociation)")


def _frame_states(w, i):
    return tuple(getattr(w, f)[i] for f in ("q", "p", "v", "bg", "ba"))


def test_factors_match_reference():
    _, _, w, extr, _ = _bench_window()
    wt = Twin.window_from_numpy(tree_to_numpy(w), torch.float64)
    et = Twin.extrinsics_from_numpy(tree_to_numpy(extr), torch.float64)
    rng = np.random.default_rng(43)
    # perturbed states so every residual block is non-zero
    bump = [rng.normal(size=4) * 0.01, rng.normal(size=3) * 0.05, rng.normal(size=3) * 0.1,
            rng.normal(size=3) * 1e-3, rng.normal(size=3) * 1e-2]
    si = [np.asarray(x) for x in _frame_states(w, 2)]
    sj = [np.asarray(x) + b for x, b in zip(_frame_states(w, 3), bump)]
    sj[0] = sj[0] / np.linalg.norm(sj[0])
    dj = jax.tree.map(lambda a: a[3], w.delta)
    dt = Tpre.PreintDelta(*(x[3] for x in wt.delta))
    lin_j, lin_t = (w.bg_lin[3] + 1e-3, w.ba_lin[3] - 2e-3), (wt.bg_lin[3] + 1e-3, wt.ba_lin[3] - 2e-3)
    args_j = [jnp.asarray(x) for x in si + sj]
    args_t = [t64(x) for x in si + sj]
    assert_close(Tf.preintegration_residual(*args_t, dt, *lin_t, et),
                 Jf.preintegration_residual(*args_j, dj, *lin_j, extr), TOL, "preint r")
    for a, b, n in zip(Tf.preintegration_residual_and_jacobians(*args_t, dt, *lin_t, et),
                       Jf.preintegration_residual_and_jacobians(*args_j, dj, *lin_j, extr),
                       ("r", "Ji", "Jj")):
        assert_rel(a, b, TOL, f"preint {n}")
    xw = np.asarray(Jwin.landmark_points(w, extr))[:40]
    z = np.asarray(w.kp[3])[:40]
    assert_close(Tf.pose_only_reprojection_residual(t64(sj[0]), t64(sj[1]), t64(xw), t64(z), et, 458.0),
                 jax.vmap(lambda x, zz: Jf.pose_only_reprojection_residual(
                     jnp.asarray(sj[0]), jnp.asarray(sj[1]), x, zz, extr, 458.0))(
                     jnp.asarray(xw), jnp.asarray(z)), TOL, "pose-only reprojection")
    S = np.array([[400.0, 10.0], [0.0, 380.0]])
    r2 = rng.normal(size=(7, 2))
    assert_close(Tf._whiten2(t64(r2), t64(S)), Jf._whiten2(jnp.asarray(r2), jnp.asarray(S)), TOL, "whiten2")
    n = rng.normal(size=(9, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    d, o, b = rng.normal(size=9), rng.normal(size=(9, 3)), rng.normal(size=(9, 3))
    assert_close(Tf.plane_cast_point(t64(n), t64(d), t64(o), t64(b)),
                 Jf.plane_cast_point(*(jnp.asarray(x) for x in (n, d, o, b))), TOL, "plane cast")


def test_value_and_jacfwd_matches_reference():
    x = np.array([0.3, -1.2, 0.7])
    fj = lambda v: jnp.stack([jnp.sin(v[0]) * v[1], v[2] ** 3, jnp.exp(v[0] * v[2])])
    ft = lambda v: torch.stack([torch.sin(v[0]) * v[1], v[2] ** 3, torch.exp(v[0] * v[2])])
    (yj, Jj), (yt, Jt) = J_vjf(fj, jnp.asarray(x)), T_vjf(ft, t64(x))
    assert_close(yt, yj, TOL, "value")
    assert_close(Jt, Jj, TOL, "jacobian")


def test_solve_pnp_matches_reference():
    """Perturbed newest-frame state, noisy keypoints with a few gross
    outliers: the refined (q, p, v, bg, ba) within 1e-9."""
    _, _, w, extr, info = _bench_window()
    new, last = info["n_frames"] - 1, info["n_frames"] - 2
    rng = np.random.default_rng(44)
    xw = Jwin.landmark_points(w, extr)
    obs = np.asarray(w.obs_mask[new] & w.track_mask)
    z = np.asarray(w.kp[new]) + rng.normal(size=w.kp.shape[1:]) * 2e-3
    z[:5] += 0.05
    q0 = Jlie.quat_mul(w.q[new], Jlie.expmap(jnp.asarray(rng.normal(size=3) * 0.01)))
    init = [np.asarray(q0), np.asarray(w.p[new]) + rng.normal(size=3) * 0.03,
            np.asarray(w.v[new]) + rng.normal(size=3) * 0.05,
            np.asarray(w.bg[new]), np.asarray(w.ba[new])]
    last_s = [np.asarray(x) for x in _frame_states(w, last)]
    cfg_j, cfg_t = Jpnp.PnPConfig(kp_sqrt_inv_cov=400.0), Tpnp.PnPConfig(kp_sqrt_inv_cov=400.0)
    dj = jax.tree.map(lambda a: a[new], w.delta)
    wt = Twin.window_from_numpy(tree_to_numpy(w), torch.float64)
    et = Twin.extrinsics_from_numpy(tree_to_numpy(extr), torch.float64)
    dt = Tpre.PreintDelta(*(x[new] for x in wt.delta))
    ref = jax.jit(lambda *a: Jpnp.solve_pnp(*a, extr, cfg_j))(
        *(jnp.asarray(x) for x in init + last_s), dj, w.bg_lin[new], w.ba_lin[new],
        xw, jnp.asarray(z), jnp.asarray(obs))
    out = Tpnp.solve_pnp(*(t64(x) for x in init + last_s), dt, wt.bg_lin[new], wt.ba_lin[new],
                         t64(xw), t64(z), t64(obs), et, cfg_t)
    for a, b, n in zip(out, ref, ("q", "p", "v", "bg", "ba")):
        assert_close(a, b, 1e-9, n)
    assert np.linalg.norm(np.asarray(ref[1]) - np.asarray(w.p[new])) < 5e-3

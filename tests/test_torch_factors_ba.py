"""Port parity of the BA factors, the preintegration factor banks and the
LM solver (`estimation/{factors,preint_soa,validator,ba}.py`, the window's
state updates and `lie.s2_tangential_basis`), pvio_torch vs pvio_tpu on the
CPU at float64.

The windows are the small configuration's (7 frame slots, 96 tracks, 32
members of one plane), built by `synthetic.solver_window_from_scene` +
`flag_plane_tracks` and perturbed as tests/test_ba.py:34 does, planes ON
and OFF. Tolerances: masks, flags and accept decisions identical; factor
values and Jacobians 1e-12 relative to their largest entry (the same
formulas, summed in another order); costs 1e-9 relative; solved states
1e-8.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvio_tpu.estimation import ba as Jba, factors as Jfac
from pvio_tpu.estimation import marginalization as Jmarg, preint_soa as Jsoa
from pvio_tpu.geometry import lie as Jlie
from pvio_tpu.map import window as Jwin
from pvio_torch.estimation import ba as Tba, factors as Tfac, preint_soa as Tsoa
from pvio_torch.estimation import validator as Tval
from pvio_torch.geometry import lie as Tlie
from pvio_torch.io import synthetic as TS
from pvio_torch.imu.preintegration import PreintDelta
from pvio_torch.map import window as Twin
from pvio_torch.utils.autodiff import value_and_jacfwd
from tests.test_torch_harness import assert_close, assert_rel, assert_same, npy, t64, tree_to_numpy

torch.set_num_threads(2)

STATE_FIELDS = ("q", "p", "v", "bg", "ba", "inv_depth", "plane_normal", "plane_distance")


def to_jax(wt):
    """A port window as the reference's WindowState with the same values."""
    from pvio_tpu.imu.preintegration import PreintDelta as JDelta

    def arr(a):
        return jnp.asarray(a.astype(np.int32) if a.dtype.kind == "i" else a)

    d = tree_to_numpy(wt)
    out = {f: arr(d[f]) for f in Jwin.WindowState._fields if f not in ("delta", "prior")}
    out["delta"] = JDelta(**{f: arr(v) for f, v in d["delta"].items()})
    out["prior"] = Jwin.MargPrior(**{f: arr(v) for f, v in d["prior"].items()})
    return Jwin.WindowState(**out)


@functools.lru_cache(maxsize=None)
def small_scene_window():
    """The small configuration's window (7 slots, 96 tracks, 32 members of
    one plane), made by the port's numpy copy of the scene generator (the
    reference's is the same, tests/test_torch_slice.py) and handed to both
    packages. Returns (scene, kf, w_port, extr_port, info)."""
    scene = TS.make_scene(duration=2.0, n_points=200, n_plane_points=80, seed=648)
    kf = [0, 4, 8, 12, 16, 20]
    wt, et, info = TS.solver_window_from_scene(scene, kf, F_cap=7, T_cap=96,
                                               dtype=torch.float64, kp_noise=0.002)
    wt, _ = TS.flag_plane_tracks(wt, scene, info)
    return scene, kf, wt, et, info


@functools.lru_cache(maxsize=None)
def ba_window():
    """The small window perturbed as tests/test_ba.py:34 does (frame 0 kept
    as the gauge), with the reference's initial prior. Returns (scene, kf,
    w_jax, extr_jax, info, w_port, extr_port)."""
    scene, kf, wt0, et, info = small_scene_window()
    w = to_jax(wt0)
    rng = np.random.default_rng(648)
    F, T = w.q.shape[0], w.inv_depth.shape[0]
    dq = rng.normal(size=(F, 3)) * 0.005
    dp = rng.normal(size=(F, 3)) * 0.01
    dq[0] = dp[0] = 0.0
    w = w._replace(q=Jlie.quat_normalize(Jlie.quat_mul(w.q, Jlie.expmap(jnp.asarray(dq)))),
                   p=w.p + dp, v=w.v + rng.normal(size=(F, 3)) * 0.02,
                   inv_depth=w.inv_depth + rng.normal(size=T) * 0.02)
    w = w._replace(prior=Jmarg.make_initial_prior(w))
    return scene, kf, w, Jwin.Extrinsics.identity(jnp.float64), info, to_port(w), et


def to_port(w):
    return Twin.window_from_numpy(tree_to_numpy(w), torch.float64)


def bacfg(planes, **kw):
    c = Jba.BAConfig(iterations=8, kp_sqrt_inv_cov=200.0, use_planes=planes, **kw)
    return c, Tba.BAConfig(**c._asdict())


def rich_extrinsics():
    """Non-trivial extrinsics (as tests/test_analytic_jacobians.py) for the
    factor tests, so every extrinsic term is exercised."""
    e = Jwin.Extrinsics(q_bc=Jlie.expmap(jnp.asarray([0.03, -0.02, 0.7])),
                        p_bc=jnp.asarray([0.02, -0.06, 0.01]),
                        q_bi=Jlie.expmap(jnp.asarray([0.01, 0.02, -0.015])),
                        p_bi=jnp.asarray([0.005, 0.01, -0.02]))
    return e, Twin.extrinsics_from_numpy(tree_to_numpy(e), torch.float64)


def assert_window_close(wt, wj, tol, what=""):
    for f in STATE_FIELDS:
        assert_close(getattr(wt, f), getattr(wj, f), tol, f"{what} {f}")


# ---------------------------------------------------------------------------


def test_s2_tangential_basis_matches_reference():
    """Random normals and the axis-aligned ones, whose |x| ties make
    argmin's first-index rule decide the basis: (0, 0, 1) takes the x axis
    in both packages."""
    rng = np.random.default_rng(3)
    n = rng.normal(size=(20, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    axes = np.array([[0, 0, 1.0], [0, 0, -1.0], [1.0, 0, 0], [0, 1.0, 0],
                     [np.sqrt(0.5), np.sqrt(0.5), 0]])
    x = np.concatenate([n, axes])
    assert_close(Tlie.s2_tangential_basis(t64(x)), jax.jit(Jlie.s2_tangential_basis)(jnp.asarray(x)),
                 1e-12, "basis")
    B = Tlie.s2_tangential_basis(t64(np.array([0, 0, 1.0])))
    assert_close(B[:, 0], np.array([0, 1.0, 0]), 0.0, "(0, 0, 1) crosses the x axis")


def test_window_updates_match_reference():
    """retract, retract_planes, frame_states_flat, triangulate_tracks (points
    and depths where the gate passes, the gate identical) and
    track_baselines."""
    _, _, w, extr, _, wt, et = ba_window()
    rng = np.random.default_rng(4)
    F, T, P = w.q.shape[0], w.inv_depth.shape[0], w.plane_mask.shape[0]
    df, dd = rng.normal(size=(F, 15)) * 0.01, rng.normal(size=T) * 0.01
    dpl = rng.normal(size=(P, 3)) * 0.01

    @jax.jit
    def ref(w, df, dd, dpl):
        return (Jwin.retract(w, df, dd), Jwin.retract_planes(w, dpl), Jwin.frame_states_flat(w),
                Jwin.triangulate_tracks(w, extr), Jwin.track_baselines(w))

    rj, rpj, flat, (pa, da, oka), base = ref(w, jnp.asarray(df), jnp.asarray(dd), jnp.asarray(dpl))
    assert_window_close(Twin.retract(wt, t64(df), t64(dd)), rj, 1e-12, "retract")
    assert_window_close(Twin.retract_planes(wt, t64(dpl)), rpj, 1e-12, "retract_planes")
    assert_close(Twin.frame_states_flat(wt), flat, 0.0, "flat")
    pb, db, okb = Twin.triangulate_tracks(wt, et)
    assert_same(okb, oka, "tri ok")
    ok = npy(oka)
    assert ok.sum() >= 80
    assert_close(npy(pb)[ok], npy(pa)[ok], 1e-10, "tri points")
    assert_close(npy(db)[ok], npy(da)[ok], 1e-10, "tri inv_d")
    assert_close(Twin.track_baselines(wt), base, 1e-12, "baselines")


def test_ba_factors_match_reference():
    """Inverse-depth reprojection over the (F, T) grid, the marginalization
    residual and Jacobian, _sym3_inv, the DLT rows, the augmented plane
    residual per track and its batched analytic Jacobians (pose and plane)."""
    _, _, w, _, _, wt, _ = ba_window()
    ej, et = rich_extrinsics()
    rng = np.random.default_rng(5)
    F, T = w.q.shape[0], w.inv_depth.shape[0]
    dq = rng.normal(size=(F, 3)) * 0.01
    A = rng.normal(size=(30, 5, 3))
    M = np.einsum("nri,nrj->nij", A, A)
    M[:3] += np.einsum("i,j->ij", [1.0, 2, 3], [1.0, 2, 3]) * 1e4   # condition ~1e5
    nrm = np.array([0.05, -0.03, 1.0])
    nrm /= np.linalg.norm(nrm)
    normals = np.tile(nrm, (T, 1))
    dists = 4.6 + rng.normal(size=T) * 0.05
    cols = (0, 5, 40)

    @jax.jit
    def ref(w, dq, M, normals, dists):
        q_ref, p_ref, z_ref = Jba._gather_track_inputs(w)
        rj = jax.vmap(jax.vmap(
            lambda qt, pt, zt, qr, pr, zr, d: Jfac.reprojection_residual(
                qt, pt, qr, pr, d, zr, zt, ej, 283.0),
            in_axes=(None, None, 0, 0, 0, 0, 0)), in_axes=(0, 0, 0, None, None, None, None))(
            w.q, w.p, w.kp, q_ref, p_ref, z_ref, w.inv_depth)
        prior = Jmarg.make_initial_prior(w, yaw_only=False)
        q2 = Jlie.quat_normalize(Jlie.quat_mul(w.q, Jlie.expmap(dq)))
        args = (q2, w.p + 0.02, w.v, w.bg, w.ba)
        marg = (Jfac.marginalization_residual_and_jacobian(*args, prior),
                Jfac.marginalization_residual(*args, prior), prior, q2)
        obs = w.obs_mask & w.frame_mask[:, None]
        rows = [Jfac.plane_point_rows(w.q, w.p, w.kp[:, c], obs[:, c], ej) for c in cols]
        rpl = jax.vmap(lambda k, m, n, dd: Jfac.augmented_plane_distance_residual(
            w.q, w.p, k, m, n, dd, ej, 100.0), in_axes=(1, 1, 0, 0))(w.kp, obs, normals, dists)
        jac = Jfac.augmented_plane_residual_and_pose_jacobian(
            w.q, w.p, w.kp, obs, normals, dists, ej, 100.0, with_plane_jacobian=True)
        return rj, marg, Jfac._sym3_inv(M), rows, rpl, jac

    rj, ((r_j, J_j), rm_j, prior, q2), inv_j, rows_j, rpl_j, jac_j = ref(
        w, jnp.asarray(dq), jnp.asarray(M), jnp.asarray(normals), jnp.asarray(dists))

    qt, pt, qr, pr, d, zr, zt = Tba._grid_args(wt)
    assert_rel(Tfac.reprojection_residual(qt, pt, qr, pr, d, zr, zt, et, 283.0), rj, 1e-12,
               "reprojection")
    prior_t = Twin.window_from_numpy(tree_to_numpy(w._replace(prior=prior)), torch.float64).prior
    args_t = (t64(q2), wt.p + 0.02, wt.v, wt.bg, wt.ba)
    r_t, J_t = Tfac.marginalization_residual_and_jacobian(*args_t, prior_t)
    assert_rel(r_t, r_j, 1e-12, "marg r")
    assert_rel(J_t, J_j, 1e-12, "marg J")
    assert_rel(Tfac.marginalization_residual(*args_t, prior_t), rm_j, 1e-12, "marg residual")
    # the adjugate's cancellations amplify rounding (XLA fuses multiply-adds
    # in the jitted reference) by the condition number: 1e-12 on the
    # well-conditioned matrices, 1e-8 on the three at condition ~1e5
    assert_rel(Tfac._sym3_inv(t64(M))[3:], inv_j[3:], 1e-12, "sym3_inv f64")
    assert_rel(Tfac._sym3_inv(t64(M))[:3], inv_j[:3], 1e-8, "sym3_inv f64, cond 1e5")
    M32 = torch.as_tensor(M, dtype=torch.float32)
    assert_rel(Tfac._sym3_inv(M32)[3:], jax.jit(Jfac._sym3_inv)(jnp.asarray(M, jnp.float32))[3:],
               1e-5, "sym3_inv f32 (ridge 1e-7)")

    obs_t = wt.obs_mask & wt.frame_mask[:, None]
    for c, (Aj, bj) in zip(cols, rows_j):
        At, bt = Tfac.plane_point_rows(wt.q, wt.p, wt.kp[:, c], obs_t[:, c], et)
        assert_rel(At, Aj, 1e-12, "rows A")
        assert_rel(bt, bj, 1e-12, "rows b")
    rpl_t = Tfac.augmented_plane_distance_residual(wt.q, wt.p, wt.kp.transpose(0, 1), obs_t.T,
                                                   t64(normals), t64(dists), et, 100.0)
    assert_rel(rpl_t, rpl_j, 1e-12, "plane residual")
    out_t = Tfac.augmented_plane_residual_and_pose_jacobian(
        wt.q, wt.p, wt.kp, obs_t, t64(normals), t64(dists), et, 100.0, with_plane_jacobian=True)
    for name, a, b in zip(("r", "J pose", "J plane"), out_t, jac_j):
        assert_rel(a, b, 1e-12, f"plane {name}")
    assert_rel(out_t[0], rpl_t, 1e-12, "batched vs per-track residual")


def test_solve_augmented_point_jvp_matches_reference():
    """The custom JVP as a torch.autograd.Function: torch.func.jvp against
    jax.jvp of the reference's custom_jvp and against central differences;
    jacfwd and vmap go through it."""
    rng = np.random.default_rng(6)
    A, b = rng.normal(size=(4, 9, 3)), rng.normal(size=(4, 9))
    dA, db = rng.normal(size=A.shape), rng.normal(size=b.shape)
    xj, dxj = jax.jvp(Jfac._solve_augmented_point, (jnp.asarray(A), jnp.asarray(b)),
                      (jnp.asarray(dA), jnp.asarray(db)))
    xt, dxt = torch.func.jvp(Tfac._solve_augmented_point, (t64(A), t64(b)), (t64(dA), t64(db)))
    assert_rel(xt, xj, 1e-12, "x")
    assert_rel(dxt, dxj, 1e-12, "dx")
    e = 1e-6
    fd = (Tfac._solve_augmented_point(t64(A + e * dA), t64(b + e * db))
          - Tfac._solve_augmented_point(t64(A - e * dA), t64(b - e * db))) / (2 * e)
    assert_rel(dxt, fd, 1e-6, "dx vs central differences")
    Jt = torch.func.vmap(torch.func.jacfwd(Tfac._solve_augmented_point))(t64(A), t64(b))
    assert_rel(Jt, jax.vmap(jax.jacfwd(Jfac._solve_augmented_point))(jnp.asarray(A), jnp.asarray(b)),
               1e-12, "vmap(jacfwd)")


def _preint_inputs(seed):
    """A window's consecutive-frame states, perturbed (biases away from
    their linearization point too) so every Jacobian block is non-zero."""
    _, _, w, _, _, _, _ = ba_window()
    rng = np.random.default_rng(seed)
    F = w.q.shape[0]
    w = w._replace(
        q=Jlie.quat_normalize(Jlie.quat_mul(w.q, Jlie.expmap(jnp.asarray(rng.normal(size=(F, 3)) * 0.02)))),
        p=w.p + rng.normal(size=(F, 3)) * 0.01, v=w.v + rng.normal(size=(F, 3)) * 0.02,
        bg=w.bg + rng.normal(size=(F, 3)) * 0.003, ba=w.ba + rng.normal(size=(F, 3)) * 0.01)
    return w, to_port(w)


def test_preint_factor_banks_match_reference():
    """Both preintegration paths (the batched analytic Jacobians the BA
    takes on the CPU, the struct-of-arrays bank it takes off the CPU)
    against the reference's, and the two port paths against each other,
    which the reference claims but does not test."""
    w, wt = _preint_inputs(7)
    ej, et = rich_extrinsics()

    @jax.jit
    def ref(w):
        batched = jax.vmap(lambda *a: Jfac.preintegration_residual_and_jacobians(*a, ej))(
            w.q[:-1], w.p[:-1], w.v[:-1], w.bg[:-1], w.ba[:-1], w.q[1:], w.p[1:], w.v[1:],
            w.bg[1:], w.ba[1:], jax.tree.map(lambda a: a[1:], w.delta), w.bg_lin[1:],
            w.ba_lin[1:])
        return batched, Jsoa.preint_factor_bank_soa(w.q, w.p, w.v, w.bg, w.ba, w.delta,
                                                    w.bg_lin, w.ba_lin, ej)

    ref_batched, ref_soa = ref(w)
    port_batched = Tba.preint_factors(wt, et)
    port_soa = Tsoa.preint_factor_bank_soa(wt.q, wt.p, wt.v, wt.bg, wt.ba, wt.delta,
                                           wt.bg_lin, wt.ba_lin, et)
    live = npy(wt.delta_valid)[1:]
    assert live.sum() >= 5
    for name, a, b, c, d in zip(("r", "Ji", "Jj"), port_batched, ref_batched, port_soa, ref_soa):
        assert_rel(npy(a)[live], npy(b)[live], 1e-12, f"batched {name}")
        assert_rel(npy(c)[live], npy(d)[live], 1e-12, f"soa {name}")
        assert_rel(npy(c)[live], npy(a)[live], 1e-12, f"soa vs batched {name}")


def test_analytic_jacobians_match_port_autodiff():
    """The CostFunctionValidator role inside the port (`validator.py`): the
    analytic preintegration, marginalization and augmented-plane Jacobians
    against the port's own forward-mode autodiff through the retraction
    (the plane one through the custom JVP), the reprojection factor against
    central differences, and the dependency check clean on the real
    Jacobian and firing on one with a dropped term."""
    w, wt = _preint_inputs(8)
    _, et = rich_extrinsics()
    k = 2
    d = PreintDelta(*(a[k] for a in wt.delta))
    si = (wt.q[k - 1], wt.p[k - 1], wt.v[k - 1], wt.bg[k - 1], wt.ba[k - 1])
    sj = (wt.q[k], wt.p[k], wt.v[k], wt.bg[k], wt.ba[k])
    r, Ji, Jj = Tfac.preintegration_residual_and_jacobians(*si, *sj, d, wt.bg_lin[k],
                                                           wt.ba_lin[k], et)

    def preint_t(d30):
        return Tba._preint_residual_t(d30, *si, *sj, d, wt.bg_lin[k], wt.ba_lin[k], et)

    r_ad, J_ad = value_and_jacfwd(preint_t, torch.zeros(30, dtype=torch.float64))
    assert_close(r, r_ad, 1e-12, "preint r")
    J_an = torch.cat([Ji, Jj], dim=1)
    assert float(((J_an - J_ad).abs() / J_ad.abs().clamp(min=1.0)).max()) < 1e-6

    d_id = d._replace(sqrt_inv_cov=torch.eye(15, dtype=torch.float64))

    def preint_id(d30):
        return Tba._preint_residual_t(d30, *si, *sj, d_id, wt.bg_lin[k], wt.ba_lin[k], et)

    _, Ji1, Jj1 = Tfac.preintegration_residual_and_jacobians(*si, *sj, d_id, wt.bg_lin[k],
                                                             wt.ba_lin[k], et)
    J1 = torch.cat([Ji1, Jj1], dim=1).numpy()
    assert Tval.check_dependencies(preint_id, J1, 30) == []
    broken = J1.copy()
    broken[0:3, 9:12] = 0.0
    assert any(i < 3 and 9 <= s < 12 for i, s in Tval.check_dependencies(preint_id, broken, 30))

    _, _, wj, _, _, wp, _ = ba_window()
    rm, Jm = Tfac.marginalization_residual_and_jacobian(wp.q, wp.p, wp.v, wp.bg, wp.ba, wp.prior)
    rm_ad, Jm_ad = value_and_jacfwd(lambda x: Tba._marg_residual_t(x, wp),
                                    torch.zeros(wp.q.shape[0] * 15, dtype=torch.float64))
    assert_close(rm, rm_ad, 1e-12, "marg r")
    assert float((Jm - Jm_ad).abs().max()) < 1e-8

    rep = Tval.validate_factor(lambda d13: Tba._repro_residual_t(
        d13, wp.q[1], wp.p[1], wp.q[0], wp.p[0], wp.inv_depth[0], wp.kp[0, 0], wp.kp[1, 0],
        et, 283.0), 13)
    assert rep.passed, str(rep)

    obs = wp.obs_mask & wp.frame_mask[:, None]
    T = wp.inv_depth.shape[0]
    nrm = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64)
    r_pl, J_pl = Tfac.augmented_plane_residual_and_pose_jacobian(
        wp.q, wp.p, wp.kp, obs, nrm.expand(T, 3), torch.full((T,), 4.6, dtype=torch.float64),
        et, 100.0)
    F = wp.q.shape[0]
    for c in (0, 7):
        r_ad, J_ad = value_and_jacfwd(lambda x: Tba._plane_residual_t(
            x, wp.q, wp.p, wp.kp[:, c], obs[:, c], nrm, torch.tensor(4.6, dtype=torch.float64),
            et, 100.0), torch.zeros(F * 6, dtype=torch.float64))
        assert_close(r_pl[c], r_ad, 1e-12, "plane r")
        assert_rel(J_pl[c].reshape(-1), J_ad, 1e-7, "plane J vs custom-JVP autodiff")


@pytest.mark.parametrize("planes", [False, True])
def test_linearize_and_cost_match_reference(planes):
    """The Gauss-Newton system and the cost of the perturbed window (with
    its initial prior), on both preintegration paths."""
    _, _, w, extr, _, wt, et = ba_window()
    cj, ct = bacfg(planes)
    ref, cost_j, masks_j, dims_j = jax.jit(lambda w_: (
        Jba.linearize(w_, extr, cj), Jba.evaluate_cost(w_, extr, cj),
        Jba._factor_masks(w_, cj), Jba._active_dims(w_)))(w)
    for fused in (False, True):
        out = Tba.linearize(wt, et, ct._replace(fused_preint=fused))
        for name, a, b in zip(("H", "Hpd", "Hdd", "b", "bd"), out[:5], ref[:5]):
            assert_rel(a, b, 1e-12, f"{name} fused={fused}")
        assert_same(out[5], ref[5], "depth_active")
        assert_same(out[7], ref[7], "dims")
        assert_rel(out[6], ref[6], 1e-9, "linearize cost")
    if planes:
        assert out[0].shape[0] == 7 * 15 + 8 * 3 and float(out[7][105:].sum()) == 3.0
    assert_rel(Tba.evaluate_cost(wt, et, ct), cost_j, 1e-9, "cost")
    for a, b in zip(Tba._factor_masks(wt, ct), masks_j):
        assert_same(a, b, "factor masks")
    assert_same(Tba._active_dims(wt), dims_j, "active dims")


def _chain_lm(step, w, lam, cfg, where):
    """solve's loop, step by step: per-iteration (cost0, cost1, accept)."""
    hist = []
    for _ in range(cfg.iterations):
        w_new, c0, c1 = step(w, lam)
        acc = bool(c1 < c0)
        hist.append((float(c0), float(c1), acc))
        lam = max(lam * cfg.lm_lambda_down, cfg.lm_lambda_min) if acc else min(
            lam * cfg.lm_lambda_up, cfg.lm_lambda_max)
        w = where(acc, w_new, w)
    return w, hist


@pytest.mark.parametrize("planes", [False, True])
def test_solve_matches_reference(planes):
    """The LM solve: per-iteration costs (1e-9 relative) and accept flags
    (identical) of the chained `_lm_step` in both packages, the port's
    `solve` against the reference's chain (states 1e-8), and its info."""
    _, _, w, extr, _, wt, et = ba_window()
    cj, ct = bacfg(planes)
    step_j = jax.jit(lambda w_, lam: Jba._lm_step(w_, extr, cj, lam))
    wj_end, hist_j = _chain_lm(lambda w_, lam: step_j(w_, jnp.asarray(lam)), w,
                               cj.lm_lambda_init, cj, lambda a, n, o: n if a else o)
    wt_end, hist_t = _chain_lm(
        lambda w_, lam: Tba._lm_step(w_, et, ct, torch.tensor(lam, dtype=torch.float64)),
        wt, ct.lm_lambda_init, ct, lambda a, n, o: n if a else o)
    assert [h[2] for h in hist_t] == [h[2] for h in hist_j]
    assert sum(h[2] for h in hist_j) >= 6
    for (a0, a1, _), (b0, b1, _) in zip(hist_t, hist_j):
        assert abs(a0 - b0) <= 1e-9 * abs(b0) and abs(a1 - b1) <= 1e-9 * abs(b1)
    assert_window_close(wt_end, wj_end, 1e-8, "chained")
    ws, info = Tba.solve(wt, et, ct)
    assert_window_close(ws, wj_end, 1e-8, "solve")
    assert int(info["accepted"]) == sum(h[2] for h in hist_j)
    assert abs(float(info["initial_cost"]) - hist_j[0][0]) <= 1e-9 * hist_j[0][0]
    last = hist_j[-1]
    assert abs(float(info["final_cost"]) - (last[1] if last[2] else last[0])) <= 1e-9 * last[0]
    assert float(info["final_cost"]) < 0.2 * float(info["initial_cost"])


def test_cholesky_failure_rejects_the_step(monkeypatch):
    """A NaN in the reduced camera system: the reference's cho_factor gives
    NaNs, the NaN cost fails `cost1 < cost0` and the step is rejected. The
    port's `cholesky_or_nan` must do the same, neither raise nor accept a
    step built from a partial finite factor; an indefinite system likewise."""
    _, _, w, extr, _, wt, et = ba_window()
    cj, ct = bacfg(False)
    cj, ct = cj._replace(iterations=1), ct._replace(iterations=1)
    lin_j, lin_t = Jba.linearize, Tba.linearize

    def poisoned(lin, mutate):
        def f(*a, **k):
            out = list(lin(*a, **k))
            out[0] = mutate(out[0])
            return tuple(out)
        return f

    def nan_at(H):
        H = H.clone()
        H[3, 3] = torch.nan
        return H

    def indefinite(H):
        return H - 1e12 * torch.eye(H.shape[0], dtype=H.dtype)

    monkeypatch.setattr(Jba, "linearize", poisoned(lin_j, lambda H: H.at[3, 3].set(jnp.nan)))
    _, ij = Jba.solve(w, extr, cj)
    assert int(ij["accepted"]) == 0 and float(ij["lambda"]) == 4e-4
    for mutate in (nan_at, indefinite):
        monkeypatch.setattr(Tba, "linearize", poisoned(lin_t, mutate))
        _, c0, c1 = Tba._lm_step(wt, et, ct, torch.tensor(1e-4, dtype=torch.float64))
        assert torch.isnan(c1) and not bool(c1 < c0)
        ws, it = Tba.solve(wt, et, ct)
        assert int(it["accepted"]) == 0
        assert float(it["lambda"]) == 4e-4
        assert_window_close(ws, w, 0.0, "a rejected step keeps the state")
        assert abs(float(it["final_cost"]) - float(ij["final_cost"])) <= 1e-9 * float(ij["final_cost"])


def test_nanmedian_averages_an_even_count():
    """The escape's per-plane common-mode offset is `jnp.nanmedian`, which
    averages the two middle values of an even count; `torch.nanmedian`
    returns the lower one. The port's masked median follows JAX on even,
    odd and empty rows."""
    rng = np.random.default_rng(9)
    vals = rng.normal(size=(5, 12))
    vals[0, 6:] = np.nan          # 6 members: even
    vals[1, 7:] = np.nan          # 7 members: odd
    vals[2, :] = np.nan           # no member
    vals[3, ::3] = np.nan         # 8 members, NaNs interleaved
    ref = np.asarray(jax.jit(lambda v: jnp.nanmedian(v, axis=-1))(jnp.asarray(vals)))
    got = Tba._nanmedian_rows(t64(vals)).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    ok = ~np.isnan(ref)
    assert np.array_equal(got[ok], ref[ok])
    lower = torch.nanmedian(t64(vals), dim=-1).values.numpy()
    assert got[0] != lower[0] and got[3] != lower[3] and got[1] == lower[1]


@functools.lru_cache(maxsize=None)
def escape_setup():
    """A wrongly adopted plane track, built on the JAX side as
    tests/test_planes.py:257-313 does: the plane scene's ground-truth host
    window (filled from the port's copy of the scene generator, as
    `make_host_window` fills it), its plane found by the reference's
    PlaneExtractor, and one genuinely off-plane track force-adopted onto it
    (`_corrupt_adoption`). Returns (cfg, hw, extr, info, scene, slot, col)."""
    from pvio_tpu.core.host_window import HostWindow
    from pvio_tpu.core.kernels import DeviceKernels
    from pvio_tpu.core.plane_extractor import PlaneExtractor
    from tests.test_planes import _corrupt_adoption, plane_config

    cfg = plane_config()
    cfg.plane_escape_min_life = 4      # <= 6 observations per track in this window
    kf = [0, 4, 8, 12, 16, 20]
    scene = TS.make_scene(duration=3.0, fps=20.0, imu_rate=200.0, n_points=60,
                          n_plane_points=130, plane_z=4.6, seed=648)
    wt, _, info = TS.solver_window_from_scene(scene, kf, F_cap=cfg.window_frame_capacity,
                                              T_cap=cfg.track_capacity,
                                              P_cap=cfg.plane_capacity, dtype=torch.float64)
    hw = HostWindow(cfg.window_frame_capacity, cfg.track_capacity, cfg.plane_capacity,
                    np.float64)
    for f in ("q", "p", "v", "frame_mask", "kp", "obs_mask", "ref_frame", "track_mask",
              "track_flags", "inv_depth"):
        setattr(hw, f, npy(getattr(wt, f)).astype(getattr(hw, f).dtype))
    hw.frame_t[:len(kf)] = scene.frame_t[kf]
    hw.track_life = np.array(npy(wt.obs_mask).sum(axis=0), np.int32)
    hw.quality[:] = 0.1
    kern = DeviceKernels(cfg)
    pe = PlaneExtractor(cfg, kern)
    pe.update_map(hw)
    assert hw.plane_mask.sum() == 1
    s = int(np.nonzero(hw.plane_mask)[0][0])
    c, _ = _corrupt_adoption(hw, pe, info, scene, s)
    return cfg, hw, kern.extr, info, scene, s, c


def _escape_pair(hw, extr, **kw):
    w = hw.to_device()
    life = jnp.asarray(hw.track_life)
    wj = jax.jit(lambda w_, l_: Jba.plane_track_escape(w_, extr, l_, **kw))(w, life)
    wt = Tba.plane_track_escape(to_port(w), Twin.extrinsics_from_numpy(tree_to_numpy(extr),
                                                                      torch.float64),
                                torch.as_tensor(hw.track_life), **kw)
    for f in ("track_flags", "plane_id"):
        assert_same(getattr(wt, f), getattr(wj, f), f)
    assert_close(wt.inv_depth, wj.inv_depth, 1e-8, "inv_depth")
    return npy(wt.track_flags)


def test_plane_track_escape_matches_reference():
    """The escape with the fixed 0.1 m gate and with the sigma gate, on the
    corrupted adoption (which escapes), and with the sigma gate on four
    members re-observed 9 cm off the plane (below the fixed gate), on a
    plane whose member count is made even so the median averages."""
    from pvio_tpu.geometry import nplie

    cfg, hw, extr, _, _, s, c = escape_setup()
    K = cfg.K
    gate = dict(min_life=cfg.plane_escape_min_life, escape_dist=cfg.plane_escape_distance)
    sigma = dict(gate, kp_sigma_px=float(np.sqrt(np.mean(np.diag(cfg.camera_noise_cov)))),
                 f_px=float(0.5 * (K[0, 0] + K[1, 1])), sigma_k=3.0, dist_floor=0.005)
    for kw in (gate, sigma):
        flags = _escape_pair(hw, extr, **kw)
        assert not flags[c] & Twin.TF_PLANE and flags[c] & Twin.TF_VALID

    hw = copy.deepcopy(hw)
    members = np.nonzero((hw.plane_id == s) & hw.track_mask
                         & ((hw.track_flags & Twin.TF_PLANE) != 0))[0]
    if len(members) % 2:
        hw.plane_id[members[-1]] = -1
        hw.track_flags[members[-1]] &= ~Twin.TF_PLANE
        members = members[:-1]
    n_obs = (hw.obs_mask & hw.frame_mask[:, None]).sum(axis=0)
    bad = [m for m in members if n_obs[m] >= 5 and m != c][:4]
    n_pl = hw.plane_normal[s]
    q_bc, p_bc = np.asarray(cfg.q_bc), np.asarray(cfg.p_bc)
    for col in bad:        # re-observe a point 9 cm off the plane
        ref = hw.ref_frame[col]
        q_wc = nplie.quat_mul(hw.q[ref], q_bc)
        o = hw.p[ref] + nplie.quat_to_mat(hw.q[ref]) @ p_bc
        x = o + nplie.quat_to_mat(q_wc) @ (np.concatenate([hw.kp[ref, col], [1.0]])
                                          / hw.inv_depth[col]) + 0.09 * n_pl
        for f in np.nonzero(hw.obs_mask[:, col] & hw.frame_mask)[0]:
            q_wc = nplie.quat_mul(hw.q[f], q_bc)
            o = hw.p[f] + nplie.quat_to_mat(hw.q[f]) @ p_bc
            y = nplie.quat_to_mat(q_wc).T @ (x - o)
            hw.kp[f, col] = y[:2] / y[2]
    assert len(bad) == 4 and len(members) % 2 == 0
    flags = _escape_pair(hw, extr, **sigma)
    assert all(not flags[b] & Twin.TF_PLANE for b in bad)
    flags = _escape_pair(hw, extr, **gate)
    assert all(flags[b] & Twin.TF_PLANE for b in bad)


def test_post_solve_update_matches_reference():
    """Depth gate and quality after a solve, with one track pushed behind
    the cameras (it loses TF_VALID) and one beyond max_z."""
    _, _, w, extr, _, _, et = ba_window()
    K = np.array([[200.0, 0, 160], [0, 200.0, 120], [0, 0, 1]])
    w = w._replace(inv_depth=w.inv_depth.at[2].set(-0.5).at[9].set(0.01))
    wj = jax.jit(lambda w_: Jba.post_solve_update(w_, extr, jnp.asarray(K)))(w)
    wt = Tba.post_solve_update(to_port(w), et, t64(K))
    assert_same(wt.track_flags, wj.track_flags, "flags")
    assert_close(wt.quality, wj.quality, 1e-10, "quality px")
    flags = npy(wt.track_flags)
    assert not flags[2] & Twin.TF_VALID and not flags[9] & Twin.TF_VALID and flags[3] & Twin.TF_VALID

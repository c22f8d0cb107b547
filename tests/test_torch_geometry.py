"""Port parity: geometry (lie, camera, triangulation) and the window's
virtual-view triangulation, pvio_torch vs pvio_tpu on the CPU at float64.

Tolerance 1e-12 (relative to max(1, |ref|)) for values: the same formulas
in float64 differ only by summation order. Masks are identical.
"""

import functools

import jax.numpy as jnp
import numpy as np
import torch

from pvio_tpu.geometry import camera as Jcam, lie as Jlie, triangulation as Jtri
from pvio_tpu.map import window as Jwin
from pvio_torch.geometry import camera as Tcam, lie as Tlie, triangulation as Ttri
from pvio_torch.map import window as Twin
from tests.test_torch_harness import assert_close, assert_same, t64, tree_to_numpy

torch.set_num_threads(2)
TOL = 1e-12


def _rand_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_lie_ops_match_reference():
    rng = np.random.default_rng(11)
    n = 40
    q1, q2 = _rand_quats(rng, n), _rand_quats(rng, n)
    v = rng.normal(size=(n, 3))
    # rotation vectors spanning the Taylor branch, small and large angles
    w = rng.normal(size=(n, 3)) * np.repeat([1e-9, 1e-4, 0.3, 2.5], n // 4)[:, None]
    J = lambda f, *a: f(*(jnp.asarray(x) for x in a))
    T = lambda f, *a: f(*(t64(x) for x in a))
    for name, args in [("quat_mul", (q1, q2)), ("quat_conj", (q1,)),
                       ("quat_normalize", (q1 * 3.0,)), ("quat_rotate", (q1, v)),
                       ("quat_to_mat", (q1,)), ("expmap", (w,)), ("logmap", (q1,)),
                       ("hat", (v,)), ("right_jacobian", (w,)),
                       ("right_jacobian_inv", (w,))]:
        assert_close(T(getattr(Tlie, name), *args), J(getattr(Jlie, name), *args), TOL, name)
    A, B = rng.normal(size=(n, 3, 3)), rng.normal(size=(n, 3, 3))
    assert_close(Tlie.mm(t64(A), t64(B)), Jlie.mm(jnp.asarray(A), jnp.asarray(B)), TOL, "mm")
    assert_close(Tlie.mv(t64(A), t64(v)), Jlie.mv(jnp.asarray(A), jnp.asarray(v)), TOL, "mv")
    # logmap of the w < 0 hemisphere and of w == 0
    qn = q1.copy()
    qn[:5, 0] = -np.abs(qn[:5, 0])
    qn[5, 0] = 0.0
    assert_close(Tlie.logmap(t64(qn)), Jlie.logmap(jnp.asarray(qn)), TOL, "logmap w<=0")


def test_camera_ops_match_reference():
    rng = np.random.default_rng(12)
    K = np.array([[458.654, 0, 367.215], [0, 457.296, 248.375], [0, 0, 1.0]])
    p2 = rng.normal(size=(30, 2))
    px = rng.uniform(0, 700, size=(30, 2))
    p3 = rng.normal(size=(30, 3))
    p3[:3, 2] = [0.0, 1e-13, -1e-13]          # the z == 0 guard
    assert_close(Tcam.apply_k(t64(p2), t64(K)), Jcam.apply_k(jnp.asarray(p2), jnp.asarray(K)), TOL)
    assert_close(Tcam.remove_k(t64(px), t64(K)), Jcam.remove_k(jnp.asarray(px), jnp.asarray(K)), TOL)
    assert_close(Tcam.project(t64(p3)), Jcam.project(jnp.asarray(p3)), TOL)
    p3[:3, 2] = 1.0
    assert_close(Tcam.dproj_dp(t64(p3)), Jcam.dproj_dp(jnp.asarray(p3)), TOL)


def _views(rng, T, F):
    """Random camera poses looking at random points; some observations
    masked out, some points behind a camera (invalid)."""
    q = _rand_quats(rng, F) * np.array([1.0, 0.05, 0.05, 0.05])
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    p = rng.normal(size=(F, 3)) * 0.3
    X = rng.normal(size=(T, 3)) + np.array([0, 0, 4.0])
    X[:3, 2] = -2.0
    R = np.asarray(Jlie.quat_to_mat(jnp.asarray(q)))
    Rsw = np.transpose(R, (0, 2, 1))
    tsw = -np.einsum("fij,fj->fi", Rsw, p)
    Ps = np.concatenate([Rsw, tsw[..., None]], axis=-1)
    y = np.einsum("fij,tj->tfi", Rsw, X) + tsw[None]
    xs = y[..., :2] / y[..., 2:3] + rng.normal(size=(T, F, 2)) * 1e-3
    mask = rng.uniform(size=(T, F)) < 0.8
    return Ps, xs, mask


def test_triangulate_scored_matches_reference():
    """Points and scores within 1e-12 where valid, validity identical; the
    invalid direction's sign is arbitrary (eigh), so only its flag counts."""
    rng = np.random.default_rng(13)
    Ps, xs, mask = _views(rng, 50, 6)
    pa, va, sa = Jtri.triangulate_scored(jnp.asarray(Ps)[None], jnp.asarray(xs), jnp.asarray(mask))
    pb, vb, sb = Ttri.triangulate_scored(t64(Ps)[None], t64(xs), t64(mask))
    assert_same(vb, va, "valid")
    ok = np.asarray(va)
    assert ok.sum() > 30 and (~ok).sum() >= 3
    assert_close(pb.numpy()[ok], np.asarray(pa)[ok], TOL, "point")
    assert_close(sb, sa, TOL, "score")
    ha = np.asarray(Jtri.triangulate_homogeneous(jnp.asarray(Ps)[None], jnp.asarray(xs), jnp.asarray(mask)))
    hb = Ttri.triangulate_homogeneous(t64(Ps)[None], t64(xs), t64(mask)).numpy()
    sign = np.sign(np.sum(ha * hb, axis=-1, keepdims=True))
    assert_close(hb * sign, ha, TOL, "homogeneous up to sign")
    assert_close(Ttri._dlt_rows(t64(Ps)[None], t64(xs)),
                 Jtri._dlt_rows(jnp.asarray(Ps)[None], jnp.asarray(xs)), TOL, "dlt rows")


@functools.lru_cache(maxsize=None)
def _bench_window(F=7, T=96):
    """Plane-flagged ground-truth window of a small scene (cached: the
    reference builds its deltas op by op, and the arrays are immutable)."""
    from pvio_tpu.io import synthetic as S

    scene = S.make_scene(duration=2.0, n_points=200, n_plane_points=80, seed=648)
    kf = [0, 4, 8, 12, 16, 20]
    w, extr, info = S.solver_window_from_scene(scene, kf, F_cap=F, T_cap=T,
                                               dtype=jnp.float64, kp_noise=0.002)
    w, _ = S.flag_plane_tracks(w, scene, info)
    return scene, kf, w, extr, info


def test_window_roundtrip_and_landmarks():
    scene, kf, w, extr, info = _bench_window()
    wt = Twin.window_from_numpy(tree_to_numpy(w), torch.float64)
    et = Twin.extrinsics_from_numpy(tree_to_numpy(extr), torch.float64)
    for f in ("q", "kp", "inv_depth", "plane_normal"):
        assert_close(getattr(wt, f), getattr(w, f), 0.0, f)
    for f in ("obs_mask", "ref_frame", "track_flags", "plane_id", "frame_mask"):
        assert_same(getattr(wt, f), getattr(w, f), f)
    assert_close(wt.delta.sqrt_inv_cov, w.delta.sqrt_inv_cov, 0.0, "delta")
    assert_close(Twin.landmark_points(wt, et), Jwin.landmark_points(w, extr), TOL, "landmarks")
    e = Twin.empty_window(4, 10, 3, torch.float64)
    ej = Jwin.empty_window(4, 10, 3, jnp.float64)
    for f in ("q", "inv_depth", "plane_normal"):
        assert_close(getattr(e, f), getattr(ej, f), 0.0, f)
    assert_same(e.plane_id, ej.plane_id)


def test_triangulate_tracks_virtual_matches_reference():
    scene, kf, w, extr, info = _bench_window()
    wt = Twin.window_from_numpy(tree_to_numpy(w), torch.float64)
    et = Twin.extrinsics_from_numpy(tree_to_numpy(extr), torch.float64)
    from pvio_tpu.io import synthetic as S

    nf = kf[-1] + 2
    kp, vis = S.project_points(scene, np.array([nf]))
    chosen = np.asarray(info["chosen"])
    T = w.kp.shape[1]
    z = np.zeros((T, 2))
    m = np.zeros(T, bool)
    z[:len(chosen)] = kp[0, chosen]
    m[:len(chosen)] = vis[0, chosen]
    q_new, p_new = scene.q_wb[nf], scene.p_wb[nf] + 0.01
    da, oka = Jwin.triangulate_tracks_virtual(w, extr, jnp.asarray(q_new), jnp.asarray(p_new),
                                              jnp.asarray(z), jnp.asarray(m))
    db, okb = Twin.triangulate_tracks_virtual(wt, et, t64(q_new), t64(p_new), t64(z), t64(m))
    assert_same(okb, oka, "tri_ok")
    ok = np.asarray(oka)
    assert ok.sum() > 40
    assert_close(db.numpy()[ok], np.asarray(da)[ok], TOL, "inv_d")

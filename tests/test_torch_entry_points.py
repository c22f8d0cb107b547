"""Port parity of the `DeviceKernels` entry points the host loop and the
initializer call (`track`, `fransac`, `remove_k`, `pad_imu`,
`integrate_one`, `predict_state`, `pnp_vi`, `pnp_vo`, `ba_vi`, `ba_vo`,
`marginalize0`, `initial_prior`, `triangulate_tracks`, `landmarks`),
pvio_torch vs pvio_tpu on the CPU at float64 with the small configuration,
planes ON.

Tolerances: status and inlier masks, counts, flags and gates identical;
keypoints 1e-9 px; preintegration 1e-12 of each field's largest entry; PnP
and BA states 1e-8 (ten and eight LM steps); the marginalization prior
through its invariants (tests/test_torch_marginalization.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pvio_tpu.imu import preintegration as Jpre
from pvio_torch.imu.preintegration import PreintDelta
from pvio_torch.io import synthetic as TS
from tests.test_torch_factors_ba import assert_window_close, ba_window
from tests.test_torch_harness import assert_close, assert_rel, assert_same, npy
from tests.test_torch_keyframe import jargs, kernels
from tests.test_torch_marginalization import assert_prior_matches

torch.set_num_threads(2)


def test_frontend_entry_points_match_reference():
    """track (KLT with the per-patch trackability gate, no response maps),
    fransac (from the same threefry key data) and remove_k on two renders."""
    jk, tk = kernels()
    cfg = tk.cfg
    scene = TS.make_scene(duration=2.0, n_points=200, n_plane_points=80, seed=648)
    imgs = [(TS.render_frame(scene, 9 + i, cfg.K, cfg.image_size) * 255 + 0.5).astype(np.uint8)
            for i in range(2)]
    pyr0_j, _, kp, mask = jk.first_frame_step(jnp.asarray(imgs[0]))
    pyr1_j = jk.preprocess(jnp.asarray(imgs[1]))
    pyr0_t, pyr1_t = tk.preprocess(imgs[0]), tk.preprocess(imgs[1])
    guess = np.asarray(kp) + 0.7
    kp_j, st_j = jk.track(pyr0_j, pyr1_j, kp, jnp.asarray(guess), mask)
    kp_t, st_t = tk.track(pyr0_t, pyr1_t, np.asarray(kp), guess, np.asarray(mask))
    assert_same(st_t, st_j, "status")
    ok = npy(st_j)
    assert ok.sum() >= 20
    assert_close(npy(kp_t)[ok], npy(kp_j)[ok], 1e-9, "kp")
    key_data = np.array([648, 3], np.uint32)
    key = jax.random.wrap_key_data(jnp.asarray(key_data), impl="threefry2x32")
    inl_j, cnt_j = jk.fransac(key, kp, kp_j, st_j)
    inl_t, cnt_t = tk.fransac(key_data, np.asarray(kp), kp_t, st_t)
    assert_same(inl_t, inl_j, "inliers")
    assert int(cnt_t) == int(cnt_j) >= 8
    assert_close(tk.remove_k(np.asarray(kp)), jk.remove_k(kp), 1e-12, "remove_k")


def test_solver_entry_points_match_reference():
    scene, kf, w, _, _, wt, _ = ba_window()
    jk, tk = kernels()
    new, last = len(kf) - 1, len(kf) - 2
    sel = (scene.imu_t >= scene.frame_t[kf[last]]) & (scene.imu_t < scene.frame_t[kf[new]])
    raw = (scene.imu_t[sel], scene.gyro[sel], scene.accel[sel])
    for a, b in zip(tk.pad_imu(*raw), jk.pad_imu(*raw)):
        assert_close(a, b, 0.0, "pad_imu")
    t1, bg = float(scene.frame_t[kf[new]]), np.array([0.001, -0.002, 0.0005])
    # the reference's own `integrate_one` raises NameError (its property looks
    # up `_preintegrate`, a local of `_build`), so the port is held to what it
    # means: `preintegrate` of the padded buffer with the tree path
    dj = jax.jit(lambda *a: Jpre.preintegrate(*a, jk.noise, assoc=True))(
        *jk.pad_imu(*raw), jnp.asarray(t1), jnp.asarray(bg), jnp.zeros(3))
    dt = tk.integrate_one(*raw, t1, bg, np.zeros(3))
    for name, a, b in zip(PreintDelta._fields, dt, dj):
        assert_rel(a, b, 1e-12, f"integrate_one {name}")
    st_j = jk.predict_state(dj, w.q[last], w.p[last], w.v[last], w.bg[last], w.ba[last])
    st_t = tk.predict_state(dt, wt.q[last], wt.p[last], wt.v[last], wt.bg[last], wt.ba[last])
    for a, b in zip(st_t, st_j):
        assert_close(a, b, 1e-12, "predict_state")

    # motion-only PnP of the newest frame from a perturbed start
    rng = np.random.default_rng(31)
    x_j, x_t = jk.landmarks(w), tk.landmarks(wt)
    assert_close(x_t, x_j, 1e-12, "landmarks")
    obs = np.asarray(w.obs_mask[new] & w.obs_mask[last] & w.track_mask)
    start = (np.asarray(w.q[new]), np.asarray(w.p[new]) + rng.normal(size=3) * 0.02,
             np.asarray(w.v[new]) + rng.normal(size=3) * 0.05, np.asarray(w.bg[new]),
             np.asarray(w.ba[new]))
    lst = tuple(np.asarray(a[last]) for a in (w.q, w.p, w.v, w.bg, w.ba))
    d_new = jax.tree.map(lambda a: a[new], w.delta)
    d_new_t = PreintDelta(*(a[new] for a in wt.delta))
    for solver in ("pnp_vi", "pnp_vo"):
        out_j = getattr(jk, solver)(*jargs(*start, *lst), d_new, w.bg_lin[new], w.ba_lin[new],
                                    x_j, w.kp[new], jnp.asarray(obs))
        out_t = getattr(tk, solver)(*(torch.as_tensor(a) for a in start + lst), d_new_t,
                                    wt.bg_lin[new], wt.ba_lin[new], x_t, wt.kp[new], obs)
        for a, b in zip(out_t, out_j):
            assert_close(a, b, 1e-8, solver)
        assert np.linalg.norm(npy(out_t[1]) - start[1]) > 1e-3        # the solve moved it

    for solver in ("ba_vi", "ba_vo"):
        (wj2, ij), (wt2, it) = getattr(jk, solver)(w), getattr(tk, solver)(wt)
        assert_window_close(wt2, wj2, 1e-8, solver)
        assert_same(wt2.track_flags, wj2.track_flags, f"{solver} flags")
        assert int(it["accepted"]) == int(ij["accepted"]) >= 1
        assert_rel(it["final_cost"], ij["final_cost"], 1e-9, f"{solver} cost")

    inv_j, ok_j = jk.triangulate_tracks(w)
    inv_t, ok_t = tk.triangulate_tracks(wt)
    assert_same(ok_t, ok_j, "tri ok")
    ok = npy(ok_j)
    assert_close(npy(inv_t)[ok], npy(inv_j)[ok], 1e-10, "tri inv_d")

    pj, pt = jk.initial_prior(w), tk.initial_prior(wt)
    assert_close(pt.sqrt_info, pj.sqrt_info, 1e-12, "initial prior")
    wmj, wmt = jk.marginalize0(w), tk.marginalize0(wt)
    assert_window_close(wmt, wmj, 1e-12, "marginalize0")
    assert_same(wmt.ref_frame, wmj.ref_frame, "marginalize0 ref_frame")
    assert_prior_matches(wmt.prior, wmj.prior, "marginalize0")

"""Port parity of the whole slice: the per-frame frontend chain and the
motion step through `DeviceKernels`, pvio_torch vs pvio_tpu on the CPU at
float64, with the pipeline tests' small configuration (320x240, 60
keypoint slots, 96 tracks, 7 frame slots) and planes ON.

Tolerances: status, detection and merged masks, triangulation flags and
common-track counts identical; kp_merged within 1e-9 px after the chain;
the PnP state, depths and parallax statistic within 1e-9 (ten LM steps,
see test_torch_imu_pnp); the preintegrated rotation 1e-12.
"""

import numpy as np
import torch

from pvio_tpu.core.kernels import DeviceKernels as JKernels
from pvio_tpu.io import synthetic as S
from pvio_torch.core.kernels import DeviceKernels as TKernels
from pvio_torch.io.config import Config as TConfig
from pvio_torch.map import window as Twin
from tests.test_pipeline import small_config
from tests.test_torch_geometry import _bench_window
from tests.test_torch_harness import assert_close, assert_same, npy, tree_to_numpy

import jax.numpy as jnp

torch.set_num_threads(2)


def _configs():
    jcfg = small_config(enable_plane_constraint=True)
    tcfg = TConfig()
    for f in jcfg.__dataclass_fields__:
        setattr(tcfg, f, getattr(jcfg, f))
    return jcfg, tcfg


def _dq_cam(scene, i):
    """Body (= camera, identity extrinsics) rotation from frame i to i+1."""
    return S._np_quat_mul(S._np_quat_conj(scene.q_wb[i]), scene.q_wb[i + 1])


def test_synthetic_scene_matches_reference():
    """The port's numpy copy of the scene generator, renderer and solver
    window gives the reference's arrays: scene, projections and renders
    bit for bit, the window's preintegrated deltas to 1e-12."""
    from pvio_torch.io import synthetic as TS

    kw = dict(duration=2.0, n_points=200, n_plane_points=80, seed=648)
    sj, st = S.make_scene(**kw), TS.make_scene(**kw)
    for f in sj._fields:
        assert np.array_equal(getattr(st, f), getattr(sj, f)), f
    jcfg, _ = _configs()
    assert np.array_equal(TS.render_frame(st, 9, jcfg.K, jcfg.image_size),
                          S.render_frame(sj, 9, jcfg.K, jcfg.image_size))
    for a, b in zip(TS.project_points(st, np.array([3, 7]), kp_noise=0.01, seed=2),
                    S.project_points(sj, np.array([3, 7]), kp_noise=0.01, seed=2)):
        assert np.array_equal(a, b)
    kf = [0, 4, 8]
    wj, _, ij = S.solver_window_from_scene(sj, kf, F_cap=5, T_cap=64, dtype=jnp.float64,
                                           kp_noise=0.002)
    wt, _, it = TS.solver_window_from_scene(st, kf, F_cap=5, T_cap=64, dtype=torch.float64,
                                            kp_noise=0.002)
    wj, nj = S.flag_plane_tracks(wj, sj, ij)
    wt, nt = TS.flag_plane_tracks(wt, st, it)
    assert nj == nt and list(ij["chosen"]) == list(it["chosen"])
    ref = tree_to_numpy(wj)
    for f in ("q", "p", "v", "inv_depth", "kp", "plane_normal", "plane_distance"):
        assert_close(getattr(wt, f), ref[f], 1e-12, f)
    for f in ("frame_mask", "fix_mask", "obs_mask", "track_mask", "track_flags", "plane_id",
              "ref_frame", "plane_mask", "delta_valid"):
        assert_same(getattr(wt, f), ref[f], f)
    for f in ("t", "q", "p", "v", "dq_dbg", "dv_dba"):
        assert_close(getattr(wt.delta, f), ref["delta"][f], 1e-12, f"delta.{f}")


def test_frontend_chain_matches_reference():
    """first_frame_step, 4 x frame_step, 1 x frame_step_nodetect on one
    scene's renders, key data [648, i], each package chaining its own
    outputs."""
    jcfg, tcfg = _configs()
    jk, tk = JKernels(jcfg), TKernels(tcfg, device="cpu")
    scene = S.make_scene(duration=2.0, n_points=200, n_plane_points=80, seed=648)
    base = 8
    imgs = [(S.render_frame(scene, base + i, jcfg.K, jcfg.image_size) * 255 + 0.5).astype(np.uint8)
            for i in range(6)]
    pyr_j, resp_j, kp_j, m_j = jk.first_frame_step(jnp.asarray(imgs[0]))
    pyr_t, resp_t, kp_t, m_t = tk.first_frame_step(imgs[0])
    for a, b in zip(pyr_t, pyr_j):
        assert_close(a, b, 1e-12, "pyramid")
    assert_close(resp_t, resp_j, 1e-12, "response")
    assert_same(m_t, m_j, "first det_mask")
    assert_close(kp_t, kp_j, 1e-12, "first det_kp")
    assert int(np.asarray(m_j).sum()) >= 30
    n_tracked = []
    for i in range(1, 6):
        dq = _dq_cam(scene, base + i - 1)
        kd = np.array([648, i], np.uint32)
        if i < 5:
            out_j = jk.frame_step(pyr_j, resp_j, jnp.asarray(imgs[i]), kp_j, m_j,
                                  jnp.asarray(dq), jnp.asarray(kd))
            out_t = tk.frame_step(pyr_t, resp_t, imgs[i], kp_t, m_t, dq, kd)
        else:
            out_j = jk.frame_step_nodetect(pyr_j, resp_j, jnp.asarray(imgs[i]), kp_j, m_j,
                                           jnp.asarray(dq), jnp.asarray(kd))
            out_t = tk.frame_step_nodetect(pyr_t, resp_t, imgs[i], kp_t, m_t, dq, kd)
        pyr_j, resp_j, kp_j, m_j, st_j, det_j = out_j
        pyr_t, resp_t, kp_t, m_t, st_t, det_t = out_t
        assert_same(st_t, st_j, f"frame {i} status")
        assert_same(det_t, det_j, f"frame {i} det_mask")
        assert_same(m_t, m_j, f"frame {i} mask_merged")
        assert_close(kp_t, kp_j, 1e-9, f"frame {i} kp_merged")
        n_tracked.append(int(np.asarray(st_j).sum()))
    assert min(n_tracked) >= 20, n_tracked
    assert not np.asarray(det_j).any()


def test_pnp_step_matches_reference():
    """pnp_step on a plane-flagged window carried across with
    window_from_numpy, on the same IMU span and observations."""
    jcfg, tcfg = _configs()
    jk, tk = JKernels(jcfg), TKernels(tcfg, device="cpu")
    scene, kf, w, _, info = _bench_window(jcfg.window_frame_capacity, jcfg.track_capacity)
    assert int(np.sum(np.asarray(w.plane_id) == 0)) >= 10
    wt = Twin.window_from_numpy(tree_to_numpy(w), torch.float64)
    tail, new = len(kf) - 1, kf[-1] + 2
    sel = (scene.imu_t >= scene.frame_t[kf[-1]]) & (scene.imu_t < scene.frame_t[new])
    imu = jk.pad_imu_host(scene.imu_t[sel], scene.gyro[sel], scene.accel[sel])
    assert all(np.array_equal(a, b) for a, b in zip(
        tk.pad_imu_host(scene.imu_t[sel], scene.gyro[sel], scene.accel[sel]), imu))
    kp, vis = S.project_points(scene, np.array([new]), kp_noise=0.002, seed=5)
    chosen = np.asarray(info["chosen"])
    T = jcfg.track_capacity
    z = np.zeros((T, 2))
    obs = np.zeros(T, bool)
    z[:len(chosen)] = kp[0, chosen]
    obs[:len(chosen)] = vis[0, chosen]
    obs_new = obs.copy()
    obs_new[::7] = False                 # a few tracks not seen by the new frame
    t_new = float(scene.frame_t[new])
    out_j = jk.pnp_step(w, *(jnp.asarray(x) for x in imu), jnp.asarray(t_new), tail,
                        jnp.asarray(z), jnp.asarray(obs), jnp.asarray(obs_new), 2)
    out_t = tk.pnp_step(wt, *imu, t_new, tail, z, obs, obs_new, 2)
    names = ("q1", "p1", "v1", "bg1", "ba1", "delta_q", "inv_d", "tri_ok", "p80", "n_common")
    res = dict(zip(names, zip(out_t, out_j)))
    for n in ("q1", "p1", "v1", "bg1", "ba1", "p80"):
        assert_close(*res[n], 1e-9, n)
    assert_close(*res["delta_q"], 1e-12, "delta_q")
    assert_same(*res["tri_ok"], "tri_ok")
    assert_same(*res["n_common"], "n_common")
    ok = npy(res["tri_ok"][1])
    assert ok.sum() >= 40
    assert_close(npy(res["inv_d"][0])[ok], npy(res["inv_d"][1])[ok], 1e-9, "inv_d")
    assert np.linalg.norm(npy(res["p1"][1]) - scene.p_wb[new]) < 0.02

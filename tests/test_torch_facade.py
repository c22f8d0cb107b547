"""The port's `PVIO` facade against the reference's, and the host-side
pieces of the sensor core.

* image tier: `pvio_torch.PVIO` and `pvio_tpu.PVIO` on the same rendered
  blob frames (`render_frame`, `small_config`, float64, CPU) and the same
  IMU stream, through the initializing frame: the same frame, no re-init,
  the initialized windows within `MAX_DP_M` (flags and ids identical), the
  same first pose (measured 9.0e-11 and 2.6e-11 m;
  `test_torch_facade_tracking.py` holds the rest of the stream to the
  reference's trackers);
* `Core._pair_imu`, `_next_ready_frame`, `_propagate` and `swt.health_update`
  against the reference on the same streams, exactly;
* `PVIO` raises without CUDA unless device="cpu", and builds a plane
  extractor with planes on;
* the port's `io/synthetic.py` copies (`render_frame`, `render_frame_room`,
  `OracleFeatureSource.make_frame`, `pipeline_config`) equal the
  reference's outputs on the same scene.
"""

from dataclasses import fields
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests.test_torch_harness import small_config
from tests.test_torch_initializer import window_fields

from pvio_tpu import PVIO as RefPVIO
from pvio_tpu.core import core as ref_core
from pvio_tpu.core.swt import health_update as ref_health_update
from pvio_tpu.io import synthetic as ref_syn
from pvio_tpu.io.config import Config as RefConfig
from pvio_torch import PVIO
from pvio_torch.core import core
from pvio_torch.core.swt import health_update
from pvio_torch.io import synthetic

MAX_DP_M = 1e-6


def drive(vio, scene, images, blackout=(), after_call=None, until_init=False):
    """Feed the scene's IMU and images as the reference pipeline tests do,
    calling after_call(frame index) after each frame, and stopping after
    the initializing frame when until_init; returns the index of the first
    frame after which vio is initialized."""
    fi, init_fi = 0, None
    H, W = images[0].shape
    for k in range(len(scene.imu_t)):
        t = scene.imu_t[k]
        vio.track_gyroscope(t, *scene.gyro[k])
        vio.track_accelerometer(t, *scene.accel[k])
        while fi < len(scene.frame_t) and scene.frame_t[fi] <= t:
            img = np.zeros((H, W), np.float32) if fi in blackout else images[fi]
            vio.track_camera(scene.frame_t[fi], img)
            if after_call is not None:
                after_call(fi)
            if init_fi is None and vio.initialized:
                init_fi = fi
                if until_init:
                    return init_fi
            fi += 1
    return init_fi


def test_facade_matches_reference_on_images():
    """Both facades from the first frame through the initializing one:
    the same frame, no re-init, the initialized windows within MAX_DP_M
    (flags, masks and ids identical) and the same first pose."""
    scene = synthetic.make_scene(duration=2.5, fps=20.0, imu_rate=200.0, n_points=320, seed=648)
    cfg = small_config()
    images = [synthetic.render_frame(scene, fi, cfg.K, cfg.image_size)
              for fi in range(len(scene.frame_t))]
    vio = PVIO(cfg, device="cpu")
    vio_ref = RefPVIO(small_config(RefConfig))
    init_fi = drive(vio, scene, images, until_init=True)
    init_ref = drive(vio_ref, scene, images, until_init=True)
    assert init_fi == init_ref is not None
    assert vio.core.frontend.n_reinits == vio_ref.core.frontend.n_reinits == 0
    w, w_ref = window_fields(vio.core.frontend.swt.hw), window_fields(vio_ref.core.frontend.swt.hw)
    dw = 0.0
    for name, b in w_ref.items():
        a = w[name]
        if isinstance(b, np.ndarray) and b.dtype.kind == "f":
            dw = max(dw, float(np.abs(a - b).max(initial=0.0)))
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=name)
        elif isinstance(b, (bool, int, dict)) and name != "prior":
            assert a == b, name
    assert dw <= MAX_DP_M, dw
    traj, traj_ref = vio.get_trajectory(), vio_ref.get_trajectory()
    assert len(traj) == len(traj_ref) == 1 and traj[0][0] == traj_ref[0][0]
    dp = float(np.abs(traj[0][2] - traj_ref[0][2]).max())
    dq = float(np.abs(traj[0][1] - traj_ref[0][1]).max())
    assert dp <= MAX_DP_M and dq <= MAX_DP_M, (dp, dq)
    print(f"facade vs the reference through initialization (frame {init_fi}): window max "
          f"|d| {dw:.3e}, first pose |dp| {dp:.3e} m")
    st, st_ref = vio.get_latest_state(), vio_ref.get_latest_state()
    assert st.t == st_ref.t and np.abs(st.v - st_ref.v).max() <= MAX_DP_M
    assert len(vio.get_map_points()) == len(vio_ref.get_map_points()) > 10
    assert vio.get_planes() == [] == vio_ref.get_planes()


def _imu_stream(seed, n=400):
    """Gyro and accel streams with their own jittered clocks."""
    rng = np.random.default_rng(seed)
    tg = np.cumsum(rng.uniform(0.004, 0.006, n))
    ta = np.cumsum(rng.uniform(0.004, 0.006, n)) + 0.003
    return tg, rng.normal(size=(n, 3)), ta, rng.normal(size=(n, 3)) + [0, 0, 9.8]


def test_core_imu_pairing_and_frame_spans_exact():
    tg, wg, ta, aa = _imu_stream(5)
    cfg, cfg_ref = small_config(), small_config(RefConfig)
    cores = [core.Core(cfg, use_native=False, device="cpu"),
             ref_core.Core(cfg_ref, use_native=False)]
    frame_t = np.arange(0.05, 1.8, 0.05) + 0.0013
    got = [[], []]
    for c, out in zip(cores, got):
        c._dispatch_frames = lambda: None   # the test pops the ready frames itself
        ig = ia = 0
        for fid, tf in enumerate(frame_t):
            while ig < len(tg) and tg[ig] <= tf + 0.01:
                c.gyro.append((tg[ig], wg[ig]))
                ig += 1
                c._pair_imu()
            while ia < len(ta) and ta[ia] <= tf + 0.01:
                c.accel.append((ta[ia], aa[ia]))
                ia += 1
                c._pair_imu()
            c.pending_frames.append([fid, tf, None])
            while (r := c._next_ready_frame()) is not None:
                out.append(r)
                c._last_frame_t = r[1]
        out.append([(t, w.copy(), a.copy()) for t, w, a in c.imu])
    assert len(got[0]) == len(got[1]) > 30
    for a, b in zip(got[0][:-1], got[1][:-1]):
        assert a[0] == b[0] and a[1] == b[1]
        for x, y in zip(a[3:], b[3:]):
            np.testing.assert_array_equal(x, y)
    for (t1, w1, a1), (t2, w2, a2) in zip(got[0][-1], got[1][-1]):
        assert t1 == t2
        np.testing.assert_array_equal(w1, w2)
        np.testing.assert_array_equal(a1, a2)


def test_core_propagate_exact():
    rng = np.random.default_rng(8)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    args = (q, rng.normal(size=3), rng.normal(size=3), 0.01 * rng.normal(size=3),
            0.1 * rng.normal(size=3), 0.5, np.sort(rng.uniform(0.45, 0.7, 30)),
            rng.normal(size=(30, 3)), rng.normal(size=(30, 3)))
    for a, b in zip(core._propagate(*args), ref_core._propagate(*args)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("window", [0, 8])
def test_health_update_exact(window):
    rng = np.random.default_rng(window)
    seqs = [[100] + [5, 8, 11, 20] * 10, [100] * 3 + [60, 80, 40, 90] * 10, [100] + [5] * 12,
            list(rng.integers(0, 120, 60))]
    cfg = SimpleNamespace(track_health_min_landmarks=8, track_health_max_keyframes=8,
                          track_health_window=window, track_health_frac=0.7)
    for seq in seqs:
        states = [SimpleNamespace(peak_valid=0, unhealthy_keyframes=0) for _ in range(2)]
        for n in seq:
            for st in states:
                st.peak_valid = max(st.peak_valid, int(n))
            assert health_update(states[0], cfg, int(n)) == ref_health_update(states[1], cfg, int(n))
            assert vars(states[0]) == vars(states[1])


def test_pvio_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PVIO(small_config())
    assert PVIO(small_config(), enable_planes=True, device="cpu").core.frontend._pef is not None
    vio = PVIO(small_config(), device="cpu")
    assert vio.core.kernels.device.type == "cpu" and not vio.initialized
    assert vio.get_latest_state() is None and vio.get_trajectory() == []
    kern = vio.core.kernels
    vio.reset()
    assert vio.core.kernels is kern


def test_synthetic_copies_equal_reference():
    cfg = small_config()
    scene = synthetic.make_scene(duration=1.0, fps=20.0, imu_rate=200.0, n_points=320, seed=648)
    scene_ref = ref_syn.make_scene(duration=1.0, fps=20.0, imu_rate=200.0, n_points=320, seed=648)
    for a, b in zip(scene, scene_ref):
        np.testing.assert_array_equal(a, b)
    for fi in (0, 7, 19):
        np.testing.assert_array_equal(synthetic.render_frame(scene, fi, cfg.K, cfg.image_size),
                                      ref_syn.render_frame(scene_ref, fi, cfg.K, cfg.image_size))
        np.testing.assert_array_equal(
            synthetic.render_frame_room(scene, fi, cfg.K, cfg.image_size),
            ref_syn.render_frame_room(scene_ref, fi, cfg.K, cfg.image_size))
    src = synthetic.OracleFeatureSource(scene, cfg.K, cfg.image_size, max_keypoints=60,
                                        kp_noise_px=0.3)
    src_ref = ref_syn.OracleFeatureSource(scene_ref, cfg.K, cfg.image_size, max_keypoints=60,
                                          kp_noise_px=0.3)
    for fi in range(5):
        imu = (scene.imu_t[:3] + fi, scene.gyro[:3], scene.accel[:3])
        a, b = src.make_frame(fi, fi, *imu), src_ref.make_frame(fi, fi, *imu)
        for f in fields(b):
            np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name))
    assert src.frame_by_id(3) is src.frames[3]
    pc, pc_ref = synthetic.pipeline_config(), ref_syn.pipeline_config()
    for f in fields(pc_ref):
        a, b = getattr(pc, f.name), getattr(pc_ref, f.name)
        assert np.array_equal(a, b) if isinstance(b, np.ndarray) else a == b, f.name

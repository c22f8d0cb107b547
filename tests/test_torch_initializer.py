"""Parity of the visual-inertial initializer (`core/initializer.py`).

Raw frames come from the reference's oracle feature source on one scene
(`make_scene(duration=2.5, n_points=320, seed=648)`, 0.3 px keypoint
noise: the scene of `test_torch_oracle_pipeline.py`, whose landmarks
depend on the duration); the same keypoints, track ids and IMU spans go to
both packages at the reference pipeline tests' `small_config` (float64,
CPU). Every frame, both Initializers attempt initialization on the same
raw window: they must fail at the same gates (the scale gate, 3 times) and
succeed on the same frame, `INIT_FRAME`, with the same window.
"""

import numpy as np

from tests.test_torch_harness import assert_close, assert_same, small_config

from pvio_tpu.core.initializer import Initializer as RefInitializer
from pvio_tpu.core.kernels import DeviceKernels as RefKernels
from pvio_tpu.io import synthetic as ref_syn
from pvio_tpu.io.config import Config as RefConfig
from pvio_torch.core.feature_tracker import RawFrame
from pvio_torch.core.initializer import Initializer
from pvio_torch.core.kernels import DeviceKernels

SCENE = dict(duration=2.5, fps=20.0, imu_rate=200.0, n_points=320, seed=648)
INIT_FRAME = 23          # the frame on which both packages initialize


def window_fields(hw):
    """Every field of a (reference or port) HostWindow as numpy values, the
    prior as a dict of its fields (the input of `HostWindow.from_arrays`)."""
    out = {}
    for name, v in vars(hw).items():
        if name in ("F", "T", "P", "dtype", "device"):
            continue
        if name == "prior":
            v = {f: np.array(x.cpu().numpy() if hasattr(x, "cpu") else x)
                 for f, x in zip(v._fields, v)}
        elif isinstance(v, np.ndarray):
            v = v.copy()
        elif isinstance(v, list):
            v = [None if x is None else np.array(x) for x in v]
        elif isinstance(v, dict):
            v = dict(v)
        out[name] = v
    return out


def oracle_frames(cfg, scene, kp_noise_px=0.3):
    """Reference RawFrames of every scene frame, IMU spliced as
    `tests/test_pipeline.py::run_oracle` does."""
    oracle = ref_syn.OracleFeatureSource(
        scene, cfg.K, cfg.image_size, max_keypoints=cfg.feature_tracker_max_keypoint_detection,
        kp_noise_px=kp_noise_px)
    frames = []
    for fi in range(len(scene.frame_t)):
        t = scene.frame_t[fi]
        sel = (scene.imu_t <= t) if fi == 0 else (
            (scene.imu_t >= scene.frame_t[fi - 1]) & (scene.imu_t < t))
        frames.append(oracle.make_frame(fi, fi, scene.imu_t[sel], scene.gyro[sel],
                                        scene.accel[sel]))
    return frames


def port_frame(rf):
    return RawFrame(rf.id, rf.t, rf.kp.copy(), rf.kp_mask.copy(), rf.track_ids.copy(),
                    rf.imu_ts.copy(), rf.imu_w.copy(), rf.imu_a.copy())


def test_initializer_same_frame_same_window():
    cfg_ref = small_config(RefConfig)
    cfg = small_config()
    scene = ref_syn.make_scene(**SCENE)
    frames_ref = oracle_frames(cfg_ref, scene)
    frames = [port_frame(f) for f in frames_ref]
    init_ref = RefInitializer(cfg_ref, RefKernels(cfg_ref))
    init = Initializer(cfg, DeviceKernels(cfg, device="cpu"))
    stages = []
    for n in range(1, len(frames) + 1):
        hw_ref = init_ref.try_initialize(frames_ref[:n])
        hw = init.try_initialize(frames[:n])
        assert (hw is None) == (hw_ref is None), (n, init.failure, init_ref.failure)
        assert init.failure == init_ref.failure or (
            init.failure[0] == init_ref.failure[0]
            and np.isclose(init.failure[1], init_ref.failure[1], rtol=1e-8)), (
            n, init.failure, init_ref.failure)
        if init_ref.failure is not None:
            stages.append(init_ref.failure[0])
        if hw_ref is not None:
            break
    assert hw_ref is not None, f"no initialization in {len(frames)} frames: {stages}"
    assert n - 1 == INIT_FRAME and stages == ["imu_scale"] * 3, (n - 1, stages)
    for name in ("q", "p"):
        assert_close(getattr(hw, name), getattr(hw_ref, name), 1e-8, name)
    for name in ("v", "bg", "ba"):
        assert_close(getattr(hw, name), getattr(hw_ref, name), 1e-8, name)
    live = hw_ref.track_mask & ((hw_ref.track_flags & 1) != 0)
    assert_same(hw.track_flags, hw_ref.track_flags, "track flags")
    assert_same(hw.track_mask, hw_ref.track_mask, "track mask")
    assert_close(hw.inv_depth[live], hw_ref.inv_depth[live], 1e-8, "inverse depths")
    for name in ("frame_mask", "keyframe", "frame_id", "ref_frame", "track_id", "obs_mask"):
        assert_same(getattr(hw, name), getattr(hw_ref, name), name)

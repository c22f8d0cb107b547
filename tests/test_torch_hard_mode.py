"""The hard mode of the golden tier at the image tier: the port's `PVIO`
facade against the reference's feature tracker and sliding-window tracker
on noisy imagery with the reduced keypoint budget and the 4 px gate.

`tests/test_golden_run.py::test_golden_hard_mode_planes_beat_planes_off`
runs 480x752 EuRoC-shaped frames with pixel noise sigma 8 after a clean
initialization, a keypoint budget of 100 (the YAML's 150 cut by a third),
a 4 px forward-backward gate, keypoint sigma 1.5 px and a noisy IMU
(gyro 1e-3, accel 1e-2). Here the same overrides go onto `small_config`
(320x240, float64, planes off) with its budget of 60 cut by the same third
to 40, over the blob stream of `test_torch_facade_tracking.py`: 8-bit
frames, clean through the initializing frame (28) and noised with sigma 8
counts from NOISE_AFTER on, from `default_rng(NOISE_SEED)`.

`pvio_torch.PVIO(device="cpu")` runs the whole stream. The reference's
`FeatureTracker` tracks the same images with the same IMU spans and must
give the same raw frames (masks and track ids identical, keypoints within
1e-9 px); its `SlidingWindowTracker` starts from the port's initialized
window and must take the same keyframes and agree with the port's states
on every frame within 1e-6 m. One compilation of the reference's path.

On noisy frames the KLT solve amplifies rounding: the two trackers left to
run free part by ~1e-12 px at the first noisy frame and by ~2e-8 px twenty
noisy frames later, growing ~1.5x a frame along each track (on the clean
frames they stay under 3e-12 px). So each frame the reference's tracker
starts from the port's keypoints of the frame before (`_kp_dev`, the
device-resident state its step chains on; masks and ids are its own and
are held identical), and each step is held to 1e-9 px.
"""

import jax.numpy as jnp
import numpy as np

from tests.test_torch_facade_tracking import MAX_DP_M, MAX_KP_PX, run_port
from tests.test_torch_harness import small_config
from tests.test_torch_oracle_pipeline import ref_window

from pvio_tpu.core.feature_tracker import FeatureTracker as RefFeatureTracker
from pvio_tpu.core.kernels import DeviceKernels as RefKernels
from pvio_tpu.core.swt import SlidingWindowTracker as RefSWT
from pvio_tpu.io.config import Config as RefConfig
from pvio_torch.io import synthetic

NOISE_AFTER = 1.45     # s: frame 29, the first after the initializing frame
NOISE_SIGMA = 8.0      # 8-bit counts, as the golden hard mode
NOISE_SEED = 649
HARD = dict(feature_tracker_max_keypoint_detection=40, feature_tracker_fb_threshold=4.0,
            camera_noise_cov=np.eye(2) * 1.5 ** 2)


def hard_config(cls=None):
    return small_config(cls, **HARD)


def hard_stream(duration=2.5):
    """The noisy-IMU blob scene and its 8-bit frames, noised from NOISE_AFTER."""
    scene = synthetic.make_scene(duration=duration, fps=20.0, imu_rate=200.0, n_points=320,
                                 seed=648, gyro_noise=1e-3, accel_noise=1e-2)
    cfg = hard_config()
    rng = np.random.default_rng(NOISE_SEED)
    images = []
    for fi in range(len(scene.frame_t)):
        u8f = synthetic.render_frame(scene, fi, cfg.K, cfg.image_size) * 255.0
        if scene.frame_t[fi] >= NOISE_AFTER:
            u8f = u8f + rng.normal(size=u8f.shape) * NOISE_SIGMA
        images.append(np.clip(u8f + 0.5, 0, 255).astype(np.uint8))
    return scene, images


def test_hard_mode_tracking_matches_reference_on_noisy_images():
    scene, images = hard_stream()
    vio, raw, init, states = run_port(scene, images, hard_config())
    assert vio.initialized and vio.core.frontend.n_reinits == 0
    assert scene.frame_t[init["fi"]] < NOISE_AFTER <= scene.frame_t[init["fi"] + 1]
    assert len(raw) == len(images) and len(states) == len(images) - 1 - init["fi"] >= 20

    cfg_ref = hard_config(RefConfig)
    kern = RefKernels(cfg_ref)
    ft = RefFeatureTracker(cfg_ref, kern)
    swt, ref_states = None, []
    for fi, rf in enumerate(raw):
        if fi > 0:
            ft._kp_dev = jnp.asarray(raw[fi - 1].kp)
        r = ft.track_frame(rf.id, rf.t, images[fi], rf.imu_ts, rf.imu_w, rf.imu_a)
        assert r.t == rf.t
        np.testing.assert_array_equal(r.kp_mask, rf.kp_mask, err_msg=f"frame {fi}")
        np.testing.assert_array_equal(r.track_ids, rf.track_ids, err_msg=f"frame {fi}")
        np.testing.assert_allclose(r.kp[r.kp_mask], rf.kp[rf.kp_mask], rtol=0, atol=MAX_KP_PX,
                                   err_msg=f"frame {fi}")
        if fi == init["fi"]:
            swt = RefSWT(cfg_ref, kern, ref_window(init["window"]), ft)
            ft.initialized = True
        elif swt is not None:
            assert swt.track(r), f"the reference lost tracking at frame {fi}"
            ref_states.append(swt.latest_state)
    assert swt.n_keyframes == vio.core.frontend.swt.n_keyframes >= 3
    assert len(ref_states) == len(states)
    dp = 0.0
    for a, b in zip(states, ref_states):
        assert a[0] == b[0]
        dp = max(dp, float(np.abs(a[2] - np.asarray(b[2])).max()))
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_allclose(x, np.asarray(y), rtol=0, atol=MAX_DP_M)
    assert dp <= MAX_DP_M, dp
    print(f"hard mode vs the reference: initialized at frame {init['fi']}, {len(states)} noisy "
          f"frames after it, {swt.n_keyframes} keyframes, max |dp| {dp:.3e} m")

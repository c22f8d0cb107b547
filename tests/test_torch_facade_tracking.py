"""The port's `PVIO` facade after initialization, against the reference's
feature tracker and sliding-window tracker on the same image stream.

The image tier of `test_torch_facade.py` continued: `pvio_torch.PVIO` runs
the whole rendered blob stream (`render_frame`, `small_config`, float64,
CPU). The reference's `FeatureTracker` tracks the same images with the
same IMU spans from the first frame, and must give the same raw frames
(masks and track ids identical, keypoints within 1e-9 px). Its
`SlidingWindowTracker` starts from the port's initialized window, built as
a reference `HostWindow`, tracks the rest of the stream on the reference's
raw frames, and must take the same keyframes and agree with the port's
states on every frame within `MAX_DP_M` (measured 1.6e-11 m). `test_torch_facade.py` holds the
reference's `PVIO` to the port's through initialization; the split keeps
each file to one compilation of the reference's path.
"""

import numpy as np

from golden_spread import followed, window_fields

from tests.test_torch_facade import drive
from tests.test_torch_harness import small_config
from tests.test_torch_oracle_pipeline import ref_window

from pvio_tpu.core.feature_tracker import FeatureTracker as RefFeatureTracker
from pvio_tpu.core.kernels import DeviceKernels as RefKernels
from pvio_tpu.core.swt import SlidingWindowTracker as RefSWT
from pvio_tpu.io.config import Config as RefConfig
from pvio_torch import PVIO
from pvio_torch.io import synthetic

MAX_DP_M = 1e-6
MAX_KP_PX = 1e-9


def latest_state(swt):
    return tuple(np.array(x) for x in swt.latest_state)


def run_port(scene, images, cfg=None, record=latest_state):
    """The port's facade over the stream (at `cfg`, `small_config()` by
    default), recording every raw frame, the window it initialized with and
    `record(tracker)` after each call after the initializing one (the
    tracker's latest state by default)."""
    vio = PVIO(small_config() if cfg is None else cfg, device="cpu")
    states, init = [], {}

    def after_call(fi):
        kind, _ = port.after_call()
        swt = vio.core.frontend.swt
        if kind == "init" and not init:
            init.update(fi=fi, window=window_fields(swt.hw))
        elif swt is not None:
            states.append(record(swt))

    with followed(vio) as port:
        drive(vio, scene, images, after_call=after_call)
    return vio, port.raw, init, states


def test_facade_tracking_matches_reference_on_images():
    scene = synthetic.make_scene(duration=2.5, fps=20.0, imu_rate=200.0, n_points=320, seed=648)
    cfg = small_config()
    images = [synthetic.render_frame(scene, fi, cfg.K, cfg.image_size)
              for fi in range(len(scene.frame_t))]
    vio, raw, init, states = run_port(scene, images)
    assert vio.initialized and vio.core.frontend.n_reinits == 0
    assert len(raw) == len(images) and len(states) == len(images) - 1 - init["fi"] >= 20

    cfg_ref = small_config(RefConfig)
    kern = RefKernels(cfg_ref)
    ft = RefFeatureTracker(cfg_ref, kern)
    swt, ref_states = None, []
    for fi, rf in enumerate(raw):
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
    print(f"facade tracking vs the reference: {len(states)} frames after initialization, "
          f"{swt.n_keyframes} keyframes, max |dp| {dp:.3e} m")

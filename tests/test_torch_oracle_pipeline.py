"""The port's `FrontendWorker` on oracle features against the reference.

The oracle tier of `tests/test_pipeline.py::run_oracle`: projected
keypoints with 0.3 px noise and perfect association drive the estimation
chain (initializer, motion step, keyframes, marginalization) at
`small_config` (float64, CPU), on `make_scene(duration=2.5, n_points=320,
seed=648)`.

The port runs the whole stream. The reference's initializer on this scene
is held to the port's in `test_torch_initializer.py` (same frame,
`INIT_FRAME`, same window at 1e-8); to keep this file's time, the
reference's tracker starts here from the port's initialized window, built
as a reference `HostWindow`, and tracks the rest of the stream. They must
make the same keyframe decisions, emit at the same times, and agree on
every position within 1e-6 m (measured 1.6e-12 m). A second port tracker
started from `HostWindow.from_arrays` of the reference's copy must equal
the port's own run bit for bit. The fused and chained keyframe modes are
in `test_torch_oracle_keyframes.py`.
"""

import copy

import jax.numpy as jnp
import numpy as np

from tests.test_torch_harness import small_config
from tests.test_torch_initializer import INIT_FRAME, SCENE, window_fields

from pvio_tpu.core.feature_tracker import RawFrame as RefRawFrame
from pvio_tpu.core.host_window import HostWindow as RefHostWindow
from pvio_tpu.core.kernels import DeviceKernels as RefKernels
from pvio_tpu.core.swt import SlidingWindowTracker as RefSWT
from pvio_tpu.io.config import Config as RefConfig
from pvio_tpu.map import window as ref_win
from pvio_torch.core.frontend_worker import FrontendWorker
from pvio_torch.core.host_window import HostWindow
from pvio_torch.core.kernels import DeviceKernels
from pvio_torch.core.swt import SlidingWindowTracker
from pvio_torch.io import synthetic

MAX_DP_M = 1e-6


def imu_span(scene, fi):
    t = scene.frame_t[fi]
    sel = (scene.imu_t <= t) if fi == 0 else (
        (scene.imu_t >= scene.frame_t[fi - 1]) & (scene.imu_t < t))
    return scene.imu_t[sel], scene.gyro[sel], scene.accel[sel]


def run_port(cfg, scene):
    """`run_oracle` on the port: outputs [(t, p)], the worker, the first
    output's frame and a copy of the window it initialized with."""
    kern = DeviceKernels(cfg, device="cpu")
    oracle = synthetic.OracleFeatureSource(
        scene, cfg.K, cfg.image_size, max_keypoints=cfg.feature_tracker_max_keypoint_detection,
        kp_noise_px=0.3)
    fw = FrontendWorker(cfg, kern, oracle)
    outputs, init_fi, init_window = [], None, None
    for fi in range(len(scene.frame_t)):
        st = fw.issue_frame(oracle.make_frame(fi, fi, *imu_span(scene, fi)))
        if st is not None:
            if init_fi is None:
                init_fi, init_window = fi, window_fields(fw.swt.hw)
            outputs.append((st[0], st[2].copy()))
    return dict(fw=fw, outputs=outputs, init_fi=init_fi, init_window=init_window,
                frames=list(oracle.frames), kern=kern)


def ref_window(fields):
    """A reference HostWindow holding the given fields."""
    F, T = fields["kp"].shape[:2]
    hw = RefHostWindow(F, T, fields["plane_mask"].shape[0], fields["q"].dtype.type)
    for name, v in copy.deepcopy(fields).items():
        setattr(hw, name, v)
    hw.prior = ref_win.MargPrior(*(jnp.asarray(fields["prior"][f])
                                   for f in ref_win.MargPrior._fields))
    return hw


def track_from(swt, frames, first, RawFrameCls):
    """Feed frames[first:] to a tracker as FrontendWorker does (no re-init
    allowed); returns [(t, p)] with the initial state first."""
    outputs = [(swt.latest_state[0], swt.latest_state[2].copy())]
    for rf in frames[first:]:
        rf = RawFrameCls(rf.id, rf.t, rf.kp.copy(), rf.kp_mask.copy(), rf.track_ids.copy(),
                         rf.imu_ts, rf.imu_w, rf.imu_a)
        swt.ft.frames.append(rf)
        assert swt.track(rf), f"tracking lost at frame {rf.id}"
        outputs.append((swt.latest_state[0], swt.latest_state[2].copy()))
    return outputs


class _Frames:
    """The raw-frame book a tracker reads (`frames`, `frame_by_id`)."""

    def __init__(self, frames):
        self.frames = list(frames)
        self.initialized = True

    def frame_by_id(self, frame_id):
        for f in self.frames:
            if f.id == frame_id:
                return f
        return None


def compare(port, ref_outputs, ref_keyframes, what):
    out = port["outputs"]
    assert len(out) == len(ref_outputs), (what, len(out), len(ref_outputs))
    assert [t for t, _ in out] == [t for t, _ in ref_outputs], what
    assert port["fw"].swt.n_keyframes == ref_keyframes, what
    dp = max(float(np.abs(a - b).max()) for (_, a), (_, b) in zip(out, ref_outputs))
    assert dp <= MAX_DP_M, f"{what}: max |dp| {dp:.3e} m"
    return dp


def test_oracle_pipeline_matches_reference():
    cfg = small_config()
    scene = synthetic.make_scene(**SCENE)
    port = run_port(cfg, scene)
    fw = port["fw"]
    assert fw.initialized and fw.n_reinits == 0
    assert port["init_fi"] == INIT_FRAME
    assert len(port["outputs"]) == len(scene.frame_t) - INIT_FRAME
    assert fw.swt.n_keyframes >= 3, fw.swt.n_keyframes

    cfg_ref = small_config(RefConfig)
    first = INIT_FRAME + 1
    ref_frames = [RefRawFrame(f.id, f.t, f.kp, f.kp_mask, f.track_ids, f.imu_ts, f.imu_w,
                              f.imu_a) for f in port["frames"][:first]]
    swt_ref = RefSWT(cfg_ref, RefKernels(cfg_ref), ref_window(port["init_window"]),
                     _Frames(ref_frames))
    ref_out = track_from(swt_ref, port["frames"], first, RefRawFrame)
    compare(port, ref_out, swt_ref.n_keyframes, "oracle pipeline")

    # the port tracker, started from the reference's copy of the window
    hw = HostWindow.from_arrays(window_fields(ref_window(port["init_window"])))
    swt = SlidingWindowTracker(cfg, port["kern"], hw, _Frames(port["frames"][:first]))
    out = track_from(swt, port["frames"], first, type(port["frames"][0]))
    assert swt.n_keyframes == fw.swt.n_keyframes
    for (t1, p1), (t2, p2) in zip(out, port["outputs"]):
        assert t1 == t2
        np.testing.assert_array_equal(p1, p2)

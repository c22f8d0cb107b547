"""The port's `FrontendWorker` with planes on, on oracle features, against
the reference: `tests/test_planes.py::test_pipeline_with_planes`'s
configuration (`plane_config` plus its initializer settings, float64, CPU)
and scene (`make_scene(duration=3.0, n_points=60, n_plane_points=130,
plane_z=4.6, seed=648)`), projected keypoints with 0.3 px noise.

The port runs the whole stream with its `PlaneExtractor`. The reference's
`SlidingWindowTracker`, with a fresh reference `PlaneExtractor` (the port's
is fresh at that point too), starts from the port's initialized window, as
`test_torch_oracle_pipeline.py` does, and tracks the rest of the stream.
They must make the same keyframe decisions and, after every call, the
same plane decisions (`plane_mask`, `plane_ids`, the tracks' `plane_id`
and TF_PLANE flags), with plane normals and distances within
`MAX_PLANE_TOL` and positions within `MAX_DP_M`; the run must hold at
least one plane and at least 10 plane tracks, as the reference's test
asserts.
"""

import numpy as np

from tests.test_torch_oracle_pipeline import _Frames, imu_span, ref_window
from tests.test_torch_initializer import window_fields
from tests.test_torch_planes import plane_config

from pvio_tpu.core.feature_tracker import RawFrame as RefRawFrame
from pvio_tpu.core.kernels import DeviceKernels as RefKernels
from pvio_tpu.core.plane_extractor import PlaneExtractor as RefExtractor
from pvio_tpu.core.swt import SlidingWindowTracker as RefSWT
from pvio_tpu.io.config import Config as RefConfig
from pvio_torch.core.frontend_worker import FrontendWorker
from pvio_torch.core.kernels import DeviceKernels
from pvio_torch.core.plane_extractor import PlaneExtractor
from pvio_torch.io import synthetic
from pvio_torch.map.window import TF_PLANE

MAX_DP_M = 1e-6
MAX_PLANE_TOL = 1e-8


def pipeline_plane_config(cls=None):
    """`test_pipeline_with_planes`'s configuration as a Config of `cls`."""
    cfg = plane_config() if cls is None else plane_config(cls)
    cfg.initializer_keyframe_gap = 4
    cfg.initializer_min_matches = 20
    cfg.initializer_min_parallax = 5.0
    cfg.initializer_min_triangulation = 15
    cfg.initializer_min_landmarks = 15
    cfg.keyframe_min_common_tracks = 20
    cfg.keyframe_parallax_px = 25.0
    cfg.feature_tracker_max_keypoint_detection = 120
    return cfg


def plane_state(swt):
    hw = swt.hw
    live = hw.plane_mask
    return dict(t=swt.latest_state[0], p=swt.latest_state[2].copy(),
                plane_mask=hw.plane_mask.copy(), plane_ids=hw.plane_ids.copy(),
                plane_id=hw.plane_id.copy(), tf_plane=(hw.track_flags & TF_PLANE) != 0,
                normal=hw.plane_normal[live].copy(), distance=hw.plane_distance[live].copy())


def test_oracle_pipeline_with_planes_matches_reference():
    cfg = pipeline_plane_config()
    scene = synthetic.make_scene(duration=3.0, fps=20.0, imu_rate=200.0, n_points=60,
                                 n_plane_points=130, plane_z=4.6, seed=648)
    kern = DeviceKernels(cfg, device="cpu")
    oracle = synthetic.OracleFeatureSource(scene, cfg.K, cfg.image_size, max_keypoints=120,
                                           kp_noise_px=0.3)
    fw = FrontendWorker(cfg, kern, oracle,
                        plane_extractor_factory=lambda: PlaneExtractor(cfg, kern))
    states, init_fi, init_window = [], None, None
    for fi in range(len(scene.frame_t)):
        st = fw.issue_frame(oracle.make_frame(fi, fi, *imu_span(scene, fi)))
        if st is not None:
            if init_fi is None:
                init_fi, init_window = fi, window_fields(fw.swt.hw)
            states.append(plane_state(fw.swt))
    assert fw.initialized and fw.n_reinits == 0
    hw = fw.swt.hw
    n_tracks = max(int(s["tf_plane"].sum()) for s in states)
    assert fw.swt.planes.next_plane_id >= 1 and n_tracks >= 10, n_tracks
    assert any(s["plane_mask"].any() for s in states)

    cfg_ref = pipeline_plane_config(RefConfig)
    kern_ref = RefKernels(cfg_ref)
    first = init_fi + 1
    frames = list(oracle.frames)
    ref_frames = [RefRawFrame(f.id, f.t, f.kp, f.kp_mask, f.track_ids, f.imu_ts, f.imu_w, f.imu_a)
                  for f in frames[:first]]
    swt_ref = RefSWT(cfg_ref, kern_ref, ref_window(init_window), _Frames(ref_frames),
                     RefExtractor(cfg_ref, kern_ref))
    ref_states = [plane_state(swt_ref)]
    for rf in frames[first:]:
        rf = RefRawFrame(rf.id, rf.t, rf.kp.copy(), rf.kp_mask.copy(), rf.track_ids.copy(),
                         rf.imu_ts, rf.imu_w, rf.imu_a)
        swt_ref.ft.frames.append(rf)
        assert swt_ref.track(rf), f"reference tracking lost at frame {rf.id}"
        ref_states.append(plane_state(swt_ref))

    assert swt_ref.n_keyframes == fw.swt.n_keyframes
    assert len(states) == len(ref_states)
    dp = dn = 0.0
    for k, (a, b) in enumerate(zip(states, ref_states)):
        assert a["t"] == b["t"], k
        for name in ("plane_mask", "plane_ids", "plane_id", "tf_plane"):
            np.testing.assert_array_equal(a[name], b[name], err_msg=f"call {k}: {name}")
        dp = max(dp, float(np.abs(a["p"] - b["p"]).max()))
        if len(b["normal"]):
            dn = max(dn, float(np.abs(a["normal"] - b["normal"]).max()),
                     float(np.abs(a["distance"] - b["distance"]).max()))
    print(f"oracle pipeline with planes: init frame {init_fi}, {fw.swt.n_keyframes} keyframes, "
          f"{fw.swt.planes.next_plane_id} planes, plane tracks max {n_tracks}, max |dp| "
          f"{dp:.3e} m, max |dn|, |dd| {dn:.3e}")
    assert dp <= MAX_DP_M and dn <= MAX_PLANE_TOL, (dp, dn)
    assert hw.plane_mask.sum() >= 1

"""The port's `PVIO` facade with planes on, on the CPU (float64): the image
tier of the plane subsystem.

On the plane scene of `tests/test_planes.py` (`make_scene(duration=3.0,
n_points=60, n_plane_points=130, plane_z=4.6, seed=648)`) rendered as blob
frames at 320x240, with its `plane_config` and the initializer settings of
`test_pipeline_with_planes`, the sequential fused loop and the pipelined
loop at depth 2 with chained keyframes emit the same trajectory bit for
bit; both detect a plane, hold plane tracks and never re-initialize.
`PVIO(Config())` builds a plane extractor on the engine's kernels, and a
reset engine gets a fresh one on the same kernels.
"""

import functools

import numpy as np
import pytest
import torch

from tests.test_torch_facade import drive
from tests.test_torch_facade_modes import assert_same_trajectory
from tests.test_torch_planes import plane_config

from pvio_torch import PVIO
from pvio_torch.core.plane_extractor import PlaneExtractor
from pvio_torch.io import synthetic
from pvio_torch.io.config import Config
from pvio_torch.map.window import TF_PLANE

torch.set_num_threads(2)


def facade_plane_config(**kw):
    cfg = plane_config()
    cfg.initializer_keyframe_gap = 4
    cfg.initializer_min_matches = 20
    cfg.initializer_min_parallax = 5.0
    cfg.initializer_min_triangulation = 15
    cfg.initializer_min_landmarks = 15
    cfg.keyframe_min_common_tracks = 20
    cfg.keyframe_parallax_px = 25.0
    cfg.feature_tracker_max_keypoint_detection = 120
    cfg.feature_tracker_min_keypoint_distance = 12.0
    cfg.feature_tracker_detect_min_free = 0
    cfg.fused_keyframe = True
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


@functools.lru_cache(maxsize=None)
def scene_and_images():
    scene = synthetic.make_scene(duration=3.0, fps=20.0, imu_rate=200.0, n_points=60,
                                 n_plane_points=130, plane_z=4.6, seed=648)
    cfg = facade_plane_config()
    return scene, [synthetic.render_frame(scene, fi, cfg.K, cfg.image_size)
                   for fi in range(len(scene.frame_t))]


def run(**kw):
    scene, images = scene_and_images()
    vio = PVIO(facade_plane_config(**kw), device="cpu")
    planes_seen, plane_tracks = [], []

    def after(fi):
        swt = vio.core.frontend.swt
        if swt is not None:
            planes_seen.append(int(swt.hw.plane_mask.sum()))
            plane_tracks.append(int(((swt.hw.track_flags & TF_PLANE) != 0).sum()))

    drive(vio, scene, images, after_call=after)
    return vio, vio.get_trajectory(), max(planes_seen, default=0), max(plane_tracks, default=0)


def test_planes_on_facade_sequential_equals_pipelined_chained():
    vio, traj, n_planes, n_tracks = run()
    assert vio.initialized and vio.core.frontend.n_reinits == 0
    assert vio.core.frontend.swt.planes is not None
    assert n_planes >= 1 and n_tracks >= 10, (n_planes, n_tracks)
    assert len(vio.get_planes()) >= 1
    vio2, traj2, n_planes2, n_tracks2 = run(pipelined_host=True, chained_keyframe=True,
                                            pipeline_depth=2)
    assert vio2.core._pipeline_depth == 2 and vio2.core.frontend.n_reinits == 0
    assert_same_trajectory(traj, traj2, "planes on: pipelined depth 2 + chained")
    assert n_planes2 >= 1 and n_tracks2 >= 10, (n_planes2, n_tracks2)
    # after the drain both windows hold the same plane decisions
    hw, hw2 = vio.core.frontend.swt.hw, vio2.core.frontend.swt.hw
    for name in ("plane_mask", "plane_ids", "plane_id", "track_flags", "track_id"):
        np.testing.assert_array_equal(getattr(hw, name), getattr(hw2, name), err_msg=name)
    for a, b in zip(vio.get_planes(), vio2.get_planes()):
        np.testing.assert_array_equal(a.normal, b.normal)
        assert a.distance == b.distance


def test_default_config_builds_the_plane_extractor(monkeypatch):
    cfg = Config()
    assert cfg.enable_plane_constraint
    vio = PVIO(cfg, device="cpu")
    kern = vio.core.kernels
    pe = vio.core.frontend._pef()
    assert isinstance(pe, PlaneExtractor) and pe.k is kern
    vio.reset()
    assert vio.core.kernels is kern
    pe2 = vio.core.frontend._pef()
    assert pe2 is not pe and pe2.k is kern and pe2.next_plane_id == 0
    assert vio.core.frontend._pef is not None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PVIO(Config())
    assert PVIO(Config(), enable_planes=False, device="cpu").core.frontend._pef is None

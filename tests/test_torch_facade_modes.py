"""The port's host-loop modes are bit-identical to each other across a
tracking loss and re-initialization (mirrors
`tests/test_pipeline.py:260-310`): the sequential loop and the pipelined
loop (`Config.pipelined_host`) on rendered blob frames with a blackout
(`small_config`, float64, CPU, the native sensor hub). With
`small_config`'s `feature_tracker_detect_min_free` (8) `Core` caps a
requested depth 2 at 1, as the reference does, so the reference's depth-2
run repeats its depth-1 run; here the cap is asserted instead, and
`test_torch_facade_chained.py` runs a real depth 2.
"""

import numpy as np

from tests.test_torch_facade import drive
from tests.test_torch_harness import small_config

from pvio_torch import PVIO
from pvio_torch.io import synthetic

BLACKOUT = range(55, 61)


def scene_and_images():
    scene = synthetic.make_scene(duration=5.0, fps=20.0, imu_rate=200.0, n_points=320, seed=648)
    cfg = small_config()
    return scene, [synthetic.render_frame(scene, fi, cfg.K, cfg.image_size)
                   for fi in range(len(scene.frame_t))]


def run(scene, images, **kw):
    vio = PVIO(small_config(**kw), device="cpu")
    assert vio.core.hub is not None, "the native sensor hub did not build"
    drive(vio, scene, images, BLACKOUT)
    return vio.get_trajectory(), vio.core.frontend.n_reinits, vio.initialized


def assert_same_trajectory(a, b, what):
    assert len(a) == len(b), (what, len(a), len(b))
    for (t1, q1, p1), (t2, q2, p2) in zip(a, b):
        assert t1 == t2, what
        np.testing.assert_array_equal(p1, p2, err_msg=f"{what}, t={t1}")
        np.testing.assert_array_equal(q1, q2, err_msg=f"{what}, t={t1}")


def test_pipelined_host_bit_identical():
    scene, images = scene_and_images()
    traj_seq, reinits_seq, init_seq = run(scene, images)
    assert init_seq and reinits_seq >= 1, "the scene must exercise a re-init segment"
    traj, reinits, init = run(scene, images, pipelined_host=True, pipeline_depth=1)
    assert init and reinits == reinits_seq
    assert_same_trajectory(traj_seq, traj, "depth 1")
    capped = PVIO(small_config(pipelined_host=True, pipeline_depth=2), device="cpu")
    assert capped.core._pipelined and capped.core._pipeline_depth == 1

"""The port's production fast path — pipelined host loop at depth 2 with
fused and chained keyframes — is bit-identical to the sequential fused
loop across a tracking loss and re-initialization (mirrors
`tests/test_pipeline.py:313-360`). `feature_tracker_detect_min_free` is 0
in both runs, so `Core` keeps two frames in flight.
"""

from tests.test_torch_facade_modes import assert_same_trajectory, run, scene_and_images


def test_pipelined_chained_keyframe_bit_identical():
    scene, images = scene_and_images()
    common = dict(fused_keyframe=True, feature_tracker_detect_min_free=0, pipeline_depth=2)
    traj_seq, reinits_seq, init_seq = run(scene, images, **common)
    assert init_seq and reinits_seq >= 1, "the scene must exercise a re-init segment"
    traj, reinits, init = run(scene, images, pipelined_host=True, chained_keyframe=True, **common)
    assert init and reinits == reinits_seq
    assert_same_trajectory(traj_seq, traj, "pipelined depth 2 + chained")

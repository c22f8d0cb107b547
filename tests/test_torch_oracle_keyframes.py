"""The port's fused and chained keyframe modes on oracle features.

`Config.fused_keyframe` (one `kf_step` per keyframe) against the
reference's fused tracker, started from the port's initialized window as
in `test_torch_oracle_pipeline.py` (same scene and `small_config`,
float64, CPU), and `Config.chained_keyframe` (`kf_step_chained` on the
motion step's device outputs) bit-identical to the fused run, as
`tests/test_pipeline.py:228-257` holds the reference.
"""

import numpy as np

from tests.test_torch_harness import small_config
from tests.test_torch_initializer import INIT_FRAME, SCENE
from tests.test_torch_oracle_pipeline import (
    _Frames, compare, ref_window, run_port, track_from)

from pvio_tpu.core.feature_tracker import RawFrame as RefRawFrame
from pvio_tpu.core.kernels import DeviceKernels as RefKernels
from pvio_tpu.core.swt import SlidingWindowTracker as RefSWT
from pvio_tpu.io.config import Config as RefConfig
from pvio_torch.io import synthetic


def test_oracle_fused_and_chained_keyframes():
    """fused_keyframe on: the port against the reference's fused tracker;
    chained_keyframe on and off bit-identical (tests/test_pipeline.py:
    228-257)."""
    scene = synthetic.make_scene(**SCENE)
    fused = run_port(small_config(fused_keyframe=True), scene)
    chained = run_port(small_config(fused_keyframe=True, chained_keyframe=True), scene)
    for run in (fused, chained):
        assert run["fw"].initialized and run["fw"].n_reinits == 0
        assert run["init_fi"] == INIT_FRAME
    assert chained["fw"].swt.n_keyframes == fused["fw"].swt.n_keyframes >= 3
    assert len(chained["outputs"]) == len(fused["outputs"])
    for (t1, p1), (t2, p2) in zip(fused["outputs"], chained["outputs"]):
        assert t1 == t2
        np.testing.assert_array_equal(p1, p2, err_msg=f"t={t1}")

    cfg_ref = small_config(RefConfig, fused_keyframe=True)
    first = INIT_FRAME + 1
    ref_frames = [RefRawFrame(f.id, f.t, f.kp, f.kp_mask, f.track_ids, f.imu_ts, f.imu_w,
                              f.imu_a) for f in fused["frames"][:first]]
    swt_ref = RefSWT(cfg_ref, RefKernels(cfg_ref), ref_window(fused["init_window"]),
                     _Frames(ref_frames))
    ref_out = track_from(swt_ref, fused["frames"], first, RefRawFrame)
    compare(fused, ref_out, swt_ref.n_keyframes, "fused keyframes")

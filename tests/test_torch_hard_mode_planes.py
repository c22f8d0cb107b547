"""The plane subsystem under the golden hard mode's noise: the port's
`FrontendWorker` with planes on against the reference's sliding-window
tracker and plane extractor, on oracle features.

`test_torch_oracle_planes.py`'s plane scene and configuration with the
hard mode's overrides (`tests/test_golden_run.py:140-152`): the keypoint
budget cut by a third (120 to 80), keypoint sigma 1.5 px declared, and a
noisy IMU (gyro 1e-3, accel 1e-2). The oracle's keypoints carry 1.0 px of
noise (0.3 px in the clean test; at 1.5 px no plane forms on this scene,
so there would be no plane decision to compare). Under noise the
adoption and escape gates decide on noise-dominated residuals; the port
must make the same keyframe and plane decisions after every call, with
plane normals and distances within 1e-8 and positions within 1e-6 m, and
hold a plane with at least 10 plane tracks.
"""

import numpy as np

from tests.test_torch_oracle_planes import check_oracle_planes


def test_oracle_pipeline_with_planes_matches_reference_under_hard_mode_noise():
    check_oracle_planes(kp_noise_px=1.0, imu_noise=1.0, feature_tracker_max_keypoint_detection=80,
                        camera_noise_cov=np.eye(2) * 1.5 ** 2)

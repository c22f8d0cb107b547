"""Model presets: ready-to-run engine configurations.

The port's own copy of `pvio_tpu/models/presets.py`: `euroc`, `tum_vi`,
`vio_no_planes`, `fast`, `PRESETS`, `config` and `build` (a live
`pvio_torch.PVIO`, on CUDA unless `device="cpu"`). Each preset returns a
fully populated `Config` for one deployment shape of the framework:

  * ``euroc``          — EuRoC MAV mono+IMU with plane priors (the
                         paper's headline configuration, config/euroc.yaml:1-67)
  * ``tum_vi``         — TUM-VI 512 fisheye (equidistant undistortion +
                         TUM-VI IMU noise, config/tum-vi.yaml:1-67)
  * ``vio_no_planes``  — plane constraint disabled
                         (PVIO_ENABLE_PLANE_CONSTRAINT=OFF analog)
  * ``fast``           — reduced budgets for latency-critical serving
                         (smaller window/track caps, fewer LM iterations)

The reference's `batched_solver` and `sharded_solver` wait for the port's
parallel layer.
"""

import os

import numpy as np

from pvio_torch.io.config import Config

_CONFIG_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "config",
)


def euroc() -> Config:
    """EuRoC MAV (ASL format), mono + IMU, plane priors ON."""
    path = os.path.join(_CONFIG_DIR, "euroc.yaml")
    return Config.from_yaml(path) if os.path.exists(path) else Config()


def tum_vi() -> Config:
    """TUM-VI 512_16 fisheye (equidistant model) + TUM-VI IMU noise.

    The reference hardcodes the 512x512 geometry in its dataset reader
    (tum_dataset_reader.cpp:73-81) rather than the YAML; mirror that here
    so the preset is complete on its own."""
    path = os.path.join(_CONFIG_DIR, "tum-vi.yaml")
    cfg = Config.from_yaml(path) if os.path.exists(path) else Config()
    cfg.image_size = (512, 512)
    if cfg.camera_distortion_model == "none":
        cfg.camera_distortion_model = "equidistant"
    return cfg


def vio_no_planes() -> Config:
    cfg = euroc()
    cfg.enable_plane_constraint = False
    return cfg


def fast() -> Config:
    """Latency-lean preset: smaller fixed shapes (half the tracks, 6-frame
    window, 6 LM iterations)."""
    cfg = euroc()
    cfg.sliding_window_size = 6
    cfg.window_frame_capacity = 7
    cfg.track_capacity = 128
    cfg.feature_tracker_max_keypoint_detection = 100
    cfg.solver_iteration_limit = 6
    return cfg


PRESETS = {
    "euroc": euroc,
    "tum_vi": tum_vi,
    "vio_no_planes": vio_no_planes,
    "fast": fast,
}


def config(name: str) -> Config:
    try:
        return PRESETS[name]()
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")


def build(name: str, device=None):
    """Construct a live PVIO engine from a preset name (CUDA unless
    device says otherwise)."""
    from pvio_torch.api import PVIO

    return PVIO(config(name), device=device)

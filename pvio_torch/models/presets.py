"""Model presets: ready-to-run engine configurations.

The port's own copy of `pvio_tpu/models/presets.py`: `euroc`, `tum_vi`,
`vio_no_planes`, `fast`, `PRESETS`, `config`, `build` (a live
`pvio_torch.PVIO`, on CUDA unless `device="cpu"`), `batched_solver` (the
keyframe BA vmapped over sequences) and `sharded_solver` (the BA over a
dp x tp process mesh, on the mesh's device). Each preset returns a
fully populated `Config` for one deployment shape of the framework:

  * ``euroc``          — EuRoC MAV mono+IMU with plane priors (the
                         paper's headline configuration, config/euroc.yaml:1-67)
  * ``tum_vi``         — TUM-VI 512 fisheye (equidistant undistortion +
                         TUM-VI IMU noise, config/tum-vi.yaml:1-67)
  * ``vio_no_planes``  — plane constraint disabled
                         (PVIO_ENABLE_PLANE_CONSTRAINT=OFF analog)
  * ``fast``           — reduced budgets for latency-critical serving
                         (smaller window/track caps, fewer LM iterations)
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


def _solver_parts(cfg: Config, device):
    """The extrinsics on `device` and the BAConfig of a fleet solver."""
    import torch

    from pvio_torch.estimation import ba as ba_mod
    from pvio_torch.map.window import Extrinsics

    dtype = torch.float32 if cfg.dtype == "float32" else torch.float64

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype, device=device)

    extr = Extrinsics(q_bc=t(cfg.q_bc), p_bc=t(cfg.p_bc), q_bi=t(cfg.q_bi), p_bi=t(cfg.p_bi))
    ba_cfg = ba_mod.BAConfig(
        iterations=cfg.solver_iteration_limit,
        kp_sqrt_inv_cov=cfg.kp_sqrt_inv_cov,
        use_planes=cfg.enable_plane_constraint,
    )
    return extr, ba_cfg


def batched_solver(cfg: Config = None, device=None):
    """Deployment model: the keyframe-BA step vmapped over a batch of
    sequences (BASELINE.json config 4), on CUDA unless `device` says
    otherwise. Returns (step_fn, ba_config)."""
    from pvio_torch.core.kernels import resolve_device
    from pvio_torch.parallel import batch as batch_mod

    extr, ba_cfg = _solver_parts(cfg or euroc(), resolve_device(device))
    return batch_mod.make_batched_keyframe_step(extr, ba_cfg), ba_cfg


def sharded_solver(mesh, cfg: Config = None):
    """Deployment model: distributed BA over a dp x tp process mesh
    (`parallel.sharded_ba.ProcessMesh`; BASELINE.json config 5), on the
    mesh's device. Returns the sharded solver callable."""
    from pvio_torch.parallel import sharded_ba

    extr, ba_cfg = _solver_parts(cfg or euroc(), mesh.device)
    return sharded_ba.make_sharded_solver(mesh, extr, ba_cfg)

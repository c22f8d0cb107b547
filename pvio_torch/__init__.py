"""pvio_torch — the PyTorch / CUDA port of pvio_tpu for one NVIDIA H100.

A second package beside `pvio_tpu`, which stays the reference: each module
here mirrors the reference module of the same path and names the
functions it matches. The port imports `torch` and never `jax` or
`pvio_tpu`. Its hand-written Hopper kernels live in `pvio_torch/csrc/` and
are built with nvcc at first use into `pvio_torch/_build/`.

Public API (plane priors on, as `Config()` defaults):

    from pvio_torch import PVIO, Config
    vio = PVIO(Config())                  # CUDA; device="cpu" to opt out
    vio.track_gyroscope(t, x, y, z)
    vio.track_accelerometer(t, x, y, z)
    pose = vio.track_camera(t, image_u8)

The device steps alone: `DeviceKernels(Config())`. From a dataset on disk:
`python -m pvio_torch.run euroc://<dir> config/euroc.yaml` (`pvio_torch/run.py`).
"""

from pvio_torch.version import __version__, version_info

__all__ = ["__version__", "version_info", "Config", "DeviceKernels", "PVIO", "OutputPose",
           "OutputState", "OutputMapPoint", "OutputPlane"]

_LAZY = {
    "Config": ("pvio_torch.io.config", "Config"),
    "DeviceKernels": ("pvio_torch.core.kernels", "DeviceKernels"),
    "PVIO": ("pvio_torch.api", "PVIO"),
    "OutputPose": ("pvio_torch.api", "OutputPose"),
    "OutputState": ("pvio_torch.api", "OutputState"),
    "OutputMapPoint": ("pvio_torch.api", "OutputMapPoint"),
    "OutputPlane": ("pvio_torch.api", "OutputPlane"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'pvio_torch' has no attribute {name!r}")

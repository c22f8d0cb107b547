"""pvio_torch — the PyTorch / CUDA port of pvio_tpu for one NVIDIA H100.

A second package beside `pvio_tpu`, which stays the reference: each module
here mirrors the reference module of the same path and names the
functions it matches. The port imports `torch` and never `jax` or
`pvio_tpu`. Its hand-written Hopper kernels live in `pvio_torch/csrc/` and
are built with nvcc at first use into `pvio_torch/_build/`.

Entry point of the ported slice (per-frame frontend + motion step):

    from pvio_torch import Config, DeviceKernels
    kern = DeviceKernels(Config())          # CUDA; device="cpu" to opt out
    pyr, resp, kp, mask = kern.first_frame_step(image_u8)
"""

__all__ = ["Config", "DeviceKernels"]

_LAZY = {
    "Config": ("pvio_torch.io.config", "Config"),
    "DeviceKernels": ("pvio_torch.core.kernels", "DeviceKernels"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'pvio_torch' has no attribute {name!r}")

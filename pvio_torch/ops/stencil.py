"""Kernel K1: the fused Shi-Tomasi corner response, hand-written for Hopper.

Replaces the Pallas TPU kernel `pvio_tpu/ops/stencil.py:_shi_tomasi_kernel`
(entered through `shi_tomasi_response_tpu`). The CUDA source is
`pvio_torch/csrc/shi_tomasi.cu` (sm_90a), built with nvcc at first use and
bound with ctypes; its header states the design and the bound (one read +
one write of the image, ~2.9 MB at 480x752, ~0.86 us at 3.35 TB/s, so
launch latency sets its time at this size).

`shi_tomasi_response(img)` is the dispatching wrapper: a CPU tensor takes
the plain PyTorch version (`frontend.detect.shi_tomasi_response`, the
oracle); a CUDA tensor launches the kernel or raises. Like the TPU wrapper
(`pvio_tpu/ops/stencil.py:83-100`) it computes in float32 and returns the
input dtype. The plain version and the kernel agree over the WHOLE image,
borders included (zero padding for the image taps, zero gradient products
outside the image).

`LAUNCHES` counts kernel launches, so a run can show that its main path
went through the kernel.
"""

import ctypes

import torch

from pvio_torch.frontend import detect
from pvio_torch.utils import cuda_build

SOURCE = cuda_build.CSRC / "shi_tomasi.cu"
LAUNCHES = 0
_LIB = None

# floating-point operations per output pixel: Scharr x and y (9 each),
# three gradient products, three 3x3 box means (9 each), lambda_min (9)
FLOPS_PER_PIXEL = 2 * 9 + 3 + 3 * 9 + 9


def cost(H, W):
    """(bytes, flops) the response must move and compute at (H, W) in
    float32: the image read once, the response written once."""
    return 2 * H * W * 4, FLOPS_PER_PIXEL * H * W


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load(SOURCE)
        fn = lib.pvio_shi_tomasi
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def build():
    """Compile (if needed) and load the kernel. Returns nvcc's output."""
    _, log = cuda_build.build(SOURCE)
    _lib()
    return log


def shi_tomasi_response_cuda(img):
    """Launch K1 on a 2-D CUDA tensor; returns (H, W) in img's dtype."""
    global LAUNCHES
    if img.device.type != "cuda":
        raise ValueError(f"shi_tomasi_response_cuda: needs a CUDA tensor, got {img.device}")
    if img.dim() != 2:
        raise ValueError(f"shi_tomasi_response_cuda: needs (H, W), got {tuple(img.shape)}")
    x = img if img.dtype == torch.float32 else img.to(torch.float32)
    if not x.is_contiguous():
        raise ValueError("shi_tomasi_response_cuda: input must be contiguous")
    H, W = x.shape
    if H == 0 or W == 0 or H * W >= 2 ** 31:
        raise ValueError(f"shi_tomasi_response_cuda: unsupported shape {(H, W)}")
    out = torch.empty_like(x)
    fn = _lib().pvio_shi_tomasi
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), H, W, stream)
    if err != 0:
        raise RuntimeError(f"shi_tomasi kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out if img.dtype == torch.float32 else out.to(img.dtype)


def shi_tomasi_response(img):
    """Min-eigenvalue corner response: the plain version for a CPU tensor,
    the Hopper kernel for a CUDA tensor."""
    if img.device.type == "cpu":
        return detect.shi_tomasi_response(img)
    if img.device.type == "cuda":
        return shi_tomasi_response_cuda(img)
    raise ValueError(f"shi_tomasi_response: unsupported device {img.device}")

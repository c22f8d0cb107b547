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

`launch_plan(H, W, data_ptr)` is the launcher's rule in Python: the tile,
the grid and whether the tile arrives by TMA or by per-thread loads. The
CUDA launcher (`pvio_shi_tomasi_plan`) follows the same rule.

`LAUNCHES` counts kernel launches, so a run can show that its main path
went through the kernel.
"""

import contextlib
import ctypes
from typing import NamedTuple

import torch

from pvio_torch.frontend import detect
from pvio_torch.utils import cuda_build

SOURCE = cuda_build.CSRC / "shi_tomasi.cu"
LAUNCHES = 0
_LIB = None

# floating-point operations per output pixel: Scharr x and y (9 each),
# three gradient products, three 3x3 box means (9 each), lambda_min (9)
FLOPS_PER_PIXEL = 2 * 9 + 3 + 3 * 9 + 9

# the kernel's output tile (rows, columns), as TH / TW in shi_tomasi.cu, and
# where its input box starts relative to the tile: 2 rows up (the halo), 4
# columns left (the halo rounded up so that the box starts on 16 B, which
# TMA requires); the box reaches as far past the tile on the other side
TILE = (24, 128)
BOX_OFFSET = (-2, -4)


class Plan(NamedTuple):
    tile: tuple      # (rows, columns) of output per block
    grid: tuple      # (blocks across, blocks down)
    box: tuple       # (rows, columns) of the input box the block loads
    tma: bool        # True: one TMA copy loads the tile; False: per-thread loads


def launch_plan(H, W, data_ptr):
    """The launch of K1 for an (H, W) float32 image at address data_ptr.
    TMA needs a 16-B aligned base and a row stride that is a multiple of
    16 B; any other input takes the kernel's per-thread load stage."""
    th, tw = TILE
    return Plan(tile=TILE, grid=(-(-W // tw), -(-H // th)),
                box=(th - 2 * BOX_OFFSET[0], tw - 2 * BOX_OFFSET[1]),
                tma=W % 4 == 0 and data_ptr % 16 == 0)


def cost(H, W):
    """(bytes, flops) the response must move and compute at (H, W) in
    float32: the image read once, the response written once."""
    return 2 * H * W * 4, FLOPS_PER_PIXEL * H * W


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load(SOURCE)
        lib.pvio_shi_tomasi.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_void_p]
        lib.pvio_shi_tomasi.restype = ctypes.c_int
        lib.pvio_shi_tomasi_plan.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                             ctypes.POINTER(ctypes.c_int)]
        lib.pvio_shi_tomasi_plan.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def build():
    """Compile (if needed) and load the kernel. Returns nvcc's output."""
    _, log = cuda_build.build(SOURCE)
    _lib()
    return log


def kernel_plan(H, W, data_ptr):
    """The plan the CUDA launcher takes (its own rule, compiled), as a
    Plan, so it can be held against launch_plan."""
    p = (ctypes.c_int * 7)()
    _lib().pvio_shi_tomasi_plan(H, W, data_ptr, p)
    return Plan(tile=(p[0], p[1]), grid=(p[2], p[3]), box=(p[5], p[6]), tma=bool(p[4]))


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
    idx = x.device.index
    # the launcher launches on the current device: switch only when needed
    with (contextlib.nullcontext() if idx == torch.cuda.current_device()
          else torch.cuda.device(idx)):
        err = fn(x.data_ptr(), out.data_ptr(), H, W, torch._C._cuda_getCurrentRawStream(idx))
    if err < 0:
        raise RuntimeError(f"shi_tomasi kernel: cuTensorMapEncodeTiled failed: CUresult {-err}")
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

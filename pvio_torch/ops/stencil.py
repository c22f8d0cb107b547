"""Kernel K1: the fused Shi-Tomasi corner response, hand-written for Hopper.

Replaces the Pallas TPU kernel `pvio_tpu/ops/stencil.py:_shi_tomasi_kernel`
(entered through `shi_tomasi_response_tpu`). The CUDA source is
`pvio_torch/csrc/shi_tomasi.cu` (sm_90a), built with nvcc at first use and
bound with ctypes; its header states the design and the bound (one read +
one write of the image, ~2.9 MB at 480x752, ~0.86 us at 3.35 TB/s, so
launch latency sets its time at this size).

`shi_tomasi_response(img)` is the dispatching wrapper, the custom op
`pvio::shi_tomasi` on an (H, W) image or a (..., H, W) stack: a CPU tensor
takes the plain PyTorch version (`frontend.detect.shi_tomasi_response`,
the oracle, image by image); a CUDA tensor launches the kernel or raises.
The kernel computes at the image's dtype, as the plain version does: float64
for a float64 image, float32 for any other (cast in, and the response cast
back). The TPU wrapper (`pvio_tpu/ops/stencil.py:83-100`) computes in
float32 whatever the dtype; a float32 response at float64 moved the card's
60 s float64 run off the reference's outcome (fault F7, ROADMAP §3), so the
float64 form exists. The plain version and the kernel agree
over the WHOLE image, borders included (zero padding for the image taps,
zero gradient products outside the image). The op's vmap rule moves the
batch dimension to the front and makes ONE launch for the whole stack, so
`torch.func.vmap` of a frame step over B sequences launches K1 once.

`launch_plan(H, W, data_ptr)` is the launcher's rule in Python: the tile,
the grid and whether the tile arrives by TMA or by per-thread loads. The
CUDA launcher (`pvio_shi_tomasi_plan`) follows the same rule.

`LAUNCHES` counts kernel launches (one for a whole stack), so a run can
show that its main path went through the kernel.
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


def launch_plan(H, W, data_ptr, itemsize=4):
    """The launch of K1 for an (H, W) image of `itemsize`-byte elements
    (float32, or 8 for float64) at address data_ptr. TMA needs a 16-B
    aligned base and a row stride that is a multiple of 16 B; any other
    input takes the kernel's per-thread load stage."""
    th, tw = TILE
    return Plan(tile=TILE, grid=(-(-W // tw), -(-H // th)),
                box=(th - 2 * BOX_OFFSET[0], tw - 2 * BOX_OFFSET[1]),
                tma=(W * itemsize) % 16 == 0 and data_ptr % 16 == 0)


def compute_dtype(dtype):
    """The dtype K1 computes in for an image of `dtype`: float64 stays,
    anything else is computed in float32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def cost(H, W, B=1, itemsize=4):
    """(bytes, flops) the response must move and compute for B images of
    (H, W) at `itemsize` bytes an element: each image read once, each
    response written once."""
    return 2 * B * H * W * itemsize, FLOPS_PER_PIXEL * B * H * W


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load(SOURCE)
        lib.pvio_shi_tomasi.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.pvio_shi_tomasi.restype = ctypes.c_int
        lib.pvio_shi_tomasi_f64.argtypes = lib.pvio_shi_tomasi.argtypes
        lib.pvio_shi_tomasi_f64.restype = ctypes.c_int
        lib.pvio_shi_tomasi_plan.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                             ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.pvio_shi_tomasi_plan.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def build():
    """Compile (if needed) and load the kernel. Returns nvcc's output."""
    _, log = cuda_build.build(SOURCE)
    _lib()
    return log


def kernel_plan(H, W, data_ptr, itemsize=4):
    """The plan the CUDA launcher takes (its own rule, compiled), as a
    Plan, so it can be held against launch_plan."""
    p = (ctypes.c_int * 7)()
    _lib().pvio_shi_tomasi_plan(H, W, data_ptr, itemsize, p)
    return Plan(tile=(p[0], p[1]), grid=(p[2], p[3]), box=(p[5], p[6]), tma=bool(p[4]))


def shi_tomasi_response_cuda(img):
    """Launch K1 once on a contiguous CUDA tensor of one (H, W) image or a
    (..., H, W) stack, in `compute_dtype(img.dtype)`; returns the responses
    in img's dtype."""
    global LAUNCHES
    if img.device.type != "cuda":
        raise ValueError(f"shi_tomasi_response_cuda: needs a CUDA tensor, got {img.device}")
    if img.dim() < 2:
        raise ValueError(f"shi_tomasi_response_cuda: needs (..., H, W), got {tuple(img.shape)}")
    cdt = compute_dtype(img.dtype)
    x = img if img.dtype == cdt else img.to(cdt)
    if not x.is_contiguous():
        raise ValueError("shi_tomasi_response_cuda: input must be contiguous")
    H, W = x.shape[-2:]
    B = x.numel() // max(H * W, 1)
    if H == 0 or W == 0 or B == 0 or H * W >= 2 ** 31 or B > 65535:
        raise ValueError(f"shi_tomasi_response_cuda: unsupported shape {tuple(x.shape)}")
    out = torch.empty_like(x)
    fn = _lib().pvio_shi_tomasi_f64 if cdt == torch.float64 else _lib().pvio_shi_tomasi
    idx = x.device.index
    # the launcher launches on the current device: switch only when needed
    with (contextlib.nullcontext() if idx == torch.cuda.current_device()
          else torch.cuda.device(idx)):
        err = fn(x.data_ptr(), out.data_ptr(), B, H, W, torch._C._cuda_getCurrentRawStream(idx))
    if err < 0:
        raise RuntimeError(f"shi_tomasi kernel: cuTensorMapEncodeTiled failed: CUresult {-err}")
    if err != 0:
        raise RuntimeError(f"shi_tomasi kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out if img.dtype == cdt else out.to(img.dtype)


@torch.library.custom_op("pvio::shi_tomasi", mutates_args=(), device_types="cpu")
def _shi_tomasi_op(img: torch.Tensor) -> torch.Tensor:
    if img.dim() == 2:
        return detect.shi_tomasi_response(img)
    H, W = img.shape[-2:]
    flat = img.reshape(-1, H, W)
    return torch.stack([detect.shi_tomasi_response(x) for x in flat]).reshape(img.shape)


@_shi_tomasi_op.register_kernel("cuda")
def _(img):
    return shi_tomasi_response_cuda(img)


@_shi_tomasi_op.register_fake
def _(img):
    return torch.empty_like(img)


@torch.library.register_vmap("pvio::shi_tomasi")
def _(info, in_dims, img):
    if in_dims[0] is None:
        return _shi_tomasi_op(img), None
    return _shi_tomasi_op(img.movedim(in_dims[0], 0).contiguous()), 0


def shi_tomasi_response(img):
    """Min-eigenvalue corner response of an (H, W) image or a (..., H, W)
    stack: the plain version for a CPU tensor, the Hopper kernel for a
    CUDA tensor (one launch for the stack)."""
    if img.device.type not in ("cpu", "cuda"):
        raise ValueError(f"shi_tomasi_response: unsupported device {img.device}")
    return _shi_tomasi_op(img)

"""Kernel E1: eigen-decomposition of 4x4 symmetric matrices on the card.

A kernel of the port only: the reference calls `jnp.linalg.eigh`, which
XLA runs on the device with no host read. `torch.linalg.eigh` computes the
same on the card but then reads its error codes on the host, which makes
every DLT triangulation (`geometry/triangulation.py::triangulate_homogeneous`,
a 4x4 normal matrix per point: the motion step's virtual-view
triangulation, the keyframe step's post-solve one and the initializer's
two-view one) wait for the device. The CUDA source is
`pvio_torch/csrc/sym_eig.cu` (sm_90a, cyclic Jacobi, one thread per
matrix, in float64 whatever the input type), built with nvcc at first use
and bound with ctypes; its header states the design and the bound.

`eigh(A)` is the dispatching wrapper, the custom op `pvio::sym_eig` on a
(..., n, n) stack of symmetric matrices: a CPU tensor takes the plain
version, `torch.linalg.eigh` (the reference's function, which the CPU
parity tests hold); a CUDA tensor of 4x4 matrices (n = N) launches the
kernel, any other raises. Both return (eigenvalues ascending (..., n),
eigenvectors as columns (..., n, n)); the kernel's columns may differ from
eigh's in sign, which its callers do not see. The op's vmap rule moves the
batch dimension to the front and makes one launch for the whole stack.

`LAUNCHES` counts kernel launches; `LAST_SWEEPS` holds the Jacobi sweeps
of each matrix of the last launch, as an int32 tensor on the card.
"""

import ctypes
from typing import Tuple

import torch

from pvio_torch.utils import cuda_build

SOURCE = cuda_build.CSRC / "sym_eig.cu"
N = 4                       # the matrix size the kernel is built for
LAUNCHES = 0
LAST_SWEEPS = None
_LIB = None


def flops_per_sweep(n):
    """Operations of one Jacobi sweep of an n x n matrix: n(n-1)/2
    rotations, each ~20 to form and 12 n to apply (A's rows and columns
    and V's columns)."""
    return n * (n - 1) // 2 * (12 * n + 20)


def cost(n, sweeps, itemsize=8):
    """(bytes, operations) of decomposing len(sweeps) n x n matrices that
    took the given sweeps: each matrix read once, its eigenvalues and
    eigenvectors written once (in float64, the kernel's type)."""
    B = len(sweeps)
    return B * (2 * n * n + n) * itemsize, flops_per_sweep(n) * int(sum(sweeps))


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load(SOURCE)
        lib.pvio_sym_eig.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        lib.pvio_sym_eig.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def build():
    """Compile (if needed) and load the kernel. Returns nvcc's output."""
    _, log = cuda_build.build(SOURCE)
    _lib()
    return log


def sym_eig_cuda(A):
    """Launch E1 once on a CUDA tensor of (..., 4, 4) float32/float64
    symmetric matrices; returns (eigenvalues, eigenvectors) in A's dtype,
    solved in float64."""
    global LAUNCHES, LAST_SWEEPS
    if A.device.type != "cuda":
        raise ValueError(f"sym_eig_cuda: needs a CUDA tensor, got {A.device}")
    if A.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"sym_eig_cuda: needs float32/float64, got {A.dtype}")
    if A.dim() < 2 or A.shape[-2:] != (N, N):
        raise ValueError(f"sym_eig_cuda: needs (..., {N}, {N}), got {tuple(A.shape)}")
    x = A.to(torch.float64).contiguous()
    B = x.numel() // (N * N)
    L = torch.empty(A.shape[:-1], dtype=torch.float64, device=A.device)
    V = torch.empty_like(x)
    if B == 0:
        return L.to(A.dtype), V.to(A.dtype)
    sweeps = torch.empty(B, dtype=torch.int32, device=A.device)
    idx = A.device.index
    with torch.cuda.device(idx):
        err = _lib().pvio_sym_eig(x.data_ptr(), L.data_ptr(), V.data_ptr(), sweeps.data_ptr(),
                                  B, torch._C._cuda_getCurrentRawStream(idx))
    if err != 0:
        raise RuntimeError(f"sym_eig kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    LAST_SWEEPS = sweeps
    return L.to(A.dtype), V.to(A.dtype)


@torch.library.custom_op("pvio::sym_eig", mutates_args=(), device_types="cpu")
def _sym_eig_op(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    L, V = torch.linalg.eigh(A)
    return L, V


@_sym_eig_op.register_kernel("cuda")
def _(A):
    return sym_eig_cuda(A)


@_sym_eig_op.register_fake
def _(A):
    return A.new_empty(A.shape[:-1]), torch.empty_like(A)


@torch.library.register_vmap("pvio::sym_eig")
def _(info, in_dims, A):
    if in_dims[0] is None:
        return _sym_eig_op(A), (None, None)
    return _sym_eig_op(A.movedim(in_dims[0], 0)), (0, 0)


def eigh(A):
    """(eigenvalues ascending, eigenvectors as columns) of symmetric
    (..., n, n) matrices: `torch.linalg.eigh` for a CPU tensor, kernel E1
    (n = N) for a CUDA tensor."""
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"eigh: unsupported device {A.device}")
    return _sym_eig_op(A)

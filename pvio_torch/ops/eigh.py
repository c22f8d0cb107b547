"""Kernels E1 and E2: eigen-decompositions of symmetric matrices on the
card.

Kernels of the port only: the reference calls `jnp.linalg.eigh`, which XLA
runs on the device with no host read. `torch.linalg.eigh` computes the
same on the card but then reads its error codes on the host, which makes
its caller wait for the device. Two kernels stand in for it, both in
float64 whatever the input type, built with nvcc at first use and bound
with ctypes; each source's header states its design and its bound:
- E1, `pvio_torch/csrc/sym_eig.cu` (cyclic Jacobi, one thread per 4x4
  matrix): every DLT triangulation of the device steps
  (`geometry/triangulation.py::triangulate_homogeneous`, a 4x4 normal
  matrix per point; the initializer's two-view one keeps eigh);
- E2, `pvio_torch/csrc/sym_eig_block.cu` (parallel cyclic Jacobi in a
  round-robin ordering, one block per matrix, 5 <= n <= N_MAX): the
  marginalization's 15x15 clamped pseudo-inverse and its (F*15)-square
  square-root prior (`estimation/marginalization.py`).

`eigh(A)` is the dispatching wrapper, the custom op `pvio::sym_eig` on a
(..., n, n) stack of symmetric matrices: a CPU tensor takes the plain
version, `torch.linalg.eigh` (the reference's function, which the CPU
parity tests hold); a CUDA tensor launches E1 (n = N) or E2 (5 <= n <=
N_MAX), and raises for any other n. Both return (eigenvalues ascending
(..., n), eigenvectors as columns (..., n, n)); a kernel's columns may
differ from eigh's in sign, and in the basis inside a repeated
eigenvalue, which their callers do not see. The op's vmap rule moves the
batch dimension to the front and makes one launch for the whole stack.

`LAUNCHES` counts E1's launches and `BLOCK_LAUNCHES` E2's by matrix size
({n: launches}); `LAST_SWEEPS` holds the Jacobi sweeps of each matrix of
the last launch of either, as an int32 tensor on the card.
"""

import collections
import ctypes
from typing import Tuple

import torch

from pvio_torch.utils import cuda_build

SOURCE = cuda_build.CSRC / "sym_eig.cu"
BLOCK_SOURCE = cuda_build.CSRC / "sym_eig_block.cu"
N = 4                       # the matrix size E1 is built for
N_MAX = 160                 # E2's largest n (its matrix fills one block's shared memory)
MAX_SWEEPS = 30             # both kernels' sweep limit (each library reports its own)
LAUNCHES = 0
BLOCK_LAUNCHES = collections.Counter()
LAST_SWEEPS = None
_LIB = None
_BLOCK_LIB = None


def cost(n, B, itemsize=8):
    """(bytes, operations) of decomposing B symmetric n x n matrices, from
    the input alone: each matrix read once, its eigenvalues and
    eigenvectors written once (in float64, the kernels' type), and the
    ~9 n^3 flops a decomposition with eigenvectors needs (tridiagonal
    reduction and implicit QR, Golub & Van Loan 8.3), not the Jacobi
    rotations the kernels take."""
    return B * (2 * n * n + n) * itemsize, B * 9 * n ** 3


def check_window(frame_capacity):
    """Raise unless the marginalization's (frame_capacity * 15)-square
    prior fits E2 (n <= N_MAX); the card runs every marginalization
    through it, so an engine checks this when it is built."""
    if frame_capacity * 15 > N_MAX:
        raise ValueError(f"window_frame_capacity {frame_capacity} (sliding_window_size + 1) "
                         f"needs {frame_capacity * 15}-square eigen-decompositions in the "
                         f"marginalization, but kernel E2 handles n <= {N_MAX}: on the card "
                         f"sliding_window_size is at most {N_MAX // 15 - 1}")


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load(SOURCE)
        lib.pvio_sym_eig.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        lib.pvio_sym_eig.restype = ctypes.c_int
        if lib.pvio_sym_eig_max_sweeps() != MAX_SWEEPS:
            raise RuntimeError("sym_eig.cu's MAX_SWEEPS differs from ops/eigh.py's")
        _LIB = lib
    return _LIB


def _block_lib():
    global _BLOCK_LIB
    if _BLOCK_LIB is None:
        lib = cuda_build.load(BLOCK_SOURCE)
        lib.pvio_sym_eig_block.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                                                   ctypes.c_void_p]
        lib.pvio_sym_eig_block.restype = ctypes.c_int
        lib.pvio_sym_eig_block_scratch.argtypes = [ctypes.c_int]
        lib.pvio_sym_eig_block_scratch.restype = ctypes.c_int
        limits = (lib.pvio_sym_eig_block_max_n(), lib.pvio_sym_eig_block_max_sweeps())
        if limits != (N_MAX, MAX_SWEEPS):
            raise RuntimeError("sym_eig_block.cu's N_MAX or MAX_SWEEPS differs from "
                               "ops/eigh.py's")
        _BLOCK_LIB = lib
    return _BLOCK_LIB


def build():
    """Compile (if needed) and load both kernels. Returns nvcc's output."""
    logs = cuda_build.build_all([SOURCE, BLOCK_SOURCE])
    _lib()
    _block_lib()
    return "".join(log for _, log in logs.values())


def sym_eig_cuda(A):
    """Launch E1 (n = N) or E2 (5 <= n <= N_MAX) once on a CUDA tensor of
    (..., n, n) float32/float64 symmetric matrices; returns (eigenvalues,
    eigenvectors) in A's dtype, solved in float64."""
    global LAUNCHES, LAST_SWEEPS
    if A.device.type != "cuda":
        raise ValueError(f"sym_eig_cuda: needs a CUDA tensor, got {A.device}")
    if A.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"sym_eig_cuda: needs float32/float64, got {A.dtype}")
    n = A.shape[-1] if A.dim() >= 2 else 0
    if A.dim() < 2 or A.shape[-2] != n or not (n == N or 5 <= n <= N_MAX):
        raise ValueError(f"sym_eig_cuda: needs (..., n, n) with n = {N} or 5 <= n <= {N_MAX}, "
                         f"got {tuple(A.shape)}")
    x = A.to(torch.float64).contiguous()
    B = x.numel() // (n * n)
    L = torch.empty(A.shape[:-1], dtype=torch.float64, device=A.device)
    V = torch.empty_like(x)
    if B == 0:
        return L.to(A.dtype), V.to(A.dtype)
    sweeps = torch.empty(B, dtype=torch.int32, device=A.device)
    idx = A.device.index
    with torch.cuda.device(idx):
        stream = torch._C._cuda_getCurrentRawStream(idx)
        if n == N:
            err = _lib().pvio_sym_eig(x.data_ptr(), L.data_ptr(), V.data_ptr(),
                                      sweeps.data_ptr(), B, stream)
        else:
            lib = _block_lib()
            m = n + n % 2
            scratch = (torch.empty(B * m * (m + 1), dtype=torch.float64, device=A.device)
                       if lib.pvio_sym_eig_block_scratch(n) else None)
            err = lib.pvio_sym_eig_block(x.data_ptr(), L.data_ptr(), V.data_ptr(),
                                         None if scratch is None else scratch.data_ptr(),
                                         sweeps.data_ptr(), B, n, stream)
    if err != 0:
        raise RuntimeError(f"sym_eig kernel ({'E1' if n == N else 'E2'}) launch failed: "
                           f"CUDA error {err}")
    if n == N:
        LAUNCHES += 1
    else:
        BLOCK_LAUNCHES[n] += 1
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
    (n = N) or E2 (5 <= n <= N_MAX) for a CUDA tensor."""
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"eigh: unsupported device {A.device}")
    return _sym_eig_op(A)

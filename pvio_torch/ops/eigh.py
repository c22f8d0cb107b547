"""Kernels E1 and E2: eigen-decompositions of symmetric matrices on the
card.

Kernels of the port only: the reference calls `jnp.linalg.eigh`, which XLA
runs on the device with no host read. `torch.linalg.eigh` computes the
same on the card but then reads its error codes on the host, which makes
its caller wait for the device. Two kernels stand in for it, both solving
in float64, built with nvcc at first use and bound with ctypes; each
source's header states its design and its bound:
- E1, `pvio_torch/csrc/sym_eig.cu` (parallel cyclic Jacobi in the
  round-robin ordering, a quad of lanes per 4x4 matrix, the caller's
  float32 or float64 read and written in the one launch): every DLT
  triangulation of the device steps
  (`geometry/triangulation.py::triangulate_homogeneous`, a 4x4 normal
  matrix per point; the initializer's two-view one keeps eigh);
- E2, `pvio_torch/csrc/sym_eig_block.cu` (parallel cyclic Jacobi in a
  round-robin ordering, 5 <= n <= N_MAX: one warp per matrix up to
  WARP_N, above it blocked Jacobi over tiles of TILE rows on one thread
  block cluster per matrix; float64 in and out, the wrapper casting a
  float32 stack): the marginalization's 15x15 clamped
  pseudo-inverse and its (F*15)-square square-root prior
  (`estimation/marginalization.py`). `jacobi_model` is both kernels'
  algorithm in float64 PyTorch, for the tests and for checking a change
  of a kernel on the CPU; no path of the port calls it.

`eigh(A)` is the dispatching wrapper, the custom op `pvio::sym_eig` on a
(..., n, n) stack of symmetric matrices: a CPU tensor takes the plain
version, `torch.linalg.eigh` (the reference's function, which the CPU
parity tests hold); a CUDA tensor launches E1 (n = N) or E2 (5 <= n <=
N_MAX), and raises for any other n. Both return (eigenvalues ascending
(..., n), eigenvectors as columns (..., n, n)) in A's dtype; a kernel's
columns may differ from eigh's in sign, and in the basis inside a
repeated eigenvalue, which their callers do not see. The op's vmap rule
moves the batch dimension to the front and makes one launch for the
whole stack.

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
N_MAX = 240                 # E2's largest n (16 tiles: 8 CTAs, the portable cluster)
MAX_SWEEPS = 30             # both kernels' sweep limit (each library reports its own)
WARP_N = 32                 # E2's small form (one warp per matrix) up to this n
TILE = 15                   # E2's blocked form: tiles of one frame's 15 rows
_EPS = 2.0 ** -53           # the unit roundoff of float64
LAUNCHES = 0
BLOCK_LAUNCHES = collections.Counter()
LAST_SWEEPS = None
_LIB = None
_BLOCK_LIB = None


def cost(n, B, itemsize=8):
    """(bytes, operations) of decomposing B symmetric n x n matrices, from
    the input alone: each matrix read once, its eigenvalues and
    eigenvectors written once, at `itemsize` bytes an entry (E1 reads and
    writes the caller's type; E2 float64), and the
    ~9 n^3 flops a decomposition with eigenvectors needs (tridiagonal
    reduction and implicit QR, Golub & Van Loan 8.3), not the Jacobi
    rotations the kernels take."""
    return B * (2 * n * n + n) * itemsize, B * 9 * n ** 3


def check_window(frame_capacity):
    """Raise unless the marginalization's (frame_capacity * 15)-square
    prior fits E2 (n <= N_MAX: at most 16 frame slots); the card runs
    every marginalization through it, so an engine checks this when it is
    built."""
    if frame_capacity * 15 > N_MAX:
        raise ValueError(f"window_frame_capacity {frame_capacity} (sliding_window_size + 1) "
                         f"needs {frame_capacity * 15}-square eigen-decompositions in the "
                         f"marginalization, but kernel E2 handles n <= {N_MAX}: on the card "
                         f"sliding_window_size is at most {N_MAX // 15 - 1}")


def _pairs(m, r, device):
    """(p, q) index tensors, p < q, of round r of the round-robin (circle)
    ordering over m (even) indices: (r, m - 1) and ((r + k) mod (m - 1),
    (r - k) mod (m - 1)) for k = 1 .. m/2 - 1."""
    k = torch.arange(m // 2, device=device)
    P = torch.where(k == 0, r % (m - 1), (r + k) % (m - 1))
    Q = torch.where(k == 0, m - 1, (r - k) % (m - 1))
    return torch.minimum(P, Q), torch.maximum(P, Q)


def _rotate(S, VT, P, Q):
    """One round of Jacobi rotations on a batch of symmetric matrices S
    (..., m, m) and their accumulated V^T (..., m, m): the disjoint pairs
    (P, Q), E1's rotation (Golub & Van Loan 8.4.2: t the smaller root of
    t^2 + 2 theta t - 1 = 0, theta = d / w, d = a_qq - a_pp, w = 2 a_pq;
    c = 1 / sqrt(t^2 + 1), s = t c, tau = s / (1 + c)) in the kernel's form:
    with r = sqrt(d^2 + w^2), D = |d| + r, Z = 2 r D, t = sgn |w| / D,
    c = D / sqrt(Z), s = sgn |w| / sqrt(Z), tau = sgn |w| / (sqrt(Z) + D),
    sgn = -1 where theta < 0; Numerical Recipes' update, rows then columns,
    each pair's own 2 x 2 block set to its new pivots and exact zeros."""
    app, aqq, apq = S[..., P, P], S[..., Q, Q], S[..., P, Q]
    nz = apq != 0.0
    d, w = aqq - app, 2.0 * apq
    neg = ((d < 0.0) != (w < 0.0)) & (d != 0.0)
    _, ex = torch.frexp(torch.where(nz, torch.maximum(d.abs(), w.abs()), 1.0))
    d, w = torch.ldexp(d, 1 - ex).abs(), torch.ldexp(w, 1 - ex).abs()   # the larger in [1, 2)
    r = torch.sqrt(d * d + w * w)
    D = d + r
    Z = 2.0 * r * D
    rz = torch.rsqrt(Z)
    sw = torch.where(neg, -w, w)
    s = torch.where(nz, sw * rz, 0.0)
    tau = torch.where(nz, sw / (Z * rz + D), 0.0)
    t = torch.where(nz, sw / torch.where(nz, D, 1.0), 0.0)
    npp, nqq = app - t * apq, aqq + t * apq

    def mix(X, dim):
        s_, tau_ = (s[..., :, None], tau[..., :, None]) if dim == -2 else (s[..., None, :],
                                                                           tau[..., None, :])
        g, h = X.index_select(dim, P), X.index_select(dim, Q)
        X = X.index_copy(dim, P, g - s_ * (h + g * tau_))
        return X.index_copy(dim, Q, h + s_ * (g - h * tau_))

    S = mix(mix(S, -2), -1)
    S[..., P, P], S[..., Q, Q] = npp, nqq
    S[..., P, Q] = S[..., Q, P] = 0.0
    return S, mix(VT, -2)


def _converged(S):
    """The kernels' convergence test of each matrix of S: the sum of squares
    above the diagonal at most eps^2 times the diagonal's (NaN: stop)."""
    off = (torch.triu(S, 1) ** 2).sum((-2, -1))
    return ~(off > _EPS * _EPS * (torch.diagonal(S, 0, -2, -1) ** 2).sum(-1))


def _sweep(S, VT):
    """One round-robin sweep over a batch of m x m matrices: a sweep of the
    small form (one warp per matrix) and the blocked form's inner solve."""
    m = S.shape[-1]
    for r in range(m - 1):
        S, VT = _rotate(S, VT, *_pairs(m, r, S.device))
    return S, VT


def _block_rounds(nb):
    """The blocked form's tile pairs, round by round: [(I_k, J_k) for CTA
    k] for each of the nb - 1 rounds of a sweep over nb (even) tiles."""
    out = []
    for r in range(nb - 1):
        P, Q = _pairs(nb, r, "cpu")
        k = torch.arange(nb // 2)
        first = torch.where(k == 0, P, torch.where(P == (r + k) % (nb - 1), P, Q))
        second = torch.where(first == P, Q, P)
        out.append(list(zip(first.tolist(), second.tolist())))
    return out


def jacobi_model(A, one_block=False):
    """Kernel E1's and E2's algorithm in float64 PyTorch, for the tests and
    for checking a change of a kernel on the CPU: (eigenvalues ascending,
    eigenvectors as columns, sweeps) of one symmetric n x n matrix (its
    lower triangle read). At n = N, E1: round-robin Jacobi over the 4
    indices, no padding. For n <= WARP_N E2's small form: round-robin
    Jacobi over n padded to 16 (n <= 16) or WARP_N. Above it the blocked
    form: n padded to nb tiles of TILE rows (nb even), each sweep nb - 1
    rounds of round-robin tile pairs; in a round each pair's 2 TILE-square
    diagonal block (read from its lower triangle) takes one round-robin
    sweep in a sweep's first round and only the TILE rounds of the pairs
    across its two tiles, (i, TILE + (i + s) mod TILE), in the others, so
    that every pair of indices turns once a sweep; its accumulated rotation
    Q^T mixes the pair's rows of A and of V^T, and every Q_d mixes the
    columns of its pair (A <- Q^T A Q with Q block-diagonal), the diagonal
    blocks taking the inner solve's result. Both forms stop at the start of
    a sweep when the sum of squares above the diagonal is at most eps^2
    times the diagonal's, or after MAX_SWEEPS. `one_block` takes the small
    form's ordering at any n: the algorithm of the earlier
    one-block-per-matrix E2 (time_eig.py --facade-check compares the two).
    Not on any path of the port: `eigh` stays torch.linalg.eigh on the
    CPU."""
    n = A.shape[-1]
    A = A.to(torch.float64)
    A = torch.tril(A) + torch.tril(A, -1).mT
    if n <= WARP_N or one_block:
        m = N if n == N else 16 if n <= 16 else max(WARP_N, n + n % 2)   # the kernel's padding
        S = torch.zeros(m, m, dtype=torch.float64)
        S[:n, :n] = A
        VT, sweeps = torch.eye(m, dtype=torch.float64), 0
        while sweeps < MAX_SWEEPS and not bool(_converged(S)):
            S, VT = _sweep(S, VT)
            sweeps += 1
    else:
        nb = -(-n // TILE)
        nb += nb % 2
        N_ = nb * TILE
        S = torch.zeros(N_, N_, dtype=torch.float64)
        S[:n, :n] = A
        VT = torch.eye(N_, dtype=torch.float64)
        rounds = _block_rounds(nb)
        tiles = torch.arange(N_).reshape(nb, TILE)
        sweeps = 0
        while sweeps < MAX_SWEEPS and not bool(_converged(S)):
            sweeps += 1
            for r, pairs in enumerate(rounds):
                R = torch.stack([torch.cat([tiles[i], tiles[j]]) for i, j in pairs])
                sub = S[R[:, :, None], R[:, None, :]]
                sub = torch.tril(sub) + torch.tril(sub, -1).mT
                QT = torch.eye(2 * TILE, dtype=torch.float64).expand_as(sub)
                if r == 0:
                    sub, QT = _sweep(sub, QT)
                else:
                    for s_ in range(TILE):        # the cross pairs (i, TILE + (i + s) % TILE)
                        P = torch.arange(TILE)
                        sub, QT = _rotate(sub, QT, P, TILE + (P + s_) % TILE)
                Qf = torch.zeros(N_, N_, dtype=torch.float64)
                Qf[R[:, :, None], R[:, None, :]] = QT
                S = (Qf @ S) @ Qf.T
                S[R[:, :, None], R[:, None, :]] = sub
                VT = Qf @ VT
    d = torch.diagonal(S)[:n]
    L, order = torch.sort(d, stable=True)
    return L, VT[order, :n].T, sweeps


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load(SOURCE)
        lib.pvio_sym_eig.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]
        lib.pvio_sym_eig.restype = ctypes.c_int
        if lib.pvio_sym_eig_max_sweeps() != MAX_SWEEPS:
            raise RuntimeError("sym_eig.cu's MAX_SWEEPS differs from ops/eigh.py's")
        if lib.pvio_sym_eig_abi() != 2:      # the argtypes above, with the element size
            raise RuntimeError("sym_eig.cu's C entry is not the one ops/eigh.py binds")
        _LIB = lib
    return _LIB


def _block_lib():
    global _BLOCK_LIB
    if _BLOCK_LIB is None:
        lib = cuda_build.load(BLOCK_SOURCE)
        lib.pvio_sym_eig_block.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                                                   ctypes.c_void_p]
        lib.pvio_sym_eig_block.restype = ctypes.c_int
        lib.pvio_sym_eig_block_max_clusters.argtypes = [ctypes.c_int]
        lib.pvio_sym_eig_block_max_clusters.restype = ctypes.c_int
        limits = (lib.pvio_sym_eig_block_max_n(), lib.pvio_sym_eig_block_max_sweeps(),
                  lib.pvio_sym_eig_block_warp_n(), lib.pvio_sym_eig_block_tile())
        if limits != (N_MAX, MAX_SWEEPS, WARP_N, TILE):
            raise RuntimeError("sym_eig_block.cu's N_MAX, MAX_SWEEPS, WARP_N or TILE differs "
                               "from ops/eigh.py's")
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
    eigenvectors) in A's dtype, solved in float64. E1 is that one launch;
    E2's wrapper casts a float32 stack to float64 and back."""
    global LAUNCHES, LAST_SWEEPS
    if A.device.type != "cuda":
        raise ValueError(f"sym_eig_cuda: needs a CUDA tensor, got {A.device}")
    if A.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"sym_eig_cuda: needs float32/float64, got {A.dtype}")
    n = A.shape[-1] if A.dim() >= 2 else 0
    if A.dim() < 2 or A.shape[-2] != n or not (n == N or 5 <= n <= N_MAX):
        raise ValueError(f"sym_eig_cuda: needs (..., n, n) with n = {N} or 5 <= n <= {N_MAX}, "
                         f"got {tuple(A.shape)}")
    if n == N:      # E1 reads and writes A's dtype
        x = A.contiguous()
        L = torch.empty(A.shape[:-1], dtype=A.dtype, device=A.device)
    else:           # E2 works in float64
        x = A.to(torch.float64).contiguous()
        L = torch.empty(A.shape[:-1], dtype=torch.float64, device=A.device)
    V = torch.empty_like(x)
    B = x.numel() // (n * n)
    if B == 0:
        return L.to(A.dtype), V.to(A.dtype)
    sweeps = torch.empty(B, dtype=torch.int32, device=A.device)
    idx = A.device.index
    with torch.cuda.device(idx):
        stream = torch._C._cuda_getCurrentRawStream(idx)
        if n == N:
            err = _lib().pvio_sym_eig(x.data_ptr(), L.data_ptr(), V.data_ptr(),
                                      sweeps.data_ptr(), B, x.element_size(), stream)
        else:
            err = _block_lib().pvio_sym_eig_block(x.data_ptr(), L.data_ptr(), V.data_ptr(),
                                                  None, sweeps.data_ptr(), B, n, stream)
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

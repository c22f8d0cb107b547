"""Kernel S1: greedy Poisson-disk selection of response-sorted candidates.

A kernel of the port only: the reference runs these rounds as XLA array
code in `lax.while_loop` (`pvio_tpu/frontend/detect.py:131-151`), on the
device and with no host read. The CUDA source is
`pvio_torch/csrc/poisson_select.cu` (sm_90a), built with nvcc at first use
and bound with ctypes; its header states the design and the bound.

`select_candidates(cand, alive, min_distance)` is the dispatching wrapper,
the custom op `pvio::poisson_select` on (C, 2) candidates and a (C,) alive
mask, or on (..., C, 2) / (..., C) stacks: a CPU tensor takes the plain
version (`select_candidates_plain`, the rounds loop, image by image; it
asks the host after each round whether any candidate is alive); a CUDA
tensor launches the kernel, which runs every round on the card, or raises.
Both return the `selected` mask, equal bit for bit. The op's vmap rule
moves the batch dimension to the front and makes ONE launch for the whole
stack.

`LAUNCHES` counts kernel launches; `LAST_ROUNDS` holds the plain version's
round count of its last image, `LAST_KERNEL_ROUNDS` the kernel's round
counts of its last launch, one per image, as an int32 tensor on the card
(read it after the step, not inside it).
"""

import ctypes

import torch

from pvio_torch.utils import cuda_build

SOURCE = cuda_build.CSRC / "poisson_select.cu"
MAX_CANDIDATES = 1024       # one thread a candidate, one block an image
LAUNCHES = 0
LAST_ROUNDS = 0
LAST_KERNEL_ROUNDS = None
_LIB = None

# operations of one candidate pair's squared distance: 2 subtractions,
# 2 products, 1 sum (the comparison with d2 not counted)
OPS_PER_PAIR = 5


def select_candidates_plain(cand, alive, min_distance):
    """Exact greedy Poisson-disk selection in parallel rounds: a candidate
    wins when no alive earlier-sorted candidate is near it; winners kill
    their neighbours; run to exhaustion (safety bound C rounds). cand (C,
    2), alive (C,) bool. Returns the selected mask (C,)."""
    global LAST_ROUNDS
    C = cand.shape[0]
    d2 = min_distance * min_distance
    dist2 = torch.sum((cand[:, None, :] - cand[None, :, :]) ** 2, dim=-1)
    near = dist2 < d2
    ar = torch.arange(C, device=cand.device)
    dominates = near & (ar[None, :] < ar[:, None])      # j earlier & near i
    selected = torch.zeros_like(alive)
    rounds = 0
    while rounds < C and bool(alive.any()):
        dominated = torch.any(dominates & alive[None, :], dim=1)
        winners = alive & ~dominated
        selected = selected | winners
        killed = torch.any(near & winners[None, :], dim=1) & ~winners
        alive = alive & ~winners & ~killed
        rounds += 1
    LAST_ROUNDS = rounds
    return selected


def cost(n_alive, C, itemsize=4):
    """(bytes, operations) the selection must move and compute for images
    with n_alive (a sequence, one per image) initially alive candidates of
    C: positions and mask read once, the mask written once; the squared
    distance of each pair of alive candidates once."""
    B = len(n_alive)
    nbytes = B * C * (2 * itemsize + 2)
    ops = sum(OPS_PER_PAIR * n * (n - 1) // 2 for n in n_alive)
    return nbytes, ops


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load(SOURCE)
        lib.pvio_poisson_select.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_void_p]
        lib.pvio_poisson_select.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def build():
    """Compile (if needed) and load the kernel. Returns nvcc's output."""
    _, log = cuda_build.build(SOURCE)
    _lib()
    return log


def poisson_select_cuda(cand, alive, min_distance):
    """Launch S1 once on CUDA tensors cand (..., C, 2) float32/float64 and
    alive (..., C) bool; returns the selected mask (..., C)."""
    global LAUNCHES, LAST_KERNEL_ROUNDS
    if cand.device.type != "cuda" or alive.device != cand.device:
        raise ValueError(f"poisson_select_cuda: needs CUDA tensors on one device, got "
                         f"{cand.device} and {alive.device}")
    if cand.dtype not in (torch.float32, torch.float64) or alive.dtype != torch.bool:
        raise ValueError(f"poisson_select_cuda: needs float32/float64 candidates and a bool "
                         f"mask, got {cand.dtype} and {alive.dtype}")
    if cand.dim() < 2 or cand.shape[-1] != 2 or alive.shape != cand.shape[:-1]:
        raise ValueError(f"poisson_select_cuda: needs (..., C, 2) and (..., C), got "
                         f"{tuple(cand.shape)} and {tuple(alive.shape)}")
    if not (cand.is_contiguous() and alive.is_contiguous()):
        raise ValueError("poisson_select_cuda: inputs must be contiguous")
    C = cand.shape[-2]
    B = alive.numel() // max(C, 1)
    if not (0 < C <= MAX_CANDIDATES) or B == 0:
        raise ValueError(f"poisson_select_cuda: unsupported shape {tuple(cand.shape)} "
                         f"(1 <= C <= {MAX_CANDIDATES})")
    selected = torch.empty_like(alive)
    rounds = torch.empty(B, dtype=torch.int32, device=cand.device)
    idx = cand.device.index
    with torch.cuda.device(idx):
        err = _lib().pvio_poisson_select(
            cand.data_ptr(), alive.data_ptr(), selected.data_ptr(), rounds.data_ptr(), B, C,
            float(min_distance) ** 2, int(cand.dtype == torch.float64),
            torch._C._cuda_getCurrentRawStream(idx))
    if err != 0:
        raise RuntimeError(f"poisson_select kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    LAST_KERNEL_ROUNDS = rounds
    return selected


@torch.library.custom_op("pvio::poisson_select", mutates_args=(), device_types="cpu")
def _poisson_select_op(cand: torch.Tensor, alive: torch.Tensor,
                       min_distance: float) -> torch.Tensor:
    if alive.dim() == 1:
        return select_candidates_plain(cand, alive, min_distance)
    C = alive.shape[-1]
    out = [select_candidates_plain(c, a, min_distance)
           for c, a in zip(cand.reshape(-1, C, 2), alive.reshape(-1, C))]
    return torch.stack(out).reshape(alive.shape)


@_poisson_select_op.register_kernel("cuda")
def _(cand, alive, min_distance):
    return poisson_select_cuda(cand, alive, min_distance)


@_poisson_select_op.register_fake
def _(cand, alive, min_distance):
    return torch.empty_like(alive)


@torch.library.register_vmap("pvio::poisson_select")
def _(info, in_dims, cand, alive, min_distance):
    cd, ad = in_dims[0], in_dims[1]
    if cd is None and ad is None:
        return _poisson_select_op(cand, alive, min_distance), None
    n = info.batch_size
    cand = (cand.movedim(cd, 0) if cd is not None
            else cand.expand(n, *cand.shape)).contiguous()
    alive = (alive.movedim(ad, 0) if ad is not None
             else alive.expand(n, *alive.shape)).contiguous()
    return _poisson_select_op(cand, alive, min_distance), 0


def select_candidates(cand, alive, min_distance):
    """The selected mask of the greedy Poisson-disk rounds: the plain
    version for CPU tensors, kernel S1 for CUDA tensors (one launch for a
    stack)."""
    if cand.device.type not in ("cpu", "cuda"):
        raise ValueError(f"select_candidates: unsupported device {cand.device}")
    return _poisson_select_op(cand, alive, float(min_distance))

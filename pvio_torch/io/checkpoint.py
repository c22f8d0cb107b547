"""Engine state checkpointing: the solver window through one .npz file.

Matches `pvio_tpu/io/checkpoint.py`: `save_window` and `load_window`, with
the same layout, so a file written by either package loads in the other:
`__n` (40), then the leaves `a0` ... `a39` in the window's field order
(`jax.tree.flatten`'s leaf order), `delta` and `prior` flattened in place.
The port's index fields (`ref_frame`, `track_flags`, `plane_id`) are int64
where the reference's are int32: each package writes what it holds, and
`load_window` gives the port's widths whatever the file holds.

The snapshot covers the SOLVER WINDOW only (frame states, track columns,
observation grid, planes, marginalization prior), as the reference's
does: not the feature tracker's frames, device keypoints, plane sector
areas or host id counters. A restored window serves solver post-mortems,
regression goldens and warm starts of a new session; it cannot splice
into a live sequence.

`load_window(path, dtype=None, device=None)` puts the window on CUDA
unless `device` says otherwise (`device="cpu"` must be asked for).
"""

import numpy as np
import torch
from torch.utils import _pytree as pytree

from pvio_torch.map import window as win
from pvio_torch.map.window import WindowState

# the tree structure of every window (capacities do not change it) and
# the positions of its index leaves
_LEAVES, _TREESPEC = pytree.tree_flatten(win.empty_window(1, 1, 1))
_INT = {i for i, a in enumerate(_LEAVES) if a.dtype == torch.int64}


def save_window(path, w: WindowState):
    """Write the window's 40 leaves to `path` (.npz, compressed)."""
    flat = pytree.tree_leaves(w)
    np.savez_compressed(path, __n=len(flat),
                        **{f"a{i}": x.detach().cpu().numpy() for i, x in enumerate(flat)})


def load_window(path, dtype=None, device=None) -> WindowState:
    """Read a window written by either package. Floating leaves keep the
    file's dtype unless `dtype` is given; index leaves become int64."""
    from pvio_torch.core.kernels import resolve_device

    dev = resolve_device(device)
    with np.load(path) as data:
        n = int(data["__n"])
        flat = [data[f"a{i}"] for i in range(n)]
    if n != _TREESPEC.num_leaves:
        raise ValueError(f"{path}: {n} leaves, a window has {_TREESPEC.num_leaves}")

    def leaf(i, a):
        if i in _INT:
            return torch.as_tensor(a.astype(np.int64), device=dev)
        t = torch.as_tensor(a, device=dev)
        return t.to(dtype) if dtype is not None and t.is_floating_point() else t

    return pytree.tree_unflatten([leaf(i, a) for i, a in enumerate(flat)], _TREESPEC)

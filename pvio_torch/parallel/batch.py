"""Batched multi-sequence solving on one device.

Matches `pvio_tpu/parallel/batch.py`: `stack_windows`, `unstack_windows`,
`make_batched_solver` and `make_batched_keyframe_step`. Independent VIO
windows are stacked on a leading batch axis and solved by
`torch.func.vmap` of the port's `ba.solve` (and `post_solve_update`): the
LM loop reads nothing back to the host, so one vmapped program serves the
whole batch, with each launch covering every sequence (BASELINE.json
config 4).
"""

import torch
from torch.func import vmap
from torch.utils import _pytree as pytree

from pvio_torch.estimation import ba as ba_mod
from pvio_torch.map.window import Extrinsics


def stack_windows(windows):
    """List of WindowState (same capacities) -> batched WindowState."""
    return pytree.tree_map(lambda *xs: torch.stack(xs), *windows)


def unstack_windows(wb, n):
    return [pytree.tree_map(lambda a: a[i], wb) for i in range(n)]


def make_batched_solver(extr: Extrinsics, cfg: ba_mod.BAConfig):
    """(batched windows) -> (batched windows, final costs (B,))."""

    def solve_one(w):
        w2, info = ba_mod.solve(w, extr, cfg)
        return w2, info["final_cost"]

    return vmap(solve_one)


def make_batched_keyframe_step(extr: Extrinsics, cfg: ba_mod.BAConfig, K=None):
    """The keyframe BA (+ with camera matrix K, the post-solve depth and
    quality update) vmapped over sequences: (batched windows) ->
    (batched windows, final costs (B,))."""

    def step(w):
        w2, info = ba_mod.solve(w, extr, cfg)
        if K is not None:
            w2 = ba_mod.post_solve_update(w2, extr, K)
        return w2, info["final_cost"]

    return vmap(step)

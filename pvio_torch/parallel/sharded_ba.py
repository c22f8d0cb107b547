"""Distributed bundle adjustment over `torch.distributed` process groups.

Matches `pvio_tpu/parallel/sharded_ba.py`: `window_pspecs` (here
`shard_window` / `gather_window`), `_lm_step_sharded`,
`make_sharded_solver` and `replicate_window_batch`. A `ProcessMesh` takes
the place of the reference's `jax.sharding.Mesh`: its world of dp x tp
processes (rank = dp_idx * tp + tp_idx) is

  * **dp**: a batch of independent windows, each rank taking a contiguous
    block of it;
  * **tp**: the track axis of each window, each rank taking a contiguous
    block of it. A rank linearizes its tracks; the reduced camera system
    is summed over its tp group (`all_reduce`, where the reference
    `psum`s), solved replicated, and the depth back-substitution stays
    local.

The frame factors (preintegration, prior) are computed on every tp rank by
linearizing a tracks-masked copy of the window; only the track-dependent
parts are summed, as the reference does. The plane member counts, the one
cross-track statistic of the factor masks, are summed once a solve: only
track fields enter them, and an LM step leaves those as they are.

The per-window stages run under `torch.func.vmap` over the rank's block of
the batch; each collective runs between them on the stacked (B_local, ...)
tensors, since vmap cannot batch c10d's in-place collectives. Sums reduced
in another order part from `ba.solve` in the last bits (the reference
holds its sharded solve to 1e-8 m for that).

Backends: NCCL for CUDA tensors, gloo for CPU tensors, and nothing else: a
CUDA window under gloo (which would copy through the host) or a CPU window
under NCCL raises. On one card the mesh is a world of one (NCCL cannot put
two ranks on one GPU).
"""

import os

import torch
import torch.distributed as dist
from torch.func import vmap
from torch.utils import _pytree as pytree

from pvio_torch.estimation import ba as ba_mod
from pvio_torch.map import window as win
from pvio_torch.map.window import Extrinsics, WindowState

# the window fields on the track axis: (T,) and (F, T, ...)
_TRACK_FIELDS = ("inv_depth", "ref_frame", "track_mask", "track_flags", "quality", "plane_id")
_GRID_FIELDS = ("kp", "obs_mask")
_BACKEND_DEVICE = {"nccl": "cuda", "gloo": "cpu"}


class ProcessMesh:
    """A dp x tp layout of the initialized default process group: this
    rank's (dp_idx, tp_idx), its tp group (the ranks of its dp row), its dp
    group (the ranks of its tp column) and its device. `device=None` means
    `cuda:<local rank>` under NCCL; under gloo the caller must pass
    `device="cpu"`."""

    def __init__(self, dp, tp, device=None):
        if not dist.is_initialized():
            raise RuntimeError("ProcessMesh: torch.distributed is not initialized")
        self.backend = dist.get_backend()
        self.rank = dist.get_rank()
        world = dist.get_world_size()
        if dp * tp != world:
            raise ValueError(f"ProcessMesh: dp {dp} x tp {tp} != world size {world}")
        if self.backend not in _BACKEND_DEVICE:
            raise ValueError(f"ProcessMesh: backend {self.backend!r}; have nccl and gloo")
        if device is None:
            if self.backend != "nccl":
                raise ValueError("ProcessMesh: a gloo mesh runs on the CPU; pass device='cpu'")
            local = int(os.environ.get("LOCAL_RANK", self.rank % torch.cuda.device_count()))
            device = torch.device("cuda", local)
        device = torch.device(device)
        if device.type != _BACKEND_DEVICE[self.backend]:
            raise ValueError(f"ProcessMesh: {self.backend} does not serve {device.type} "
                             f"tensors (nccl: cuda, gloo: cpu)")
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.dp, self.tp = dp, tp
        self.dp_idx, self.tp_idx = divmod(self.rank, tp)
        # every rank creates every group, in the same order
        for d in range(dp):
            g = dist.new_group([d * tp + t for t in range(tp)])
            if d == self.dp_idx:
                self.tp_group = g
        for t in range(tp):
            g = dist.new_group([d * tp + t for d in range(dp)])
            if t == self.tp_idx:
                self.dp_group = g

    def check(self, x: torch.Tensor, what="tensor"):
        """Raise unless x lies on the mesh's device."""
        if x.device != self.device:
            raise ValueError(f"ProcessMesh ({self.backend} on {self.device}): {what} is on "
                             f"{x.device}")


def _all_reduce(x, group):
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def _all_gather_cat(x, group, size, dim):
    """Concatenate x over the ranks of `group` along `dim` (bools as uint8)."""
    if size == 1:
        return x
    y = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    parts = [torch.empty_like(y) for _ in range(size)]
    dist.all_gather(parts, y, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def _track_dim(field):
    """The track axis of a batched window field, None if it has none."""
    return 1 if field in _TRACK_FIELDS else 2 if field in _GRID_FIELDS else None


def shard_window(wb: WindowState, mesh: ProcessMesh) -> WindowState:
    """This rank's block of a batched window (B, ...): its contiguous dp
    block of the batch and tp block of the tracks; every other field is
    replicated over tp (the reference's `window_pspecs`)."""
    mesh.check(wb.p, "the window")
    B, T = wb.p.shape[0], wb.inv_depth.shape[1]
    if B % mesh.dp or T % mesh.tp:
        raise ValueError(f"shard_window: batch {B} and tracks {T} must divide by "
                         f"dp {mesh.dp} and tp {mesh.tp}")
    bl, tl = B // mesh.dp, T // mesh.tp
    b0, t0 = mesh.dp_idx * bl, mesh.tp_idx * tl
    w = pytree.tree_map(lambda a: a[b0:b0 + bl], wb)
    return w._replace(**{f: getattr(w, f).narrow(_track_dim(f), t0, tl).contiguous()
                         for f in _TRACK_FIELDS + _GRID_FIELDS})


def gather_batch(tree, mesh: ProcessMesh):
    """Every leaf (B_local, ...) concatenated over the dp group: (B, ...)."""
    return pytree.tree_map(lambda a: _all_gather_cat(a, mesh.dp_group, mesh.dp, 0), tree)


def gather_window(wl: WindowState, mesh: ProcessMesh) -> WindowState:
    """The global batched window from every rank's block: the track fields
    over the tp group, then every field over the dp group."""
    mesh.check(wl.p, "the window")
    w = wl._replace(**{f: _all_gather_cat(getattr(wl, f), mesh.tp_group, mesh.tp,
                                          _track_dim(f))
                       for f in _TRACK_FIELDS + _GRID_FIELDS})
    return gather_batch(w, mesh)


def _lm_step_sharded(w: WindowState, lam, counts, extr: Extrinsics, cfg: ba_mod.BAConfig,
                     group):
    """One LM step on a rank's block (B_local windows, its tracks): the
    reference's `_lm_step_sharded` with each `psum` an `all_reduce` over
    `group`. `counts` (B_local, P) are the plane member counts summed over
    the group. Returns (w_new, cost0, cost1), costs global (B_local,) in
    float64: like `ba._lm_step` it linearizes, solves and costs in float64
    and applies the step at the window's dtype."""
    dtype = w.p.dtype
    w64, extr = win.as_float64(w), win.as_float64(extr)
    w0 = w64._replace(track_mask=torch.zeros_like(w.track_mask))
    no_members = torch.zeros_like(counts)
    lin = vmap(lambda wx, c: ba_mod.linearize(wx, extr, cfg, counts=c))
    cost_of = vmap(lambda wx, c: ba_mod.evaluate_cost(wx, extr, cfg, counts=c))

    def total_cost(wx):
        c_local = cost_of(wx, counts)
        c_frame = cost_of(wx._replace(track_mask=torch.zeros_like(wx.track_mask)), no_members)
        return c_frame + _all_reduce(c_local - c_frame, group)

    H, Hpd, Hdd, b, bd, depth_active, cost_local, m = lin(w64, counts)
    H_f, _, _, b_f, _, _, cost_f, _ = lin(w0, no_members)
    # the frame factors once, the track parts summed over the group
    H_g = H_f + _all_reduce(H - H_f, group)
    b_g = b_f + _all_reduce(b - b_f, group)
    cost0 = cost_f + _all_reduce(cost_local - cost_f, group)
    Hpd, bd, Hdd_inv, S, s = vmap(ba_mod._eliminate)(Hpd, Hdd, bd, depth_active, m, lam)
    # the reduced camera system: the local depth-elimination blocks summed
    S = _all_reduce(S, group)
    s = _all_reduce(s, group)
    dp = vmap(ba_mod._reduced_solve)(H_g, b_g, S, s, m, lam)
    dd = vmap(ba_mod._depth_step)(Hpd, bd, Hdd_inv, depth_active, dp)
    w_new = vmap(ba_mod._retract)(w, dp.to(dtype), dd.to(dtype))
    return w_new, cost0, total_cost(win.as_float64(w_new))


def make_sharded_solver(mesh: ProcessMesh, extr: Extrinsics, cfg: ba_mod.BAConfig):
    """The distributed BA solve over `mesh`: (batched windows (B, ...), the
    same on every rank) -> (solved windows (B, ...), costs (B,)), both
    gathered to the global batch on every rank. B must divide by dp and the
    track capacity by tp. The costs are the last LM step's cost1, as the
    reference's `costs[-1]`. `cfg.iterations` LM steps in a Python loop,
    accept or reject by `torch.where`, no host wait."""
    mesh.check(extr.q_bc, "the extrinsics")

    def solve_local(w: WindowState):
        B = w.p.shape[0]
        lam = torch.full((B,), cfg.lm_lambda_init, dtype=w.p.dtype, device=w.p.device)
        counts = _all_reduce(vmap(ba_mod.plane_counts)(w), mesh.tp_group)
        for _ in range(cfg.iterations):
            w_new, cost0, cost1 = _lm_step_sharded(w, lam, counts, extr, cfg, mesh.tp_group)
            accept = cost1 < cost0
            lam = torch.where(accept,
                              torch.clamp(lam * cfg.lm_lambda_down, min=cfg.lm_lambda_min),
                              torch.clamp(lam * cfg.lm_lambda_up, max=cfg.lm_lambda_max))
            w = vmap(ba_mod._select)(accept, w_new, w)
        return w, cost1.to(w.p.dtype)

    def solve(wb: WindowState):
        w, costs = solve_local(shard_window(wb, mesh))
        return gather_window(w, mesh), gather_batch(costs, mesh)

    return solve


def replicate_window_batch(w: WindowState, batch: int):
    """Tile a single window into a batch (for benchmarks and dry runs)."""
    return pytree.tree_map(lambda a: a[None].expand((batch,) + a.shape), w)

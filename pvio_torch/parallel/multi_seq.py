"""Multi-sequence coupled-chain batching (BASELINE config 4).

Matches `pvio_tpu/parallel/multi_seq.py`: `build_sequence_inputs`,
`make_chain` and `run_batched`. N sequences run the fused per-frame device
steps -- the frontend (`frame_step`: CLAHE, pyramid, K1, KLT, F-gate,
detection with S1), the motion step (`pnp_step`) and every `kf_every`-th
frame the plane-augmented VI BA and the marginalization (`ba_step`,
`marg_step`) -- through ONE `torch.func.vmap` of the single-sequence
chain. The hand-written kernels are custom ops whose vmap rules launch
once for the whole batch, so a vmapped frame launches K1 and S1 once, not
once per sequence.

As in the reference this is a fixed-cadence throughput batch: the solved
window carries across groups, but the window topology is static (no
keyframe append, no adaptive decisions); N adaptive engines behind one
host loop are `parallel/serving.py`. The chain is the coupled pipeline:
KLT-tracked keypoints feed the PnP through a static detector-slot ->
window-column association.

The reference's `lax.scan` over groups is a Python loop here. It never
reads the device: every step is device code, and the chain's constants
(the key, the identity rotation, the inverse intrinsics) are filled on the
device. With a `mesh`, `run_batched` shards the batch over its dp axis
(`torch.distributed`, `parallel/sharded_ba.py`).
"""

import numpy as np
import torch
from torch.func import vmap

from pvio_torch.io import synthetic
from pvio_torch.parallel import batch as pbatch
from pvio_torch.utils import transfer


def build_sequence_inputs(cfg, kern, n_chain_frames, seed=648):
    """Host-side inputs for one sequence's coupled pipeline chain:
    rendered image stack, plane-flagged solver window, per-frame IMU
    grids, and the detector-slot -> window-column association.

    Returns (w, arrays): the window on the engine's device and a dict of
    per-sequence numpy arrays to stack along a leading batch axis."""
    dtype = kern.dtype
    n_kf = cfg.window_frame_capacity - 1
    gap = 4
    scene = synthetic.make_scene(duration=6.0, fps=20.0, imu_rate=200.0,
                                 n_points=280, n_plane_points=160, seed=seed)
    kf = list(range(0, n_kf * gap, gap))
    w, _extr, info = synthetic.solver_window_from_scene(
        scene, kf, F_cap=cfg.window_frame_capacity, T_cap=cfg.track_capacity,
        dtype=dtype, device=kern.device, kp_noise=0.002)
    w, n_members = synthetic.flag_plane_tracks(w, scene, info)
    assert n_members >= cfg.plane_min_tracks, n_members

    NSEQ = n_chain_frames + 1
    base = kf[-1]
    assert base + NSEQ <= len(scene.frame_t), (base, NSEQ)
    images = np.stack([
        (synthetic.render_frame(scene, base + fi, cfg.K, cfg.image_size)
         * 255 + 0.5).astype(np.uint8)
        for fi in range(NSEQ)
    ])

    # pixel projections of the window's tracks at the sequence start
    kp, vis = synthetic.project_points(scene, np.array([base]))
    chosen = np.asarray(info["chosen"])
    fx, fy, cx, cy = cfg.K[0, 0], cfg.K[1, 1], cfg.K[0, 2], cfg.K[1, 2]
    col_px = np.stack([kp[0, chosen, 0] * fx + cx,
                       kp[0, chosen, 1] * fy + cy], axis=-1)
    col_vis = vis[0, chosen]

    # one-time detector-slot -> window-column association from a run of
    # the first-frame detector
    _p, _r, kp0_d, mask0_d = kern.first_frame_step(images[0])
    kp0_h, mask0_h = kp0_d.cpu().numpy(), mask0_d.cpu().numpy()
    T_cap = w.kp.shape[1]
    slot_of_col = np.full(T_cap, -1, np.int64)
    live = np.nonzero(mask0_h)[0]
    if len(live):
        d2 = ((kp0_h[live][:, None, :] - col_px[None, :, :]) ** 2).sum(-1)
        d2[:, ~col_vis] = np.inf
        used = set()
        for si in np.argsort(d2.min(axis=1)):
            ci = int(np.argmin(d2[si]))
            if d2[si, ci] < 9.0 and ci not in used:
                slot_of_col[ci] = live[si]
                used.add(ci)

    # per-frame padded IMU grids for the keyframe BA/marg steps
    F = cfg.window_frame_capacity
    N = cfg.imu_buffer_capacity
    npdt = np.float32 if dtype == torch.float32 else np.float64
    ts = np.zeros((F, N)); ws_ = np.zeros((F, N, 3))
    accs = np.zeros((F, N, 3)); mask = np.zeros((F, N), bool)
    t_frames = np.zeros(F)
    for j in range(F):
        if 1 <= j <= len(kf) - 1:
            t0, t1 = scene.frame_t[kf[j - 1]], scene.frame_t[kf[j]]
            sel = (scene.imu_t >= t0) & (scene.imu_t < t1)
            n = min(int(sel.sum()), N)
            ts[j, :n] = scene.imu_t[sel][:n]
            ws_[j, :n] = scene.gyro[sel][:n]
            accs[j, :n] = scene.accel[sel][:n]
            mask[j, :n] = True
        if j < len(kf):
            t_frames[j] = scene.frame_t[kf[j]]

    sel = ((scene.imu_t >= scene.frame_t[base])
           & (scene.imu_t < scene.frame_t[base + 1]))
    tp_, wp_, ap_, mp_ = kern.pad_imu_host(
        scene.imu_t[sel], scene.gyro[sel], scene.accel[sel])

    arrays = dict(
        images=images,
        slot_of_col=slot_of_col,
        imu_ts=ts.astype(npdt), imu_w=ws_.astype(npdt),
        imu_a=accs.astype(npdt), imu_mask=mask,
        frame_ts=t_frames.astype(npdt),
        pnp_tp=tp_, pnp_wp=wp_, pnp_ap=ap_, pnp_mp=mp_,
        track_life=np.full(T_cap, 20, np.int64),
        t_new=np.asarray(scene.frame_t[base + 1], npdt),
    )
    return w, arrays


def upload_arrays(kern, arrays):
    """A `build_sequence_inputs` dict (or one of stacked arrays) as tensors
    on the engine's device, from one host -> device copy."""
    keys = sorted(arrays)
    vals = transfer.upload([arrays[k] for k in keys], kern.device, kern.dtype)
    return dict(zip(keys, vals))


def make_chain(kern, cfg, groups, kf_every=4):
    """The coupled pipeline chain for ONE sequence:

        chain(w_base, arrays, stir0) -> (costs (groups,), w_final)

    `arrays` holds `build_sequence_inputs`' arrays as tensors on the
    engine's device (`upload_arrays`). groups * kf_every frames: fused
    frontend + slot-associated VI PnP per frame, plane-augmented VI BA +
    marginalization every kf_every-th frame. A pure function of its
    inputs that reads nothing back to the host: vmap it for the
    multi-sequence batch."""
    dtype, dev = kern.dtype, kern.device
    fx, fy = float(cfg.K[0, 0]), float(cfg.K[1, 1])
    cx, cy = float(cfg.K[0, 2]), float(cfg.K[1, 2])

    def chain(w_base, a, stir0):
        # the constants, filled on the device (no host copy)
        kinv_scale = torch.full((2,), 1.0 / fx, dtype=dtype, device=dev)
        kinv_scale[1].fill_(1.0 / fy)
        kinv_off = torch.full((2,), cx, dtype=dtype, device=dev)
        kinv_off[1].fill_(cy)
        dq_id = torch.zeros(4, dtype=dtype, device=dev)
        dq_id[0].fill_(1.0)
        key0 = torch.full((2,), 648, dtype=torch.int64, device=dev)
        key0[1].fill_(1)

        images = a["images"]
        slot_of_col = a["slot_of_col"]
        imu_ops = (a["imu_ts"], a["imu_w"], a["imu_a"], a["imu_mask"], a["frame_ts"])
        pnp_imu = (a["pnp_tp"], a["pnp_wp"], a["pnp_ap"], a["pnp_mp"])
        tail_idx = torch.sum(w_base.frame_mask) - 1
        at_tail = torch.arange(w_base.q.shape[0], device=dev) == tail_idx

        def one_frame(pyr, resp, kp, mask, wst, alive, stir, i):
            pyr2, resp2, kp2, mask2, status, det = kern.frame_step(
                pyr, resp, images[i + 1], kp, mask, dq_id, key0 + i)
            sc = torch.clamp(slot_of_col, 0, kp2.shape[0] - 1)
            alive = alive & mask2[sc] & (slot_of_col >= 0)
            z = (kp2[sc] - kinv_off) * kinv_scale + stir
            q1, p1 = kern.pnp_step(
                wst, *pnp_imu, a["t_new"], tail_idx, z, alive, alive, 0)[:2]
            wst = wst._replace(q=torch.where(at_tail[:, None], q1, wst.q),
                               p=torch.where(at_tail[:, None], p1, wst.p))
            stir = stir + 1e-30 * (kp2[0, 0] + p1[0])
            return pyr2, resp2, kp2, mask2, wst, alive, stir

        pyr, resp, kp, mask = kern.first_frame_step(images[0])
        wst, alive, stir = w_base, slot_of_col >= 0, stir0
        costs = []
        for g in range(groups):
            i0 = g * kf_every
            for i in range(kf_every):
                pyr, resp, kp, mask, wst, alive, stir = one_frame(
                    pyr, resp, kp, mask, wst, alive, stir, i0 + i)
            # the post-BA window CARRIES across groups: refined states,
            # biases, depths and planes feed the next group's PnP/BA (the
            # topology stays static). The marginalization product is
            # computed for its cost (and kept live through the stir term),
            # but the un-compacted window is what the chain continues from.
            wst2, info, xw, _tri = kern.ba_step(wst, *imu_ops, a["track_life"], False)
            wm = kern.marg_step(wst2, *imu_ops)
            stir = stir + 1e-30 * torch.nan_to_num(
                info["final_cost"] + wm.p[0, 0] + xw[0, 0])
            wst = wst2._replace(p=wst2.p + stir)
            costs.append(info["final_cost"])
        return torch.stack(costs), wst

    return chain


def run_batched(kern, cfg, ws, arrays_list, groups, kf_every=4, mesh=None):
    """Run N sequences (windows on the engine's device, as
    `build_sequence_inputs` makes them) end to end through one vmapped
    chain, or dp-sharded over `mesh` (a `sharded_ba.ProcessMesh` on the
    engine's device): each dp rank runs the vmapped chain on its contiguous
    block of the N sequences (N must divide by dp; the ranks of a tp group
    run the same block), and the costs and windows are gathered over the
    dp group, as the reference's `P("dp")` sharding. Returns (costs
    (N, groups) numpy, windows list)."""
    chain = make_chain(kern, cfg, groups, kf_every)
    n = len(ws)
    lo, hi = 0, n
    if mesh is not None:
        mesh.check(ws[0].p, "the windows")
        if n % mesh.dp:
            raise ValueError(f"run_batched: {n} sequences do not divide by dp {mesh.dp}")
        lo = mesh.dp_idx * (n // mesh.dp)
        hi = lo + n // mesh.dp
    wb = pbatch.stack_windows(ws[lo:hi])
    ab = upload_arrays(kern, {k: np.stack([np.asarray(a[k]) for a in arrays_list[lo:hi]])
                              for k in arrays_list[0]})
    stir = torch.zeros(hi - lo, dtype=kern.dtype, device=kern.device)
    costs, wf = vmap(chain)(wb, ab, stir)
    if mesh is not None:
        from pvio_torch.parallel.sharded_ba import gather_batch

        costs, wf = gather_batch((costs, wf), mesh)
    return costs.cpu().numpy(), pbatch.unstack_windows(wf, n)

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`pvio_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's hand-written kernels from `pvio_torch/csrc/` and drives
the port's main path, bench.py's coupled chain, at the production size
(Config() defaults, float32, planes on: 480x752 frames, 150 keypoint slots,
9 frame slots x 256 tracks x 8 planes, 64 IMU samples) through the entry
points a user calls: `DeviceKernels.first_frame_step`, `frame_step`,
`pnp_step`, `ba_step`, `marg_step`, `kf_step` and `kf_step_chained`; then
the `PVIO` facade, planes off and with `Config()`'s planes on, and the CLI
(`python -m pvio_torch.run`).

Phases; each raises on failure, so any failure exits non-zero:
  1. device and build: the card's name and power limit, the kernels built
     with nvcc (one process per source, started together);
  2. kernel K1 (Shi-Tomasi response) against its plain PyTorch version on
     the card over the full image: the bench render, uniform noise from
     1x1 to 481x755 (one tile, one tile plus a pixel each way, 1x752) and
     a contiguous view 4 bytes into its storage; each case prints the load
     stage it took (TMA or per-thread loads), which must match the
     launcher's plan, and both stages must occur. Then the detections it
     feeds, and its time beside the plain version's, the card's bound and
     a launch floor (the device time of a 1-element zero_());
  3. the main path: the bench scene, first_frame_step, the slot -> track
     association, then N_FRAMES x (frame_step -> association -> pnp_step)
     chaining the tail pose, and every KF_EVERY-th frame ba_step
     (make_prior=False) + marg_step on the chained window, which then
     resets to the base window as bench.py does (the synthetic window has
     no host topology upkeep); every solve must lower its cost, accept a
     step and leave a finite window and prior; launch counts are zeroed
     just before and read just after, and K1 must have launched once per
     frame;
  4. the keyframe: one kf_step_chained (do_marg=True) fed the last
     pnp_step's device outputs, and one kf_step fed their host copies,
     under deterministic algorithms: every output identical. Then the
     median device-synchronised times of ba_step, marg_step, kf_step and
     kf_step_chained, and of one BA solve with each preintegration path;
  5. the same chain through the port on the CPU at float32, and the
     agreement of the two runs (frames and keyframes);
  6. the facade: `pvio_torch.PVIO` (Config() float32, the init scale gate
     raised as the golden runs do) on a camera + IMU stream of the
     synthetic scene rendered as a textured room at 480x752 (uint8), under
     deterministic algorithms, FACADE_SECONDS long, each mode run
     sequentially and then pipelined with fused and chained keyframes:
     planes off at Config()'s detect-skip (Core caps the depth at 1, as the
     reference's `run.py --fast` runs it) and on the first
     FACADE_FAST_FRAMES frames with detection on every frame (two frames in
     flight); then planes on (Config()'s default) at the detect-skip. Each run must initialize,
     never re-initialize, emit a pose for every frame after initialization
     (less the frames in flight: the pipeline depth and the SWT stage),
     launch K1 once per frame and keep its ATE under FACADE_MAX_ATE_M; the
     runs of a pair must be identical bit for bit, and the native sensor
     hub must have built. The planes-on runs must detect a plane and hold
     PLANES_MIN_TRACKS plane tracks; they print the planes detected, the
     slots in use at the end, the plane tracks, the keyframe steps in
     which `promote_pending`, `extend_planes`, `merge_planes` and
     `update_parameters` changed the window, and each plane stage's median
     host ms. Every run prints the initialization frame, the keyframes, the
     initializing call's time and the median ms per `track_camera` call by
     state. Then the first FACADE_CPU_FRAMES frames through the port on the
     CPU (planes off), at float32 against the card's sequential run and at
     float64 against a card run at float64: the same initialization frame,
     the first call after which a host decision (KLT status, track ids, the
     window's frames, keyframes, tracks, flags, observations, plane slots,
     plane ids and the tracks' planes) differs (none may at float64), and
     the card's positions within MAX_FACADE_F32_DP_M / MAX_FACADE_F64_DP_M
     of the CPU's before it. Last, the CLI on the card in a process of its
     own, `python -m pvio_torch.run synthetic --fast` (planes on): exit 0,
     one TUM line per pose it reports, finite poses and its printed ATE
     under CLI_MAX_ATE_M;
  7. the kernel table (JSON; K1's launches are the planes-on sequential
     run's), the total time, the nvidia-smi line and, last, the result.

Exits non-zero, printing no result, when CUDA is not available or the
port's package is not beside this script.
"""

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_FRAMES = 12
KF_EVERY = 4                    # bench.py's keyframe cadence
KF_REPS = 3                     # timed repetitions of each keyframe step
KEY0 = (648, 1)                 # threefry key data of the first frame_step
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores

# K1 against its plain version: the kernel sums in another order in float32
K1_REL_TOL, K1_ABS_TOL = 1e-6, 1e-9
# card vs CPU chain, both float32: the kernel, cuBLAS and the CPU round
# differently, and a KLT/RANSAC/detection decision can flip on a hair.
# Measured on an H100 (700 W): agreement 1.0, median |dkp| 7.6e-6 px,
# final |dp| 1.7e-7 m; the bounds keep a margin of ~100x.
MIN_STATUS_AGREEMENT = 0.995
MAX_MEDIAN_KP_PX = 1e-3
MAX_FINAL_DP_M = 1e-5
# card vs CPU keyframes, both float32: ba_step's solved window, marg_step's
# prior through S^T S and S^T infovec (relative to their largest entry).
# Measured on an H100 (700 W), worst of 3 keyframes: |dp| 2.384e-6 m,
# |dtheta| 5.807e-7 rad, flags 1.0, accepted 10 vs 10, prior 4.342e-4. The
# bounds are ~100x those, the flag and accept bounds the slice's ceilings
# (at most 1e-3 m, 1e-3 rad, >= 0.99 flags, accepted within 1).
MAX_KF_DP_M = 2.4e-4
MAX_KF_DTHETA_RAD = 6e-5
MIN_KF_FLAG_AGREEMENT = 0.99
MAX_KF_ACCEPTED_DIFF = 1
MAX_KF_PRIOR_REL = 5e-2
# the facade phase: scene length (s), the golden tier's ATE bound
# (tests/test_golden_run.py:88), the frames of the card-vs-CPU run and its
# bound on positions while every host decision of the two runs agrees
FACADE_SECONDS = 4.5
FACADE_MAX_ATE_M = 0.10
FACADE_CPU_FRAMES = 50
# the min_free-0 pair runs the first FACADE_FAST_FRAMES frames
FACADE_FAST_FRAMES = 60
# the planes-on facade runs the same FACADE_SECONDS stream (its first plane
# enters the window after frame 48 of 90 on an H100) and must hold at
# least PLANES_MIN_TRACKS plane tracks after some call
PLANES_MIN_TRACKS = 10
# the CLI on the card: `python -m pvio_torch.run synthetic --fast`, and a
# bound on the ATE it prints that catches a diverged run. The built-in
# scene (blob frames, the production init scale gate) is not a golden run:
# measured on an H100 (700 W), its float32 run initializes three frames
# after the CPU's float32 run (36 poses against 39) and reads 0.269 m
# (the CPU 0.069 m); at float64 card and CPU agree (0.069 m, 36 poses).
CLI_MAX_ATE_M = 0.5
CLI_TIMEOUT_S = 400
# card vs CPU facade over FACADE_CPU_FRAMES frames: positions until the
# first host decision that differs. Measured on an H100 (700 W): no
# decision differs; float32 2.2e-5 m at initialization, 5.1e-4 m from the
# first tracked frame, 2.4e-3 m after the first keyframe; float64 5.0e-6 m
# throughout. The bounds keep ~4x and ~10x.
MAX_FACADE_F32_DP_M = 1e-2
MAX_FACADE_F64_DP_M = 5e-5


def log(msg):
    print(msg, flush=True)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=60, warmup=5):
    """Median milliseconds of fn() on the current stream, CUDA events around
    each call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps=60, warmup=5):
    """Mean device time of fn() in milliseconds: the durations of the CUDA
    kernels it launches, summed over a torch.profiler trace of `reps`
    calls. Raises when the trace holds no CUDA kernel: then nothing of fn
    was seen on the device, and a host-clock time would hide that."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("device_ms: the profiler trace holds no CUDA kernel")
    return sum(e.time_range.elapsed_us() for e in kernels) / reps / 1e3


# ---------------------------------------------------------------------------
# the bench scene (bench.py's coupled chain, built with the port's numpy copy)


def imu_grids(scene, frames, F, N, dtype=np.float32):
    """bench.py's per-slot IMU buffers: slot j holds the samples from frame
    frames[j-1] to frames[j], t_frames[j] is frames[j]'s time."""
    ts, ws, accs = np.zeros((F, N)), np.zeros((F, N, 3)), np.zeros((F, N, 3))
    mask, t_frames = np.zeros((F, N), bool), np.zeros(F)
    for j, fr in enumerate(frames):
        t_frames[j] = scene.frame_t[fr]
        if j:
            sel = (scene.imu_t >= scene.frame_t[frames[j - 1]]) & (scene.imu_t < scene.frame_t[fr])
            n = min(int(sel.sum()), N)
            ts[j, :n], ws[j, :n], accs[j, :n] = (scene.imu_t[sel][:n], scene.gyro[sel][:n],
                                                 scene.accel[sel][:n])
            mask[j, :n] = True
    return ts.astype(dtype), ws.astype(dtype), accs.astype(dtype), mask, t_frames.astype(dtype)


def bench_inputs(cfg, n_frames):
    """Window, renders and IMU of the bench scene (float32 numpy and port
    tensors on the CPU). Returns (window, host dict)."""
    import torch

    from pvio_torch.io import synthetic

    n_kf = cfg.window_frame_capacity - 1
    gap = 4
    scene = synthetic.make_scene(duration=6.0, fps=20.0, imu_rate=200.0,
                                 n_points=280, n_plane_points=160, seed=648)
    kf = list(range(0, n_kf * gap, gap))
    w, _, info = synthetic.solver_window_from_scene(
        scene, kf, F_cap=cfg.window_frame_capacity, T_cap=cfg.track_capacity,
        P_cap=cfg.plane_capacity, dtype=torch.float32, kp_noise=0.002,
        imu_cap=cfg.imu_buffer_capacity)
    w, n_members = synthetic.flag_plane_tracks(w, scene, info)
    if n_members < cfg.plane_min_tracks:
        raise RuntimeError(f"bench window has {n_members} plane tracks")
    base = kf[-1]
    images = np.stack([
        (synthetic.render_frame(scene, base + fi, cfg.K, cfg.image_size) * 255 + 0.5)
        .astype(np.uint8) for fi in range(n_frames + 1)])
    kp, vis = synthetic.project_points(scene, np.array([base]))
    chosen = np.asarray(info["chosen"])
    fx, fy, cx, cy = cfg.K[0, 0], cfg.K[1, 1], cfg.K[0, 2], cfg.K[1, 2]
    col_px = np.stack([kp[0, chosen, 0] * fx + cx, kp[0, chosen, 1] * fy + cy], axis=-1)
    sel = (scene.imu_t >= scene.frame_t[base]) & (scene.imu_t < scene.frame_t[base + 1])
    F, N = cfg.window_frame_capacity, cfg.imu_buffer_capacity
    host = dict(images=images, col_px=col_px, col_vis=vis[0, chosen],
                pnp_imu=(scene.imu_t[sel], scene.gyro[sel], scene.accel[sel]),
                t_new=float(scene.frame_t[base + 1]),
                tail_idx=len(kf) - 1, n_tracks=len(chosen),
                # keyframe IMU: the window's layout, and the layout after
                # slot 0 is marginalized and the new frame appended
                imu_ops=imu_grids(scene, kf, F, N),
                imu_ops2=imu_grids(scene, kf[1:] + [base + 1], F, N),
                track_life=np.full(cfg.track_capacity, 20, np.int32))
    return w, host


def associate(kp0, mask0, col_px, col_vis, T_cap):
    """bench.py's one-time detector-slot -> window-column association:
    greedy nearest-first within 3 px. Returns slot_of_col (T_cap,)."""
    slot_of_col = np.full(T_cap, -1, np.int64)
    live = np.nonzero(mask0)[0]
    if len(live):
        d2 = ((kp0[live][:, None, :] - col_px[None, :, :]) ** 2).sum(-1)
        d2[:, ~col_vis] = np.inf
        used = set()
        for si in np.argsort(d2.min(axis=1)):
            ci = int(np.argmin(d2[si]))
            if d2[si, ci] < 3.0 ** 2 and ci not in used:
                slot_of_col[ci] = live[si]
                used.add(ci)
    return slot_of_col


def to_device(nt, device):
    """NamedTuple of tensors (nested ones included) onto a device."""
    return type(nt)(*(to_device(x, device) if hasattr(x, "_fields") else x.to(device)
                      for x in nt))


def rotation_angle(qa, qb):
    """Angles (rad) of the relative rotations qa^-1 qb of (..., 4) quaternions
    (w, x, y, z), in float64 (an arccos of their float32 dot product cannot
    resolve angles below ~5e-4 rad)."""
    qa, qb = np.asarray(qa, np.float64), np.asarray(qb, np.float64)
    w = np.sum(qa * qb, axis=-1)
    xyz = (qa[..., :1] * qb[..., 1:] - qb[..., :1] * qa[..., 1:]
           - np.cross(qa[..., 1:], qb[..., 1:]))
    return 2.0 * np.arctan2(np.linalg.norm(xyz, axis=-1), np.abs(w))


def finite(*xs):
    return all(bool(x.isfinite().all()) for x in xs)


def check_solve(info, w2, what):
    """Raise unless the solve lowered its cost, accepted a step and left a
    finite window."""
    c0, c1, acc = (float(info["initial_cost"]), float(info["final_cost"]),
                   int(info["accepted"]))
    if not (c1 < c0 and acc >= 1 and finite(w2.q, w2.p, w2.v, w2.bg, w2.ba, w2.inv_depth)):
        raise RuntimeError(f"{what}: cost {c0} -> {c1}, {acc} accepted steps, or a "
                           f"non-finite window")
    return c0, c1, acc


def run_chain(kern, w, host, n_frames, kf_every=KF_EVERY):
    """first_frame_step, association, then n_frames x (frame_step ->
    association -> pnp_step) with the tail pose chained; after every
    kf_every-th frame ba_step + marg_step on the chained window, which then
    resets to the base window (bench.py:237-254). Returns per-frame and
    per-keyframe records (numpy), host-clock step times and the last
    frame's device outputs."""
    import torch

    from pvio_torch.frontend import detect

    dev, dt = kern.device, kern.dtype
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    w = w_base = to_device(w, dev)
    images = host["images"]
    pyr, resp, kp, mask = kern.first_frame_step(images[0])
    slot_of_col = associate(kp.cpu().numpy(), mask.cpu().numpy(), host["col_px"],
                            host["col_vis"], w.kp.shape[1])
    n_assoc = int((slot_of_col >= 0).sum())
    slot_d = torch.as_tensor(slot_of_col, device=dev)
    sc = torch.clamp(slot_d, 0, kp.shape[0] - 1)
    alive = slot_d >= 0
    fx, fy, cx, cy = (float(v) for v in kern.cfg.camera_intrinsic)
    kinv_scale = torch.tensor([1.0 / fx, 1.0 / fy], dtype=dt, device=dev)
    kinv_off = torch.tensor([cx, cy], dtype=dt, device=dev)
    imu = kern.pad_imu_host(*host["pnp_imu"])
    dq_id = np.array([1.0, 0, 0, 0])
    tail = host["tail_idx"]
    rec = dict(status=[], kp=[], p=[], q=[], rounds=[], frame_ms=[], pnp_ms=[],
               n_assoc=n_assoc, alive=[], kf=[])
    for i in range(n_frames):
        sync()
        t0 = time.perf_counter()
        pyr, resp, kp, mask, status, det = kern.frame_step(
            pyr, resp, images[i + 1], kp, mask, dq_id,
            np.array([KEY0[0], KEY0[1] + i], np.uint32))
        sync()
        t1 = time.perf_counter()
        rec["rounds"].append(detect.LAST_ROUNDS)
        alive = alive & mask[sc] & (slot_d >= 0)
        z = (kp[sc] - kinv_off) * kinv_scale
        out = kern.pnp_step(w, *imu, host["t_new"], tail, z, alive, alive, 0)
        q1, p1 = out[0], out[1]
        q, p = w.q.clone(), w.p.clone()
        q[tail], p[tail] = q1, p1
        w = w._replace(q=q, p=p)
        sync()
        t2 = time.perf_counter()
        rec["frame_ms"].append(1e3 * (t1 - t0))
        rec["pnp_ms"].append(1e3 * (t2 - t1))
        rec["status"].append(status.cpu().numpy())
        rec["kp"].append(kp.cpu().numpy())
        rec["p"].append(p1.cpu().numpy())
        rec["q"].append(q1.cpu().numpy())
        rec["alive"].append(int(alive.sum()))
        rec["last"] = dict(pnp=out, z=z, alive=alive)
        if kf_every and (i + 1) % kf_every == 0:
            rec["kf"].append(keyframe(kern, w, host, sync, f"keyframe after frame {i + 1}"))
            w = w_base
    return rec


def keyframe(kern, w, host, sync, what):
    """bench.py's keyframe: ba_step (make_prior=False) + marg_step, both
    checked. Returns a record of the solved window and the new prior."""
    sync()
    t0 = time.perf_counter()
    w2, info, xw, _ = kern.ba_step(w, *host["imu_ops"], host["track_life"], False)
    sync()
    t1 = time.perf_counter()
    wm = kern.marg_step(w2, *host["imu_ops"])
    sync()
    t2 = time.perf_counter()
    c0, c1, acc = check_solve(info, w2, f"ba_step, {what}")
    if not finite(xw[w2.track_mask], wm.prior.sqrt_info, wm.prior.infovec, wm.p, wm.q):
        raise RuntimeError(f"marg_step, {what}: non-finite prior or window")
    S, iv = wm.prior.sqrt_info.double(), wm.prior.infovec.double()
    return dict(cost=(c0, c1), accepted=acc, ba_ms=1e3 * (t1 - t0), marg_ms=1e3 * (t2 - t1),
                p=w2.p.cpu().numpy(), q=w2.q.cpu().numpy(),
                frames=w2.frame_mask.cpu().numpy(), flags=w2.track_flags.cpu().numpy(),
                StS=(S.T @ S).cpu().numpy(), Siv=(S.T @ iv).cpu().numpy())


def keyframe_inputs(kern, w, host, last):
    """kf_step's arguments for one keyframe at the bench's new frame
    (base + 1) with do_marg=True, on the base window with its initial
    prior, every 5th non-plane track made fresh (not TF_VALID, re-based
    off slot 0) so that the adoption has work. `last` holds the last
    pnp_step's device outputs. Returns (window, args before the
    triangulation, (tri_depth, tri_ok), tri_mask_host, track_life, slot)."""
    import torch

    from pvio_torch.estimation import marginalization as marg_mod
    from pvio_torch.map import window as win

    w = to_device(w, kern.device)
    wr = marg_mod.rebase_tracks(w, kern.extr, removed_slot=0)
    T = w.kp.shape[1]
    col = torch.arange(T, device=kern.device)
    fresh = ((col % 5 == 2) & ((w.track_flags & win.TF_PLANE) == 0) & w.track_mask
             & (wr.ref_frame != 0))
    w = w._replace(track_flags=torch.where(fresh, w.track_flags & ~win.TF_VALID, w.track_flags),
                   ref_frame=torch.where(fresh, wr.ref_frame, w.ref_frame),
                   inv_depth=torch.where(fresh, wr.inv_depth, w.inv_depth))
    w = w._replace(prior=kern.initial_prior(w))
    out, z, alive = last["pnp"], last["z"], last["alive"]
    nf_obs = alive.cpu().numpy()
    obs = (w.obs_mask & w.frame_mask[:, None]).cpu().numpy()
    flags, ref = w.track_flags.cpu().numpy(), w.ref_frame.cpu().numpy()
    tri_mask_host = (w.track_mask.cpu().numpy() & (obs[1:].sum(axis=0) + nf_obs >= 2)
                     & ((flags & (win.TF_VALID | win.TF_PLANE)) == 0) & (ref != 0))
    life = (obs.sum(axis=0) + nf_obs).astype(np.int32) + 15
    slot = int(w.frame_mask.sum()) - 1            # the slot freed by the marginalization
    args = (*host["imu_ops"], *host["imu_ops2"], *out[:5], z, alive)
    return w, args, (out[6], out[7]), tri_mask_host, life, slot


def leaves(x):
    """Every tensor of a nested output, in a fixed order."""
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in leaves(x[k])]
    return [t for item in x for t in leaves(item)]


def synced_ms(fn, reps):
    """Median host-clock milliseconds of fn() between two device
    synchronisations, and fn()'s last output."""
    import torch

    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times), out


# ---------------------------------------------------------------------------
# the facade: PVIO on a rendered camera + IMU stream


def facade_config(**kw):
    """Config() at float32, planes off, the init scale gate raised as the
    golden runs raise it (the synthetic rig sweeps more than 1 m while
    initializing), plus the given fields."""
    from pvio_torch.io.config import Config

    cfg = Config()
    cfg.dtype = "float32"
    cfg.enable_plane_constraint = False
    cfg.initializer_max_scale = 5.0
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _render_room(args):
    from pvio_torch.io import synthetic

    scene, fi, K, size, q_bc, p_bc = args
    img = synthetic.render_frame_room(scene, fi, K, size, q_bc=q_bc, p_bc=p_bc)
    return (img * 255.0 + 0.5).astype(np.uint8)


def facade_inputs(cfg, duration=FACADE_SECONDS):
    """The scene (seed 648) and its frames rendered as a textured room at
    the config's size, uint8, in a pool of worker processes."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from pvio_torch.io import synthetic

    scene = synthetic.make_scene(duration=duration, fps=20.0, imu_rate=200.0, n_points=8,
                                 seed=648)
    jobs = [(scene, fi, cfg.K, cfg.image_size, np.asarray(cfg.q_bc), np.asarray(cfg.p_bc))
            for fi in range(len(scene.frame_t))]
    workers = max(1, min(len(jobs), os.cpu_count() or 1))
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        images = list(ex.map(_render_room, jobs))
    return scene, images


def decisions(vio):
    """The host decisions standing after a track_camera call: the newest
    raw frame's keypoint mask and track ids (KLT status, detections
    merged) and, once initialized, the window's integer and boolean
    mirrors (frames kept, keyframes, tracks kept, their flags and
    observations, plane slots, plane ids and the tracks' planes)."""
    out = {}
    ft = vio.core.feature_tracker
    if ft.frames:
        out["kp_mask"] = ft.frames[-1].kp_mask.copy()
        out["track_ids"] = ft.frames[-1].track_ids.copy()
    swt = vio.core.frontend.swt
    if swt is not None:
        for name in ("frame_mask", "keyframe", "frame_id", "track_mask", "track_flags",
                     "track_id", "obs_mask", "plane_mask", "plane_ids", "plane_id"):
            out[name] = getattr(swt.hw, name).copy()
    return out


def first_flip(a, b):
    """(call, {decision: entries that differ}) of the first call after
    which two runs' decisions differ, or None when they agree throughout."""
    for k, (da, db) in enumerate(zip(a, b)):
        diff = {n: (int(np.sum(da[n] != db[n])) if n in da and n in db else -1)
                for n in sorted(set(da) | set(db))}
        diff = {n: c for n, c in diff.items() if c}
        if diff:
            return k, diff
    return None


def instrument_planes(pe, log, kf_calls):
    """Wrap a PlaneExtractor's keyframe stages to log the host ms of each
    call and the keyframe steps (by count so far) in which each changed
    the window: a plane promoted, tracks adopted, planes merged, plane
    parameters refit."""
    from pvio_torch.map.window import TF_PLANE

    def plane_tracks(hw):
        return int(((hw.track_flags & TF_PLANE) != 0).sum())

    def wrap(name, changed):
        fn = getattr(pe, name)

        def wrapped(hw, *a, **k):
            before = (int(hw.plane_mask.sum()), plane_tracks(hw), hw.plane_normal.copy(),
                      hw.plane_distance.copy())
            t0 = time.perf_counter()
            out = fn(hw, *a, **k)
            log["ms"].setdefault(name, []).append(1e3 * (time.perf_counter() - t0))
            if name == "issue_detection" and out is not None:
                log["issued"] += 1
            delta = changed(before, hw)
            if delta:
                log[name].append((kf_calls[0], delta))
            return out
        setattr(pe, name, wrapped)

    wrap("issue_detection", lambda b, hw: 0)
    wrap("promote_pending", lambda b, hw: int(hw.plane_mask.sum()) - b[0])
    wrap("extend_planes", lambda b, hw: plane_tracks(hw) - b[1])
    wrap("merge_planes", lambda b, hw: b[0] - int(hw.plane_mask.sum()))
    wrap("update_parameters", lambda b, hw: int(
        ((hw.plane_normal != b[2]).any(axis=1) | (hw.plane_distance != b[3]))[hw.plane_mask].sum()))


def run_facade(cfg, scene, images, device=None, n_frames=None, fused_preint=None):
    """Drive pvio_torch.PVIO over the stream (IMU first, then each frame
    at its time; the first n_frames frames, or all) with K1's count zeroed
    just before; `fused_preint` overrides the BA's preintegration bank
    (the card's is the struct-of-arrays one). Returns the run's record:
    trajectory, initialization frame, re-inits, keyframe steps, K1
    launches, poses before the final drain, the plane stages' log, the
    decisions after each call and the host ms of every track_camera call
    with its state (before / initializing / tracking / keyframe: a
    keyframe step ran in the call)."""
    from pvio_torch import PVIO
    from pvio_torch.map.window import TF_PLANE
    from pvio_torch.ops import stencil

    vio = PVIO(cfg, device=device)
    kern = vio.core.kernels
    if fused_preint is not None:               # the BA's preintegration bank
        kern.ba_cfg = kern.ba_cfg._replace(fused_preint=fused_preint)
    kf_calls, inside = [0], [False]
    for name in ("kf_step", "kf_step_chained", "ba_step"):
        def counted(*a, _fn=getattr(kern, name), **k):
            if inside[0]:                  # kf_step runs ba_step: count the outer call
                return _fn(*a, **k)
            kf_calls[0] += 1
            inside[0] = True
            try:
                return _fn(*a, **k)
            finally:
                inside[0] = False
        setattr(kern, name, counted)
    planes = dict(ms={}, issued=0, issue_detection=[], promote_pending=[], extend_planes=[],
                  merge_planes=[], update_parameters=[], extractors=[])
    fw = vio.core.frontend
    if fw._pef is not None:
        make = fw._pef

        def factory():
            pe = make()
            planes["extractors"].append(pe)
            instrument_planes(pe, planes, kf_calls)
            return pe
        fw._pef = factory
    last = len(scene.frame_t) if n_frames is None else n_frames
    stencil.LAUNCHES = 0
    calls, decided, init_fi, init_state, fi = [], [], None, None, 0
    for k in range(len(scene.imu_t)):
        t = scene.imu_t[k]
        vio.track_gyroscope(t, *scene.gyro[k])
        vio.track_accelerometer(t, *scene.accel[k])
        while fi < last and scene.frame_t[fi] <= t:
            was_init, kf0 = vio.initialized, kf_calls[0]
            t0 = time.perf_counter()
            vio.track_camera(scene.frame_t[fi], images[fi])
            ms = 1e3 * (time.perf_counter() - t0)
            if not was_init:
                state = "initializing" if vio.initialized else "before"
            else:
                state = "keyframe" if kf_calls[0] > kf0 else "tracking"
            calls.append((state, ms))
            decided.append(decisions(vio))
            if init_fi is None and vio.initialized:
                init_fi = fi
                init_state = [np.array(x) for x in vio.core.frontend.swt.latest_state]
            fi += 1
    if device != "cpu":
        import torch

        torch.cuda.synchronize()
    launches = stencil.LAUNCHES
    n_before_drain = len(vio.core.outputs)
    traj = vio.get_trajectory()
    swt = vio.core.frontend.swt
    planes["detected"] = sum(pe.next_plane_id for pe in planes.pop("extractors"))
    planes["slots_end"] = int(swt.hw.plane_mask.sum()) if swt else 0
    planes["tracks"] = [int(((d["track_flags"] & TF_PLANE) != 0).sum()) if "track_flags" in d
                        else 0 for d in decided]
    return dict(traj=traj, init_fi=init_fi, init_state=init_state, planes=planes,
                n_reinits=vio.core.frontend.n_reinits,
                initialized=vio.initialized, keyframes=swt.n_keyframes if swt else 0,
                kf_steps=kf_calls[0], launches=launches, n_frames=fi,
                n_before_drain=n_before_drain, calls=calls, decisions=decided,
                hub=vio.core.hub is not None,
                depth=vio.core._pipeline_depth if vio.core._pipelined else 0)


def dp_first(a, b):
    """|dp| (m) of two runs' first poses."""
    return float(np.abs(a["traj"][0][2] - b["traj"][0][2]).max())


def facade_gap(a, b, scene):
    """Card run a against CPU run b: the first decision flip (None if
    none), and the largest |dp| (m) over the poses of frames before it
    and over all common poses (the runs' times must agree)."""
    flip = first_flip(a["decisions"], b["decisions"])
    n = min(len(a["traj"]), len(b["traj"]))
    if [t for t, _, _ in a["traj"][:n]] != [t for t, _, _ in b["traj"][:n]]:
        raise RuntimeError("the card and the CPU facade runs emit at different times")
    t_flip = np.inf if flip is None else scene.frame_t[flip[0]]
    dps = [(t, float(np.abs(pa - pb).max()))
           for (t, _, pa), (_, _, pb) in zip(a["traj"][:n], b["traj"][:n])]
    before = max([d for t, d in dps if t < t_flip], default=0.0)
    return flip, before, max([d for _, d in dps], default=0.0)


def facade_ate(traj, scene):
    """ATE (m) of the trajectory's positions against the scene's, after an
    SE(3) alignment (the golden runs' measure)."""
    import torch

    from pvio_torch.geometry import wahba

    t2idx = {round(t, 6): i for i, t in enumerate(scene.frame_t)}
    pairs = [(p, scene.p_wb[t2idx[round(t, 6)]]) for t, _, p in traj if round(t, 6) in t2idx]
    est = torch.as_tensor(np.array([a for a, _ in pairs]), dtype=torch.float64)
    gt = torch.as_tensor(np.array([b for _, b in pairs]), dtype=torch.float64)
    return float(wahba.ate_rmse(est, gt, with_scale=False))


def check_facade(rec, scene, what):
    """Raise unless the run initialized, never re-initialized, emitted a
    pose per frame after initialization (less the frames still in flight
    before the final drain: the pipeline depth plus the SWT stage),
    launched K1 once per frame and met the ATE bound. Returns the ATE."""
    if not (rec["initialized"] and rec["init_fi"] is not None and rec["hub"]):
        raise RuntimeError(f"{what}: not initialized, or the native sensor hub did not build")
    if rec["n_reinits"]:
        raise RuntimeError(f"{what}: {rec['n_reinits']} re-initializations")
    want = rec["n_frames"] - rec["init_fi"]
    in_flight = rec["depth"] + 1 if rec["depth"] else 0
    if rec["n_before_drain"] < want - in_flight or len(rec["traj"]) < want:
        raise RuntimeError(f"{what}: {rec['n_before_drain']} poses before the drain, "
                           f"{len(rec['traj'])} after, for {want} frames after initialization")
    if rec["launches"] != rec["n_frames"]:
        raise RuntimeError(f"{what}: K1 launched {rec['launches']} times in {rec['n_frames']} frames")
    ate = facade_ate(rec["traj"], scene)
    if not ate < FACADE_MAX_ATE_M:
        raise RuntimeError(f"{what}: ATE {ate} m >= {FACADE_MAX_ATE_M} m")
    return ate


def check_planes(rec, what):
    """Raise unless a planes-on run detected a plane and held at least
    PLANES_MIN_TRACKS plane tracks after some call; log its plane counts,
    the keyframe steps in which each plane stage changed the window, and
    the stages' median host ms."""
    pl = rec["planes"]
    first = next((k for k, d in enumerate(rec["decisions"])
                  if "plane_mask" in d and d["plane_mask"].any()), None)
    log(f"[6]   planes: {pl['detected']} detected (first in the window after frame {first}), "
        f"{pl['slots_end']} slots in use at the end, plane tracks max {max(pl['tracks'])} / "
        f"at the end {pl['tracks'][-1]}; {pl['issued']} detections issued")
    for name in ("promote_pending", "extend_planes", "merge_planes", "update_parameters"):
        log(f"[6]   {name} changed the window at keyframe steps "
            f"{[k for k, _ in pl[name]]} (by {[d for _, d in pl[name]]})")
    log("[6]   median host ms per keyframe: " + ", ".join(
        f"{k} {statistics.median(v):.3f} ({len(v)})" for k, v in pl["ms"].items()))
    if pl["detected"] < 1 or max(pl["tracks"]) < PLANES_MIN_TRACKS:
        raise RuntimeError(f"{what}: {pl['detected']} planes detected, at most "
                           f"{max(pl['tracks'])} plane tracks (want >= 1 and >= "
                           f"{PLANES_MIN_TRACKS})")


def run_cli():
    """`python -m pvio_torch.run synthetic --output <tmp> --fast` (planes on,
    on the card) in a subprocess. Raises unless it exits 0, writes one TUM
    line per pose it reports, and prints an ATE within CLI_MAX_ATE_M."""
    import re
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "trajectory.tum"
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        proc = subprocess.run([sys.executable, "-m", "pvio_torch.run", "synthetic", "--output",
                               str(out), "--fast"], cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=CLI_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"the CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
        rows = [line.split() for line in out.read_text().splitlines()]
    written = re.search(r"^(\d+) poses written to ", proc.stdout, re.M)
    ate = re.search(r"^ATE RMSE \(SE3\): ([0-9.]+) cm over (\d+) poses", proc.stdout, re.M)
    planes = re.search(r"'sliding_window_planes': (\d+)", proc.stdout)
    if written is None or ate is None:
        raise RuntimeError(f"the CLI printed no pose count or ATE: {proc.stdout[-2000:]}")
    vals = np.array(rows, float) if rows else np.zeros((0, 8))
    rec = dict(written=int(written.group(1)), lines=len(rows), ate_cm=ate.group(1),
               ate_m=float(ate.group(1)) / 100, ate_poses=int(ate.group(2)),
               planes=int(planes.group(1)) if planes else None)
    if not (rec["lines"] == rec["written"] > 0 and vals.shape[1] == 8
            and np.isfinite(vals).all() and rec["ate_m"] < CLI_MAX_ATE_M):
        raise RuntimeError(f"the CLI run on the card failed its checks: {rec}")
    return rec


def state_ms(calls):
    """Median host ms of track_camera per state, with the call counts."""
    out = {}
    for state in ("before", "initializing", "tracking", "keyframe"):
        ms = [m for s, m in calls if s == state]
        if ms:
            out[state] = (statistics.median(ms), len(ms))
    return out


# ---------------------------------------------------------------------------


def main():
    # cuBLAS is deterministic only with a fixed workspace, which must be set
    # before its first use (the keyframe phase runs under deterministic
    # algorithms)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs one NVIDIA card",
              file=sys.stderr)
        return 2
    if not (ROOT / "pvio_torch" / "__init__.py").is_file():
        print(f"chip_smoke: the pvio_torch package is not beside {Path(__file__).name}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    from pvio_torch.core.kernels import DeviceKernels
    from pvio_torch.frontend import detect
    from pvio_torch.io.config import Config
    from pvio_torch.ops import stencil
    from pvio_torch.utils import cuda_build

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = gpu_line()
    kind = torch.cuda.get_device_name(0)

    # 1. device and build ---------------------------------------------------
    log(f"[1] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")
    t0 = time.perf_counter()
    built = cuda_build.build_all()
    stencil.build()
    log(f"[1] built {len(built)} kernel source(s) in {time.perf_counter() - t0:.3f} s")
    for src, (_, out) in built.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[1]   {src.name}: {line.strip()}")

    cfg = Config()
    cfg.dtype = "float32"
    cfg.enable_plane_constraint = True
    kern = DeviceKernels(cfg)                # CUDA, or raises

    w, host = bench_inputs(cfg, N_FRAMES)
    H, W = host["images"].shape[1:]

    # 2. K1 against its plain version -----------------------------------------
    pyr0 = kern.preprocess(host["images"][0])
    g = torch.Generator(device="cpu").manual_seed(648)
    th, tw = stencil.TILE
    k1_cases = [("bench render", pyr0[0].contiguous())] + [
        (f"uniform {h}x{w_}", torch.rand(h, w_, generator=g).to(dev))
        for h, w_ in [(480, 752), (240, 376), (481, 755), (1, 1), (3, 5), (7, 130),
                      (th, tw), (th + 1, tw + 1), (1, 752)]]
    # a contiguous view 4 bytes into its storage: TMA cannot take it
    flat = torch.rand(480 * 752 + 1, generator=g).to(dev)
    k1_cases.append(("misaligned view 480x752", flat[1:].view(480, 752)))
    k1_err_main, stages = None, set()
    for name, img in k1_cases:
        plan = stencil.launch_plan(*img.shape, img.data_ptr())
        if stencil.kernel_plan(*img.shape, img.data_ptr()) != plan:
            raise RuntimeError(f"K1 launcher and launch_plan disagree on {name}")
        if plan.tma != (name != "misaligned view 480x752" and img.shape[1] % 4 == 0):
            raise RuntimeError(f"K1 plans the wrong load stage for {name}")
        stage = "tma" if plan.tma else "threads"
        stages.add(stage)
        before = stencil.LAUNCHES
        out = stencil.shi_tomasi_response(img)
        torch.cuda.synchronize()
        if stencil.LAUNCHES != before + 1:
            raise RuntimeError("K1 wrapper did not count its launch")
        ref = detect.shi_tomasi_response(img)
        err = float((out - ref).abs().max())
        lim = K1_REL_TOL * float(ref.abs().max()) + K1_ABS_TOL
        if not (err <= lim and torch.isfinite(out).all()):
            raise RuntimeError(f"K1 disagrees with its plain version on {name}: {err} > {lim}")
        if name == "bench render":
            k1_err_main = err
        log(f"[2] K1 {name} {tuple(img.shape)}: load stage {stage}, grid {plan.grid}, "
            f"max|kernel - plain| = {err:.3e} (limit {lim:.3e})")
    if stages != {"tma", "threads"}:
        raise RuntimeError(f"K1's cases took only the load stage(s) {stages}")
    img0 = pyr0[0].contiguous()
    r_k, r_p = stencil.shi_tomasi_response(img0), detect.shi_tomasi_response(img0)
    xy_k, m_k = kern.detect(img0, torch.zeros(1, 2, device=dev), torch.zeros(1, dtype=torch.bool, device=dev), r_k)
    xy_p, m_p = kern.detect(img0, torch.zeros(1, 2, device=dev), torch.zeros(1, dtype=torch.bool, device=dev), r_p)
    dxy = float((xy_k - xy_p).abs().max())
    if not (torch.equal(m_k, m_p) and dxy <= 1e-3):
        raise RuntimeError(f"detections from K1 and plain responses differ (max {dxy} px)")
    log(f"[2] detections from K1 / plain responses: {int(m_k.sum())} identical keypoints "
        f"(max |dxy| {dxy:.2e} px)")
    k1_ms = device_ms(lambda: stencil.shi_tomasi_response(img0))
    one = torch.empty(1, device=dev)
    floor_ms = device_ms(lambda: one.zero_())
    floor_call_ms = cuda_ms(lambda: one.zero_())
    events_ms = cuda_ms(lambda: None)
    plain_ms = device_ms(lambda: detect.shi_tomasi_response(img0))
    k1_call_ms = cuda_ms(lambda: stencil.shi_tomasi_response(img0))
    plain_call_ms = cuda_ms(lambda: detect.shi_tomasi_response(img0))
    nbytes, nflops = stencil.cost(H, W)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nflops / FP32_FLOPS_PER_S * 1e3
    bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    log(f"[2] K1 at {H}x{W}: device {k1_ms:.6f} ms/launch (per call, host launch included: "
        f"{k1_call_ms:.6f} ms); plain version device {plain_ms:.6f} ms (per call "
        f"{plain_call_ms:.6f} ms); bound {bound_ms:.6f} ms ({bound_by}: {nbytes} B, "
        f"{nflops} flop); no single PyTorch call computes this function (library_ms null)")
    log(f"[2] launch floor: device {floor_ms:.6f} ms for a 1-element zero_() on the card, per "
        f"call {floor_call_ms:.6f} ms (an empty event pair reads {events_ms:.6f} ms); K1 device "
        f"{k1_ms:.6f} ms, per call {k1_call_ms:.6f} ms, bound {bound_ms:.6f} ms")
    torch.cuda.synchronize()

    # 3. the main path ---------------------------------------------------------
    stencil.LAUNCHES = 0
    rec = run_chain(kern, w, host, N_FRAMES)
    torch.cuda.synchronize()
    launches = {"shi_tomasi": stencil.LAUNCHES}
    if rec["n_assoc"] < 50:
        raise RuntimeError(f"association matched {rec['n_assoc']} < 50 window tracks")
    if launches["shi_tomasi"] != N_FRAMES + 1:
        raise RuntimeError(f"K1 launched {launches['shi_tomasi']} times in "
                           f"{N_FRAMES + 1} frames (want one per frame)")
    tracked = [int(s.sum()) for s in rec["status"]]
    if not all(np.isfinite(p).all() and np.isfinite(q).all() for p, q in zip(rec["p"], rec["q"])):
        raise RuntimeError("non-finite pose on the main path")
    if min(tracked) <= 0 or min(rec["alive"]) <= 0:
        raise RuntimeError(f"tracking died: tracked {tracked}, associated {rec['alive']}")
    fs_ms = statistics.median(rec["frame_ms"][1:])
    pnp_ms = statistics.median(rec["pnp_ms"][1:])
    log(f"[3] main path: {rec['n_assoc']} tracks associated, {N_FRAMES} frames, K1 launches "
        f"{launches['shi_tomasi']}, tracked slots {tracked}, associated alive {rec['alive']}")
    log(f"[3] detection rounds per frame {rec['rounds']}")
    log(f"[3] frame_step ms {[round(x, 3) for x in rec['frame_ms']]}")
    log(f"[3] pnp_step ms {[round(x, 3) for x in rec['pnp_ms']]}")
    log(f"[3] median (first frame excluded): frame_step {fs_ms:.3f} ms, pnp_step {pnp_ms:.3f} ms")
    if len(rec["kf"]) != N_FRAMES // KF_EVERY:
        raise RuntimeError(f"{len(rec['kf'])} keyframes in {N_FRAMES} frames")
    for k, r in enumerate(rec["kf"]):
        log(f"[3] keyframe {k + 1}: ba_step {r['ba_ms']:.3f} ms (cost {r['cost'][0]:.6g} -> "
            f"{r['cost'][1]:.6g}, {r['accepted']} accepted steps), marg_step {r['marg_ms']:.3f} ms")

    # 4. the keyframe, chained and fed from the host ------------------------------
    from pvio_torch.estimation import ba as ba_mod

    wk, args, (tri_depth, tri_ok), tri_mask_host, life, slot = keyframe_inputs(
        kern, w, host, rec["last"])
    host_args = tuple(a.cpu() if torch.is_tensor(a) else a for a in args)
    host_tri = (tri_depth.cpu(), tri_mask_host & tri_ok.cpu().numpy())
    torch.use_deterministic_algorithms(True)
    try:
        chained = kern.kf_step_chained(wk, *args, tri_depth, tri_ok, tri_mask_host, life, slot,
                                       False, True)
        fed = kern.kf_step(wk, *host_args, *host_tri, life, slot, False, True)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    la, lb = leaves(chained), leaves(fed)
    same = len(la) == len(lb) and all(a.dtype == b.dtype and torch.equal(a, b)
                                      for a, b in zip(la, lb))
    c0, c1, acc = check_solve(chained[1], chained[0], "kf_step_chained")
    if not (same and finite(chained[0].prior.sqrt_info, chained[0].prior.infovec)):
        raise RuntimeError("kf_step_chained and kf_step (host copies) differ, or a non-finite prior")
    log(f"[4] keyframe (do_marg, slot {slot}, {int(host_tri[1].sum())} triangulations adopted): "
        f"kf_step_chained == kf_step on all {len(la)} outputs, bit for bit, under "
        f"deterministic algorithms; cost {c0:.6g} -> {c1:.6g}, {acc} accepted steps")
    w_kf = to_device(w, dev)
    kf_ms = {
        "ba_step": synced_ms(lambda: kern.ba_step(w_kf, *host["imu_ops"], host["track_life"],
                                                  False), KF_REPS)[0],
        "marg_step": synced_ms(lambda: kern.marg_step(w_kf, *host["imu_ops"]), KF_REPS)[0],
        "kf_step": synced_ms(lambda: kern.kf_step(wk, *host_args, *host_tri, life, slot,
                                                  False, True), KF_REPS)[0],
        "kf_step_chained": synced_ms(lambda: kern.kf_step_chained(
            wk, *args, tri_depth, tri_ok, tri_mask_host, life, slot, False, True), KF_REPS)[0],
    }
    w_att = kern.attach_deltas(w_kf, *host["imu_ops"])
    for fused in (True, False):
        kf_ms[f"solve fused_preint={fused}"] = synced_ms(lambda: ba_mod.solve(
            w_att, kern.extr, kern.ba_cfg._replace(fused_preint=fused)), KF_REPS)[0]
    log(f"[4] median device-synchronised ms of {KF_REPS}: "
        + ", ".join(f"{k} {v:.3f}" for k, v in kf_ms.items()))

    # 5. card vs CPU -------------------------------------------------------------
    torch.set_num_threads(max(1, os.cpu_count() or 1))
    t0 = time.perf_counter()
    rec_cpu = run_chain(DeviceKernels(cfg, device="cpu"), w, host, N_FRAMES)
    agree = float(np.mean([np.mean(a == b) for a, b in zip(rec["status"], rec_cpu["status"])]))
    dkp = np.concatenate([np.linalg.norm(a - b, axis=-1)[sa & sb] for a, b, sa, sb in zip(
        rec["kp"], rec_cpu["kp"], rec["status"], rec_cpu["status"])])
    med_dkp = float(np.median(dkp)) if dkp.size else float("inf")
    dp = float(np.linalg.norm(rec["p"][-1] - rec_cpu["p"][-1]))
    log(f"[5] CPU chain {time.perf_counter() - t0:.1f} s: status agreement {agree:.6f}, "
        f"median |dkp| {med_dkp:.3e} px over {dkp.size} slot-frames, max |dkp| "
        f"{float(dkp.max()) if dkp.size else float('nan'):.3e}, final |dp| {dp:.3e} m")
    if not (agree >= MIN_STATUS_AGREEMENT and med_dkp <= MAX_MEDIAN_KP_PX and dp <= MAX_FINAL_DP_M):
        raise RuntimeError("card and CPU runs of the port disagree beyond the stated bounds")
    kf_ok = len(rec_cpu["kf"]) == len(rec["kf"])
    for k, (a, b) in enumerate(zip(rec["kf"], rec_cpu["kf"])):
        live = a["frames"] & b["frames"]
        kdp = float(np.abs(a["p"] - b["p"])[live].max())
        kdth = float(rotation_angle(a["q"], b["q"])[live].max())
        flag_agree = float(np.mean(a["flags"] == b["flags"]))
        prior_rel = max(float(np.abs(a[x] - b[x]).max() / np.abs(b[x]).max())
                        for x in ("StS", "Siv"))
        log(f"[5] keyframe {k + 1} card vs CPU: max |dp| {kdp:.3e} m, max |dtheta| "
            f"{kdth:.3e} rad, flag agreement {flag_agree:.6f}, accepted {a['accepted']} vs "
            f"{b['accepted']}, prior S^T S / S^T infovec max rel {prior_rel:.3e}")
        kf_ok &= (kdp <= MAX_KF_DP_M and kdth <= MAX_KF_DTHETA_RAD
                  and flag_agree >= MIN_KF_FLAG_AGREEMENT
                  and abs(a["accepted"] - b["accepted"]) <= MAX_KF_ACCEPTED_DIFF
                  and prior_rel <= MAX_KF_PRIOR_REL)
    if not kf_ok:
        raise RuntimeError("card and CPU keyframes of the port disagree beyond the stated bounds")

    # 6. the facade ---------------------------------------------------------------
    t0 = time.perf_counter()
    scene, images = facade_inputs(facade_config())
    log(f"[6] rendered {len(images)} frames {images[0].shape} uint8 in "
        f"{time.perf_counter() - t0:.1f} s")
    # Config()'s detect-skip (feature_tracker_detect_min_free 8) caps the
    # pipelined loop at depth 1, as the reference's run.py --fast runs it;
    # detection on every frame (min_free 0) lets it keep two frames in flight
    fast = dict(fused_keyframe=True, chained_keyframe=True, pipelined_host=True,
                pipeline_depth=2)
    pairs = (("Config() detect-skip", {}, None),
             ("detection on every frame", dict(feature_tracker_detect_min_free=0),
              FACADE_FAST_FRAMES),
             ("planes on, Config() detect-skip", dict(enable_plane_constraint=True), None))
    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        for variant, base, n_frames in pairs:
            for mode, kw in (("sequential, fused keyframes", dict(fused_keyframe=True)),
                             ("pipelined, fused + chained keyframes", fast)):
                what = f"{variant}, {mode}"
                t0 = time.perf_counter()
                rec = run_facade(facade_config(**base, **kw), scene, images, n_frames=n_frames)
                rec["seconds"], rec["what"] = time.perf_counter() - t0, what
                rec["ate"] = check_facade(rec, scene, what)
                runs[what] = rec
                init_ms = [m for s, m in rec["calls"] if s == "initializing"][0]
                log(f"[6] {what}: {rec['seconds']:.1f} s, {rec['n_frames']} frames, initialized "
                    f"at frame {rec['init_fi']} (that call {init_ms:.3f} ms), {rec['keyframes']} "
                    f"keyframes ({rec['kf_steps']} keyframe steps), re-inits {rec['n_reinits']}, "
                    f"{len(rec['traj'])} poses ({rec['n_before_drain']} before the drain, depth "
                    f"{rec['depth']}), K1 launches {rec['launches']}, ATE {rec['ate']:.6f} m "
                    f"(bound {FACADE_MAX_ATE_M} m)")
                log(f"[6]   median ms per track_camera call: " + ", ".join(
                    f"{k} {v[0]:.3f} ({v[1]} calls)" for k, v in state_ms(rec["calls"]).items()))
                if "enable_plane_constraint" in base:
                    check_planes(rec, what)
    finally:
        torch.use_deterministic_algorithms(False)
    recs = list(runs.values())
    for seq, pipe in (recs[0:2], recs[2:4], recs[4:6]):
        same = len(seq["traj"]) == len(pipe["traj"]) and all(
            t1 == t2 and np.array_equal(q1, q2) and np.array_equal(p1, p2)
            for (t1, q1, p1), (t2, q2, p2) in zip(seq["traj"], pipe["traj"]))
        if not same:
            raise RuntimeError(f"{seq['what']} and its pipelined + chained run differ")
        log(f"[6] {seq['what']} == pipelined (depth {pipe['depth']}) + chained: all "
            f"{len(seq['traj'])} poses identical bit for bit")
    seq = recs[0]
    launches["shi_tomasi"] = recs[4]["launches"]

    # the first frames through the port on the CPU, at float32 against the
    # card's run above and at float64 against a card run at float64
    for dt, bound in (("float32", MAX_FACADE_F32_DP_M), ("float64", MAX_FACADE_F64_DP_M)):
        t0 = time.perf_counter()
        cfg_dt = facade_config(fused_keyframe=True, dtype=dt)
        cpu = run_facade(cfg_dt, scene, images, device="cpu", n_frames=FACADE_CPU_FRAMES)
        card = seq if dt == "float32" else run_facade(cfg_dt, scene, images,
                                                       n_frames=FACADE_CPU_FRAMES)
        flip, dp_agreed, dp_all = facade_gap(card, cpu, scene)
        dv = float(np.abs(card["init_state"][3] - cpu["init_state"][3]).max())
        log(f"[6] card vs CPU, {dt}, first {FACADE_CPU_FRAMES} frames "
            f"({time.perf_counter() - t0:.1f} s): initialized at frame {card['init_fi']} vs "
            f"{cpu['init_fi']} (|dp| {dp_first(card, cpu):.3e} m, |dv| {dv:.3e} m/s there), "
            f"first decision flip "
            f"{'none' if flip is None else f'after frame {flip[0]}: {flip[1]}'}, max |dp| before it "
            f"{dp_agreed:.3e} m (bound {bound} m), over all poses {dp_all:.3e} m")
        if not (card["init_fi"] == cpu["init_fi"] is not None and dp_agreed <= bound
                and (dt == "float32" or flip is None)):
            raise RuntimeError(f"the card and the CPU facade runs at {dt} disagree beyond the "
                               "stated bounds")

    # the CLI on the card, in a process of its own
    t0 = time.perf_counter()
    cli = run_cli()
    log(f"[6] CLI `python -m pvio_torch.run synthetic --fast` on the card: "
        f"{time.perf_counter() - t0:.1f} s, rc 0, {cli['lines']} TUM lines for {cli['written']} "
        f"poses written, ATE {cli['ate_cm']} cm as it prints it, over {cli['ate_poses']} "
        f"poses (bound {CLI_MAX_ATE_M} m), {cli['planes']} plane slots at the end")

    # 7. summary -----------------------------------------------------------------
    kernels = [dict(name="shi_tomasi", route="cuda", source="pvio_torch/csrc/shi_tomasi.cu",
                    replaces="pvio_tpu/ops/stencil.py:28", launches=launches["shi_tomasi"],
                    max_abs_err=k1_err_main, ms=k1_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=None)]
    log(f"[7] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
(`python -m pvio_torch.run`); then many sequences on the card: the vmapped
multi-sequence chain (`parallel.multi_seq`) and N engines behind one host
loop (`parallel.serving`); last, the BA sharded over a `torch.distributed`
process mesh (`parallel.sharded_ba`) as a world of one.

Phases; each raises on failure, so any failure exits non-zero:
  1. device and build: the card's name and power limit, the kernels built
     with nvcc (one process per source, started together);
  2. kernel K1 (Shi-Tomasi response) against its plain PyTorch version on
     the card over the full image: the bench render, uniform noise from
     1x1 to 481x755 (one tile, one tile plus a pixel each way, 1x752) and
     a contiguous view 4 bytes into its storage; each case prints the load
     stage it took (TMA or per-thread loads), which must match the
     launcher's plan, and both stages must occur; the same for its float64
     form (a float64 image: the bench render, uniform noise, an odd width
     and a view 8 bytes into its storage) at the float64 tolerance, and
     its time. Then the detections it
     feeds, and its time beside the plain version's, the card's bound and
     a launch floor (the device time of a 1-element zero_()), and its time
     at 512x512 (phase 6's golden-shaped TUM-VI geometry). Then K1's
     batched form on MS_B bench frames in one launch (each image equal to
     its own launch bit for bit), kernel S1 (Poisson-disk selection) on
     their candidates, one image and the stack, equal to the plain rounds
     loop bit for bit at float32 and float64 with the same round counts,
     and on its edge cases (`selection_cases`); kernel E1 (4x4 symmetric
     eigen-decompositions, a quad of lanes per matrix) on the window's DLT
     normal matrices and an MS_B stack of them, in their float32, one kernel
     per call in the profiler trace, its sweeps equal to its CPU model's
     (`eigh_op.jacobi_model`) on every matrix; kernel E2 (n x n: a warp per
     matrix up to 32, above it a thread block cluster per matrix) on the
     marginalization's 15x15 and (F*15)-square matrices, an MS_B stack of
     the latter and a 240x240 matrix (16 frame slots), its sweeps beside
     its CPU model's; each against torch.linalg.eigh, timed beside it, its
     bound and the launch floor;
  3. the main path: the bench scene, first_frame_step, the slot -> track
     association, then N_FRAMES x (frame_step -> association -> pnp_step)
     chaining the tail pose, and every KF_EVERY-th frame ba_step
     (make_prior=False) + marg_step on the chained window, which then
     resets to the base window as bench.py does (the synthetic window has
     no host topology upkeep); every solve must lower its cost, accept a
     step and leave a finite window and prior; launch counts are zeroed
     just before and read just after, and K1 and S1 must have launched
     once per frame, E1 at least once per motion step, E2 once at each
     size per marginalization;
  4. the keyframe: one kf_step_chained (do_marg=True) fed the last
     pnp_step's device outputs, and one kf_step fed their host copies,
     under deterministic algorithms: every output identical; then
     kf_step_chained under sync debug mode "warn", which must name no
     synchronising call (fault F2, repaired by E2). Then the
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
     reference's `run.py --fast` runs it) and with detection on every
     frame (two frames in flight), each on the first FACADE_FAST_FRAMES
     frames; then planes on (Config()'s default) at the detect-skip on the
     first FACADE_PLANES_FRAMES. Each run must initialize,
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
     initializing call's time, the median ms per `track_camera` call by
     state and the S1 and E1 launches; each pair prints its sequential and
     pipelined tracking and keyframe ms. Then the first FACADE_CPU_FRAMES
     frames through the port on the
     CPU (planes off), at float32 against the card's sequential run and at
     float64 against a card run at float64: the same initialization frame,
     the first call after which a host decision (KLT status, track ids, the
     window's frames, keyframes, tracks, flags, observations, plane slots,
     plane ids and the tracks' planes) differs (none may at float64), and
     the card's positions within MAX_FACADE_F32_DP_M / MAX_FACADE_F64_DP_M
     of the CPU's before it. Then the CLI on the card in a process of its
     own, `python -m pvio_torch.run synthetic` sequentially and with `--fast
     --view3d` (planes on, float32), each on its first CLI_MAX_FRAMES
     frames: each exits 0, writes one TUM line per
     pose it reports, finite poses, its printed ATE under CLI_MAX_ATE_M
     (fault F4's bound), and prints its initialization frame; the second
     writes a non-empty 3D viewer page. Last, the golden-shaped run: the
     golden harness's pieces (`pvio_torch.golden_run`) on
     config/tum-vi.yaml at float32 (512x512, the equidistant undistorter
     in the loop) over the first GOLDEN_FRAMES frames of a FACADE_SECONDS
     stream: it must initialize, never
     re-initialize, launch K1 once per frame and keep its ATE under
     FACADE_MAX_ATE_M; it prints the ms per track_camera call by state, and
     K1 at 512x512 against its plain version on its first frame;
  7. the multi-sequence chain at Config()'s size, planes on: MS_B
     sequences through one vmapped chain, K1 and S1 launched once per frame,
     E1 at least once per motion step and E2 once at each size per
     marginalization (counts zeroed just before, read just after), the
     sequences MS_CHECK unbatched against their batched results within
     MAX_MS_COST_REL / MAX_MS_DP_M, and ms per group batched at B = 1, 4
     and MS_B beside B unbatched chains;
  8. serving: two PVIO engines (planes on) behind one MultiSequenceServer
     on the first SERVE_FRAMES frames, engine 0 the phase-6 stream held to
     phase 6's sequential run, engine 1 the SERVE_SEED room stream held to
     its own solo run, both bit for bit under deterministic algorithms; the
     host waits once or twice per tick; ms per tick beside the two solo
     calls; then the stream served again under sync debug mode "warn"
     (so the timed run is not) for PyTorch's own synchronising calls per
     tick, by kind of tick: a tick that does not initialize may name no
     site in ransac.py (fault F3, repaired);
  9. the sharded BA (`parallel.sharded_ba`, reaching no kernel): a world of
     one over NCCL (`ProcessMesh(1, 1)`, tp = dp = 1: NCCL cannot put two
     ranks on one card) solving SHARD_B copies of BASELINE config 5's window
     (16 keyframes x 256 tracks) at float64 within MAX_SHARD_DP_M of
     ba.solve on the card, and at float32 (its gap printed, not held); ms
     per sharded solve beside ba.solve's; no synchronising call in a warm
     solve (one runs under sync debug mode "error"); a CUDA window through
     the checkpoint and back, every leaf equal;
 10. the seconds each phase took and the total (a `phase_seconds` JSON
     line; each phase also logs its own seconds as the next begins), the
     kernel table (JSON; the single-image entries' launches are the
     planes-on sequential run's, K1's float64 entry's the float64 card run
     of phase 6's card-vs-CPU comparison, where every K1 launch must be the
     float64 form's, the 512x512 entry's the golden-shaped run's, the
     batched entries' the vmapped chain's), the nvidia-smi line and, last,
     the result.

Exits non-zero, printing no result, when CUDA is not available or the
port's package is not beside this script.
"""

import collections
import itertools
import json
import os
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_FRAMES = 12
KF_EVERY = 4                    # bench.py's keyframe cadence
KF_REPS = 3                     # timed repetitions of each keyframe step
KEY0 = (648, 1)                 # threefry key data of the first frame_step
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
FP64_FLOPS_PER_S = 34e12        # H100 SXM float64 outside the tensor cores, data sheet
FP64_TC_FLOPS_PER_S = 67e12     # H100 SXM float64 on the tensor cores (E2's mixing), data sheet

# K1 against its plain version: the kernel sums in another order in float32
K1_REL_TOL, K1_ABS_TOL = 1e-6, 1e-9
# K1's float64 form (a float64 image, fault F7's repair) against the plain
# version at float64: another order in float64, ~1e7 times under the float32
# form's own distance from it (~1e-7 of the response range)
K1_F64_REL_TOL, K1_F64_ABS_TOL = 1e-13, 1e-18
# the multi-sequence chain (BASELINE config 4): MS_B sequences (seeds 648 +
# 31 i) through one vmapped chain of MS_GROUPS groups of MS_KF_EVERY frames;
# the sequences MS_CHECK also run unbatched. Batched against unbatched, both
# on the card at float32 (the batched matmuls may round differently): the
# final costs within MAX_MS_COST_REL and the final positions within
# MAX_MS_DP_M. Measured on an H100 (700 W): costs 1.55e-6 relative,
# positions 4.1e-6 m at most; the bounds keep ~100x, as the keyframe
# bounds do.
MS_B, MS_GROUPS, MS_KF_EVERY, MS_CHECK = 11, 2, 4, (0, 6)
MAX_MS_COST_REL = 2e-4
MAX_MS_DP_M = 5e-4
# serving: two PVIO engines behind one host loop on the first SERVE_FRAMES
# frames of the planes-on room stream (engine 0: phase 6's seed; engine 1:
# SERVE_SEED, a SERVE_SECONDS scene: its length fixes the room's random
# draws), each held bit for bit to its solo sequential run
SERVE_FRAMES = 50
SERVE_SEED = 679
SERVE_SECONDS = 3.05
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
# bound on positions while every host decision of the two runs agrees.
# Every run of the phase initializes at frame 35 of its stream on an H100
# and takes a keyframe step every ~5 frames after it; each is cut to a
# depth that keeps its initializing call and at least two keyframe steps
FACADE_SECONDS = 4.5
FACADE_MAX_ATE_M = 0.10
FACADE_CPU_FRAMES = 50
# the planes-off pairs run the first FACADE_FAST_FRAMES frames
FACADE_FAST_FRAMES = 50
# the planes-on pair runs the first FACADE_PLANES_FRAMES frames of the same
# stream (its first plane enters the window after frame 48 on an H100) and
# must hold at least PLANES_MIN_TRACKS plane tracks after some call
FACADE_PLANES_FRAMES = 70
PLANES_MIN_TRACKS = 10
# the golden-shaped run drives the first GOLDEN_FRAMES frames of its
# FACADE_SECONDS stream
GOLDEN_FRAMES = 70
# the CLI on the card: `python -m pvio_torch.run synthetic`, sequential and
# --fast (blob frames at 320x240, float32, planes on, the production init
# scale gate: not a golden run), each held to the golden tier's 0.10 m since
# fault F4's repair (the initializer's two-view geometry in float64).
# Measured on an H100 (700 W) before it: initialized at frame 44 with a
# scale of 0.227, 0.6225 m sequential and 0.1812 m --fast over 36 poses;
# after it: frame 44, 0.0449 m and 0.0697 m; since fault F5's repair (the
# marginalization and the BA steps in float64 too) 0.0436 m and 0.069 m, as
# the CPU reads at float32 and float64.
CLI_MAX_ATE_M = 0.10
CLI_TIMEOUT_S = 400
# the CLI's runs stop after the first CLI_MAX_FRAMES frames of its scene
# (`--max-frames`; it initializes at frame 44 of 80)
CLI_MAX_FRAMES = 64
# card vs CPU facade over FACADE_CPU_FRAMES frames: positions until the
# first host decision that differs. Measured on an H100 (700 W): no
# decision differs; float32 2.2e-5 m at initialization, 5.1e-4 m from the
# first tracked frame, 2.4e-3 m after the first keyframe (1.1e-5 m
# throughout since the BA steps and the marginalization compute in
# float64); float64 5.0e-6 m throughout, while K1 computed a float64
# image's response in float32 (fault F7, repaired). The bounds keep ~4x
# and ~10x.
MAX_FACADE_F32_DP_M = 1e-2
MAX_FACADE_F64_DP_M = 5e-5
# the sharded BA (phase 9): BASELINE config 5's enlarged window
# (tests/test_parallel.py:126-137: 16 keyframes x 256 tracks, two LM
# iterations, planes off), SHARD_B perturbed copies, through the sharded
# solver on a world of one over NCCL (tp = dp = 1), held to ba.solve on the
# card at float64 within MAX_SHARD_DP_M (the reference holds its sharded
# solve to 1e-8 m); its float32 run's gap is printed, not held
SHARD_B = 2
MAX_SHARD_DP_M = 1e-8
SHARD_REPS = 5


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


TRACE_PAD = 8          # kernels of a trace's own at each end of it
TRACE_PAD_S = 0.01     # the host's wait between them and the calls
TRACE_TRIES = 3        # traces device_ms takes before a lost kernel event fails it


def profile_calls(fn, reps=60, warmup=5, pad=True):
    """A torch.profiler trace of `reps` calls of fn() (after `warmup` calls
    outside it) inside a "trace calls" range. With `pad`, TRACE_PAD
    1-element kernels of the trace's own run before the calls and after
    them, each group TRACE_PAD_S of host time away from the calls, so that
    the events a trace loses at its start are theirs (once the process has
    spent seconds on the host, PERF.md §6). Returns the
    (name, microseconds) of the CUDA kernels in start order: the calls'
    (those that start within TRACE_PAD_S / 2 of the range), the pad
    kernels before them and those after them."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    buf = torch.zeros(1, device="cuda")
    n_pad = TRACE_PAD if pad else 0
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_pad):
            buf.add_(1.0)
        torch.cuda.synchronize()
        if pad:
            time.sleep(TRACE_PAD_S)
        with record_function("trace calls"):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        if pad:
            time.sleep(TRACE_PAD_S)
        for _ in range(n_pad):
            buf.add_(1.0)
        torch.cuda.synchronize()
    events = prof.events()
    rng = next(e.time_range for e in events if e.name == "trace calls")
    margin = 1e6 * TRACE_PAD_S / 2 if pad else float("inf")
    parts = ([], [], [])                      # calls, before, after
    for t0, us, name in sorted((e.time_range.start, e.time_range.elapsed_us(), e.name)
                               for e in events
                               if e.device_type == torch.autograd.DeviceType.CUDA
                               and not getattr(e, "is_user_annotation", False)):
        part = 1 if t0 < rng.start - margin else 2 if t0 > rng.end + margin else 0
        parts[part].append((name, us))
    return parts


def trace_kernels(fn, reps=60, warmup=5):
    """The CUDA kernels of `reps` calls of fn() in a torch.profiler trace,
    as (name, microseconds) in start order (`profile_calls`, padded at
    both ends: a trace has lost kernel events at its start, PERF.md §6,
    `time_eig.py --trace-check`). Raises when the trace holds no CUDA
    kernel of the calls: then nothing of fn was seen on the device, and a
    host-clock time would hide that."""
    kernels, _, _ = profile_calls(fn, reps, warmup)
    if not kernels:
        raise RuntimeError("trace_kernels: the profiler trace holds no CUDA kernel")
    return kernels


def device_ms(fn, reps=60, warmup=5, kernel=None, count=None, alone=False):
    """Mean device time of fn() in milliseconds: the durations of the CUDA
    kernels it launches, summed over a torch.profiler trace of `reps`
    calls (`trace_kernels`), over reps. For a wrapper of one of the port's
    kernels, `kernel` is a part of that kernel's name and `count()` reads
    the wrapper's launch count: it raises unless the wrapper counted
    warmup + reps launches, and it reads only a trace that holds the
    kernel exactly reps times (and, with `alone`, no other kernel), so
    that a reading is never low by an event the trace lost. A trace that
    holds it fewer times is printed and taken again, TRACE_TRIES traces
    in all; then it raises."""
    if kernel is None:
        return sum(us for _, us in trace_kernels(fn, reps, warmup)) / reps / 1e3
    tries = []
    for _ in range(TRACE_TRIES):
        before = count()
        events, pads_before, pads_after = profile_calls(fn, reps, warmup)
        launched = count() - before
        if launched != warmup + reps:
            raise RuntimeError(f"device_ms: {warmup + reps} calls launched {kernel} "
                               f"{launched} times")
        seen = sum(kernel in name for name, _ in events)
        if seen == reps and not (alone and len(events) != seen):
            return sum(us for _, us in events) / reps / 1e3
        tries.append(dict(
            kernel=kernel, calls=reps, seen=seen, kernels=len(events),
            names=sorted({name[:60] for name, _ in events}),
            kernel_in_pads=[sum(kernel in name for name, _ in p)
                            for p in (pads_before, pads_after)],
            pads=[len(pads_before), len(pads_after)]))
        log(f"device_ms: a trace short of calls, taken again: {json.dumps(tries[-1])}")
    raise RuntimeError(f"device_ms: {TRACE_TRIES} traces of {reps} calls each lost {kernel} "
                       f"events: {json.dumps(tries)}")


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

    from pvio_torch.ops import poisson

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
        # the selection's rounds: S1's device count on the card, read after
        # the step, or the plain loop's
        rec["rounds"].append(int(poisson.LAST_KERNEL_ROUNDS[0]) if dev.type == "cuda"
                             else poisson.LAST_ROUNDS)
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


def selection_cases(dtype, seed=648):
    """S1's edge cases, [(name, cand (C, 2), alive (C,), min_distance)] as
    CPU tensors: pairs exactly min_distance apart (on an axis, where the
    squared distance equals d2, and in random directions, within an ulp of
    it), every candidate alive, none alive, C = 1 (alive and not), all
    candidates on one point, min_distance 0, a deep chain (rounds = half
    its length), and counts of alive candidates that are not a multiple of
    32 or of a CTA's share of the rows (C = 33, 100, 129, 1000, 1024 with a
    random mask)."""
    import torch

    rng = np.random.default_rng(seed)

    def case(name, cand, alive, md=12.0):
        return (name, torch.as_tensor(np.asarray(cand, np.float64), dtype=dtype),
                torch.as_tensor(np.asarray(alive, bool)), md)

    def uniform(C, extent):
        return rng.uniform(0.0, extent, size=(C, 2))

    exact = uniform(300, 150.0)
    exact[1::4] = exact[0::4] + [12.0, 0.0]
    exact[3::4] = exact[2::4] + [0.0, 12.0]
    ring = uniform(300, 160.0)
    theta = rng.uniform(0.0, 2 * np.pi, size=150)
    ring[1::2] = ring[0::2] + 12.0 * np.stack([np.cos(theta), np.sin(theta)], axis=-1)
    chain = np.stack([np.arange(25) * 10.8, np.zeros(25)], axis=-1)
    cases = [case("pairs exactly min_distance apart on an axis", exact, np.ones(300)),
             case("pairs min_distance apart in random directions", ring, rng.uniform(size=300) < 0.85),
             case("pairs min_distance apart, d2 rounded to the type", ring, np.ones(300), 12.3),
             case("all alive, dense", uniform(1024, 250.0), np.ones(1024)),
             case("none alive", uniform(64, 60.0), np.zeros(64)),
             case("C = 1, alive", uniform(1, 10.0), np.ones(1)),
             case("C = 1, not alive", uniform(1, 10.0), np.zeros(1)),
             case("all on one point", np.full((40, 2), 7.25), np.ones(40)),
             case("min_distance 0", uniform(64, 20.0), np.ones(64), 0.0),
             case("a deep chain", chain, np.ones(25))]
    for C in (33, 100, 129, 1000):
        cases.append(case(f"C = {C}, all alive", uniform(C, 9.0 * np.sqrt(C)), np.ones(C)))
    cases.append(case("C = 1024, 900 alive", uniform(1024, 300.0),
                      rng.permutation(1024) < 900))
    return cases


def eig_cases(kern, w):
    """E1's inputs at the main path's shapes: the DLT normal matrices A^T A
    (T, 4, 4) of every track of the window, as `window.triangulate_tracks`
    forms them, and MS_B copies of them, each entry scaled by 1 + 1e-3 u
    with u a seeded symmetric uniform noise (the first copy unscaled), as
    the vmapped chain stacks them (`marg_cases` perturbs E2's stack so)."""
    import torch

    from pvio_torch.geometry import lie, triangulation
    from pvio_torch.map import window as win

    q_ws, p_ws = win._camera_poses(w.q, w.p, kern.extr)
    R_sw = lie.quat_to_mat(lie.quat_conj(q_ws))
    Ps = torch.cat([R_sw, -lie.mv(R_sw, p_ws)[..., None]], dim=-1)
    obs = (w.obs_mask & w.frame_mask[:, None]).T
    rows = triangulation._dlt_rows(Ps[None], w.kp.transpose(0, 1)) * obs[..., None, None]
    A = rows.reshape(rows.shape[0], -1, 4)
    A = (A.transpose(-1, -2) @ A).contiguous()
    T = A.shape[0]
    g = torch.Generator(device="cpu").manual_seed(648)
    u = torch.rand(MS_B, T, 4, 4, generator=g, dtype=torch.float64) * 2.0 - 1.0
    u = ((u + u.transpose(-1, -2)) / 2.0).to(A.device, A.dtype)
    u[0] = 0.0
    return {"4x4": A, f"{MS_B}x{T}x4x4": (A * (1.0 + 1e-3 * u)).contiguous()}


def marg_cases(kern, w, host):
    """E2's inputs at the main path's shapes: the two symmetric matrices
    that marginalizing slot 0 of the window decomposes (the 15x15 victim
    block and the (F*15)-square prior), recorded from one
    `marg_step` on the bench window, and MS_B copies of the prior, each entry
    scaled by 1 + 1e-3 u with u a seeded symmetric uniform noise (its
    zeroed slot stays zero), as the vmapped chain stacks them; last, the
    prior's size at E2's largest window (16 frame slots, n = N_MAX = 240)
    as a seeded rank-deficient `marg_like` matrix in the prior's dtype."""
    import torch

    from pvio_torch.ops import eigh as eigh_op

    seen, real = [], eigh_op.eigh
    eigh_op.eigh = lambda A: seen.append(A.clone()) or real(A)
    try:
        kern.marg_step(w, *host["imu_ops"])
    finally:
        eigh_op.eigh = real
    A15, AP = seen
    n = AP.shape[-1]
    g = torch.Generator(device="cpu").manual_seed(648)
    u = torch.rand(MS_B, n, n, generator=g, dtype=torch.float64) * 2.0 - 1.0
    u = ((u + u.transpose(-1, -2)) / 2.0).to(AP.device, AP.dtype)
    u[0] = 0.0
    big = torch.as_tensor(marg_like(np.random.default_rng(240), 1, eigh_op.N_MAX)[0],
                          dtype=AP.dtype, device=AP.device)
    return {"15x15": A15, f"{n}x{n}": AP, f"{MS_B}x{n}x{n}": (AP * (1.0 + 1e-3 * u)).contiguous(),
            f"{eigh_op.N_MAX}x{eigh_op.N_MAX}": big}


def marg_like(rng, B, n, zeroed=15):
    """B symmetric positive semi-definite n x n matrices (float64 numpy)
    shaped like the marginalization's: J^T J with column scales over three
    decades, the last `zeroed` rows and columns exactly zero (the slot
    `_shift_out` frees; none when zeroed = 0)."""
    J = rng.normal(size=(B, 2 * n, n)) * 10.0 ** rng.uniform(0.0, 1.5, size=(B, 1, n))
    A = J.transpose(0, 2, 1) @ J
    if zeroed:
        A[:, -zeroed:, :] = 0.0
        A[:, :, -zeroed:] = 0.0
    return A


def dlt_normals(B):
    """B 4x4 DLT normal matrices A^T A of 8 rows each (float64 numpy, seed
    15): of max(B, 8) drawn, every 4th from the first all zero (an empty
    track column), every 4th from the second with its last column scaled by
    1e-3 (poorly conditioned); the last B of them (B = 256: E1's first card
    test's matrices; B = 1: a full-rank one)."""
    rng = np.random.default_rng(15)
    rows = rng.normal(size=(max(B, 8), 8, 4))
    rows[::4] = 0.0
    rows[1::4, :, 3] *= 1e-3
    return (rows.transpose(0, 2, 1) @ rows)[-B:]


def eig_gap(A, L_k, V_k, L_p):
    """E1's or E2's eigenpairs against torch.linalg.eigh's eigenvalues: the
    largest of the eigenvalue gap, the kernel's residual |A v - lambda v|
    and its departure from orthonormality, each relative to the matrix's
    largest |eigenvalue| (eigenvectors are compared through the residual:
    their signs, and the basis of a repeated eigenvalue, are free). Returns
    (gap, limit): 1e-5 at float32 (the decompositions round differently; a
    tolerance of ~100 unit roundoffs), 1e-12 at float64; for n x n matrices
    with 16 n unit roundoffs above that (n = 105 and 135), 16 n unit
    roundoffs, since an n x n decomposition's error, and the residual's own
    float32 product, grow with n."""
    import torch

    scale = L_p.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30)
    gap_l = ((L_k - L_p).abs() / scale).max()
    res = (A @ V_k - V_k * L_k[..., None, :]).abs().amax(dim=-2) / scale
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    orth = (V_k.transpose(-1, -2) @ V_k - eye).abs().max()
    gap = float(max(gap_l, res.max(), orth))
    u, base = (2.0 ** -24, 1e-5) if A.dtype == torch.float32 else (2.0 ** -53, 1e-12)
    return gap, max(base, 16 * A.shape[-1] * u)


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


def sync_sites(caught):
    """The sites (file:line) of the synchronising calls that sync debug
    mode "warn" named among the recorded warnings `caught`."""
    return [f"{os.path.basename(c.filename)}:{c.lineno}" for c in caught
            if "synchronizing CUDA operation" in str(c.message)]


def host_waits(fn):
    """Run fn() under sync debug mode "warn" and return the sites of the
    synchronising calls PyTorch made in it (host reads, synchronising
    copies)."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sync_sites(caught)


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


def facade_inputs(cfg, duration=FACADE_SECONDS, seed=648, n_frames=None):
    """The scene and its first n_frames frames (all by default) rendered as
    a textured room at the config's size, uint8, in a pool of worker
    processes."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from pvio_torch.io import synthetic

    scene = synthetic.make_scene(duration=duration, fps=20.0, imu_rate=200.0, n_points=8,
                                 seed=seed)
    jobs = [(scene, fi, cfg.K, cfg.image_size, np.asarray(cfg.q_bc), np.asarray(cfg.p_bc))
            for fi in range(len(scene.frame_t) if n_frames is None else n_frames)]
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
    trajectory, initialization frame, re-inits, keyframe steps, K1 (and of
    them its float64 form's), S1, E1 and E2 launches, poses before the
    final drain, the plane stages' log, the decisions after each call and the host ms of every track_camera call
    with its state (before / initializing / tracking / keyframe: a
    keyframe step ran in the call)."""
    from pvio_torch import PVIO, golden_run
    from pvio_torch.map.window import TF_PLANE
    from pvio_torch.ops import eigh as eigh_op
    from pvio_torch.ops import poisson, stencil

    vio = PVIO(cfg, device=device)
    if fused_preint is not None:               # the BA's preintegration bank
        kern = vio.core.kernels
        kern.ba_cfg = kern.ba_cfg._replace(fused_preint=fused_preint)
    kf_calls = [0]
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
    decided, init = [], {}

    def on_frame(fi):
        decided.append(decisions(vio))
        if "state" not in init and vio.initialized:
            init["state"] = [np.array(x) for x in vio.core.frontend.swt.latest_state]

    stencil.LAUNCHES = stencil.LAUNCHES_F64 = poisson.LAUNCHES = eigh_op.LAUNCHES = 0
    eigh_op.BLOCK_LAUNCHES.clear()
    rec = golden_run.drive(vio, scene, images.__getitem__, on_frame=on_frame,
                           n_frames=n_frames, kf_calls=kf_calls)
    if device != "cpu":
        import torch

        torch.cuda.synchronize()
    launches, s1_launches, e1_launches = stencil.LAUNCHES, poisson.LAUNCHES, eigh_op.LAUNCHES
    k1_f64_launches, e2_launches = stencil.LAUNCHES_F64, dict(eigh_op.BLOCK_LAUNCHES)
    n_before_drain = len(vio.core.outputs)
    traj = vio.get_trajectory()
    swt = vio.core.frontend.swt
    planes["detected"] = sum(pe.next_plane_id for pe in planes.pop("extractors"))
    planes["slots_end"] = int(swt.hw.plane_mask.sum()) if swt else 0
    planes["tracks"] = [int(((d["track_flags"] & TF_PLANE) != 0).sum()) if "track_flags" in d
                        else 0 for d in decided]
    return dict(traj=traj, init_fi=rec["init_fi"], init_state=init.get("state"), planes=planes,
                n_reinits=vio.core.frontend.n_reinits,
                initialized=vio.initialized, keyframes=swt.n_keyframes if swt else 0,
                kf_steps=rec["kf_steps"], launches=launches, k1_f64_launches=k1_f64_launches,
                s1_launches=s1_launches,
                e1_launches=e1_launches, e2_launches=e2_launches, n_frames=rec["n_frames"],
                n_before_drain=n_before_drain, calls=rec["calls"], decisions=decided,
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


def run_cli(fast):
    """`python -m pvio_torch.run synthetic --output <tmp> --max-frames
    CLI_MAX_FRAMES` (planes on, on the card, float32 as the preset is),
    with `--fast --view3d <tmp>` when
    `fast`, in a subprocess. Raises unless it exits 0, writes one TUM line
    per pose it reports, prints an ATE within CLI_MAX_ATE_M and, with
    --view3d, writes a non-empty 3D viewer page (numpy and json only; the
    flags that draw with matplotlib stay on the CPU). The initialization
    frame is the scene's frames less the poses: the CLI emits one pose per
    frame from that frame on."""
    import re
    import tempfile

    from pvio_torch.io import synthetic

    n_frames = min(CLI_MAX_FRAMES,   # of run.py's scene
                   len(synthetic.make_scene(duration=4.0, n_points=320).frame_t))
    with tempfile.TemporaryDirectory() as tmp:
        out, page = Path(tmp) / "trajectory.tum", Path(tmp) / "map.html"
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        flags = ["--fast", "--view3d", str(page)] if fast else []
        proc = subprocess.run([sys.executable, "-m", "pvio_torch.run", "synthetic", "--output",
                               str(out), "--max-frames", str(CLI_MAX_FRAMES), *flags],
                              cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=CLI_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"the CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
        rows = [line.split() for line in out.read_text().splitlines()]
        view3d_bytes = page.stat().st_size if page.is_file() else 0
    if fast and not (view3d_bytes > 0 and f"3D viewer written to {page}" in proc.stdout):
        raise RuntimeError(f"the CLI wrote no 3D viewer page: {proc.stdout[-2000:]}")
    written = re.search(r"^(\d+) poses written to ", proc.stdout, re.M)
    ate = re.search(r"^ATE RMSE \(SE3\): ([0-9.]+) cm over (\d+) poses", proc.stdout, re.M)
    planes = re.search(r"'sliding_window_planes': (\d+)", proc.stdout)
    if written is None or ate is None:
        raise RuntimeError(f"the CLI printed no pose count or ATE: {proc.stdout[-2000:]}")
    vals = np.array(rows, float) if rows else np.zeros((0, 8))
    rec = dict(written=int(written.group(1)), lines=len(rows), ate_cm=ate.group(1),
               view3d_bytes=view3d_bytes,
               ate_m=float(ate.group(1)) / 100, ate_poses=int(ate.group(2)),
               init_fi=n_frames - int(ate.group(2)),
               planes=int(planes.group(1)) if planes else None)
    if not (rec["lines"] == rec["written"] > 0 and vals.shape[1] == 8
            and np.isfinite(vals).all() and rec["ate_m"] < CLI_MAX_ATE_M):
        raise RuntimeError(f"the CLI run on the card failed its checks: {rec}")
    return rec


def golden_phase():
    """The golden harness's pieces on config/tum-vi.yaml at float32 over the
    first GOLDEN_FRAMES frames of a FACADE_SECONDS stream: the Config from
    the YAML (512x512, equidistant), those frames rendered in a pool and
    undistorted, `golden_run.drive` on the
    card with K1's, S1's, E1's and E2's counts zeroed just before and read
    just after, and the readout. Raises unless the run initialized, never
    re-initialized, launched K1 once per frame and kept its ATE under
    FACADE_MAX_ATE_M. Returns its record and the level-0 image of its first
    frame (K1's 512x512 input)."""
    import torch

    from pvio_torch import PVIO, golden_run
    from pvio_torch.ops import eigh as eigh_op
    from pvio_torch.ops import poisson, stencil

    args = golden_run.parse_args([str(ROOT / "config" / "tum-vi.yaml"), "--dtype", "float32",
                                  "--duration", str(FACADE_SECONDS)])
    cfg = golden_run.build_config(args)
    scene = golden_run.make_scene(args)
    t0 = time.perf_counter()
    images = golden_run.render_images(scene, cfg, args, frames=range(GOLDEN_FRAMES))
    render_s = time.perf_counter() - t0
    vio = PVIO(cfg)
    stencil.LAUNCHES = poisson.LAUNCHES = eigh_op.LAUNCHES = 0
    eigh_op.BLOCK_LAUNCHES.clear()
    t0 = time.perf_counter()
    rec = golden_run.drive(vio, scene, golden_run.image_source(images, scene, cfg, args),
                           n_frames=GOLDEN_FRAMES)
    torch.cuda.synchronize()
    rec.update(seconds=time.perf_counter() - t0, render_s=render_s, launches=stencil.LAUNCHES,
               s1_launches=poisson.LAUNCHES, e1_launches=eigh_op.LAUNCHES,
               e2_launches=dict(eigh_op.BLOCK_LAUNCHES), n_reinits=vio.core.frontend.n_reinits,
               initialized=vio.initialized, planes=len(vio.get_planes()),
               size=tuple(images[0].shape))
    if not (rec["initialized"] and rec["init_fi"] is not None) or rec["n_reinits"]:
        raise RuntimeError(f"golden-shaped run: initialized {rec['initialized']}, "
                           f"{rec['n_reinits']} re-initializations")
    rec.update(golden_run.readout(vio.get_trajectory(), scene))
    if rec["launches"] != rec["n_frames"]:
        raise RuntimeError(f"golden-shaped run: K1 launched {rec['launches']} times in "
                           f"{rec['n_frames']} frames")
    if not rec["ate"] < FACADE_MAX_ATE_M:
        raise RuntimeError(f"golden-shaped run: ATE {rec['ate']} m >= {FACADE_MAX_ATE_M} m")
    img0 = vio.core.kernels.preprocess(images[0])[0].contiguous()
    return rec, img0


# ---------------------------------------------------------------------------
# the sharded BA on the card: a world of one over NCCL


def sharded_phase():
    """Phase 9: `parallel.sharded_ba` over NCCL as a world of one
    (`ProcessMesh(1, 1)` on cuda:0), on SHARD_B perturbed copies of BASELINE
    config 5's window, at float64 against ba.solve on the card and at
    float32 (the gap printed); ms per sharded solve beside ba.solve's (one
    window after the other); the synchronising calls of a warm solve (sync
    debug mode "warn") and one warm solve under "error"; a CUDA window
    through `checkpoint.save_window` / `load_window`. Returns a record."""
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.utils import _pytree as pytree

    from pvio_torch.estimation import ba as ba_mod
    from pvio_torch.io import checkpoint, synthetic
    from pvio_torch.parallel import batch as pbatch
    from pvio_torch.parallel import sharded_ba

    dev = torch.device("cuda", 0)
    scene = synthetic.make_scene(duration=6.0, fps=20.0, n_points=300, seed=7)
    w, extr, info = synthetic.solver_window_from_scene(
        scene, list(range(0, 16 * 4, 4)), F_cap=16, T_cap=256, dtype=torch.float64,
        device=dev, kp_noise=0.001)
    if info["n_frames"] != 16:
        raise RuntimeError(f"the config-5 window holds {info['n_frames']} keyframes, not 16")
    ws = []
    for seed in range(SHARD_B):     # tests/test_parallel.py's _perturb
        dp = np.random.default_rng(seed).normal(size=tuple(w.p.shape)) * 0.005
        dp[0] = 0.0
        ws.append(w._replace(p=w.p + torch.as_tensor(dp, device=dev)))
    cfg = ba_mod.BAConfig(iterations=2, kp_sqrt_inv_cov=283.0, use_planes=False)
    rec = dict(tracks=info["n_tracks"])

    def to32(tree):
        return pytree.tree_map(lambda a: a.float() if a.is_floating_point() else a, tree)

    with tempfile.TemporaryDirectory() as tmp:
        # NCCL bootstraps over a socket of its own; a world of one needs loopback only
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg_init", rank=0,
                                world_size=1)
        try:
            mesh = sharded_ba.ProcessMesh(1, 1)
            if mesh.device != dev:
                raise RuntimeError(f"the NCCL mesh chose {mesh.device}, not {dev}")
            solver = sharded_ba.make_sharded_solver(mesh, extr, cfg)
            wb = pbatch.stack_windows(ws)
            out, costs = solver(wb)
            singles = [ba_mod.solve(wi, extr, cfg)[0] for wi in ws]
            rec["dp_m"] = max(float((out.p[i] - s.p).abs().max()) for i, s in enumerate(singles))
            if not (torch.isfinite(costs).all() and torch.isfinite(out.p).all()
                    and rec["dp_m"] <= MAX_SHARD_DP_M):
                raise RuntimeError(f"the float64 sharded solve parts from ba.solve by "
                                   f"{rec['dp_m']} m (bound {MAX_SHARD_DP_M} m), costs {costs}")
            rec["costs"] = [float(c) for c in costs]
            solver32 = sharded_ba.make_sharded_solver(mesh, to32(extr), cfg)
            wb32 = to32(wb)
            out32, costs32 = solver32(wb32)
            singles32 = [ba_mod.solve(to32(wi), to32(extr), cfg)[0] for wi in ws]
            rec["dp32_vs64_m"] = float((out32.p.double() - out.p).abs().max())
            rec["dp32_vs_solve32_m"] = max(float((out32.p[i] - s.p).abs().max())
                                           for i, s in enumerate(singles32))
            rec["costs32_finite"] = bool(torch.isfinite(costs32).all())
            rec["sharded_ms"] = cuda_ms(lambda: solver(wb), reps=SHARD_REPS, warmup=1)
            rec["solve_ms"] = cuda_ms(lambda: [ba_mod.solve(wi, extr, cfg) for wi in ws],
                                      reps=SHARD_REPS, warmup=1)
            rec["sharded32_ms"] = cuda_ms(lambda: solver32(wb32), reps=SHARD_REPS, warmup=1)
            # warm: the communicator exists; a solve must not wait on the host
            rec["sync_sites"] = host_waits(lambda: solver(wb))
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                again, _ = solver(wb)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            if not torch.equal(again.p, out.p):
                raise RuntimeError("a second sharded solve of the same batch differs")
            path = Path(tmp) / "window.npz"
            checkpoint.save_window(path, ws[0])
            back = checkpoint.load_window(path)
            lv = pytree.tree_leaves(ws[0])
            rec["checkpoint_leaves"] = len(lv)
            if not all(b.is_cuda and b.dtype == a.dtype and torch.equal(a, b)
                       for a, b in zip(lv, pytree.tree_leaves(back))):
                raise RuntimeError("a CUDA window does not come back equal from its checkpoint")
        finally:
            dist.destroy_process_group()
    return rec


# ---------------------------------------------------------------------------
# many sequences on one card: the vmapped chain and the served fleet


def multi_seq_phase(cfg):
    """`parallel.multi_seq` at the config's size: MS_B sequences through
    one vmapped chain with the kernels' counts zeroed just before and read
    just after (K1 and S1 must have launched once per frame, not per
    sequence, E1 at least once per motion step, E2 once at each size per
    marginalization),
    the sequences MS_CHECK unbatched against their batched results, and the
    batched chain's time per group at B = 1, 4 and MS_B beside B unbatched
    chains' (B times the mean unbatched chain measured here). Raises on any
    failed check; returns the phase's record."""
    import torch

    from pvio_torch.core.kernels import DeviceKernels
    from pvio_torch.ops import eigh as eigh_op
    from pvio_torch.ops import poisson, stencil
    from pvio_torch.parallel import multi_seq

    kern = DeviceKernels(cfg)
    n_frames = MS_GROUPS * MS_KF_EVERY
    t0 = time.perf_counter()
    inputs = [multi_seq.build_sequence_inputs(cfg, kern, n_frames, seed=648 + 31 * i)
              for i in range(MS_B)]
    ws, arrays = [w for w, _ in inputs], [a for _, a in inputs]
    build_s = time.perf_counter() - t0

    def batched(B):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = multi_seq.run_batched(kern, cfg, ws[:B], arrays[:B], MS_GROUPS, MS_KF_EVERY)
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    stencil.LAUNCHES = poisson.LAUNCHES = eigh_op.LAUNCHES = 0
    eigh_op.BLOCK_LAUNCHES.clear()
    (costs_b, wfs), ms_full = batched(MS_B)
    launches = {"shi_tomasi_batched": stencil.LAUNCHES, "poisson_select_batched": poisson.LAUNCHES}
    e1, e2 = eigh_op.LAUNCHES, dict(eigh_op.BLOCK_LAUNCHES)
    if set(launches.values()) != {n_frames + 1}:
        raise RuntimeError(f"the vmapped chain of {n_frames + 1} frames launched {launches} "
                           "(want one launch of each kernel per frame)")
    if e1 < n_frames:
        raise RuntimeError(f"the vmapped chain's {n_frames} motion steps launched E1 {e1} times "
                           "(want at least one launch per motion step)")
    launches["sym_eig_batched"] = e1
    n_prior = cfg.window_frame_capacity * 15
    if e2 != {15: MS_GROUPS, n_prior: MS_GROUPS}:
        raise RuntimeError(f"the vmapped chain's {MS_GROUPS} marginalizations launched E2 {e2} "
                           "times (by n; want one launch of each size per marginalization)")
    launches["sym_eig_block_batched"] = e2[n_prior]
    if not (np.isfinite(costs_b).all() and len({round(float(c[-1]), 3) for c in costs_b}) == MS_B):
        raise RuntimeError(f"the vmapped chain's final costs are not finite and distinct: {costs_b}")

    chain = multi_seq.make_chain(kern, cfg, MS_GROUPS, MS_KF_EVERY)
    gaps, single_ms = [], []
    for i in MS_CHECK:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        costs, wf = chain(ws[i], multi_seq.upload_arrays(kern, arrays[i]),
                          torch.zeros((), dtype=kern.dtype, device=kern.device))
        costs = costs.cpu().numpy()
        single_ms.append(1e3 * (time.perf_counter() - t0))
        rel = float(np.max(np.abs(costs_b[i] - costs) / np.abs(costs)))
        dp = float((wfs[i].p - wf.p).abs().max())
        gaps.append((i, rel, dp))
    ms = {MS_B: ms_full}
    for B in (1, 4):
        ms[B] = batched(B)[1]
    rec = dict(build_s=build_s, launches=launches, costs=costs_b, gaps=gaps, ms=ms,
               single_ms=statistics.mean(single_ms), frames=n_frames + 1)
    if not all(rel <= MAX_MS_COST_REL and dp <= MAX_MS_DP_M for _, rel, dp in gaps):
        raise RuntimeError(f"the vmapped chain and its unbatched runs disagree beyond the stated "
                           f"bounds: {gaps}")
    return rec


def instrument_ticks(srv, caught):
    """Wrap `srv._tick` to log each tick's host ms, its kind ("init" when
    an engine of the tick was initializing before or after it, "keyframe"
    when an engine ran a keyframe solve in it (a `track_finish` whose
    window tail is a keyframe), else "steady") and the sites (file:line)
    of the synchronising calls that sync debug mode named in it (warnings
    recorded in `caught`: the waits PyTorch makes itself, which
    `transfer.WAITS` does not count).
    Returns (tick_ms, kinds, syncs, restore); `restore()` undoes the
    keyframe count's wrapper."""
    from pvio_torch.core import swt as swt_mod

    tick, finish = srv._tick, swt_mod.SlidingWindowTracker.track_finish
    tick_ms, kinds, syncs, solves = [], [], [], [0]

    def counted_finish(self, pend, fetched=None):
        solves[0] += bool(self.hw.keyframe[self.hw.n_frames - 1])
        return finish(self, pend, fetched)

    def timed_tick(batch):
        fws = [srv.vios[i].core.frontend for i, _ in batch]
        init0, solves0, syncs0 = sum(not fw.initialized for fw in fws), solves[0], len(caught)
        t0 = time.perf_counter()
        tick(batch)
        tick_ms.append((len(batch), 1e3 * (time.perf_counter() - t0)))
        syncs.append(sync_sites(caught[syncs0:]))
        init = init0 + sum(not fw.initialized for fw in fws)
        kinds.append("init" if init else "keyframe" if solves[0] > solves0 else "steady")

    def restore():
        swt_mod.SlidingWindowTracker.track_finish = finish

    srv._tick = timed_tick
    swt_mod.SlidingWindowTracker.track_finish = counted_finish
    return tick_ms, kinds, syncs, restore


def check_waits(ticks, kinds):
    """The served fleet's host waits (`MultiSequenceServer.ticks`, counted
    by `transfer.WAITS`): each fleet harvest is one wait, and a steady
    tick (no engine initializing, no keyframe solve) makes no other, so it
    waits exactly twice when an engine tracks in it. Returns the waits per
    tick of each kind as {kind: {waits: ticks}}; raises otherwise."""
    steady = [(h, w) for (_, h, w), k in zip(ticks, kinds) if k == "steady"]
    if not (all(w >= h for _, h, w in ticks) and steady
            and all(w == h for h, w in steady) and any(w == 2 for _, w in steady)):
        raise RuntimeError(f"the host did not wait once per fleet harvest, twice per steady "
                           f"tick: {list(zip(kinds, ticks))}")
    hist = {}
    for (_, _, w), k in zip(ticks, kinds):
        hist.setdefault(k, {}).setdefault(w, 0)
        hist[k][w] += 1
    return {k: dict(sorted(v.items())) for k, v in sorted(hist.items())}


def serve(cfgs, scenes, images, count_syncs):
    """Feed the scenes' IMU samples and SERVE_FRAMES frames each to a new
    `parallel.serving.MultiSequenceServer` of the given configs, one pump
    per IMU sample of scenes[0]. With count_syncs, sync debug mode "warn"
    names PyTorch's own synchronising calls in each tick (`instrument_ticks`);
    without it the ticks are timed as the solo runs were. Returns (server,
    tick_ms, kinds, syncs, seconds)."""
    import torch

    from pvio_torch.parallel.serving import MultiSequenceServer

    srv = MultiSequenceServer(cfgs, auto_pump=False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tick_ms, kinds, syncs, restore = instrument_ticks(srv, caught)
        fis = [0] * len(scenes)
        t0 = time.perf_counter()
        if count_syncs:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            for k in range(len(scenes[0].imu_t)):
                for i, scene in enumerate(scenes):
                    if k >= len(scene.imu_t):
                        continue
                    t = scene.imu_t[k]
                    srv.track_gyroscope(i, t, *scene.gyro[k])
                    srv.track_accelerometer(i, t, *scene.accel[k])
                    while fis[i] < SERVE_FRAMES and scene.frame_t[fis[i]] <= t:
                        srv.track_camera(i, scene.frame_t[fis[i]], images[i][fis[i]])
                        fis[i] += 1
                srv.pump()
            srv.pump()
        finally:
            restore()
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if fis != [SERVE_FRAMES] * len(scenes):
        raise RuntimeError(f"serving fed {fis} frames, want {SERVE_FRAMES} each")
    return srv, tick_ms, kinds, syncs, seconds


def serving_phase(scene0, images0, solo0, cfg_kw):
    """`parallel.serving.MultiSequenceServer` with two engines on the
    first SERVE_FRAMES frames: engine 0 the planes-on stream of phase 6
    (held to phase 6's sequential run `solo0`), engine 1 the room stream of
    SERVE_SEED (held to its own solo run here), both bit for bit, under
    deterministic algorithms. The stream is served twice: timed with sync
    debug mode off, as the solo runs were, then with it on to count
    PyTorch's own synchronising calls per tick. Returns the phase's record:
    the served and solo host ms, the harvests of each tick and its host
    waits and synchronising calls by kind."""
    import torch

    scene1, images1 = facade_inputs(facade_config(**cfg_kw), duration=SERVE_SECONDS,
                                    seed=SERVE_SEED, n_frames=SERVE_FRAMES)
    scenes, images = (scene0, scene1), (images0, images1)
    torch.use_deterministic_algorithms(True)
    try:
        t0 = time.perf_counter()
        solo1 = run_facade(facade_config(**cfg_kw), scene1, images1, n_frames=SERVE_FRAMES)
        solo1_s = time.perf_counter() - t0
        srv, tick_ms, kinds, _, serve_s = serve(
            [facade_config(**cfg_kw) for _ in range(2)], scenes, images, count_syncs=False)
        srv_c, _, kinds_c, syncs, _ = serve(
            [facade_config(**cfg_kw) for _ in range(2)], scenes, images, count_syncs=True)
    finally:
        torch.use_deterministic_algorithms(False)
    t_last = scene0.frame_t[SERVE_FRAMES - 1]
    want0 = [p for p in solo0["traj"] if p[0] <= t_last]
    for (i, want), server in itertools.product(((0, want0), (1, solo1["traj"])), (srv, srv_c)):
        got = server.get_trajectory(i)
        same = len(got) == len(want) > 0 and all(
            t1 == t2 and np.array_equal(q1, q2) and np.array_equal(p1, p2)
            for (t1, q1, p1), (t2, q2, p2) in zip(got, want))
        if not same:
            raise RuntimeError(f"served engine {i} differs from its solo run ({len(got)} vs "
                               f"{len(want)} poses)")
    harvests = [h for _, h, _ in srv.ticks]
    tracked = max(len(srv.get_trajectory(i)) for i in range(2))
    if not (set(harvests) <= {1, 2} and sum(h == 2 for h in harvests) >= tracked - 1):
        raise RuntimeError(f"the fleet was not harvested once or twice per tick: {srv.ticks}")
    waits = check_waits(srv.ticks, kinds)
    hidden, sites = {}, {}
    for k, tick_sites in zip(kinds_c, syncs):
        hidden.setdefault(k, {}).setdefault(len(tick_sites), 0)
        hidden[k][len(tick_sites)] += 1
        for site in tick_sites:
            sites.setdefault(k, {}).setdefault(site, 0)
            sites[k][site] += 1
    both = [ms for n, ms in tick_ms if n == 2]
    solo_calls = [a[1] + b[1] for a, b in zip(solo0["calls"][:SERVE_FRAMES], solo1["calls"])]
    return dict(poses=[len(srv.get_trajectory(i)) for i in range(2)], ticks=len(srv.ticks),
                two=sum(h == 2 for h in harvests), waits=waits,
                hidden={k: dict(sorted(v.items())) for k, v in sorted(hidden.items())},
                sites={k: dict(sorted(v.items(), key=lambda kv: -kv[1])) for k, v
                       in sorted(sites.items())},
                tick_ms=statistics.median(both),
                solo_ms=statistics.median(solo_calls), serve_s=serve_s,
                solo_s=sum(m for _, m in solo0["calls"][:SERVE_FRAMES]) / 1e3
                + sum(m for _, m in solo1["calls"]) / 1e3, solo1_s=solo1_s,
                keyframes=[srv.vios[i].core.frontend.swt.n_keyframes
                           if srv.vios[i].core.frontend.swt else 0 for i in range(2)],
                reinits=[v.core.frontend.n_reinits for v in srv.vios])


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

    from torch.func import vmap

    from pvio_torch.core.kernels import DeviceKernels
    from pvio_torch.frontend import detect
    from pvio_torch.golden_run import state_ms
    from pvio_torch.io.config import Config
    from pvio_torch.ops import eigh as eigh_op
    from pvio_torch.ops import poisson, stencil
    from pvio_torch.utils import cuda_build

    t_start = time.perf_counter()
    marks = [("1", t_start)]                 # (phase, its start on the host clock)

    def phase(n):
        """Mark the start of phase n, logging the seconds of the one before."""
        now = time.perf_counter()
        log(f"[{marks[-1][0]}] phase {marks[-1][0]}: {now - marks[-1][1]:.1f} s")
        marks.append((str(n), now))

    dev = torch.device("cuda")
    smi = gpu_line()
    kind = torch.cuda.get_device_name(0)

    # 1. device and build ---------------------------------------------------
    log(f"[1] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")
    t0 = time.perf_counter()
    built = cuda_build.build_all()
    stencil.build()
    poisson.build()
    eigh_op.build()
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
    phase(2)
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
    # K1's float64 form: a float64 image is computed in float64 (fault F7)
    g64 = torch.Generator(device="cpu").manual_seed(649)
    flat64 = torch.rand(480 * 752 + 1, generator=g64, dtype=torch.float64).to(dev)
    k1_f64_cases = [("bench render", pyr0[0].double().contiguous())] + [
        (f"uniform {h}x{w_}", torch.rand(h, w_, generator=g64, dtype=torch.float64).to(dev))
        for h, w_ in [(480, 752), (481, 755), (3, 5)]] + [
        ("misaligned view 480x752", flat64[1:].view(480, 752))]
    stages, k1_f64_err = set(), 0.0
    for name, img in k1_f64_cases:
        plan = stencil.launch_plan(*img.shape, img.data_ptr(), itemsize=8)
        if stencil.kernel_plan(*img.shape, img.data_ptr(), itemsize=8) != plan:
            raise RuntimeError(f"K1 launcher and launch_plan disagree on {name} (float64)")
        stages.add("tma" if plan.tma else "threads")
        before = stencil.LAUNCHES
        out = stencil.shi_tomasi_response(img)
        torch.cuda.synchronize()
        if stencil.LAUNCHES != before + 1 or out.dtype != torch.float64:
            raise RuntimeError("K1 wrapper did not launch its float64 form once")
        ref = detect.shi_tomasi_response(img)
        err = float((out - ref).abs().max())
        lim = K1_F64_REL_TOL * float(ref.abs().max()) + K1_F64_ABS_TOL
        if not (err <= lim and torch.isfinite(out).all()):
            raise RuntimeError(f"K1 float64 disagrees with its plain version on {name}: "
                               f"{err} > {lim}")
        k1_f64_err = max(k1_f64_err, err)
        log(f"[2] K1 float64 {name} {tuple(img.shape)}: load stage "
            f"{'tma' if plan.tma else 'threads'}, max|kernel - plain| = {err:.3e} "
            f"(limit {lim:.3e})")
    if stages != {"tma", "threads"}:
        raise RuntimeError(f"K1's float64 cases took only the load stage(s) {stages}")
    img64 = k1_f64_cases[0][1]
    k1_f64_ms = device_ms(lambda: stencil.shi_tomasi_response(img64), kernel="shi_tomasi_kernel",
                          count=lambda: stencil.LAUNCHES)
    k1_f64_plain = device_ms(lambda: detect.shi_tomasi_response(img64))
    nbytes, nflops = stencil.cost(*img64.shape, itemsize=8)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nflops / FP64_FLOPS_PER_S * 1e3
    k1_f64_bound = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    log(f"[2] K1 float64 at {tuple(img64.shape)}: device {k1_f64_ms:.6f} ms/launch, plain "
        f"version {k1_f64_plain:.6f} ms, bound {k1_f64_bound[0]:.6f} ms ({k1_f64_bound[1]}: "
        f"{nbytes} B, {nflops} flop); max|kernel - plain| over its cases {k1_f64_err:.3e}")
    img0 = pyr0[0].contiguous()
    r_k, r_p = stencil.shi_tomasi_response(img0), detect.shi_tomasi_response(img0)
    xy_k, m_k = kern.detect(img0, torch.zeros(1, 2, device=dev), torch.zeros(1, dtype=torch.bool, device=dev), r_k)
    xy_p, m_p = kern.detect(img0, torch.zeros(1, 2, device=dev), torch.zeros(1, dtype=torch.bool, device=dev), r_p)
    dxy = float((xy_k - xy_p).abs().max())
    if not (torch.equal(m_k, m_p) and dxy <= 1e-3):
        raise RuntimeError(f"detections from K1 and plain responses differ (max {dxy} px)")
    log(f"[2] detections from K1 / plain responses: {int(m_k.sum())} identical keypoints "
        f"(max |dxy| {dxy:.2e} px)")
    k1_count = lambda: stencil.LAUNCHES  # noqa: E731
    k1_ms = device_ms(lambda: stencil.shi_tomasi_response(img0), kernel="shi_tomasi_kernel",
                      count=k1_count)
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
    # K1 at the TUM-VI geometry, 512x512, which phase 6's golden-shaped run
    # launches (held to its plain version there, on that run's first frame);
    # timed here, before the later phases' host work
    img512 = torch.rand(512, 512, generator=g).to(dev)
    k1_512_ms = device_ms(lambda: stencil.shi_tomasi_response(img512), kernel="shi_tomasi_kernel",
                          count=k1_count)
    k1_512_plain = device_ms(lambda: detect.shi_tomasi_response(img512))
    nbytes, nflops = stencil.cost(512, 512)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nflops / FP32_FLOPS_PER_S * 1e3
    k1_512_bound = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    log(f"[2] K1 at 512x512 (uniform noise): device {k1_512_ms:.6f} ms/launch, plain version "
        f"{k1_512_plain:.6f} ms, bound {k1_512_bound[0]:.6f} ms ({k1_512_bound[1]}: {nbytes} B, "
        f"{nflops} flop)")

    # K1's batched form: the level-0 images of MS_B bench frames, one launch
    # (a 3-D tensor map: each image's halo past its edge reads zeros)
    stack = torch.stack([kern.preprocess(host["images"][i])[0] for i in range(MS_B)]).contiguous()
    before = stencil.LAUNCHES
    resp_b = stencil.shi_tomasi_response(stack)
    torch.cuda.synchronize()
    if stencil.LAUNCHES != before + 1:
        raise RuntimeError("K1 did not launch once for the stack")
    k1b_err = 0.0
    for b in range(MS_B):
        if not torch.equal(resp_b[b], stencil.shi_tomasi_response(stack[b].contiguous())):
            raise RuntimeError(f"batched K1 differs from its single launch on image {b}")
        ref = detect.shi_tomasi_response(stack[b])
        err = float((resp_b[b] - ref).abs().max())
        if not err <= K1_REL_TOL * float(ref.abs().max()) + K1_ABS_TOL:
            raise RuntimeError(f"batched K1 disagrees with its plain version on image {b}: {err}")
        k1b_err = max(k1b_err, err)
    k1b_ms = device_ms(lambda: stencil.shi_tomasi_response(stack), kernel="shi_tomasi_kernel",
                       count=k1_count)
    k1b_plain_ms = device_ms(lambda: vmap(detect.shi_tomasi_response)(stack))
    k1b_call_ms = cuda_ms(lambda: stencil.shi_tomasi_response(stack))
    nbytes, nflops = stencil.cost(H, W, MS_B)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nflops / FP32_FLOPS_PER_S * 1e3
    k1b_bound, k1b_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    log(f"[2] K1 batched, {MS_B} x {H}x{W} in one launch: each image == its single launch bit for "
        f"bit, max|kernel - plain| {k1b_err:.3e}; device {k1b_ms:.6f} ms/launch (per call "
        f"{k1b_call_ms:.6f} ms), {MS_B} single launches {MS_B * k1_ms:.6f} ms; plain version "
        f"(vmapped) device {k1b_plain_ms:.6f} ms; bound {k1b_bound:.6f} ms ({k1b_by}: {nbytes} "
        f"B, {nflops} flop), {100 * k1b_bound / k1b_ms:.1f}% reached")

    # S1: the selection of the same frames' candidates, one image and the stack
    md = cfg.feature_tracker_min_keypoint_distance
    cands = [detect.candidates(stack[b], md, border=20, response=resp_b[b]) for b in range(MS_B)]
    cand_b = torch.stack([c for c, _ in cands]).contiguous()
    alive_b = torch.stack([a for _, a in cands]).contiguous()
    C = cand_b.shape[1]
    before = poisson.LAUNCHES
    sel1 = poisson.select_candidates(cand_b[0], alive_b[0], md)
    rounds1 = int(poisson.LAST_KERNEL_ROUNDS[0])
    plain1 = poisson.select_candidates_plain(cand_b[0], alive_b[0], md)
    sel_b = poisson.select_candidates(cand_b, alive_b, md)
    rounds_b = poisson.LAST_KERNEL_ROUNDS.tolist()
    if poisson.LAUNCHES != before + 2 or not torch.equal(sel1, plain1) \
            or rounds1 != poisson.LAST_ROUNDS:
        raise RuntimeError(f"S1 differs from its plain version on the bench frame (rounds "
                           f"{rounds1} vs {poisson.LAST_ROUNDS})")
    s1_diff = 0
    for b in range(MS_B):
        plain = poisson.select_candidates_plain(cand_b[b], alive_b[b], md)
        s1_diff += int((sel_b[b] != plain).sum()) + int(rounds_b[b] != poisson.LAST_ROUNDS)
        sel64 = poisson.select_candidates(cand_b[b].double(), alive_b[b], md)
        s1_diff += int((sel64 != poisson.select_candidates_plain(cand_b[b].double(), alive_b[b],
                                                                 md)).sum())
    if s1_diff:
        raise RuntimeError(f"S1 differs from its plain version in {s1_diff} entries")
    s1_count = lambda: poisson.LAUNCHES  # noqa: E731
    s1_ms = device_ms(lambda: poisson.select_candidates(cand_b[0], alive_b[0], md),
                      kernel="poisson_select_kernel", count=s1_count)
    s1b_ms = device_ms(lambda: poisson.select_candidates(cand_b, alive_b, md),
                       kernel="poisson_select_kernel", count=s1_count)
    s1_plain_ms = device_ms(lambda: poisson.select_candidates_plain(cand_b[0], alive_b[0], md),
                            reps=20)
    s1b_plain_ms = device_ms(lambda: [poisson.select_candidates_plain(c, a, md)
                                      for c, a in zip(cand_b, alive_b)], reps=5)
    n_alive = [int(n) for n in alive_b.sum(dim=1).tolist()]
    s1_bounds = {}
    for key, alive_n in (("one", n_alive[:1]), ("stack", n_alive)):
        nb, nops = poisson.cost(alive_n, C)
        tb, to = nb / HBM_BYTES_PER_S * 1e3, nops / FP32_FLOPS_PER_S * 1e3
        s1_bounds[key] = (tb, "bytes") if tb >= to else (to, "operations")
    log(f"[2] S1 on the bench frames' {C} candidates ({n_alive} alive, min_distance {md}): == the "
        f"plain rounds loop bit for bit at float32 and float64, rounds {rounds_b}; one image: "
        f"device {s1_ms:.6f} ms/launch, plain version {s1_plain_ms:.6f} ms device (+ a host "
        f"read per round), bound {s1_bounds['one'][0]:.6f} ms ({s1_bounds['one'][1]}); "
        f"{MS_B} images in one launch: device {s1b_ms:.6f} ms, plain {s1b_plain_ms:.6f} ms, "
        f"bound {s1_bounds['stack'][0]:.6f} ms ({s1_bounds['stack'][1]})")
    # S1 on its edge cases (tests/test_torch_cuda.py holds it to the same)
    n_cases = 0
    for dtype in (torch.float32, torch.float64):
        for name, cand, alive, md_ in selection_cases(dtype):
            sel = poisson.select_candidates(cand.to(dev), alive.to(dev), md_)
            rounds = int(poisson.LAST_KERNEL_ROUNDS[0])
            if not (torch.equal(sel.cpu(), poisson.select_candidates_plain(cand, alive, md_))
                    and rounds == poisson.LAST_ROUNDS):
                raise RuntimeError(f"S1 differs from its plain version on {name} ({dtype})")
            n_cases += 1
    log(f"[2] S1 == the plain rounds loop bit for bit, rounds included, on {n_cases} edge cases "
        f"(selection_cases at float32 and float64)")
    # E1: the eigen-decompositions of the triangulation (one 4x4 normal
    # matrix per track of the bench window) and the vmapped chain's stack
    # of them; the sweeps of every matrix equal to its CPU model's
    e1 = {}
    for key, A in eig_cases(kern, to_device(w, dev)).items():
        before = eigh_op.LAUNCHES
        L_k, V_k = eigh_op.eigh(A)
        sweeps = eigh_op.LAST_SWEEPS.tolist()
        if eigh_op.LAUNCHES != before + 1:
            raise RuntimeError(f"E1 did not launch once for {key}")
        if not L_k.dtype == V_k.dtype == A.dtype:
            raise RuntimeError(f"E1 returned {L_k.dtype} / {V_k.dtype} for {A.dtype} input")
        L_p, _ = torch.linalg.eigh(A)
        err, lim = eig_gap(A, L_k, V_k, L_p)
        if not err <= lim:
            raise RuntimeError(f"E1 disagrees with torch.linalg.eigh on {key}: {err} > {lim}")
        model = [eigh_op.jacobi_model(a)[2] for a in A.double().cpu().reshape(-1, 4, 4)]
        if sweeps != model:
            off = [(i, s_, m) for i, (s_, m) in enumerate(zip(sweeps, model)) if s_ != m]
            raise RuntimeError(f"E1's sweeps differ from its CPU model's on {len(off)} of "
                               f"{len(model)} matrices of {key} (index, kernel, model): {off[:10]}")
        # one kernel a call: E1's alone in the trace, once for each launch
        t = device_ms(lambda: eigh_op.eigh(A), kernel="sym_eig_kernel",
                      count=lambda: eigh_op.LAUNCHES, alone=True)
        t_plain = device_ms(lambda: torch.linalg.eigh(A), reps=20)
        # at the caller's dtype, which the kernel reads and writes; from the input
        nb, nops = eigh_op.cost(4, len(sweeps), itemsize=A.element_size())
        tb, to = nb / HBM_BYTES_PER_S * 1e3, nops / FP64_FLOPS_PER_S * 1e3
        e1[key] = dict(err=err, ms=t, plain_ms=t_plain,
                       bound=(tb, "bytes") if tb >= to else (to, "operations"))
        hist = dict(sorted(collections.Counter(sweeps).items()))
        log(f"[2] E1 {key} {tuple(A.shape)} {A.dtype}: max gap to torch.linalg.eigh {err:.3e} "
            f"(limit {lim:.3e}); sweeps {{sweeps: matrices}} {hist}, equal to the CPU model's on "
            f"all {len(model)}; device {t:.6f} ms a call in one kernel, "
            f"torch.linalg.eigh device {t_plain:.6f} ms (+ its "
            f"host read of the error codes), bound {e1[key]['bound'][0]:.6f} ms "
            f"({e1[key]['bound'][1]}: {nb} B at the input's {A.element_size()} B an entry, {nops} "
            f"flop), launch floor {floor_ms:.6f} ms")
    # E2: the marginalization's two eigen-decompositions on the bench
    # window (15x15, (F*15)-square), a vmapped chain's stack of priors and
    # a prior of 16 frame slots; the sweeps beside its CPU model's
    e2 = {}
    for key, A in marg_cases(kern, to_device(w, dev), host).items():
        n = A.shape[-1]
        before = eigh_op.BLOCK_LAUNCHES[n]
        L_k, V_k = eigh_op.eigh(A)
        sweeps = eigh_op.LAST_SWEEPS.reshape(-1).tolist()
        if eigh_op.BLOCK_LAUNCHES[n] != before + 1:
            raise RuntimeError(f"E2 did not launch once for {key}")
        L_p, _ = torch.linalg.eigh(A)
        err, lim = eig_gap(A, L_k, V_k, L_p)
        if not (err <= lim and max(sweeps) < eigh_op.MAX_SWEEPS):
            raise RuntimeError(f"E2 disagrees with torch.linalg.eigh on {key}: {err} > {lim}, "
                               f"or did not converge (sweeps {sweeps})")
        model = [eigh_op.jacobi_model(a)[2] for a in A.double().cpu().reshape(-1, n, n)]
        t = device_ms(lambda: eigh_op.eigh(A), reps=10, warmup=2,
                      kernel="small_kernel" if n <= eigh_op.WARP_N else "cluster_kernel",
                      count=lambda: eigh_op.BLOCK_LAUNCHES[n])
        t_plain = device_ms(lambda: torch.linalg.eigh(A), reps=10, warmup=2)
        nb, nops = eigh_op.cost(n, len(sweeps))  # in float64, from the input
        tb, to = nb / HBM_BYTES_PER_S * 1e3, nops / FP64_TC_FLOPS_PER_S * 1e3
        e2[key] = dict(err=err, ms=t, plain_ms=t_plain,
                       bound=(tb, "bytes") if tb >= to else (to, "operations"))
        log(f"[2] E2 {key} {tuple(A.shape)} {A.dtype}: max gap to torch.linalg.eigh {err:.3e} "
            f"(limit {lim:.3e}), sweeps {sweeps} (CPU model {model}); device {t:.6f} ms/launch, "
            f"torch.linalg.eigh device {t_plain:.6f} ms (+ its host read of the error codes), "
            f"bound {e2[key]['bound'][0]:.6f} ms ({e2[key]['bound'][1]}: {nb} B, {nops} flop)")
    torch.cuda.synchronize()

    # 3. the main path ---------------------------------------------------------
    phase(3)
    stencil.LAUNCHES = poisson.LAUNCHES = eigh_op.LAUNCHES = 0
    eigh_op.BLOCK_LAUNCHES.clear()
    rec = run_chain(kern, w, host, N_FRAMES)
    torch.cuda.synchronize()
    launches = {"shi_tomasi": stencil.LAUNCHES, "poisson_select": poisson.LAUNCHES,
                "sym_eig": eigh_op.LAUNCHES}
    n_prior = cfg.window_frame_capacity * 15
    e2_chain = dict(eigh_op.BLOCK_LAUNCHES)
    if rec["n_assoc"] < 50:
        raise RuntimeError(f"association matched {rec['n_assoc']} < 50 window tracks")
    if (launches["shi_tomasi"], launches["poisson_select"]) != (N_FRAMES + 1, N_FRAMES + 1):
        raise RuntimeError(f"K1 and S1 launched {launches} in {N_FRAMES + 1} frames (want one "
                           f"each per frame)")
    tracked = [int(s.sum()) for s in rec["status"]]
    if not all(np.isfinite(p).all() and np.isfinite(q).all() for p, q in zip(rec["p"], rec["q"])):
        raise RuntimeError("non-finite pose on the main path")
    if min(tracked) <= 0 or min(rec["alive"]) <= 0:
        raise RuntimeError(f"tracking died: tracked {tracked}, associated {rec['alive']}")
    fs_ms = statistics.median(rec["frame_ms"][1:])
    pnp_ms = statistics.median(rec["pnp_ms"][1:])
    log(f"[3] main path: {rec['n_assoc']} tracks associated, {N_FRAMES} frames, K1 launches "
        f"{launches['shi_tomasi']}, S1 launches {launches['poisson_select']}, E1 launches "
        f"{launches['sym_eig']}, tracked slots {tracked}, associated alive {rec['alive']}")
    if launches["sym_eig"] < N_FRAMES:
        raise RuntimeError(f"E1 launched {launches['sym_eig']} times in {N_FRAMES} motion steps")
    n_kf = N_FRAMES // KF_EVERY
    if e2_chain != {15: n_kf, n_prior: n_kf}:
        raise RuntimeError(f"E2 launched {e2_chain} times (by n) in {n_kf} marginalizations "
                           f"(want one 15x15 and one {n_prior}x{n_prior} each)")
    log(f"[3] E2 launches by n {e2_chain} in {n_kf} marginalizations")
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
    phase(4)
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
    # host waits of the chained keyframe on device inputs (the IMU grids and
    # masks uploaded first, as the pipelined loop uploads them): PyTorch's
    # synchronising calls, named by sync debug mode (the marginalization's
    # two eigh waits were F2; E2 reads nothing back)
    dev_args = [torch.as_tensor(a, device=dev) for a in (*args, tri_mask_host, life)]
    torch.cuda.synchronize()

    def chained_kf():
        kern.kf_step_chained(wk, *dev_args[:-2], tri_depth, tri_ok, *dev_args[-2:], slot, False,
                             True)

    kf_waits = host_waits(chained_kf)
    # the witness: the same call with torch.linalg.eigh in E2's place
    real_eigh = eigh_op.eigh
    eigh_op.eigh = lambda A: torch.linalg.eigh(A) if A.shape[-1] != eigh_op.N else real_eigh(A)
    try:
        eigh_waits = host_waits(chained_kf)
    finally:
        eigh_op.eigh = real_eigh
    log(f"[4] kf_step_chained (do_marg) host waits under sync debug mode: {len(kf_waits)} "
        f"{kf_waits}; with torch.linalg.eigh in E2's place (fault F2): {len(eigh_waits)} "
        f"{eigh_waits}")
    if kf_waits:
        raise RuntimeError(f"kf_step_chained waited on the host: {kf_waits}")
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
    phase(5)
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
    phase(6)
    t0 = time.perf_counter()
    scene, images = facade_inputs(facade_config(), n_frames=max(
        FACADE_FAST_FRAMES, FACADE_PLANES_FRAMES, FACADE_CPU_FRAMES, SERVE_FRAMES))
    log(f"[6] rendered {len(images)} frames {images[0].shape} uint8 in "
        f"{time.perf_counter() - t0:.1f} s")
    # Config()'s detect-skip (feature_tracker_detect_min_free 8) caps the
    # pipelined loop at depth 1, as the reference's run.py --fast runs it;
    # detection on every frame (min_free 0) lets it keep two frames in flight
    fast = dict(fused_keyframe=True, chained_keyframe=True, pipelined_host=True,
                pipeline_depth=2)
    pairs = (("Config() detect-skip", {}, FACADE_FAST_FRAMES),
             ("detection on every frame", dict(feature_tracker_detect_min_free=0),
              FACADE_FAST_FRAMES),
             ("planes on, Config() detect-skip", dict(enable_plane_constraint=True),
              FACADE_PLANES_FRAMES))
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
                    f"{k} {v[0]:.3f} ({v[1]} calls)" for k, v in state_ms(rec["calls"]).items())
                    + f"; S1 launches {rec['s1_launches']}, E1 launches {rec['e1_launches']}, "
                    f"E2 launches by n {rec['e2_launches']}")
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
        a, b = state_ms(seq["calls"]), state_ms(pipe["calls"])
        log(f"[6] {seq['what']} == pipelined (depth {pipe['depth']}) + chained: all "
            f"{len(seq['traj'])} poses identical bit for bit; median ms sequential / pipelined: "
            + ", ".join(f"{k} {a[k][0]:.3f} / {b[k][0]:.3f}" for k in ("tracking", "keyframe")
                        if k in a and k in b))
    seq = recs[0]
    launches["shi_tomasi"] = recs[4]["launches"]
    launches["poisson_select"] = recs[4]["s1_launches"]
    launches["sym_eig"] = recs[4]["e1_launches"]
    launches["sym_eig_block_15"] = recs[4]["e2_launches"].get(15, 0)
    launches[f"sym_eig_block_{n_prior}"] = recs[4]["e2_launches"].get(n_prior, 0)
    if not launches["sym_eig_block_15"] == launches[f"sym_eig_block_{n_prior}"] > 0:
        raise RuntimeError(f"E2 launched {recs[4]['e2_launches']} times (by n) in the planes-on "
                           "facade run (want one 15x15 and one prior per marginalization)")

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
        if dt == "float64":
            # every K1 launch of the float64 engine is the float64 form's
            launches["shi_tomasi_f64"] = card["k1_f64_launches"]
            log(f"[6]   K1's float64 form: {card['k1_f64_launches']} launches of the card run's "
                f"{card['launches']} K1 launches in {card['n_frames']} frames")
            if not 0 < card["k1_f64_launches"] == card["launches"]:
                raise RuntimeError(f"the float64 card run launched K1's float64 form "
                                   f"{card['k1_f64_launches']} times of {card['launches']}")

    # the CLI on the card, in a process of its own: sequential, then --fast
    for fast in (False, True):
        t0 = time.perf_counter()
        cli = run_cli(fast)
        mode = "--fast --view3d" if fast else "(sequential)"
        log(f"[6] CLI `python -m pvio_torch.run synthetic {mode}` on the card: "
            f"{time.perf_counter() - t0:.1f} s, rc 0, {cli['lines']} TUM lines for {cli['written']} "
            f"poses written, initialized at frame {cli['init_fi']}, ATE {cli['ate_cm']} cm as it "
            f"prints it, over {cli['ate_poses']} poses (bound {CLI_MAX_ATE_M} m), {cli['planes']} "
            f"plane slots at the end" + (f", 3D viewer page {cli['view3d_bytes']} bytes"
                                         if fast else ""))

    # the golden harness's pieces on the TUM-VI geometry
    gr, img512_run = golden_phase()
    log(f"[6] golden-shaped run (pvio_torch.golden_run, config/tum-vi.yaml, float32, {gr['size']} "
        f"equidistant, {gr['n_frames']} frames rendered in {gr['render_s']:.1f} s): "
        f"{gr['seconds']:.1f} s, initialized at frame {gr['init_fi']}, re-inits {gr['n_reinits']}, "
        f"{gr['poses']} poses, ATE {gr['ate']:.6f} m (bound {FACADE_MAX_ATE_M} m), scale "
        f"{gr['scale']:.6f}, {gr['planes']} planes; K1 launches {gr['launches']}, S1 "
        f"{gr['s1_launches']}, E1 {gr['e1_launches']}, E2 by n {gr['e2_launches']}")
    log("[6]   median ms per track_camera call: " + ", ".join(
        f"{k} {v[0]:.3f} ({v[1]} calls)" for k, v in state_ms(gr["calls"]).items()))
    launches["shi_tomasi_512"] = gr["launches"]
    out = stencil.shi_tomasi_response(img512_run)
    ref = detect.shi_tomasi_response(img512_run)
    k1_512_err = float((out - ref).abs().max())
    lim = K1_REL_TOL * float(ref.abs().max()) + K1_ABS_TOL
    if not (k1_512_err <= lim and torch.isfinite(out).all()):
        raise RuntimeError(f"K1 disagrees with its plain version at 512x512: {k1_512_err} > {lim}")
    log(f"[6]   K1 at {tuple(img512_run.shape)} on its first frame: max|kernel - plain| "
        f"{k1_512_err:.3e} (limit {lim:.3e}), load stage "
        f"{'tma' if stencil.launch_plan(*img512_run.shape, img512_run.data_ptr()).tma else 'threads'}")

    # 7. many sequences: the vmapped chain -----------------------------------------
    phase(7)
    t0 = time.perf_counter()
    ms = multi_seq_phase(cfg)
    launches.update(ms["launches"])
    log(f"[7] multi-seq chain, {MS_B} sequences x {ms['frames']} frames ({MS_GROUPS} groups of "
        f"{MS_KF_EVERY}, planes on, {H}x{W} float32; inputs built in {ms['build_s']:.1f} s): "
        f"one vmapped chain launched K1 {ms['launches']['shi_tomasi_batched']} and S1 "
        f"{ms['launches']['poisson_select_batched']} times for {ms['frames']} frames, E1 "
        f"{ms['launches']['sym_eig_batched']} times for its {ms['frames'] - 1} motion steps, E2 "
        f"{ms['launches']['sym_eig_block_batched']} times at each size for its {MS_GROUPS} "
        f"marginalizations; final "
        f"costs {[round(float(c[-1]), 3) for c in ms['costs']]}")
    for i, rel, dp in ms["gaps"]:
        log(f"[7]   sequence {i} batched vs unbatched on the card: final costs max rel "
            f"{rel:.3e} (bound {MAX_MS_COST_REL}), positions max |dp| {dp:.3e} m (bound "
            f"{MAX_MS_DP_M} m)")
    log(f"[7]   ms per group (host clock, device-synchronised, inputs uploaded in the call): " +
        ", ".join(f"B={B} batched {ms['ms'][B] / MS_GROUPS:.1f} vs {B} unbatched "
                  f"{B * ms['single_ms'] / MS_GROUPS:.1f}" for B in (1, 4, MS_B))
        + f" (unbatched: {len(MS_CHECK)} chains measured, {ms['single_ms'] / MS_GROUPS:.1f} "
          f"ms per group each); phase {time.perf_counter() - t0:.1f} s")

    # 8. many sequences: the served fleet -------------------------------------------
    phase(8)
    t0 = time.perf_counter()
    sv = serving_phase(scene, images, recs[4],
                       dict(enable_plane_constraint=True, fused_keyframe=True))
    log(f"[8] serving, 2 PVIO engines (planes on; engine 0 = phase 6's stream, engine 1 seed "
        f"{SERVE_SEED}), {SERVE_FRAMES} frames each: {sv['poses']} poses, each engine == its "
        f"solo sequential run bit for bit; keyframes {sv['keyframes']}, re-inits "
        f"{sv['reinits']}; {sv['ticks']} ticks, {sv['two']} with two fleet harvests (frontend + "
        f"motion step) and the rest one; host waits per tick (transfer.WAITS) by kind of tick, "
        f"{{waits: ticks}}: {sv['waits']}; PyTorch's own synchronising calls per tick (sync "
        f"debug mode \"warn\", on for a second served run), {{calls: ticks}}: {sv['hidden']}; median "
        f"ms per tick with both engines "
        f"{sv['tick_ms']:.3f} vs the two solo calls {sv['solo_ms']:.3f}; whole stream "
        f"{sv['serve_s']:.1f} s served vs {sv['solo_s']:.1f} s in the solo runs' calls; phase "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"[8]   their sites by kind of tick, {{file:line: calls}}: {sv['sites']}")
    f3 = [(kind, site, calls) for kind, sites in sv["sites"].items() if kind != "init"
          for site, calls in sites.items() if site.startswith("ransac.py:")]
    if f3:
        raise RuntimeError(f"find_plane still synchronises in served ticks (fault F3): {f3}")

    # 9. the sharded BA on the card --------------------------------------------------
    phase(9)
    t0 = time.perf_counter()
    sh = sharded_phase()
    log(f"[9] sharded BA, a world of one over NCCL (tp = dp = 1), BASELINE config 5's window "
        f"(16 keyframes x {sh['tracks']} tracks, 2 LM iterations, planes off) x {SHARD_B}: "
        f"float64 max |dp| vs ba.solve {sh['dp_m']:.3e} m (bound {MAX_SHARD_DP_M} m), costs "
        f"{sh['costs']}; float32 (not held) max |dp| vs the float64 sharded solve "
        f"{sh['dp32_vs64_m']:.3e} m, vs float32 ba.solve {sh['dp32_vs_solve32_m']:.3e} m, costs "
        f"finite {sh['costs32_finite']}")
    log(f"[9]   ms per call (CUDA events, median of {SHARD_REPS}): sharded solve of the "
        f"{SHARD_B} windows {sh['sharded_ms']:.3f} (float32 {sh['sharded32_ms']:.3f}) vs "
        f"ba.solve of each in turn {sh['solve_ms']:.3f}; a warm sharded solve's synchronising "
        f"calls (sync debug mode \"warn\") {sh['sync_sites']}, and one under \"error\" raised "
        f"nothing; a CUDA window's checkpoint round trip: {sh['checkpoint_leaves']} leaves "
        f"equal; phase {time.perf_counter() - t0:.1f} s")

    # 10. summary ----------------------------------------------------------------
    phase(10)
    def entry(name, route, source, replaces, n, err, t, plain, bound, library=None):
        return dict(name=name, route=route, source=source, replaces=replaces, launches=n,
                    max_abs_err=err, ms=t, plain_ms=plain, bound_ms=bound[0],
                    bound_by=bound[1], library_ms=library)

    k1_src, s1_src = "pvio_torch/csrc/shi_tomasi.cu", "pvio_torch/csrc/poisson_select.cu"
    e1_batched = next(key for key in e1 if key != "4x4")
    kernels = [
        entry("shi_tomasi", "cuda", k1_src, "pvio_tpu/ops/stencil.py:28", launches["shi_tomasi"],
              k1_err_main, k1_ms, plain_ms, (bound_ms, bound_by)),
        entry("shi_tomasi_f64", "cuda", k1_src, "pvio_tpu/ops/stencil.py:28",
              launches["shi_tomasi_f64"], k1_f64_err, k1_f64_ms, k1_f64_plain, k1_f64_bound),
        entry("shi_tomasi_512", "cuda", k1_src, "pvio_tpu/ops/stencil.py:28",
              launches["shi_tomasi_512"], k1_512_err, k1_512_ms, k1_512_plain, k1_512_bound),
        entry("shi_tomasi_batched", "cuda", k1_src, "pvio_tpu/ops/stencil.py:28",
              launches["shi_tomasi_batched"], k1b_err, k1b_ms, k1b_plain_ms,
              (k1b_bound, k1b_by)),
        entry("poisson_select", "cuda", s1_src, "none (port-only; XLA array code at "
              "pvio_tpu/frontend/detect.py:131)", launches["poisson_select"], 0.0, s1_ms,
              s1_plain_ms, s1_bounds["one"]),
        entry("poisson_select_batched", "cuda", s1_src, "none (port-only; XLA array code at "
              "pvio_tpu/frontend/detect.py:131)", launches["poisson_select_batched"], 0.0,
              s1b_ms, s1b_plain_ms, s1_bounds["stack"]),
        entry("sym_eig", "cuda", "pvio_torch/csrc/sym_eig.cu", "none (port-only; jnp.linalg.eigh "
              "at pvio_tpu/geometry/triangulation.py:36)", launches["sym_eig"],
              e1["4x4"]["err"], e1["4x4"]["ms"], e1["4x4"]["plain_ms"], e1["4x4"]["bound"],
              library=e1["4x4"]["plain_ms"]),    # torch.linalg.eigh: plain and library call
        entry("sym_eig_batched", "cuda", "pvio_torch/csrc/sym_eig.cu", "none (port-only; "
              "jnp.linalg.eigh at pvio_tpu/geometry/triangulation.py:36)",
              launches["sym_eig_batched"], e1[e1_batched]["err"], e1[e1_batched]["ms"],
              e1[e1_batched]["plain_ms"], e1[e1_batched]["bound"],
              library=e1[e1_batched]["plain_ms"]),
    ]
    e2_src = "pvio_torch/csrc/sym_eig_block.cu"
    e2_replaces = ("none (port-only; jnp.linalg.eigh at pvio_tpu/estimation/marginalization.py:41 "
                   "and :209)")
    for name, key, n in (("sym_eig_block_15", "15x15", launches["sym_eig_block_15"]),
                         (f"sym_eig_block_{n_prior}", f"{n_prior}x{n_prior}",
                          launches[f"sym_eig_block_{n_prior}"]),
                         ("sym_eig_block_batched", f"{MS_B}x{n_prior}x{n_prior}",
                          launches["sym_eig_block_batched"])):
        kernels.append(entry(name, "cuda", e2_src, e2_replaces, n, e2[key]["err"], e2[key]["ms"],
                             e2[key]["plain_ms"], e2[key]["bound"],
                             library=e2[key]["plain_ms"]))   # torch.linalg.eigh, as for E1
    end = time.perf_counter()
    phase_s = {n: t1 - t0 for (n, t0), (_, t1) in zip(marks, marks[1:] + [(None, end)])}
    phase_s["total"] = end - t_start
    log(f"[10] phase 10: {phase_s['10']:.1f} s; total {phase_s['total']:.1f} s")
    print(json.dumps({"phase_seconds": phase_s}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

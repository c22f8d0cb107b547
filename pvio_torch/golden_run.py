"""Golden-run harness of the port: rendered textured-room imagery (with
real lens distortion) -> io/undistort -> the full PVIO pipeline -> ATE
against ground truth.

    python -m pvio_torch.golden_run config/euroc.yaml [--duration 12] \\
        [--cpu] [--dtype float64] [--no-planes] [--seed 648]

Matches `scripts/golden_run.py`: the same flags and defaults, the same
changes to the YAML's `Config` (the 512x512 image for `tum` configs), the
same scene and imagery and the same printed lines (total time, poses,
initialization and re-inits; ATE, scale, planes and map points; the
quarters' ATE; the blackout gauges), and last the initialization frame
and the median ms per `track_camera` call by state. The engine runs on the
card; `--cpu` runs it on the CPU, and without a card and without `--cpu`
the run stops before it renders. Frames are rendered in a pool of worker
processes; the pixel noise is drawn in frame order in this process, so the
images equal the reference script's cached ones. `--cache-images` keeps
them in an `.npz`.

Its pieces are functions the tests call: `build_config`, `make_scene`,
`render_images` (the pool, then `finish_frame`: noise, rounding and
undistortion), `frames_key` (what the frames depend on, to cache them
by), `image_source` (the blackout), `drive` and `readout`.
"""

import argparse
import os
import statistics
import sys
import time

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("--duration", type=float, default=12.0)
    ap.add_argument("--fps", type=float, default=20.0)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--dtype", default="float64")
    ap.add_argument("--no-planes", action="store_true")
    ap.add_argument("--supplement", action="store_true",
                    help="keep member reprojection factors alongside the "
                         "plane factor (Config.plane_supplement)")
    ap.add_argument("--seed", type=int, default=648)
    ap.add_argument("--traj-scale", type=float, default=1.0,
                    help="spatial sweep scale; <= 0.6 keeps the init "
                         "baseline under the reference scale gate")
    ap.add_argument("--init-ramp", type=float, default=0.0,
                    help="smooth spatial-sweep ramp floor (>0 keeps the "
                         "init baseline under the production scale gate "
                         "without shrinking the rest of the trajectory)")
    ap.add_argument("--long-profile", action="store_true",
                    help="60+ s profile: drifting loops + aggressive "
                         "yaw/pitch burst at t=25-35 s")
    ap.add_argument("--blackout", nargs=2, type=float, default=None,
                    metavar=("T0", "T1"),
                    help="feed black frames for t in [T0, T1) (forces "
                         "tracking loss + re-init mid-run)")
    ap.add_argument("--cache-images", default=None,
                    help=".npz path: render once, reuse across runs "
                         "(uint8, post-undistortion, pre-blackout)")
    ap.add_argument("--max-scale", type=float, default=5.0,
                    help="initializer_max_scale override (1.0 = the "
                         "reference production gate, initializer.cpp:216)")
    ap.add_argument("--imu-noise", type=float, default=0.0,
                    help="gyro/accel noise scale (0 = ideal IMU)")
    ap.add_argument("--cauchy", type=float, default=None,
                    help="override Config.cauchy_scale")
    ap.add_argument("--fb", type=float, default=None,
                    help="override forward-backward KLT gate (px, 0=off)")
    ap.add_argument("--pixel-noise", type=float, default=0.0,
                    help="additive Gaussian image noise sigma in 8-bit counts "
                         "(hard mode: degrades KLT so structural priors matter)")
    ap.add_argument("--max-kp", type=int, default=None,
                    help="override keypoint detection budget (hard mode)")
    ap.add_argument("--noise-after", type=float, default=0.0,
                    help="apply --pixel-noise only after this time (s): "
                         "clean initialization, then degraded tracking")
    ap.add_argument("--escape-dist", type=float, default=None,
                    help="override plane_escape_distance (m): the 0.1 m "
                         "reference gate is too coarse to shed mm-regime "
                         "bad adoptions")
    ap.add_argument("--kp-sigma", type=float, default=None,
                    help="declared keypoint noise sigma in px (reference "
                         "camera.noise config) — raise for noisy imagery")
    ap.add_argument("--texture-seed", type=int, default=7,
                    help="room texture seed — the engine's RANSAC seeds are "
                         "fixed (seed 648, config.cpp:91-93), so run-to-run "
                         "variation must come from the imagery itself")
    ap.add_argument("--save-frames", default=None,
                    help="directory to dump a few rendered+undistorted PNGs")
    return ap.parse_args(argv)


def build_config(args):
    """The YAML's Config with the flags applied, as the reference script
    applies them."""
    from pvio_torch.io.config import Config

    cfg = Config.from_yaml(args.config)
    cfg.dtype = args.dtype
    cfg.initializer_max_scale = args.max_scale
    if "tum" in args.config:
        cfg.image_size = (512, 512)
    if args.no_planes:
        cfg.enable_plane_constraint = False
    if args.supplement:
        cfg.plane_supplement = True
    if args.cauchy is not None:
        cfg.cauchy_scale = args.cauchy
    if args.fb is not None:
        cfg.feature_tracker_fb_threshold = args.fb
    if args.max_kp is not None:
        cfg.feature_tracker_max_keypoint_detection = args.max_kp
    if args.kp_sigma is not None:
        cfg.camera_noise_cov = np.eye(2) * args.kp_sigma ** 2
    if args.escape_dist is not None:
        cfg.plane_escape_distance = args.escape_dist
    return cfg


def make_scene(args):
    from pvio_torch.io import synthetic

    return synthetic.make_scene(
        duration=args.duration, fps=args.fps, imu_rate=200.0,
        n_points=8, seed=args.seed, traj_scale=args.traj_scale,
        init_ramp=args.init_ramp, long_profile=args.long_profile,
        gyro_noise=1e-3 * args.imu_noise, accel_noise=1e-2 * args.imu_noise,
    )


def _render(job):
    """One frame rendered through the lens model, in 8-bit counts (float)."""
    from pvio_torch.io import synthetic

    scene, fi, K, size, q_bc, p_bc, distortion, model, texture_seed = job
    img = synthetic.render_frame_room(scene, fi, K, size, q_bc=q_bc, p_bc=p_bc,
                                      distortion=distortion, distortion_model=model,
                                      seed=texture_seed)
    return img * 255.0


def finish_frame(u8f, t, args, noise_rng, und):
    """Pixel noise (drawn from `noise_rng` when the frame is noisy), 8-bit
    rounding and undistortion: the reference script's `render_image` after
    the render. Call it in frame order: the noise is one stream."""
    if args.pixel_noise > 0 and t >= args.noise_after:
        u8f = u8f + noise_rng.normal(size=u8f.shape) * args.pixel_noise
    u8 = np.clip(u8f + 0.5, 0, 255).astype(np.uint8)
    return np.asarray(und.apply(u8))


def render_images(scene, cfg, args, frames=None, workers=None):
    """The frames (all, or the given indices), rendered in a pool of
    `workers` spawned processes (one per CPU by default), then noised in
    frame order and undistorted here: uint8, pre-blackout. The noise stream
    starts at the first frame given, as the reference's starts at frame 0."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from pvio_torch.io.undistort import ImageUndistorter

    frames = list(range(len(scene.frame_t))) if frames is None else list(frames)
    workers = max(1, min(len(frames), workers or os.cpu_count() or 1))
    jobs = [(scene, fi, cfg.K, cfg.image_size, np.asarray(cfg.q_bc), np.asarray(cfg.p_bc),
             cfg.camera_distortion, cfg.camera_distortion_model, args.texture_seed)
            for fi in frames]
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        counts = list(ex.map(_render, jobs))
    und = ImageUndistorter(cfg.K, cfg.camera_distortion, cfg.camera_distortion_model,
                           cfg.image_size)
    noise_rng = np.random.default_rng(args.seed + 1)
    return [finish_frame(c, scene.frame_t[fi], args, noise_rng, und)
            for fi, c in zip(frames, counts)]


def frames_key(args, scene):
    """A key for the rendered frames of a run (`render_images`): a hash of
    the scene's poses, the camera (intrinsics, extrinsics, distortion and
    image size) and every flag that shapes the frames (the pixel noise and
    its start, the texture seed, the noise stream's seed, the fps). Runs
    that differ only in how they are solved (dtype, planes, gates) share a
    key; the blackout is applied after the cache and is left out."""
    import hashlib

    cfg = build_config(args)
    h = hashlib.sha256()
    for a in (scene.p_wb, scene.q_wb, scene.frame_t, cfg.K, cfg.camera_distortion,
              cfg.q_bc, cfg.p_bc):
        h.update(np.ascontiguousarray(np.asarray(a, np.float64)).tobytes())
    h.update(repr((tuple(cfg.image_size), cfg.camera_distortion_model,
                   float(args.pixel_noise), float(args.noise_after), args.texture_seed,
                   args.seed, float(args.fps))).encode())
    return h.hexdigest()[:16]


def load_or_render(scene, cfg, args):
    """The undistorted frames: from --cache-images when it exists (and
    written there when it does not), else rendered."""
    if args.cache_images and os.path.exists(args.cache_images):
        cached = np.load(args.cache_images)["images"]
        assert len(cached) == len(scene.frame_t), (
            f"cache has {len(cached)} frames, scene {len(scene.frame_t)} — "
            "delete the stale cache")
        print(f"loaded {len(cached)} cached frames from {args.cache_images}",
              file=sys.stderr)
        return list(cached)
    t0 = time.perf_counter()
    images = render_images(scene, cfg, args)
    if args.cache_images:
        np.savez_compressed(args.cache_images, images=np.stack(images))
        print(f"rendered+cached {len(images)} frames in "
              f"{time.perf_counter() - t0:.0f}s -> {args.cache_images}",
              file=sys.stderr)
    return images


def blacked_out(args, t):
    return args.blackout is not None and args.blackout[0] <= t < args.blackout[1]


def image_source(images, scene, cfg, args):
    """`image_of(fi)`: the frame's image, black for t in --blackout."""
    H, W = cfg.image_size[1], cfg.image_size[0]

    def image_of(fi):
        if blacked_out(args, scene.frame_t[fi]):
            return np.zeros((H, W), np.uint8)
        return images[fi]
    return image_of


def drive(vio, scene, image_of, on_frame=None, progress=False, n_frames=None, kf_calls=None):
    """Feed the scene to `vio`: every IMU sample, and each of the first
    `n_frames` frames (all by default; `image_of(fi)`) once its time has
    come. Calls `on_frame(fi)` after each frame, and counts the keyframe
    steps into `kf_calls[0]` (a one-element list) as they run. Returns the
    run's record: render and pipeline seconds, the initialization frame,
    the frames fed, the keyframe steps, and the host ms of every
    `track_camera` call with its state (before / initializing / tracking /
    keyframe: a keyframe step ran in the call)."""
    kern = vio.core.kernels
    kf_calls = [0] if kf_calls is None else kf_calls
    inside = [False]
    real = {name: getattr(kern, name) for name in ("kf_step", "kf_step_chained", "ba_step")}
    for name, fn in real.items():
        def counted(*a, _fn=fn, **k):
            if inside[0]:                  # kf_step runs ba_step: count the outer call
                return _fn(*a, **k)
            kf_calls[0] += 1
            inside[0] = True
            try:
                return _fn(*a, **k)
            finally:
                inside[0] = False
        setattr(kern, name, counted)
    n_frames = len(scene.frame_t) if n_frames is None else n_frames
    fi, calls, init_fi = 0, [], None
    t_render = t_pipe = 0.0
    try:
        for k in range(len(scene.imu_t)):
            t = scene.imu_t[k]
            vio.track_gyroscope(t, *scene.gyro[k])
            vio.track_accelerometer(t, *scene.accel[k])
            while fi < n_frames and scene.frame_t[fi] <= t:
                t0 = time.perf_counter()
                img = image_of(fi)
                t1 = time.perf_counter()
                was_init, kf0 = vio.initialized, kf_calls[0]
                vio.track_camera(scene.frame_t[fi], img)
                t2 = time.perf_counter()
                t_render += t1 - t0
                t_pipe += t2 - t1
                if not was_init:
                    state = "initializing" if vio.initialized else "before"
                else:
                    state = "keyframe" if kf_calls[0] > kf0 else "tracking"
                calls.append((state, 1e3 * (t2 - t1)))
                if init_fi is None and vio.initialized:
                    init_fi = fi
                if on_frame is not None:
                    on_frame(fi)
                fi += 1
                if progress and fi % 20 == 0:
                    print(f"  frame {fi}/{n_frames} init={vio.initialized} "
                          f"reinits={vio.core.frontend.n_reinits} "
                          f"render {t_render / fi * 1e3:.0f}ms/f "
                          f"pipe {t_pipe / fi * 1e3:.0f}ms/f", file=sys.stderr)
    finally:
        for name, fn in real.items():
            setattr(kern, name, fn)
    return dict(t_render=t_render, t_pipe=t_pipe, init_fi=init_fi, calls=calls,
                n_frames=fi, kf_steps=kf_calls[0])


def state_ms(calls):
    """Median host ms of track_camera per state, with the call counts."""
    out = {}
    for state in ("before", "initializing", "tracking", "keyframe"):
        ms = [m for s, m in calls if s == state]
        if ms:
            out[state] = (statistics.median(ms), len(ms))
    return out


def readout(traj, scene, blackout=None):
    """The reference script's gauges of a trajectory [(t, q, p)], in
    float64: ATE after an SE(3) alignment, the similarity's scale, the
    poses compared, the ATE of each quarter (aligned on its own; None for
    a quarter under 5 poses) and, with a blackout (T0, T1), the pre-
    blackout and post-recovery segments' (ATE, scale, poses), None when a
    segment has under 10 poses."""
    import torch

    from pvio_torch.geometry import wahba

    t2idx = {round(tt, 6): i for i, tt in enumerate(scene.frame_t)}
    kept = [(tt, p) for (tt, q, p) in traj if t2idx.get(round(tt, 6)) is not None]
    est = torch.as_tensor(np.array([p for _, p in kept]), dtype=torch.float64)
    gt = torch.as_tensor(np.array([scene.p_wb[t2idx[round(tt, 6)]] for tt, _ in kept]),
                         dtype=torch.float64)
    s, _, _ = wahba.find_srt(est, gt)
    out = dict(ate=float(wahba.ate_rmse(est, gt, with_scale=False)), scale=float(s),
               poses=len(kept), quarters=[])
    nq = len(kept) // 4
    for k in range(4):
        seg = slice(k * nq, (k + 1) * nq if k < 3 else len(kept))
        n = seg.stop - seg.start
        out["quarters"].append(
            (float(wahba.ate_rmse(est[seg], gt[seg], with_scale=False)), n) if n >= 5 else None)
    if blackout is not None:
        ts = np.array([tt for tt, _ in kept])
        for name, m in (("pre-blackout", ts < blackout[0]), ("post-recovery", ts >= blackout[1])):
            idx = torch.as_tensor(np.nonzero(m)[0])
            if m.sum() < 10:
                out[name] = (None, None, int(m.sum()))
                continue
            s_seg, _, _ = wahba.find_srt(est[idx], gt[idx])
            out[name] = (float(wahba.ate_rmse(est[idx], gt[idx], with_scale=False)),
                         float(s_seg), int(m.sum()))
    return out


def main(argv=None):
    args = parse_args(argv)
    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("golden_run: no CUDA card; pass --cpu to run on the CPU", file=sys.stderr)
        return 2
    from pvio_torch import PVIO

    cfg = build_config(args)
    scene = make_scene(args)
    images = load_or_render(scene, cfg, args) if args.cache_images else None

    if args.save_frames:
        from pvio_torch.io import synthetic

        os.makedirs(args.save_frames, exist_ok=True)
        firsts = images[:2] if images is not None else render_images(scene, cfg, args, [0, 1])
        for fi in [0, 1]:
            raw = synthetic.render_frame_room(
                scene, fi, cfg.K, cfg.image_size, q_bc=np.asarray(cfg.q_bc),
                p_bc=np.asarray(cfg.p_bc), distortion=cfg.camera_distortion,
                distortion_model=cfg.camera_distortion_model)
            try:
                import matplotlib
                matplotlib.use("Agg")
                import matplotlib.pyplot as plt
                plt.imsave(f"{args.save_frames}/raw_{fi}.png", raw, cmap="gray")
                plt.imsave(f"{args.save_frames}/und_{fi}.png",
                           image_source(firsts, scene, cfg, args)(fi), cmap="gray")
            except Exception as e:
                print("save failed:", e)

    if images is None:
        images = render_images(scene, cfg, args)
    vio = PVIO(cfg, device="cpu" if args.cpu else None)
    t_start = time.perf_counter()
    rec = drive(vio, scene, image_source(images, scene, cfg, args), progress=True)
    traj = vio.get_trajectory()
    print(f"total {time.perf_counter() - t_start:.1f}s "
          f"(render {rec['t_render']:.1f}s, pipeline {rec['t_pipe']:.1f}s), "
          f"{len(traj)} poses, init={vio.initialized}, "
          f"reinits={vio.core.frontend.n_reinits}")
    if not traj:
        print("NO TRAJECTORY")
        return 1
    r = readout(traj, scene, args.blackout)
    print(f"ATE {r['ate']:.4f} m over {r['poses']} poses, scale {r['scale']:.4f}, "
          f"planes={len(vio.get_planes())}, "
          f"map_points={len(vio.get_map_points())}")
    for k, q in enumerate(r["quarters"]):
        if q is not None:
            print(f"  quarter {k}: ATE {q[0]:.4f} m over {q[1]}")
    if args.blackout is not None:
        for name in ("pre-blackout", "post-recovery"):
            a, s, n = r[name]
            if a is None:
                print(f"  {name}: only {n} poses")
            else:
                print(f"  {name}: ATE {a:.4f} m over {n} poses, scale {s:.4f}")
    print(f"initialized at frame {rec['init_fi']}; median ms per track_camera call: "
          + ", ".join(f"{k} {v[0]:.3f} ({v[1]} calls)" for k, v in state_ms(rec["calls"]).items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())

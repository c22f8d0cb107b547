"""CLI runner, the role of the reference pvio-pc app:

    python -m pvio_torch.run <euroc://DIR | tum://DIR | sensors://FILE |
                              legacy-sensors://FILE | synthetic> [config.yaml]
        [--output trajectory.tum] [--max-frames N] [--cpu]
        [--dtype float32|float64] [--no-planes] [--pipelined] [--fast]
        [--plot PNG] [--view3d HTML] [--overlay-dir DIR [--overlay-every N]]
        [--live DIR [--live-every N]] [--status]

Matches `pvio_tpu/run.py`'s `main`: drives a dataset (or the built-in
synthetic scene, whose ATE against its ground truth is printed) through
`pvio_torch.PVIO`, writes a TUM trajectory and prints the forensics
summary. The engine runs on the card; `--cpu` runs it on the CPU, and
without a card and without `--cpu` the run raises, as `PVIO` does.

On `synthetic` the scene's own preset (`io/synthetic.pipeline_config`)
replaces the YAML config; `--no-planes`, `--dtype`, `--pipelined` and
`--fast` apply to it (the reference keeps only the plane switch there).

The visual flags write what the reference's do, from the forensics bus
through an `on_frame` hook called after every frame: `--view3d` the 3D
map viewer (`io/viewer3d.py`, numpy + json only); `--plot` the end-of-run
dashboard, `--overlay-dir` the tracked-feature overlays, `--live` an
auto-refreshing live view and `--status` a terminal status line
(`io/visualizer.py`; all but `--status` need matplotlib).
"""

import argparse
import sys


def apply_flags(cfg, args):
    """The run-mode flags on a Config."""
    if args.dtype is not None:
        cfg.dtype = args.dtype
    cfg.pipelined_host = bool(args.pipelined or args.fast)
    if args.fast:
        cfg.fused_keyframe = True
        cfg.chained_keyframe = True
    if args.no_planes:
        cfg.enable_plane_constraint = False
    return cfg


def synthetic_ate(traj, scene):
    """ATE (m) of a trajectory against the synthetic scene's positions,
    after an SE(3) alignment, and the number of poses compared."""
    import numpy as np
    import torch

    from pvio_torch.geometry import wahba

    t2idx = {round(tt, 6): i for i, tt in enumerate(scene.frame_t)}
    pairs = [(p, scene.p_wb[t2idx[round(tt, 6)]]) for tt, _, p in traj if round(tt, 6) in t2idx]
    est = torch.as_tensor(np.array([a for a, _ in pairs]), dtype=torch.float64)
    gt = torch.as_tensor(np.array([b for _, b in pairs]), dtype=torch.float64)
    return float(wahba.ate_rmse(est, gt, with_scale=False)), len(pairs)


def main(argv=None):
    ap = argparse.ArgumentParser(description="pvio_torch VIO runner")
    ap.add_argument("dataset", help="euroc://path, tum://path, sensors://file, "
                                    "legacy-sensors://file or 'synthetic'")
    ap.add_argument("config", nargs="?", help="YAML config (reference schema)")
    ap.add_argument("--output", default="trajectory.tum")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--cpu", action="store_true", help="run the engine on the CPU")
    ap.add_argument("--dtype", default=None, choices=["float32", "float64"],
                    help="estimator dtype (default: the config's)")
    ap.add_argument("--no-planes", action="store_true")
    ap.add_argument("--pipelined", action="store_true",
                    help="latency-hiding host pipeline (one frame of "
                         "estimator lag; bit-identical outputs)")
    ap.add_argument("--fast", action="store_true",
                    help="full fast path: pipelined host loop + fused + "
                         "chained keyframe (one combined deferred fetch "
                         "per frame, keyframes included)")
    ap.add_argument("--plot", default=None, metavar="PNG",
                    help="render the forensics dashboard to this file")
    ap.add_argument("--view3d", default=None, metavar="HTML",
                    help="write the interactive 3D map viewer (orbitable "
                         "landmarks/frusta/planes/trajectory; the reference "
                         "NanoVis 3D window, main.cpp:264-470) at end of run")
    ap.add_argument("--overlay-dir", default=None, metavar="DIR",
                    help="save tracked-feature overlays (every --overlay-every"
                         " frames) to this directory")
    ap.add_argument("--overlay-every", type=int, default=10)
    ap.add_argument("--live", default=None, metavar="DIR",
                    help="live view: auto-refreshing DIR/live.html + "
                         "overlay/dashboard PNGs updated during the run "
                         "(reference GUI role, main.cpp:264-470)")
    ap.add_argument("--live-every", type=int, default=10,
                    help="re-render the live view every N frames")
    ap.add_argument("--status", action="store_true",
                    help="in-place terminal status line with fps/lag/BA "
                         "sparklines")
    args = ap.parse_args(argv)

    from pvio_torch import PVIO, Config
    from pvio_torch.io.tum_writer import TumTrajectoryWriter
    from pvio_torch.utils.forensics import bus

    recorder = None
    live = None
    if args.live or args.status:
        from pvio_torch.io.visualizer import LiveVisualizer

        live = LiveVisualizer(directory=args.live, every=args.live_every,
                              terminal=args.status, bus=bus,
                              get_trajectory=lambda: vio.get_trajectory())
        recorder = live.history  # shared with the end-of-run dashboard
    elif args.plot:
        from pvio_torch.io.visualizer import HistoryRecorder

        recorder = HistoryRecorder(bus)

    overlay_count = [0]

    def on_frame(t):
        if live is not None:
            live.frame(t)
        elif recorder is not None:
            recorder.sample(t)
        if args.overlay_dir:
            k = overlay_count[0]
            overlay_count[0] += 1
            if k % args.overlay_every == 0:
                import os

                from pvio_torch.io.visualizer import render_feature_overlay

                os.makedirs(args.overlay_dir, exist_ok=True)
                try:
                    render_feature_overlay(
                        f"{args.overlay_dir}/frame_{k:05d}.png", bus=bus)
                except ValueError:
                    pass

    device = "cpu" if args.cpu else None
    if args.dataset == "synthetic":
        from pvio_torch.io import synthetic

        cfg = apply_flags(synthetic.pipeline_config(), args)
        scene = synthetic.make_scene(duration=4.0, n_points=320)
        vio = PVIO(cfg, device=device)
        n = 0
        with TumTrajectoryWriter(args.output) as wtr:
            fi = 0
            for k in range(len(scene.imu_t)):
                t = scene.imu_t[k]
                vio.track_gyroscope(t, *scene.gyro[k])
                vio.track_accelerometer(t, *scene.accel[k])
                while fi < len(scene.frame_t) and scene.frame_t[fi] <= t:
                    img = synthetic.render_frame(scene, fi, cfg.K, cfg.image_size)
                    pose = vio.track_camera(scene.frame_t[fi], img)
                    if pose is not None:
                        wtr.write_pose(pose.t, pose.q, pose.p)
                    on_frame(scene.frame_t[fi])
                    fi += 1
                    n += 1
                    if args.max_frames and n >= args.max_frames:
                        break
                if args.max_frames and n >= args.max_frames:
                    break
        traj = vio.get_trajectory()
        if traj:
            ate, n_poses = synthetic_ate(traj, scene)
            print(f"ATE RMSE (SE3): {ate * 100:.2f} cm over {n_poses} poses")
    else:
        from pvio_torch.io.datasets import open_dataset, run_dataset

        cfg = apply_flags(Config.from_yaml(args.config) if args.config else Config(), args)
        vio = PVIO(cfg, device=device)
        reader = open_dataset(args.dataset, cfg)
        with TumTrajectoryWriter(args.output) as wtr:
            run_dataset(vio, reader, wtr, max_frames=args.max_frames,
                        on_frame=on_frame)

    if args.view3d:
        from pvio_torch.io.viewer3d import render_view3d

        render_view3d(args.view3d, bus=bus, trajectory=vio.get_trajectory(),
                      title=f"pvio_torch 3D — {args.dataset}")
        print(f"3D viewer written to {args.view3d}")

    if args.plot:
        from pvio_torch.io.visualizer import render_dashboard

        render_dashboard(args.plot, trajectory=vio.get_trajectory(),
                         history=recorder, bus=bus,
                         title=f"pvio_torch — {args.dataset}")
        print(f"dashboard written to {args.plot}")

    print(f"{wtr.n_written} poses written to {args.output}")
    print("forensics:", {k: (round(v, 4) if isinstance(v, float) else v)
                         for k, v in bus.summary().items()
                         if isinstance(v, (int, float))})
    return 0


if __name__ == "__main__":
    sys.exit(main())

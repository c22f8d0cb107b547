"""CLI runner, the role of the reference pvio-pc app:

    python -m pvio_torch.run <euroc://DIR | tum://DIR | sensors://FILE |
                              legacy-sensors://FILE | synthetic> [config.yaml]
        [--output trajectory.tum] [--max-frames N] [--cpu]
        [--dtype float32|float64] [--no-planes] [--pipelined] [--fast]

Matches `pvio_tpu/run.py`'s `main`: drives a dataset (or the built-in
synthetic scene, whose ATE against its ground truth is printed) through
`pvio_torch.PVIO`, writes a TUM trajectory and prints the forensics
summary. The engine runs on the card; `--cpu` runs it on the CPU, and
without a card and without `--cpu` the run raises, as `PVIO` does.

On `synthetic` the scene's own preset (`io/synthetic.pipeline_config`)
replaces the YAML config; `--no-planes`, `--dtype`, `--pipelined` and
`--fast` apply to it (the reference keeps only the plane switch there).
The reference's visual flags (`--plot`, `--view3d`, `--overlay-dir`,
`--live`, `--status`) need its visualizer modules and are not here.
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
    args = ap.parse_args(argv)

    from pvio_torch import PVIO, Config
    from pvio_torch.io.tum_writer import TumTrajectoryWriter
    from pvio_torch.utils.forensics import bus

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
            run_dataset(vio, reader, wtr, max_frames=args.max_frames)

    print(f"{wtr.n_written} poses written to {args.output}")
    print("forensics:", {k: (round(v, 4) if isinstance(v, float) else v)
                         for k, v in bus.summary().items()
                         if isinstance(v, (int, float))})
    return 0


if __name__ == "__main__":
    sys.exit(main())

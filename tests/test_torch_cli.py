"""The port's CLI, `python -m pvio_torch.run`, on the CPU: an ASL dataset on
disk (PNG frames with radtan lens distortion, ns CSVs) and a small
reference-schema YAML, through the native loader, the undistorter, `PVIO`
(float64, planes on) and the TUM writer.

The frames are the synthetic scene's blob renders (`render_frame`, cheap at
the configuration's 752x480), distorted by the YAML's radtan model so that
the reader's undistorter has work. `main([... "--cpu", "--dtype",
"float64"])` must return 0 and write one TUM pose per frame from the
initializing one on, at the times of `io/datasets.run_dataset` driving
`PVIO` directly on the same reader, with the same poses within
`MAX_DP` (the CPU's multi-threaded BLAS may sum in another order from one
run to the next: measured up to 2.4e-9 m between two runs of one process).
"""

import numpy as np
from PIL import Image

import torch

from pvio_torch import PVIO
from pvio_torch import run as cli
from pvio_torch.io import datasets, synthetic, undistort
from pvio_torch.io.config import Config
from pvio_torch.io.tum_writer import TumTrajectoryWriter, load_tum

torch.set_num_threads(2)

MAX_DP = 1e-7
RADTAN = [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
YAML = """\
%YAML 1.0
camera:
  intrinsic: [458.654, 457.296, 367.215, 248.375]
  noise: [0.5, 0.0, 0.0, 0.5]
  distortion: [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
  distortion_model: radtan
sliding_window_size: 5
feature_tracker:
  min_keypoint_distance: 20.0
  max_keypoint_detection: 80
initializer:
  keyframe_num: 5
  keyframe_gap: 3
  min_matches: 20
  min_parallax: 5.0
  min_triangulation: 15
  min_landmarks: 15
solver:
  iteration_limit: 4
"""


def distorted(img, K, size):
    """What a radtan camera records of a pinhole image: each distorted
    pixel samples the pinhole image at its undistorted position."""
    W, H = size
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    X, Y = np.meshgrid((np.arange(W) - cx) / fx, (np.arange(H) - cy) / fy)
    xu, yu = undistort.undistort_points(X, Y, RADTAN, "radtan")
    mx = np.clip(xu * fx + cx, 0.0, W - 1.001)
    my = np.clip(yu * fy + cy, 0.0, H - 1.001)
    x0, y0 = np.floor(mx).astype(int), np.floor(my).astype(int)
    ax, ay = mx - x0, my - y0
    out = ((img[y0, x0] * (1 - ay) + img[y0 + 1, x0] * ay) * (1 - ax)
           + (img[y0, x0 + 1] * (1 - ay) + img[y0 + 1, x0 + 1] * ay) * ax)
    return np.clip(out * 255.0 + 0.5, 0, 255).astype(np.uint8)


def write_dataset(root, cfg, scene):
    cam, imu = root / "mav0" / "cam0", root / "mav0" / "imu0"
    (cam / "data").mkdir(parents=True)
    imu.mkdir(parents=True)
    with open(imu / "data.csv", "w") as f:
        f.write("#timestamp [ns],wx,wy,wz,ax,ay,az\n")
        for t, w, a in zip(scene.imu_t, scene.gyro, scene.accel):
            f.write(f"{int(round(t * 1e9))}," + ",".join(repr(float(x)) for x in (*w, *a)) + "\n")
    with open(cam / "data.csv", "w") as f:
        f.write("#timestamp [ns],filename\n")
        for i, t in enumerate(scene.frame_t):
            ns = int(round(t * 1e9))
            img = synthetic.render_frame(scene, i, cfg.K, cfg.image_size,
                                         q_bc=np.asarray(cfg.q_bc), p_bc=np.asarray(cfg.p_bc))
            Image.fromarray(distorted(img, cfg.K, cfg.image_size)).save(cam / "data" / f"{ns}.png")
            f.write(f"{ns},{ns}.png\n")


def test_cli_writes_the_trajectory_of_run_dataset(tmp_path, capsys):
    yaml_path = tmp_path / "small.yaml"
    yaml_path.write_text(YAML)
    cfg = Config.from_yaml(yaml_path)
    assert cfg.enable_plane_constraint and cfg.image_size == (752, 480)
    scene = synthetic.make_scene(duration=1.6, fps=20.0, imu_rate=200.0, n_points=320,
                                 seed=648, init_ramp=0.3)
    write_dataset(tmp_path / "asl", cfg, scene)
    out = tmp_path / "trajectory.tum"
    rc = cli.main([f"euroc://{tmp_path / 'asl'}", str(yaml_path), "--output", str(out),
                   "--cpu", "--dtype", "float64"])
    assert rc == 0
    t_cli, q_cli, p_cli = load_tum(out)

    cfg.dtype = "float64"
    vio = PVIO(cfg, device="cpu")
    init = []
    ref_out = tmp_path / "direct.tum"
    with TumTrajectoryWriter(ref_out) as wtr:
        datasets.run_dataset(vio, datasets.open_dataset(f"euroc://{tmp_path / 'asl'}", cfg), wtr,
                             on_frame=lambda t: init.append(vio.initialized))
    assert vio.initialized and vio.core.frontend.n_reinits == 0
    n_after_init = len(init) - init.index(True)
    assert len(t_cli) == n_after_init >= 8, (len(t_cli), n_after_init)
    t_ref, q_ref, p_ref = load_tum(ref_out)
    np.testing.assert_array_equal(t_cli, t_ref)
    assert np.abs(p_cli - p_ref).max() <= MAX_DP and np.abs(q_cli - q_ref).max() <= MAX_DP
    assert np.isfinite(p_cli).all() and np.allclose(np.linalg.norm(q_cli, axis=1), 1.0)
    assert f"{len(t_cli)} poses written to {out}" in capsys.readouterr().out

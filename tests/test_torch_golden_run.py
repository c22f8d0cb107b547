"""`pvio_torch.golden_run`'s pieces against the reference's golden harness
(`scripts/golden_run.py`), on the CPU.

- The Config that each set of flags produces equals, field by field, the
  one the reference script builds (its `Config.from_yaml` and lines
  88-107), for euroc.yaml and tum-vi.yaml; the hard-mode flags give the
  reference test's `hard_cfg(planes)` and the endurance flags its
  `Config.from_yaml` with the dtype and the plane switch
  (`tests/test_golden_run.py:140-148`, `:385-387`).
- Rendered and undistorted frames equal the reference's bit for bit:
  radtan at 480x752 and equidistant at 512x512, with pixel noise; a
  blackout frame is black at the config's size; the hard mode's last clean
  and first noisy frames and the endurance run's frames 0 and 600 equal
  the reference tests' own renders, over the same scenes.
- `golden_run.frames_key` tells apart the frames that differ (clean and
  noisy, two texture seeds) and gives runs over the same frames (the two
  dtypes, planes on and off) one key.
- The readout (ATE, scale, quarters, blackout segments) equals the
  reference script's through `pvio_tpu.geometry.wahba` to 1e-12.

The golden runs themselves, on the CPU, are `slow` (the 60 s endurance
runs also `verylong`): the checks of `tests/test_torch_golden_card.py`
with the reference tests' bounds.
"""

from dataclasses import fields
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from pvio_tpu.geometry import wahba as ref_wahba
from pvio_tpu.io import synthetic as ref_syn
from pvio_tpu.io.config import Config as RefConfig
from pvio_tpu.io.undistort import ImageUndistorter as RefUndistorter
from pvio_torch import golden_run
from tests import test_torch_golden_card as card

REPO = Path(__file__).resolve().parent.parent
FLAGS = [
    ["config/euroc.yaml"],
    ["config/euroc.yaml", "--dtype", "float32", "--max-scale", "1.0", "--no-planes",
     "--supplement", "--cauchy", "2.5", "--fb", "0", "--max-kp", "100", "--kp-sigma", "1.5",
     "--escape-dist", "0.02"],
    ["config/tum-vi.yaml", "--dtype", "float32"],
]


def ref_config(args):
    """The reference script's Config (scripts/golden_run.py:96-115)."""
    cfg = RefConfig.from_yaml(args.config)
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


def ref_hard_config(args):
    """The reference hard-mode test's `hard_cfg(planes)`
    (tests/test_golden_run.py:140-148)."""
    cfg = RefConfig.from_yaml(str(REPO / "config/euroc.yaml"))
    cfg.dtype = "float64"
    cfg.initializer_max_scale = 5.0
    cfg.enable_plane_constraint = not args.no_planes
    cfg.feature_tracker_max_keypoint_detection = 100
    cfg.feature_tracker_fb_threshold = 4.0
    cfg.camera_noise_cov = np.eye(2) * 1.5 ** 2
    return cfg


def ref_long_config(args):
    """The reference endurance test's Config (tests/test_golden_run.py:
    385-387), at the run's dtype."""
    cfg = RefConfig.from_yaml(str(REPO / "config/euroc.yaml"))
    cfg.dtype = args.dtype
    cfg.enable_plane_constraint = not args.no_planes
    return cfg


def args_of(flags):
    args = golden_run.parse_args([str(REPO / flags[0])] + flags[1:])
    return args


@pytest.mark.parametrize("flags,ref_of", [
    (FLAGS[0], ref_config), (FLAGS[1], ref_config), (FLAGS[2], ref_config),
    (card.HARD_MODE + ["--dtype", "float64"], ref_hard_config),
    (card.HARD_MODE + ["--dtype", "float64", "--no-planes"], ref_hard_config),
    (card.LONG_HORIZON + ["--dtype", "float64"], ref_long_config),
    (card.LONG_HORIZON + ["--dtype", "float64", "--no-planes"], ref_long_config),
    (card.LONG_HORIZON + ["--dtype", "float32"], ref_long_config),
], ids=["euroc", "euroc-overrides", "tum-vi", "hard-planes_on", "hard-planes_off",
        "long-float64-planes_on", "long-float64-planes_off", "long-float32-planes_on"])
def test_config_matches_reference_script(flags, ref_of):
    args = args_of(flags)
    port, ref = golden_run.build_config(args), ref_of(args)
    for f in fields(RefConfig):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        assert np.array_equal(a, b) if isinstance(b, np.ndarray) else a == b, f.name
    assert port.image_size == ((512, 512) if "tum" in flags[0] else (752, 480))


def ref_frame(scene, fi, cfg, args, noise_rng, und):
    """The reference script's render_image (scripts/golden_run.py:140-152)."""
    img = ref_syn.render_frame_room(
        scene, fi, cfg.K, cfg.image_size, q_bc=np.asarray(cfg.q_bc), p_bc=np.asarray(cfg.p_bc),
        distortion=cfg.camera_distortion, distortion_model=cfg.camera_distortion_model,
        seed=args.texture_seed)
    u8f = img * 255.0
    if args.pixel_noise > 0 and scene.frame_t[fi] >= args.noise_after:
        u8f = u8f + noise_rng.normal(size=u8f.shape) * args.pixel_noise
    u8 = np.clip(u8f + 0.5, 0, 255).astype(np.uint8)
    return np.asarray(und.apply(u8))


def ref_script_scene(args):
    return ref_syn.make_scene(duration=args.duration, fps=args.fps, imu_rate=200.0, n_points=8,
                              seed=args.seed)


def ref_hard_scene(args):
    """The reference hard-mode test's scene (tests/test_golden_run.py:150-152)."""
    return ref_syn.make_scene(duration=12.0, fps=20.0, imu_rate=200.0, n_points=8, seed=648,
                              gyro_noise=1e-3, accel_noise=1e-2)


def ref_long_scene(args):
    """The reference endurance test's scene (tests/test_golden_run.py:377-379)."""
    return ref_syn.make_scene(duration=60.0, fps=20.0, imu_rate=200.0, n_points=8, seed=648,
                              init_ramp=0.3, long_profile=True)


def ref_hard_frame(scene, fi, cfg, args, noise_rng, und):
    """The reference hard-mode test's render (tests/test_golden_run.py:
    159-167): the default texture, noise sigma 8 from t = 3.0 s."""
    img = ref_syn.render_frame_room(
        scene, fi, cfg.K, cfg.image_size, q_bc=np.asarray(cfg.q_bc), p_bc=np.asarray(cfg.p_bc),
        distortion=cfg.camera_distortion, distortion_model=cfg.camera_distortion_model)
    u8f = img * 255.0
    if scene.frame_t[fi] >= 3.0:
        u8f = u8f + noise_rng.normal(size=u8f.shape) * 8.0
    return np.asarray(und.apply(np.clip(u8f + 0.5, 0, 255).astype(np.uint8)))


def ref_long_frame(scene, fi, cfg, args, noise_rng, und):
    """The reference endurance test's `_long_horizon_images` render
    (tests/test_golden_run.py:318-324): no noise, the default texture."""
    img = ref_syn.render_frame_room(
        scene, fi, cfg.K, cfg.image_size, q_bc=np.asarray(cfg.q_bc), p_bc=np.asarray(cfg.p_bc),
        distortion=cfg.camera_distortion, distortion_model=cfg.camera_distortion_model)
    return np.asarray(und.apply((img * 255.0 + 0.5).astype(np.uint8)))


# (flags, frames rendered, the reference's Config, scene and render). The
# port's noise stream starts at the first frame given, the reference's at
# frame 0 but with no draw for a clean frame: the script cases render from
# frame 0; the hard mode's frame 59 (t = 2.95 s) is its last clean frame and
# frame 60 (t = 3.0 s) its first noisy one, so both streams draw first for
# frame 60 from default_rng(649); the endurance frames have no noise.
FRAME_CASES = [
    (["config/euroc.yaml", "--pixel-noise", "3.0", "--duration", "0.15", "--blackout", "0.1",
      "1"], [0, 1], (ref_config, ref_script_scene, ref_frame)),
    (["config/tum-vi.yaml", "--pixel-noise", "3.0", "--noise-after", "0.03", "--duration", "0.15",
      "--texture-seed", "11", "--seed", "5", "--blackout", "0.1", "1"], [0, 1],
     (ref_config, ref_script_scene, ref_frame)),
    (card.HARD_MODE, [59, 60, 61], (ref_hard_config, ref_hard_scene, ref_hard_frame)),
    (card.LONG_HORIZON, [0, 600], (ref_long_config, ref_long_scene, ref_long_frame)),
]


@pytest.mark.parametrize("flags,frames,ref", FRAME_CASES,
                         ids=["euroc-radtan", "tum-vi-equidistant", "hard-mode", "long-horizon"])
def test_frames_match_reference_script(flags, frames, ref):
    ref_config_of, ref_scene_of, ref_frame_of = ref
    args = args_of(flags)
    cfg, ref_cfg = golden_run.build_config(args), ref_config_of(args)
    scene = golden_run.make_scene(args)
    ref_scene = ref_scene_of(args)
    for a, b in zip(scene, ref_scene):
        np.testing.assert_array_equal(a, b)
    images = golden_run.render_images(scene, cfg, args, frames=frames, workers=2)
    und = RefUndistorter(ref_cfg.K, ref_cfg.camera_distortion, ref_cfg.camera_distortion_model,
                         ref_cfg.image_size)
    rng = np.random.default_rng(args.seed + 1)
    W, H = ref_cfg.image_size
    for fi, img in zip(frames, images):
        ref_img = ref_frame_of(ref_scene, fi, ref_cfg, args, rng, und)
        assert img.dtype == np.uint8 and img.shape == (H, W)
        np.testing.assert_array_equal(img, ref_img, err_msg=f"frame {fi}")
    if args.blackout is None:
        return
    # the noise moved the image, and frame 2 (t = 0.1) is blacked out
    assert args.pixel_noise > 0
    image_of = golden_run.image_source(images + [None], scene, cfg, args)
    assert image_of(1) is images[1]
    np.testing.assert_array_equal(image_of(2), np.zeros((H, W), np.uint8))


def test_frames_key_tells_renders_apart():
    """The card tests cache frames under `golden_run.frames_key`: frames
    that differ get different keys, runs over the same frames one key."""
    def key(flags):
        args = args_of(flags)
        return golden_run.frames_key(args, golden_run.make_scene(args))

    clean, hard = key(["config/euroc.yaml"]), key(card.HARD_MODE)
    assert clean != hard
    assert key(["config/euroc.yaml", "--texture-seed", "7"]) == clean
    assert key(["config/euroc.yaml", "--texture-seed", "11"]) != clean
    assert key(list(card.HARD_MODE)) == hard
    assert key(card.HARD_MODE + ["--no-planes", "--dtype", "float32"]) == hard
    assert key(card.LONG_HORIZON + ["--dtype", "float32"]) == \
        key(card.LONG_HORIZON + ["--dtype", "float64", "--no-planes"])
    assert key(card.LONG_HORIZON) not in (clean, hard)


def test_readout_matches_reference_script():
    """The reference script's gauges (scripts/golden_run.py:221-257) on a
    perturbed trajectory with a pose at a time the scene lacks."""
    args = golden_run.parse_args(["config/euroc.yaml", "--duration", "3"])
    scene = golden_run.make_scene(args)
    rng = np.random.default_rng(3)
    traj = [(float(t), np.array([1.0, 0, 0, 0]),
             1.02 * scene.p_wb[i] + 0.01 * rng.standard_normal(3) + np.array([0.3, -0.1, 0.2]))
            for i, t in enumerate(scene.frame_t) if i >= 7]
    traj.insert(5, (123.456, np.array([1.0, 0, 0, 0]), np.zeros(3)))
    blackout = (1.0, 1.6)
    r = golden_run.readout(traj, scene, blackout)

    t2idx = {round(tt, 6): i for i, tt in enumerate(scene.frame_t)}
    est, gt = [], []
    for (tt, q, p) in traj:
        i = t2idx.get(round(tt, 6))
        if i is not None:
            est.append(p)
            gt.append(scene.p_wb[i])
    est, gt = jnp.asarray(np.array(est)), jnp.asarray(np.array(gt))
    s, _, _ = ref_wahba.find_srt(est, gt)
    assert r["poses"] == len(est) == len(scene.frame_t) - 7
    assert abs(r["ate"] - float(ref_wahba.ate_rmse(est, gt, with_scale=False))) < 1e-12
    assert abs(r["scale"] - float(s)) < 1e-12
    nq = len(est) // 4
    for k in range(4):
        seg = slice(k * nq, (k + 1) * nq if k < 3 else len(est))
        a = float(ref_wahba.ate_rmse(est[seg], gt[seg], with_scale=False))
        assert r["quarters"][k][1] == seg.stop - seg.start
        assert abs(r["quarters"][k][0] - a) < 1e-12
    ts = np.array([tt for (tt, q, p) in traj if t2idx.get(round(tt, 6)) is not None])
    for name, m in (("pre-blackout", ts < blackout[0]), ("post-recovery", ts >= blackout[1])):
        e, g = est[np.nonzero(m)[0]], gt[np.nonzero(m)[0]]
        s_seg, _, _ = ref_wahba.find_srt(e, g)
        a, s_port, n = r[name]
        assert n == int(m.sum()) >= 10
        assert abs(a - float(ref_wahba.ate_rmse(e, g, with_scale=False))) < 1e-12
        assert abs(s_port - float(s_seg)) < 1e-12
    short = golden_run.readout(traj[:10], scene, (0.0, 0.6))
    assert short["quarters"] == [None] * 4
    assert short["pre-blackout"] == (None, None, 0)


# the golden runs on the CPU, with the reference tests' bounds ------------------


@pytest.mark.slow
def test_golden_f32_production_dtype_cpu():
    card.check_production_dtype("cpu")


@pytest.mark.slow
def test_golden_euroc_shaped_cpu():
    card.check_euroc_shaped("cpu")


@pytest.mark.slow
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_golden_tumvi_shaped_cpu(dtype):
    card.check_tumvi_shaped("cpu", dtype)


@pytest.mark.slow
def test_golden_production_scale_gate_cpu():
    card.check_production_scale_gate("cpu")


@pytest.mark.slow
def test_golden_blackout_reinit_cpu():
    card.check_blackout_reinit("cpu")


@pytest.mark.slow
def test_golden_hard_mode_cpu():
    card.check_hard_mode_planes_beat_planes_off("cpu", "float64")


@pytest.mark.slow
@pytest.mark.verylong
@pytest.mark.parametrize("dtype,planes", [("float64", True), ("float64", False),
                                          ("float32", True)],
                         ids=["float64-planes_on", "float64-planes_off", "float32-planes_on"])
def test_golden_long_horizon_cpu(dtype, planes):
    card.check_long_horizon_production_gates("cpu", dtype, planes)

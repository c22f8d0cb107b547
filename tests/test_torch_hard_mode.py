"""The hard mode of the golden tier at the image tier: the port's `PVIO`
facade against the reference's feature tracker and sliding-window tracker
on noisy imagery with the reduced keypoint budget and the 4 px gate.

`tests/test_golden_run.py::test_golden_hard_mode_planes_beat_planes_off`
runs 480x752 EuRoC-shaped frames with pixel noise sigma 8 after a clean
initialization, a keypoint budget of 100 (the YAML's 150 cut by a third),
a 4 px forward-backward gate, keypoint sigma 1.5 px and a noisy IMU
(gyro 1e-3, accel 1e-2). Here the same overrides go onto `small_config`
(320x240, float64, planes off) with its budget of 60 cut by the same third
to 40, over the blob stream of `test_torch_facade_tracking.py`: 8-bit
frames, clean through the initializing frame (28) and noised with sigma 8
counts from NOISE_AFTER on, from `default_rng(NOISE_SEED)`.

`lockstep` holds the two packages together step by step on any
configuration and frames; `tests/test_torch_hard_mode_full.py` runs it at
the golden hard mode's own size and frames. `pvio_torch.PVIO(device="cpu")`
runs the whole stream. The reference's `FeatureTracker` tracks the same
images with the same IMU spans and must give the same raw frames (masks
and track ids identical, keypoints within 1e-9 px); its
`SlidingWindowTracker` (with a fresh `PlaneExtractor` when planes are on,
as the port's is at that point) starts from the port's initialized window
and must, after every call, have taken the same keyframes, agree with the
port's state within 1e-6 m and have made the same plane decisions
(`plane_state`: plane masks and ids, the tracks' plane ids and flags
identical; normals, distances and the planes' polar extents within 1e-8).
The reference's extractor builds its extents from the members with a
valid fresh triangulation, as the port's does
(`test_torch_planes.extent_from_valid_members`): the point of a member seen
from one window slot is undefined, and the two eigensolvers pick different
points of its ray. One compilation of the reference's path.

On noisy frames the KLT solve amplifies rounding: the two trackers left to
run free part by ~1e-12 px at the first noisy frame and by ~2e-8 px twenty
noisy frames later, growing ~1.5x a frame along each track (on the clean
frames they stay under 3e-12 px). So each frame the reference's tracker
starts from the port's keypoints of the frame before (`_kp_dev`, the
device-resident state its step chains on; masks and ids are its own and
are held identical), and each step is held to 1e-9 px.
"""

import jax.numpy as jnp
import numpy as np

from tests.test_torch_facade_tracking import MAX_DP_M, MAX_KP_PX, run_port
from tests.test_torch_harness import small_config
from tests.test_torch_oracle_planes import MAX_PLANE_TOL, plane_state
from tests.test_torch_planes import extent_from_valid_members
from tests.test_torch_oracle_pipeline import ref_window

from pvio_tpu.core.feature_tracker import FeatureTracker as RefFeatureTracker
from pvio_tpu.core.kernels import DeviceKernels as RefKernels
from pvio_tpu.core.plane_extractor import PlaneExtractor as RefExtractor
from pvio_tpu.core.swt import SlidingWindowTracker as RefSWT
from pvio_tpu.io.config import Config as RefConfig
from pvio_torch.io import synthetic

NOISE_AFTER = 1.45     # s: frame 29, the first after the initializing frame
NOISE_SIGMA = 8.0      # 8-bit counts, as the golden hard mode
NOISE_SEED = 649
HARD = dict(feature_tracker_max_keypoint_detection=40, feature_tracker_fb_threshold=4.0,
            camera_noise_cov=np.eye(2) * 1.5 ** 2)
PLANE_DECISIONS = ("plane_mask", "plane_ids", "plane_id", "tf_plane")


def hard_config(cls=None):
    return small_config(cls, **HARD)


def hard_stream(duration=2.5):
    """The noisy-IMU blob scene and its 8-bit frames, noised from NOISE_AFTER."""
    scene = synthetic.make_scene(duration=duration, fps=20.0, imu_rate=200.0, n_points=320,
                                 seed=648, gyro_noise=1e-3, accel_noise=1e-2)
    cfg = hard_config()
    rng = np.random.default_rng(NOISE_SEED)
    images = []
    for fi in range(len(scene.frame_t)):
        u8f = synthetic.render_frame(scene, fi, cfg.K, cfg.image_size) * 255.0
        if scene.frame_t[fi] >= NOISE_AFTER:
            u8f = u8f + rng.normal(size=u8f.shape) * NOISE_SIGMA
        images.append(np.clip(u8f + 0.5, 0, 255).astype(np.uint8))
    return scene, images


def step_state(swt):
    """What the two trackers are held to after a call: the plane decisions
    and values (`plane_state`), the planes' polar extents, the whole latest
    state and the keyframes."""
    st = plane_state(swt)
    areas = {} if swt.planes is None else swt.planes.areas
    st.update(state=tuple(np.array(x) for x in swt.latest_state), n_keyframes=swt.n_keyframes,
              areas={int(k): np.concatenate([np.ravel(x) for x in a]) for k, a in areas.items()})
    return st


def lockstep(scene, images, cfg, cfg_ref, free_frontend=False):
    """The port's facade at `cfg` over the scene's IMU and `images`, and the
    reference's trackers at `cfg_ref` held to it step by step (see the
    module's docstring); the first call that parts fails, naming its frame.
    Returns the port's engine, the initializing frame, the keyframes, the
    largest |dp| (m) and the largest of |dn|, |dd| and the extents'
    difference after each call, the largest keypoint
    gap (px) of each frame, and both trackers' states after each call from
    the initializing one on as trajectories [(t, q, p)]. With
    `free_frontend` a second reference `FeatureTracker` tracks the same
    frames left free, and the record adds its largest keypoint gap to the
    port's raw frames on each frame before their masks or ids first differ,
    and that frame (`free_parts`, None if they never do)."""
    planes = cfg.enable_plane_constraint
    vio, raw, init, states = run_port(scene, images, cfg, record=step_state)
    assert vio.initialized and vio.core.frontend.n_reinits == 0
    assert len(raw) == len(images) and len(states) == len(images) - 1 - init["fi"]

    kern = RefKernels(cfg_ref)
    ft = RefFeatureTracker(cfg_ref, kern)
    free = RefFeatureTracker(cfg_ref, kern) if free_frontend else None
    free_gap, free_parts = [], None
    swt, dp, dn, dkp = None, [], [], []
    port_traj, ref_traj = [], []
    for fi, rf in enumerate(raw):
        if free is not None:
            f = free.track_frame(rf.id, rf.t, images[fi], rf.imu_ts, rf.imu_w, rf.imu_a)
            free.initialized = fi >= init["fi"]
            if np.array_equal(f.kp_mask, rf.kp_mask) and np.array_equal(f.track_ids, rf.track_ids):
                gap = np.abs(f.kp[f.kp_mask] - rf.kp[rf.kp_mask])
                free_gap.append(float(gap.max()) if gap.size else 0.0)
            else:
                free, free_parts = None, fi
        if fi > 0:
            ft._kp_dev = jnp.asarray(raw[fi - 1].kp)
        r = ft.track_frame(rf.id, rf.t, images[fi], rf.imu_ts, rf.imu_w, rf.imu_a)
        assert r.t == rf.t
        np.testing.assert_array_equal(r.kp_mask, rf.kp_mask, err_msg=f"frame {fi}")
        np.testing.assert_array_equal(r.track_ids, rf.track_ids, err_msg=f"frame {fi}")
        gap = np.abs(r.kp[r.kp_mask] - rf.kp[rf.kp_mask])
        dkp.append(float(gap.max()) if gap.size else 0.0)
        np.testing.assert_allclose(r.kp[r.kp_mask], rf.kp[rf.kp_mask], rtol=0, atol=MAX_KP_PX,
                                   err_msg=f"frame {fi}")
        if fi == init["fi"]:
            swt = RefSWT(cfg_ref, kern, ref_window(init["window"]), ft,
                         extent_from_valid_members(RefExtractor(cfg_ref, kern)) if planes
                         else None)
            ft.initialized = True
            t, q, p = swt.latest_state[:3]
            port_traj.append((t, np.array(q), np.array(p)))
            ref_traj.append((t, np.array(q), np.array(p)))
        elif swt is not None:
            assert swt.track(r), f"the reference lost tracking at frame {fi}"
            a, b = states[fi - 1 - init["fi"]], step_state(swt)
            assert a["t"] == b["t"] and a["n_keyframes"] == b["n_keyframes"], (
                f"frame {fi}: keyframes {a['n_keyframes']} (port) vs {b['n_keyframes']}")
            for name in PLANE_DECISIONS:
                np.testing.assert_array_equal(a[name], b[name], err_msg=f"frame {fi}: {name}")
            dp.append(float(np.abs(a["p"] - np.asarray(b["p"])).max()))
            assert sorted(a["areas"]) == sorted(b["areas"]), f"frame {fi}: extents"
            dn.append(max([float(np.abs(a[k] - b[k]).max()) for k in ("normal", "distance")
                           if len(b[k])]
                          + [float(np.abs(a["areas"][k] - b["areas"][k]).max()) for k in b["areas"]],
                          default=0.0))
            for x, y in zip(a["state"][1:], b["state"][1:]):
                np.testing.assert_allclose(x, np.asarray(y), rtol=0, atol=MAX_DP_M,
                                           err_msg=f"frame {fi}")
            assert dn[-1] <= MAX_PLANE_TOL, (fi, dn[-1])
            port_traj.append((a["t"], a["state"][1], a["state"][2]))
            ref_traj.append((b["t"], np.array(b["state"][1]), np.array(b["state"][2])))
    assert swt.n_keyframes == vio.core.frontend.swt.n_keyframes
    return dict(vio=vio, init_fi=init["fi"], n_keyframes=swt.n_keyframes, dp=dp, dn=dn, dkp=dkp,
                port_traj=port_traj, ref_traj=ref_traj, free_gap=free_gap, free_parts=free_parts)


def test_hard_mode_tracking_matches_reference_on_noisy_images():
    scene, images = hard_stream()
    run = lockstep(scene, images, hard_config(), hard_config(RefConfig))
    init_fi, n_noisy = run["init_fi"], len(run["dp"])
    assert scene.frame_t[init_fi] < NOISE_AFTER <= scene.frame_t[init_fi + 1]
    assert n_noisy >= 20 and run["n_keyframes"] >= 3
    dp = max(run["dp"])
    assert dp <= MAX_DP_M, dp
    print(f"hard mode vs the reference: initialized at frame {init_fi}, {n_noisy} noisy "
          f"frames after it, {run['n_keyframes']} keyframes, max |dp| {dp:.3e} m")

"""Synthetic VIO scene (host-side numpy) for driving the port without JAX.

Numpy-only copies of what the port's smoke run, CLI and tests need from
`pvio_tpu/io/synthetic.py`: `make_scene` (`synthetic.py:193`),
`pipeline_config`, `OracleFeatureSource` (emitting the port's `RawFrame`),
`_value_noise_hash`, `fractal_texture`, `_room_rays` and
`render_frame_room` (pinhole or lens-distorted rays, through the port's
`io/undistort`), `_texture`, `render_frame_textured`, `render_frame`,
`project_points`, `write_asl_dataset` and `load_asl_groundtruth`
(`:433-844`), plus
`solver_window_from_scene` and `flag_plane_tracks` (`:300-430`) built on
the port's preintegration and window types. The scene generator and the
renderers are the reference's code verbatim, so a seed gives the same
scene, images and window in both packages.
"""

from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from pvio_torch.imu import preintegration as _pre
from pvio_torch.imu.preintegration import GRAVITY_NOMINAL
from pvio_torch.map import window as _win

GRAVITY = np.array([0.0, 0.0, -GRAVITY_NOMINAL])

# -- numpy quaternion helpers (host-side; avoids device dispatch per call) --

def _np_quat_mul(a, b):
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], axis=-1)


def _np_quat_conj(q):
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def _np_expmap(w):
    t2 = np.sum(w * w, axis=-1, keepdims=True)
    small = t2 < 1e-12
    t = np.sqrt(np.where(small, 1.0, t2))
    s = np.where(small, 0.5 - t2 / 48.0, np.sin(0.5 * t) / t)
    c = np.where(small, 1.0 - t2 / 8.0, np.cos(0.5 * t))
    return np.concatenate([c, s * w], axis=-1)


def _np_logmap(q):
    q = q * np.sign(np.where(q[..., :1] == 0, 1.0, q[..., :1]))
    w = q[..., :1]
    u = q[..., 1:]
    n2 = np.sum(u * u, axis=-1, keepdims=True)
    small = n2 < 1e-12
    n = np.sqrt(np.where(small, 1.0, n2))
    angle = 2.0 * np.arctan2(n, w)
    scale = np.where(small, 2.0 / np.maximum(w, 0.5), angle / n)
    return scale * u


def _np_quat_to_mat(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    R = np.empty(q.shape[:-1] + (3, 3))
    R[..., 0, 0] = 1 - 2 * (yy + zz); R[..., 0, 1] = 2 * (xy - wz); R[..., 0, 2] = 2 * (xz + wy)
    R[..., 1, 0] = 2 * (xy + wz); R[..., 1, 1] = 1 - 2 * (xx + zz); R[..., 1, 2] = 2 * (yz - wx)
    R[..., 2, 0] = 2 * (xz - wy); R[..., 2, 1] = 2 * (yz + wx); R[..., 2, 2] = 1 - 2 * (xx + yy)
    return R


def _np_quat_rotate(q, v):
    w = q[..., :1]
    u = q[..., 1:]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))



class SyntheticScene(NamedTuple):
    # trajectory at frame rate (body frame states, world coords)
    frame_t: np.ndarray     # (N,)
    q_wb: np.ndarray        # (N, 4)
    p_wb: np.ndarray        # (N, 3)
    v_wb: np.ndarray        # (N, 3)
    # imu stream
    imu_t: np.ndarray       # (M,)
    gyro: np.ndarray        # (M, 3) body angular rate (with bias+noise if any)
    accel: np.ndarray       # (M, 3) specific force in body frame
    bg_true: np.ndarray     # (3,)
    ba_true: np.ndarray     # (3,)
    # structure
    points: np.ndarray      # (L, 3)
    plane_of_point: np.ndarray  # (L,) int, -1 = free-space point
    plane_normals: np.ndarray   # (P, 3)
    plane_distances: np.ndarray  # (P,)


def _smoothstep(x):
    x = np.clip(x, 0.0, 1.0)
    return x * x * (3.0 - 2.0 * x)


def _pause_warp(t, a0=47.0, a1=48.5, b1=52.0, b0=53.5, depth=0.88):
    """C^1 time-warp tau(t) = t - depth * integral(bump) implementing a
    slow-down to (1-depth) speed over [a0, b0] (trapezoidal speed
    profile: ramp a0->a1, hold a1->b1, ramp b1->b0). The path is
    unchanged; only traversal speed drops — so every state before a0 is
    bit-identical with or without the pause."""
    r = a1 - a0
    i1 = (t - a0) ** 2 / (2 * r)
    i2 = r / 2 + (t - a1)
    i3 = r / 2 + (b1 - a1) + (r / 2 - (b0 - t) ** 2 / (2 * r))
    i4 = r + (b1 - a1)
    integ = np.where(
        t <= a0, 0.0,
        np.where(t <= a1, i1,
                 np.where(t <= b1, i2,
                          np.where(t <= b0, i3, i4))))
    return t - depth * integ


def _traj_pose(t, span=5.0, traj_scale=1.0, init_ramp=0.0,
               long_profile=False, agg_scale=1.0):
    """Smooth analytic trajectory: oval + yaw sweep + gentle roll, with
    enough acceleration excitation (~2-3 m/s^2) for scale/gravity
    observability during initialization. traj_scale shrinks the spatial
    sweep (rotations unchanged) — at <= 0.6 the initialization baseline
    stays under 1 m, inside the reference's production scale sanity gate
    (initializer.cpp:216,221).

    init_ramp > 0: multiply the spatial sweep by a smooth envelope that
    starts at `init_ramp` and reaches 1.0 at t = 4 s — the init-window
    baseline stays under the reference's <1 m scale gate WITHOUT
    shrinking the whole trajectory (the production-gate alternative to
    traj_scale).

    long_profile: superimpose slow incommensurate center drift (the
    base oval revisits displaced loops instead of retracing itself), an
    aggressive yaw/pitch oscillation burst around t = 25-35 s, and a
    slow-down window at t = 47-52 s (a C^1 time-warp traversing the same
    path at ~20% speed — the hover pause every real MAV sequence
    contains, and the <1 m-baseline window a production re-init needs,
    initializer.cpp:216) — the loop + hard-segment + pause structure of
    a 60+ s EuRoC-style sequence."""
    t = np.asarray(t, np.float64)
    t_real = t
    if long_profile:
        t = _pause_warp(t)
    w = 2 * np.pi / span
    p = np.stack(
        [1.2 * np.sin(w * t), 0.8 * np.sin(2 * w * t), 0.25 * np.sin(w * t + 0.4)],
        axis=-1,
    )
    yaw = 0.5 * np.sin(w * t)
    pitch = 0.12 * np.sin(2 * w * t + 0.3)
    roll = 0.10 * np.sin(w * t + 1.1)
    if long_profile:
        p = p + np.stack(
            [0.8 * np.sin(2 * np.pi * t / 37.0),
             0.6 * np.sin(2 * np.pi * t / 53.0),
             0.12 * np.sin(2 * np.pi * t / 23.0)], axis=-1)
        agg = agg_scale * _smoothstep((t - 25.0) / 3.0) * _smoothstep((35.0 - t) / 3.0)
        yaw = yaw + 0.6 * agg * np.sin(2 * np.pi * t / 3.5)
        pitch = pitch + 0.15 * agg * np.sin(2 * np.pi * t / 2.3 + 0.7)
        # hover-correction jitter riding the pause (REAL time, so it is
        # zero before the pause and leaves every earlier state
        # bit-identical): ~5 cm station-keeping oscillation at ~1 Hz —
        # what a real MAV hover exhibits from wind/position corrections.
        # It contributes ~2.4 m/s^2 of accelerometer excitation with a
        # < 6 cm baseline footprint, making metric scale observable to a
        # pause-window re-initialization WITHOUT breaching the
        # reference's < 1 m init-baseline sanity gate
        # (initializer.cpp:216,221) that the slow traversal speed is
        # there to satisfy.
        hov = (_smoothstep((t_real - 47.5) / 1.0)
               * _smoothstep((52.5 - t_real) / 1.0))
        p = p + hov[..., None] * np.stack(
            [0.05 * np.sin(2 * np.pi * 1.1 * t_real),
             0.05 * np.sin(2 * np.pi * 0.9 * t_real + 0.5),
             0.025 * np.sin(2 * np.pi * 1.3 * t_real + 1.0)], axis=-1)
    if init_ramp > 0.0:
        env = init_ramp + (1.0 - init_ramp) * _smoothstep(t / 4.0)
        p = p * env[..., None]
    p = traj_scale * p
    rv = np.stack([roll, pitch, yaw], axis=-1)
    q = _np_expmap(rv)
    return q, p


def make_scene(
    seed=648,
    duration=4.0,
    fps=20.0,
    imu_rate=200.0,
    n_points=160,
    n_plane_points=0,
    plane_z=4.6,
    gyro_noise=0.0,
    accel_noise=0.0,
    bg=(0.0, 0.0, 0.0),
    ba=(0.0, 0.0, 0.0),
    traj_scale=1.0,
    init_ramp=0.0,
    long_profile=False,
    agg_scale=1.0,
) -> SyntheticScene:
    rng = np.random.default_rng(seed)
    assert imu_rate % fps == 0, "frame times must align with the IMU grid"
    stride = int(round(imu_rate / fps))
    imu_t = np.arange(0.0, duration + 0.5 / imu_rate, 1.0 / imu_rate)
    n_frames = int(duration * fps)
    frame_idx = np.arange(n_frames) * stride
    frame_t = imu_t[frame_idx]

    # Sample ideal gyro/accel from the analytic trajectory...
    h = 1e-4

    def _tp(t):
        return _traj_pose(t, traj_scale=traj_scale, init_ramp=init_ramp,
                          long_profile=long_profile, agg_scale=agg_scale)

    def vel(t):
        _, pp = _tp(t + h)
        _, pm = _tp(t - h)
        return (pp - pm) / (2 * h)

    def acc(t):
        _, pp = _tp(t + h)
        _, p0 = _tp(t)
        _, pm = _tp(t - h)
        return (pp - 2 * p0 + pm) / (h * h)

    q_i, _ = _tp(imu_t)
    q_ip, _ = _tp(imu_t + h)
    # body angular rate: omega = logmap(q(t)^-1 q(t+h)) / h
    dq = _np_quat_mul(_np_quat_conj(q_i), q_ip)
    omega = _np_logmap(dq) / h
    a_w = acc(imu_t)
    # specific force in body frame: f = R_wb^T (a - g)
    R_bw = _np_quat_to_mat(_np_quat_conj(q_i))
    f_b = np.einsum("nij,nj->ni", R_bw, a_w - GRAVITY)

    bg = np.asarray(bg, float)
    ba = np.asarray(ba, float)
    gyro = omega + bg + rng.normal(size=omega.shape) * gyro_noise
    accel = f_b + ba + rng.normal(size=f_b.shape) * accel_noise

    # ...then define ground truth AS the piecewise-constant integration of
    # the bias-corrected noise-free samples, so preintegrated deltas are
    # exactly consistent with the trajectory (no discretization mismatch).
    q_all = np.zeros((len(imu_t), 4))
    p_all = np.zeros((len(imu_t), 3))
    v_all = np.zeros((len(imu_t), 3))
    q0, p0 = _tp(np.array([0.0]))
    q_all[0] = q0[0]
    p_all[0] = p0[0]
    v_all[0] = vel(np.array([0.0]))[0]
    for i in range(len(imu_t) - 1):
        dt = imu_t[i + 1] - imu_t[i]
        Rwb = _np_quat_to_mat(q_all[i])
        a_world = Rwb @ f_b[i] + GRAVITY
        p_all[i + 1] = p_all[i] + dt * v_all[i] + 0.5 * dt * dt * a_world
        v_all[i + 1] = v_all[i] + dt * a_world
        qn = _np_quat_mul(q_all[i], _np_expmap(omega[i] * dt))
        q_all[i + 1] = qn / np.linalg.norm(qn)
    q_f = q_all[frame_idx]
    p_f = p_all[frame_idx]
    v_f = v_all[frame_idx]

    # landmarks in a slab in front of the cameras (the nominal optical
    # axis is +z): dense enough that every frame sees a full keypoint set
    pts = rng.uniform(-1.0, 1.0, size=(n_points, 3)) * np.array([2.5, 2.0, 1.0])
    pts[:, 2] = rng.uniform(1.8, 4.5, size=n_points)
    plane_of_point = -np.ones(n_points + n_plane_points, dtype=np.int64)
    if n_plane_points > 0:
        # fronto-parallel wall z = plane_z (normal +z, distance plane_z), in view of the +z-looking camera
        ppts = np.concatenate(
            [rng.uniform(-4.0, 4.0, size=(n_plane_points, 2)),
             np.full((n_plane_points, 1), plane_z)], axis=-1
        )
        pts = np.concatenate([pts, ppts], axis=0)
        plane_of_point[n_points:] = 0
        plane_normals = np.array([[0.0, 0.0, 1.0]])
        plane_distances = np.array([plane_z])
    else:
        plane_normals = np.zeros((0, 3))
        plane_distances = np.zeros((0,))

    return SyntheticScene(
        frame_t=frame_t, q_wb=q_f, p_wb=p_f, v_wb=v_f,
        imu_t=imu_t, gyro=gyro, accel=accel, bg_true=bg, ba_true=ba,
        points=pts, plane_of_point=plane_of_point,
        plane_normals=plane_normals, plane_distances=plane_distances,
    )



def pipeline_config():
    """Config preset for running the full pipeline on the built-in
    synthetic scene (small image, small window; used by the CLI runner
    and the timing scripts)."""
    from pvio_torch.io.config import Config

    cfg = Config()
    cfg.camera_intrinsic = np.array([200.0, 200.0, 160.0, 120.0])
    cfg.image_size = (320, 240)
    cfg.sliding_window_size = 6
    cfg.window_frame_capacity = 7
    cfg.track_capacity = 128
    cfg.initializer_keyframe_gap = 4
    cfg.initializer_min_matches = 20
    cfg.initializer_min_parallax = 5.0
    cfg.initializer_min_triangulation = 15
    cfg.initializer_min_landmarks = 15
    cfg.keyframe_min_common_tracks = 20
    cfg.keyframe_parallax_px = 25.0
    return cfg


class OracleFeatureSource:
    """Drop-in stand-in for core.feature_tracker.FeatureTracker that emits
    RawFrames with *projected* keypoints (+ optional pixel noise) instead
    of running detection/KLT on images. Track ids are landmark indices, so
    data association is perfect. Used by golden-run tests to isolate the
    estimation chain from front-end fidelity, and by benchmarks to drive
    the solver at full rate."""

    def __init__(self, scene: SyntheticScene, K, image_size, max_keypoints=150,
                 kp_noise_px=0.0, seed=0, q_bc=None, p_bc=None):
        from pvio_torch.core.feature_tracker import RawFrame

        self.frames = []
        self.initialized = False
        self._RawFrame = RawFrame
        self.scene = scene
        self.K = K
        self.image_size = image_size
        self.max_keypoints = max_keypoints
        self.rng = np.random.default_rng(seed)
        self.kp_noise_px = kp_noise_px
        self.q_bc = q_bc
        self.p_bc = p_bc
        self.max_frames = 1000

    def make_frame(self, frame_id, frame_index, imu_ts, imu_w, imu_a):
        W, H = self.image_size
        kp, vis = project_points(self.scene, np.array([frame_index]),
                                 self.q_bc, self.p_bc, max_angle_tan=10.0)
        fx, fy = self.K[0, 0], self.K[1, 1]
        cx, cy = self.K[0, 2], self.K[1, 2]
        px = kp[0, :, 0] * fx + cx
        py = kp[0, :, 1] * fy + cy
        ok = vis[0] & (px > 20) & (px < W - 20) & (py > 20) & (py < H - 20)
        idx = np.nonzero(ok)[0][: self.max_keypoints]
        Kmax = self.max_keypoints
        kpa = np.zeros((Kmax, 2))
        mask = np.zeros(Kmax, bool)
        ids = -np.ones(Kmax, np.int64)
        n = len(idx)
        kpa[:n, 0] = px[idx]
        kpa[:n, 1] = py[idx]
        if self.kp_noise_px > 0:
            kpa[:n] += self.rng.normal(size=(n, 2)) * self.kp_noise_px
        mask[:n] = True
        ids[:n] = idx
        rf = self._RawFrame(frame_id, float(self.scene.frame_t[frame_index]),
                            kpa, mask, ids, np.asarray(imu_ts),
                            np.asarray(imu_w), np.asarray(imu_a))
        self.frames.append(rf)
        while len(self.frames) > self.max_frames:
            self.frames.pop(0)
        return rf

    def frame_by_id(self, frame_id):
        for f in self.frames:
            if f.id == frame_id:
                return f
        return None


def _value_noise_hash(ix, iy, seed):
    """Deterministic lattice hash -> [0, 1) (vectorized integer mix)."""
    h = (ix.astype(np.int64) * 374761393 + iy.astype(np.int64) * 668265263
         + np.int64(seed) * 1442695041) & 0x7FFFFFFF
    h = ((h ^ (h >> 13)) * 1274126177) & 0x7FFFFFFF
    return ((h ^ (h >> 16)) & 0xFFFFF).astype(np.float64) / float(0xFFFFF)


def fractal_texture(u, v, seed=7, octaves=5, lacunarity=2.0, gain=0.55,
                    base_freq=1.5):
    """Multi-octave value noise (smoothstep-interpolated random lattice):
    dense gradients at every scale, the corner statistics real imagery has.
    Replaces gaussian-blob splats for frontend-in-the-loop accuracy runs
    (blob imagery causes KLT center drift)."""
    u = np.asarray(u, np.float64)
    v = np.asarray(v, np.float64)
    acc = np.zeros_like(u)
    amp_sum = 0.0
    freq, amp = base_freq, 1.0
    for o in range(octaves):
        x, y = u * freq, v * freq
        ix, iy = np.floor(x), np.floor(y)
        fx, fy = x - ix, y - iy
        ix = ix.astype(np.int64)
        iy = iy.astype(np.int64)
        sx = fx * fx * (3.0 - 2.0 * fx)
        sy = fy * fy * (3.0 - 2.0 * fy)
        h00 = _value_noise_hash(ix, iy, seed + 31 * o)
        h10 = _value_noise_hash(ix + 1, iy, seed + 31 * o)
        h01 = _value_noise_hash(ix, iy + 1, seed + 31 * o)
        h11 = _value_noise_hash(ix + 1, iy + 1, seed + 31 * o)
        n = (h00 * (1 - sx) + h10 * sx) * (1 - sy) \
            + (h01 * (1 - sx) + h11 * sx) * sy
        acc += amp * n
        amp_sum += amp
        freq *= lacunarity
        amp *= gain
    return acc / amp_sum


_ROOM_RAY_CACHE = {}


def _room_rays(K, image_size, distortion, distortion_model):
    """Per-pixel camera-frame ray directions (cached). With a distortion
    model the rays are those of the *distorted* pixels, so the rendered
    image is what the physical (distorted) camera would capture and must
    be undistorted before the pinhole pipeline — exercising io/undistort
    in the loop like the reference datasets do (euroc_dataset_reader.cpp:
    70-74, tum_dataset_reader.cpp:73-81)."""
    key = (image_size, np.asarray(K).tobytes(),
           None if distortion is None else tuple(np.asarray(distortion)),
           distortion_model)
    hit = _ROOM_RAY_CACHE.get(key)
    if hit is not None:
        return hit
    W, H = image_size
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    xs = (np.arange(W) - cx) / fx
    ys = (np.arange(H) - cy) / fy
    X, Y = np.meshgrid(xs, ys)
    if distortion is not None and distortion_model not in (None, "none"):
        from pvio_torch.io.undistort import undistort_points

        X, Y = undistort_points(X, Y, distortion, distortion_model)
    dirs = np.stack([X, Y, np.ones_like(X)], axis=-1)
    _ROOM_RAY_CACHE[key] = dirs
    if len(_ROOM_RAY_CACHE) > 8:
        _ROOM_RAY_CACHE.pop(next(iter(_ROOM_RAY_CACHE)))
    return dirs


def render_frame_room(scene: SyntheticScene, frame_index, K, image_size,
                      q_bc=None, p_bc=None, distortion=None,
                      distortion_model=None,
                      box=((-4.0, 4.0), (-3.0, 3.0), (-2.5, 6.0)), seed=7,
                      ss=2):
    """Render one frame of a textured box-room interior: every pixel ray
    is cast to its exit face of the axis-aligned box and sampled from a
    multi-octave noise texture. Geometrically exact dense imagery with
    multiple true planes (the walls), production resolutions, and optional
    radtan/equidistant lens distortion — the stand-in for EuRoC/TUM-VI
    golden-run imagery (SURVEY §4). Returns (H, W) float32 in [0, 1].

    `ss`: supersampling factor. ss=2 renders at twice the resolution and
    box-downsamples — the camera-PSF anti-aliasing a real sensor has.
    Aliased (ss=1) imagery makes subpixel KLT drift several times worse,
    which no real camera exhibits."""
    if ss > 1:
        W, H = image_size
        Kss = np.array(K, float).copy()
        Kss[0, 0] *= ss
        Kss[1, 1] *= ss
        Kss[0, 2] = Kss[0, 2] * ss + (ss - 1) * 0.5
        Kss[1, 2] = Kss[1, 2] * ss + (ss - 1) * 0.5
        hi = render_frame_room(scene, frame_index, Kss, (W * ss, H * ss),
                               q_bc=q_bc, p_bc=p_bc, distortion=distortion,
                               distortion_model=distortion_model, box=box,
                               seed=seed, ss=1)
        return hi.reshape(H, ss, W, ss).mean(axis=(1, 3)).astype(np.float32)
    if q_bc is None:
        q_bc = np.array([1.0, 0, 0, 0])
    if p_bc is None:
        p_bc = np.zeros(3)
    q = scene.q_wb[frame_index]
    p = scene.p_wb[frame_index]
    q_wc = _np_quat_mul(q, q_bc)
    p_wc = p + _np_quat_rotate(q, p_bc)
    R_wc = _np_quat_to_mat(q_wc)
    dirs = _room_rays(K, image_size, distortion, distortion_model) @ R_wc.T

    # exit point of the box (camera is inside): per axis the positive-t
    # face crossing, overall hit = nearest crossing
    eps = 1e-12
    t_ax = np.empty(dirs.shape[:2] + (3,))
    for a in range(3):
        lo, hi = box[a]
        d = dirs[..., a]
        o = p_wc[a]
        t_ax[..., a] = np.where(
            d > eps, (hi - o) / np.where(d > eps, d, 1.0),
            np.where(d < -eps, (lo - o) / np.where(d < -eps, d, 1.0), np.inf))
    axis = np.argmin(t_ax, axis=-1)
    t = np.take_along_axis(t_ax, axis[..., None], axis=-1)[..., 0]
    hit = p_wc + t[..., None] * dirs
    face = axis * 2 + (np.take_along_axis(
        dirs, axis[..., None], axis=-1)[..., 0] > 0)
    # texture coords = the two in-face coordinates, decorrelated per face
    u = np.where(axis == 0, hit[..., 1], hit[..., 0]) + 137.31 * face
    v = np.where(axis == 2, hit[..., 1], hit[..., 2]) + 91.73 * face
    img = 0.15 + 0.8 * fractal_texture(u, v, seed=seed)
    shade = 1.0 - 0.06 * face  # slight per-face brightness step
    return np.clip(img * shade, 0.0, 1.0).astype(np.float32)


_TEXTURE_WAVES = None


def _texture(u, v, seed=7, n_waves=40):
    """Procedural 2-D texture: sum of random sinusoids (dense gradients,
    plenty of Shi-Tomasi corners)."""
    global _TEXTURE_WAVES
    if _TEXTURE_WAVES is None or _TEXTURE_WAVES[0] != (seed, n_waves):
        rng = np.random.default_rng(seed)
        freq = rng.uniform(0.5, 6.0, size=(n_waves, 2)) * rng.choice([-1, 1], size=(n_waves, 2))
        phase = rng.uniform(0, 2 * np.pi, size=n_waves)
        amp = rng.uniform(0.3, 1.0, size=n_waves) / np.sqrt(n_waves)
        _TEXTURE_WAVES = ((seed, n_waves), freq, phase, amp)
    _, freq, phase, amp = _TEXTURE_WAVES
    acc = np.zeros_like(u)
    for k in range(len(amp)):
        acc = acc + amp[k] * np.sin(freq[k, 0] * u + freq[k, 1] * v + phase[k])
    return 0.5 + 0.5 * acc / np.max(np.abs(acc) + 1e-9)


def render_frame_textured(scene: SyntheticScene, frame_index, K, image_size,
                          q_bc=None, p_bc=None, wall_z=None):
    """Render a frame of a *textured wall* at z = wall_z (defaults to the
    scene's plane if present, else behind the landmark slab): every pixel
    ray is cast onto the wall and sampled from a procedural texture —
    geometrically exact dense imagery that the KLT frontend can track
    without the center-drift artifacts of sparse gaussian blobs."""
    W, H = image_size
    if wall_z is None:
        wall_z = float(scene.plane_distances[0]) if len(scene.plane_distances) else 5.0
    if q_bc is None:
        q_bc = np.array([1.0, 0, 0, 0])
    if p_bc is None:
        p_bc = np.zeros(3)
    q = scene.q_wb[frame_index]
    p = scene.p_wb[frame_index]
    q_wc = _np_quat_mul(q, q_bc)
    p_wc = p + _np_quat_rotate(q, p_bc)
    R_wc = _np_quat_to_mat(q_wc)

    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    xs = (np.arange(W) - cx) / fx
    ys = (np.arange(H) - cy) / fy
    X, Y = np.meshgrid(xs, ys)
    dirs = np.stack([X, Y, np.ones_like(X)], axis=-1) @ R_wc.T  # world rays
    dz = dirs[..., 2]
    dz = np.where(np.abs(dz) < 1e-9, 1e-9, dz)
    s = (wall_z - p_wc[2]) / dz
    hit_x = p_wc[0] + s * dirs[..., 0]
    hit_y = p_wc[1] + s * dirs[..., 1]
    img = _texture(hit_x, hit_y)
    img = np.where(s > 0.1, img, 0.0)
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def render_frame(scene: SyntheticScene, frame_index, K, image_size,
                 q_bc=None, p_bc=None, sigma=1.6, seed=0):
    """Render a grayscale image of the landmark cloud as gaussian splats —
    enough texture for the KLT frontend to detect and track. image_size =
    (W, H). Returns (H, W) float array in [0, 1]."""
    W, H = image_size
    kp, vis = project_points(scene, np.array([frame_index]), q_bc, p_bc,
                             max_angle_tan=10.0)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    px = kp[0, :, 0] * fx + cx
    py = kp[0, :, 1] * fy + cy
    ok = vis[0] & (px > -5) & (px < W + 5) & (py > -5) & (py < H + 5)
    rng = np.random.default_rng(1234)  # fixed per-landmark appearance
    amp = rng.uniform(0.45, 1.0, size=len(px))
    img = np.zeros((H, W))
    r = int(np.ceil(3 * sigma))
    for i in np.nonzero(ok)[0]:
        x0 = int(np.floor(px[i]))
        y0 = int(np.floor(py[i]))
        xs = np.arange(max(x0 - r, 0), min(x0 + r + 1, W))
        ys = np.arange(max(y0 - r, 0), min(y0 + r + 1, H))
        if len(xs) == 0 or len(ys) == 0:
            continue
        gx = np.exp(-((xs - px[i]) ** 2) / (2 * sigma**2))
        gy = np.exp(-((ys - py[i]) ** 2) / (2 * sigma**2))
        img[np.ix_(ys, xs)] += amp[i] * np.outer(gy, gx)
    return np.clip(img, 0.0, 1.0)


def project_points(scene: SyntheticScene, frame_indices, q_bc=None, p_bc=None,
                   max_angle_tan=0.9, min_z=0.3, kp_noise=0.0, seed=0):
    """Project all landmarks into the chosen frames.

    Returns (kp (F, L, 2) normalized coords, visible (F, L) bool).
    """
    rng = np.random.default_rng(seed)
    if q_bc is None:
        q_bc = np.array([1.0, 0, 0, 0])
    if p_bc is None:
        p_bc = np.zeros(3)
    q = scene.q_wb[frame_indices]
    p = scene.p_wb[frame_indices]
    q_wc = _np_quat_mul(q, np.broadcast_to(q_bc, q.shape))
    p_wc = p + _np_quat_rotate(q, np.broadcast_to(p_bc, p.shape))
    R_cw = _np_quat_to_mat(_np_quat_conj(q_wc))
    rel = scene.points[None, :, :] - p_wc[:, None, :]
    y = np.einsum("fij,flj->fli", R_cw, rel)
    z = y[..., 2]
    visible = z > min_z
    zs = np.where(np.abs(z) < 1e-9, 1e-9, z)
    kp = y[..., :2] / zs[..., None]
    visible &= np.all(np.abs(kp) < max_angle_tan, axis=-1)
    if kp_noise > 0:
        kp = kp + rng.normal(size=kp.shape) * kp_noise
    return kp, visible




def solver_window_from_scene(scene, kf_indices, F_cap=9, T_cap=256, P_cap=8,
                             dtype=torch.float32, device="cpu", kp_noise=0.0,
                             imu_cap=64, seed=1, bg_est=None, ba_est=None,
                             noise=None):
    """Ground-truth solver window from a scene: true states, true depths,
    preintegrated deltas (the port's `preintegrate`, tree path).

    Returns (WindowState, Extrinsics, info dict)."""
    nkf = len(kf_indices)
    assert nkf <= F_cap
    dev = torch.device(device)
    if noise is None:
        noise = _pre.ImuNoise.isotropic(1e-4, 1e-2, 1e-8, 1e-6, dtype=dtype, device=dev)

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

    kp, vis = project_points(scene, np.asarray(kf_indices), kp_noise=kp_noise, seed=seed)
    counts = vis.sum(axis=0)
    order = np.argsort(-counts)
    chosen = [l for l in order if counts[l] >= 2][:T_cap]
    L = len(chosen)

    kp_grid = np.zeros((F_cap, T_cap, 2))
    obs = np.zeros((F_cap, T_cap), dtype=bool)
    kp_grid[:nkf, :L] = kp[:, chosen]
    obs[:nkf, :L] = vis[:, chosen]
    ref = np.argmax(obs, axis=0)

    pts = scene.points[chosen]
    q_ref = scene.q_wb[np.asarray(kf_indices)[ref[:L]]]
    p_ref = scene.p_wb[np.asarray(kf_indices)[ref[:L]]]
    R_cw = _np_quat_to_mat(_np_quat_conj(q_ref))
    y = np.einsum("lij,lj->li", R_cw, pts - p_ref)
    inv_depth = np.ones(T_cap)
    inv_depth[:L] = 1.0 / y[:, 2]

    bg_est = np.zeros(3) if bg_est is None else np.asarray(bg_est)
    ba_est = np.zeros(3) if ba_est is None else np.asarray(ba_est)
    delta = _win.empty_delta(F_cap, dtype, dev)
    dvalid = np.zeros(F_cap, dtype=bool)
    for j in range(1, nkf):
        t0 = scene.frame_t[kf_indices[j - 1]]
        t1 = scene.frame_t[kf_indices[j]]
        sel = (scene.imu_t >= t0) & (scene.imu_t < t1)
        n = min(int(sel.sum()), imu_cap)
        ts_p = np.zeros(imu_cap)
        ws_p = np.zeros((imu_cap, 3))
        as_p = np.zeros((imu_cap, 3))
        m_p = np.zeros(imu_cap, dtype=bool)
        ts_p[:n] = scene.imu_t[sel][:n]
        ws_p[:n] = scene.gyro[sel][:n]
        as_p[:n] = scene.accel[sel][:n]
        m_p[:n] = True
        d = _pre.preintegrate(t(ts_p), t(ws_p), t(as_p), t(m_p, torch.bool), t(t1),
                              t(bg_est), t(ba_est), noise)
        for field, val in zip(_pre.PreintDelta._fields, d):
            getattr(delta, field)[j] = val
        dvalid[j] = True

    fm = np.zeros(F_cap, dtype=bool)
    fm[:nkf] = True
    q = np.tile([1.0, 0, 0, 0], (F_cap, 1))
    p = np.zeros((F_cap, 3))
    v = np.zeros((F_cap, 3))
    q[:nkf] = scene.q_wb[kf_indices]
    p[:nkf] = scene.p_wb[kf_indices]
    v[:nkf] = scene.v_wb[kf_indices]
    flags = np.where(np.arange(T_cap) < L, _win.TF_VALID, 0)
    fix = np.zeros(F_cap, dtype=bool)
    fix[0] = True
    w = _win.empty_window(F_cap, T_cap, P_cap, dtype, dev)._replace(
        q=t(q), p=t(p), v=t(v),
        bg=t(np.tile(bg_est, (F_cap, 1))), ba=t(np.tile(ba_est, (F_cap, 1))),
        frame_mask=t(fm, torch.bool), fix_mask=t(fix, torch.bool),
        delta=delta, delta_valid=t(dvalid, torch.bool),
        bg_lin=t(np.tile(bg_est, (F_cap, 1))), ba_lin=t(np.tile(ba_est, (F_cap, 1))),
        inv_depth=t(inv_depth), ref_frame=t(ref, torch.int64),
        track_mask=t(np.arange(T_cap) < L, torch.bool),
        track_flags=t(flags, torch.int64),
        kp=t(kp_grid), obs_mask=t(obs, torch.bool),
    )
    extr = _win.Extrinsics.identity(dtype, dev)
    return w, extr, {"n_frames": nkf, "n_tracks": L, "chosen": chosen}


def flag_plane_tracks(w, scene, info, plane_index=0, slot=0):
    """Mark the window tracks on scene plane `plane_index` as TF_PLANE
    members of plane `slot` and install the true plane parameters.
    Returns (window, number of members)."""
    chosen = np.asarray(info["chosen"])
    on_plane = scene.plane_of_point[chosen] == plane_index
    T = w.inv_depth.shape[0]
    onp = np.zeros(T, bool)
    onp[: len(chosen)] = on_plane
    dev = w.p.device
    onp_t = torch.as_tensor(onp, device=dev)
    flags = torch.where(onp_t, torch.full_like(w.track_flags, _win.TF_PLANE | _win.TF_VALID),
                        w.track_flags)
    pid = torch.where(onp_t, torch.full_like(w.plane_id, slot), w.plane_id)
    normal = w.plane_normal.clone()
    normal[slot] = torch.as_tensor(scene.plane_normals[plane_index], dtype=w.p.dtype, device=dev)
    dist = w.plane_distance.clone()
    dist[slot] = float(scene.plane_distances[plane_index])
    pmask = w.plane_mask.clone()
    pmask[slot] = True
    return w._replace(track_flags=flags, plane_id=pid, plane_normal=normal,
                      plane_distance=dist, plane_mask=pmask), int(onp.sum())


def write_asl_dataset(scene: SyntheticScene, outdir, K, image_size,
                      q_bc=None, p_bc=None, distortion=None,
                      distortion_model=None, progress=False):
    """Serialize a synthetic scene to an on-disk ASL/EuRoC directory:

        <outdir>/mav0/cam0/data.csv + data/<ns>.png   (DISTORTED renders —
                                                       what the sensor records;
                                                       the reader undistorts)
        <outdir>/mav0/imu0/data.csv
        <outdir>/mav0/state_groundtruth_estimate0/data.csv

    This closes the loop the reference validates through real datasets
    (euroc_dataset_reader.cpp:21-104 parses exactly these files): the
    written directory is consumed by ``euroc://<outdir>`` through the
    native C++ loader, exercising CSV parsing, PNG decode, undistortion,
    and the full engine + output writer from disk. Timestamps are
    nanosecond integers as in ASL.
    """
    import sys as _sys

    from PIL import Image

    outdir = Path(outdir)
    cam = outdir / "mav0" / "cam0"
    imu = outdir / "mav0" / "imu0"
    gt = outdir / "mav0" / "state_groundtruth_estimate0"
    (cam / "data").mkdir(parents=True, exist_ok=True)
    imu.mkdir(parents=True, exist_ok=True)
    gt.mkdir(parents=True, exist_ok=True)

    with open(imu / "data.csv", "w") as f:
        f.write("#timestamp [ns],w_RS_S_x [rad s^-1],w_RS_S_y [rad s^-1],"
                "w_RS_S_z [rad s^-1],a_RS_S_x [m s^-2],a_RS_S_y [m s^-2],"
                "a_RS_S_z [m s^-2]\n")
        for i, t in enumerate(scene.imu_t):
            w, a = scene.gyro[i], scene.accel[i]
            row = [w[0], w[1], w[2], a[0], a[1], a[2]]
            f.write(f"{int(round(t * 1e9))},"
                    + ",".join(repr(float(x)) for x in row) + "\n")

    with open(gt / "data.csv", "w") as f:
        f.write("#timestamp [ns],p_RS_R_x [m],p_RS_R_y [m],p_RS_R_z [m],"
                "q_RS_w [],q_RS_x [],q_RS_y [],q_RS_z [],"
                "v_RS_R_x [m s^-1],v_RS_R_y [m s^-1],v_RS_R_z [m s^-1]\n")
        for i, t in enumerate(scene.frame_t):
            p, q, v = scene.p_wb[i], scene.q_wb[i], scene.v_wb[i]
            row = [p[0], p[1], p[2], q[0], q[1], q[2], q[3], v[0], v[1], v[2]]
            f.write(f"{int(round(t * 1e9))},"
                    + ",".join(repr(float(x)) for x in row) + "\n")

    with open(cam / "data.csv", "w") as f:
        f.write("#timestamp [ns],filename\n")
        for i, t in enumerate(scene.frame_t):
            ns = int(round(t * 1e9))
            name = f"{ns}.png"
            img = render_frame_room(
                scene, i, K, image_size, q_bc=q_bc, p_bc=p_bc,
                distortion=distortion, distortion_model=distortion_model)
            u8 = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
            Image.fromarray(u8, mode="L").save(cam / "data" / name)
            f.write(f"{ns},{name}\n")
            if progress and (i + 1) % 20 == 0:
                print(f"  wrote frame {i + 1}/{len(scene.frame_t)}",
                      file=_sys.stderr)
    return outdir


def load_asl_groundtruth(outdir):
    """Read back the ground-truth CSV written by write_asl_dataset:
    (t (N,) s, p (N, 3), q (N, 4) wxyz)."""
    import csv as _csv

    path = Path(outdir) / "mav0" / "state_groundtruth_estimate0" / "data.csv"
    ts, ps, qs = [], [], []
    with open(path) as f:
        for row in _csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            ts.append(int(row[0]) * 1e-9)
            ps.append([float(v) for v in row[1:4]])
            qs.append([float(v) for v in row[4:8]])
    return np.asarray(ts), np.asarray(ps), np.asarray(qs)

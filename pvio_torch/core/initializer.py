"""Visual-inertial initialization: SfM bootstrap + IMU alignment.

Matches `pvio_tpu/core/initializer.py`: `Initializer` (`try_initialize`,
`_mirror`, `_init_sfm`, `_set_camera_pose`, `_pnp_frame`,
`_triangulate_all`, `_attach_deltas`, `_pack_imu`, `_preintegrate_np`,
`_imu_pose`, `_cam_pose`, `_init_imu`) and `_from_two_vectors`:

  * mirror `sliding_window_size` keyframes at `initializer_keyframe_gap`
    from the raw tracking window, splicing the in-between IMU samples;
  * SfM: parallax/match gates, homography AND essential RANSAC, the 8
    (R, T) candidates chosen under the gyro rotation prior, PnP for the
    middle frames, triangulation, vision-only BA, prune;
  * IMU: gyro-bias least squares, the linear gravity/scale/velocity solve,
    gravity refinement on the S^2 tangent, the scale gates, gravity
    alignment and re-triangulation, the landmark gate;
  * a final visual-inertial BA with the first pose fixed.

The RANSACs, triangulation, PnP and BA run on the engine's device; the
small least-squares solves stay numpy at float64 on host values fetched
from the engine, as in the reference. The two-view geometry (RANSACs,
decompositions, hypothesis selection) runs in float64 whatever the
engine's dtype, where the reference runs it at the engine's. The RANSAC
keys come from the port's bit-exact `threefry.PRNGKey(config.random_seed)`
/ `split` stream, restarted by every new Initializer.
"""

import numpy as np
import torch

from pvio_torch.core.host_window import HostWindow
from pvio_torch.frontend import ransac as ransac_mod
from pvio_torch.geometry import essential as ess
from pvio_torch.geometry import homography as hom
from pvio_torch.geometry import nplie, triangulation
from pvio_torch.imu.preintegration import GRAVITY_NOMINAL, PreintDelta, fit_span
from pvio_torch.map.window import TF_VALID
from pvio_torch.utils import threefry, transfer


def _q_np(x):
    return np.asarray(x, float)


def _quat_mul(a, b):
    return nplie.quat_mul(a, b)


def _quat_conj(q):
    return q * np.array([1.0, -1, -1, -1])


def _rotate(q, v):
    return nplie.quat_to_mat(q) @ np.asarray(v, float)


def _from_two_vectors(a, b):
    """Quaternion rotating a onto b (Eigen FromTwoVectors)."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    c = np.cross(a, b)
    d = np.dot(a, b)
    if d < -1.0 + 1e-12:
        axis = nplie.s2_tangential_basis(a)[:, 0]
        return np.concatenate([[0.0], axis])
    q = np.concatenate([[1.0 + d], c])
    return q / np.linalg.norm(q)


class Initializer:
    def __init__(self, config, kernels):
        self.cfg = config
        self.k = kernels
        self._key = threefry.PRNGKey(config.random_seed)
        # last gate that rejected an initialization attempt: (stage, value)
        # or None after a successful attempt
        self.failure = None

    def _next_key(self):
        self._key, sub = threefry.split(self._key)
        return sub

    def _t(self, *arrays):
        """Host arrays as engine tensors, in one upload."""
        return transfer.upload(arrays, self.k.device, self.k.dtype)

    # ------------------------------------------------------------------
    def try_initialize(self, raw_frames):
        """Attempt initialization from the raw tracking window. Returns a
        ready HostWindow (all frames keyframes, states aligned to gravity)
        or None."""
        cfg = self.cfg
        gap = cfg.initializer_keyframe_gap
        n_kf = cfg.sliding_window_size
        distance = gap * (n_kf - 1)
        if len(raw_frames) < distance + 1:
            return None
        last = len(raw_frames) - 1
        indices = [last - distance + i * gap for i in range(n_kf)]

        hw = self._mirror(raw_frames, indices)
        if hw is None:
            return None
        if not self._init_sfm(hw):
            return None
        if not self._init_imu(hw):
            return None

        # final full visual-inertial BA, first pose fixed
        hw.fix_mask[:] = False
        hw.fix_mask[0] = True
        w = hw.to_device()
        w = self._attach_deltas(w, hw)
        w, info = self.k.ba_vi(w)
        hw.from_device(w)
        hw.keyframe[: hw.n_frames] = True
        return hw

    # ------------------------------------------------------------------
    def _mirror(self, raw_frames, indices):
        cfg = self.cfg
        hw = HostWindow(cfg.window_frame_capacity, cfg.track_capacity, cfg.plane_capacity,
                        np.float32 if cfg.dtype == "float32" else np.float64, self.k.device)
        K = cfg.K
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

        frames = [raw_frames[i] for i in indices]
        for j, rf in enumerate(frames):
            if j == 0:
                imu = (np.zeros(0), np.zeros((0, 3)), np.zeros((0, 3)))
            else:
                # splice IMU of raw frames (indices[j-1], indices[j]]
                ts, ws, accs = [], [], []
                for i in range(indices[j - 1] + 1, indices[j] + 1):
                    ts.append(raw_frames[i].imu_ts)
                    ws.append(raw_frames[i].imu_w)
                    accs.append(raw_frames[i].imu_a)
                imu = (np.concatenate(ts), np.concatenate(ws), np.concatenate(accs))
            hw.append_frame(rf.id, rf.t, [1.0, 0, 0, 0], np.zeros(3), np.zeros(3),
                            np.zeros(3), np.zeros(3), *imu)

        # link tracks between consecutive mirrored keyframes
        for j in range(1, len(frames)):
            fi, fj = frames[j - 1], frames[j]
            ids_j = {int(t): k for k, t in enumerate(fj.track_ids)
                     if fj.kp_mask[k] and t >= 0}
            for ki, tid in enumerate(fi.track_ids):
                if not fi.kp_mask[ki] or tid < 0:
                    continue
                kj = ids_j.get(int(tid))
                if kj is None:
                    continue
                col = hw.column_of(tid)
                if col is None:
                    col = hw.alloc_column(tid, j - 1)
                    if col is None:
                        continue
                zi = np.array([(fi.kp[ki, 0] - cx) / fx, (fi.kp[ki, 1] - cy) / fy])
                zj = np.array([(fj.kp[kj, 0] - cx) / fx, (fj.kp[kj, 1] - cy) / fy])
                if not hw.obs_mask[j - 1, col]:
                    hw.add_observation(col, j - 1, zi)
                hw.add_observation(col, j, zj)
        return hw

    # ------------------------------------------------------------------
    def _init_sfm(self, hw: HostWindow):
        cfg = self.cfg
        n = hw.n_frames
        fx = cfg.K[0, 0]

        # matches between first and last keyframe
        cols = np.nonzero(hw.obs_mask[0] & hw.obs_mask[n - 1] & hw.track_mask)[0]
        if len(cols) < cfg.initializer_min_matches:
            self.failure = ("sfm_matches", len(cols))
            return False
        x1 = hw.kp[0, cols]
        x2 = hw.kp[n - 1, cols]
        parallax = np.mean(np.linalg.norm((x1 - x2), axis=-1)) * 0.5 * (
            cfg.K[0, 0] + cfg.K[1, 1])
        if parallax < cfg.initializer_min_parallax:
            self.failure = ("sfm_parallax", float(parallax))
            return False

        # pad to the track capacity (fixed shapes, as in the reference)
        N = cfg.track_capacity
        x1p = np.zeros((N, 2), hw.dtype)
        x2p = np.zeros((N, 2), hw.dtype)
        mp = np.zeros(N, bool)
        x1p[: len(cols)] = x1
        x2p[: len(cols)] = x2
        mp[: len(cols)] = True
        # the two-view geometry (RANSACs, decompositions, hypothesis
        # selection) in float64 whatever the engine's dtype: in float32 its
        # Gram-matrix eigh and degree-10 root scan turned rounding into
        # device-dependent initializations (fault F4: the `synthetic` CLI's
        # scale 0.23 on the card against 0.90 on the CPU)
        x1j, x2j, mj = transfer.upload((x1p, x2p, mp), self.k.device, torch.float64)
        thr = 0.7 / fx

        H, _, _ = ransac_mod.find_homography(self._next_key(), x1j, x2j, mj, threshold=thr)
        RsH, TsH, _, pure_rot = hom.decompose_homography(H)
        if bool(pure_rot):
            self.failure = ("sfm_pure_rotation", None)
            return False
        E, _, _ = ransac_mod.find_essential(self._next_key(), x1j, x2j, mj, threshold=thr)
        RE1, RE2, TE = ess.decompose_essential(E)

        def nrm(t):
            return t / torch.clamp(torch.linalg.norm(t), min=1e-12)

        Rs = torch.stack([RsH[0], RsH[0], RsH[1], RsH[1], RE1, RE1, RE2, RE2])
        Ts = torch.stack([nrm(TsH[0]), -nrm(TsH[0]), nrm(TsH[1]), -nrm(TsH[1]),
                          nrm(TE), -nrm(TE), nrm(TE), -nrm(TE)])
        # gyro rotation prior across the whole first->last span, mapped to
        # the camera frame: conj(q_ic^-1 (x) dq_body(0->n-1) (x) q_ic)
        delta_rot, dval = self._preintegrate_np(hw, np.zeros(3), np.zeros(3))
        dq_body = np.array([1.0, 0, 0, 0])
        for j in range(1, n):
            if dval[j]:
                dq_body = _quat_mul(dq_body, np.asarray(delta_rot.q[j]))
        q_ic = _quat_mul(_quat_conj(_q_np(cfg.q_bi)), _q_np(cfg.q_bc))
        q_cam = _quat_mul(_quat_mul(_quat_conj(q_ic), dq_body), q_ic)
        (R_prior,) = transfer.upload((nplie.quat_to_mat(_quat_conj(q_cam)),), self.k.device,
                                     torch.float64)

        # hypothesis selection over the padded match set (masked points
        # have zero coords and do not triangulate)
        best, pts, status, count = triangulation.select_rt_hypothesis(
            Rs, Ts, x1j, x2j, count_threshold=cfg.initializer_min_triangulation,
            R_prior=R_prior, prior_max_angle=np.deg2rad(10.0))
        best, pts, status, Rs_h, Ts_h = transfer.get((best, pts, status, Rs, Ts))
        status = status & mp
        if int(status.sum()) < cfg.initializer_min_triangulation:
            self.failure = ("sfm_triangulation", int(status.sum()))
            return False
        R = Rs_h[int(best)]
        T = Ts_h[int(best)]

        # camera poses: frame0 = identity, frameN-1 = (R^T, -R^T T)
        self._set_camera_pose(hw, 0, np.array([1.0, 0, 0, 0]), np.zeros(3))
        q_j = nplie.mat_to_quat(R.T)
        self._set_camera_pose(hw, n - 1, q_j, -R.T @ T)

        # triangulated landmarks: inv depth in frame-0 camera (= z)
        for k in np.nonzero(status)[0]:
            col = cols[k]
            z = pts[k, 2]
            if z <= 1e-6:
                continue
            # only tracks whose reference is frame 0 keep this depth
            if hw.ref_frame[col] == 0:
                hw.inv_depth[col] = 1.0 / z
                hw.track_flags[col] |= TF_VALID

        # middle frames via vision-only PnP
        for j in range(1, n - 1):
            self._pnp_frame(hw, j, use_inertial=False, init_from=j - 1)

        # triangulate everything else + vision-only BA with pose-0 fixed
        self._triangulate_all(hw)
        hw.fix_mask[:] = False
        hw.fix_mask[0] = True
        w = hw.to_device()
        w, info = self.k.ba_vo(w)
        hw.from_device(w)

        # prune: invalid or quality > 1.0
        for c in np.nonzero(hw.track_mask)[0]:
            if not (hw.track_flags[c] & TF_VALID) or hw.quality[c] > 1.0:
                hw.track_flags[c] &= ~TF_VALID
        return True

    def _set_camera_pose(self, hw, slot, q_wc, p_wc):
        """Body pose from a camera pose: q_wb = q_wc q_bc^-1,
        p_wb = p_wc - q_wb p_bc."""
        q_bc = _q_np(self.cfg.q_bc)
        p_bc = _q_np(self.cfg.p_bc)
        q_wb = _quat_mul(q_wc, _quat_conj(q_bc))
        q_wb /= np.linalg.norm(q_wb)
        hw.q[slot] = q_wb
        hw.p[slot] = p_wc - _rotate(q_wb, p_bc)

    def _pnp_frame(self, hw, slot, use_inertial, init_from):
        w = hw.to_device()
        x_world = transfer.get(self.k.landmarks(w))
        valid = (hw.track_flags & TF_VALID).astype(bool) & hw.track_mask
        obs = hw.obs_mask[slot] & valid
        if obs.sum() < 4:
            hw.q[slot] = hw.q[init_from]
            hw.p[slot] = hw.p[init_from]
            return
        q0, p0, zeros3, xw, z, m = self._t(hw.q[init_from], hw.p[init_from],
                                           np.zeros(3, hw.dtype), x_world, hw.kp[slot], obs)
        dummy_delta = PreintDelta(*(a[0] for a in w.delta))
        q, p, v, bg, ba = self.k.pnp_vo(q0, p0, zeros3, zeros3, zeros3,
                                        q0, p0, zeros3, zeros3, zeros3,
                                        dummy_delta, zeros3, zeros3, xw, z, m)
        q, p = transfer.get((q, p))
        hw.q[slot] = q
        hw.p[slot] = p

    def _triangulate_all(self, hw):
        w = hw.to_device()
        inv_d, ok = transfer.get(self.k.triangulate_tracks(w))
        for c in np.nonzero(hw.track_mask & ok)[0]:
            hw.inv_depth[c] = inv_d[c]
            hw.track_flags[c] |= TF_VALID
        for c in np.nonzero(hw.track_mask & ~ok)[0]:
            hw.track_flags[c] &= ~TF_VALID
        return int((hw.track_flags & TF_VALID).astype(bool).sum())

    # ------------------------------------------------------------------
    def _attach_deltas(self, w, hw: HostWindow):
        ts, ws, accs, mask, t_frames = self._pack_imu(hw)
        return self.k.attach_deltas(w, ts, ws, accs, mask, t_frames)

    def _pack_imu(self, hw: HostWindow):
        # mirrored init keyframes splice `keyframe_gap` inter-frame spans
        # each, so use the window-grid capacity with integral-preserving
        # downsampling, never truncation
        F = hw.F
        N = self.cfg.window_imu_capacity
        ts = np.zeros((F, N))
        ws = np.zeros((F, N, 3))
        accs = np.zeros((F, N, 3))
        mask = np.zeros((F, N), bool)
        for j in range(F):
            if hw.imu_ts[j] is None or len(hw.imu_ts[j]) == 0:
                continue
            tj, wj, aj = hw.imu_ts[j], hw.imu_w[j], hw.imu_a[j]
            if len(tj) > N:
                tj, wj, aj = fit_span(tj, wj, aj, hw.frame_t[j], N)
            n = len(tj)
            ts[j, :n] = tj
            ws[j, :n] = wj
            accs[j, :n] = aj
            mask[j, :n] = True
        return tuple(self._t(ts, ws, accs, mask, hw.frame_t))

    def _preintegrate_np(self, hw, bg, ba):
        """Per-interval deltas at fixed (bg, ba) -> host numpy tuple."""
        w = hw.to_device()
        bg_t, ba_t = self._t(np.tile(bg, (hw.F, 1)), np.tile(ba, (hw.F, 1)))
        w = self._attach_deltas(w._replace(bg=bg_t, ba=ba_t), hw)
        return transfer.get((w.delta, w.delta_valid))

    def _imu_pose(self, hw, i):
        """IMU-sensor pose of frame i."""
        q_bi = _q_np(self.cfg.q_bi)
        p_bi = _q_np(self.cfg.p_bi)
        q = _quat_mul(hw.q[i], q_bi)
        p = hw.p[i] + _rotate(hw.q[i], p_bi)
        return q, p

    def _cam_pose(self, hw, i):
        q_bc = _q_np(self.cfg.q_bc)
        p_bc = _q_np(self.cfg.p_bc)
        q = _quat_mul(hw.q[i], q_bc)
        p = hw.p[i] + _rotate(hw.q[i], p_bc)
        return q, p

    def _init_imu(self, hw: HostWindow):
        cfg = self.cfg
        n = hw.n_frames
        bg = np.zeros(3)
        ba = np.zeros(3)

        # --- solve gyro bias ---
        delta, dvalid = self._preintegrate_np(hw, bg, ba)
        A = np.zeros((3, 3))
        b = np.zeros(3)
        for j in range(1, n):
            qi, _ = self._imu_pose(hw, j - 1)
            qj, _ = self._imu_pose(hw, j)
            dq = delta.q[j]
            dq_dbg = delta.dq_dbg[j]
            r = nplie.logmap(_quat_mul(_quat_conj(_quat_mul(qi, dq)), qj))
            A += dq_dbg.T @ dq_dbg
            b += dq_dbg.T @ r
        bg = np.linalg.lstsq(A, b, rcond=None)[0]

        # --- gravity / scale / velocity linear solve ---
        delta, dvalid = self._preintegrate_np(hw, bg, ba)
        A = np.zeros(((n - 1) * 6, 3 + 1 + 3 * n))
        rhs = np.zeros((n - 1) * 6)
        for j in range(1, n):
            i = j - 1
            dt = float(delta.t[j])
            qci, pci = self._cam_pose(hw, i)
            qcj, pcj = self._cam_pose(hw, j)
            qii, _ = self._imu_pose(hw, i)
            p_bc = _q_np(cfg.p_bc)
            A[i * 6: i * 6 + 3, 0:3] = -0.5 * dt * dt * np.eye(3)
            A[i * 6: i * 6 + 3, 3] = pcj - pci
            A[i * 6: i * 6 + 3, 4 + i * 3: 7 + i * 3] = -dt * np.eye(3)
            rhs[i * 6: i * 6 + 3] = _rotate(qii, delta.p[j]) + (
                _rotate(hw.q[j], p_bc) - _rotate(hw.q[i], p_bc))
            A[i * 6 + 3: i * 6 + 6, 0:3] = -dt * np.eye(3)
            A[i * 6 + 3: i * 6 + 6, 4 + i * 3: 7 + i * 3] = -np.eye(3)
            A[i * 6 + 3: i * 6 + 6, 4 + j * 3: 7 + j * 3] = np.eye(3)
            rhs[i * 6 + 3: i * 6 + 6] = _rotate(qii, delta.v[j])
        x = np.linalg.lstsq(A, rhs, rcond=None)[0]
        gravity = x[0:3] / max(np.linalg.norm(x[0:3]), 1e-12) * GRAVITY_NOMINAL
        scale = x[3]
        velocities = x[4:].reshape(n, 3).copy()
        if scale < 0.001 or scale > cfg.initializer_max_scale:
            self.failure = ("imu_scale", float(scale))
            return False

        # --- refine with fixed |g| on the S^2 tangent (8 damped steps) ---
        refine_iters = 8 if cfg.initializer_refine_imu else 0
        for _ in range(refine_iters):
            damp = 0.5
            Tg = nplie.s2_tangential_basis(gravity / np.linalg.norm(gravity))
            A2 = np.zeros(((n - 1) * 6, 2 + 1 + 3 * n))
            r2 = np.zeros((n - 1) * 6)
            for j in range(1, n):
                i = j - 1
                dt = float(delta.t[j])
                qci, pci = self._cam_pose(hw, i)
                qcj, pcj = self._cam_pose(hw, j)
                qii, _ = self._imu_pose(hw, i)
                p_bc = _q_np(cfg.p_bc)
                A2[i * 6: i * 6 + 3, 0:2] = -0.5 * dt * dt * Tg
                A2[i * 6: i * 6 + 3, 2] = pcj - pci
                A2[i * 6: i * 6 + 3, 3 + i * 3: 6 + i * 3] = -dt * np.eye(3)
                r2[i * 6: i * 6 + 3] = 0.5 * dt * dt * gravity + _rotate(qii, delta.p[j]) + (
                    _rotate(hw.q[j], p_bc) - _rotate(hw.q[i], p_bc))
                A2[i * 6 + 3: i * 6 + 6, 0:2] = -dt * Tg
                A2[i * 6 + 3: i * 6 + 6, 3 + i * 3: 6 + i * 3] = -np.eye(3)
                A2[i * 6 + 3: i * 6 + 6, 3 + j * 3: 6 + j * 3] = np.eye(3)
                r2[i * 6 + 3: i * 6 + 6] = dt * gravity + _rotate(qii, delta.v[j])
            x2 = np.linalg.lstsq(A2, r2, rcond=None)[0]
            dg = x2[0:2]
            gravity = gravity + damp * (Tg @ dg)
            gravity = gravity / np.linalg.norm(gravity) * GRAVITY_NOMINAL
            scale = x2[2]
            velocities = x2[3:].reshape(n, 3).copy()
        if refine_iters and (scale < 0.001 or scale > cfg.initializer_max_scale):
            self.failure = ("imu_scale_refined", float(scale))
            return False

        # --- apply: gravity-align + scale + velocities ---
        q_align = _from_two_vectors(gravity, np.array([0.0, 0.0, -GRAVITY_NOMINAL]))
        q_bi = _q_np(cfg.q_bi)
        p_bi = _q_np(cfg.p_bi)
        for i in range(n):
            qi, pi = self._imu_pose(hw, i)
            qi_new = _quat_mul(q_align, qi)
            qi_new /= np.linalg.norm(qi_new)
            pi_new = scale * _rotate(q_align, pi)
            q_wb = _quat_mul(qi_new, _quat_conj(q_bi))
            q_wb /= np.linalg.norm(q_wb)
            hw.q[i] = q_wb
            hw.p[i] = pi_new - _rotate(q_wb, p_bi)
            hw.v[i] = _rotate(q_align, velocities[i])
            hw.bg[i] = bg
            hw.ba[i] = 0.0
        n_landmarks = self._triangulate_all(hw)
        if n_landmarks < cfg.initializer_min_landmarks:
            self.failure = ("imu_landmarks", int(n_landmarks))
            return False
        self.failure = None
        return True

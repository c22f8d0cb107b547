"""Device steps of the VIO pipeline on PyTorch.

Matches `pvio_tpu/core/kernels.py`'s `DeviceKernels`: the solver configs
(`ba_cfg`, `ba_cfg_vo`, `pnp_cfg`, `pnp_cfg_vo`), the frontend
(`preprocess`, `track`, `fransac`, `predict_kp`, `remove_k`,
`first_frame_step`, `frame_step`, `frame_step_nodetect`), the IMU and
solver steps (`integrate_deltas`, `attach_deltas`, `predict_state`,
`pnp_vi`, `pnp_vo`, `ba_vi`, `ba_vo`, `marginalize0`, `initial_prior`,
`triangulate_tracks`, `landmarks`, `plane_points`), the fused per-frame
`pnp_step` and the keyframe steps (`ba_step`, `marg_step`, `kf_step`,
`kf_step_chained`), plus `pad_imu_host`, `pad_imu` and `integrate_one`.
`DeviceKernels.get`, the reference's cache of compiled callables, has no
counterpart: eager PyTorch compiles nothing per config.

The engine runs on one device. `DeviceKernels(cfg)` means CUDA and raises
when CUDA is absent; the CPU is used only when the caller passes
`device="cpu"` (the parity tests). The dtype follows `cfg.dtype`. On a
CUDA device the corner response is kernel K1 (`ops/stencil.py`); there is
no fallback to the plain version there. As in the reference, the BA takes
the struct-of-arrays preintegration bank (`estimation/preint_soa.py`) off
the CPU and the batched analytic Jacobians on it (`kernels.py:116`).

Python arguments select code as the reference's static arguments do:
`make_prior` and `do_marg` are Python bools; `slot` is an int or a 0-d
tensor. The keyframe steps take the window on the device and the other
inputs as numpy arrays or tensors on any device.
"""

import numpy as np
import torch
from torch.func import vmap

from pvio_torch.estimation import ba as ba_mod
from pvio_torch.estimation import marginalization as marg_mod
from pvio_torch.estimation import pnp as pnp_mod
from pvio_torch.estimation.factors import plane_cast_point
from pvio_torch.frontend import detect as detect_mod
from pvio_torch.frontend import image as image_mod
from pvio_torch.frontend import klt as klt_mod
from pvio_torch.frontend import ransac as ransac_mod
from pvio_torch.geometry import camera, lie
from pvio_torch.imu import preintegration as pre
from pvio_torch.map import window as win
from pvio_torch.ops import eigh as eigh_op
from pvio_torch.ops import stencil
from pvio_torch.utils import transfer

_PYRAMID_LEVELS = 2      # 3 images: full, /2, /4 (kernels.py:145-149)


def resolve_device(device=None):
    """`None` means CUDA, which must exist; anything else is taken as
    given. Also pins full-precision float32 matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("pvio_torch: CUDA is not available; pass "
                               "device='cpu' to run on the CPU explicitly")
        device = "cuda"
    return torch.device(device)


class DeviceKernels:
    """The per-frame device steps, built once per engine with the static
    shapes and constants of a Config."""

    def __init__(self, cfg, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            eigh_op.check_window(cfg.window_frame_capacity)
        if cfg.dtype not in ("float32", "float64"):
            raise ValueError(f"unsupported Config.dtype {cfg.dtype!r}")
        self.dtype = torch.float32 if cfg.dtype == "float32" else torch.float64
        dt, dev = self.dtype, self.device

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float64), dtype=dt, device=dev)

        self.extr = win.Extrinsics(q_bc=t(cfg.q_bc), p_bc=t(cfg.p_bc),
                                   q_bi=t(cfg.q_bi), p_bi=t(cfg.p_bi))
        self.K = t(cfg.K)
        self.noise = pre.ImuNoise(cov_w=t(cfg.imu_cov_g), cov_a=t(cfg.imu_cov_a),
                                  cov_bg=t(cfg.imu_cov_bg), cov_ba=t(cfg.imu_cov_ba))
        self.ba_cfg = ba_mod.BAConfig(
            iterations=cfg.solver_iteration_limit,
            kp_sqrt_inv_cov=cfg.kp_sqrt_inv_cov,
            plane_sqrt_inv_cov=float(1.0 / np.sqrt(cfg.plane_distance_cov)),
            min_plane_tracks=cfg.plane_min_tracks,
            use_inertial=True,
            use_planes=cfg.enable_plane_constraint,
            estimate_planes=bool(getattr(cfg, "plane_estimate_in_solver", True)),
            plane_supplement=bool(getattr(cfg, "plane_supplement", False)),
            cauchy_scale=float(getattr(cfg, "cauchy_scale", 1.0)),
            fused_preint=(self.device.type != "cpu"),
        )
        self.ba_cfg_vo = self.ba_cfg._replace(use_inertial=False, use_planes=False)
        self.pnp_cfg = pnp_mod.PnPConfig(
            iterations=cfg.solver_iteration_limit,
            kp_sqrt_inv_cov=cfg.kp_sqrt_inv_cov,
            use_inertial=True,
            cauchy_scale=float(getattr(cfg, "cauchy_scale", 1.0)),
        )
        self.pnp_cfg_vo = self.pnp_cfg._replace(use_inertial=False)
        self.fb_px = float(getattr(cfg, "feature_tracker_fb_threshold", 0.0))
        self.assoc = bool(getattr(cfg, "preint_assoc", True))

    # ------------------------------------------------------------------
    def _to(self, x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def preprocess(self, img):
        """uint8 (or float) (H, W) -> 3-image pyramid (CLAHE or min-max
        normalized level 0)."""
        img = self._to(img)
        if img.dtype == torch.uint8:
            img = img.to(self.dtype) * transfer.constant(1.0 / 255.0, self.dtype, self.device)
        else:
            img = img.to(self.dtype)
        img = image_mod.clahe(img) if self.cfg.feature_tracker_clahe else image_mod.normalize(img)
        return tuple(image_mod.build_pyramid(img, _PYRAMID_LEVELS))

    def response_of(self, img0):
        """Corner response of the level-0 image: kernel K1 on CUDA, the
        plain version on the CPU. CLAHE crops its tile-padded result, so
        level 0 is a strided view unless the tiles divide the image."""
        return stencil.shi_tomasi_response(img0.contiguous())

    def detect(self, img0, existing, existing_mask, response):
        return detect_mod.detect_keypoints(
            img0,
            max_keypoints=self.cfg.feature_tracker_max_keypoint_detection,
            min_distance=self.cfg.feature_tracker_min_keypoint_distance,
            existing_xy=existing, existing_mask=existing_mask,
            border=20, response=response)

    def track(self, pyr_prev, pyr_next, kp, guess, mask):
        """Pyramidal KLT with the per-patch trackability gate. Returns
        (kp_next, status)."""
        return klt_mod.track_keypoints(list(pyr_prev), list(pyr_next), self._to(kp, self.dtype),
                                       self._to(guess, self.dtype), self._to(mask, torch.bool),
                                       border=20.0, fb_threshold=self.fb_px)

    def fransac(self, key_data, kp1, kp2, mask):
        """F-RANSAC inlier mask and count; key_data (2,) uint32."""
        _, inl, count = ransac_mod.find_fundamental(
            key_data, self._to(kp1, self.dtype), self._to(kp2, self.dtype),
            self._to(mask, torch.bool), threshold=1.0)
        return inl, count

    def remove_k(self, kp):
        return camera.remove_k(self._to(kp, self.dtype), self.K)

    def predict_kp(self, kp, mask, dq_cam):
        """Gyro-predicted keypoints: rotate each bearing by the inter-frame
        camera rotation dq_cam (4,)."""
        z = camera.remove_k(kp, self.K)
        b = torch.cat([z, torch.ones_like(z[..., :1])], dim=-1)
        b2 = lie.quat_rotate(lie.quat_conj(dq_cam)[None, :], b)
        zs = torch.where(torch.abs(b2[..., 2:3]) < 1e-6,
                         torch.full_like(b2[..., 2:3], 1e-6), b2[..., 2:3])
        out = camera.apply_k(b2[..., :2] / zs, self.K)
        return torch.where(mask[:, None], out, kp)

    def first_frame_step(self, img):
        """Preprocess + detection. Returns (pyr, resp, det_kp, det_mask)."""
        pyr = self.preprocess(img)
        resp = self.response_of(pyr[0])
        det_kp, det_mask = self.detect(
            pyr[0], torch.zeros((1, 2), dtype=self.dtype, device=self.device),
            torch.zeros(1, dtype=torch.bool, device=self.device), resp)
        return pyr, resp, det_kp, det_mask

    def frame_step(self, pyr_prev, resp_prev, img_next, kp_prev, mask_prev,
                   dq_cam, key_data, with_detect=True):
        """Fused per-frame frontend: preprocess, corner response,
        gyro-predicted pyramidal KLT, F-RANSAC gate, detection and the
        keypoint merge. key_data: (2,) uint32 threefry key data.

        Returns (pyr_next, resp_next, kp_merged, mask_merged, status,
        det_mask): tracked keypoints stay in their rows, free rows take the
        fresh detections in ascending-row order."""
        cfg = self.cfg
        kp_prev = self._to(kp_prev, self.dtype)
        mask_prev = self._to(mask_prev, torch.bool)
        dq_cam = self._to(dq_cam, self.dtype)
        pyr_next = self.preprocess(img_next)
        resp_next = self.response_of(pyr_next[0])
        guess = (self.predict_kp(kp_prev, mask_prev, dq_cam)
                 if cfg.feature_tracker_predict_keypoints else kp_prev)
        kp_new, status = klt_mod.track_keypoints(
            list(pyr_prev), list(pyr_next), kp_prev, guess, mask_prev,
            resp_prev, resp_next, border=20.0, fb_threshold=self.fb_px)
        # fundamental-matrix gate, applied with >= 8 survivors and inliers
        _, inl, count = ransac_mod.find_fundamental(
            key_data, kp_prev, kp_new, status, threshold=1.0)
        gate_on = (torch.sum(status) >= 8) & (count >= 8)
        status = torch.where(gate_on, status & inl, status)
        Kmax = kp_new.shape[0]
        kp_kept = torch.where(status[:, None], kp_new, torch.zeros_like(kp_new))
        if not with_detect:
            return (pyr_next, resp_next, kp_kept, status, status,
                    torch.zeros(Kmax, dtype=torch.bool, device=self.device))
        det_kp, det_mask = self.detect(pyr_next[0], kp_new, status, resp_next)
        kp_merged, mask_merged = _merge(kp_kept, status, det_kp, det_mask)
        return pyr_next, resp_next, kp_merged, mask_merged, status, det_mask

    def frame_step_nodetect(self, pyr_prev, resp_prev, img_next, kp_prev,
                            mask_prev, dq_cam, key_data):
        """`frame_step` without detection: det_mask all false."""
        return self.frame_step(pyr_prev, resp_prev, img_next, kp_prev, mask_prev,
                               dq_cam, key_data, with_detect=False)

    # ------------------------------------------------------------------
    def plane_points(self, w, x_world):
        """Replace plane-track landmarks with their plane ray-casts, unless
        the ray is within 20 degrees of parallel to the plane or casts
        behind the camera."""
        extr = self.extr
        P = w.plane_mask.shape[0]
        T = w.kp.shape[1]
        pid = torch.clamp(w.plane_id, 0, P - 1)
        is_plane = ((w.track_flags & win.TF_PLANE) != 0) & (w.plane_id >= 0)
        q_ref = w.q[w.ref_frame]
        p_ref = w.p[w.ref_frame]
        q_wc = lie.quat_mul(q_ref, extr.q_bc.expand_as(q_ref))
        o = p_ref + lie.quat_rotate(q_ref, extr.p_bc.expand_as(p_ref))
        z_ref = w.kp[w.ref_frame, torch.arange(T, device=w.kp.device)]
        bearing = lie.quat_rotate(q_wc, torch.cat([z_ref, torch.ones_like(z_ref[:, :1])], dim=-1))
        n = w.plane_normal[pid]
        cast = plane_cast_point(n, w.plane_distance[pid], o, bearing)
        denom = torch.sum(n * bearing, dim=-1)
        not_par = torch.abs(denom) >= (torch.linalg.norm(bearing, dim=-1)
                                       * float(np.sin(np.deg2rad(20.0))))
        s_ray = torch.sum((cast - o) * bearing, dim=-1)
        use_cast = is_plane & not_par & (s_ray > 0)
        return torch.where(use_cast[:, None], cast, x_world)

    def pnp_step(self, w, tp, wp, ap, mp, t_new, tail_idx, z_obs, pnp_mask,
                 obs_new, kf_idx):
        """Fused per-frame motion step: preintegrate the tail -> new IMU span
        at the tail's bias, predict, form landmarks (plane tracks
        ray-cast), motion-only VI PnP, virtual-view triangulation of fresh
        tracks and the rotation-compensated 80th-percentile parallax
        against keyframe kf_idx. Returns (q1, p1, v1, bg1, ba1, delta_q,
        inv_d, tri_ok, p80, n_common)."""
        cfg, extr, dt = self.cfg, self.extr, self.dtype
        tp, wp, ap = (self._to(x, dt) for x in (tp, wp, ap))
        mp = self._to(mp, torch.bool)
        z_obs = self._to(z_obs, dt)
        pnp_mask = self._to(pnp_mask, torch.bool)
        obs_new = self._to(obs_new, torch.bool)
        tail_q, tail_p, tail_v, tail_bg, tail_ba = (_row(a, tail_idx)
                                                    for a in (w.q, w.p, w.v, w.bg, w.ba))
        delta = pre.preintegrate(tp, wp, ap, mp, t_new, tail_bg, tail_ba,
                                 self.noise, assoc=self.assoc)
        q0, p0, v0, bg0, ba0 = pre.predict(delta, tail_q, tail_p, tail_v, tail_bg, tail_ba)
        x_world = win.landmark_points(w, extr)
        if cfg.enable_plane_constraint and bool(getattr(cfg, "pnp_use_plane_points", True)):
            x_world = self.plane_points(w, x_world)
        q1, p1, v1, bg1, ba1 = pnp_mod.solve_pnp(
            q0, p0, v0, bg0, ba0, tail_q, tail_p, tail_v, tail_bg, tail_ba,
            delta, tail_bg, tail_ba, x_world, z_obs, pnp_mask, extr, self.pnp_cfg)
        inv_d, tri_ok = win.triangulate_tracks_virtual(w, extr, q1, p1, z_obs, obs_new)
        # keyframe statistic: camera rotation tail -> new through extrinsics
        qm, qc = lie.quat_mul, lie.quat_conj
        qij = qc(qm(qm(qm(qc(extr.q_bc), extr.q_bi), delta.q),
                    qm(qc(extr.q_bi), extr.q_bc)))
        zi = _row(w.kp, kf_idx)
        b2 = lie.quat_rotate(qij[None, :], torch.cat([zi, torch.ones_like(zi[:, :1])], dim=-1))
        zsafe = torch.where(torch.abs(b2[..., 2:3]) < 1e-6,
                            torch.full_like(b2[..., 2:3], 1e-6), b2[..., 2:3])
        pi = b2[..., :2] / zsafe
        f = torch.stack([self.K[0, 0], self.K[1, 1]])
        par = torch.linalg.norm((pi - z_obs) * f, dim=-1)
        common = (_row(w.obs_mask, kf_idx) & _row(w.frame_mask, kf_idx) & obs_new
                  & (torch.abs(b2[..., 2]) >= 1e-6))
        n_common = torch.sum(common)
        vals, _ = torch.sort(torch.where(common, par, torch.full_like(par, torch.inf)))
        idx = torch.clamp(n_common * 4 // 5, 0, par.shape[0] - 1)
        p80 = torch.where(n_common > 0, _row(vals, idx), torch.full_like(vals[0], torch.inf))
        return q1, p1, v1, bg1, ba1, delta.q, inv_d, tri_ok, p80, n_common

    # ------------------------------------------------------------------
    # IMU, solver and keyframe steps

    def _imu(self, ts, ws, accs, mask):
        dt = self.dtype
        return self._to(ts, dt), self._to(ws, dt), self._to(accs, dt), self._to(mask, torch.bool)

    def integrate_deltas(self, ts, ws, accs, mask, t_target, bg_prev, ba_prev):
        """Batched preintegration of F padded buffers (F, N): slot j's delta
        spans frame j-1 -> j, linearized at frame j-1's bias."""
        ts, ws, accs, mask = self._imu(ts, ws, accs, mask)
        t_target = self._to(t_target, self.dtype)
        noise, assoc = self.noise, self.assoc
        return vmap(lambda t_, w_, a_, m_, tt, bg, ba_: pre.preintegrate(
            t_, w_, a_, m_, tt, bg, ba_, noise, assoc=assoc))(
            ts, ws, accs, mask, t_target, bg_prev, ba_prev)

    def attach_deltas(self, w, ts, ws, accs, mask, t_frames):
        """Re-integrate every frame interval at the previous frame's current
        bias and attach the deltas to the window."""
        bg_prev = torch.cat([w.bg[:1], w.bg[:-1]], dim=0)
        ba_prev = torch.cat([w.ba[:1], w.ba[:-1]], dim=0)
        mask = self._to(mask, torch.bool)
        deltas = self.integrate_deltas(ts, ws, accs, mask, t_frames, bg_prev, ba_prev)
        prev_mask = torch.cat([torch.zeros_like(w.frame_mask[:1]), w.frame_mask[:-1]])
        valid = torch.any(mask, dim=-1) & w.frame_mask & prev_mask
        return w._replace(delta=deltas, delta_valid=valid, bg_lin=bg_prev, ba_lin=ba_prev)

    def predict_state(self, delta, q, p, v, bg, ba):
        return pre.predict(delta, q, p, v, bg, ba)

    def _pnp(self, cfg, q0, p0, v0, bg0, ba0, lq, lp, lv, lbg, lba, delta, bg_lin, ba_lin,
             x_world, z_obs, obs_mask):
        return pnp_mod.solve_pnp(q0, p0, v0, bg0, ba0, lq, lp, lv, lbg, lba, delta, bg_lin,
                                 ba_lin, x_world, self._to(z_obs, self.dtype),
                                 self._to(obs_mask, torch.bool), self.extr, cfg)

    def pnp_vi(self, *args):
        """Motion-only visual-inertial PnP (arguments of `solve_pnp` without
        extr and cfg)."""
        return self._pnp(self.pnp_cfg, *args)

    def pnp_vo(self, *args):
        """Motion-only vision-only PnP."""
        return self._pnp(self.pnp_cfg_vo, *args)

    def _ba(self, w, cfg):
        w2, info = ba_mod.solve(w, self.extr, cfg)
        return ba_mod.post_solve_update(w2, self.extr, self.K), info

    def ba_vi(self, w):
        """Visual-inertial BA (planes as configured) + post-solve update."""
        return self._ba(w, self.ba_cfg)

    def ba_vo(self, w):
        """Vision-only BA without planes + post-solve update."""
        return self._ba(w, self.ba_cfg_vo)

    def marginalize0(self, w):
        """Re-base the tracks off slot 0, then marginalize it."""
        w = marg_mod.rebase_tracks(w, self.extr, removed_slot=0)
        return marg_mod.marginalize_and_remove(w, self.extr, self.ba_cfg, index=0)

    def initial_prior(self, w):
        return marg_mod.make_initial_prior(w)

    def triangulate_tracks(self, w):
        """Multi-view DLT of every track column. Returns (inv_depth, ok)."""
        _, inv_d, ok = win.triangulate_tracks(w, self.extr)
        return inv_d, ok

    def landmarks(self, w):
        return win.landmark_points(w, self.extr)

    def _escape(self, w2, track_life):
        """The plane-track escape with the config's thresholds, as host
        floats."""
        cfg = self.cfg
        gate_k = float(getattr(cfg, "plane_sigma_gate_k", 3.0))
        sigma_px = float(np.sqrt(np.mean(np.diag(np.asarray(cfg.camera_noise_cov)))))
        f_px = 0.5 * (float(cfg.camera_intrinsic[0]) + float(cfg.camera_intrinsic[1]))
        return ba_mod.plane_track_escape(
            w2, self.extr, track_life,
            min_life=int(getattr(cfg, "plane_escape_min_life", 10)),
            escape_dist=float(getattr(cfg, "plane_escape_distance", 0.1)),
            kp_sigma_px=sigma_px if gate_k > 0 else None,
            f_px=f_px if gate_k > 0 else None,
            sigma_k=gate_k,
            dist_floor=float(getattr(cfg, "plane_sigma_gate_floor", 0.005)))

    def _fresh_geometry(self, w2):
        """Post-solve multi-view triangulations, baselines and the landmark
        cloud that ride the keyframe's fetch."""
        tri_pts, tri_inv_d, tri_ok = win.triangulate_tracks(w2, self.extr)
        baseline = win.track_baselines(w2)
        return win.landmark_points(w2, self.extr), (tri_pts, tri_inv_d, tri_ok, baseline)

    def ba_step(self, w, ts, ws, accs, mask, t_frames, track_life, make_prior):
        """Fused keyframe solve: optionally the initial prior, re-integrated
        deltas, the visual-inertial BA, the plane-track escape, the
        post-solve update and fresh geometry. Returns (w2, info, landmarks,
        (tri_pts, tri_inv_d, tri_ok, baseline))."""
        if make_prior:
            w = w._replace(prior=marg_mod.make_initial_prior(w))
        w = self.attach_deltas(w, ts, ws, accs, mask, t_frames)
        w2, info = ba_mod.solve(w, self.extr, self.ba_cfg)
        if self.cfg.enable_plane_constraint:
            w2 = self._escape(w2, self._to(track_life))
        w2 = ba_mod.post_solve_update(w2, self.extr, self.K)
        xw, tri = self._fresh_geometry(w2)
        return w2, info, xw, tri

    def marg_step(self, w, ts, ws, accs, mask, t_frames):
        """Fused marginalization: attach deltas, re-base the tracks off the
        oldest slot, Schur-eliminate it into the prior, compact the slots."""
        return self.marginalize0(self.attach_deltas(w, ts, ws, accs, mask, t_frames))

    def kf_step(self, w, ts, ws, accs, mask, t_frames, ts2, ws2, accs2, mask2, t_frames2,
                nf_q, nf_p, nf_v, nf_bg, nf_ba, nf_kp, nf_obs, tri_depth, tri_mask,
                track_life, slot, make_prior, do_marg):
        """The whole keyframe: (with do_marg) marginalize the oldest frame on
        the pre-marginalization IMU grids (ts..t_frames), splice the new
        frame's state and observations into `slot`, adopt the triangulations
        under tri_mask, then `ba_step` on the post-append grids
        (ts2..t_frames2)."""
        dt, to = self.dtype, self._to
        if do_marg:
            w = self.marg_step(w, ts, ws, accs, mask, t_frames)
        nf_obs = to(nf_obs, torch.bool)
        tri_mask = to(tri_mask, torch.bool)

        def put(a, value):
            at_slot = torch.arange(a.shape[0], device=a.device) == slot
            return torch.where(at_slot.reshape(-1, *([1] * (a.dim() - 1))), value, a)

        w = w._replace(
            q=put(w.q, to(nf_q, dt)), p=put(w.p, to(nf_p, dt)), v=put(w.v, to(nf_v, dt)),
            bg=put(w.bg, to(nf_bg, dt)), ba=put(w.ba, to(nf_ba, dt)),
            frame_mask=put(w.frame_mask, True), fix_mask=put(w.fix_mask, False),
            kp=put(w.kp, torch.where(nf_obs[:, None], to(nf_kp, dt), _row(w.kp, slot))),
            obs_mask=put(w.obs_mask, nf_obs))
        w = w._replace(
            inv_depth=torch.where(tri_mask, to(tri_depth, dt), w.inv_depth),
            track_flags=torch.where(tri_mask, w.track_flags | win.TF_VALID, w.track_flags))
        return self.ba_step(w, ts2, ws2, accs2, mask2, t_frames2, track_life, make_prior)

    def kf_step_chained(self, w, ts, ws, accs, mask, t_frames, ts2, ws2, accs2, mask2,
                        t_frames2, nf_q, nf_p, nf_v, nf_bg, nf_ba, nf_kp, nf_obs, tri_depth,
                        tri_ok, tri_mask_host, track_life, slot, make_prior, do_marg):
        """`kf_step` on the motion step's device outputs (nf_q..nf_ba,
        tri_depth, tri_ok straight from `pnp_step`): the adoption mask is
        completed on the device, so the results equal `kf_step` fed host
        copies of the same values, bit for bit."""
        tri_mask = self._to(tri_mask_host, torch.bool) & tri_ok.to(torch.bool)
        return self.kf_step(w, ts, ws, accs, mask, t_frames, ts2, ws2, accs2, mask2, t_frames2,
                            nf_q, nf_p, nf_v, nf_bg, nf_ba, nf_kp, nf_obs, tri_depth, tri_mask,
                            track_life, slot, make_prior, do_marg)

    # ------------------------------------------------------------------
    def pad_imu_host(self, ts, ws, accs):
        """Pad raw IMU samples to the static buffer size (numpy)."""
        N = self.cfg.imu_buffer_capacity
        npdt = np.float32 if self.dtype == torch.float32 else np.float64
        n = min(len(ts), N)
        tp = np.zeros(N, npdt)
        wp = np.zeros((N, 3), npdt)
        ap = np.zeros((N, 3), npdt)
        mp = np.zeros(N, bool)
        tp[:n] = ts[:n]
        wp[:n] = ws[:n]
        ap[:n] = accs[:n]
        mp[:n] = True
        return tp, wp, ap, mp

    def pad_imu(self, ts, ws, accs):
        """`pad_imu_host` as tensors on the device."""
        tp, wp, ap, mp = self.pad_imu_host(ts, ws, accs)
        return self._imu(tp, wp, ap, mp)

    def integrate_one(self, ts, ws, accs, t_target, bg, ba):
        """Preintegrate a single interval of raw samples."""
        tp, wp, ap, mp = self.pad_imu(ts, ws, accs)
        dt = self.dtype
        return pre.preintegrate(tp, wp, ap, mp, self._to(t_target, dt), self._to(bg, dt),
                                self._to(ba, dt), self.noise, assoc=self.assoc)


def _row(x, i):
    """x[i] for an integer or a 0-d index tensor: indexing with a 0-d
    tensor reads it on the host, indexing with its (1,) view does not."""
    return x[i.reshape(1)][0] if isinstance(i, torch.Tensor) else x[i]


def _merge(kp_kept, status, det_kp, det_mask):
    """In-graph keypoint merge (`kernels.py:266-275`): free rows (status
    false), in ascending order, take the first min(#detections, #free)
    detections in detection order. Returns (kp_merged, mask_merged).

    The reference's `jnp.nonzero(size, fill_value)` is a stable sort that
    brings the True rows first, and its `.at[rows].set(mode="drop")` is a
    scatter into one extra sink row that is then cut off."""
    Kmax = status.shape[0]
    dev = status.device
    ar = torch.arange(Kmax, device=dev)
    n_fill = torch.minimum(torch.sum(det_mask), Kmax - torch.sum(status))
    free_idx = torch.sort((status).to(torch.int32), stable=True).indices
    det_idx = torch.sort((~det_mask).to(torch.int32), stable=True).indices
    det_idx = torch.where(ar < torch.sum(det_mask), det_idx, torch.full_like(det_idx, Kmax - 1))
    fill_rows = torch.where(ar < n_fill, free_idx, torch.full_like(free_idx, Kmax))
    kp_out = torch.cat([kp_kept, kp_kept.new_zeros(1, 2)], dim=0)
    kp_out[fill_rows] = det_kp[det_idx]
    mask_out = torch.cat([status, status.new_zeros(1)], dim=0)
    mask_out[fill_rows] = torch.ones_like(fill_rows, dtype=torch.bool)
    return kp_out[:Kmax], mask_out[:Kmax]

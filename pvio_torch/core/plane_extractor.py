"""Multi-plane detection, extension and merging: the paper's structural
prior, on the host window.

Matches `pvio_tpu/core/plane_extractor.py`: `_refine_plane_pca_np` and
`PlaneExtractor` (`_landmarks`, `_camera_centers`, `_baseline`, `_rpe`,
`_rpe_batch`, `detect`, `update_map`, `_promote`, `issue_detection`,
`store_pending_result`, `promote_pending`, `extend_planes`,
`_set_landmark`, `merge_planes`, `update_parameters` with both branches of
`plane_estimate_in_solver`, and `plane_track_points`). The bookkeeping is
host numpy, as in the reference, with the same formulas (`np.linalg.eigh`,
`np.median`, `np.maximum.at`, first-index `np.argmin` ties).

Only the 3-point RANSAC (`frontend/ransac.find_plane`) runs on the
kernels' device. Its key stream is the reference's: `PRNGKey(random_seed +
1)` split once per RANSAC issued (`utils/threefry.py`, bit-exact with
`jax.random`), so the port scores the very hypotheses the reference
scores. `issue_detection` dispatches it and returns the device (inliers,
count) without waiting; the sliding-window tracker folds them into the
keyframe step's packed fetch and hands the host values to
`store_pending_result`; `promote_pending` consumes them at the next
keyframe. `detect` / `update_map` and the refit of
`plane_estimate_in_solver=False` fetch synchronously, as in the
reference. The reference's compiled-callable cache has no counterpart:
eager PyTorch compiles nothing.
"""

import numpy as np

from pvio_torch.frontend import ransac as ransac_mod
from pvio_torch.geometry import nplie
from pvio_torch.map import sector_area as sa
from pvio_torch.map.window import TF_PLANE, TF_VALID
from pvio_torch.utils import threefry, transfer


def _refine_plane_pca_np(points, inlier_mask):
    """Host numpy mirror of ransac.refine_plane_pca
    (plane_extractor.cpp:63-76): normal = smallest-eigenvector of the
    inlier scatter. The result feeds host bookkeeping immediately, so
    computing it on device would cost a dispatch + fetch round trip per
    plane per keyframe. Returns (normal, distance, centroid)."""
    m = inlier_mask.astype(np.float64)[:, None]
    cnt = max(float(m.sum()), 1.0)
    pts = np.asarray(points, np.float64)
    c = (pts * m).sum(axis=0) / cnt
    d = (pts - c) * m
    cov = d.T @ d / cnt
    _, V = np.linalg.eigh(cov)
    n = V[:, 0]
    dist = float(n @ c)
    if dist < 0:
        n, dist = -n, -dist
    return n, dist, c


class PlaneExtractor:
    def __init__(self, config, kernels):
        self.cfg = config
        self.k = kernels
        self._key = threefry.PRNGKey(config.random_seed + 1)
        self.next_plane_id = 0
        self.areas = {}  # plane slot -> SectorArea (utility/sector_area.h role)
        self.threshold = float(getattr(config, "plane_ransac_threshold", 0.03))
        self.min_inliers = int(getattr(config, "plane_min_inliers", 30))
        # life >= 10 gate (plane_extractor.cpp:47); config knob so short
        # synthetic test scenes can lower it without silent deviations
        self.min_track_life = int(getattr(config, "plane_min_track_life", 10))
        self._pending = None  # in-flight async detection (issue_detection)

    def _next_key(self):
        self._key, sub = threefry.split(self._key)
        return sub

    def _find_plane(self, pts, mask, threshold):
        """Dispatch find_plane on the kernels' device: the points (in the
        engine dtype), the mask and the next key go up in ONE upload.
        Returns the device (inlier_mask, count), not awaited."""
        pts_d, mask_d, key_d = transfer.upload(
            [pts, mask, self._next_key()], self.k.device, self.k.dtype)
        return ransac_mod.find_plane(key_d, pts_d, mask_d, threshold=threshold)[2:]

    # ------------------------------------------------------------------
    def _landmarks(self, hw):
        """World-space landmark per track column — host numpy mirror of
        map.window.landmark_points (track.cpp:137-147). The plane
        bookkeeping calls this several times per keyframe; doing it on
        host costs microseconds where each device round trip would
        synchronise the host with the card."""
        q_bc = np.asarray(self.cfg.q_bc)
        p_bc = np.asarray(self.cfg.p_bc)
        T = hw.T
        z_ref = np.take_along_axis(hw.kp, hw.ref_frame[None, :, None], axis=0)[0]
        inv_d = np.where(np.abs(hw.inv_depth) < 1e-12, 1e-12, hw.inv_depth)
        y = np.concatenate([z_ref, np.ones((T, 1), hw.kp.dtype)], axis=-1)
        y = y / inv_d[:, None]
        y_body = nplie.quat_rotate(np.broadcast_to(q_bc, (T, 4)), y) + p_bc
        q_ref = hw.q[hw.ref_frame]
        p_ref = hw.p[hw.ref_frame]
        return nplie.quat_rotate(q_ref, y_body) + p_ref

    def _camera_centers(self, hw):
        p_bc = np.asarray(self.cfg.p_bc)
        return hw.p + nplie.quat_rotate(hw.q, np.tile(p_bc, (hw.F, 1)))

    def _baseline(self, hw, pts):
        """Per-track baseline: sum of body-position distances between
        consecutive observing frames (Track::compute_baseline,
        track.cpp:125-136). Slot order is time order."""
        F, T = hw.obs_mask.shape
        obs = hw.obs_mask & hw.frame_mask[:, None]
        idx = np.where(obs, np.arange(F)[:, None], -1)
        prev = np.maximum.accumulate(idx, axis=0)
        prev = np.concatenate([-np.ones((1, T), int), prev[:-1]], axis=0)
        seg = obs & (prev >= 0)
        d = np.linalg.norm(
            hw.p[:, None, :] - hw.p[np.clip(prev, 0, F - 1)], axis=-1)
        return (seg * d).sum(axis=0)

    def _rpe(self, hw, col, point):
        """Mean pixel reprojection error of `point` over the track's
        observations (plane_extractor.cpp:184-198). Scalar convenience
        wrapper over the batched kernel."""
        return float(self._rpe_batch(hw, np.asarray(point)[None, None, :],
                                     cols=np.array([col]))[0, 0])

    def _rpe_batch(self, hw, points, cols=None):
        """Batched compute_reprojection_error (plane_extractor.cpp:184-198):
        mean pixel reprojection error of candidate `points` (C, M, 3) over
        each track's observing frames. `cols` selects the C track columns
        (default: all T). Returns (C, M); +inf where a candidate point
        falls behind any observing camera or the track has no
        observations. One einsum over the whole (F, C, M) grid — no
        per-track/per-frame Python loops."""
        K = self.cfg.K
        fx, fy = K[0, 0], K[1, 1]
        q_bc = np.asarray(self.cfg.q_bc)
        p_bc = np.asarray(self.cfg.p_bc)
        F = hw.F
        R_wb = nplie.quat_to_mat(hw.q)                      # (F, 3, 3)
        R_wc = R_wb @ nplie.quat_to_mat(q_bc)[None]
        p_wc = hw.p + np.einsum("fij,j->fi", R_wb, p_bc)    # (F, 3)
        obs = (hw.obs_mask & hw.frame_mask[:, None])
        kp = hw.kp
        if cols is not None:
            obs = obs[:, cols]
            kp = kp[:, cols]
        pts = np.asarray(points, float)                     # (C, M, 3)
        d = pts[None] - p_wc[:, None, None, :]              # (F, C, M, 3)
        y = np.einsum("fji,fcmj->fcmi", R_wc, d)            # R_wc^T @ d
        z = y[..., 2]
        safe_z = np.where(np.abs(z) < 1e-12, 1e-12, z)
        ex = (y[..., 0] / safe_z - kp[..., 0][..., None]) * fx
        ey = (y[..., 1] / safe_z - kp[..., 1][..., None]) * fy
        err = np.hypot(ex, ey)                              # (F, C, M)
        om = np.broadcast_to(obs[..., None], err.shape)     # (F, C, M)
        cnt = om.sum(axis=0)                                # (C, M)
        mean = np.where(om, err, 0.0).sum(axis=0) / np.maximum(cnt, 1)
        bad = np.any(om & (z <= 1e-9), axis=0)
        return np.where(bad | (cnt == 0), np.inf, mean)

    # ------------------------------------------------------------------
    def detect(self, hw):
        """RANSAC plane detection over well-constrained landmarks; returns
        a detection record or None (PlaneExtractor::work)."""
        pts = self._landmarks(hw)
        is_valid = (hw.track_flags & TF_VALID).astype(bool)
        is_plane = (hw.track_flags & TF_PLANE).astype(bool)
        baseline = self._baseline(hw, pts)
        good = (
            hw.track_mask & is_valid & ~is_plane
            & (hw.track_life >= self.min_track_life) & (hw.quality < 2.0)
            & ((baseline > 0.5)
               | ((hw.inv_depth < 5.0) & (baseline * np.abs(hw.inv_depth) > 0.5)))
        )
        if good.sum() < self.min_inliers:
            return None
        inl, count = transfer.get(self._find_plane(pts, good, self.threshold))
        if int(count) <= self.min_inliers:
            return None
        inl = np.array(inl) & good
        n2, d2, cog = _refine_plane_pca_np(pts, inl)
        return {
            "normal": n2, "distance": d2,
            "reference_point": cog, "cols": np.nonzero(inl)[0],
        }

    def update_map(self, hw):
        """Detect and promote to a plane slot + flag member tracks
        (plane_extractor.cpp:83-104). Synchronous variant: one detection
        per keyframe."""
        rec = self.detect(hw)
        self._promote(hw, rec)

    def _promote(self, hw, rec):
        if rec is None:
            return
        free = np.nonzero(~hw.plane_mask)[0]
        if len(free) == 0:
            return
        slot = int(free[0])
        hw.plane_mask[slot] = True
        hw.plane_normal[slot] = rec["normal"]
        hw.plane_distance[slot] = rec["distance"]
        hw.plane_ids[slot] = self.next_plane_id
        self.next_plane_id += 1
        for c in rec["cols"]:
            hw.track_flags[c] |= TF_PLANE
            hw.plane_id[c] = slot
        # polar-sector extent of the new plane (update_sector_area role)
        basis = nplie.s2_tangential_basis(rec["normal"])
        pts = self._landmarks(hw)[rec["cols"]]
        self.areas[slot] = sa.insert(
            sa.SectorArea.empty(rec["reference_point"], basis), pts)

    # ------------------------------------------------------------------
    # asynchronous detection (the reference's PlaneExtractor is a worker:
    # issue_extraction schedules RANSAC off the tracking thread,
    # plane_extractor.cpp:106-110; update_map consumes the finished
    # record at a later keyframe). Here: the RANSAC dispatch is issued
    # fire-and-forget at keyframe k, its outputs ride the SOLVER's batched
    # device->host fetch, and the record is promoted at keyframe k+1 —
    # zero extra synchronization points.
    # ------------------------------------------------------------------
    def issue_detection(self, hw):
        """Host gating + device RANSAC dispatch, NO fetch. Returns device
        outputs to fold into the caller's batched fetch (or None)."""
        self._pending = None
        pts = self._landmarks(hw)
        is_valid = (hw.track_flags & TF_VALID).astype(bool)
        is_plane = (hw.track_flags & TF_PLANE).astype(bool)
        baseline = self._baseline(hw, pts)
        good = (
            hw.track_mask & is_valid & ~is_plane
            & (hw.track_life >= self.min_track_life) & (hw.quality < 2.0)
            & ((baseline > 0.5)
               | ((hw.inv_depth < 5.0) & (baseline * np.abs(hw.inv_depth) > 0.5)))
        )
        if good.sum() < self.min_inliers:
            return None
        out = self._find_plane(pts, good, self.threshold)
        self._pending = {"pts": pts, "good": good,
                         "track_id": hw.track_id.copy()}
        return out

    def store_pending_result(self, fetched):
        """Record the (inliers, count) fetched by the caller's batched
        device->host round trip."""
        if self._pending is not None and fetched is not None:
            inl, count = fetched
            self._pending["inl"] = np.array(inl)
            self._pending["count"] = int(count)

    def promote_pending(self, hw):
        """Promote the previous keyframe's detection (update_map role).
        Columns recycled to a different track since issue time are
        dropped (the reference's worker snapshot is protected by the map
        lock; here track-id matching provides the same guarantee)."""
        p, self._pending = self._pending, None
        if p is None or "inl" not in p or p["count"] <= self.min_inliers:
            return
        inl = (p["inl"] & p["good"] & hw.track_mask
               & (hw.track_id == p["track_id"])
               & ((hw.track_flags & TF_PLANE) == 0))
        if inl.sum() <= self.min_inliers:
            return
        n2, d2, cog = _refine_plane_pca_np(p["pts"], inl)
        self._promote(hw, {
            "normal": n2, "distance": d2,
            "reference_point": cog, "cols": np.nonzero(inl)[0],
        })

    # ------------------------------------------------------------------
    def extend_planes(self, hw, extend_rpe_ratio=1.2):
        """Adopt VALID tracks onto planes by ray-casting
        (plane_extractor.cpp:112-161). Fully vectorized over the
        (tracks x planes) grid: ray-cast, parallel/cheirality gates and
        batched reprojection errors are numpy array ops; only the final
        per-adopted-track bookkeeping loops (a handful per keyframe)."""
        slots = np.nonzero(hw.plane_mask)[0]
        if len(slots) == 0:
            return
        pts = self._landmarks(hw)
        q_bc = np.asarray(self.cfg.q_bc)
        p_bc = np.asarray(self.cfg.p_bc)
        flags = hw.track_flags
        cand = hw.track_mask & ((flags & TF_VALID) != 0) & ((flags & TF_PLANE) == 0)
        cols = np.nonzero(cand)[0]
        if len(cols) == 0:
            return
        C, P = len(cols), len(slots)
        ref = hw.ref_frame[cols]
        R_ref = nplie.quat_to_mat(hw.q[ref])                 # (C, 3, 3)
        R_wc = R_ref @ nplie.quat_to_mat(q_bc)[None]
        o = hw.p[ref] + np.einsum("cij,j->ci", R_ref, p_bc)  # (C, 3)
        kp_ref = hw.kp[ref, cols]                            # (C, 2)
        bearing = np.einsum(
            "cij,cj->ci", R_wc,
            np.concatenate([kp_ref, np.ones((C, 1))], axis=-1))
        n = hw.plane_normal[slots]                           # (P, 3)
        dist = hw.plane_distance[slots]                      # (P,)
        # per-plane common-mode offset of the CURRENT member landmarks
        # (see ba.plane_track_escape): with the plane held as a
        # slowly-varying world anchor, the window drifts relative to it;
        # candidates live in the window frame, so cast and test against
        # the drift-compensated plane d + median member offset
        med = np.zeros(len(slots))
        for j, sl in enumerate(slots):
            mm = ((hw.plane_id == sl) & hw.track_mask
                  & ((hw.track_flags & TF_PLANE) != 0))
            if mm.any():
                med[j] = np.median(pts[mm] @ n[j] - dist[j])
        dist = dist + med
        denom = bearing @ n.T                                # (C, P)
        # is_parallel gate: ray within ~20 deg of the plane
        not_parallel = (np.abs(denom)
                        >= np.linalg.norm(bearing, axis=-1, keepdims=True)
                        * np.sin(np.deg2rad(20)))
        safe_denom = np.where(np.abs(denom) < 1e-12, 1e-12, denom)
        s_len = (dist[None, :] - o @ n.T) / safe_denom       # (C, P)
        cast = o[:, None, :] + s_len[..., None] * bearing[:, None, :]  # (C, P, 3)
        # cheirality in the reference camera
        y = np.einsum("cji,cpj->cpi", R_wc, cast - o[:, None, :])
        valid = not_parallel & (y[..., 2] >= 0)              # (C, P)
        rpe_before = self._rpe_batch(hw, pts[cols, None, :], cols=cols)[:, 0]
        rpe_after = np.where(valid,
                             self._rpe_batch(hw, cast, cols=cols), np.inf)
        # noise-aware adoption: the reference's ratio gate
        # (rpe_after/rpe_before < 1.2, plane_extractor.cpp:131-140)
        # accepts near-anything once both errors are noise-dominated —
        # measured as the main plane contamination path on degraded
        # imagery. rpe_after and rpe_before share the SAME observations,
        # so their squared difference cancels most of the keypoint noise
        # and isolates the geometric displacement of casting onto the
        # plane: adopt when that displacement is within half the
        # declared keypoint sigma (camera.noise config), or the absolute
        # error is small outright. At the default sigma (~0.7 px) this
        # is as permissive as the reference's gates on clean imagery.
        sigma = float(np.sqrt(np.mean(np.diag(
            np.asarray(self.cfg.camera_noise_cov)))))
        with np.errstate(invalid="ignore", divide="ignore"):
            chi_ok = (rpe_after ** 2
                      <= rpe_before[:, None] ** 2 + (0.5 * sigma) ** 2)
            abs_ok = rpe_after < max(0.5, 0.7 * sigma)
            passes = chi_ok | abs_ok
        passes &= valid
        # evidence gate: the off-plane test below compares the candidate's
        # free triangulation against the plane — meaningful only when that
        # triangulation actually explains the observations. During
        # transient window inconsistency free points scatter 0.2+ m and
        # the rpe gates become noise-dominated coin flips (the measured
        # adoption-contamination path); refuse to adopt on junk evidence.
        passes &= (rpe_before <= max(2.0 * sigma, 1.0))[:, None]
        # statistical point-to-plane test (the escape gate's symmetric
        # counterpart, ba.plane_track_escape): the candidate's CURRENT
        # (BA-optimized) triangulation must lie within sigma_k plane-
        # distance standard deviations of the plane, where sigma_plane
        # follows from the declared keypoint sigma, the track's depth and
        # its baseline. Rejects confidently-off-plane tracks that the rpe
        # gates cannot see (their rpe displacement is noise-dominated),
        # while leaving genuinely depth-uncertain tracks adoptable —
        # those are the ones the structural prior helps.
        gate_k = float(getattr(self.cfg, "plane_sigma_gate_k", 3.0))
        if gate_k > 0:
            K = self.cfg.K
            f_px = float(0.5 * (K[0, 0] + K[1, 1]))
            z = 1.0 / np.maximum(np.abs(hw.inv_depth[cols]), 1e-6)
            b_dir = bearing / np.linalg.norm(bearing, axis=-1, keepdims=True)
            base_c = self._baseline(hw, pts)[cols]
            ang = sigma / f_px
            sig_z = ang * z * z / np.maximum(base_c, 1e-3)
            sig_lat = ang * z
            c2 = (b_dir @ n.T) ** 2                       # (C, P)
            # NO multi-view averaging reduction here (unlike the escape
            # gate): the model omits pose and plane-fit error, so the
            # 1/sqrt(n_obs-1) factor over-tightens the threshold for
            # well-observed candidates and starved adoption on clean
            # scenes (round-3 regression, verified by bisection)
            sigma_pl = np.sqrt(
                c2 * sig_z[:, None] ** 2
                + (1.0 - c2) * sig_lat[:, None] ** 2)
            thresh = np.minimum(
                float(getattr(self.cfg, "plane_escape_distance", 0.1)),
                np.maximum(float(getattr(self.cfg, "plane_sigma_gate_floor",
                                         0.005)),
                           gate_k * sigma_pl))
            off = np.abs(pts[cols] @ n.T - dist[None, :])  # (C, P)
            passes &= off <= thresh
        # polar-sector near-boundary gate, batched per plane
        # (plane_extractor.cpp:131-140, sector_area.h:57-118)
        near = np.zeros((C, P), bool)
        for j, s in enumerate(slots):
            area = self.areas.get(int(s))
            if area is None:
                continue
            m = passes[:, j]
            if m.any():
                near[m, j] = sa.is_near_boundary_batch(
                    area, cast[m, j], True, 1.2, 0.1)
        eligible = passes & near
        adopted = eligible.any(axis=1)
        # best plane = lowest rpe among the planes that PASSED the gates
        # (argmin over all planes could select a gate-failing one)
        rpe_gated = np.where(eligible, rpe_after, np.inf)
        best_j = np.argmin(rpe_gated, axis=1)                # (C,)
        best_ok = np.isfinite(rpe_gated[np.arange(C), best_j])
        for i in np.nonzero(adopted & best_ok)[0]:
            c = int(cols[i])
            j = int(best_j[i])
            s_best = int(slots[j])
            hw.track_flags[c] |= TF_PLANE
            hw.plane_id[c] = s_best
            # NOTE: the triangulated inverse depth is deliberately KEPT
            # (the reference overwrites the landmark with the cast point,
            # plane_extractor.cpp:141-145 — but every downstream consumer
            # here re-derives plane geometry fresh: BA's augmented factor
            # triangulates implicitly, PnP ray-casts per frame
            # (kernels.plane_points), refits use post-solve
            # triangulations. Keeping the free-point depth preserves the
            # information the escape test and a small-plane reprojection
            # fallback need; overwriting it was measured as a
            # contamination path on degraded imagery, PERF_NOTES round 3.)
            if s_best in self.areas:
                self.areas[s_best] = sa.insert(
                    self.areas[s_best], cast[i, j][None])

    def _set_landmark(self, hw, col, point):
        """Re-express a world point as inverse depth in the reference
        frame (Track::set_landmark_point, track.cpp:137-147)."""
        ref = hw.ref_frame[col]
        q_bc = np.asarray(self.cfg.q_bc)
        p_bc = np.asarray(self.cfg.p_bc)
        q_wc = nplie.quat_mul(hw.q[ref], q_bc)
        o = hw.p[ref] + nplie.quat_to_mat(hw.q[ref]) @ p_bc
        y = nplie.quat_to_mat(q_wc).T @ (point - o)
        if y[2] > 1e-6:
            hw.inv_depth[col] = 1.0 / y[2]

    # ------------------------------------------------------------------
    def merge_planes(self, hw):
        """Merge near-coplanar overlapping planes
        (plane_extractor.cpp:163-182)."""
        pts = self._landmarks(hw)  # landmarks don't move during merging
        changed = True
        while changed:
            changed = False
            slots = list(np.nonzero(hw.plane_mask)[0])
            for ii in range(len(slots)):
                for jj in range(ii + 1, len(slots)):
                    i, j = slots[ii], slots[jj]
                    if abs(np.dot(hw.plane_normal[i], hw.plane_normal[j])) < 0.95:
                        continue
                    if abs(hw.plane_distance[i] - hw.plane_distance[j]) > 0.25:
                        continue
                    mi = (hw.plane_id == i) & hw.track_mask
                    mj = (hw.plane_id == j) & hw.track_mask
                    if mi.sum() == 0 or mj.sum() == 0:
                        overlap = 1.0
                    else:
                        # overlap: fraction of j's members within i's extent
                        pi = pts[mi]
                        spread = np.median(np.linalg.norm(pi - pi.mean(0), axis=-1)) + 1e-6
                        dj = np.linalg.norm(
                            pts[mj][:, None, :] - pi[None, :, :], axis=-1
                        ).min(axis=1)
                        overlap = float((dj < 2.0 * spread).mean())
                    if overlap > 0.3:
                        hw.plane_id[mj] = i
                        hw.plane_mask[j] = False
                        if i in self.areas and j in self.areas:
                            self.areas[i] = sa.merge(self.areas[i],
                                                     self.areas.pop(j))
                        else:
                            self.areas.pop(j, None)
                        changed = True
                        break
                if changed:
                    break

    def update_parameters(self, hw, fresh=None):
        """Re-fit each plane from FRESH triangulations of its mature
        member tracks (Plane::update_parameter, plane.cpp:64-114).

        The reference's refit evidence is strictly gated: member tracks
        are RE-TRIANGULATED from current poses (plane.cpp:70-71 — not
        their stored landmark, which for plane members is a point cast
        onto the old plane, i.e. circular evidence), must have
        enough_baseline and life >= 15, and the refit is SKIPPED entirely
        below 50 such points (plane.cpp:74). RANSAC threshold here is
        0.05 (looser than detection's 0.03, plane.cpp:76), and the PCA
        refinement only replaces the RANSAC plane at > 30 inliers.
        Violating any of these (round 2 refit: stale landmarks, >= 3
        points, no maturity gates) produced per-keyframe parameter jolts
        that spiked the next BA's initial cost ~1e6.

        fresh: optional (tri_pts (T, 3), tri_inv_d (T,), tri_ok (T,),
        baseline (T,)) from the solver fetch (kernels.ba_step). Without
        it, falls back to host triangulation-free landmarks (tests /
        legacy callers) under the same gates minus tri_ok.
        """
        if fresh is not None:
            pts_np, inv_d, tri_ok, baseline = [np.asarray(a) for a in fresh]
            ok = tri_ok.astype(bool)
        else:
            pts_np = self._landmarks(hw)
            inv_d = hw.inv_depth
            baseline = self._baseline(hw, pts_np)
            ok = np.ones(hw.T, bool)
        base_ok = ((baseline > 0.5)
                   | ((inv_d < 5.0) & (baseline * np.abs(inv_d) > 0.5)))
        well = ok & hw.track_mask & (hw.track_life >= 15) & base_ok
        # the gauge re-anchor (below) is a per-keyframe coordinate update,
        # not new-evidence gathering — it uses the plane's own membership
        # maturity gate rather than the stricter refit gate
        well_anchor = (ok & hw.track_mask & base_ok
                       & (hw.track_life >= self.min_track_life))
        in_solver = bool(getattr(self.cfg, "plane_estimate_in_solver", False))
        for s in np.nonzero(hw.plane_mask)[0]:
            m = (hw.plane_id == s) & well
            members = (hw.plane_id == s) & hw.track_mask
            if in_solver:
                # Re-anchor the plane to the CURRENT gauge. A VIO window
                # drifts in its unobservable directions (yaw +
                # translation); holding the plane at its detection-time
                # parameters (round-3 "world anchor") tilts/offsets it
                # relative to EVERYTHING in the current window — measured
                # as 0.1-0.4 m member off-plane spread after ~2 deg of
                # yaw drift, which mass-triggers escapes and starves
                # adoption. The reference avoids this by refitting the
                # plane from current landmarks every keyframe
                # (plane.cpp:64-114); we do the same, robustly, from the
                # FRESH post-solve triangulations. The in-solve anchor
                # prior still pins the plane WITHIN each solve (the
                # pose+plane null-drift guard) — it just follows the
                # gauge between solves.
                mf = members & well_anchor & ((hw.track_flags & TF_PLANE) != 0)
                if mf.sum() >= 8:
                    n0, d0 = hw.plane_normal[s], hw.plane_distance[s]
                    signed = pts_np[mf] @ n0 - d0
                    med = np.median(signed)
                    mad = np.median(np.abs(signed - med))
                    inl_loc = np.abs(signed - med) <= max(
                        3.0 * 1.4826 * mad, 0.03)
                    if inl_loc.sum() >= 8:
                        inl = np.zeros(hw.T, bool)
                        inl[np.nonzero(mf)[0][inl_loc]] = True
                        n2, d2, _ = _refine_plane_pca_np(pts_np, inl)
                        if n2 @ n0 < 0:
                            n2, d2 = -n2, -d2
                        if n2 @ n0 > 0.9:  # reject degenerate refits
                            hw.plane_normal[s] = n2
                            hw.plane_distance[s] = d2
                    # keep member bookkeeping in the current gauge too:
                    # in REPLACEMENT mode (reference semantics) the BA
                    # never refines member depths, so stored depths
                    # freeze at adoption and go stale as the gauge
                    # drifts — poisoning the per-frame PnP that uses
                    # them as fixed points. In supplement mode the BA
                    # owns member depths; overwriting them with fresh
                    # triangulations would discard the solve. Only the
                    # MAD inliers of the refit are refreshed: a member
                    # whose fresh triangulation just scattered off-plane
                    # keeps its stale-but-good stored depth (mirrors the
                    # escape path's never-overwrite-with-junk guard,
                    # estimation/ba.plane_track_escape).
                    if not bool(getattr(self.cfg, "plane_supplement", False)):
                        upd = np.nonzero(mf)[0][inl_loc]
                        hw.inv_depth[upd] = inv_d[upd]
                # the host maintains the polar extent from member points
                if members.sum() >= 3:
                    cog = pts_np[members].mean(axis=0)
                    basis = nplie.s2_tangential_basis(hw.plane_normal[s])
                    self.areas[s] = sa.insert(
                        sa.SectorArea.empty(np.array(cog), basis),
                        pts_np[members])
                continue
            if m.sum() < 50:
                continue  # plane.cpp:74 — no refit without strong evidence
            # refit RANSAC is looser than detection (0.05 vs 0.03,
            # plane.cpp:76 vs plane_extractor.cpp:56)
            inl = np.array(transfer.get(self._find_plane(pts_np, m, 0.05)[0])) & m
            if inl.sum() <= 30:
                continue
            n2, d2, cog = _refine_plane_pca_np(pts_np, inl)
            hw.plane_normal[s] = n2
            hw.plane_distance[s] = d2
            # rebuild + centralize the sector extent
            # (plane->sector_area.centralize(), sliding_window_tracker.cpp:131)
            basis = nplie.s2_tangential_basis(n2)
            # built directly at the member centroid — already centralized
            self.areas[s] = sa.insert(
                sa.SectorArea.empty(np.array(cog), basis), pts_np[members])

    # ------------------------------------------------------------------
    def plane_track_points(self, w_dev, x_world):
        """For PnP: replace plane-track landmarks with their best-plane
        ray-cast points (pnp.cpp:61-88). Delegates to the shared device
        step (DeviceKernels.plane_points, also fused into pnp_step)."""
        return self.k.plane_points(w_dev, x_world)

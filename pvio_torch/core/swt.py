"""Sliding-window tracker: the per-frame VIO state machine.

Matches `pvio_tpu/core/swt.py`: `SlidingWindowTracker` (`track`,
`track_dispatch`, `track_finish`, `_post_track`, `_keyframe_fused`, the
chained keyframe `_dispatch_keyframe_chained` / `_finish_keyframe_chained`,
`_imu_ops_post_append`, `_mirror_frame`, `_write_observations`,
`_keyframe_check`, `_apply_triangulation`, `_imu_ops_host`,
`_imu_ops_from`, `_marginalize_oldest`), `health_update` and
`pend_fetch_arrays`. For each issued frame: the fused motion step
(`pnp_step`: preintegrate + predict, motion-only PnP, fresh-track
triangulation, the keyframe statistic), the rotation-compensated keyframe
check; a keyframe marginalizes the oldest frame, appends and runs the
full BA (`marg_step` + `ba_step`, or the fused `kf_step`, or
`kf_step_chained` on the motion step's device outputs); a non-keyframe
merges its IMU span and replaces the window tail; then track pruning and
the landmark-starvation backstop. With a `plane_extractor`
(`core/plane_extractor.py`) each keyframe promotes the previous keyframe's
detection, extends the planes, issues a new detection whose device outputs
ride the keyframe step's fetch, then merges and refits the planes.

Each step makes ONE upload (`HostWindow.to_device` with extras) and ONE
packed copy back (`utils/transfer.Fetch`), started at dispatch time. The
host blocks where the reference does: `transfer.block` after `ba_step`
and `marg_step`, and the harvest of the motion step (plus the chained
keyframe) in `track_finish`.
"""

import numpy as np
import torch

from pvio_torch.core.host_window import HostWindow
from pvio_torch.imu.preintegration import fit_span
from pvio_torch.map.window import TF_PLANE, TF_VALID
from pvio_torch.utils import transfer
from pvio_torch.utils.forensics import bus as forensics


class SlidingWindowTracker:
    def __init__(self, config, kernels, host_window: HostWindow, feature_tracker,
                 plane_extractor=None):
        self.cfg = config
        self.k = kernels
        self.hw = host_window
        self.ft = feature_tracker
        self.planes = plane_extractor
        self.skipped_frames = 0
        self.n_keyframes = 0    # keyframe decisions made (test observability)
        self.unhealthy_keyframes = 0  # consecutive starved keyframes
        self.peak_valid = 0           # running peak landmark population
        self._fresh_tri = None  # post-solve triangulations from ba_step
        # (t, q, p, v, bg, ba) of the newest optimized frame, for predict_pose
        tail = self.hw.n_frames - 1
        self.latest_state = self._state_of(tail)

    def _state_of(self, slot):
        return (
            float(self.hw.frame_t[slot]), self.hw.q[slot].copy(),
            self.hw.p[slot].copy(), self.hw.v[slot].copy(),
            self.hw.bg[slot].copy(), self.hw.ba[slot].copy(),
        )

    # ------------------------------------------------------------------
    def track(self, raw_new):
        """Process one issued frame (sliding_window_tracker.cpp:75-135).
        Returns False on unrecoverable failure (triggers re-init,
        frontend_worker.cpp:71-77)."""
        pend = self.track_dispatch(raw_new)
        if pend is None:
            return False
        return self.track_finish(pend)

    def track_dispatch(self, raw_new):
        """First half of track(): host association + the fused motion-step
        device dispatch, with its device->host copies STARTED but not
        awaited. Returns a pending record for track_finish, or None on
        immediate failure. In pipelined mode the host runs the next
        frame's frontend while this transfer lands (the reference's
        worker-thread decoupling, utility/worker.h:25-78)."""
        cfg = self.cfg
        hw = self.hw
        tail = hw.n_frames - 1
        raw_tail = self.ft.frame_by_id(int(hw.frame_id[tail]))
        if raw_tail is None:
            return None  # "SWT cannot catch up" (feature_tracker.cpp:70-75)

        # --- mirror: link tracks between window tail and the new frame ---
        new_obs = self._mirror_frame(raw_tail, raw_new, tail)
        if len(new_obs) < 8:
            return None

        # --- fused motion step: preintegrate tail->new + predict + PnP +
        # fresh-track triangulation + keyframe statistic (pnp.cpp:32-100,
        # track.cpp:61-106, sliding_window_tracker.cpp:255-296) — ONE
        # upload, ONE dispatch, ONE (deferred) fetch ---
        imu_pad = self.k.pad_imu_host(raw_new.imu_ts, raw_new.imu_w, raw_new.imu_a)
        valid = ((hw.track_flags & (TF_VALID | TF_PLANE)) != 0) & hw.track_mask
        z_obs = np.zeros((hw.T, 2), hw.dtype)
        obs_mask = np.zeros(hw.T, bool)
        for col, z in new_obs:
            z_obs[col] = z
            obs_mask[col] = True
        pnp_mask = obs_mask & valid & hw.obs_mask[tail]
        # snapshot of the column identities the fused triangulation was
        # computed against: topology mutations below (drop_tail column
        # recycling, marginalization slot shifts) can re-bind a column to
        # a different track or move its reference frame, and applying the
        # stale result there would write another track's inverse depth
        tri_track_id = hw.track_id.copy()
        # reference identified by physical frame id (slot indices shift
        # when marginalization compacts the window)
        tri_ref_fid = hw.frame_id[hw.ref_frame].copy()
        kf_slots = np.nonzero(hw.keyframe & hw.frame_mask)[0]
        kf_idx = int(kf_slots[-1]) if len(kf_slots) else 0
        w_dev, ops = hw.to_device(extra=(
            *imu_pad, np.asarray(raw_new.t, hw.dtype), z_obs, pnp_mask, obs_mask))
        tp, wp, ap, mp, t_new, z_obs_d, pnp_mask_d, obs_new_d = ops
        pnp_out = self.k.pnp_step(
            w_dev, tp, wp, ap, mp, t_new, tail, z_obs_d, pnp_mask_d,
            obs_new_d, kf_idx)
        pend = dict(raw_new=raw_new, pnp_out=pnp_out, pnp_fetch=transfer.Fetch(pnp_out),
                    new_obs=new_obs,
                    tri_track_id=tri_track_id, tri_ref_fid=tri_ref_fid,
                    kf_slots=kf_slots)
        # chained keyframe (Config.chained_keyframe): when the tail is a
        # declared keyframe, dispatch the fused keyframe step NOW,
        # feeding it the motion step's device outputs directly — its
        # results ride the same deferred fetch as the motion step's, so
        # the keyframe costs no extra blocking round trip (VERDICT r4
        # item 8). The host bookkeeping moves to track_finish.
        if (bool(getattr(cfg, "chained_keyframe", False))
                and bool(getattr(cfg, "fused_keyframe", False))
                and bool(hw.keyframe[tail])
                and hw.n_frames <= cfg.window_frame_capacity):
            self._dispatch_keyframe_chained(pend)
        return pend

    def track_finish(self, pend, fetched=None):
        """Second half of track(): harvest the motion-step results and run
        the keyframe/window bookkeeping. Returns False on failure.
        `fetched`: optional pre-fetched host values of pend["pnp_out"]
        (lets the caller batch the fetch with other stages' results)."""
        if "kf" in pend:
            return self._finish_keyframe_chained(pend, fetched)
        cfg = self.cfg
        hw = self.hw
        raw_new = pend["raw_new"]
        new_obs = pend["new_obs"]
        tri_track_id = pend["tri_track_id"]
        tri_ref_fid = pend["tri_ref_fid"]
        kf_slots = pend["kf_slots"]
        tail = hw.n_frames - 1
        if fetched is None:
            fetched = transfer.get(pend["pnp_fetch"])
        (q1, p1, v1, bg1, ba1, delta_q, tri_inv_d, tri_ok, p80_px,
         n_common) = [np.array(a) for a in fetched]
        if not (np.isfinite(q1).all() and np.isfinite(p1).all()):
            return False

        # --- keyframe check (:255-296); statistics computed in-graph ---
        is_keyframe = self._keyframe_check(
            bool(len(kf_slots) == 0), float(p80_px), int(n_common))
        if is_keyframe:
            self.n_keyframes += 1

        tail_was_keyframe = bool(hw.keyframe[tail])
        if (tail_was_keyframe
                and bool(getattr(cfg, "fused_keyframe", False))
                and hw.n_frames <= cfg.window_frame_capacity):
            self._keyframe_fused(raw_new, new_obs, q1, p1, v1, bg1, ba1,
                                 tri_inv_d, tri_ok, tri_track_id,
                                 tri_ref_fid, is_keyframe)
        elif tail_was_keyframe:
            # marginalize oldest while full, then append (:90-113)
            while hw.n_frames >= cfg.window_frame_capacity:
                self._marginalize_oldest()
            slot = hw.append_frame(
                raw_new.id, raw_new.t, q1, p1, v1,
                bg1, ba1,
                raw_new.imu_ts, raw_new.imu_w, raw_new.imu_a,
                keyframe=is_keyframe,
            )
            self._write_observations(slot, new_obs)
            self._apply_triangulation(tri_inv_d, tri_ok, tri_track_id, tri_ref_fid)
            pend_dev = None
            if self.planes is not None:
                # async plane worker (plane_extractor.cpp:106-110): promote
                # LAST keyframe's detection, then issue this keyframe's —
                # its outputs ride the BA fetch below
                self.planes.promote_pending(self.hw)
                self.planes.extend_planes(self.hw)
            # fused keyframe solve: (initial prior if absent) + delta
            # re-integration + full VI BA — ONE upload, ONE dispatch,
            # ONE fetch (incl. solver info, forensics landmark cloud and
            # the async plane-RANSAC outputs)
            w, ops = hw.to_device(
                extra=self._imu_ops_host() + (hw.track_life.copy(),))
            if self.planes is not None:
                pend_dev = self.planes.issue_detection(self.hw)
            with forensics.timer("bundle_adjustor_solve_time"):
                w, info, xw_dev, tri_dev = self.k.ba_step(
                    w, *ops, not hw.prior_valid)
                transfer.block(w.p)
            hw.prior_valid = True
            info, xw, self._fresh_tri, pend_h = hw.from_device(
                w, extra=(info, xw_dev, tri_dev, pend_dev))
            if self.planes is not None:
                self.planes.store_pending_result(pend_h)
            self._emit_solver_forensics(info, xw)
        else:
            # replace tail: merge the IMU span (:115-121)
            merged_ts = np.concatenate([hw.imu_ts[tail], raw_new.imu_ts])
            merged_w = np.concatenate([hw.imu_w[tail], raw_new.imu_w])
            merged_a = np.concatenate([hw.imu_a[tail], raw_new.imu_a])
            hw.drop_tail()
            slot = hw.append_frame(
                raw_new.id, raw_new.t, q1, p1, v1, bg1, ba1,
                merged_ts, merged_w, merged_a, keyframe=is_keyframe,
            )
            # re-link against the frame before the old tail
            prev_slot = slot - 1
            raw_prev = self.ft.frame_by_id(int(hw.frame_id[prev_slot]))
            if raw_prev is not None:
                obs2 = self._mirror_frame(raw_prev, raw_new, prev_slot)
            else:
                obs2 = new_obs
            self._write_observations(slot, obs2)
            self._apply_triangulation(tri_inv_d, tri_ok, tri_track_id, tri_ref_fid)

        return self._post_track(is_keyframe, tail_was_keyframe)

    def _post_track(self, is_keyframe, tail_was_keyframe):
        """Shared tail of track_finish: track pruning, the landmark-
        starvation health backstop, keyframe plane upkeep and the
        latest-state publish. Returns False when the backstop declares
        tracking lost."""
        cfg = self.cfg
        hw = self.hw
        # --- prune tracks with quality > 3.0 (:123-125, map.cpp:125-135),
        # with a triangulation grace window for immature tracks
        # (Config.track_grace_life; the reference's cull-on-first-failure
        # starves the map under rotation-dominated stress — see the
        # config docstring and PERF_NOTES round 5) ---
        immature = hw.track_mask & (
            (hw.track_flags & (TF_VALID | TF_PLANE)) == 0)
        grace = int(getattr(cfg, "track_grace_life", 0))
        bad = hw.track_mask & (hw.quality > 3.0)
        bad |= immature & (hw.track_life >= max(grace, 2))
        # capacity valve: graced immature tracks must not exhaust the
        # column pool — cull oldest-immature-first below the floor
        min_free = int(getattr(cfg, "track_min_free_columns", 0))
        free_after = hw.T - int((hw.track_mask & ~bad).sum())
        if free_after < min_free:
            cand = np.nonzero(immature & ~bad)[0]
            if len(cand):
                order = cand[np.argsort(-hw.track_life[cand])]
                bad[order[: min_free - free_after]] = True
        for c in np.nonzero(bad)[0]:
            hw.release_column(int(c))

        # --- failure backstop (SURVEY §5): persistent landmark
        # starvation is tracking loss — re-init beats silent divergence
        # (measured: the 60 s golden limped at ~20 landmarks from t=43
        # on and spiraled to 7 m ATE; a re-init recovers a fresh gauge).
        # The floor self-scales as a fraction of the map's RUNNING PEAK
        # population, so the same default serves a 250-track production
        # window and a 50-track test window without retuning. ---
        if is_keyframe:
            n_valid_now = int((hw.track_mask & (
                (hw.track_flags & (TF_VALID | TF_PLANE)) != 0)).sum())
            self.peak_valid = max(self.peak_valid, n_valid_now)
            lost = health_update(self, cfg, n_valid_now)
            if lost:
                forensics.set("tracking_health_reinit", True)
                return False

        if tail_was_keyframe and self.planes is not None:
            self.planes.merge_planes(self.hw)
            # refit from FRESH post-solve triangulations fetched with the
            # BA results (Plane::update_parameter re-triangulates,
            # plane.cpp:64-76) — never from stale cast points
            self.planes.update_parameters(self.hw, fresh=self._fresh_tri)

        self.latest_state = self._state_of(hw.n_frames - 1)
        return True

    # ------------------------------------------------------------------
    def _emit_solver_forensics(self, info, xw):
        """Full-state emission for host visualizers
        (sliding_window_tracker.cpp:138-245 emits landmark clouds, plane
        states and keyframe poses into forensics slots)."""
        hw = self.hw
        forensics.set("solver_info", {k_: float(v) for k_, v in info.items()})
        forensics.set("sliding_window_landmarks",
                      int(((hw.track_flags & (TF_VALID | TF_PLANE)) != 0).sum()))
        forensics.set("sliding_window_planes", int(hw.plane_mask.sum()))
        if forensics.enabled:
            live = hw.track_mask & (
                (hw.track_flags & (TF_VALID | TF_PLANE)) != 0)
            forensics.set("sliding_window_landmark_points",
                          np.asarray(xw)[live])
            forensics.set(
                "sliding_window_keyframe_poses",
                [(float(hw.frame_t[i]), hw.q[i].copy(), hw.p[i].copy())
                 for i in range(hw.n_frames)],
            )
            forensics.set(
                "sliding_window_plane_states",
                [(hw.plane_normal[j].copy(), float(hw.plane_distance[j]))
                 for j in np.nonzero(hw.plane_mask)[0]],
            )
            forensics.set("imu_bias_gyroscope", hw.bg[hw.n_frames - 1].copy())
            forensics.set("imu_bias_accelerometer", hw.ba[hw.n_frames - 1].copy())

    def _keyframe_fused(self, raw_new, new_obs, q1, p1, v1, bg1, ba1,
                        tri_inv_d, tri_ok, tri_track_id, tri_ref_fid,
                        is_keyframe):
        """The whole keyframe (marginalize + append + plane bookkeeping +
        BA) with ONE device dispatch and ONE fetch (Config.fused_keyframe;
        kernels.kf_step). The separate marg_step/ba_step path costs two
        device round trips per keyframe plus an intermediate host mirror.

        Documented deviations from the sequential path (why this is an
        opt-in performance mode, not the default):
        - plane promote/extend run on the PRE-marginalization window
          (they see the to-be-dropped oldest frame and pre-rebase
          depths — all currently-valid values, one frame earlier than
          the reference's marginalize->update_map->extend order);
        - triangulation adoptions whose reference frame is the victim
          are skipped for one frame (the in-kernel rebase would move
          their reference; they re-triangulate next frame)."""
        cfg, hw = self.cfg, self.hw
        do_marg = hw.n_frames >= cfg.window_frame_capacity
        slot = (cfg.window_frame_capacity - 1) if do_marg else hw.n_frames

        pend_dev = None
        if self.planes is not None:
            self.planes.promote_pending(hw)
            self.planes.extend_planes(hw)

        dt_np = hw.dtype
        nf_kp = np.zeros((hw.T, 2), dt_np)
        nf_obs = np.zeros(hw.T, bool)
        for col, z in new_obs:
            nf_kp[col] = z
            nf_obs[col] = True

        # _apply_triangulation guards, host-computed for the FINAL topology
        obs_alive = hw.obs_mask & hw.frame_mask[:, None]
        obs_surv = (obs_alive[1:] if do_marg else obs_alive).sum(axis=0)
        n_obs_final = obs_surv + nf_obs
        unchanged = (hw.track_id == tri_track_id) & (
            hw.frame_id[hw.ref_frame] == tri_ref_fid)
        tri_mask = (hw.track_mask & tri_ok.astype(bool) & (n_obs_final >= 2)
                    & unchanged
                    & ((hw.track_flags & (TF_VALID | TF_PLANE)) == 0))
        if do_marg:
            tri_mask &= hw.ref_frame != 0

        life2 = (hw.track_life + nf_obs.astype(np.int32)).astype(np.int32)
        ops1 = self._imu_ops_host()
        ops2 = self._imu_ops_post_append(do_marg, raw_new)
        make_prior = not hw.prior_valid

        w, ops = hw.to_device(extra=ops1 + ops2 + (
            np.asarray(q1, dt_np), np.asarray(p1, dt_np),
            np.asarray(v1, dt_np), np.asarray(bg1, dt_np),
            np.asarray(ba1, dt_np),
            nf_kp, nf_obs, np.asarray(tri_inv_d, dt_np), tri_mask,
            life2))
        if self.planes is not None:
            pend_dev = self.planes.issue_detection(hw)
        with forensics.timer("bundle_adjustor_solve_time"):
            w_out, info, xw_dev, tri_dev = self.k.kf_step(
                w, *ops, slot, make_prior, do_marg)
        # FETCH FIRST (the reference's order): the fetch waits for the
        # step and refreshes every mirrored value (including the spliced
        # frame and the compacted slots); only host-only index fields
        # remain. The upload copied the mirrors, so mutating them is safe
        # either way.
        info, xw, self._fresh_tri, pend_h = hw.from_device(
            w_out, extra=(info, xw_dev, tri_dev, pend_dev))
        if do_marg:
            hw.shift_after_marginalize(0)
        hw.frame_id[slot] = raw_new.id
        hw.frame_t[slot] = raw_new.t
        hw.keyframe[slot] = is_keyframe
        hw.imu_ts[slot] = np.asarray(raw_new.imu_ts, np.float64)
        hw.imu_w[slot] = np.asarray(raw_new.imu_w)
        hw.imu_a[slot] = np.asarray(raw_new.imu_a)
        hw.track_life = life2
        hw.prior_valid = True
        if do_marg:
            hw._refresh_track_columns()
        if self.planes is not None:
            self.planes.store_pending_result(pend_h)
        self._emit_solver_forensics(info, xw)

    def _dispatch_keyframe_chained(self, pend):
        """Dispatch the fused keyframe step chained on the motion step's
        DEVICE outputs (Config.chained_keyframe). Runs at track_dispatch
        time: the keyframe's results ride the SAME deferred combined
        fetch as the motion step's, so a keyframe costs the same single
        blocking synchronization as any other frame (VERDICT r4 item 8).
        All host bookkeeping — window mirrors, prune, plane upkeep, the
        keyframe decision itself, the NaN failure check — moves to
        _finish_keyframe_chained.

        Semantics are _keyframe_fused's exactly (including its two
        documented deviations): every host value it computes at finish
        time is computed here at dispatch time instead, and nothing the
        fused path reads can change in between — the host mutates the
        window only inside dispatch/finish steps, which never
        interleave with this one."""
        cfg, hw = self.cfg, self.hw
        raw_new = pend["raw_new"]
        new_obs = pend["new_obs"]
        pnp_out = pend["pnp_out"]
        do_marg = hw.n_frames >= cfg.window_frame_capacity
        slot = (cfg.window_frame_capacity - 1) if do_marg else hw.n_frames

        pend_dev = None
        if self.planes is not None:
            # same placement as the fused path: promote/extend mutate the
            # host window AFTER the motion step's upload (which therefore
            # sees the pre-promote state, exactly like _keyframe_fused)
            self.planes.promote_pending(hw)
            self.planes.extend_planes(hw)

        dt_np = hw.dtype
        nf_kp = np.zeros((hw.T, 2), dt_np)
        nf_obs = np.zeros(hw.T, bool)
        for col, z in new_obs:
            nf_kp[col] = z
            nf_obs[col] = True

        # _apply_triangulation guards minus tri_ok (ANDed in-graph by
        # kf_step_chained). The `unchanged` snapshot guard is trivially
        # true here: this runs in the same dispatch step the snapshots
        # were taken in, before any topology mutation.
        obs_alive = hw.obs_mask & hw.frame_mask[:, None]
        obs_surv = (obs_alive[1:] if do_marg else obs_alive).sum(axis=0)
        n_obs_final = obs_surv + nf_obs
        tri_mask_host = (hw.track_mask & (n_obs_final >= 2)
                         & ((hw.track_flags & (TF_VALID | TF_PLANE)) == 0))
        if do_marg:
            tri_mask_host &= hw.ref_frame != 0

        life2 = (hw.track_life + nf_obs.astype(np.int32)).astype(np.int32)
        ops1 = self._imu_ops_host()
        ops2 = self._imu_ops_post_append(do_marg, raw_new)
        make_prior = not hw.prior_valid

        w, ops = hw.to_device(extra=ops1 + ops2 + (
            nf_kp, nf_obs, tri_mask_host, life2))
        if self.planes is not None:
            pend_dev = self.planes.issue_detection(hw)
        (ts, ws, accs, mask, t_frames, ts2, ws2, accs2, mask2, t_frames2,
         nf_kp_d, nf_obs_d, tri_mask_d, life2_d) = ops
        q1d, p1d, v1d, bg1d, ba1d = pnp_out[0:5]
        tri_depth_d, tri_ok_d = pnp_out[6], pnp_out[7]
        with forensics.timer("bundle_adjustor_solve_time"):
            w_out, info, xw_dev, tri_dev = self.k.kf_step_chained(
                w, ts, ws, accs, mask, t_frames,
                ts2, ws2, accs2, mask2, t_frames2,
                q1d, p1d, v1d, bg1d, ba1d,
                nf_kp_d, nf_obs_d, tri_depth_d, tri_ok_d, tri_mask_d,
                life2_d, slot, make_prior, do_marg)
        fetch = transfer.Fetch((HostWindow.device_arrays(w_out), info, xw_dev,
                                tri_dev, pend_dev))
        pend["kf"] = dict(fetch=fetch, w_out=w_out, do_marg=do_marg,
                          slot=slot, life2=life2)

    def _finish_keyframe_chained(self, pend, fetched=None):
        """Harvest a chained keyframe: the motion-step statistics
        (keyframe decision, NaN failure check) and the keyframe step's
        results apply together, one frame after dispatch. `fetched`:
        optional pre-fetched host values of pend_fetch_arrays(pend)."""
        hw = self.hw
        kf = pend["kf"]
        raw_new = pend["raw_new"]
        if fetched is None:
            fetched = transfer.get(pend_fetch_arrays(pend))
        pnp_vals, kf_vals = fetched
        (q1, p1, v1, bg1, ba1, delta_q, tri_inv_d, tri_ok, p80_px,
         n_common) = [np.array(a) for a in pnp_vals]
        if not (np.isfinite(q1).all() and np.isfinite(p1).all()):
            # the dispatched keyframe solve was garbage-in; nothing was
            # applied to the host window — the sequential path re-inits
            # here too, from the identical un-mutated state
            return False
        is_keyframe = self._keyframe_check(
            bool(len(pend["kf_slots"]) == 0), float(p80_px), int(n_common))
        if is_keyframe:
            self.n_keyframes += 1

        win_vals, info, xw, fresh_tri, pend_h = kf_vals
        hw.apply_fetched(kf["w_out"], win_vals)
        self._fresh_tri = fresh_tri
        do_marg, slot = kf["do_marg"], kf["slot"]
        if do_marg:
            hw.shift_after_marginalize(0)
        hw.frame_id[slot] = raw_new.id
        hw.frame_t[slot] = raw_new.t
        hw.keyframe[slot] = is_keyframe
        hw.imu_ts[slot] = np.asarray(raw_new.imu_ts, np.float64)
        hw.imu_w[slot] = np.asarray(raw_new.imu_w)
        hw.imu_a[slot] = np.asarray(raw_new.imu_a)
        hw.track_life = kf["life2"]
        hw.prior_valid = True
        if do_marg:
            hw._refresh_track_columns()
        if self.planes is not None:
            self.planes.store_pending_result(pend_h)
        self._emit_solver_forensics(info, xw)
        return self._post_track(is_keyframe, True)

    def _imu_ops_post_append(self, do_marg, raw_new):
        """IMU grids in the POST-(marginalize+append) slot layout,
        built WITHOUT mutating the window (the fused keyframe step needs
        both layouts in one upload)."""
        hw = self.hw
        n = hw.n_frames
        ts_l = [hw.imu_ts[i] for i in range(n)]
        w_l = [hw.imu_w[i] for i in range(n)]
        a_l = [hw.imu_a[i] for i in range(n)]
        t_l = [hw.frame_t[i] for i in range(n)]
        if do_marg:
            ts_l, w_l, a_l, t_l = ts_l[1:], w_l[1:], a_l[1:], t_l[1:]
        ts_l.append(np.asarray(raw_new.imu_ts))
        w_l.append(np.asarray(raw_new.imu_w))
        a_l.append(np.asarray(raw_new.imu_a))
        t_l.append(raw_new.t)
        return self._imu_ops_from(ts_l, w_l, a_l, t_l)

    # ------------------------------------------------------------------
    def _mirror_frame(self, raw_prev, raw_new, prev_slot):
        """Link tracks shared by (raw_prev, raw_new); returns
        [(column, z_normalized)] for the new frame
        (mirror_frame, sliding_window_tracker.cpp:52-72)."""
        hw = self.hw
        K = self.cfg.K
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        ids_new = {int(t): k for k, t in enumerate(raw_new.track_ids)
                   if raw_new.kp_mask[k] and t >= 0}
        out = []
        seen = set()
        for ki, tid in enumerate(raw_prev.track_ids):
            if not raw_prev.kp_mask[ki] or tid < 0:
                continue
            kj = ids_new.get(int(tid))
            if kj is None:
                continue
            col = hw.column_of(tid)
            if col is None:
                col = hw.alloc_column(tid, prev_slot)
                if col is None:
                    continue
                zi = np.array([(raw_prev.kp[ki, 0] - cx) / fx,
                               (raw_prev.kp[ki, 1] - cy) / fy])
                hw.add_observation(col, prev_slot, zi)
            zj = np.array([(raw_new.kp[kj, 0] - cx) / fx,
                           (raw_new.kp[kj, 1] - cy) / fy])
            if col not in seen:
                out.append((col, zj))
                seen.add(col)
        return out

    def _write_observations(self, slot, obs):
        for col, z in obs:
            if not self.hw.obs_mask[slot, col]:
                self.hw.add_observation(col, slot, z)

    def _keyframe_check(self, no_keyframe_yet, p80_px, n_common):
        """Rotation-compensated 80th-percentile parallax gate
        (sliding_window_tracker.cpp:255-296). The statistics (p80 pixel
        parallax vs the last keyframe + common-track count) are computed
        inside the fused pnp_step fetch; only the thresholds and the
        skipped-frame counter live here."""
        cfg = self.cfg
        if no_keyframe_yet:
            self.skipped_frames = 0
            return True
        keyframe = False
        if n_common < cfg.keyframe_min_common_tracks:
            keyframe = True
        elif p80_px > cfg.keyframe_parallax_px:
            keyframe = True
        else:
            self.skipped_frames += 1
        if self.skipped_frames > cfg.keyframe_max_skipped:
            keyframe = True
        if keyframe:
            self.skipped_frames = 0
        return keyframe

    def _apply_triangulation(self, inv_d, ok, snap_track_id, snap_ref_fid):
        """Adopt fused-fetch triangulations for not-yet-valid tracks
        (track() triangulation sweep, sliding_window_tracker.cpp:81-88).
        Vectorized host bookkeeping — no extra device sync.

        snap_track_id/snap_ref_fid: the column->track binding and the
        physical id of each column's reference frame at the time of the
        device call. Topology mutations between the call and here
        (drop_tail column recycling, marginalization slot shifts) can
        re-bind a column or move its reference camera; stale results are
        skipped for those columns — they re-triangulate next frame."""
        hw = self.hw
        # require >= 2 surviving observations in the FINAL topology: the
        # fused result was computed pre-append, and the non-keyframe path
        # drops the old tail, which can leave a tail-born track with a
        # single real view (its virtual-pair triangulation is degenerate)
        n_obs = (hw.obs_mask & hw.frame_mask[:, None]).sum(axis=0)
        unchanged = (hw.track_id == snap_track_id) & (
            hw.frame_id[hw.ref_frame] == snap_ref_fid)
        fresh = (hw.track_mask & ok & (n_obs >= 2) & unchanged
                 & ((hw.track_flags & (TF_VALID | TF_PLANE)) == 0))
        hw.inv_depth[fresh] = inv_d[fresh]
        hw.track_flags[fresh] |= TF_VALID

    def _imu_ops_host(self):
        """Per-frame padded IMU sample grids (host numpy) for delta
        re-integration inside the fused ba/marg steps.

        Non-keyframe tail replacements MERGE spans, so a frame can hold
        many inter-frame spans; the grid capacity is
        window_imu_capacity (> the single-span capacity) and overlong
        spans are integral-preserving downsampled. Truncating instead
        (round-2 behavior) silently shrank the preintegration interval
        of merged spans, which walked the bias estimates and caused the
        long-run scale drift."""
        return self._imu_ops_from(
            self.hw.imu_ts, self.hw.imu_w, self.hw.imu_a, self.hw.frame_t)

    def _imu_ops_from(self, ts_list, w_list, a_list, frame_t):
        """Grid-building core of _imu_ops_host over explicit span lists
        (any slot layout; entries beyond the list are empty)."""
        F = self.hw.F
        N = self.cfg.window_imu_capacity
        ts = np.zeros((F, N))
        ws = np.zeros((F, N, 3))
        accs = np.zeros((F, N, 3))
        mask = np.zeros((F, N), bool)
        t_frames = np.zeros(F)
        t_frames[: min(len(frame_t), F)] = np.asarray(frame_t)[:F]
        for j in range(min(len(ts_list), F)):
            if ts_list[j] is None or len(ts_list[j]) == 0:
                continue
            tj, wj, aj = ts_list[j], w_list[j], a_list[j]
            if len(tj) > N:
                tj, wj, aj = fit_span(tj, wj, aj, t_frames[j], N)
            n = len(tj)
            ts[j, :n] = tj
            ws[j, :n] = wj
            accs[j, :n] = aj
            mask[j, :n] = True
        dt = np.float32 if self.k.dtype == torch.float32 else np.float64
        return (ts.astype(dt), ws.astype(dt), accs.astype(dt),
                mask, t_frames.astype(dt))

    def _marginalize_oldest(self):
        """Fused: attach deltas + Schur-eliminate frame 0 into the prior +
        compact slots — ONE upload, ONE dispatch, ONE fetch."""
        with forensics.timer("bundle_adjustor_marginalization_time"):
            w, ops = self.hw.to_device(extra=self._imu_ops_host())
            w = self.k.marg_step(w, *ops)
            transfer.block(w.p)
        self.hw.from_device(w)   # mirrors the compacted frame_mask back
        self.hw.prior_valid = True
        self.hw.shift_after_marginalize(0)
        self.hw._refresh_track_columns()


def health_update(state, cfg, n_valid_now):
    """Landmark-starvation health decision (the SURVEY §5 failure
    backstop), one call per keyframe. Returns True when tracking should
    be declared lost. `state` carries `peak_valid` (already updated),
    `unhealthy_keyframes` (consecutive counter) and, lazily,
    `health_bits` (recent below-floor history for the windowed test).

    Two detectors:
    - strict-consecutive (default): track_health_max_keyframes
      below-floor keyframes in a row;
    - windowed fraction (opt-in, track_health_window > 0): >= frac of
      the last `window` keyframes below floor. A persistently sick map
      whose count BOUNCES over the floor resets the consecutive counter
      every bounce (measured on the 60 s endurance profile's
      post-re-init runaway, PERF_NOTES "Long-horizon: the post-recovery
      gauge"); the windowed test still fires.

    The floor self-scales as 15% of the running peak population, so one
    default serves a 250-track production window and a 50-track test
    window without retuning."""
    floor = int(getattr(cfg, "track_health_min_landmarks", 0))
    if floor <= 0:
        return False
    floor = max(floor, int(0.15 * state.peak_valid))
    below = n_valid_now < floor
    if below:
        state.unhealthy_keyframes += 1
        if state.unhealthy_keyframes >= int(cfg.track_health_max_keyframes):
            return True
    else:
        state.unhealthy_keyframes = 0
    win = int(getattr(cfg, "track_health_window", 0))
    if win > 0:
        bits = getattr(state, "health_bits", None)
        if bits is None:
            bits = []
            state.health_bits = bits
        bits.append(bool(below))
        del bits[:-win]
        frac = float(getattr(cfg, "track_health_frac", 0.7))
        if len(bits) >= win and sum(bits) >= frac * win:
            return True
    return False


def pend_fetch_arrays(pend):
    """The copies track_finish(pend) harvests, for the Core host loop to
    wait on together with the frontend stage's: the motion step's outputs,
    and for a chained keyframe (Config.chained_keyframe) also the keyframe
    step's results."""
    if "kf" in pend:
        return (pend["pnp_fetch"], pend["kf"]["fetch"])
    return pend["pnp_fetch"]

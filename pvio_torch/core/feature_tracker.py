"""Feature tracker: per-frame KLT tracking + detection + raw track book.

Matches `pvio_tpu/core/feature_tracker.py`: `RawFrame` and
`FeatureTracker` (`track_frame`, `dispatch_frame`, `handle_arrays`,
`finish_frame`, `frame_by_id`, `keypoints_of_track`, the gyro-predicted
inter-frame camera rotation and the per-frame threefry key data). The
tracker keeps a sliding window of raw frames (keypoints + global track ids)
on the host; all pixel work runs in the engine's `first_frame_step` /
`frame_step` / `frame_step_nodetect`, whose corner response is kernel K1
on the card. The device-resident state (pyramid, response, keypoint slots)
advances at dispatch time.

`dispatch_frame` uploads the image, the rotation and the key data in ONE
copy, launches the frame step and starts ONE packed device -> host copy of
its outputs (`utils/transfer.Fetch`); `finish_frame` harvests it.
"""

from dataclasses import dataclass, field

import numpy as np

from pvio_torch.utils import transfer
from pvio_torch.utils.forensics import bus as forensics


@dataclass
class RawFrame:
    """Host record of one tracked frame."""

    id: int
    t: float
    kp: np.ndarray          # (K, 2) pixel coords
    kp_mask: np.ndarray     # (K,)
    track_ids: np.ndarray   # (K,) int64, -1 = unassigned
    # IMU samples since the previous frame (exclusive) up to t (inclusive)
    imu_ts: np.ndarray = field(default_factory=lambda: np.zeros(0))
    imu_w: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))
    imu_a: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))


class FeatureTracker:
    def __init__(self, config, kernels, seed=None):
        self.cfg = config
        self.k = kernels
        self.frames: list[RawFrame] = []
        self.prev_pyramid = None
        self.prev_response = None  # device-resident corner-response map
        # device-resident merged keypoint state from the last frame step,
        # fed straight back next frame
        self._kp_dev = None
        self._mask_dev = None
        self.next_track_id = 0
        self.track_len: dict[int, int] = {}
        self.initialized = False  # switches raw window length
        self._seed = np.uint32(config.random_seed if seed is None else seed)
        self._frame_counter = 0
        self._q_bc = np.asarray(config.q_bc)

    def _next_key_data(self):
        """Threefry key data (seed, frame counter): a distinct deterministic
        key per frame, built on the host."""
        self._frame_counter += 1
        return np.array([self._seed, self._frame_counter], np.uint32)

    @staticmethod
    def _np_quat_mul(a, b):
        w = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3]
        x = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2]
        y = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1]
        z = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0]
        return np.array([w, x, y, z])

    def _interframe_camera_rotation(self, imu_ts, imu_w, t_prev, t_new):
        """Integrate raw gyro over (t_prev, t_new] -> camera-frame dq, in
        numpy."""
        if len(imu_ts) == 0:
            return np.array([1.0, 0, 0, 0])
        q = np.array([1.0, 0, 0, 0])
        ts = np.concatenate([imu_ts, [t_new]])
        for i in range(len(imu_ts)):
            dt = max(ts[i + 1] - ts[i], 0.0)
            half = 0.5 * np.asarray(imu_w[i]) * dt
            n = np.linalg.norm(half)
            dq = (np.concatenate([[np.cos(n)], half * (np.sin(n) / n)])
                  if n > 1e-12 else np.array([1.0, half[0], half[1], half[2]]))
            q = self._np_quat_mul(q, dq)
        q /= np.linalg.norm(q)
        # body dq -> camera dq: q_cam = q_bc^-1 * q * q_bc
        qbc = np.asarray(self._q_bc)
        qbc_inv = qbc * np.array([1.0, -1, -1, -1])
        qc = self._np_quat_mul(self._np_quat_mul(qbc_inv, q), qbc)
        return qc / np.linalg.norm(qc)

    def track_frame(self, frame_id, t, img, imu_ts, imu_w, imu_a):
        """Process one camera frame synchronously; returns the new
        RawFrame. Equivalent to dispatch_frame + finish_frame."""
        return self.finish_frame(
            self.dispatch_frame(frame_id, t, img, imu_ts, imu_w, imu_a))

    def dispatch_frame(self, frame_id, t, img, imu_ts, imu_w, imu_a):
        """Launch the fused frontend step for this frame and start the
        copy of its outputs to the host without waiting; returns a handle
        for finish_frame."""
        cfg = self.cfg
        Kmax = cfg.feature_tracker_max_keypoint_detection
        dev, dt = self.k.device, self.k.dtype

        if not self.frames:
            (img_d,) = transfer.upload([np.asarray(img)], dev, dt)
            pyr, resp, kp_dev, mask_dev = self.k.first_frame_step(img_d)
            self.prev_response = resp
            self._kp_dev, self._mask_dev = kp_dev, mask_dev
            self.prev_pyramid = pyr
            return dict(first=True, frame_id=frame_id, t=t, img=img,
                        imu_ts=imu_ts, imu_w=imu_w, imu_a=imu_a,
                        fetch=transfer.Fetch((kp_dev, mask_dev)))

        # with pipeline depth > 1, frames[-1] is the last FINISHED frame:
        # the rotation helper ignores t_prev, and the detect-skip choice is
        # frame-independent whenever detect_min_free == 0 (Core caps the
        # depth to 1 otherwise)
        prev = self.frames[-1]
        dq_cam = (self._interframe_camera_rotation(imu_ts, imu_w, prev.t, t)
                  if cfg.feature_tracker_predict_keypoints
                  else np.array([1.0, 0, 0, 0]))
        # ONE upload (image + gyro rotation + key data); uint8 images ship
        # as-is, anything else at the engine dtype
        img_d, dq_d, key_d = transfer.upload(
            [np.asarray(img), dq_cam, self._next_key_data()], dev, dt)
        # detection is skipped while the keypoint budget is nearly full;
        # the previous frame's host alive count decides
        min_free = int(getattr(cfg, "feature_tracker_detect_min_free", 0))
        n_prev_alive = int(prev.kp_mask.sum())
        step = (self.k.frame_step_nodetect
                if Kmax - n_prev_alive < min_free else self.k.frame_step)
        pyr, resp, kp_dev, mask_dev, status, det_mask = step(
            self.prev_pyramid, self.prev_response, img_d,
            self._kp_dev, self._mask_dev, dq_d, key_d)
        self.prev_response = resp
        self._kp_dev, self._mask_dev = kp_dev, mask_dev
        self.prev_pyramid = pyr
        return dict(first=False, frame_id=frame_id, t=t, img=img,
                    imu_ts=imu_ts, imu_w=imu_w, imu_a=imu_a,
                    fetch=transfer.Fetch((kp_dev, mask_dev, status, det_mask)))

    @staticmethod
    def handle_arrays(handle):
        """The copy a finish_frame(handle) harvests, for a caller that
        waits on it together with other stages' copies."""
        return handle["fetch"]

    def finish_frame(self, handle, fetched=None):
        """Harvest a dispatch_frame handle and run the host bookkeeping;
        returns the new RawFrame. `fetched`: optional harvested host values
        of handle_arrays(handle)."""
        cfg = self.cfg
        Kmax = cfg.feature_tracker_max_keypoint_detection
        frame_id, t, img = handle["frame_id"], handle["t"], handle["img"]
        if fetched is None:
            fetched = transfer.get(self.handle_arrays(handle))

        if handle["first"]:
            kp, mask = [np.array(a) for a in fetched]
            ids = -np.ones(Kmax, np.int64)
            for i in np.nonzero(mask)[0]:
                ids[i] = self._new_track()
            rf = RawFrame(frame_id, t, kp, mask, ids,
                          np.asarray(handle["imu_ts"]),
                          np.asarray(handle["imu_w"]),
                          np.asarray(handle["imu_a"]))
            status_np = np.zeros(Kmax, bool)
        else:
            prev = self.frames[-1]  # the previously FINISHED frame
            kp, mask, status_np, det_mask = [np.array(a) for a in fetched]
            ids = np.where(status_np, prev.track_ids, -1)
            for tid in prev.track_ids[prev.kp_mask & ~status_np]:
                self.track_len.pop(int(tid), None)

            # replay the kernel's deterministic merge rule on track ids:
            # free rows (ascending) take fresh detections (ascending)
            n_alive = int(status_np.sum())
            free_rows = np.nonzero(~status_np)[0]
            n_fill = min(len(free_rows), int(det_mask.sum()), Kmax - n_alive)
            for r in free_rows[:n_fill]:
                ids[r] = self._new_track()
            for tid in ids[mask]:
                self.track_len[int(tid)] = self.track_len.get(int(tid), 0) + 1
            rf = RawFrame(frame_id, t, kp, mask, ids,
                          np.asarray(handle["imu_ts"]),
                          np.asarray(handle["imu_w"]),
                          np.asarray(handle["imu_a"]))

        if forensics.enabled:
            # painter snapshot: tracked features + optical-flow segments
            prev_kp = (self.frames[-1].kp if self.frames else None)
            tracked = (status_np if self.frames else np.zeros(Kmax, bool))
            forensics.set("feature_tracker_painter", {
                "frame_id": frame_id, "t": t, "image": np.asarray(img),
                "kp": rf.kp.copy(), "mask": rf.kp_mask.copy(),
                "tracked": tracked.copy(),
                "prev_kp": (None if prev_kp is None else prev_kp.copy()),
            })
        self.frames.append(rf)
        limit = (self.cfg.feature_tracker_max_frames if self.initialized
                 else self.cfg.feature_tracker_max_init_frames)
        while len(self.frames) > limit:
            self.frames.pop(0)
        return rf

    def _new_track(self):
        tid = self.next_track_id
        self.next_track_id += 1
        self.track_len[tid] = 0
        return tid

    def frame_by_id(self, frame_id):
        for f in self.frames:
            if f.id == frame_id:
                return f
        return None

    def keypoints_of_track(self, tid):
        """(frame, kp_index) observations of a track in the raw window."""
        out = []
        for f in self.frames:
            idx = np.nonzero((f.track_ids == tid) & f.kp_mask)[0]
            if len(idx):
                out.append((f, int(idx[0])))
        return out

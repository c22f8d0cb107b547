"""Core sensor frontend: gyro/accel pairing, frame dispatch, the
pipelined host loop and IMU-rate pose prediction.

Matches `pvio_tpu/core/core.py`: `_propagate` and `Core` (`track_gyroscope`,
`track_accelerometer`, `track_camera`, `_dispatch_native`,
`poll_ready_frame`, `_process_frame`, `_advance_pipeline`, `flush`,
`_pair_imu`, `_next_ready_frame`, `_dispatch_frames`, `_emit_output`,
`_predict_output`):
  * gyroscope samples are linearly interpolated onto accelerometer
    timestamps to form fused IMU samples;
  * each camera frame collects the samples in (t_prev, t_frame] and is
    dispatched once a sample beyond its timestamp arrives;
  * the latest optimized state is propagated through the pending samples
    at IMU rate (the low-latency output).
With the native sensor hub (`utils/native.py`, built from
`csrc/pvio_core.cpp`) and `Config.pipelined_host`, frame k's frontend runs
on the device while the host finishes frame k-1; the outputs are
bit-identical to the sequential loop. With `defer_frames` set (the serving
mode, `parallel/serving.py`) the sensor entry points only queue, and an
outer host loop takes each ready frame with `poll_ready_frame` and runs the
dispatch and finish phases itself.

One `DeviceKernels` serves the engine; it runs on CUDA unless `device` says
otherwise, and a caller may hand in an existing one (`kernels`).
"""

from collections import deque

import numpy as np

from pvio_torch.core.feature_tracker import FeatureTracker
from pvio_torch.core.frontend_worker import FrontendWorker
from pvio_torch.core.kernels import DeviceKernels
from pvio_torch.core.swt import pend_fetch_arrays
from pvio_torch.geometry import nplie
from pvio_torch.imu.preintegration import GRAVITY_NOMINAL
from pvio_torch.utils import transfer
from pvio_torch.utils.forensics import bus as forensics

GRAVITY = np.array([0.0, 0.0, -GRAVITY_NOMINAL])


def _propagate(q, p, v, bg, ba, t0, ts, ws, accs):
    """Constant-sample forward integration (core.cpp:32-39)."""
    t = t0
    for i in range(len(ts)):
        dt = ts[i] - t
        if dt <= 0:
            continue
        w = ws[i] - bg
        a = accs[i] - ba
        R = nplie.quat_to_mat(q)
        a_w = R @ a + GRAVITY
        p = p + dt * v + 0.5 * dt * dt * a_w
        v = v + dt * a_w
        q = nplie.quat_normalize(nplie.quat_mul(q, nplie.expmap(w * dt)))
        t = ts[i]
    return q, p, v, t


class Core:
    def __init__(self, config, plane_extractor_factory=None, use_native=True,
                 device=None, kernels=None):
        self.cfg = config
        self.kernels = kernels if kernels is not None else DeviceKernels(config, device)
        self.feature_tracker = FeatureTracker(config, self.kernels)
        self.frontend = FrontendWorker(config, self.kernels, self.feature_tracker,
                                       plane_extractor_factory)
        self.gyro = deque()    # (t, w)
        self.accel = deque()   # (t, a)
        self.imu = []          # fused ImuData since last dispatched frame
        self.pending_frames = deque()  # (id, t, image)
        self.frame_counter = 0
        self.outputs = []      # (t, q_out, p_out) trajectory
        self._last_frame_t = -np.inf
        self._boundary = None  # last IMU sample consumed by a frame
        # native C++ sensor hub (csrc/pvio_core.cpp) when available
        self.hub = None
        if use_native:
            try:
                from pvio_torch.utils.native import NativeSensorHub

                self.hub = NativeSensorHub(imu_capacity=4 * config.imu_buffer_capacity)
            except RuntimeError:        # no compiler: the pure-Python path
                self.hub = None
        self._images = {}      # frame id -> image (native path)
        # latency-hiding host pipeline (reference worker decoupling,
        # utility/worker.h:25-78): frame k's frontend computes + streams
        # back while the host processes frame k-1. One frame of
        # estimator lag; bit-identical outputs (same ops, same order,
        # same inputs — only the host blocking pattern changes).
        self._pipelined = bool(getattr(config, "pipelined_host", False))
        # frontend stage depth: how many frame dispatches may be in
        # flight before the oldest is harvested. Depth 2 gives each
        # device->host transfer two inter-frame host intervals to land.
        # Depth > 1 requires the detect-skip variant choice to be
        # frame-independent, which holds exactly when
        # feature_tracker_detect_min_free == 0: the
        # choice then never consults the not-yet-harvested alive count,
        # so outputs stay bit-identical to the sequential loop.
        depth = int(getattr(config, "pipeline_depth", 2))
        if int(getattr(config, "feature_tracker_detect_min_free", 0)) > 0:
            depth = min(depth, 1)
        self._pipeline_depth = max(depth, 1)
        self._ft_queue = deque()  # in-flight frontend handles (oldest first)
        self._swt_pending = None  # in-flight SWT motion-step record
        # serving mode (parallel/serving.MultiSequenceServer): sensor entry
        # points only QUEUE; an external host loop polls ready frames and
        # runs the dispatch/finish phases itself, so N engines can share each
        # device -> host synchronization point
        self.defer_frames = False

    # ------------------------------------------------------------------
    # public sensor entry points (pvio.h:135-148 facade semantics)
    # ------------------------------------------------------------------
    def track_gyroscope(self, t, x, y, z):
        if self.hub is not None:
            self.hub.push_gyro(t, x, y, z)
            self._dispatch_native()
        else:
            self.gyro.append((t, np.array([x, y, z])))
            self._pair_imu()
        return self._predict_output(t)

    def track_accelerometer(self, t, x, y, z):
        if self.hub is not None:
            self.hub.push_accel(t, x, y, z)
            self._dispatch_native()
        else:
            self.accel.append((t, np.array([x, y, z])))
            self._pair_imu()
        return self._predict_output(t)

    def track_camera(self, t, image):
        forensics.measure_rate("camera_input_rate", t)
        forensics.measure_rate("camera_real_rate", __import__("time").perf_counter())
        fid = self.frame_counter
        self.frame_counter += 1
        if self.hub is not None:
            self._images[fid] = image
            self.hub.push_frame(fid, t)
            self._dispatch_native()
        else:
            self.pending_frames.append([fid, t, image])
            self._dispatch_frames()
        return self._predict_output(t)

    def _dispatch_native(self):
        if self.defer_frames:
            return
        while True:
            got = self.hub.poll_frame()
            if got is None:
                return
            fid, t, ts, ws, accs = got
            image = self._images.pop(fid)
            self._process_frame(fid, t, image, ts, ws, accs)

    def poll_ready_frame(self):
        """(serving host loop) Pop the oldest camera frame whose IMU span is
        complete WITHOUT processing it; returns (fid, t, image, ts, ws,
        accs) or None. Only meaningful with `defer_frames` set: the external
        loop then runs the dispatch/finish phases (parallel/serving.py)."""
        if self.hub is not None:
            got = self.hub.poll_frame()
            if got is None:
                return None
            fid, t, ts, ws, accs = got
            return fid, t, self._images.pop(fid), ts, ws, accs
        return self._next_ready_frame()

    def _process_frame(self, fid, t, image, ts, ws, accs):
        """Run one camera frame through tracker + frontend — sequentially,
        or with one frame of pipelining once initialized."""
        if not (self._pipelined and self.frontend.initialized):
            self.flush()
            with forensics.timer("feature_tracker_time"):
                rf = self.feature_tracker.track_frame(fid, t, image, ts, ws, accs)
            state = self.frontend.issue_frame(rf)
            if state is not None:
                self._emit_output(state)
            self._last_frame_t = t
            return
        # pipelined steady state at camera frame k (depth D):
        #   1. dispatch frontend(k)            (non-blocking)
        #   2. if D frontends in flight: finish frontend(k-D)
        #   3. finish SWT(k-D-1)               (transfer landed: ~0 wait)
        #   4. dispatch SWT(k-D)               (non-blocking)
        # Same operations in the same relative order as the sequential
        # loop — outputs are bit-identical, only the blocking moves.
        if self._pipeline_depth == 1 and self._ft_queue:
            # depth 1 retires BEFORE dispatching so the detect-skip
            # variant choice sees the immediately-previous frame's alive
            # count, exactly like the sequential loop
            self._advance_pipeline()
        self._ft_queue.append(self.feature_tracker.dispatch_frame(
            fid, t, image, ts, ws, accs))
        self._last_frame_t = t
        if len(self._ft_queue) > self._pipeline_depth:
            self._advance_pipeline()

    def _advance_pipeline(self):
        """Retire the oldest in-flight frontend frame and route it
        through the estimator stage. The frontend frame's copy and the
        pending SWT motion step's are harvested at one synchronization
        point."""
        handle = self._ft_queue.popleft()
        pend, self._swt_pending = self._swt_pending, None
        ft_arrays = self.feature_tracker.handle_arrays(handle)
        pnp_arrays = pend_fetch_arrays(pend) if pend is not None else ()
        ft_vals, pnp_vals = transfer.get((ft_arrays, pnp_arrays))
        with forensics.timer("feature_tracker_time"):
            rf_prev = self.feature_tracker.finish_frame(handle,
                                                       fetched=ft_vals)
        if pend is not None:
            state = self.frontend.finish_issued(pend, fetched=pnp_vals)
            if state is not None:
                self._emit_output(state)
        if self.frontend.initialized:
            self._swt_pending = self.frontend.issue_dispatch(rf_prev)
        else:
            # re-init happened underneath: route through the
            # initializer path (sequential until re-initialized)
            state = self.frontend.issue_frame(rf_prev)
            if state is not None:
                self._emit_output(state)

    def flush(self):
        """Drain the host pipeline (end of stream / mode transition):
        completes any in-flight frontend and SWT stages so trajectory
        queries reflect every fed frame."""
        while self._ft_queue:
            self._advance_pipeline()
        if self._swt_pending is not None:
            pend, self._swt_pending = self._swt_pending, None
            state = self.frontend.finish_issued(pend)
            if state is not None:
                self._emit_output(state)

    # ------------------------------------------------------------------
    def _pair_imu(self):
        """Interpolate gyro onto accel timestamps (core.cpp:59-107)."""
        while len(self.accel) and len(self.gyro) >= 2:
            ta, a = self.accel[0]
            # need gyro samples bracketing ta
            if self.gyro[0][0] > ta:
                self.accel.popleft()  # accel predates gyro stream
                continue
            if self.gyro[-1][0] < ta:
                break  # wait for more gyro
            while len(self.gyro) >= 2 and self.gyro[1][0] <= ta:
                self.gyro.popleft()
            t0, w0 = self.gyro[0]
            t1, w1 = self.gyro[1] if len(self.gyro) > 1 else self.gyro[0]
            lam = 0.0 if t1 == t0 else (ta - t0) / (t1 - t0)
            w = w0 * (1 - lam) + w1 * lam
            self.imu.append((ta, w, a))
            self.accel.popleft()
        self._dispatch_frames()

    def _next_ready_frame(self):
        """Pop the oldest pending frame whose IMU span is complete and
        extract its (ts, ws, accs) span; returns
        (fid, t, image, ts, ws, accs) or None (core.cpp:129-141)."""
        if not self.pending_frames:
            return None
        fid, t, image = self.pending_frames[0]
        if not self.imu or self.imu[-1][0] < t:
            return None  # IMU span not complete yet (core.cpp:129-141)
        take = [s for s in self.imu if s[0] <= t]
        self.imu = [s for s in self.imu if s[0] > t]
        self.pending_frames.popleft()
        # Seed the interval with the boundary sample held at the
        # previous frame's timestamp so integration covers the full
        # [t_prev, t] span (the reference drops the first sub-sample
        # segment, core.cpp:129-141 + preintegrator.cpp:88-96; we fix
        # the coverage rather than copy the quirk).
        if take and self._boundary is not None:
            bt, bw, ba_ = self._boundary
            if take[0][0] > self._last_frame_t > -np.inf:
                take.insert(0, (self._last_frame_t, bw, ba_))
        if take:
            self._boundary = take[-1]
        ts = np.array([s[0] for s in take])
        ws = np.array([s[1] for s in take]).reshape(-1, 3)
        accs = np.array([s[2] for s in take]).reshape(-1, 3)
        return fid, t, image, ts, ws, accs

    def _dispatch_frames(self):
        if self.defer_frames:
            return
        while True:
            got = self._next_ready_frame()
            if got is None:
                break
            fid, t, image, ts, ws, accs = got
            with forensics.timer("feature_tracker_time"):
                rf = self.feature_tracker.track_frame(fid, t, image, ts, ws, accs)
            state = self.frontend.issue_frame(rf)
            if state is not None:
                self._emit_output(state)
            self._last_frame_t = t

    def _emit_output(self, state):
        t, q, p, v, bg, ba = state
        q_bo = np.asarray(self.cfg.q_bo)
        p_bo = np.asarray(self.cfg.p_bo)
        q_out = nplie.quat_mul(q, q_bo)
        p_out = p + nplie.quat_to_mat(q) @ p_bo
        self.outputs.append((t, q_out, p_out))

    def _predict_output(self, t_now):
        """IMU-rate pose output by forward propagation from the latest
        optimized state (core.cpp:143-164). Returns (t, q, p) or None."""
        if self.frontend.swt is None:
            return None
        t0, q, p, v, bg, ba = self.frontend.swt.latest_state
        forensics.set("input_output_lag", min(t_now - t0, 5.0))
        if self.hub is not None:
            state16 = np.concatenate([q, p, v, bg, ba])
            q, p = self.hub.predict(state16, t0, t_now)
            return (t_now, q, p)
        pend = [(s[0], s[1], s[2]) for s in self.imu if s[0] > t0]
        if pend:
            ts = np.array([s[0] for s in pend])
            ws = np.array([s[1] for s in pend])
            accs = np.array([s[2] for s in pend])
            q, p, v, _ = _propagate(q, p, v, bg, ba, t0, ts, ws, accs)
        return (t_now, q, p)

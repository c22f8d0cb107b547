"""Forensics: the observability bus of the pipeline.

The port's own copy of `pvio_tpu/utils/forensics.py` (`ITEMS`,
`RollingAverage`, `Forensics`, the module-level `bus`): a global slot table
that the host loop writes (stage timers, rates, solver info, landmark
clouds) and host apps read. Slots are plain dict entries; everything is a
no-op while `Forensics.enabled` is False.
"""

import time
from collections import deque
from contextlib import contextmanager

# Slot names mirroring forensics.h:44-59
ITEMS = (
    "camera_input_rate",
    "camera_real_rate",
    "input_output_lag",
    "feature_tracker_time",
    "bundle_adjustor_solve_time",
    "bundle_adjustor_marginalization_time",
    "plane_extraction_time",
    "sliding_window_landmarks",
    "sliding_window_planes",
    "sliding_window_keyframe_poses",
    "feature_tracker_painter",
    "solver_info",
    # full-state slots for host visualizers (beyond-reference richness)
    "sliding_window_landmark_points",
    "sliding_window_plane_states",
    "imu_bias_gyroscope",
    "imu_bias_accelerometer",
)


class RollingAverage:
    """Rolling mean over the last n samples (the reference smooths stage
    timings the same way before graphing them, main.cpp:163-167)."""

    def __init__(self, n=20):
        self.buf = deque(maxlen=n)

    def push(self, v):
        self.buf.append(float(v))
        return self.mean

    @property
    def mean(self):
        return sum(self.buf) / len(self.buf) if self.buf else 0.0


class Forensics:
    enabled = True

    def __init__(self):
        self.slots = {}
        self.averages = {}

    def set(self, item, value):
        if Forensics.enabled:
            self.slots[item] = value

    def get(self, item, default=None):
        return self.slots.get(item, default)

    def push_time(self, item, seconds):
        if not Forensics.enabled:
            return
        avg = self.averages.setdefault(item, RollingAverage())
        self.slots[item] = avg.push(seconds)

    @contextmanager
    def timer(self, item):
        """RAII scope timer (unique_timer.h:27-75)."""
        if not Forensics.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.push_time(item, time.perf_counter() - t0)

    def measure_rate(self, item, t, window=10):
        """Input-rate measurement from timestamps (core.cpp:166-189)."""
        if not Forensics.enabled:
            return
        key = f"_{item}_stamps"
        stamps = self.slots.setdefault(key, deque(maxlen=window))
        stamps.append(float(t))
        if len(stamps) >= 2:
            dt = stamps[-1] - stamps[0]
            if dt > 0:
                self.slots[item] = (len(stamps) - 1) / dt

    def summary(self):
        return {k: v for k, v in self.slots.items() if not k.startswith("_")}


# module-level default bus (the reference uses a global slot array)
bus = Forensics()

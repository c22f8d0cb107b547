"""ctypes bindings of the native sensor runtime (`csrc/pvio_core.cpp`).

The port's own copy of `pvio_tpu/utils/native.py`: `load`, `available` and
`NativeSensorHub` (IMU pairing, camera-frame association and IMU-rate pose
prediction, the hub the pipelined `Core` loop runs on); the TUM writer
waits for the CLI. The library is built on first use with g++ (no external
dependencies) into the git-ignored `pvio_torch/_build/`, never beside the
source; the build writes a temporary file and renames it, so processes
that build at once do not see a partial library. `available()` is False
when no compiler is present.
"""

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parents[2] / "csrc" / "pvio_core.cpp"
_SO = Path(__file__).resolve().parents[1] / "_build" / "libpviocore.so"
_lib = None
_tried = False


def _build():
    _SO.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_SO.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-o", tmp, str(_SRC)],
                       check=True, capture_output=True)
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load():
    """The loaded library, built first if missing or older than its
    source; None when it cannot be built or loaded."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
            _build()
        lib = ctypes.CDLL(str(_SO))
    except (OSError, subprocess.CalledProcessError):
        return None
    D = ctypes.POINTER(ctypes.c_double)
    lib.hub_create.restype = ctypes.c_void_p
    lib.hub_destroy.argtypes = [ctypes.c_void_p]
    lib.hub_push_gyro.argtypes = [ctypes.c_void_p] + [ctypes.c_double] * 4
    lib.hub_push_accel.argtypes = [ctypes.c_void_p] + [ctypes.c_double] * 4
    lib.hub_push_frame.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_double]
    lib.hub_poll_frame.restype = ctypes.c_int64
    lib.hub_poll_frame.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                                   D, D, D, D, ctypes.c_int64]
    lib.hub_predict.argtypes = [ctypes.c_void_p, D, ctypes.c_double, ctypes.c_double, D]
    _lib = lib
    return _lib


def available():
    return load() is not None


class NativeSensorHub:
    """Native IMU pairing + frame association + IMU-rate prediction."""

    def __init__(self, imu_capacity=256):
        self._lib = load()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self._h = self._lib.hub_create()
        self.cap = imu_capacity
        self._ts = np.zeros(imu_capacity)
        self._ws = np.zeros((imu_capacity, 3))
        self._as = np.zeros((imu_capacity, 3))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.hub_destroy(self._h)
            self._h = None

    def push_gyro(self, t, x, y, z):
        self._lib.hub_push_gyro(self._h, t, x, y, z)

    def push_accel(self, t, x, y, z):
        self._lib.hub_push_accel(self._h, t, x, y, z)

    def push_frame(self, frame_id, t):
        self._lib.hub_push_frame(self._h, frame_id, t)

    def poll_frame(self):
        """(id, t, ts, ws, accs) of the oldest frame whose IMU span is
        complete, or None."""
        fid = ctypes.c_int64()
        ft = ctypes.c_double()
        D = ctypes.POINTER(ctypes.c_double)
        n = self._lib.hub_poll_frame(
            self._h, ctypes.byref(fid), ctypes.byref(ft), self._ts.ctypes.data_as(D),
            self._ws.ctypes.data_as(D), self._as.ctypes.data_as(D), self.cap)
        if n < 0:
            return None
        return (int(fid.value), float(ft.value), self._ts[:n].copy(),
                self._ws[:n].copy(), self._as[:n].copy())

    def predict(self, state16, t0, t_now):
        """state16 = [q(4) p(3) v(3) bg(3) ba(3)] -> (q(4), p(3))."""
        s = np.ascontiguousarray(state16, dtype=np.float64)
        out = np.zeros(7)
        D = ctypes.POINTER(ctypes.c_double)
        self._lib.hub_predict(self._h, s.ctypes.data_as(D), t0, t_now, out.ctypes.data_as(D))
        return out[:4].copy(), out[4:].copy()

"""ctypes binding of the native dataset loader (`csrc/pvio_loader.cpp`).

The port's own copy of `pvio_tpu/io/native_loader.py`: `load`, `available`
and `NativeEurocReader` (CSV parse, time-sorted merge and grayscale image
decode with libpng / PGM / NPY on a background prefetch thread, so disk and
zlib work never stall the tracking loop). The library is built on first
use with g++ (`-lpng -lz -lpthread`) into the git-ignored
`pvio_torch/_build/`, never beside the source; the build writes a temporary
file and renames it, so processes that build at once do not see a partial
library. `available()` is False without a compiler or libpng, and
`io/datasets.open_dataset` then warns and takes the Python reader.
"""

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parents[2] / "csrc" / "pvio_loader.cpp"
_SO = Path(__file__).resolve().parents[1] / "_build" / "libpvioloader.so"
_lib = None
_tried = False


def _build():
    _SO.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_SO.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-o", tmp, str(_SRC),
                        "-lpng", "-lz", "-lpthread"], check=True, capture_output=True)
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
    lib.loader_open.restype = ctypes.c_void_p
    lib.loader_open.argtypes = [ctypes.c_char_p]
    lib.loader_close.argtypes = [ctypes.c_void_p]
    lib.loader_counts.restype = ctypes.c_int64
    lib.loader_counts.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_int64),
                                  ctypes.POINTER(ctypes.c_int64)]
    lib.loader_next.restype = ctypes.c_int
    lib.loader_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.loader_fetch_last.restype = ctypes.c_int
    lib.loader_fetch_last.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    lib.loader_rewind.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available():
    return load() is not None


class NativeEurocReader:
    """Streams ('gyroscope'|'accelerometer'|'camera', t, payload) events
    like datasets.EurocDatasetReader, but with native parsing/decoding and
    read-ahead. Camera payloads are uint8 (H, W) — the pipeline's native
    transfer format."""

    def __init__(self, root, undistorter=None, image_capacity=4 << 20):
        lib = load()
        if lib is None:
            raise RuntimeError("native loader unavailable")
        self._lib = lib
        self._h = lib.loader_open(str(root).encode())
        if not self._h:
            raise FileNotFoundError(f"not an ASL/EuRoC dataset: {root}")
        self.undistorter = undistorter
        self._buf = np.zeros(image_capacity, np.uint8)
        self._consumed = False  # set once any iteration starts; next __iter__ rewinds
        n_imu = ctypes.c_int64()
        n_cam = ctypes.c_int64()
        self.n_events = int(lib.loader_counts(
            self._h, ctypes.byref(n_imu), ctypes.byref(n_cam)))
        self.n_imu, self.n_cam = int(n_imu.value), int(n_cam.value)

    def close(self):
        if getattr(self, "_h", None):
            self._lib.loader_close(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def __iter__(self):
        """Stream all events from the start. Like EurocDatasetReader,
        every iteration replays the full dataset: a partially- or
        fully-consumed stream is rewound (native cursor reset + prefetch
        thread restarted) before yielding."""
        if self._h is None:
            raise RuntimeError("native loader: reader is closed")
        lib = self._lib
        if self._consumed:
            lib.loader_rewind(self._h)
        self._consumed = True
        t = ctypes.c_double()
        v3 = np.zeros(3)
        w = ctypes.c_int64()
        h = ctypes.c_int64()
        D = ctypes.POINTER(ctypes.c_double)
        U8 = ctypes.POINTER(ctypes.c_uint8)
        while True:
            if self._h is None:
                raise RuntimeError("native loader: reader closed mid-iteration")
            kind = lib.loader_next(
                self._h, ctypes.byref(t), v3.ctypes.data_as(D),
                self._buf.ctypes.data_as(U8), self._buf.size,
                ctypes.byref(w), ctypes.byref(h))
            if kind == -3:  # grow the buffer and retrieve the stashed image
                self._buf = np.zeros(int(w.value) * int(h.value), np.uint8)
                if lib.loader_fetch_last(
                        self._h, self._buf.ctypes.data_as(U8), self._buf.size) != 0:
                    raise RuntimeError("native loader: image fetch failed")
                kind = 2
            if kind == -1:
                return
            if kind == -2:
                raise RuntimeError("native loader: image decode failed")
            if kind == 0:
                yield ("gyroscope", float(t.value), tuple(v3))
            elif kind == 1:
                yield ("accelerometer", float(t.value), tuple(v3))
            else:
                n = int(w.value) * int(h.value)
                img = self._buf[:n].reshape(int(h.value), int(w.value)).copy()
                if self.undistorter is not None:
                    img = self.undistorter.apply(img)
                yield ("camera", float(t.value), img)

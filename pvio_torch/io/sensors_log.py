"""Streaming binary sensor-log format: `sensors://` / `legacy-sensors://`.

The port's own copy of `pvio_tpu/io/sensors_log.py`: `SensorsLogWriter`,
`SensorsStreamParser`, `SensorsDatasetReader`, `LegacySensorsDatasetReader`
and `convert_events_to_log`, the same wire format and dispatch order.

Role parity with the reference's SensorsDatasetReader /
LegacySensorsDatasetReader (pvio-pc/src/sensors_dataset_reader.cpp:24-117,
legacy_sensors_dataset_reader.cpp:26-120). The reference delegates the wire
format to an external, non-vendored `libsensors` (sensors-toolkit); what it
pins down — and what we preserve — is the *behavior*:

  * the file is consumed in fixed 8192-byte chunks fed to an incremental
    parser (`sensors->parse_data(buffer, len)`,
    sensors_dataset_reader.cpp:88-96) that emits gyro / accel / image
    callbacks as records complete across chunk boundaries;
  * pending records from the three streams are dispatched in timestamp
    order with the reference's exact tie-breaks: accel wins ties against
    both, gyro wins ties against image but loses to accel
    (sensors_dataset_reader.cpp:62-99);
  * the legacy variant stores accelerometer samples in g units and scales
    them by GRAVITY_NOMINAL = -9.80665 on read
    (legacy_sensors_dataset_reader.cpp:27,43).

Since libsensors' framing is unavailable, this module defines a documented
little-endian format ("PVSN v1"):

    header:  magic b"PVSN" | u32 version (=1)
    record:  u8 type | f64 t | payload
      type 1 gyroscope      payload = 3 x f64 (x, y, z)
      type 2 accelerometer  payload = 3 x f64 (x, y, z)
      type 3 image          payload = u32 width | u32 height
                                      | width*height x u8 grayscale

A writer is provided so datasets can be converted and tests can
round-trip the stream.
"""

import struct
from collections import deque

import numpy as np

MAGIC = b"PVSN"
VERSION = 1
GYROSCOPE = 1
ACCELEROMETER = 2
IMAGE = 3
GRAVITY_NOMINAL = -9.80665  # legacy_sensors_dataset_reader.cpp:27
CHUNK = 8192                # sensors_dataset_reader.cpp:89

_HDR = struct.Struct("<4sI")
_REC = struct.Struct("<Bd")
_VEC3 = struct.Struct("<3d")
_IMDIM = struct.Struct("<II")


class SensorsLogWriter:
    """Append-only writer of the PVSN v1 stream."""

    def __init__(self, path):
        self.f = open(path, "wb")
        self.f.write(_HDR.pack(MAGIC, VERSION))

    def put_gyroscope(self, t, w):
        self.f.write(_REC.pack(GYROSCOPE, float(t)))
        self.f.write(_VEC3.pack(*[float(v) for v in w]))

    def put_accelerometer(self, t, a):
        self.f.write(_REC.pack(ACCELEROMETER, float(t)))
        self.f.write(_VEC3.pack(*[float(v) for v in a]))

    def put_image(self, t, image):
        """image: (H, W) uint8, or float in [0, 1] (converted)."""
        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
        h, w = img.shape
        self.f.write(_REC.pack(IMAGE, float(t)))
        self.f.write(_IMDIM.pack(w, h))
        self.f.write(img.tobytes())

    def close(self):
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SensorsStreamParser:
    """Incremental chunk parser — the libsensors::Sensors::parse_data role
    (sensors_dataset_reader.cpp:24-49). Complete records are appended to
    the pending deques; partial records survive across chunks."""

    def __init__(self, accel_scale=1.0):
        self.buf = bytearray()
        self.header_seen = False
        self.accel_scale = accel_scale
        self.pending_images = deque()
        self.pending_gyroscopes = deque()
        self.pending_accelerometers = deque()

    def parse_data(self, chunk):
        self.buf.extend(chunk)
        if not self.header_seen:
            if len(self.buf) < _HDR.size:
                return
            magic, version = _HDR.unpack_from(self.buf, 0)
            if magic != MAGIC or version != VERSION:
                raise ValueError(
                    f"not a PVSN v{VERSION} sensors log (magic={magic!r}, "
                    f"version={version})"
                )
            del self.buf[:_HDR.size]
            self.header_seen = True
        while True:
            if len(self.buf) < _REC.size:
                return
            rtype, t = _REC.unpack_from(self.buf, 0)
            off = _REC.size
            if rtype in (GYROSCOPE, ACCELEROMETER):
                if len(self.buf) < off + _VEC3.size:
                    return
                v = _VEC3.unpack_from(self.buf, off)
                off += _VEC3.size
                if rtype == GYROSCOPE:
                    self.pending_gyroscopes.append((t, v))
                else:
                    s = self.accel_scale
                    self.pending_accelerometers.append(
                        (t, (s * v[0], s * v[1], s * v[2]))
                    )
            elif rtype == IMAGE:
                if len(self.buf) < off + _IMDIM.size:
                    return
                w, h = _IMDIM.unpack_from(self.buf, off)
                off += _IMDIM.size
                if len(self.buf) < off + w * h:
                    return
                img = (
                    np.frombuffer(bytes(self.buf[off:off + w * h]), np.uint8)
                    .reshape(h, w)
                    .astype(np.float32)
                    / 255.0
                )
                off += w * h
                self.pending_images.append((t, img))
            else:
                raise ValueError(f"corrupt sensors log: record type {rtype}")
            del self.buf[:off]


class SensorsDatasetReader:
    """Chunked streaming reader with the reference's timestamp-ordered
    dispatch (sensors_dataset_reader.cpp:62-117)."""

    accel_scale = 1.0

    def __init__(self, path, undistorter=None):
        self.f = open(path, "rb")
        self.parser = SensorsStreamParser(accel_scale=self.accel_scale)
        self.undistorter = undistorter

    def __iter__(self):
        p = self.parser
        inf = float("inf")
        while True:
            image_t = p.pending_images[0][0] if p.pending_images else inf
            gyro_t = p.pending_gyroscopes[0][0] if p.pending_gyroscopes else inf
            accel_t = (
                p.pending_accelerometers[0][0]
                if p.pending_accelerometers else inf
            )
            if image_t < inf or gyro_t < inf or accel_t < inf:
                # reference tie-break order, sensors_dataset_reader.cpp:78-85
                if accel_t <= image_t and accel_t <= gyro_t:
                    t, a = p.pending_accelerometers.popleft()
                    yield ("accelerometer", t, a)
                elif gyro_t <= image_t and gyro_t < accel_t:
                    t, w = p.pending_gyroscopes.popleft()
                    yield ("gyroscope", t, w)
                else:
                    t, img = p.pending_images.popleft()
                    if self.undistorter is not None:
                        img = np.asarray(self.undistorter.apply(img))
                    yield ("camera", t, img)
            else:
                chunk = self.f.read(CHUNK)
                if not chunk:
                    return
                p.parse_data(chunk)


class LegacySensorsDatasetReader(SensorsDatasetReader):
    """Legacy logs store accel in g units — scale by GRAVITY_NOMINAL
    (legacy_sensors_dataset_reader.cpp:43)."""

    accel_scale = GRAVITY_NOMINAL


def convert_events_to_log(events, path):
    """Write an event stream (('gyroscope'|'accelerometer'|'camera', t,
    payload)) to a PVSN log — dataset conversion utility."""
    with SensorsLogWriter(path) as wtr:
        for kind, t, payload in events:
            if kind == "gyroscope":
                wtr.put_gyroscope(t, payload)
            elif kind == "accelerometer":
                wtr.put_accelerometer(t, payload)
            elif kind == "camera":
                wtr.put_image(t, payload)
    return path

"""Dataset readers: EuRoC MAV and TUM-VI, with URL-scheme dispatch.

The port's own copy of `pvio_tpu/io/datasets.py`: `_load_image`,
`EurocDatasetReader`, `TumDatasetReader`, `open_dataset` and
`run_dataset` (reference pvio-pc dataset readers: `euroc://`, `tum://`
scheme factory; cam0/imu0 CSV parsing with ns -> s conversion and a
time-sorted merge; TUM-VI's 512 fisheye with equidistant undistortion).

Readers yield a time-ordered stream of sensor events:
    ("gyroscope", t, (x, y, z))
    ("accelerometer", t, (x, y, z))
    ("camera", t, image (H, W): uint8 from the native loader, float in
     [0, 1] from the Python reader)

`open_dataset` prefers the native loader (`io/native_loader.py`) and, when
it cannot be built or the path is not an ASL directory, warns and takes
the Python reader, as the reference does; that choice is host file I/O
and never touches the device. Image decoding in the Python reader uses PIL
or imageio when available and raw .npy otherwise.
"""

import csv
import os
from pathlib import Path

import numpy as np

from pvio_torch.io.undistort import ImageUndistorter


def _load_image(path):
    path = str(path)
    if path.endswith(".npy"):
        img = np.load(path)
    else:
        try:
            from PIL import Image

            img = np.asarray(Image.open(path).convert("L"))
        except ImportError:
            try:
                import imageio.v3 as iio

                img = iio.imread(path)
                if img.ndim == 3:
                    img = img.mean(axis=-1)
            except ImportError as e:
                raise RuntimeError(
                    f"no image decoder available for {path}; install pillow "
                    "or convert images to .npy"
                ) from e
    img = np.asarray(img, np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    return img


class EurocDatasetReader:
    """ASL-format reader: <root>/mav0/{cam0,imu0}/data.csv
    (euroc_dataset_reader.cpp:21-104)."""

    def __init__(self, root, undistorter: ImageUndistorter = None):
        root = Path(root)
        if (root / "mav0").exists():
            root = root / "mav0"
        self.root = root
        self.undistorter = undistorter
        self.events = []
        imu_csv = root / "imu0" / "data.csv"
        with open(imu_csv) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                t = int(row[0]) * 1e-9
                w = tuple(float(v) for v in row[1:4])
                a = tuple(float(v) for v in row[4:7])
                # gyro first at equal t (reference emits gyro then accel)
                self.events.append((t, 0, ("gyroscope", w)))
                self.events.append((t, 1, ("accelerometer", a)))
        cam_csv = root / "cam0" / "data.csv"
        with open(cam_csv) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                t = int(row[0]) * 1e-9
                self.events.append((t, 2, ("camera", root / "cam0" / "data" / row[1].strip())))
        self.events.sort(key=lambda e: (e[0], e[1]))

    def __iter__(self):
        for t, _, (kind, payload) in self.events:
            if kind == "camera":
                img = _load_image(payload)
                if self.undistorter is not None:
                    img = np.asarray(self.undistorter.apply(img))
                yield ("camera", t, img)
            else:
                yield (kind, t, payload)


class TumDatasetReader(EurocDatasetReader):
    """TUM-VI uses the same ASL directory layout; fisheye images must be
    remapped with an equidistant undistorter (tum_dataset_reader.cpp:73-81)."""


def open_dataset(url, config=None, native=True):
    """URL-scheme dispatch (dataset_reader.cpp:34-46):
    euroc://<path>, tum://<path>.

    `native=True` prefers the C++ loader (csrc/pvio_loader.cpp: CSV parse,
    libpng decode, prefetch thread) when buildable, mirroring the
    reference's C++ readers; falls back to the Python reader."""
    if "://" not in url:
        scheme, path = "euroc", url
    else:
        scheme, path = url.split("://", 1)
    und = None
    if config is not None and config.camera_distortion is not None:
        und = ImageUndistorter(config.K, config.camera_distortion,
                               config.camera_distortion_model, config.image_size)
    if scheme in ("euroc", "tum") and native:
        try:
            from pvio_torch.io.native_loader import NativeEurocReader

            return NativeEurocReader(path, und)
        except (RuntimeError, FileNotFoundError) as e:
            # only the expected "native loader unavailable / not an ASL
            # dataset" cases fall back — and audibly, because the Python
            # reader also changes the camera payload dtype (uint8 vs
            # float [0,1]); real decode/undistorter bugs propagate
            import warnings

            warnings.warn(
                f"native dataset loader unavailable ({e}); using the "
                "Python reader (camera payloads become float [0,1])",
                RuntimeWarning, stacklevel=2)
    if scheme == "euroc":
        return EurocDatasetReader(path, und)
    if scheme == "tum":
        return TumDatasetReader(path, und)
    if scheme == "sensors":
        from pvio_torch.io.sensors_log import SensorsDatasetReader

        return SensorsDatasetReader(path, und)
    if scheme == "legacy-sensors":
        from pvio_torch.io.sensors_log import LegacySensorsDatasetReader

        return LegacySensorsDatasetReader(path, und)
    raise ValueError(f"unknown dataset scheme {scheme!r}")


def run_dataset(vio, reader, output_writer=None, max_frames=None,
                on_frame=None):
    """Drive a PVIO engine from a dataset stream (pvio-pc main.cpp role).
    Returns the trajectory [(t, q, p)]."""
    n = 0
    for kind, t, payload in reader:
        if kind == "gyroscope":
            vio.track_gyroscope(t, *payload)
        elif kind == "accelerometer":
            vio.track_accelerometer(t, *payload)
        elif kind == "camera":
            pose = vio.track_camera(t, payload)
            if pose is not None and output_writer is not None:
                output_writer.write_pose(pose.t, pose.q, pose.p)
            if on_frame is not None:
                on_frame(t)
            n += 1
            if max_frames is not None and n >= max_frames:
                break
    return vio.get_trajectory()

"""Image undistortion with precomputed remap tables.

The port's own copy of `pvio_tpu/io/undistort.py`, host numpy as there:
`_distort_radtan`, `_distort_equidistant`, `undistort_points` and
`ImageUndistorter` (`apply`), for the radial-tangential (radtan) and
equidistant (fisheye, TUM-VI) models. The remap table is built once; each
image is remapped on the host by a bilinear gather, as the dataset
readers' images arrive there (the reference remaps with cv::remap on the
CPU too), so the card only ever receives the undistorted uint8 frame.
"""

import numpy as np


def _distort_radtan(x, y, k1, k2, p1, p2):
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return xd, yd


def _distort_equidistant(x, y, k1, k2, k3, k4):
    r = np.sqrt(x * x + y * y)
    r = np.where(r < 1e-12, 1e-12, r)
    theta = np.arctan(r)
    t2 = theta * theta
    theta_d = theta * (1 + k1 * t2 + k2 * t2**2 + k3 * t2**3 + k4 * t2**4)
    scale = theta_d / r
    return x * scale, y * scale


def undistort_points(xd, yd, distortion, model, iters=10):
    """Invert the distortion model: distorted normalized coords -> true
    (pinhole) normalized coords. The forward models above are what the
    reference's ImageUndistorter bakes into its remap tables
    (image_undistorter.h:61-93); the inverse is needed to *synthesize*
    distorted imagery (ray direction of a distorted pixel) and mirrors
    cv::undistortPoints' iterative scheme."""
    xd = np.asarray(xd, np.float64)
    yd = np.asarray(yd, np.float64)
    if model in (None, "none"):
        return xd, yd
    if model == "radtan":
        k1, k2, p1, p2 = (list(distortion) + [0.0] * 4)[:4]
        x, y = xd.copy(), yd.copy()
        for _ in range(iters):  # fixed-point: x <- xd - (distort(x) - x)
            xh, yh = _distort_radtan(x, y, k1, k2, p1, p2)
            x = x + (xd - xh)
            y = y + (yd - yh)
        return x, y
    if model == "equidistant":
        k1, k2, k3, k4 = (list(distortion) + [0.0] * 4)[:4]
        rd = np.sqrt(xd * xd + yd * yd)
        rd_s = np.where(rd < 1e-12, 1e-12, rd)
        theta = rd.copy()  # Newton on theta_d(theta) = rd
        for _ in range(iters):
            t2 = theta * theta
            f = theta * (1 + k1 * t2 + k2 * t2**2 + k3 * t2**3 + k4 * t2**4) - rd
            df = (1 + 3 * k1 * t2 + 5 * k2 * t2**2 + 7 * k3 * t2**3
                  + 9 * k4 * t2**4)
            theta = theta - f / np.where(np.abs(df) < 1e-9, 1e-9, df)
        scale = np.tan(theta) / rd_s
        return xd * scale, yd * scale
    raise ValueError(f"unknown distortion model {model!r}")


class ImageUndistorter:
    """Precomputes the map from undistorted pixels to distorted source
    pixels; apply() remaps an image so the pinhole model K holds."""

    def __init__(self, K, distortion, model, image_size):
        W, H = image_size
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        xs = (np.arange(W) - cx) / fx
        ys = (np.arange(H) - cy) / fy
        X, Y = np.meshgrid(xs, ys)
        if model == "radtan":
            k1, k2, p1, p2 = (list(distortion) + [0.0] * 4)[:4]
            Xd, Yd = _distort_radtan(X, Y, k1, k2, p1, p2)
        elif model == "equidistant":
            k1, k2, k3, k4 = (list(distortion) + [0.0] * 4)[:4]
            Xd, Yd = _distort_equidistant(X, Y, k1, k2, k3, k4)
        elif model in (None, "none"):
            Xd, Yd = X, Y
        else:
            raise ValueError(f"unknown distortion model {model!r}")
        # remap runs on the host as part of dataset IO (the reference's
        # cv::remap is host-side too, opencv_image.cpp); precompute
        # integer indices + bilinear weights once.
        mx = np.clip(Xd * fx + cx, 0.0, W - 1.001)
        my = np.clip(Yd * fy + cy, 0.0, H - 1.001)
        x0 = np.floor(mx).astype(np.int32)
        y0 = np.floor(my).astype(np.int32)
        self._x0, self._y0 = x0, y0
        self._fx = (mx - x0).astype(np.float32)
        self._fy = (my - y0).astype(np.float32)
        self.map_x = mx.astype(np.float32)
        self.map_y = my.astype(np.float32)

    def apply(self, img):
        """Bilinear remap (host numpy). uint8 in -> uint8 out (the
        pipeline's native transfer format); float stays float32."""
        src = np.asarray(img)
        was_u8 = src.dtype == np.uint8
        f = src.astype(np.float32)
        # guard against sources smaller than the table's target geometry
        x0 = np.minimum(self._x0, src.shape[1] - 2)
        y0 = np.minimum(self._y0, src.shape[0] - 2)
        fx_, fy_ = self._fx, self._fy
        out = ((f[y0, x0] * (1 - fy_) + f[y0 + 1, x0] * fy_) * (1 - fx_)
               + (f[y0, x0 + 1] * (1 - fy_) + f[y0 + 1, x0 + 1] * fy_) * fx_)
        if was_u8:
            return np.clip(out + 0.5, 0, 255).astype(np.uint8)
        return out

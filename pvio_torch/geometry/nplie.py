"""Numpy Lie-group helpers for host-side bookkeeping math.

The port's own copy of `pvio_tpu/geometry/nplie.py`: `hat`, `quat_mul`,
`quat_conj`, `quat_normalize`, `quat_to_mat`, `quat_rotate`,
`mat_to_quat`, `expmap`, `logmap`, `s2_tangential_basis`, with the same
formulas. The host state machines (IMU-rate pose propagation in `Core`,
the initializer's gravity/scale solve) do tiny 3/4-vector math per sample
or frame; running it through torch would launch a device operation for
every add. Device steps keep using `geometry.lie`.

Quaternions are wxyz, as in `geometry.lie`.
"""

import numpy as np


def hat(w):
    w = np.asarray(w)
    return np.array([
        [0.0, -w[2], w[1]],
        [w[2], 0.0, -w[0]],
        [-w[1], w[0], 0.0],
    ])


def quat_mul(p, q):
    pw, px, py, pz = p
    qw, qx, qy, qz = q
    return np.array([
        pw * qw - px * qx - py * qy - pz * qz,
        pw * qx + px * qw + py * qz - pz * qy,
        pw * qy - px * qz + py * qw + pz * qx,
        pw * qz + px * qy - py * qx + pz * qw,
    ])


def quat_conj(q):
    return np.asarray(q) * np.array([1.0, -1.0, -1.0, -1.0])


def quat_normalize(q):
    q = np.asarray(q, np.float64)
    return q / np.linalg.norm(q)


def quat_to_mat(q):
    """(..., 4) wxyz quaternion(s) -> (..., 3, 3) rotation matrices."""
    q = np.asarray(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], axis=-1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], axis=-1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], axis=-1),
    ], axis=-2)
    return rows


def quat_rotate(q, v):
    """Rotate v by q. Supports batched q (N,4) with v (N,3) or single."""
    q = np.asarray(q, np.float64)
    v = np.asarray(v, np.float64)
    if q.ndim == 1:
        return quat_to_mat(q) @ v
    qw, qv = q[:, :1], q[:, 1:]
    t = 2.0 * np.cross(qv, v)
    return v + qw * t + np.cross(qv, t)


def mat_to_quat(R):
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return quat_normalize([0.25 * s,
                               (R[2, 1] - R[1, 2]) / s,
                               (R[0, 2] - R[2, 0]) / s,
                               (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-18)) * 2
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return quat_normalize(q)


def expmap(w):
    w = np.asarray(w, np.float64)
    theta = np.linalg.norm(w)
    if theta < 1e-12:
        return quat_normalize(np.concatenate([[1.0], 0.5 * w]))
    half = 0.5 * theta
    return np.concatenate([[np.cos(half)], np.sin(half) * (w / theta)])


def logmap(q):
    q = np.asarray(q, np.float64)
    if q[0] < 0:
        q = -q
    nv = np.linalg.norm(q[1:])
    if nv < 1e-12:
        return 2.0 * q[1:]
    return 2.0 * np.arctan2(nv, q[0]) * (q[1:] / nv)


def s2_tangential_basis(x):
    """Two unit vectors orthogonal to x (lie_algebra.cpp:61-75)."""
    x = np.asarray(x, np.float64)
    ref = np.array([0.0, 0.0, 1.0]) if abs(x[2]) < 0.9 else np.array([1.0, 0.0, 0.0])
    b0 = np.cross(x, ref)
    b0 /= np.linalg.norm(b0)
    b1 = np.cross(x, b0)
    b1 /= np.linalg.norm(b1)
    return np.stack([b0, b1], axis=1)

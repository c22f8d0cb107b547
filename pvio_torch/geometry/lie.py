"""SO(3)/quaternion helpers on torch tensors.

Matches `pvio_tpu/geometry/lie.py`: `mm`, `mv`, `hat`, `quat_mul`,
`quat_conj`, `quat_normalize`, `quat_rotate`, `quat_to_mat`, `expmap`,
`logmap`, `right_jacobian`, `right_jacobian_inv`, `s2_tangential_basis`.
Quaternions are (..., 4)
ordered (w, x, y, z), Hamilton product; every function broadcasts over
leading batch dimensions and keeps the input dtype. Small-angle branches
use the same guarded Taylor series, so values (and forward-mode
derivatives through `torch.func`) stay finite at zero angle.
"""

import torch

# Angle^2 below this uses the Taylor series branch.
_EPS2 = 1e-12


def mm(A, B):
    """Batched small-matrix product (..., n, k) @ (..., k, m)."""
    return torch.matmul(A, B)


def mv(A, x):
    """Batched small matrix-vector product (..., n, k) @ (..., k)."""
    return torch.matmul(A, x.unsqueeze(-1)).squeeze(-1)


def _safe(x2):
    """x2 clamped away from zero plus the small-angle mask."""
    small = x2 < _EPS2
    return torch.where(small, torch.ones_like(x2), x2), small


def hat(w):
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def quat_mul(p, q):
    """Hamilton product of (..., 4) quaternions (w, x, y, z)."""
    pw, px, py, pz = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            pw * qw - px * qx - py * qy - pz * qz,
            pw * qx + px * qw + py * qz - pz * qy,
            pw * qy - px * qz + py * qw + pz * qx,
            pw * qz + px * qy - py * qx + pz * qw,
        ],
        dim=-1,
    )


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_rotate(q, v):
    """Rotate vectors v (..., 3) by unit quaternions q (..., 4)."""
    w = q[..., :1]
    u = q[..., 1:]
    u, v = torch.broadcast_tensors(u, v)
    uv = torch.linalg.cross(u, v, dim=-1)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=-1))


def quat_to_mat(q):
    """(..., 4) -> (..., 3, 3) rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
        ],
        dim=-2,
    )


def expmap(w):
    """Rotation vector (..., 3) -> unit quaternion (..., 4)."""
    t2 = torch.sum(w * w, dim=-1, keepdim=True)
    t2s, small = _safe(t2)
    t = torch.sqrt(t2s)
    half = 0.5 * t
    s = torch.where(small, 0.5 - t2 / 48.0, torch.sin(half) / t)
    c = torch.where(small, 1.0 - t2 / 8.0, torch.cos(half))
    return torch.cat([c, s * w], dim=-1)


def logmap(q):
    """Unit quaternion (..., 4) -> rotation vector (..., 3), |w| in [0, pi]."""
    w0 = q[..., :1]
    q = q * torch.sign(torch.where(w0 == 0, torch.ones_like(w0), w0))
    w = q[..., :1]
    u = q[..., 1:]
    n2 = torch.sum(u * u, dim=-1, keepdim=True)
    n2s, small = _safe(n2)
    n = torch.sqrt(n2s)
    angle = 2.0 * torch.atan2(n, w)
    scale = torch.where(small, 2.0 / torch.clamp(w, min=0.5), angle / n)
    return scale * u


def _eye3(ref):
    return torch.eye(3, dtype=ref.dtype, device=ref.device)


def right_jacobian(w):
    """SO(3) right Jacobian Jr(w): (..., 3) -> (..., 3, 3)."""
    t2 = torch.sum(w * w, dim=-1)
    t2s, small = _safe(t2)
    t = torch.sqrt(t2s)
    a = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / t2s)
    b = torch.where(small, 1.0 / 6.0 - t2 / 120.0, (t - torch.sin(t)) / (t2s * t))
    W = hat(w)
    return _eye3(w) - a[..., None, None] * W + b[..., None, None] * mm(W, W)


def right_jacobian_inv(w):
    """Inverse right Jacobian Jr^{-1}(w)."""
    t2 = torch.sum(w * w, dim=-1)
    t2s, small = _safe(t2)
    t = torch.sqrt(t2s)
    sin_t = torch.sin(t)
    sin_ts = torch.where(torch.abs(sin_t) < 1e-12, torch.ones_like(sin_t), sin_t)
    c = torch.where(
        small,
        1.0 / 12.0 + t2 / 720.0,
        1.0 / t2s - (1.0 + torch.cos(t)) / (2.0 * t * sin_ts),
    )
    W = hat(w)
    return _eye3(w) + 0.5 * W + c[..., None, None] * mm(W, W)


def s2_tangential_basis(x):
    """Orthonormal basis of the tangent plane at x on S^2: (..., 3) ->
    (..., 3, 2). Crosses x with the unit axis least aligned with it; ties
    go to the lower axis (`torch.argmin` and `jnp.argmin` both return the
    first minimum), so (0, 0, 1) takes the x axis."""
    idx = torch.argmin(torch.abs(x), dim=-1)
    e = _eye3(x)[idx]
    b0 = torch.linalg.cross(x, e, dim=-1)
    b0 = b0 / torch.linalg.norm(b0, dim=-1, keepdim=True)
    b1 = torch.linalg.cross(x, b0, dim=-1)
    b1 = b1 / torch.linalg.norm(b1, dim=-1, keepdim=True)
    return torch.stack([b0, b1], dim=-1)

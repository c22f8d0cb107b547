"""Pinhole camera helpers on torch tensors.

Matches `pvio_tpu/geometry/camera.py`: `apply_k`, `remove_k`, `project`,
`dproj_dp`. Points are K-normalized image coordinates; all functions
broadcast over leading batch dims.
"""

import torch


def apply_k(p, K):
    """Normalized (..., 2) -> pixel coords, K (..., 3, 3)."""
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    return torch.stack([p[..., 0] * fx + cx, p[..., 1] * fy + cy], dim=-1)


def remove_k(p, K):
    """Pixel (..., 2) -> normalized coords."""
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    return torch.stack([(p[..., 0] - cx) / fx, (p[..., 1] - cy) / fy], dim=-1)


def project(p):
    """Camera-frame 3D point (..., 3) -> normalized image point (..., 2),
    safe at z == 0."""
    z = p[..., 2:3]
    tiny = torch.where(z < 0, torch.full_like(z, -1e-12), torch.full_like(z, 1e-12))
    zs = torch.where(torch.abs(z) < 1e-12, tiny, z)
    return p[..., :2] / zs


def dproj_dp(p):
    """Jacobian of `project` w.r.t. the 3D point: (..., 3) -> (..., 2, 3)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    iz = 1.0 / z
    iz2 = iz * iz
    zr = torch.zeros_like(z)
    return torch.stack(
        [
            torch.stack([iz, zr, -x * iz2], dim=-1),
            torch.stack([zr, iz, -y * iz2], dim=-1),
        ],
        dim=-2,
    )

"""Epipolar error and rows, the part of `pvio_tpu/geometry/essential.py`
the F-RANSAC gate needs: `essential_geometric_error`,
`essential_symmetric_error` (`essential.py:36-50`) and `_epipolar_rows`
(`essential.py:66`). The 5-point solver and `decompose_essential` wait for
the initializer slice."""

import torch


def essential_geometric_error(E, p1, p2):
    """Squared epipolar-line distance of p2 from E p1. E (..., 3, 3)
    broadcasts against the leading dims of p1/p2 (..., N, 2)."""
    p1h = torch.cat([p1, torch.ones_like(p1[..., :1])], dim=-1)
    p2h = torch.cat([p2, torch.ones_like(p2[..., :1])], dim=-1)
    Ep1 = torch.matmul(p1h, E.transpose(-1, -2))          # (..., N, 3)
    r = torch.sum(p2h * Ep1, dim=-1)
    denom = torch.clamp(Ep1[..., 0] ** 2 + Ep1[..., 1] ** 2, min=1e-18)
    return r * r / denom


def essential_symmetric_error(E, p1, p2):
    """Two-sided epipolar error."""
    return (essential_geometric_error(E, p1, p2)
            + essential_geometric_error(E.transpose(-1, -2), p2, p1))


def _epipolar_rows(x1, x2):
    """(..., 2) pairs -> rows a with a . vec(E) = 0 (E row-major,
    x2^T E x1 = 0)."""
    u, v = x1[..., 0], x1[..., 1]
    up, vp = x2[..., 0], x2[..., 1]
    one = torch.ones_like(u)
    return torch.stack([up * u, up * v, up, vp * u, vp * v, vp, u, v, one], dim=-1)

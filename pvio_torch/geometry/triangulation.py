"""Multi-view DLT triangulation, batched and masked.

Matches `pvio_tpu/geometry/triangulation.py`: `_dlt_rows`,
`triangulate_homogeneous` and `triangulate_scored` (`MAX_DEPTH` = 100).
The homogeneous point is the smallest eigenvector of A^T A
(`torch.linalg.eigh` for `jnp.linalg.eigh`). Its sign is arbitrary: the
valid point q[:3] / w does not depend on it, but the direction returned
for invalid tracks does, so callers compare invalid entries by their flag
only. Two-view bootstrapping waits for the initializer slice.
"""

import torch

from pvio_torch.geometry.camera import project

MAX_DEPTH = 100.0


def _dlt_rows(P, x):
    """Two DLT rows for one camera: P (..., 3, 4), x (..., 2) -> (..., 2, 4)."""
    r0 = x[..., 0:1] * P[..., 2, :] - P[..., 0, :]
    r1 = x[..., 1:2] * P[..., 2, :] - P[..., 1, :]
    return torch.stack([r0, r1], dim=-2)


def triangulate_homogeneous(Ps, xs, mask=None):
    """DLT point from N views: Ps (..., N, 3, 4), xs (..., N, 2),
    mask (..., N) -> unit homogeneous point (..., 4)."""
    rows = _dlt_rows(Ps, xs)                             # (..., N, 2, 4)
    if mask is not None:
        rows = rows * mask[..., None, None].to(rows.dtype)
    A = rows.reshape(*rows.shape[:-3], -1, 4)
    AtA = A.transpose(-1, -2) @ A
    _, vecs = torch.linalg.eigh(AtA)
    return vecs[..., :, 0]


def triangulate_scored(Ps, xs, mask=None):
    """Triangulate + cheirality/depth check + reprojection score.
    Returns (point (..., 3), valid (...,) bool, score (...,))."""
    q = triangulate_homogeneous(Ps, xs, mask)
    w = q[..., 3]
    qc = torch.matmul(Ps, q[..., None, :, None])[..., 0]  # (..., N, 3)
    z = qc[..., 2]
    ws = torch.where(torch.abs(w) < 1e-18, torch.full_like(w, 1e-18), w)
    depth_ratio = z / ws[..., None]
    ok = (z * w[..., None] > 0) & (depth_ratio < MAX_DEPTH)
    err = torch.sum((project(qc) - xs) ** 2, dim=-1)      # (..., N)
    if mask is not None:
        m = mask.to(q.dtype)
        cnt = torch.clamp(torch.sum(m, dim=-1), min=1.0)
        score = torch.sum(err * m, dim=-1) / cnt
        valid = torch.all(ok | ~mask, dim=-1)
    else:
        score = torch.mean(err, dim=-1)
        valid = torch.all(ok, dim=-1)
    p_valid = q[..., :3] / ws[..., None]
    dirn = q[..., :3] / torch.linalg.norm(q[..., :3], dim=-1, keepdim=True)
    point = torch.where(valid[..., None], p_valid, dirn)
    return point, valid, score

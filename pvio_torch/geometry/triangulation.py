"""Multi-view DLT triangulation, batched and masked.

Matches `pvio_tpu/geometry/triangulation.py`: `_dlt_rows`,
`triangulate_homogeneous`, `triangulate_scored` (`MAX_DEPTH` = 100),
`pose_matrix`, `triangulate_two_view` and `select_rt_hypothesis`
(`triangulation.py:24-141`; the vmap over hypotheses is a batch dim).
The homogeneous point is the smallest eigenvector of A^T A
(`ops.eigh.eigh` for `jnp.linalg.eigh`: `torch.linalg.eigh` on the CPU,
kernel E1 on the card, which reads nothing back to the host; the
initializer's two-view triangulation keeps `torch.linalg.eigh` on the
card, see `triangulate_two_view`). Its sign is arbitrary: the valid
point q[:3] / w does not depend on it, but the direction returned for
invalid tracks does, so callers compare invalid entries by their flag
only.
"""

import torch

from pvio_torch.geometry.camera import project
from pvio_torch.ops import eigh as eigh_op

MAX_DEPTH = 100.0


def _dlt_rows(P, x):
    """Two DLT rows for one camera: P (..., 3, 4), x (..., 2) -> (..., 2, 4)."""
    r0 = x[..., 0:1] * P[..., 2, :] - P[..., 0, :]
    r1 = x[..., 1:2] * P[..., 2, :] - P[..., 1, :]
    return torch.stack([r0, r1], dim=-2)


def triangulate_homogeneous(Ps, xs, mask=None, eigh=None):
    """DLT point from N views: Ps (..., N, 3, 4), xs (..., N, 2),
    mask (..., N) -> unit homogeneous point (..., 4). `eigh` decomposes
    the (..., 4, 4) normal matrices (default `ops.eigh.eigh`)."""
    rows = _dlt_rows(Ps, xs)                             # (..., N, 2, 4)
    if mask is not None:
        rows = rows * mask[..., None, None].to(rows.dtype)
    A = rows.reshape(*rows.shape[:-3], -1, 4)
    AtA = A.transpose(-1, -2) @ A
    _, vecs = (eigh or eigh_op.eigh)(AtA)
    return vecs[..., :, 0]


def triangulate_scored(Ps, xs, mask=None, eigh=None):
    """Triangulate + cheirality/depth check + reprojection score.
    Returns (point (..., 3), valid (...,) bool, score (...,))."""
    q = triangulate_homogeneous(Ps, xs, mask, eigh)
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


def pose_matrix(R, t):
    """(..., 3, 3), (..., 3) -> (..., 3, 4) projection [R | t]."""
    return torch.cat([R, t[..., None]], dim=-1)


def triangulate_two_view(R, t, x1, x2):
    """Two-view batch: R (..., 3, 3) / t (..., 3) map frame-1 coords into
    frame 2 (P1 = [I|0], P2 = [R|t]); x1, x2 (N, 2). Returns (point
    (..., N, 3), valid (..., N), score (..., N))."""
    lead = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    N = x1.shape[-2]
    eye = torch.eye(3, 4, dtype=x1.dtype, device=x1.device)
    P1 = eye.expand(*lead, N, 3, 4)
    P2 = pose_matrix(R, t)[..., None, :, :].expand(*lead, N, 3, 4)
    Ps = torch.stack([P1, P2], dim=-3)
    xs = torch.stack([x1, x2], dim=-2).expand(*lead, N, 2, 2)
    # torch.linalg.eigh on the card too (one host wait, in the initializer
    # only): with E1's float64 solve here, the float32 facade's card
    # positions part from the CPU's by 3.2e-4 m from the first pose on,
    # over tests/test_torch_cuda.py::test_facade_on_card_matches_cpu's
    # 1e-4 m (PERF.md)
    return triangulate_scored(Ps, xs, eigh=torch.linalg.eigh)


def select_rt_hypothesis(Rs, Ts, x1, x2, count_threshold=0, R_prior=None,
                         prior_max_angle=None):
    """Choose among H candidate (R, T) pairs by triangulating all N matches
    under each. Rs (H, 3, 3), Ts (H, 3), x1/x2 (N, 2). Returns (best_idx,
    points (N, 3), status (N,) bool, count).

    Hypotheses whose count exceeds `count_threshold` compete on their mean
    score, else on the count (first index on ties). With `R_prior` (3, 3)
    and `prior_max_angle` (rad), hypotheses farther than the bound from
    the prior are ruled out whenever at least one lies within it."""
    pts, valid, score = triangulate_two_view(Rs, Ts, x1, x2)
    counts = torch.sum(valid, dim=-1)
    total = torch.sum(torch.where(valid, score, torch.zeros_like(score)), dim=-1)
    scores = total / torch.clamp(counts, min=1).to(score.dtype)
    passing = counts > count_threshold
    big = torch.full_like(scores, torch.finfo(scores.dtype).max)
    if R_prior is not None and prior_max_angle is not None:
        dR = Rs @ R_prior.T
        tr = dR[:, 0, 0] + dR[:, 1, 1] + dR[:, 2, 2]
        ang = torch.arccos(torch.clamp(0.5 * (tr - 1.0), -1.0, 1.0))
        within = ang < prior_max_angle
        keep = within | ~torch.any(within)
        scores = torch.where(keep, scores, big)
        counts = torch.where(keep, counts, torch.zeros_like(counts))
        passing = passing & keep
    best_by_score = torch.argmin(torch.where(passing, scores, big))
    best_by_count = torch.argmax(counts)
    best = torch.where(torch.any(passing), best_by_score, best_by_count)
    return best, pts[best], valid[best], counts[best]

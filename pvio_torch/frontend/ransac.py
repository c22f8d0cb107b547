"""Vmapped fixed-budget RANSAC estimators: the 8-point F-RANSAC gate after
KLT and the initializer's two-view models.

Matches `pvio_tpu/frontend/ransac.py`: `_sample_indices`, `_ge_solve`,
`find_essential` (5-point, 64 hypotheses x 10 roots), `find_homography`
(4-point, 256 hypotheses) and `find_fundamental`; the reference's vmaps
over hypotheses are batch dims. The hypothesis batch is drawn with the port's
bit-exact threefry `uniform` (`utils/threefry.py`) from the same key data,
so the port scores the very hypotheses the reference scores. The uniform
draw uses the pipeline dtype, as the reference's default-dtype draw does
(float64 under the tests' x64, float32 in production). `find_plane`
(3-point, 256 hypotheses) and `refine_plane_pca` are the plane extractor's.
"""

import torch

from pvio_torch.geometry import essential as ess
from pvio_torch.geometry import homography as hom
from pvio_torch.utils import threefry
from pvio_torch.utils.transfer import constant


def _sample_indices(key_data, n_hyp, n_sample, mask, dtype):
    """(n_hyp, n_sample) indices drawn from the valid entries of mask:
    the n_sample largest uniform keys per row, ties by lower index."""
    N = mask.shape[0]
    keys = threefry.uniform(key_data, (n_hyp, N), dtype, device=mask.device)
    keys = torch.where(mask[None, :], keys, torch.full_like(keys, -1.0))
    _, idx = torch.sort(keys, dim=-1, descending=True, stable=True)
    return idx[:, :n_sample]


def find_essential(key_data, x1, x2, mask, threshold=1.0, n_hyp=64):
    """5-pt RANSAC for E on normalized coords: symmetric epipolar error
    < 2 * 3.84 * threshold^2; candidates without a real root count -1.
    Returns (E, inlier_mask, count)."""
    thr = 2.0 * 3.84 * threshold * threshold
    idx = _sample_indices(key_data, n_hyp, 5, mask, x1.dtype)
    Es, ok = ess.solve_essential_5pt(x1[idx], x2[idx])       # (H, 10, 3, 3)
    Es = Es.reshape(-1, 3, 3)
    ok = ok.reshape(-1)
    errs = ess.essential_symmetric_error(Es, x1, x2)          # (H*10, N)
    inls = (errs < thr) & mask[None, :]
    counts = torch.where(ok, torch.sum(inls, dim=-1), torch.full_like(ok, -1, dtype=torch.int64))
    best = torch.argmax(counts)
    return Es[best], inls[best], counts[best]


def find_homography(key_data, x1, x2, mask, threshold=1.0, n_hyp=256):
    """4-pt RANSAC for H on normalized coords (two-sided transfer error
    < 2 * 5.99 * threshold^2). Returns (H, inlier_mask, count)."""
    thr = 2.0 * 5.99 * threshold * threshold
    idx = _sample_indices(key_data, n_hyp, 4, mask, x1.dtype)
    Hs = hom.solve_homography(x1[idx], x2[idx])               # (H, 3, 3)
    errs = (hom.homography_geometric_error(Hs, x1, x2)
            + hom.homography_geometric_error(hom.inv3(Hs), x2, x1))
    inls = (errs < thr) & mask[None, :]
    counts = torch.sum(inls, dim=-1)
    best = torch.argmax(counts)
    return Hs[best], inls[best], counts[best]


def _ge_solve(A, b):
    """Batched unpivoted Gaussian elimination for small systems
    A (..., n, n) x = b (..., n)."""
    n = A.shape[-1]
    M = torch.cat([A, b[..., None]], dim=-1)             # (..., n, n+1)
    for k in range(n):
        piv = M[..., k, k]
        piv = torch.where(torch.abs(piv) < 1e-12, torch.full_like(piv, 1e-12), piv)
        row_k = M[..., k, :] / piv[..., None]
        M = M.clone()
        M[..., k, :] = row_k
        fac = M[..., :, k].clone()
        fac[..., k] = 0.0
        M = M - fac[..., None] * row_k[..., None, :]
    return M[..., :, n]


# fixed generic normalization covector of the bordered 8-point system
_F_NORM_C = (1.0, 0.35, -0.6, 0.2, 1.1, 0.15, -0.8, 0.4, 0.55)


def find_fundamental(key_data, x1, x2, mask, threshold=1.0, n_hyp=128):
    """8-pt RANSAC for F on pixel coords. key_data: (2,) uint32 threefry
    key data. Returns (F, inlier_mask, count)."""
    dtype, dev = x1.dtype, x1.device
    thr = 2.0 * 3.84 * threshold * threshold
    idx = _sample_indices(key_data, n_hyp, 8, mask, dtype)   # (H, 8)
    a = x1[idx]                                              # (H, 8, 2)
    b = x2[idx]
    ca, cb = torch.mean(a, dim=1), torch.mean(b, dim=1)      # (H, 2)
    sqrt2 = torch.sqrt(constant(2.0, dtype, dev))
    sa = sqrt2 / torch.clamp(torch.mean(torch.linalg.norm(a - ca[:, None], dim=-1), dim=1), min=1e-9)
    sb = sqrt2 / torch.clamp(torch.mean(torch.linalg.norm(b - cb[:, None], dim=-1), dim=1), min=1e-9)
    an = (a - ca[:, None]) * sa[:, None, None]
    bn = (b - cb[:, None]) * sb[:, None, None]
    rows = ess._epipolar_rows(an, bn)                        # (H, 8, 9)
    c = constant(_F_NORM_C, dtype, dev)
    A9 = torch.cat([rows, c.expand(n_hyp, 1, 9)], dim=1)     # (H, 9, 9)
    e9 = torch.zeros(n_hyp, 9, dtype=dtype, device=dev)
    e9[:, 8] = 1.0
    Fm = _ge_solve(A9, e9).reshape(-1, 3, 3)

    zero = torch.zeros_like(sa)
    one = torch.ones_like(sa)

    def T(s, cc):
        return torch.stack([
            torch.stack([s, zero, -s * cc[:, 0]], dim=-1),
            torch.stack([zero, s, -s * cc[:, 1]], dim=-1),
            torch.stack([zero, zero, one], dim=-1)], dim=-2)

    Fs = T(sb, cb).transpose(-1, -2) @ Fm @ T(sa, ca)         # (H, 3, 3)
    errs = ess.essential_symmetric_error(Fs, x1, x2)          # (H, N)
    inls = (errs < thr) & mask[None, :]
    counts = torch.sum(inls, dim=-1)
    # a 0-d index tensor would be read on the host (`Fs[best]`); a (1,) one
    # stays on the device
    best = torch.argmax(counts)[None]
    return Fs[best][0], inls[best][0], counts[best][0]


def find_plane(key_data, points, mask, threshold=0.03, n_hyp=256):
    """3-point RANSAC plane fit over landmark points (inlier when the
    point-to-plane distance < threshold; degenerate triples count -1).
    Returns (normal (3,), distance, inlier_mask, count) with n.x = d."""
    idx = _sample_indices(key_data, n_hyp, 3, mask, points.dtype)
    p = points[idx]                                           # (H, 3, 3)
    n = torch.linalg.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0], dim=-1)
    norm = torch.linalg.norm(n, dim=-1)
    n = n / torch.where(norm < 1e-12, torch.full_like(norm, 1e-12), norm)[:, None]
    d = torch.sum(n * p[:, 0], dim=-1)
    errs = torch.abs(n @ points.T - d[:, None])               # (H, N)
    inls = (errs < threshold) & mask[None, :]
    counts = torch.where(norm > 1e-12, torch.sum(inls, dim=-1),
                         torch.full_like(norm, -1, dtype=torch.int64))
    best = torch.argmax(counts).reshape(1)                    # (1,): no host read
    return n[best][0], d[best][0], inls[best][0], counts[best][0]


def refine_plane_pca(points, inlier_mask):
    """PCA refinement of a plane from its inliers: the normal is the
    eigenvector of the smallest eigenvalue of the inlier scatter, oriented
    so that the distance is >= 0. Returns (normal, distance, centroid)."""
    m = inlier_mask.to(points.dtype)[:, None]
    cnt = torch.clamp(torch.sum(m), min=1.0)
    c = torch.sum(points * m, dim=0) / cnt
    d = (points - c) * m
    cov = d.T @ d / cnt
    _, V = torch.linalg.eigh(cov)
    n = V[:, 0]
    dist = torch.dot(n, c)
    sgn = torch.where(dist < 0, -torch.ones_like(dist), torch.ones_like(dist))
    return n * sgn, dist * sgn, c

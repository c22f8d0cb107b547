"""Rotation / similarity fitting for trajectory evaluation.

Matches `pvio_tpu/geometry/wahba.py`: `kabsch`, `find_srt` (Umeyama) and
`ate_rmse` (absolute trajectory error after Sim(3) or SE(3) alignment), on
torch tensors. `torch.linalg.svd` stands where the reference calls
`jnp.linalg.svd`; the rotation and the similarity do not depend on the
signs of its singular vectors.
"""

import torch


def kabsch(src, dst, weights=None):
    """Rotation R minimizing sum w_i |R src_i - dst_i|^2; src, dst (N, 3)."""
    if weights is None:
        weights = torch.ones(src.shape[0], dtype=src.dtype, device=src.device)
    H = (weights[:, None] * src).T @ dst
    U, _, Vt = torch.linalg.svd(H)
    d = torch.linalg.det(Vt.T @ U.T)
    D = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    return Vt.T @ D @ U.T


def find_srt(src, dst):
    """Similarity (s, R, t) minimizing |s R src + t - dst|^2."""
    mu_s = torch.mean(src, dim=0)
    mu_d = torch.mean(dst, dim=0)
    cs = src - mu_s
    cd = dst - mu_d
    R = kabsch(cs, cd)
    var_s = torch.sum(cs * cs)
    s = torch.sum(cd * (cs @ R.T)) / torch.clamp(var_s, min=1e-18)
    t = mu_d - s * (R @ mu_s)
    return s, R, t


def ate_rmse(est, gt, with_scale=True):
    """Absolute trajectory error RMSE of positions est, gt (N, 3) after
    Sim(3) (or, without scale, SE(3)) alignment."""
    if with_scale:
        s, R, t = find_srt(est, gt)
    else:
        mu_s = torch.mean(est, dim=0)
        mu_d = torch.mean(gt, dim=0)
        R = kabsch(est - mu_s, gt - mu_d)
        s = torch.ones((), dtype=est.dtype, device=est.device)
        t = mu_d - R @ mu_s
    aligned = s * (est @ R.T) + t
    return torch.sqrt(torch.mean(torch.sum((aligned - gt) ** 2, dim=-1)))

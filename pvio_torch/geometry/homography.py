"""4-point homography estimation + analytic decomposition.

Matches `pvio_tpu/geometry/homography.py`: `_normalize_points`,
`solve_homography` (Hartley-normalized DLT through the eigenvector of the
9x9 normal matrix), `inv3`, `homography_geometric_error` and the branch-free
Malis-Vargas `decompose_homography` (`homography.py:15-171`). Every
function but `decompose_homography` takes leading batch dimensions (the
reference vmaps them over RANSAC hypotheses). `torch.linalg.eigh` / `svd`
stand where the reference calls `jnp.linalg.eigh` / `svd`; H is divided by
H[2, 2] and the pure-rotation R is U V^T, so neither depends on their
column signs.
"""

import torch


def _normalize_points(x):
    """Hartley normalization: (..., N, 2) -> (normalized points, 3x3
    transform, its closed-form inverse)."""
    c = torch.mean(x, dim=-2, keepdim=True)
    d = torch.mean(torch.linalg.norm(x - c, dim=-1), dim=-1)
    s = torch.sqrt(torch.tensor(2.0, dtype=x.dtype)).to(x.device) / torch.clamp(d, min=1e-12)
    xn = (x - c) * s[..., None, None]
    cx, cy = c[..., 0, 0], c[..., 0, 1]
    one, zero = torch.ones_like(s), torch.zeros_like(s)

    def mat(a, b, e):
        return torch.stack([torch.stack([a, zero, b], dim=-1),
                            torch.stack([zero, a, e], dim=-1),
                            torch.stack([zero, zero, one], dim=-1)], dim=-2)

    inv_s = 1.0 / s
    return xn, mat(s, -s * cx, -s * cy), mat(inv_s, cx, cy)


def solve_homography(x1, x2):
    """DLT homography from N >= 4 correspondences (x2 ~ H x1), both
    (..., N, 2) in normalized camera coords. Returns (..., 3, 3) H."""
    p1, T1, _ = _normalize_points(x1)
    p2, _, T2inv = _normalize_points(x2)
    u, v = p1[..., 0], p1[..., 1]
    up, vp = p2[..., 0], p2[..., 1]
    one, zero = torch.ones_like(u), torch.zeros_like(u)
    r1 = torch.stack([u, v, one, zero, zero, zero, -up * u, -up * v, -up], dim=-1)
    r2 = torch.stack([zero, zero, zero, u, v, one, -vp * u, -vp * v, -vp], dim=-1)
    A = torch.cat([r1, r2], dim=-2)
    _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    Hn = vecs[..., :, 0].reshape(*A.shape[:-2], 3, 3)
    H = T2inv @ (Hn @ T1)
    return H / H[..., 2:3, 2:3]


def inv3(M):
    """Closed-form 3x3 inverse via the adjugate, with a sign-preserving
    clamp of the determinant at 1e-18."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    Hc = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    det = torch.where(det >= 0, torch.clamp(det, min=1e-18), torch.clamp(det, max=-1e-18))
    adj = torch.stack([torch.stack([A, B, C], dim=-1),
                       torch.stack([D, E, F], dim=-1),
                       torch.stack([G, Hc, I], dim=-1)], dim=-2)
    return adj / det[..., None, None]


def homography_geometric_error(H, p1, p2):
    """Squared transfer error d(p2, H p1)^2; H (..., 3, 3) broadcasts
    against the leading dims of p1/p2 (..., N, 2)."""
    p1h = torch.cat([p1, torch.ones_like(p1[..., :1])], dim=-1)
    q = torch.matmul(p1h, H.transpose(-1, -2))
    z = q[..., 2:3]
    zs = torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)
    return torch.sum((p2 - q[..., :2] / zs) ** 2, dim=-1)


def _sqrt0(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def decompose_homography(H):
    """Analytic decomposition of one calibrated homography (3, 3).

    Returns (Rs (2, 3, 3), Ts (2, 3), ns (2, 3), is_pure_rotation 0-d
    bool): H scaled by its middle singular value, S = Hn^T Hn - I; pure
    rotation when max |S| <= 1e-3 (R = U V^T, T = n = 0), otherwise the two
    Malis-Vargas solutions, the dominant-diagonal case chosen by a select."""
    dt, dev = H.dtype, H.device
    sv = torch.linalg.svdvals(H)
    Hn = H / sv[1]
    I3 = torch.eye(3, dtype=dt, device=dev)
    S = Hn.T @ Hn - I3
    is_pure_rotation = torch.max(torch.abs(S)) <= 1e-3

    U, _, Vt = torch.linalg.svd(H)
    Rpr = U @ Vt
    Rpr = torch.where(torch.linalg.det(Rpr) < 0, -Rpr, Rpr)

    Ms00 = S[1, 2] * S[1, 2] - S[1, 1] * S[2, 2]
    Ms11 = S[0, 2] * S[0, 2] - S[0, 0] * S[2, 2]
    Ms22 = S[0, 1] * S[0, 1] - S[0, 0] * S[1, 1]
    s00, s11, s22 = _sqrt0(Ms00), _sqrt0(Ms11), _sqrt0(Ms22)
    tr = S[0, 0] + S[1, 1] + S[2, 2]
    nu = 2.0 * _sqrt0(1.0 + tr - Ms00 - Ms11 - Ms22)
    tenormsq = 2.0 + tr - nu

    def sgn(x):
        return torch.where(x < 0, -torch.ones_like(x), torch.ones_like(x))

    e12 = sgn(S[0, 1] * S[0, 2] - S[0, 0] * S[1, 2])
    n1_a = torch.stack([S[0, 0], S[0, 1] + s22, S[0, 2] + e12 * s11])
    n2_a = torch.stack([S[0, 0], S[0, 1] - s22, S[0, 2] - e12 * s11])
    e02 = sgn(S[1, 1] * S[0, 2] - S[0, 1] * S[1, 2])
    n1_b = torch.stack([S[0, 1] + s22, S[1, 1], S[1, 2] - e02 * s00])
    n2_b = torch.stack([S[0, 1] - s22, S[1, 1], S[1, 2] + e02 * s00])
    e01 = sgn(S[1, 2] * S[0, 2] - S[0, 1] * S[2, 2])
    n1_c = torch.stack([S[0, 2] + e01 * s11, S[1, 2] + s00, S[2, 2]])
    n2_c = torch.stack([S[0, 2] - e01 * s11, S[1, 2] - s00, S[2, 2]])

    case = torch.argmax(torch.stack([S[0, 0], S[1, 1], S[2, 2]]))

    def select(a, b, c):
        return torch.where(case == 0, a, torch.where(case == 1, b, c))

    n1 = select(n1_a, n1_b, n1_c)
    n2 = select(n2_a, n2_b, n2_c)
    d = select(S[0, 0], S[1, 1], S[2, 2])
    ds = torch.where(torch.abs(d) < 1e-12, torch.full_like(d, 1e-12), d)
    tstar1 = torch.linalg.norm(n1) * n2 / ds
    tstar2 = torch.linalg.norm(n2) * n1 / ds
    n1 = n1 / torch.clamp(torch.linalg.norm(n1), min=1e-12)
    n2 = n2 / torch.clamp(torch.linalg.norm(n2), min=1e-12)
    tstar1 = tstar1 - tenormsq * n1
    tstar2 = tstar2 - tenormsq * n2
    nus = torch.where(torch.abs(nu) < 1e-12, torch.full_like(nu, 1e-12), nu)
    R1 = Hn @ (I3 - torch.outer(tstar1 / nus, n1))
    R2 = Hn @ (I3 - torch.outer(tstar2 / nus, n2))
    T1 = R1 @ (0.5 * tstar1)
    T2 = R2 @ (0.5 * tstar2)

    zeros3 = torch.zeros(3, dtype=dt, device=dev)
    Rs = torch.where(is_pure_rotation, torch.stack([Rpr, Rpr]), torch.stack([R1, R2]))
    Ts = torch.where(is_pure_rotation, torch.stack([zeros3, zeros3]), torch.stack([T1, T2]))
    ns = torch.where(is_pure_rotation, torch.stack([zeros3, zeros3]), torch.stack([n1, n2]))
    return Rs, Ts, ns, is_pure_rotation

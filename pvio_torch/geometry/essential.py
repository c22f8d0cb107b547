"""Essential-matrix estimation: epipolar errors, the 8-point solve and the
5-point solver with static shapes.

Matches `pvio_tpu/geometry/essential.py`: `essential_geometric_error`,
`essential_symmetric_error`, `decompose_essential`, `_epipolar_rows`,
`solve_essential_8pt` and the 5-point tan-substitution solver
`solve_essential_5pt` with `_nullspace_basis`, `_pmul`,
`_constraints_matrix`, `_gauss_jordan`, `_poly_z_forms`, `_upoly_mul`,
`_det_poly` and `_real_roots_deg10` (`essential.py:36-329`).

Where the reference vmaps the 5-point solver over RANSAC samples, every
function here takes leading batch dimensions, and its `lax.fori_loop`s
(Gauss-Jordan, root bisection) are Python loops over batched tensors that
never read a value back to the host. The trivariate product `_pmul` is a
gather over a fixed table of monomial pairs (no atomics, so it is
deterministic on the card). `torch.linalg.eigh` / `svd` stand where the
reference calls `jnp.linalg.eigh` / `svd`: the nullspace basis of the
5 x 9 epipolar system is any orthonormal basis of a 4-d eigenspace, so the
candidate E's come in another order and sign than the reference's, but as
the same set.
"""

import itertools
import math

import torch

_GRID = 1024  # theta samples for the root scan
_BISECT_ITERS = 64
_MAX_ROOTS = 10


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


def decompose_essential(E):
    """E (..., 3, 3) -> (R1, R2, T) via SVD with determinant sign fixes.
    The four pose hypotheses are (R1, T), (R1, -T), (R2, T), (R2, -T)."""
    U, _, Vt = torch.linalg.svd(E)
    U = torch.where(torch.linalg.det(U)[..., None, None] < 0, -U, U)
    Vt = torch.where(torch.linalg.det(Vt)[..., None, None] < 0, -Vt, Vt)
    W = torch.zeros(3, 3, dtype=E.dtype, device=E.device)
    W[0, 1], W[1, 0], W[2, 2] = 1.0, -1.0, 1.0
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    return R1, R2, U[..., :, 2]


def solve_essential_8pt(x1, x2):
    """Linear N >= 8 point solve + projection to the essential manifold;
    x1, x2 (..., N, 2)."""
    A = _epipolar_rows(x1, x2)
    _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    E = vecs[..., :, 0].reshape(*A.shape[:-2], 3, 3)
    U, s, Vt = torch.linalg.svd(E)
    sm = (s[..., 0] + s[..., 1]) * 0.5
    d = torch.stack([sm, sm, torch.zeros_like(sm)], dim=-1)
    return U @ torch.diag_embed(d) @ Vt


# ----------------------------------------------------------------------------
# 5-point solver machinery


def _pmul_table():
    """For each output monomial (i, j, k) of degree < 4 per variable, the
    flat indices (m, n) of the factor monomials with m + n = (i, j, k),
    padded with the index 64 (a zero slot) to 64 pairs."""
    m_idx, n_idx = [], []
    for out in itertools.product(range(4), repeat=3):
        pairs = [(a, tuple(o - ai for o, ai in zip(out, a)))
                 for a in itertools.product(*(range(o + 1) for o in out))]
        flat = [(a[0] * 16 + a[1] * 4 + a[2], b[0] * 16 + b[1] * 4 + b[2]) for a, b in pairs]
        flat += [(64, 64)] * (64 - len(flat))
        m_idx += [f[0] for f in flat]
        n_idx += [f[1] for f in flat]
    return m_idx, n_idx


_PMUL_M, _PMUL_N = _pmul_table()
_PMUL_CACHE = {}


def _pmul_index(device):
    key = str(device)
    if key not in _PMUL_CACHE:
        _PMUL_CACHE[key] = (torch.tensor(_PMUL_M, dtype=torch.int64, device=device),
                            torch.tensor(_PMUL_N, dtype=torch.int64, device=device))
    return _PMUL_CACHE[key]


def _pmul(a, b):
    """Multiply trivariate coefficient tensors (..., 4, 4, 4), truncated to
    degree 3 per variable (the reference's 3-D convolution cut to
    [:4, :4, :4]); broadcasts over leading dims."""
    a, b = torch.broadcast_tensors(a, b)
    lead = a.shape[:-3]
    mi, ni = _pmul_index(a.device)
    pad = a.new_zeros(*lead, 1)
    af = torch.cat([a.reshape(*lead, 64), pad], dim=-1)
    bf = torch.cat([b.reshape(*lead, 64), pad], dim=-1)
    prod = af[..., mi] * bf[..., ni]                     # (..., 64 * 64)
    return torch.sum(prod.reshape(*lead, 64, 64), dim=-1).reshape(*lead, 4, 4, 4)


def _nullspace_basis(x1, x2):
    """(..., 5, 2) pairs -> four 3x3 basis matrices X, Y, Z, W (..., 4, 3, 3)
    spanning the right nullspace of the epipolar system, and the (..., 9, 4)
    basis."""
    A = _epipolar_rows(x1, x2)                           # (..., 5, 9)
    _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    basis = vecs[..., :, :4]
    return basis.transpose(-1, -2).reshape(*basis.shape[:-2], 4, 3, 3), basis


# Nister monomial ordering for the 10x20 system. First 10 are eliminated.
_MONOMIALS = (
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
    (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
    (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
    (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
)
_MONO_FLAT = [i * 16 + j * 4 + k for i, j, k in _MONOMIALS]


def _constraints_matrix(XYZW):
    """(..., 4, 3, 3) basis -> (..., 10, 20) coefficient matrix of the
    Groebner constraints: constraint 0 = det(E), 1..9 = 2 E E^T E -
    tr(E E^T) E (row-major), E(x, y, z) = x X + y Y + z Z + W."""
    lead = XYZW.shape[:-3]
    E = XYZW.new_zeros(*lead, 3, 3, 4, 4, 4)
    E[..., 1, 0, 0] = XYZW[..., 0, :, :]
    E[..., 0, 1, 0] = XYZW[..., 1, :, :]
    E[..., 0, 0, 1] = XYZW[..., 2, :, :]
    E[..., 0, 0, 0] = XYZW[..., 3, :, :]

    def el(M, i, j):
        return M[..., i, j, :, :, :]

    mul = _pmul
    a = mul(mul(el(E, 1, 1), el(E, 2, 2)) - mul(el(E, 1, 2), el(E, 2, 1)), el(E, 0, 0))
    b = mul(mul(el(E, 1, 0), el(E, 2, 2)) - mul(el(E, 1, 2), el(E, 2, 0)), el(E, 0, 1))
    c = mul(mul(el(E, 1, 0), el(E, 2, 1)) - mul(el(E, 1, 1), el(E, 2, 0)), el(E, 0, 2))
    detE = a - b + c

    # M = E E^T (degree 2), C = 2 M E - tr(M) E (degree 3); the k-sums run
    # in the reference's order
    n = len(lead)
    Ei = E.unsqueeze(n + 1)                    # (..., 3, 1, 3, P): E[i, k]
    Ej = E.unsqueeze(n)                        # (..., 1, 3, 3, P): E[j, k]
    prods = mul(Ei, Ej)                        # (..., 3, 3, 3, P)
    M = prods[..., 0, :, :, :] + prods[..., 1, :, :, :]
    M = M + prods[..., 2, :, :, :]
    trM = el(M, 0, 0) + el(M, 1, 1) + el(M, 2, 2)
    # products M[i, k] E[k, j] laid out (..., i, j, k, P)
    pk = mul(M.unsqueeze(n + 1), E.transpose(n, n + 1).unsqueeze(n))
    acc = pk[..., 0, :, :, :] + pk[..., 1, :, :, :]
    acc = acc + pk[..., 2, :, :, :]
    C = 2.0 * acc - mul(trM[..., None, None, :, :, :], E)
    polys = torch.cat([detE.unsqueeze(n), C.reshape(*lead, 9, 4, 4, 4)], dim=n)
    flat = polys.reshape(*lead, 10, 64)
    idx = torch.tensor(_MONO_FLAT, dtype=torch.int64, device=XYZW.device)
    return flat[..., idx]


def _gauss_jordan(A):
    """Reduce (..., 10, 20) A so the left 10x10 block becomes identity, with
    partial pivoting (first maximum on ties); a pivot below 1e-18 in
    magnitude is replaced by 1e-18."""
    n = A.shape[-2]
    rows = torch.arange(n, device=A.device)
    for k in range(n):
        col = torch.abs(A[..., :, k])
        col = torch.where(rows >= k, col, torch.full_like(col, -1.0))
        p = torch.argmax(col, dim=-1)                     # (...,)
        rk = A[..., k, :]
        rp = torch.gather(A, -2, p[..., None, None].expand(*p.shape, 1, A.shape[-1]))[..., 0, :]
        is_k = (rows == k)[:, None]
        is_p = rows[:, None] == p[..., None, None]
        A = torch.where(is_p, rk[..., None, :], A)
        A = torch.where(is_k, rp[..., None, :], A)
        piv = A[..., k, k]
        piv = torch.where(torch.abs(piv) < 1e-18, torch.full_like(piv, 1e-18), piv)
        row_k = A[..., k, :] / piv[..., None]
        A = torch.where(is_k, row_k[..., None, :], A)
        factors = torch.where(rows == k, torch.zeros_like(A[..., :, k]), A[..., :, k])
        A = A - factors[..., :, None] * row_k[..., None, :]
    return A


def _poly_z_forms(B):
    """From the reduced right block B (..., 10, 10) the 3x3 matrix K(z) of
    polynomials in z (..., 3, 3, 5): rows from the monomial pairs
    (x^2 z, x^2), (y^2 z, y^2), (xyz, xy); K[k] = [p_k (deg 3), q_k
    (deg 3), r_k (deg 4)], coefficients ascending, padded to length 5."""
    def lin_form(row):
        px = torch.stack([row[..., 2], row[..., 1], row[..., 0]], dim=-1)
        py = torch.stack([row[..., 5], row[..., 4], row[..., 3]], dim=-1)
        pc = torch.stack([row[..., 9], row[..., 8], row[..., 7], row[..., 6]], dim=-1)
        return px, py, pc

    def pad(p, n):
        return torch.cat([p, p.new_zeros(*p.shape[:-1], n - p.shape[-1])], dim=-1)

    def shift(p):  # multiply by z
        return torch.cat([p.new_zeros(*p.shape[:-1], 1), p], dim=-1)

    Ks = []
    for rz, r1 in ((4, 5), (6, 7), (8, 9)):
        pxz, pyz, pcz = lin_form(B[..., rz, :])
        px1, py1, pc1 = lin_form(B[..., r1, :])
        Ks.append(torch.stack([pad(shift(px1), 5) - pad(pxz, 5),
                               pad(shift(py1), 5) - pad(pyz, 5),
                               pad(shift(pc1), 5) - pad(pcz, 5)], dim=-2))
    return torch.stack(Ks, dim=-3)


def _upoly_mul(a, b):
    """Product of ascending coefficient vectors (..., la) and (..., lb)
    (`jnp.convolve`)."""
    la, lb = a.shape[-1], b.shape[-1]
    out = a.new_zeros(*torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]), la + lb - 1)
    for i in range(la):
        out = out + torch.nn.functional.pad(a[..., i:i + 1] * b, (i, la - 1 - i))
    return out


def _det_poly(K):
    """det of the 3x3 matrix of univariate polynomials (..., 3, 3, 5) ->
    degree-10 coefficients (..., 11), ascending."""
    def k(i, j):
        return K[..., i, j, :]

    m = _upoly_mul
    c00 = m(k(1, 1), k(2, 2)) - m(k(1, 2), k(2, 1))
    c01 = m(k(1, 0), k(2, 2)) - m(k(1, 2), k(2, 0))
    c02 = m(k(1, 0), k(2, 1)) - m(k(1, 1), k(2, 0))
    det = m(k(0, 0), c00) - m(k(0, 1), c01) + m(k(0, 2), c02)
    return det[..., :11]


def _real_roots_deg10(c):
    """Real roots of degree-10 polynomials (..., 11) with static shapes:
    z = tan(theta), scan g(theta) = sum_k c_k sin^k cos^(10-k) on a grid
    for sign changes, take the first ten, bisect 64 times. Returns (roots
    (..., 10), mask (..., 10))."""
    dt, dev = c.dtype, c.device
    thetas = torch.linspace(-math.pi / 2 + 1e-4, math.pi / 2 - 1e-4, _GRID, dtype=dt, device=dev)
    k = torch.arange(11, device=dev).to(dt)

    def g(theta):
        s, co = torch.sin(theta), torch.cos(theta)
        return torch.sum(c.unsqueeze(-2) * s[..., None] ** k * co[..., None] ** (10 - k), dim=-1)

    lead = c.shape[:-1]
    vals = g(thetas.expand(*lead, _GRID))
    sign_change = torch.sign(vals[..., :-1]) * torch.sign(vals[..., 1:]) < 0
    idx = torch.arange(_GRID - 1, device=dev)
    order = torch.sort(torch.where(sign_change, idx, torch.full_like(idx, _GRID)),
                       dim=-1, stable=True).indices
    take = order[..., :_MAX_ROOTS]
    mask = torch.gather(sign_change, -1, take)
    lo = thetas[take]
    hi = thetas[take + 1]
    glo = g(lo)
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        gm = g(mid)
        left = torch.sign(glo) * torch.sign(gm) < 0
        lo, hi, glo = (torch.where(left, lo, mid), torch.where(left, mid, hi),
                       torch.where(left, glo, gm))
    return torch.tan(0.5 * (lo + hi)), mask


def solve_essential_5pt(x1, x2):
    """Nister 5-point solver on normalized correspondences x1, x2 (..., 5, 2)
    (x2^T E x1 = 0). Returns (Es (..., 10, 3, 3), mask (..., 10))."""
    XYZW, _ = _nullspace_basis(x1, x2)
    return _solve_from_basis(XYZW)


def _solve_from_basis(XYZW):
    """The 5-point solver after the nullspace step: candidate E's and their
    mask from the basis X, Y, Z, W (..., 4, 3, 3)."""
    A = _gauss_jordan(_constraints_matrix(XYZW))
    K = _poly_z_forms(A[..., :, 10:])
    n = _det_poly(K)
    n = n / torch.clamp(torch.max(torch.abs(n), dim=-1, keepdim=True).values, min=1e-18)
    roots, mask = _real_roots_deg10(n)
    # (x, y) of every root: least squares on [p q] (x, y) = -r at z
    powers = roots[..., None] ** torch.arange(5, device=roots.device).to(roots.dtype)
    Kz = torch.einsum("...ijc,...rc->...rij", K, powers)          # (..., 10, 3, 3)
    Apq = Kz[..., :2]
    b = -Kz[..., 2]
    AtA = Apq.transpose(-1, -2) @ Apq + 1e-12 * torch.eye(2, dtype=Kz.dtype, device=Kz.device)
    rhs = (Apq.transpose(-1, -2) @ b[..., None])[..., 0]
    det = AtA[..., 0, 0] * AtA[..., 1, 1] - AtA[..., 0, 1] * AtA[..., 1, 0]
    det = torch.where(torch.abs(det) < 1e-24, torch.full_like(det, 1e-24), det)
    xy = torch.stack([(AtA[..., 1, 1] * rhs[..., 0] - AtA[..., 0, 1] * rhs[..., 1]) / det,
                      (AtA[..., 0, 0] * rhs[..., 1] - AtA[..., 1, 0] * rhs[..., 0]) / det], dim=-1)
    coeffs = torch.cat([xy, roots[..., None], torch.ones_like(roots[..., None])], dim=-1)
    Es = torch.einsum("...rk,...kij->...rij", coeffs, XYZW)
    nrm = torch.linalg.norm(Es.reshape(*Es.shape[:-2], 9), dim=-1)
    return Es / torch.clamp(nrm, min=1e-18)[..., None, None], mask

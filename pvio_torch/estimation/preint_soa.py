"""Component-wise (struct-of-arrays) preintegration factor bank.

Matches `pvio_tpu/estimation/preint_soa.py`: `preint_factor_bank_soa` and its
helpers. Every quaternion, vector and 3x3 matrix is a tuple of (K,) tensors
(K = F - 1 consecutive-frame factors), so the whole chain is elementwise
work; only the final stacks and the whitening contraction see whole
blocks. Its values are those of `factors.preintegration_residual_and_jacobians`
applied to each consecutive pair. `ba.linearize` takes this bank off the
CPU (`BAConfig.fused_preint`), as the reference does.
"""

import torch

from pvio_torch.imu.preintegration import GRAVITY_NOMINAL, PreintDelta
from pvio_torch.map.window import Extrinsics

_EPS2 = 1e-12

# quaternions: (w, x, y, z) tuples; vectors: (x, y, z); matrices: row-major
# 9-tuples (m00..m22). Entries are (K,) tensors or broadcasting scalars.


def _qmul(p, q):
    pw, px, py, pz = p
    qw, qx, qy, qz = q
    return (pw * qw - px * qx - py * qy - pz * qz,
            pw * qx + px * qw + py * qz - pz * qy,
            pw * qy - px * qz + py * qw + pz * qx,
            pw * qz + px * qy - py * qx + pz * qw)


def _qconj(q):
    w, x, y, z = q
    return (w, -x, -y, -z)


def _qrot(q, v):
    w, x, y, z = q
    vx, vy, vz = v
    ux, uy, uz = (y * vz - z * vy, z * vx - x * vz, x * vy - y * vx)
    wx, wy, wz = (y * uz - z * uy, z * ux - x * uz, x * uy - y * ux)
    return (vx + 2.0 * (w * ux + wx), vy + 2.0 * (w * uy + wy), vz + 2.0 * (w * uz + wz))


def _qmat(q):
    w, x, y, z = q
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return (1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy))


def _mmul(A, B):
    a00, a01, a02, a10, a11, a12, a20, a21, a22 = A
    b00, b01, b02, b10, b11, b12, b20, b21, b22 = B
    return (a00 * b00 + a01 * b10 + a02 * b20,
            a00 * b01 + a01 * b11 + a02 * b21,
            a00 * b02 + a01 * b12 + a02 * b22,
            a10 * b00 + a11 * b10 + a12 * b20,
            a10 * b01 + a11 * b11 + a12 * b21,
            a10 * b02 + a11 * b12 + a12 * b22,
            a20 * b00 + a21 * b10 + a22 * b20,
            a20 * b01 + a21 * b11 + a22 * b21,
            a20 * b02 + a21 * b12 + a22 * b22)


def _mt(A):
    a00, a01, a02, a10, a11, a12, a20, a21, a22 = A
    return (a00, a10, a20, a01, a11, a21, a02, a12, a22)


def _mneg(A):
    return tuple(-a for a in A)


def _mscale(s, A):
    return tuple(s * a for a in A)


def _mv(A, v):
    a00, a01, a02, a10, a11, a12, a20, a21, a22 = A
    x, y, z = v
    return (a00 * x + a01 * y + a02 * z,
            a10 * x + a11 * y + a12 * z,
            a20 * x + a21 * y + a22 * z)


def _hat(v):
    x, y, z = v
    zero = x * 0.0
    return (zero, -z, y, z, zero, -x, -y, x, zero)


def _expmap(v):
    x, y, z = v
    t2 = x * x + y * y + z * z
    small = t2 < _EPS2
    t = torch.sqrt(torch.where(small, 1.0, t2))
    s = torch.where(small, 0.5 - t2 / 48.0, torch.sin(0.5 * t) / t)
    c = torch.where(small, 1.0 - t2 / 8.0, torch.cos(0.5 * t))
    return (c, s * x, s * y, s * z)


def _logmap(q):
    w, x, y, z = q
    sgn = torch.sign(torch.where(w == 0, 1.0, w))
    w, x, y, z = w * sgn, x * sgn, y * sgn, z * sgn
    n2 = x * x + y * y + z * z
    small = n2 < _EPS2
    n = torch.sqrt(torch.where(small, 1.0, n2))
    angle = 2.0 * torch.atan2(n, w)
    scale = torch.where(small, 2.0 / torch.clamp(w, min=0.5), angle / n)
    return (scale * x, scale * y, scale * z)


def _right_jacobian_terms(v):
    x, y, z = v
    t2 = x * x + y * y + z * z
    small = t2 < _EPS2
    t2s = torch.where(small, 1.0, t2)
    t = torch.sqrt(t2s)
    a = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / t2s)
    b = torch.where(small, 1.0 / 6.0 - t2 / 120.0, (t - torch.sin(t)) / (t2s * t))
    return a, b


def _eye9(one):
    zero = one * 0
    return (one, zero, zero, zero, one, zero, zero, zero, one)


def _right_jacobian(v):
    a, b = _right_jacobian_terms(v)
    W = _hat(v)
    WW = _mmul(W, W)
    I = _eye9(v[0] * 0.0 + 1.0)
    return tuple(I[k] - a * W[k] + b * WW[k] for k in range(9))


def _right_jacobian_inv(v):
    x, y, z = v
    t2 = x * x + y * y + z * z
    small = t2 < _EPS2
    t2s = torch.where(small, 1.0, t2)
    t = torch.sqrt(t2s)
    sin_t = torch.sin(t)
    sin_ts = torch.where(torch.abs(sin_t) < 1e-12, 1.0, sin_t)
    c = torch.where(small, 1.0 / 12.0 + t2 / 720.0,
                    1.0 / t2s - (1.0 + torch.cos(t)) / (2.0 * t * sin_ts))
    W = _hat(v)
    WW = _mmul(W, W)
    I = _eye9(x * 0.0 + 1.0)
    return tuple(I[k] + 0.5 * W[k] + c * WW[k] for k in range(9))


def _cols3(M):
    """(K, 3, 3) tensor -> row-major component tuple."""
    return tuple(M[..., r, c] for r in range(3) for c in range(3))


def preint_factor_bank_soa(q, p, v, bg, ba, delta: PreintDelta, bg_lin, ba_lin,
                           extr: Extrinsics):
    """Residuals and Jacobians of all consecutive-frame preintegration
    factors: q (F, 4), p/v/bg/ba (F, 3), delta batched over F (slot j spans
    j-1 -> j). Returns whitened (r (F-1, 15), Ji, Jj (F-1, 15, 15))."""
    F = q.shape[0]

    def comps(arr, s):
        return tuple(arr[s, k] for k in range(arr.shape[1]))

    lo, hi = slice(0, F - 1), slice(1, F)
    qi_c, qj_c = comps(q, lo), comps(q, hi)
    pi_c, pj_c = comps(p, lo), comps(p, hi)
    vi_c, vj_c = comps(v, lo), comps(v, hi)
    bgi_c, bgj_c = comps(bg, lo), comps(bg, hi)
    bai_c, baj_c = comps(ba, lo), comps(ba, hi)
    bgl_c, bal_c = comps(bg_lin, hi), comps(ba_lin, hi)

    dt = delta.t[1:]
    dq_c = comps(delta.q, hi)
    dp_c = comps(delta.p, hi)
    dv_c = comps(delta.v, hi)
    dqdbg = _cols3(delta.dq_dbg[1:])
    dpdbg = _cols3(delta.dp_dbg[1:])
    dpdba = _cols3(delta.dp_dba[1:])
    dvdbg = _cols3(delta.dv_dbg[1:])
    dvdba = _cols3(delta.dv_dba[1:])

    ex_qbi = tuple(extr.q_bi[k] for k in range(4))
    ex_pbi = tuple(extr.p_bi[k] for k in range(3))

    zero = dt * 0.0
    g = (zero, zero, zero - GRAVITY_NOMINAL)

    # sensor-frame states
    qi = _qmul(qi_c, ex_qbi)
    qj = _qmul(qj_c, ex_qbi)
    rot_pbi_i = _qrot(qi_c, ex_pbi)
    rot_pbi_j = _qrot(qj_c, ex_pbi)
    pi = tuple(pi_c[k] + rot_pbi_i[k] for k in range(3))
    pj = tuple(pj_c[k] + rot_pbi_j[k] for k in range(3))

    dbg = tuple(bgi_c[k] - bgl_c[k] for k in range(3))
    dba = tuple(bai_c[k] - bal_c[k] for k in range(3))

    dqdbg_dbg = _mv(dqdbg, dbg)
    corr = _expmap(dqdbg_dbg)
    dq_corr = _qmul(dq_c, corr)
    qi_conj = _qconj(qi)
    rq = _logmap(_qmul(_qconj(dq_corr), _qmul(qi_conj, qj)))

    dp_arg = tuple(pj[k] - pi[k] - dt * vi_c[k] - 0.5 * dt * dt * g[k] for k in range(3))
    dv_arg = tuple(vj_c[k] - vi_c[k] - dt * g[k] for k in range(3))
    rp_rot = _qrot(qi_conj, dp_arg)
    rv_rot = _qrot(qi_conj, dv_arg)
    dpdbg_dbg = _mv(dpdbg, dbg)
    dpdba_dba = _mv(dpdba, dba)
    dvdbg_dbg = _mv(dvdbg, dbg)
    dvdba_dba = _mv(dvdba, dba)
    rp = tuple(rp_rot[k] - (dp_c[k] + dpdbg_dbg[k] + dpdba_dba[k]) for k in range(3))
    rv = tuple(rv_rot[k] - (dv_c[k] + dvdbg_dbg[k] + dvdba_dba[k]) for k in range(3))
    rbg = tuple(bgj_c[k] - bgi_c[k] for k in range(3))
    rba = tuple(baj_c[k] - bai_c[k] for k in range(3))
    r_comp = rq + rp + rv + rbg + rba                   # 15 (K,) tensors

    # Jacobian blocks
    Jr_inv = _right_jacobian_inv(rq)
    R_qi_T = _qmat(qi_conj)
    R_qci = _qmat(qi_c)
    R_qj_T = _qmat(_qconj(qj))
    R_bi_T = _qmat(_qconj(ex_qbi))
    R_qcj = _qmat(qj_c)
    I3 = _eye9(zero + 1.0)
    Z3 = (zero,) * 9

    b_q_ti = _mneg(_mmul(_mmul(Jr_inv, R_qj_T), R_qci))
    b_q_bgi = _mneg(_mmul(_mmul(_mmul(Jr_inv, _mt(_qmat(_expmap(rq)))),
                                _right_jacobian(dqdbg_dbg)), dqdbg))
    hp = _qrot(_qconj(qi_c), tuple(pj[k] - pi_c[k] - dt * vi_c[k] - 0.5 * dt * dt * g[k]
                                   for k in range(3)))
    b_p_ti = _mmul(R_bi_T, _hat(hp))
    hv = _qrot(_qconj(qi_c), dv_arg)
    b_v_ti = _mmul(R_bi_T, _hat(hv))
    nR_qi_T = _mneg(R_qi_T)
    b_p_vi = _mscale(-dt, R_qi_T)
    b_q_tj = _mmul(Jr_inv, R_bi_T)
    b_p_tj = _mneg(_mmul(_mmul(R_qi_T, R_qcj), _hat(ex_pbi)))
    nI3 = _mneg(I3)

    def rows(blockrow):
        """5 matrices (9-tuples) of one block row -> 3 rows of 15 components."""
        return [[c for B in blockrow for c in B[3 * r: 3 * r + 3]] for r in range(3)]

    Ji_rows = (rows([b_q_ti, Z3, Z3, b_q_bgi, Z3])
               + rows([b_p_ti, nR_qi_T, b_p_vi, _mneg(dpdbg), _mneg(dpdba)])
               + rows([b_v_ti, Z3, nR_qi_T, _mneg(dvdbg), _mneg(dvdba)])
               + rows([Z3, Z3, Z3, nI3, Z3])
               + rows([Z3, Z3, Z3, Z3, nI3]))
    Jj_rows = (rows([b_q_tj, Z3, Z3, Z3, Z3])
               + rows([b_p_tj, R_qi_T, Z3, Z3, Z3])
               + rows([Z3, Z3, R_qi_T, Z3, Z3])
               + rows([Z3, Z3, Z3, I3, Z3])
               + rows([Z3, Z3, Z3, Z3, I3]))

    K = F - 1

    def stack(cs):
        return torch.stack([c.expand(K) for c in cs], dim=-1)

    r_arr = stack(r_comp)                                        # (K, 15)
    Ji_arr = stack([c for row in Ji_rows for c in row]).reshape(K, 15, 15)
    Jj_arr = stack([c for row in Jj_rows for c in row]).reshape(K, 15, 15)
    S = delta.sqrt_inv_cov[1:]
    r_w = torch.sum(S * r_arr[:, None, :], dim=-1)
    Ji_w = torch.sum(S[:, :, :, None] * Ji_arr[:, None, :, :], dim=-2)
    Jj_w = torch.sum(S[:, :, :, None] * Jj_arr[:, None, :, :], dim=-2)
    return r_w, Ji_w, Jj_w

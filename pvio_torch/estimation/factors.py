"""Factor residuals for motion-only visual-inertial PnP.

Matches the part of `pvio_tpu/estimation/factors.py` that PnP needs
(`factors.py:50-180`, `:458`): `pose_only_reprojection_residual`,
`_whiten2`, `preintegration_residual`,
`preintegration_residual_and_jacobians` (analytic 15x15 blocks) and
`plane_cast_point`. The BA-only factors (inverse-depth reprojection,
marginalization, `_sym3_inv`, the augmented plane residual and its
implicit solve) wait for the keyframe slice.
"""

import torch

from pvio_torch.geometry import camera, lie
from pvio_torch.imu.preintegration import GRAVITY_NOMINAL, PreintDelta
from pvio_torch.map.window import Extrinsics


def _gravity(ref):
    return torch.tensor([0.0, 0.0, -GRAVITY_NOMINAL], dtype=ref.dtype, device=ref.device)


def _whiten2(r, sqrt_inv_cov):
    S = torch.as_tensor(sqrt_inv_cov, dtype=r.dtype, device=r.device)
    if S.dim() == 0:
        return S * r
    return lie.mv(S, r)


def pose_only_reprojection_residual(q_tgt, p_tgt, x_world, z_tgt, extr: Extrinsics,
                                    sqrt_inv_cov):
    """Fixed-landmark reprojection residual (2,), broadcast over leading
    dims of x_world/z_tgt."""
    y_tgt_center = lie.quat_rotate(lie.quat_conj(q_tgt), x_world - p_tgt)
    y_tgt = lie.quat_rotate(lie.quat_conj(extr.q_bc), y_tgt_center - extr.p_bc)
    r = camera.project(y_tgt) - z_tgt
    return _whiten2(r, sqrt_inv_cov)


def preintegration_residual(q_i, p_i, v_i, bg_i, ba_i, q_j, p_j, v_j, bg_j, ba_j,
                            delta: PreintDelta, bg_lin, ba_lin, extr: Extrinsics):
    """15-dim preintegration residual with first-order bias correction,
    whitened by delta.sqrt_inv_cov."""
    g = _gravity(q_i)
    qi = lie.quat_mul(q_i, extr.q_bi)
    pi = p_i + lie.quat_rotate(q_i, extr.p_bi)
    qj = lie.quat_mul(q_j, extr.q_bi)
    pj = p_j + lie.quat_rotate(q_j, extr.p_bi)
    dt = delta.t
    dbg = bg_i - bg_lin
    dba = ba_i - ba_lin
    dq_corr = lie.quat_mul(delta.q, lie.expmap(lie.mv(delta.dq_dbg, dbg)))
    qi_conj = lie.quat_conj(qi)
    rq = lie.logmap(lie.quat_mul(lie.quat_conj(dq_corr), lie.quat_mul(qi_conj, qj)))
    rp = lie.quat_rotate(qi_conj, pj - pi - dt * v_i - 0.5 * dt * dt * g) - (
        delta.p + lie.mv(delta.dp_dbg, dbg) + lie.mv(delta.dp_dba, dba))
    rv = lie.quat_rotate(qi_conj, v_j - v_i - dt * g) - (
        delta.v + lie.mv(delta.dv_dbg, dbg) + lie.mv(delta.dv_dba, dba))
    r = torch.cat([rq, rp, rv, bg_j - bg_i, ba_j - ba_i])
    return lie.mv(delta.sqrt_inv_cov, r)


def preintegration_residual_and_jacobians(q_i, p_i, v_i, bg_i, ba_i,
                                          q_j, p_j, v_j, bg_j, ba_j,
                                          delta: PreintDelta, bg_lin, ba_lin,
                                          extr: Extrinsics):
    """Whitened residual + analytic Jacobians w.r.t. both frames' error
    states (theta, p, v, bg, ba). Returns (r (15,), Ji, Jj (15, 15))."""
    dt = delta.t
    g = _gravity(q_i)
    qi = lie.quat_mul(q_i, extr.q_bi)
    pi = p_i + lie.quat_rotate(q_i, extr.p_bi)
    qj = lie.quat_mul(q_j, extr.q_bi)
    pj = p_j + lie.quat_rotate(q_j, extr.p_bi)
    dbg = bg_i - bg_lin
    dba = ba_i - ba_lin
    corr = lie.expmap(lie.mv(delta.dq_dbg, dbg))
    dq_corr = lie.quat_mul(delta.q, corr)
    qi_conj = lie.quat_conj(qi)
    rq = lie.logmap(lie.quat_mul(lie.quat_conj(dq_corr), lie.quat_mul(qi_conj, qj)))
    dp_arg = pj - pi - dt * v_i - 0.5 * dt * dt * g
    dv_arg = v_j - v_i - dt * g
    rp = lie.quat_rotate(qi_conj, dp_arg) - (
        delta.p + lie.mv(delta.dp_dbg, dbg) + lie.mv(delta.dp_dba, dba))
    rv = lie.quat_rotate(qi_conj, dv_arg) - (
        delta.v + lie.mv(delta.dv_dbg, dbg) + lie.mv(delta.dv_dba, dba))
    r = torch.cat([rq, rp, rv, bg_j - bg_i, ba_j - ba_i])

    Jr_inv = lie.right_jacobian_inv(rq)
    R_qi_T = lie.quat_to_mat(qi_conj)
    R_qci = lie.quat_to_mat(q_i)
    R_qj_T = lie.quat_to_mat(lie.quat_conj(qj))
    R_bi_T = lie.quat_to_mat(lie.quat_conj(extr.q_bi))
    R_qcj = lie.quat_to_mat(q_j)
    I3 = torch.eye(3, dtype=q_i.dtype, device=q_i.device)
    Z3 = torch.zeros_like(I3)

    def blocks_to_mat(B):
        return torch.cat([torch.cat(row, dim=-1) for row in B], dim=-2)

    mm = lie.mm
    Ji = blocks_to_mat([
        [-mm(mm(Jr_inv, R_qj_T), R_qci), Z3, Z3,
         -mm(mm(mm(Jr_inv, lie.quat_to_mat(lie.expmap(rq)).T),
                lie.right_jacobian(lie.mv(delta.dq_dbg, dbg))), delta.dq_dbg), Z3],
        [mm(R_bi_T, lie.hat(lie.quat_rotate(lie.quat_conj(q_i),
                                            pj - p_i - dt * v_i - 0.5 * dt * dt * g))),
         -R_qi_T, -dt * R_qi_T, -delta.dp_dbg, -delta.dp_dba],
        [mm(R_bi_T, lie.hat(lie.quat_rotate(lie.quat_conj(q_i), dv_arg))),
         Z3, -R_qi_T, -delta.dv_dbg, -delta.dv_dba],
        [Z3, Z3, Z3, -I3, Z3],
        [Z3, Z3, Z3, Z3, -I3],
    ])
    Jj = blocks_to_mat([
        [mm(Jr_inv, R_bi_T), Z3, Z3, Z3, Z3],
        [-mm(mm(R_qi_T, R_qcj), lie.hat(extr.p_bi)), R_qi_T, Z3, Z3, Z3],
        [Z3, Z3, R_qi_T, Z3, Z3],
        [Z3, Z3, Z3, I3, Z3],
        [Z3, Z3, Z3, Z3, I3],
    ])
    S = delta.sqrt_inv_cov
    return lie.mv(S, r), mm(S, Ji), mm(S, Jj)


def plane_cast_point(normal, distance, origin, bearing):
    """Ray-cast from origin along bearing onto the plane n.x = d (garbage
    when near-parallel; callers gate on |n . bearing|)."""
    denom = torch.sum(normal * bearing, dim=-1)
    denom = torch.where(torch.abs(denom) < 1e-12, torch.full_like(denom, 1e-12), denom)
    s = (distance - torch.sum(normal * origin, dim=-1)) / denom
    return origin + s[..., None] * bearing

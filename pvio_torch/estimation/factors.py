"""Factor residuals for visual-inertial PnP and bundle adjustment.

Matches `pvio_tpu/estimation/factors.py`: `reprojection_residual`,
`pose_only_reprojection_residual`, `_whiten2`, `preintegration_residual`,
`preintegration_residual_and_jacobians` (analytic 15x15 blocks),
`marginalization_residual_and_jacobian`, `marginalization_residual`,
`_sym3_inv`, `_solve_augmented_point` (with its custom JVP),
`plane_point_rows`, `augmented_plane_distance_residual`,
`augmented_plane_residual_and_pose_jacobian` and `plane_cast_point`.

The per-track plane functions take leading batch dimensions where the
reference vmaps over tracks.
"""

import torch
from torch.func import jacfwd

from pvio_torch.geometry import camera, lie
from pvio_torch.imu.preintegration import PreintDelta, gravity
from pvio_torch.map.window import Extrinsics


def _gravity(ref):
    return gravity(ref.dtype, ref.device)


def _whiten2(r, sqrt_inv_cov):
    """sqrt_inv_cov: a Python scalar (applied as is, no host-to-device copy),
    a 0-d tensor, or a (2, 2) matrix."""
    if isinstance(sqrt_inv_cov, (int, float)):
        return sqrt_inv_cov * r
    S = torch.as_tensor(sqrt_inv_cov, dtype=r.dtype, device=r.device)
    if S.dim() == 0:
        return S * r
    return lie.mv(S, r)


def reprojection_residual(q_tgt, p_tgt, q_ref, p_ref, inv_depth, z_ref, z_tgt,
                          extr: Extrinsics, sqrt_inv_cov):
    """Inverse-depth reprojection residual (2,): the landmark at depth
    1/inv_depth along [z_ref, 1] in the reference camera, seen by the target
    camera. Broadcasts over leading dims."""
    inv_d = torch.where(torch.abs(inv_depth) < 1e-12, torch.full_like(inv_depth, 1e-12),
                        inv_depth)
    y_ref = torch.cat([z_ref, torch.ones_like(z_ref[..., :1])], dim=-1) / inv_d[..., None]
    y_ref_center = lie.quat_rotate(extr.q_bc, y_ref) + extr.p_bc
    x = lie.quat_rotate(q_ref, y_ref_center) + p_ref
    y_tgt_center = lie.quat_rotate(lie.quat_conj(q_tgt), x - p_tgt)
    y_tgt = lie.quat_rotate(lie.quat_conj(extr.q_bc), y_tgt_center - extr.p_bc)
    r = camera.project(y_tgt) - z_tgt
    return _whiten2(r, sqrt_inv_cov)


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


def _prior_dx(q, p, v, bg, ba, prior):
    rq = lie.logmap(lie.quat_mul(lie.quat_conj(prior.q0), q))
    dx = torch.cat([rq, p - prior.p0, v - prior.v0, bg - prior.bg0, ba - prior.ba0],
                   dim=-1)                                        # (F, 15)
    return rq, dx


def marginalization_residual_and_jacobian(q, p, v, bg, ba, prior):
    """Whitened prior residual (F*15,) and its analytic Jacobian
    (F*15, F*15) w.r.t. the stacked frame error states: the only
    non-identity block is d log(q0^-1 q) / d theta = Jr^-1(rq)."""
    F = q.shape[0]
    rq, dx = _prior_dx(q, p, v, bg, ba, prior)
    r = lie.mv(prior.sqrt_info, dx.reshape(-1)) + prior.infovec
    blocks = torch.eye(15, dtype=p.dtype, device=p.device).repeat(F, 1, 1)
    blocks[:, 0:3, 0:3] = lie.right_jacobian_inv(rq)
    D = torch.block_diag(*blocks)
    return r, prior.sqrt_info @ D


def marginalization_residual(q, p, v, bg, ba, prior):
    """Prior residual over all frame slots (F*15,): r = sqrt_info @ dx +
    infovec, dx_i = [log(q0_i^-1 q_i); p - p0; v - v0; bg - bg0; ba - ba0]."""
    _, dx = _prior_dx(q, p, v, bg, ba, prior)
    return lie.mv(prior.sqrt_info, dx.reshape(-1)) + prior.infovec


# ---------------------------------------------------------------------------
# plane factor: implicit DLT triangulation augmented with a plane row


def _sym3_inv(M, ridge_rel=None):
    """Closed-form inverse of batched symmetric PSD 3x3 matrices by the
    adjugate, with a trace-relative ridge (1e-7 in float32, 1e-13 in
    float64) standing in for an eigenvalue clamp."""
    if ridge_rel is None:
        ridge_rel = 1e-7 if M.dtype == torch.float32 else 1e-13
    tr = M[..., 0, 0] + M[..., 1, 1] + M[..., 2, 2]
    eps = ridge_rel * tr + 1e-18
    Mr = M + eps[..., None, None] * torch.eye(3, dtype=M.dtype, device=M.device)
    a, b, c = Mr[..., 0, 0], Mr[..., 0, 1], Mr[..., 0, 2]
    d, e, f = Mr[..., 1, 1], Mr[..., 1, 2], Mr[..., 2, 2]
    A00 = d * f - e * e
    A01 = c * e - b * f
    A02 = b * e - c * d
    A11 = a * f - c * c
    A12 = b * c - a * e
    A22 = a * d - b * b
    det = a * A00 + b * A01 + c * A02
    adj = torch.stack([torch.stack([A00, A01, A02], -1),
                       torch.stack([A01, A11, A12], -1),
                       torch.stack([A02, A12, A22], -1)], -2)
    return adj / det[..., None, None]


def _augmented_point(A, b):
    AtA = torch.einsum("...ri,...rj->...ij", A, A)
    Atb = torch.einsum("...ri,...r->...i", A, b)
    AtAinv = _sym3_inv(AtA)
    return AtAinv, -torch.einsum("...ij,...j->...i", AtAinv, Atb)


class _SolveAugmentedPoint(torch.autograd.Function):
    """x = -(A^T A)^+ A^T b, A (..., R, 3), b (..., R). Its forward-mode
    derivative comes from the normal equations (A^T A) x = -A^T b by the
    implicit function theorem, as the reference's `custom_jvp` does; so
    `torch.func.jvp`, `jacfwd` and `vmap` see that rule, not the adjugate's
    own derivative."""

    generate_vmap_rule = True

    @staticmethod
    def forward(A, b):
        return _augmented_point(A, b)[1]

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs)

    @staticmethod
    def jvp(ctx, dA, db):
        A, b = ctx.saved_tensors
        dA = torch.zeros_like(A) if dA is None else dA
        db = torch.zeros_like(b) if db is None else db
        AtAinv, x = _augmented_point(A, b)
        # d(AtA) x + d(Atb) = dA^T (A x + b) + A^T (dA x + db)
        Axb = torch.einsum("...ri,...i->...r", A, x) + b
        rhs = torch.einsum("...ri,...r->...i", dA, Axb) + torch.einsum(
            "...ri,...r->...i", A, torch.einsum("...ri,...i->...r", dA, x) + db)
        return -torch.einsum("...ij,...j->...i", AtAinv, rhs)


def _solve_augmented_point(A, b):
    return _SolveAugmentedPoint.apply(A, b)


def _camera_rows(q, p, extr: Extrinsics):
    """World -> camera rotation Rsw (..., 3, 3) and translation Tsw (..., 3)
    of body poses q (..., 4), p (..., 3)."""
    q_ws = lie.quat_mul(q, extr.q_bc)
    Rsw = lie.quat_to_mat(lie.quat_conj(q_ws))
    return Rsw, -lie.mv(Rsw, p + lie.quat_rotate(q, extr.p_bc))


def plane_point_rows(q_frames, p_frames, kps, mask, extr: Extrinsics):
    """DLT rows of tracks across their observing frames: q_frames (F, 4),
    p_frames (F, 3), kps (..., F, 2), mask (..., F). Returns A (..., 2F, 3),
    b (..., 2F); masked-out frames give zero rows."""
    Rsw, Tsw = _camera_rows(q_frames, p_frames, extr)
    u = kps[..., 0:1]
    v = kps[..., 1:2]
    a0 = u * Rsw[:, 2, :] - Rsw[:, 0, :]
    a1 = v * Rsw[:, 2, :] - Rsw[:, 1, :]
    b0 = u[..., 0] * Tsw[:, 2] - Tsw[:, 0]
    b1 = v[..., 0] * Tsw[:, 2] - Tsw[:, 1]
    m = mask.to(kps.dtype)[..., None]
    A = torch.cat([a0 * m, a1 * m], dim=-2)
    b = torch.cat([b0 * m[..., 0], b1 * m[..., 0]], dim=-1)
    return A, b


def augmented_plane_distance_residual(q_frames, p_frames, kps, mask, normal, distance,
                                      extr: Extrinsics, sqrt_inv_cov,
                                      regularization_weight=1.0):
    """The multi-plane prior factor: triangulate each track from all its
    observing poses with an extra plane row (w*n, -w*d), then whiten the
    signed distance n.x - d of that point. kps (..., F, 2), mask (..., F),
    normal (..., 3), distance (...). Returns (...)."""
    A, b = plane_point_rows(q_frames, p_frames, kps, mask, extr)
    w = regularization_weight
    A = torch.cat([A, (w * normal)[..., None, :]], dim=-2)
    b = torch.cat([b, (-w * distance)[..., None]], dim=-1)
    x = _solve_augmented_point(A, b)
    r = torch.sum(normal * x, dim=-1) - distance
    return sqrt_inv_cov * r


def augmented_plane_residual_and_pose_jacobian(q_frames, p_frames, kps_ft, mask_ft,
                                               normals_t, dists_t, extr: Extrinsics,
                                               sqrt_inv_cov, regularization_weight=1.0,
                                               with_plane_jacobian=False):
    """Residuals (T,) and analytic pose Jacobians (T, F, 6) of the augmented
    plane factor for all track columns, by the implicit chain rule through
    the pseudo-inverse: dr = -sic g^T (dA^T s + A^T (dA x + db)) with
    g = (A^T A)^+ n and s = A x + b. The per-frame derivatives of the camera
    rows come from one forward-mode Jacobian of `_camera_rows` over a 6-dim
    tangent shared by all frames: frame f's rows depend only on frame f's
    pose, so each frame gets its own Jacobian (the reference vmaps a
    `jax.linearize` over frames). With with_plane_jacobian, also the
    Jacobian (T, 3) w.r.t. the plane's tangent (2 on the normal's S^2 basis,
    then the distance)."""
    dtype, dev = p_frames.dtype, p_frames.device

    def rows_at(d6):
        q2 = lie.quat_mul(q_frames, lie.expmap(d6[0:3]))
        return _camera_rows(q2, p_frames + d6[3:6], extr)

    def rows_twice(d6):
        out = rows_at(d6)
        return out, out

    (dR, dT), (Rsw, Tsw) = jacfwd(rows_twice, has_aux=True)(
        torch.zeros(6, dtype=dtype, device=dev))
    dR = dR.permute(0, 3, 1, 2)                          # (F, 6, 3, 3)
    dT = dT.permute(0, 2, 1)                             # (F, 6, 3)

    u = kps_ft[..., 0]                                   # (F, T)
    v = kps_ft[..., 1]
    m = mask_ft.to(dtype)
    a0 = (u[..., None] * Rsw[:, None, 2, :] - Rsw[:, None, 0, :]) * m[..., None]
    a1 = (v[..., None] * Rsw[:, None, 2, :] - Rsw[:, None, 1, :]) * m[..., None]
    b0 = (u * Tsw[:, None, 2] - Tsw[:, None, 0]) * m
    b1 = (v * Tsw[:, None, 2] - Tsw[:, None, 1]) * m

    w = regularization_weight
    nn = w * normals_t                                   # (T, 3)
    AtA = (torch.einsum("fti,ftj->tij", a0, a0) + torch.einsum("fti,ftj->tij", a1, a1)
           + nn[:, :, None] * nn[:, None, :])
    Atb = (torch.einsum("fti,ft->ti", a0, b0) + torch.einsum("fti,ft->ti", a1, b1)
           + nn * (-w * dists_t)[:, None])
    AtAinv = _sym3_inv(AtA)
    x = -torch.einsum("tij,tj->ti", AtAinv, Atb)         # (T, 3)
    g = torch.einsum("tij,tj->ti", AtAinv, normals_t)
    r = torch.einsum("ti,ti->t", normals_t, x) - dists_t

    s0 = torch.einsum("fti,ti->ft", a0, x) + b0          # (F, T)
    s1 = torch.einsum("fti,ti->ft", a1, x) + b1
    a0g = torch.einsum("fti,ti->ft", a0, g)
    a1g = torch.einsum("fti,ti->ft", a1, g)

    DRg = torch.einsum("fkij,tj->tfki", dR, g)           # (T, F, 6, 3)
    DRx = torch.einsum("fkij,tj->tfki", dR, x)
    uT = u.T[:, :, None]                                 # (T, F, 1)
    vT = v.T[:, :, None]
    da0g = uT * DRg[..., 2] - DRg[..., 0]                # (T, F, 6)
    da1g = vT * DRg[..., 2] - DRg[..., 1]
    da0x = uT * DRx[..., 2] - DRx[..., 0]
    da1x = vT * DRx[..., 2] - DRx[..., 1]
    db0 = uT * dT[None, :, :, 2] - dT[None, :, :, 0]
    db1 = vT * dT[None, :, :, 2] - dT[None, :, :, 1]
    J = -(s0.T[:, :, None] * da0g + s1.T[:, :, None] * da1g
          + a0g.T[:, :, None] * (da0x + db0) + a1g.T[:, :, None] * (da1x + db1))
    sic = sqrt_inv_cov
    if not with_plane_jacobian:
        return sic * r, sic * J
    # dr/d(dn) = sic [(1 - w^2 g.n) x - w s_pl g], dr/d(dd) = sic [w^2 g.n - 1]
    gn = torch.einsum("ti,ti->t", g, normals_t)
    s_pl = w * r
    dr_dn = (1.0 - w * w * gn)[:, None] * x - (w * s_pl)[:, None] * g
    dr_dd = w * w * gn - 1.0
    Tg = lie.s2_tangential_basis(normals_t)              # (T, 3, 2)
    Jn2 = torch.einsum("ti,tik->tk", dr_dn, Tg)
    Jpl = sic * torch.cat([Jn2, dr_dd[:, None]], dim=-1)
    return sic * r, sic * J, Jpl


def plane_cast_point(normal, distance, origin, bearing):
    """Ray-cast from origin along bearing onto the plane n.x = d (garbage
    when near-parallel; callers gate on |n . bearing|)."""
    denom = torch.sum(normal * bearing, dim=-1)
    denom = torch.where(torch.abs(denom) < 1e-12, torch.full_like(denom, 1e-12), denom)
    s = (distance - torch.sum(normal * origin, dim=-1)) / denom
    return origin + s[..., None] * bearing

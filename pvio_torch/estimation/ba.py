"""Sliding-window bundle adjustment: Levenberg-Marquardt with landmark Schur
elimination, built from dense masked tensor work.

Matches `pvio_tpu/estimation/ba.py`: `BAConfig`, `_factor_masks`,
`_active_dims`, `_cauchy_w`, `_cauchy_rho`, the tangent residuals
(`_repro_residual_t`, `_preint_residual_t`, `_plane_residual_t`,
`_marg_residual_t`), `_gather_track_inputs`, `evaluate_cost`, `linearize`,
`_lm_step`, `solve`, `plane_track_escape`, `_mean_rpe_norm` and
`post_solve_update`. The window has fixed shape (F frame slots x T track
slots); every factor is evaluated on the dense grid under masks. The
reprojection Jacobians come from one forward-mode Jacobian over a 13-dim
tangent shared by every observation (each observation's residual depends
only on its own copy, so this equals the reference's vmap over
observations). The reference's `tp_axis` (tracks sharded over devices)
is `counts` here: `plane_counts` summed over the track shards, passed to
`_factor_masks`, `evaluate_cost` and `linearize`
(`parallel/sharded_ba.py`).

`_lm_step` is `linearize`, then `_schur_solve` (`_eliminate`: the
landmark Schur complement's blocks; `_reduced_solve`: the Cholesky solve
of the reduced camera system; `_depth_step`), then `_retract` and the cost
at the step's end; the sharded solver reduces between those stages. A
Cholesky failure gives a NaN step and a NaN cost, so the step is
rejected, as with the reference's `cho_factor`.
The LM loop is a Python loop that never waits on the device: accept or
reject is a `torch.where` over every state field of the window.

Each LM step linearizes, solves and costs in float64 whatever the window's
dtype; only the step is applied at the window's dtype (the reference runs
all of it at the window's dtype). After a marginalization the reduced
system's eigenvalues span ~1e7, so a float32 Gram product or Cholesky
decides the step along its weakest directions by rounding, and two
devices that sum in other orders walk apart by millimetres in 8 steps.
A float64 window computes exactly as before.
"""

from typing import NamedTuple

import torch
from torch.func import vmap

from pvio_torch.estimation import factors
from pvio_torch.estimation.preint_soa import preint_factor_bank_soa
from pvio_torch.geometry import camera, lie
from pvio_torch.imu.preintegration import cholesky_or_nan
from pvio_torch.map import window as win
from pvio_torch.map.window import TF_PLANE, TF_VALID, Extrinsics, WindowState
from pvio_torch.utils.autodiff import value_and_jacfwd

# the window fields an LM step changes
_STATE_FIELDS = ("q", "p", "v", "bg", "ba", "inv_depth", "plane_normal", "plane_distance")


class BAConfig(NamedTuple):
    """Solver knobs, the reference's fields and defaults (see
    `pvio_tpu/estimation/ba.py:49-93` for what each one trades)."""

    iterations: int = 10
    kp_sqrt_inv_cov: float = 458.0
    plane_sqrt_inv_cov: float = 100.0
    min_plane_tracks: int = 20
    use_inertial: bool = True
    use_planes: bool = True
    estimate_planes: bool = True
    plane_anchor_sigma_n: float = 0.002
    plane_anchor_sigma_d: float = 0.001
    plane_supplement: bool = False
    cauchy_scale: float = 1.0
    fused_preint: bool = False
    lm_lambda_init: float = 1e-4
    lm_lambda_up: float = 4.0
    lm_lambda_down: float = 0.5
    lm_lambda_min: float = 1e-10
    lm_lambda_max: float = 1e8


# ---------------------------------------------------------------------------
# factor masks


def _plane_members(w: WindowState):
    """Each track's clamped plane slot (T,) and whether it is a member (T,)."""
    P = w.plane_mask.shape[0]
    pid = torch.clamp(w.plane_id, 0, P - 1)
    member = w.track_mask & ((w.track_flags & TF_PLANE) != 0) & (w.plane_id >= 0)
    return pid, member


def plane_counts(w: WindowState):
    """Member tracks per plane slot (P,): the one cross-track statistic of
    the factor masks (it gates the augmented plane factor). A track-sharded
    solve sums it over its group and passes the sum as `counts`, where the
    reference psums it inside `_factor_masks` (`ba.py:100-114`). Only the
    track fields enter it, which an LM step leaves as they are."""
    P = w.plane_mask.shape[0]
    pid, member = _plane_members(w)
    # a one-hot sum: deterministic on CUDA
    onehot = pid[:, None] == torch.arange(P, device=w.kp.device)[None, :]
    return torch.sum(member[:, None] & onehot, dim=0)


def _factor_masks(w: WindowState, cfg: BAConfig, counts=None):
    """(repro_mask (F, T), depth_active (T,), plane_track (T,), plane_big (P,)).
    `counts` (P,) are the plane member counts over every track of the
    window, `plane_counts(w)` when not given."""
    F, T = w.kp.shape[0], w.kp.shape[1]
    P = w.plane_mask.shape[0]
    dev = w.kp.device
    is_valid = (w.track_flags & TF_VALID) != 0
    is_plane = (w.track_flags & TF_PLANE) != 0
    if cfg.use_planes:
        pid, member = _plane_members(w)
        if counts is None:
            counts = plane_counts(w)
        plane_big = (counts >= cfg.min_plane_tracks) & w.plane_mask
        big_track = member & plane_big[pid]
    else:
        big_track = torch.zeros(T, dtype=torch.bool, device=dev)
    if cfg.use_planes and cfg.plane_supplement:
        repro_track = w.track_mask & (is_valid | is_plane)
    else:
        repro_track = w.track_mask & (is_valid | is_plane) & ~big_track
    fm = w.frame_mask
    not_ref = torch.arange(F, device=dev)[:, None] != w.ref_frame[None, :]
    ref_ok = fm[w.ref_frame]                          # reference frame alive
    repro_mask = w.obs_mask & fm[:, None] & repro_track[None, :] & not_ref & ref_ok[None, :]
    depth_active = repro_track & ref_ok & torch.any(repro_mask, dim=0)
    plane_track = big_track & ref_ok
    if not cfg.use_planes:
        plane_big = torch.zeros(P, dtype=torch.bool, device=dev)
    return repro_mask, depth_active, plane_track, plane_big


def _active_dims(w: WindowState):
    """(F, 15) mask of active tangent dims: dead frames fully inactive,
    FIX_POSE frames freeze (theta, p)."""
    F = w.q.shape[0]
    dtype, dev = w.p.dtype, w.p.device
    m = w.frame_mask[:, None].expand(F, 15).to(dtype)
    first6 = (torch.arange(15, device=dev) < 6).to(dtype)
    return m * (1.0 - w.fix_mask[:, None].to(dtype) * first6[None, :])


# ---------------------------------------------------------------------------
# residual evaluation


def _cauchy_w(s, c2):
    """IRLS weight of CauchyLoss(c): 1 / (1 + s / c^2)."""
    return 1.0 / (1.0 + s / c2)


def _cauchy_rho(s, c2):
    """Robustified cost of the squared residual s."""
    return c2 * torch.log1p(s / c2)


def _repro_residual_t(delta13, q_t, p_t, q_r, p_r, d, z_r, z_t, extr, sic):
    q_tgt = lie.quat_mul(q_t, lie.expmap(delta13[0:3]))
    q_ref = lie.quat_mul(q_r, lie.expmap(delta13[6:9]))
    return factors.reprojection_residual(q_tgt, p_t + delta13[3:6], q_ref, p_r + delta13[9:12],
                                         d + delta13[12], z_r, z_t, extr, sic)


def _preint_residual_t(delta30, qi, pi, vi, bgi, bai, qj, pj, vj, bgj, baj,
                       delta, bg_lin, ba_lin, extr):
    di, dj = delta30[:15], delta30[15:]
    return factors.preintegration_residual(
        lie.quat_mul(qi, lie.expmap(di[0:3])), pi + di[3:6], vi + di[6:9],
        bgi + di[9:12], bai + di[12:15],
        lie.quat_mul(qj, lie.expmap(dj[0:3])), pj + dj[3:6], vj + dj[6:9],
        bgj + dj[9:12], baj + dj[12:15], delta, bg_lin, ba_lin, extr)


def _plane_residual_t(delta6F, q, p, kps, mask, normal, dist, extr, sic):
    d = delta6F.reshape(-1, 6)
    qd = lie.quat_mul(q, lie.expmap(d[:, 0:3]))
    return factors.augmented_plane_distance_residual(qd, p + d[:, 3:6], kps, mask, normal,
                                                     dist, extr, sic)


def _marg_residual_t(deltaF15, w: WindowState):
    d = deltaF15.reshape(-1, 15)
    q = lie.quat_mul(w.q, lie.expmap(d[:, 0:3]))
    return factors.marginalization_residual(q, w.p + d[:, 3:6], w.v + d[:, 6:9],
                                            w.bg + d[:, 9:12], w.ba + d[:, 12:15], w.prior)


def _gather_track_inputs(w: WindowState):
    """Reference-frame pose (T, 4), (T, 3) and keypoint (T, 2) of every track."""
    T = w.kp.shape[1]
    z_ref = w.kp[w.ref_frame, torch.arange(T, device=w.kp.device)]
    return w.q[w.ref_frame], w.p[w.ref_frame], z_ref


def _grid_args(w: WindowState):
    """Arguments of `_repro_residual_t` broadcast over the (F, T) grid."""
    q_ref, p_ref, z_ref = _gather_track_inputs(w)
    return (w.q[:, None], w.p[:, None], q_ref[None], p_ref[None], w.inv_depth[None],
            z_ref[None], w.kp)


def _consecutive(w: WindowState):
    """Per-factor arguments of the F-1 consecutive-frame preintegration
    factors (slot j's delta spans j-1 -> j)."""
    delta_j = type(w.delta)(*(a[1:] for a in w.delta))
    return (w.q[:-1], w.p[:-1], w.v[:-1], w.bg[:-1], w.ba[:-1],
            w.q[1:], w.p[1:], w.v[1:], w.bg[1:], w.ba[1:], delta_j, w.bg_lin[1:], w.ba_lin[1:])


def preint_factors(w: WindowState, extr: Extrinsics):
    """Whitened residuals and analytic Jacobians (F-1, 15), (F-1, 15, 15) x 2
    of the consecutive-frame preintegration factors, one pair at a time
    (the reference's vmap)."""
    return vmap(lambda *a: factors.preintegration_residual_and_jacobians(*a, extr))(
        *_consecutive(w))


def evaluate_cost(w: WindowState, extr: Extrinsics, cfg: BAConfig, counts=None):
    """Total robustified cost at the current state (no Jacobians); `counts`
    as in `_factor_masks`."""
    dtype = w.p.dtype
    repro_mask, _, plane_track, _ = _factor_masks(w, cfg, counts)
    c2 = cfg.cauchy_scale * cfg.cauchy_scale
    q_t, p_t, q_r, p_r, d, z_r, z_t = _grid_args(w)
    r = factors.reprojection_residual(q_t, p_t, q_r, p_r, d, z_r, z_t, extr,
                                      cfg.kp_sqrt_inv_cov)          # (F, T, 2)
    m = repro_mask.to(dtype)
    s = torch.sum(r * r, dim=-1) * m
    cost = torch.sum(_cauchy_rho(s, c2) * m)

    if cfg.use_inertial:
        mask_pre = (w.frame_mask[:-1] & w.frame_mask[1:] & w.delta_valid[1:]).to(dtype)
        rp = vmap(lambda *a: factors.preintegration_residual(*a, extr))(*_consecutive(w))
        cost = cost + torch.sum(torch.sum(rp * rp, dim=-1) * mask_pre)

    rm = factors.marginalization_residual(w.q, w.p, w.v, w.bg, w.ba, w.prior)
    cost = cost + torch.sum(rm * rm)

    if cfg.use_planes:
        P = w.plane_mask.shape[0]
        pid = torch.clamp(w.plane_id, 0, P - 1)
        obs_cols = w.obs_mask & w.frame_mask[:, None]
        rpl = factors.augmented_plane_distance_residual(
            w.q, w.p, w.kp.transpose(0, 1), obs_cols.T, w.plane_normal[pid],
            w.plane_distance[pid], extr, cfg.plane_sqrt_inv_cov)   # (T,)
        mpl = plane_track.to(dtype)
        cost = cost + torch.sum(_cauchy_rho(rpl * rpl * mpl, c2) * mpl)
    return cost


# ---------------------------------------------------------------------------
# linearization


def _pad15(x, *dims):
    """x with each of `dims` (of size 6, the pose block) zero-padded to the
    15 entries of a frame's state."""
    pad = [0] * (2 * x.dim())
    for d in dims:
        pad[2 * (x.dim() - 1 - d) + 1] = 15 - x.shape[d]
    return torch.nn.functional.pad(x, pad)


def linearize(w: WindowState, extr: Extrinsics, cfg: BAConfig, counts=None):
    """Gauss-Newton system. Returns (H (D, D), Hpd (D, T), Hdd (T,), b (D,),
    bd (T,), depth_active (T,), cost, dims (D,)), D = F*15, plus P*3 when
    planes are estimated in the solve (each armed plane's normal-tangent and
    distance); `dims` masks the active dimensions of the whole state.
    `counts` as in `_factor_masks`."""
    F, T = w.kp.shape[0], w.kp.shape[1]
    dtype, dev = w.p.dtype, w.p.device
    repro_mask, depth_active, plane_track, plane_big = _factor_masks(w, cfg, counts)
    c2 = cfg.cauchy_scale * cfg.cauchy_scale
    grid = _grid_args(w)

    def repro_t(d13):
        return _repro_residual_t(d13, *grid, extr, cfg.kp_sqrt_inv_cov)

    r, J = value_and_jacfwd(repro_t, torch.zeros(13, dtype=dtype, device=dev))
    # r (F, T, 2), J (F, T, 2, 13)
    m = repro_mask.to(dtype)
    s = torch.sum(r * r, dim=-1)
    sqrt_wgt = torch.sqrt(_cauchy_w(s, c2)) * m
    cost = torch.sum(_cauchy_rho(s, c2) * m)
    r_w = r * sqrt_wgt[..., None]
    J_w = J * sqrt_wgt[..., None, None]
    J_tgt = J_w[..., 0:6]
    J_ref = J_w[..., 6:12]
    J_d = J_w[..., 12]                                    # (F, T, 2)

    eyeF = torch.eye(F, dtype=dtype, device=dev)
    onehot_ref = eyeF[w.ref_frame]                        # (T, F)
    Jfull = (torch.einsum("ftai,fg->ftagi", J_tgt, eyeF)
             + torch.einsum("ftai,tg->ftagi", J_ref, onehot_ref))   # (F, T, 2, F, 6)
    # the pose blocks fill rows and columns 0:6 of each frame's 15; the
    # rest is zero (padded, not written in place, so the step vmaps)
    Hpp = _pad15(torch.einsum("ftagi,ftahj->gihj", Jfull, Jfull), 1, 3)
    bp = _pad15(torch.einsum("ftagi,fta->gi", Jfull, r_w), 1)
    Hpd = _pad15(torch.einsum("ftagi,fta->git", Jfull, J_d), 1)
    Hdd = torch.einsum("fta,fta->t", J_d, J_d)
    bd = torch.einsum("fta,fta->t", J_d, r_w)

    if cfg.use_inertial:
        mask_pre = (w.frame_mask[:-1] & w.frame_mask[1:] & w.delta_valid[1:]).to(dtype)
        if cfg.fused_preint:
            rp, Ji, Jj = preint_factor_bank_soa(w.q, w.p, w.v, w.bg, w.ba, w.delta,
                                                w.bg_lin, w.ba_lin, extr)
        else:
            rp, Ji, Jj = preint_factors(w, extr)
        rp = rp * mask_pre[:, None]
        Ji = Ji * mask_pre[:, None, None]
        Jj = Jj * mask_pre[:, None, None]
        cost = cost + torch.sum(rp * rp)
        Ei, Ej = eyeF[:-1], eyeF[1:]
        A_pre = (Ji[:, :, None, :] * Ei[:, None, :, None]
                 + Jj[:, :, None, :] * Ej[:, None, :, None]).reshape((F - 1) * 15, F * 15)
        Hpp = Hpp + (A_pre.T @ A_pre).reshape(F, 15, F, 15)
        bp = bp + (A_pre.T @ rp.reshape(-1)).reshape(F, 15)

    rm, Jm = factors.marginalization_residual_and_jacobian(w.q, w.p, w.v, w.bg, w.ba, w.prior)
    cost = cost + torch.sum(rm * rm)
    Hpp = Hpp + (Jm.T @ Jm).reshape(F, 15, F, 15)
    bp = bp + (Jm.T @ rm).reshape(F, 15)

    ext = cfg.use_planes and cfg.estimate_planes
    P = w.plane_mask.shape[0]
    if cfg.use_planes:
        pid = torch.clamp(w.plane_id, 0, P - 1)
        obs_cols = w.obs_mask & w.frame_mask[:, None]
        out = factors.augmented_plane_residual_and_pose_jacobian(
            w.q, w.p, w.kp, obs_cols, w.plane_normal[pid], w.plane_distance[pid], extr,
            cfg.plane_sqrt_inv_cov, with_plane_jacobian=ext)   # (T,), (T, F, 6)[, (T, 3)]
        rpl, Jpl = out[0], out[1]
        mp = plane_track.to(dtype)
        spl = rpl * rpl
        wpl = torch.sqrt(_cauchy_w(spl, c2)) * mp
        cost = cost + torch.sum(_cauchy_rho(spl, c2) * mp)
        rpl_w = rpl * wpl
        Jpl_w = Jpl * wpl[:, None, None]
        Hpp = Hpp + _pad15(torch.einsum("tgi,thj->gihj", Jpl_w, Jpl_w), 1, 3)
        bp = bp + _pad15(torch.einsum("tgi,t->gi", Jpl_w, rpl_w), 1)

    dims_pose = _active_dims(w).reshape(-1)
    H = Hpp.reshape(F * 15, F * 15)
    Hpd = Hpd.reshape(F * 15, T)
    b = bp.reshape(F * 15)
    if not ext:
        return H, Hpd, Hdd, b, bd, depth_active, cost, dims_pose

    # extend the reduced system with each armed plane's 3-dof tangent
    Jpl3_w = out[2] * wpl[:, None]                        # (T, 3)
    # one-hot by comparison: F.one_hot checks its indices on the host
    Epl = (pid[:, None] == torch.arange(P, device=dev)[None, :]).to(dtype)   # (T, P)
    Hplpl = torch.einsum("ti,tp,tj->pij", Jpl3_w, Epl, Jpl3_w)
    Hpose_pl = torch.einsum("tgi,tp,tj->gipj", Jpl_w, Epl, Jpl3_w)   # (F, 6, P, 3)
    b_pl = torch.einsum("ti,tp,t->pi", Jpl3_w, Epl, rpl_w)
    cross = _pad15(Hpose_pl, 1).reshape(F * 15, P * 3)
    # stay-here anchor on the plane tangent: information only, zero gradient
    anchor = torch.full((3,), 1.0 / cfg.plane_anchor_sigma_n ** 2, dtype=dtype, device=dev)
    anchor[2].fill_(1.0 / cfg.plane_anchor_sigma_d ** 2)
    Hplpl = Hplpl + torch.diag(anchor)[None, :, :]
    eyeP = torch.eye(P, dtype=torch.bool, device=dev)[:, None, :, None]
    Hpl_blocks = torch.where(eyeP, Hplpl[:, :, None, :].expand(P, 3, P, 3),
                             torch.zeros((), dtype=dtype, device=dev)).reshape(P * 3, P * 3)
    He = torch.cat([torch.cat([H, cross], dim=1), torch.cat([cross.T, Hpl_blocks], dim=1)])
    be = torch.cat([b, b_pl.reshape(-1)])
    Hpd_e = torch.cat([Hpd, torch.zeros(P * 3, T, dtype=dtype, device=dev)], dim=0)
    dims_pl = (plane_big & w.plane_mask).to(dtype)[:, None].expand(P, 3).reshape(-1)
    return He, Hpd_e, Hdd, be, bd, depth_active, cost, torch.cat([dims_pose, dims_pl])


# ---------------------------------------------------------------------------
# LM solve with Schur elimination


def _eliminate(Hpd, Hdd, bd, depth_active, m, lam):
    """The depth-elimination blocks of the damped system: the masked Hpd and
    bd, the damped inverse depth diagonal, and the two terms that the depths
    take from the reduced camera system, S = Hpd Hdd^-1 Hpd^T and
    s = Hpd Hdd^-1 bd. A track-sharded solve sums S and s over its group."""
    da = depth_active.to(Hpd.dtype)
    Hpd = Hpd * m[:, None] * da[None, :]
    bd = bd * da
    Hdd = torch.where(depth_active, Hdd, 1.0)
    Hdd_inv = 1.0 / (Hdd * (1.0 + lam))
    return Hpd, bd, Hdd_inv, (Hpd * Hdd_inv[None, :]) @ Hpd.T, Hpd @ (bd * Hdd_inv)


def _reduced_solve(H, b, S, s, m, lam):
    """Damp the pose/plane system, take the depths' S and s out of it and
    solve it by Cholesky. Returns the pose/plane step dp (D,)."""
    dtype, dev = H.dtype, H.device
    D = H.shape[0]
    H = H * m[:, None] * m[None, :]
    b = b * m
    diag_floor = torch.clamp(torch.diagonal(H), min=1e-8)
    Hpp_d = H + torch.diag(lam * diag_floor + (1.0 - m))    # inactive dims: unit diagonal
    Hred = Hpp_d - S
    bred = b - s
    jitter = 1e-9 * torch.trace(Hred) / D
    L = cholesky_or_nan(Hred + jitter * torch.eye(D, dtype=dtype, device=dev))
    return torch.cholesky_solve(-bred[:, None], L)[:, 0] * m


def _depth_step(Hpd, bd, Hdd_inv, depth_active, dp):
    """Back-substitution of the depths from the masked blocks of `_eliminate`."""
    return (-bd - Hpd.T @ dp) * Hdd_inv * depth_active.to(Hpd.dtype)


def _schur_solve(H, Hpd, Hdd, b, bd, depth_active, m, lam):
    """Damp, eliminate the depths and solve the reduced camera system by
    Cholesky. Returns the pose/plane step dp (D,) and depth step dd (T,)."""
    Hpd, bd, Hdd_inv, S, s = _eliminate(Hpd, Hdd, bd, depth_active, m, lam)
    dp = _reduced_solve(H, b, S, s, m, lam)
    return dp, _depth_step(Hpd, bd, Hdd_inv, depth_active, dp)


def _retract(w: WindowState, dp, dd):
    """The window after the pose/plane step dp and the depth step dd."""
    F = w.q.shape[0]
    P = w.plane_mask.shape[0]
    w_new = win.retract(w, dp[:F * 15].reshape(F, 15), dd)
    if dp.shape[0] > F * 15:
        w_new = win.retract_planes(w_new, dp[F * 15:].reshape(P, 3))
    return w_new


def _lm_step(w: WindowState, extr: Extrinsics, cfg: BAConfig, lam):
    """One LM step: (the window after it, float64 costs before and after)."""
    e64 = win.as_float64(extr)
    H, Hpd, Hdd, b, bd, depth_active, cost0, m = linearize(win.as_float64(w), e64, cfg)
    dp, dd = _schur_solve(H, Hpd, Hdd, b, bd, depth_active, m, lam)
    w_new = _retract(w, dp.to(w.p.dtype), dd.to(w.p.dtype))
    return w_new, cost0, evaluate_cost(win.as_float64(w_new), e64, cfg)


def _select(accept, new: WindowState, old: WindowState):
    return old._replace(**{f: torch.where(accept, getattr(new, f), getattr(old, f))
                           for f in _STATE_FIELDS})


def solve(w: WindowState, extr: Extrinsics, cfg: BAConfig):
    """cfg.iterations LM steps. Returns (w_final, info) with info's
    "initial_cost", "final_cost", "accepted" and "lambda" as device scalars."""
    lam = torch.full((), cfg.lm_lambda_init, dtype=w.p.dtype, device=w.p.device)
    costs0, accepts = [], []
    for _ in range(cfg.iterations):
        w_new, cost0, cost1 = _lm_step(w, extr, cfg, lam)
        accept = cost1 < cost0
        lam = torch.where(accept, torch.clamp(lam * cfg.lm_lambda_down, min=cfg.lm_lambda_min),
                          torch.clamp(lam * cfg.lm_lambda_up, max=cfg.lm_lambda_max))
        w = _select(accept, w_new, w)
        costs0.append(cost0)
        accepts.append(accept)
    info = {"initial_cost": costs0[0].to(w.p.dtype),
            "final_cost": torch.where(accept, cost1, cost0).to(w.p.dtype),
            "accepted": torch.sum(torch.stack(accepts)),
            "lambda": lam}
    return w, info


# ---------------------------------------------------------------------------
# post-solve track maintenance


def _nanmedian_rows(vals):
    """Median of each row of (P, N) ignoring NaNs, NaN for an empty row. An
    even count averages the two middle values as `jnp.nanmedian` does
    (lower * 0.5 + upper * 0.5); `torch.nanmedian` would return the lower."""
    n = torch.sum(~torch.isnan(vals), dim=-1)
    srt = torch.sort(vals, dim=-1).values                 # NaNs sort last
    pos = 0.5 * (n - 1).to(vals.dtype)
    lo_f, hi_f = torch.floor(pos), torch.ceil(pos)
    hw = pos - lo_f
    last = torch.clamp(n - 1, min=0)[:, None]
    lo = torch.clamp(lo_f.long()[:, None], min=0)
    hi = torch.clamp(hi_f.long()[:, None], min=0)
    lo = torch.minimum(lo, last)
    hi = torch.minimum(hi, last)
    lo_v = torch.gather(srt, -1, lo)[:, 0]
    hi_v = torch.gather(srt, -1, hi)[:, 0]
    return lo_v * (1.0 - hw) + hi_v * hw


def plane_track_escape(w: WindowState, extr: Extrinsics, track_life, min_life=10,
                       escape_dist=0.1, kp_sigma_px=None, f_px=None, sigma_k=3.0,
                       dist_floor=0.005):
    """Release bad plane adoptions after a solve: every mature TF_PLANE track
    with enough baseline whose fresh multi-view triangulation sits off its
    plane, measured against the median member of that plane, by more than
    the threshold goes back to TF_VALID. The threshold is escape_dist, or,
    given kp_sigma_px and f_px (host floats), the noise-scaled
    min(escape_dist, max(dist_floor, sigma_k * sigma_plane)) with the
    evidence gates of the reference (`pvio_tpu/estimation/ba.py:511-548`).
    track_life (T,) is each track's observation count."""
    dtype = w.p.dtype
    pts, inv_d, tri_ok = win.triangulate_tracks(w, extr)
    baseline = win.track_baselines(w)
    enough = (baseline > 0.5) | ((w.inv_depth < 5.0) & (baseline * w.inv_depth > 0.5))
    is_plane = ((w.track_flags & TF_PLANE) != 0) & w.track_mask
    P = w.plane_mask.shape[0]
    pid = torch.clamp(w.plane_id, 0, P - 1)
    n_pl = w.plane_normal[pid]
    signed = torch.sum(n_pl * pts, dim=-1) - w.plane_distance[pid]
    member_ok = is_plane & (w.plane_id >= 0) & tri_ok
    of_plane = pid[None, :] == torch.arange(P, device=pid.device)[:, None]     # (P, T)
    med = _nanmedian_rows(torch.where(member_ok[None, :] & of_plane, signed[None, :],
                                      torch.nan))
    med = torch.where(torch.isnan(med), 0.0, med)
    sigma_mode = kp_sigma_px is not None and f_px is not None
    if sigma_mode:
        z = 1.0 / torch.clamp(torch.abs(inv_d), min=1e-6)
        T = w.kp.shape[1]
        _, _, z_ref = _gather_track_inputs(w)
        q_wc = lie.quat_mul(w.q[w.ref_frame], extr.q_bc.expand(T, 4))
        bearing = lie.quat_rotate(q_wc, torch.cat([z_ref, torch.ones_like(z_ref[:, :1])], dim=-1))
        bearing = bearing / torch.linalg.norm(bearing, dim=-1, keepdim=True)
        c2 = torch.sum(n_pl * bearing, dim=-1) ** 2
        ang = kp_sigma_px / f_px
        sig_z = ang * z * z / torch.clamp(baseline, min=1e-3)
        sig_lat = ang * z
        # an n-view DLT's error is ~sqrt(n-1) below the two-view model
        n_obs = torch.sum(w.obs_mask & w.frame_mask[:, None], dim=0)
        red = torch.rsqrt(torch.clamp(n_obs - 1, min=1).to(dtype))
        sigma_pl = red * torch.sqrt(c2 * sig_z ** 2 + (1.0 - c2) * sig_lat ** 2)
        thresh = torch.clamp(torch.clamp(sigma_k * sigma_pl, min=dist_floor), max=escape_dist)
    else:
        thresh = escape_dist
    off = torch.abs(signed - med[pid]) > thresh
    escape = (is_plane & (w.plane_id >= 0) & w.plane_mask[pid] & (track_life > min_life)
              & enough & tri_ok & off)
    depth_write = escape
    if sigma_mode:
        rpe_fresh = _mean_rpe_norm(w, extr, pts) * f_px
        rpe_stored = _mean_rpe_norm(w, extr, win.landmark_points(w, extr)) * f_px
        escape = escape & (rpe_fresh <= max(2.0 * kp_sigma_px, 1.0))
        depth_write = escape & (rpe_fresh < rpe_stored)
    flags = torch.where(escape, (w.track_flags & ~TF_PLANE) | TF_VALID, w.track_flags)
    return w._replace(track_flags=flags,
                      inv_depth=torch.where(depth_write, inv_d, w.inv_depth),
                      plane_id=torch.where(escape, -1, w.plane_id))


def _project_into_frames(w: WindowState, extr: Extrinsics, x):
    """Points x (T, 3) in every frame's camera: (F, T, 3)."""
    q_ws = lie.quat_mul(w.q, extr.q_bc.expand_as(w.q))
    p_ws = w.p + lie.quat_rotate(w.q, extr.p_bc.expand_as(w.p))
    return lie.quat_rotate(lie.quat_conj(q_ws)[:, None, :], x[None, :, :] - p_ws[:, None, :])


def _mean_rpe_norm(w: WindowState, extr: Extrinsics, x):
    """Mean normalized-coordinate reprojection error (T,) of candidate points
    x over each track's observing frames; +inf on a cheirality failure or
    without observations."""
    y = _project_into_frames(w, extr, x)
    obs = w.obs_mask & w.frame_mask[:, None]
    err = torch.linalg.norm(camera.project(y) - w.kp, dim=-1)
    cnt = torch.sum(obs, dim=0)
    mean = torch.sum(torch.where(obs, err, 0.0), dim=0) / torch.clamp(cnt, min=1)
    bad = torch.any(obs & (y[..., 2] <= 1e-6), dim=0) | (cnt == 0)
    return torch.where(bad, torch.inf, mean)


def post_solve_update(w: WindowState, extr: Extrinsics, K, min_z=1.0e-3, max_z=50.0):
    """Depth gate and quality after a solve: a track whose landmark leaves
    (min_z, max_z) in any observing frame loses TF_VALID and TF_PLANE; valid
    tracks get quality = mean pixel reprojection error."""
    dtype = w.p.dtype
    y = _project_into_frames(w, extr, win.landmark_points(w, extr))
    z = y[..., 2]
    obs = w.obs_mask & w.frame_mask[:, None]
    bad = torch.any(obs & ((z <= min_z) | (z > max_z)), dim=0)
    err_px = torch.linalg.norm(camera.apply_k(camera.project(y), K) - camera.apply_k(w.kp, K),
                               dim=-1)
    cnt = torch.clamp(torch.sum(obs, dim=0).to(dtype), min=1.0)
    quality = torch.sum(torch.where(obs, err_px, 0.0), dim=0) / cnt
    is_valid = (w.track_flags & TF_VALID) != 0
    flags = torch.where(bad, w.track_flags & ~(TF_VALID | TF_PLANE), w.track_flags)
    return w._replace(track_flags=flags,
                      quality=torch.where(is_valid & ~bad, quality, w.quality))

"""Frame marginalization: dense Schur complement -> square-root-information
prior.

Matches `pvio_tpu/estimation/marginalization.py`: `_clamped_pinv`,
`accumulate_information`, `make_initial_prior`, `_shift_out`,
`marginalize_and_remove` and `rebase_tracks`. The victim's information is
gathered from the existing prior, its adjacent preintegration factors and
the unrobustified reprojections of the valid non-plane tracks it observes
(landmarks Schur-eliminated, rank 1 each); the victim block is then
eliminated with an eigenvalue-clamped pseudo-inverse, the window shifts
down one slot, and the new prior is sqrt_info = sqrt(lambda) V^T,
infovec = sqrt(lambda)^-1 V^T b with eigenvalues clamped at 1e-8.

`eigh` fixes neither the eigenvectors' signs nor the basis inside a
repeated eigenvalue (the 15 zeroed dims of the removed slot), here or in the
reference. Only S^T S and S^T infovec are determined, and they are all a
solve ever uses. Both decompositions go through `ops.eigh.eigh`:
`torch.linalg.eigh` on the CPU, kernel E2 on the card (in float64), which
reads nothing back to the host, where `torch.linalg.eigh` would read its
error codes and make the marginalization wait for the device twice.

`marginalize_and_remove` builds (H, b), the Schur complements and the
decomposition in float64 whatever the window's dtype, and casts only the
new prior back; the reference runs them at the window's dtype. In float32
the victim's Schur complement cancels entries of ~1e7 down to eigenvalues
of a few units, so its rounding (~1e2 there, negative eigenvalues of that
size) picks the retained eigenspace, and two devices that sum in other
orders keep different priors. In float64 that rounding sits ~1e9 below
the smallest kept eigenvalue.
"""

import torch

from pvio_torch.estimation import factors
from pvio_torch.estimation.ba import (BAConfig, _grid_args, _repro_residual_t,
                                      preint_factors)
from pvio_torch.geometry import lie
from pvio_torch.map import window as win
from pvio_torch.map.window import TF_PLANE, TF_VALID, Extrinsics, MargPrior, WindowState
from pvio_torch.ops import eigh as eigh_op
from pvio_torch.utils.autodiff import value_and_jacfwd


def _clamped_pinv(M, eps=1e-8):
    lam, V = eigh_op.eigh(M)
    lam_inv = torch.where(lam > eps, 1.0 / torch.where(lam > eps, lam, 1.0), 0.0)
    return (V * lam_inv[None, :]) @ V.T


def accumulate_information(w: WindowState, extr: Extrinsics, cfg: BAConfig, index: int):
    """(H (F*15, F*15), b (F*15,)) of the factors that marginalizing frame
    slot `index` collects, landmarks already Schur-eliminated."""
    F = w.kp.shape[0]
    dtype, dev = w.p.dtype, w.p.device
    eyeF = torch.eye(F, dtype=dtype, device=dev)

    # (a) the existing prior
    rm, Jm = factors.marginalization_residual_and_jacobian(w.q, w.p, w.v, w.bg, w.ba, w.prior)
    H = (Jm.T @ Jm).reshape(F, 15, F, 15)
    b = (Jm.T @ rm).reshape(F, 15)

    # (b) the preintegration factors into and out of the victim
    span = torch.arange(F - 1, device=dev)
    include = (((span == index) & (index + 1 < F))          # spans index -> index + 1
               | ((span == index - 1) & (index >= 1)))      # spans index - 1 -> index
    mask_pre = (w.frame_mask[:-1] & w.frame_mask[1:] & w.delta_valid[1:] & include).to(dtype)
    rp, Ji, Jj = preint_factors(w, extr)
    rp = rp * mask_pre[:, None]
    Ji = Ji * mask_pre[:, None, None]
    Jj = Jj * mask_pre[:, None, None]
    A_pre = (Ji[:, :, None, :] * eyeF[:-1][:, None, :, None]
             + Jj[:, :, None, :] * eyeF[1:][:, None, :, None]).reshape((F - 1) * 15, F * 15)
    H = H + (A_pre.T @ A_pre).reshape(F, 15, F, 15)
    b = b + (A_pre.T @ rp.reshape(-1)).reshape(F, 15)

    # (c) unrobustified reprojections of the victim's valid non-plane tracks
    is_valid = (w.track_flags & TF_VALID) != 0
    is_plane = (w.track_flags & TF_PLANE) != 0
    marg_track = (w.obs_mask[index] & w.track_mask & is_valid & ~is_plane
                  & w.frame_mask[w.ref_frame])
    not_ref = torch.arange(F, device=dev)[:, None] != w.ref_frame[None, :]
    m_obs = (w.obs_mask & w.frame_mask[:, None] & marg_track[None, :] & not_ref).to(dtype)
    grid = _grid_args(w)

    def repro_t(d13):
        return _repro_residual_t(d13, *grid, extr, cfg.kp_sqrt_inv_cov)

    r, J = value_and_jacfwd(repro_t, torch.zeros(13, dtype=dtype, device=dev))
    r = r * m_obs[..., None]
    J = J * m_obs[..., None, None]
    J_d = J[..., 12]
    Jfull = (torch.einsum("ftai,fg->ftagi", J[..., 0:6], eyeF)
             + torch.einsum("ftai,tg->ftagi", J[..., 6:12], eyeF[w.ref_frame]))
    H[:, 0:6, :, 0:6] += torch.einsum("ftagi,ftahj->gihj", Jfull, Jfull)
    b[:, 0:6] += torch.einsum("ftagi,fta->gi", Jfull, r)

    # landmark Schur elimination (rank 1 per track)
    Hdd = torch.einsum("fta,fta->t", J_d, J_d)
    bd = torch.einsum("fta,fta->t", J_d, r)
    h = torch.einsum("ftagi,fta->tgi", Jfull, J_d)        # (T, F, 6)
    Hdd_inv = torch.where(Hdd > 1e-12, 1.0 / torch.where(Hdd > 1e-12, Hdd, 1.0), 0.0)
    H[:, 0:6, :, 0:6] += -torch.einsum("tgi,t,thj->gihj", h, Hdd_inv, h)
    b[:, 0:6] += -torch.einsum("tgi,t->gi", h, Hdd_inv * bd)
    return H.reshape(F * 15, F * 15), b.reshape(F * 15)


def make_initial_prior(w: WindowState, sqrt_info_value=3.0e3, index: int = 0,
                       yaw_only: bool = True) -> MargPrior:
    """Gauge prior on frame `index`'s pose (sqrt-info 3e3): its position and,
    with yaw_only, only the yaw tangent direction a = R_wb^T e_z, so later
    solves can still rotate roll and pitch onto gravity."""
    F = w.q.shape[0]
    dtype, dev = w.p.dtype, w.p.device
    s = sqrt_info_value
    M = w.p.new_zeros(F * 15, F * 15)     # batched with the window under vmap
    sl = index * 15
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    if yaw_only:
        e_z = torch.zeros(3, dtype=dtype, device=dev)
        e_z[2].fill_(1.0)                 # a kernel; `e_z[2] = 1.0` would copy from the host
        a = lie.quat_rotate(lie.quat_conj(w.q[index]), e_z)
        a = a / torch.clamp(torch.linalg.norm(a), min=1e-12)
        M[sl:sl + 3, sl:sl + 3] = s * torch.outer(a, a)
    else:
        M[sl:sl + 3, sl:sl + 3] = s * eye3
    M[sl + 3:sl + 6, sl + 3:sl + 6] = s * eye3
    return MargPrior(sqrt_info=M, infovec=torch.zeros(F * 15, dtype=dtype, device=dev),
                     q0=w.q, p0=w.p, v0=w.v, bg0=w.bg, ba0=w.ba,
                     valid=torch.ones((), dtype=torch.bool, device=dev))


def _shift_out(arr, index):
    """Remove slot `index` along dim 0 and pad a zeroed slot at the end."""
    return torch.cat([arr[:index], arr[index + 1:], torch.zeros_like(arr[:1])], dim=0)


def marginalize_and_remove(w: WindowState, extr: Extrinsics, cfg: BAConfig,
                           index: int = 0) -> WindowState:
    """Marginalize frame slot `index` (a Python int) into the prior and
    compact the window. Re-basing the tracks whose reference is that slot is
    the caller's (`rebase_tracks`). The prior is computed in float64 and
    stored at the window's dtype."""
    F = w.kp.shape[0]
    dtype, dev = w.p.dtype, w.p.device
    H, b = accumulate_information(win.as_float64(w), win.as_float64(extr), cfg, index)

    sl = slice(index * 15, (index + 1) * 15)
    Hkk_inv = _clamped_pinv(H[sl, sl])
    Hk = H[:, sl]                                         # (F*15, 15)
    H2 = H - Hk @ Hkk_inv @ Hk.T
    b2 = b - Hk @ (Hkk_inv @ b[sl])
    keep = torch.ones(F * 15, dtype=torch.bool, device=dev)
    keep[sl] = False
    H2 = H2 * keep[:, None] * keep[None, :]
    b2 = b2 * keep
    H3 = H2.reshape(F, 15, F, 15)
    H3 = _shift_out(_shift_out(H3, index).permute(2, 3, 0, 1), index).permute(2, 3, 0, 1)
    b3 = _shift_out(b2.reshape(F, 15), index)

    lam, V = eigh_op.eigh(H3.reshape(F * 15, F * 15))
    ok = lam > 1e-8
    lam_c = torch.where(ok, lam, 0.0)
    lam_inv = torch.where(ok, 1.0 / torch.where(ok, lam, 1.0), 0.0)
    sqrt_info = (torch.sqrt(lam_c)[:, None] * V.T).to(dtype)
    infovec = (torch.sqrt(lam_inv)[:, None] * V.T @ b3.reshape(-1)).to(dtype)

    def shift(a):
        return _shift_out(a, index)

    new_q = shift(w.q)
    new_q[-1, 0].fill_(1.0)                               # the freed slot: identity
    # the preintegration deltas are re-integrated from raw IMU before the
    # next solve (attach_deltas), not merged across the removed slot
    return w._replace(
        q=new_q, p=shift(w.p), v=shift(w.v), bg=shift(w.bg), ba=shift(w.ba),
        frame_mask=shift(w.frame_mask), fix_mask=shift(w.fix_mask),
        delta=type(w.delta)(*(shift(a) for a in w.delta)),
        delta_valid=shift(w.delta_valid), bg_lin=shift(w.bg_lin), ba_lin=shift(w.ba_lin),
        kp=shift(w.kp), obs_mask=shift(w.obs_mask),
        ref_frame=torch.where(w.ref_frame > index, w.ref_frame - 1,
                              torch.where(w.ref_frame == index, 0, w.ref_frame)),
        prior=MargPrior(sqrt_info=sqrt_info, infovec=infovec, q0=shift(w.q), p0=shift(w.p),
                        v0=shift(w.v), bg0=shift(w.bg), ba0=shift(w.ba),
                        valid=torch.ones((), dtype=torch.bool, device=dev)))


def rebase_tracks(w: WindowState, extr: Extrinsics, removed_slot: int = 0):
    """Before removing `removed_slot`, move the reference of every track
    that has it onto the track's next observing slot, transporting the
    inverse depth so the landmark stays put; tracks with no other
    observation are dropped."""
    needs = (w.ref_frame == removed_slot) & w.track_mask
    obs = (w.obs_mask & w.frame_mask[:, None]).clone()
    obs[removed_slot] = False
    has_next = torch.any(obs, dim=0)
    # first observing slot; argmax keeps the first of equal maxima, as in JAX
    next_slot = torch.argmax(obs.to(torch.int32), dim=0)

    x = win.landmark_points(w, extr)
    q_new, p_new = w.q[next_slot], w.p[next_slot]
    q_ws = lie.quat_mul(q_new, extr.q_bc.expand_as(q_new))
    p_ws = p_new + lie.quat_rotate(q_new, extr.p_bc.expand_as(p_new))
    z = lie.quat_rotate(lie.quat_conj(q_ws), x - p_ws)[..., 2]
    new_inv_depth = 1.0 / torch.where(torch.abs(z) < 1e-6, 1e-6, z)

    apply = needs & has_next
    drop = needs & ~has_next
    return w._replace(
        ref_frame=torch.where(apply, next_slot, w.ref_frame),
        inv_depth=torch.where(apply, new_inv_depth, w.inv_depth),
        track_flags=torch.where(drop, w.track_flags & ~(TF_VALID | TF_PLANE), w.track_flags),
        track_mask=w.track_mask & ~drop)

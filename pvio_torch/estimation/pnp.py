"""Motion-only visual-inertial PnP for the newest frame.

Matches `pvio_tpu/estimation/pnp.py`: `PnPConfig` and `solve_pnp`. The
newest frame's (q, p, v, bg, ba) is refined against a preintegration prior
from the last window frame and Cauchy-robustified pose-only reprojection
residuals of fixed world landmarks, by `iterations` Levenberg-Marquardt
steps in a Python loop (the reference scans). Each step solves the damped
15x15 normal equations by Cholesky with the reference's trace jitter
(`pnp.py:105-109`) and accepts or rejects with `torch.where`, so the loop
never waits on the device.
"""

from typing import NamedTuple

import torch

from pvio_torch.estimation import factors
from pvio_torch.geometry import lie
from pvio_torch.imu.preintegration import PreintDelta, cholesky_or_nan
from pvio_torch.map.window import Extrinsics
from pvio_torch.utils.autodiff import value_and_jacfwd


class PnPConfig(NamedTuple):
    iterations: int = 10
    kp_sqrt_inv_cov: float = 458.0
    use_inertial: bool = True
    cauchy_scale: float = 1.0
    lm_lambda_init: float = 1e-4
    lm_lambda_up: float = 4.0
    lm_lambda_down: float = 0.5


def solve_pnp(q0, p0, v0, bg0, ba0, last_q, last_p, last_v, last_bg, last_ba,
              delta: PreintDelta, bg_lin, ba_lin, x_world, z_obs, obs_mask,
              extr: Extrinsics, cfg: PnPConfig):
    """Returns (q, p, v, bg, ba) of the refined newest frame. x_world (T, 3)
    fixed landmarks, z_obs (T, 2) their normalized keypoints, obs_mask (T,)."""
    dtype, dev = p0.dtype, p0.device
    sic = cfg.kp_sqrt_inv_cov
    c2 = cfg.cauchy_scale * cfg.cauchy_scale
    m = obs_mask.to(dtype)
    eye15 = torch.eye(15, dtype=dtype, device=dev)

    def reproj(q, p):
        return factors.pose_only_reprojection_residual(q, p, x_world, z_obs, extr, sic)

    def cost_of(state):
        q, p, v, bg, ba = state
        r2 = reproj(q, p)
        s = torch.sum(r2 * r2, dim=-1)
        cost = torch.sum(c2 * torch.log1p(s / c2) * m)
        if cfg.use_inertial:
            rp = factors.preintegration_residual(
                last_q, last_p, last_v, last_bg, last_ba, q, p, v, bg, ba,
                delta, bg_lin, ba_lin, extr)
            cost = cost + torch.sum(rp * rp)
        return s, cost

    def retract(state, d15):
        q, p, v, bg, ba = state
        return (lie.quat_normalize(lie.quat_mul(q, lie.expmap(d15[0:3]))),
                p + d15[3:6], v + d15[6:9], bg + d15[9:12], ba + d15[12:15])

    def lm_step(state, lam):
        def r_repro_t(d15):
            q, p, _, _, _ = retract(state, d15)
            return reproj(q, p).reshape(-1)

        s, cost0 = cost_of(state)
        r2, J2 = value_and_jacfwd(r_repro_t, torch.zeros(15, dtype=dtype, device=dev))
        r2 = r2.reshape(-1, 2)
        J2 = J2.reshape(-1, 2, 15)
        wgt = torch.sqrt(1.0 / (1.0 + s / c2)) * m
        r_w = r2 * wgt[:, None]
        J_w = J2 * wgt[:, None, None]
        H = torch.einsum("tai,taj->ij", J_w, J_w)
        b = torch.einsum("tai,ta->i", J_w, r_w)
        if cfg.use_inertial:
            q, p, v, bg, ba = state
            rpv, _, Jp = factors.preintegration_residual_and_jacobians(
                last_q, last_p, last_v, last_bg, last_ba, q, p, v, bg, ba,
                delta, bg_lin, ba_lin, extr)
            H = H + Jp.T @ Jp
            b = b + Jp.T @ rpv
        diag = torch.clamp(torch.diagonal(H), min=1e-8)
        Hd = H + torch.diag(lam * diag)
        L = cholesky_or_nan(Hd + 1e-9 * torch.trace(Hd) / 15 * eye15)
        d = -torch.cholesky_solve(b[:, None], L)[:, 0]
        new_state = retract(state, d)
        _, cost1 = cost_of(new_state)
        return new_state, cost0, cost1

    state = (q0, p0, v0, bg0, ba0)
    lam = torch.full((), cfg.lm_lambda_init, dtype=dtype, device=dev)
    for _ in range(cfg.iterations):
        new_state, cost0, cost1 = lm_step(state, lam)
        accept = cost1 < cost0
        lam = torch.where(accept, lam * cfg.lm_lambda_down, lam * cfg.lm_lambda_up)
        lam = torch.clamp(lam, 1e-10, 1e8)
        state = tuple(torch.where(accept, b_, a) for a, b_ in zip(state, new_state))
    return state

"""On-manifold IMU preintegration over a padded sample buffer.

Matches `pvio_tpu/imu/preintegration.py`: `PreintDelta`, `ImuNoise`,
`fit_span`, `_increment` (the sequential oracle; a Python loop where the
reference scans), `_preintegrate_tree` (the default, `preint_assoc=True`),
`preintegrate`, `sqrt_inv_covariance` and `predict`. Padded samples carry
dt = 0 and are exact identities. Error-state order is (q, p, v, bg, ba).

The tree path composes the per-sample elements pairwise in the same
pairing as the reference ((0,1), (2,3), ... after padding to a power of
two); the prefix rotations come from a log-depth inclusive scan. Both are
the reference's math up to float reassociation.
"""

from typing import NamedTuple

import numpy as np
import torch

from pvio_torch.geometry import lie

GRAVITY_NOMINAL = 9.80665
ES_Q, ES_P, ES_V, ES_BG, ES_BA, ES_SIZE = 0, 3, 6, 9, 12, 15


class PreintDelta(NamedTuple):
    """Preintegrated IMU measurement between two frames (fields may carry
    leading batch dims)."""

    t: torch.Tensor             # () total dt
    q: torch.Tensor             # (4,) delta q (w, x, y, z)
    p: torch.Tensor             # (3,)
    v: torch.Tensor             # (3,)
    cov: torch.Tensor           # (15, 15) error-state covariance
    sqrt_inv_cov: torch.Tensor  # (15, 15) whitener S, S^T S = cov^-1
    dq_dbg: torch.Tensor        # (3, 3)
    dp_dbg: torch.Tensor
    dp_dba: torch.Tensor
    dv_dbg: torch.Tensor
    dv_dba: torch.Tensor


class ImuNoise(NamedTuple):
    """Continuous-time noise covariances (3, 3) each."""

    cov_w: torch.Tensor
    cov_a: torch.Tensor
    cov_bg: torch.Tensor
    cov_ba: torch.Tensor

    @staticmethod
    def isotropic(sw, sa, sbg, sba, dtype=torch.float32, device="cpu"):
        eye = torch.eye(3, dtype=dtype, device=device)
        return ImuNoise(sw * eye, sa * eye, sbg * eye, sba * eye)


def fit_span(ts, ws, accs, t_end, capacity):
    """Host-side: fit an IMU span into `capacity` samples by
    integral-preserving pairwise merging (never truncation). Returns numpy
    (ts, ws, accs) with len <= capacity."""
    ts = np.asarray(ts, np.float64)
    ws = np.asarray(ws, np.float64).reshape(-1, 3)
    accs = np.asarray(accs, np.float64).reshape(-1, 3)
    while len(ts) > capacity:
        dts = np.diff(np.concatenate([ts, [max(t_end, ts[-1])]]))
        dts = np.maximum(dts, 0.0)
        n = len(ts)
        n2 = n // 2
        d0 = dts[0: 2 * n2: 2]
        d1 = dts[1: 2 * n2: 2]
        tot = np.maximum(d0 + d1, 1e-12)
        w2 = (ws[0: 2 * n2: 2] * d0[:, None] + ws[1: 2 * n2: 2] * d1[:, None]) / tot[:, None]
        a2 = (accs[0: 2 * n2: 2] * d0[:, None] + accs[1: 2 * n2: 2] * d1[:, None]) / tot[:, None]
        t2 = ts[0: 2 * n2: 2]
        if n % 2:
            t2 = np.concatenate([t2, ts[-1:]])
            w2 = np.concatenate([w2, ws[-1:]])
            a2 = np.concatenate([a2, accs[-1:]])
        ts, ws, accs = t2, w2, a2
    return ts, ws, accs


def unit_quat(dtype, device):
    """(1, 0, 0, 0) made on the device: a tensor built from a Python list,
    or an element set from a Python number (`q[0] = 1.0`), is copied from
    pageable host memory, which waits on the stream; `fill_` is a kernel."""
    q = torch.zeros(4, dtype=dtype, device=device)
    q[0].fill_(1.0)
    return q


def gravity(dtype, device):
    """(0, 0, -g), made on the device like `unit_quat`."""
    g = torch.zeros(3, dtype=dtype, device=device)
    g[2].fill_(-GRAVITY_NOMINAL)
    return g


def _block(rows):
    return torch.cat([torch.cat(r, dim=-1) for r in rows], dim=-2)


def _transition(dt, w, a, dq, Rd, noise):
    """Per-sample (A (9, 9), Q (9, 9), Jr, Rstep_T, Ra) for the error-state
    recursion; batched over leading dims of dt."""
    I3 = torch.eye(3, dtype=dt.dtype, device=dt.device).expand(*dt.shape, 3, 3)
    Z3 = torch.zeros_like(I3)
    d = dt[..., None, None]
    Rstep_T = lie.quat_to_mat(dq).transpose(-1, -2)
    Ra = Rd @ lie.hat(a)
    Jr = lie.right_jacobian(w * dt[..., None])
    A = _block([[Rstep_T, Z3, Z3],
                [-0.5 * d * d * Ra, I3, d * I3],
                [-d * Ra, Z3, I3]])
    B = _block([[d * Jr, Z3], [Z3, 0.5 * d * d * Rd], [Z3, d * Rd]])
    inv_dt = (1.0 / torch.clamp(dt, min=1e-7))[..., None, None]
    N = _block([[noise.cov_w * inv_dt, Z3], [Z3, noise.cov_a * inv_dt]])
    live = torch.where(dt > 0, torch.ones_like(dt), torch.zeros_like(dt))[..., None, None]
    Q = (B @ N @ B.transpose(-1, -2)) * live
    return A, Q, Jr, Rstep_T, Ra


def _increment(state, dt, w_raw, a_raw, bg, ba, noise):
    """One IMU sample step of the sequential oracle; dt == 0 is a no-op."""
    t, q, p, v, cov9, covbg, covba, J = state
    w = w_raw - bg
    a = a_raw - ba
    Rd = lie.quat_to_mat(q)
    dq = lie.expmap(w * dt)
    A, Q, Jr, Rstep_T, Ra = _transition(dt, w, a, dq, Rd, noise)
    cov9 = A @ cov9 @ A.T + Q
    covbg = covbg + noise.cov_bg * dt
    covba = covba + noise.cov_ba * dt
    dq_dbg, dp_dbg, dp_dba, dv_dbg, dv_dba = J
    dp_dbg = dp_dbg + dt * dv_dbg - 0.5 * dt * dt * Ra @ dq_dbg
    dp_dba = dp_dba + dt * dv_dba - 0.5 * dt * dt * Rd
    dv_dbg = dv_dbg - dt * Ra @ dq_dbg
    dv_dba = dv_dba - dt * Rd
    dq_dbg = Rstep_T @ dq_dbg - dt * Jr
    a_world = lie.quat_rotate(q, a)
    p = p + dt * v + 0.5 * dt * dt * a_world
    v = v + dt * a_world
    q = lie.quat_normalize(lie.quat_mul(q, dq))
    t = t + dt
    return (t, q, p, v, cov9, covbg, covba, (dq_dbg, dp_dbg, dp_dba, dv_dbg, dv_dba))


def _prefix_quat(dq):
    """Inclusive prefix products q_0, q_0 q_1, ... of (n, 4) quaternions
    in ceil(log2 n) rounds (Hillis-Steele)."""
    qs = dq
    d = 1
    n = dq.shape[0]
    while d < n:
        qs = torch.cat([qs[:d], lie.quat_mul(qs[:-d], qs[d:])], dim=0)
        d *= 2
    return qs


def _preintegrate_tree(dts, ws, accs, bg, ba, noise):
    """Log-depth preintegration by tree reduction. Returns
    (t, q, p, v, cov9, Gg (9, 3), Ga (9, 3))."""
    dtype, dev = ws.dtype, ws.device
    n = dts.shape[0]
    w = ws - bg
    a = accs - ba
    dq = lie.expmap(w * dts[:, None])                    # (n, 4)
    qs = _prefix_quat(dq)
    ident = unit_quat(dtype, dev)
    q_pref = torch.cat([ident[None], qs[:-1]], dim=0)
    Rd = lie.quat_to_mat(q_pref)
    A, Q, Jr, _, _ = _transition(dts, w, a, dq, Rd, noise)
    d = dts[:, None, None]
    Z3 = torch.zeros_like(Jr)
    Gg = torch.cat([-d * Jr, Z3, Z3], dim=-2)            # (n, 9, 3)
    Ga = torch.cat([Z3, -0.5 * d * d * Rd, -d * Rd], dim=-2)
    # state parts in each element's own start frame
    el = [dts, dq, 0.5 * d[..., 0] * d[..., 0] * a, d[..., 0] * a, A, Q, Gg, Ga]

    m = 1
    while m < n:
        m *= 2
    if m > n:
        pad = m - n
        fills = [torch.zeros((), dtype=dtype, device=dev), ident,
                 torch.zeros(3, dtype=dtype, device=dev), torch.zeros(3, dtype=dtype, device=dev),
                 torch.eye(9, dtype=dtype, device=dev), torch.zeros(9, 9, dtype=dtype, device=dev),
                 torch.zeros(9, 3, dtype=dtype, device=dev), torch.zeros(9, 3, dtype=dtype, device=dev)]
        el = [torch.cat([x, f.expand(pad, *f.shape)], dim=0) for x, f in zip(el, fills)]
    while m > 1:
        ta, qa, pa, va, Aa, Qa, Gga, Gaa = [x[0::2] for x in el]
        tb, qb, pb, vb, Ab, Qb, Ggb, Gab = [x[1::2] for x in el]
        Ra = lie.quat_to_mat(qa)
        el = [
            ta + tb,
            lie.quat_normalize(lie.quat_mul(qa, qb)),
            pa + va * tb[..., None] + lie.mv(Ra, pb),
            va + lie.mv(Ra, vb),
            Ab @ Aa,
            Ab @ Qa @ Ab.transpose(-1, -2) + Qb,
            Ab @ Gga + Ggb,
            Ab @ Gaa + Gab,
        ]
        m //= 2
    t, q, p, v, _A, Q, Gg, Ga = [x[0] for x in el]
    return t, q, p, v, Q, Gg, Ga


def preintegrate(ts, ws, accs, mask, t_target, bg, ba, noise,
                 compute_covariance=True, assoc=True):
    """Integrate a padded IMU buffer into a PreintDelta.

    ts (N,), ws/accs (N, 3), mask (N,) bool, t_target the end time, bg/ba
    (3,) linearization biases. Sample i integrates with dt = t_{i+1} - t_i,
    the last masked sample with dt = t_target - t_last; padded entries with
    dt = 0. assoc=True uses the tree reduction, assoc=False the sequential
    oracle."""
    dtype, dev = ws.dtype, ws.device
    n = ts.shape[0]
    m = mask.to(dtype)
    count = torch.sum(mask)
    idx = torch.arange(n, device=dev)
    is_last = idx == (count - 1)
    t_target = torch.as_tensor(t_target, dtype=dtype, device=dev)
    t_next = torch.where(is_last, t_target, torch.roll(ts, -1))
    dts = torch.clamp(t_next - ts, min=0.0) * m

    if assoc:
        t, q, p, v, cov9, Gg, Ga = _preintegrate_tree(dts, ws, accs, bg, ba, noise)
        covbg = noise.cov_bg * t
        covba = noise.cov_ba * t
        J = (Gg[0:3], Gg[3:6], Ga[3:6], Gg[6:9], Ga[6:9])
    else:
        z33 = torch.zeros(3, 3, dtype=dtype, device=dev)
        state = (torch.zeros((), dtype=dtype, device=dev),
                 unit_quat(dtype, dev),
                 torch.zeros(3, dtype=dtype, device=dev), torch.zeros(3, dtype=dtype, device=dev),
                 torch.zeros(9, 9, dtype=dtype, device=dev), z33, z33, (z33,) * 5)
        for i in range(n):
            state = _increment(state, dts[i], ws[i], accs[i], bg, ba, noise)
        t, q, p, v, cov9, covbg, covba, J = state

    # assembled out of place, so that `torch.func.vmap` can batch it
    z3 = torch.zeros_like(covbg)
    cov = _block([[cov9, torch.zeros(9, 6, dtype=dtype, device=dev)],
                  [torch.zeros(6, 9, dtype=dtype, device=dev), _block([[covbg, z3], [z3, covba]])]])
    if compute_covariance:
        sqrt_inv_cov = sqrt_inv_covariance(cov)
    else:
        sqrt_inv_cov = torch.zeros(15, 15, dtype=dtype, device=dev)
    return PreintDelta(t, q, p, v, cov, sqrt_inv_cov, *J)


def cholesky_or_nan(A):
    """Lower Cholesky factor, NaN where A is not positive definite (as
    jnp.linalg.cholesky). `cholesky_ex` leaves the check on the device, so
    the call never waits for it."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L, torch.full_like(L, torch.nan))


def sqrt_inv_covariance(cov):
    """Whitener S = L^-1 D^-1 with S^T S = cov^-1, from the Cholesky of
    the correlation matrix (float32-safe; S is not triangular)."""
    dtype, dev = cov.dtype, cov.device
    eps = 1e-12 if dtype == torch.float64 else 1e-6
    d = torch.sqrt(torch.clamp(torch.diagonal(cov, dim1=-2, dim2=-1), min=1e-30))
    C = cov / (d[..., :, None] * d[..., None, :])
    eye = torch.eye(15, dtype=dtype, device=dev)
    C = 0.5 * (C + C.transpose(-1, -2)) + eps * eye
    L = cholesky_or_nan(C)
    Linv = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    return Linv / d[..., None, :]


def predict(delta: PreintDelta, q, p, v, bg, ba):
    """Constant-bias forward propagation with gravity. Returns
    (q', p', v', bg, ba)."""
    g = gravity(p.dtype, p.device)
    v_new = v + g * delta.t + lie.quat_rotate(q, delta.v)
    p_new = p + 0.5 * g * delta.t ** 2 + v * delta.t + lie.quat_rotate(q, delta.p)
    q_new = lie.quat_mul(q, delta.q)
    return q_new, p_new, v_new, bg, ba

"""Sliding-window state: fixed-capacity, masked, structure-of-arrays.

Matches `pvio_tpu/map/window.py`: `Extrinsics`, `MargPrior`,
`WindowState` (with a batched `PreintDelta`), `empty_delta`, `empty_prior`,
`empty_window`, the `TF_*` flags, `retract`, `retract_planes`,
`landmark_points`, `frame_states_flat`, `triangulate_tracks`,
`triangulate_tracks_virtual` and `track_baselines` (`window.py:176-309`).

`window_from_numpy` / `extrinsics_from_numpy` carry state across from the
reference: they take dicts of numpy arrays (for example
`{f: np.asarray(getattr(w_jax, f)) ...}`, the nested `delta` and `prior`
included) and build the port's tuples on a given device and dtype.
"""

from typing import NamedTuple

import numpy as np
import torch

from pvio_torch.geometry import lie, triangulation
from pvio_torch.imu.preintegration import PreintDelta

ES_SIZE = 15

TF_VALID = 1       # has a triangulated depth
TF_PLANE = 2       # associated with a plane

_INT_FIELDS = ("ref_frame", "track_flags", "plane_id")
_BOOL_FIELDS = ("frame_mask", "fix_mask", "delta_valid", "track_mask",
                "obs_mask", "plane_mask", "valid")


class Extrinsics(NamedTuple):
    """Body <-> sensor transforms: x_center = q_cs * x_sensor + p_cs."""

    q_bc: torch.Tensor  # (4,) camera-to-body rotation
    p_bc: torch.Tensor  # (3,)
    q_bi: torch.Tensor  # (4,) imu-to-body rotation
    p_bi: torch.Tensor  # (3,)

    @staticmethod
    def identity(dtype=torch.float32, device="cpu"):
        q = torch.tensor([1.0, 0, 0, 0], dtype=dtype, device=device)
        z = torch.zeros(3, dtype=dtype, device=device)
        return Extrinsics(q, z, q.clone(), z.clone())


class MargPrior(NamedTuple):
    """Marginalization prior over all frame slots (F*15 rows)."""

    sqrt_info: torch.Tensor  # (F*15, F*15)
    infovec: torch.Tensor    # (F*15,)
    q0: torch.Tensor         # (F, 4)
    p0: torch.Tensor         # (F, 3)
    v0: torch.Tensor
    bg0: torch.Tensor
    ba0: torch.Tensor
    valid: torch.Tensor      # () bool


class WindowState(NamedTuple):
    q: torch.Tensor           # (F, 4)
    p: torch.Tensor           # (F, 3)
    v: torch.Tensor           # (F, 3)
    bg: torch.Tensor          # (F, 3)
    ba: torch.Tensor          # (F, 3)
    frame_mask: torch.Tensor  # (F,) bool
    fix_mask: torch.Tensor    # (F,) bool
    delta: PreintDelta        # batched over F; delta[j] spans j-1 -> j
    delta_valid: torch.Tensor  # (F,) bool
    bg_lin: torch.Tensor      # (F, 3)
    ba_lin: torch.Tensor      # (F, 3)
    inv_depth: torch.Tensor   # (T,)
    ref_frame: torch.Tensor   # (T,) int64 first observing slot
    track_mask: torch.Tensor  # (T,) bool
    track_flags: torch.Tensor  # (T,) int64 bitmask (TF_*)
    quality: torch.Tensor     # (T,)
    plane_id: torch.Tensor    # (T,) int64, -1 = none
    kp: torch.Tensor          # (F, T, 2) K-normalized keypoints
    obs_mask: torch.Tensor    # (F, T) bool
    plane_normal: torch.Tensor    # (P, 3)
    plane_distance: torch.Tensor  # (P,)
    plane_mask: torch.Tensor      # (P,) bool
    prior: MargPrior


def _unit_q(F, dtype, device):
    q = torch.zeros(F, 4, dtype=dtype, device=device)
    q[:, 0] = 1.0
    return q


def empty_delta(F, dtype=torch.float32, device="cpu"):
    def z(*s):
        return torch.zeros(*s, dtype=dtype, device=device)

    return PreintDelta(t=z(F), q=_unit_q(F, dtype, device), p=z(F, 3), v=z(F, 3),
                       cov=z(F, 15, 15), sqrt_inv_cov=z(F, 15, 15),
                       dq_dbg=z(F, 3, 3), dp_dbg=z(F, 3, 3), dp_dba=z(F, 3, 3),
                       dv_dbg=z(F, 3, 3), dv_dba=z(F, 3, 3))


def empty_prior(F, dtype=torch.float32, device="cpu"):
    def z(*s):
        return torch.zeros(*s, dtype=dtype, device=device)

    return MargPrior(sqrt_info=z(F * ES_SIZE, F * ES_SIZE), infovec=z(F * ES_SIZE),
                     q0=_unit_q(F, dtype, device), p0=z(F, 3), v0=z(F, 3),
                     bg0=z(F, 3), ba0=z(F, 3),
                     valid=torch.tensor(False, device=device))


def empty_window(F, T, P, dtype=torch.float32, device="cpu"):
    def z(*s):
        return torch.zeros(*s, dtype=dtype, device=device)

    def zb(*s):
        return torch.zeros(*s, dtype=torch.bool, device=device)

    def zi(*s):
        return torch.zeros(*s, dtype=torch.int64, device=device)

    normal = z(P, 3)
    normal[:, 2] = 1.0
    return WindowState(
        q=_unit_q(F, dtype, device), p=z(F, 3), v=z(F, 3), bg=z(F, 3), ba=z(F, 3),
        frame_mask=zb(F), fix_mask=zb(F), delta=empty_delta(F, dtype, device),
        delta_valid=zb(F), bg_lin=z(F, 3), ba_lin=z(F, 3),
        inv_depth=torch.ones(T, dtype=dtype, device=device), ref_frame=zi(T),
        track_mask=zb(T), track_flags=zi(T), quality=z(T), plane_id=zi(T) - 1,
        kp=z(F, T, 2), obs_mask=zb(F, T), plane_normal=normal, plane_distance=z(P),
        plane_mask=zb(P), prior=empty_prior(F, dtype, device))


def _tensor(name, value, dtype, device):
    a = np.asarray(value)
    if name in _BOOL_FIELDS:
        return torch.as_tensor(a.astype(bool), device=device)
    if name in _INT_FIELDS:
        return torch.as_tensor(a.astype(np.int64), device=device)
    return torch.as_tensor(np.array(a, np.float64), dtype=dtype, device=device)


def extrinsics_from_numpy(d, dtype=torch.float32, device="cpu"):
    """Extrinsics from a dict (or any mapping) of numpy arrays."""
    return Extrinsics(*(_tensor(f, d[f], dtype, device) for f in Extrinsics._fields))


def window_from_numpy(d, dtype=torch.float32, device="cpu"):
    """WindowState from a dict of numpy arrays keyed by field name; `delta`
    and `prior` are nested dicts (or NamedTuples) of their own fields."""
    def sub(cls, val):
        get = (lambda f: getattr(val, f)) if hasattr(val, "_fields") else val.__getitem__
        return cls(*(_tensor(f, get(f), dtype, device) for f in cls._fields))

    out = {}
    for f in WindowState._fields:
        if f == "delta":
            out[f] = sub(PreintDelta, d[f])
        elif f == "prior":
            out[f] = sub(MargPrior, d[f])
        else:
            out[f] = _tensor(f, d[f], dtype, device)
    return WindowState(**out)


def retract(w: WindowState, d_frames, d_depth):
    """Apply a tangent step: d_frames (F, 15) ordered (theta, p, v, bg, ba),
    d_depth (T,). Quaternion update q <- normalize(q * expmap(theta))."""
    q = lie.quat_normalize(lie.quat_mul(w.q, lie.expmap(d_frames[:, 0:3])))
    return w._replace(q=q, p=w.p + d_frames[:, 3:6], v=w.v + d_frames[:, 6:9],
                      bg=w.bg + d_frames[:, 9:12], ba=w.ba + d_frames[:, 12:15],
                      inv_depth=w.inv_depth + d_depth)


def retract_planes(w: WindowState, d_planes):
    """Apply a plane tangent step d_planes (P, 3): 2 dof on the normal's S^2
    tangent basis, then the distance."""
    Tg = lie.s2_tangential_basis(w.plane_normal)                # (P, 3, 2)
    n = w.plane_normal + lie.mv(Tg, d_planes[:, :2])
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)
    return w._replace(plane_normal=n, plane_distance=w.plane_distance + d_planes[:, 2])


def landmark_points(w: WindowState, extr: Extrinsics):
    """World-space landmark of every track (T, 3): the reference frame's
    bearing [z_ref, 1] / inv_depth through body-camera extrinsics and the
    reference pose. Invalid tracks give garbage; mask with track_mask."""
    T = w.inv_depth.shape[0]
    z_ref = w.kp[w.ref_frame, torch.arange(T, device=w.kp.device)]     # (T, 2)
    inv_d = torch.where(torch.abs(w.inv_depth) < 1e-12,
                        torch.full_like(w.inv_depth, 1e-12), w.inv_depth)
    y = torch.cat([z_ref, torch.ones_like(z_ref[:, :1])], dim=-1) / inv_d[:, None]
    y_body = lie.quat_rotate(extr.q_bc[None], y) + extr.p_bc[None]
    return lie.quat_rotate(w.q[w.ref_frame], y_body) + w.p[w.ref_frame]


def frame_states_flat(w: WindowState):
    """(F, 16) stacked [q, p, v, bg, ba]."""
    return torch.cat([w.q, w.p, w.v, w.bg, w.ba], dim=-1)


def _camera_poses(q, p, extr: Extrinsics):
    """World <- camera rotations and centres of body poses q (F, 4), p (F, 3)."""
    q_ws = lie.quat_mul(q, extr.q_bc.expand_as(q))
    return q_ws, p + lie.quat_rotate(q, extr.p_bc.expand_as(p))


def _triangulate(q_ws, p_ws, kp, obs, ref_frame):
    """Multi-view DLT of every track column (kp (F', T, 2), obs (F', T)) from
    camera poses (F', ...); the depth is taken in the camera of ref_frame.
    Returns (pts (T, 3), inv_d (T,), ok (T,))."""
    R_sw = lie.quat_to_mat(lie.quat_conj(q_ws))
    t_sw = -lie.mv(R_sw, p_ws)
    Ps = torch.cat([R_sw, t_sw[..., None]], dim=-1)               # (F', 3, 4)
    pts, ok, _ = triangulation.triangulate_scored(
        Ps[None], kp.transpose(0, 1), obs.transpose(0, 1))        # batched over T
    ok = ok & (torch.sum(obs, dim=0) >= 2)
    y = lie.quat_rotate(lie.quat_conj(q_ws[ref_frame]), pts - p_ws[ref_frame])
    z = y[..., 2]
    ok = ok & (z > 1e-3) & (z < triangulation.MAX_DEPTH)
    inv_d = 1.0 / torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    return pts, inv_d, ok


def triangulate_tracks(w: WindowState, extr: Extrinsics):
    """Multi-view DLT of every track column from the current window poses.
    Returns (pts (T, 3) world points, inv_d (T,) in the reference frame,
    ok (T,) cheirality/depth gate). Invalid columns' points depend on
    `eigh`'s arbitrary sign; compare them by their flag only."""
    q_ws, p_ws = _camera_poses(w.q, w.p, extr)
    return _triangulate(q_ws, p_ws, w.kp, w.obs_mask & w.frame_mask[:, None], w.ref_frame)


def triangulate_tracks_virtual(w: WindowState, extr: Extrinsics,
                               q_new, p_new, z_new, m_new):
    """Multi-view DLT of every track column with one virtual extra view
    (body pose q_new/p_new, normalized observations z_new (T, 2) masked by
    m_new). Returns (inv_d (T,) in the reference frame, ok (T,))."""
    q_all = torch.cat([w.q, q_new[None]], dim=0)
    p_all = torch.cat([w.p, p_new[None]], dim=0)
    q_ws, p_ws = _camera_poses(q_all, p_all, extr)
    obs = torch.cat([w.obs_mask & w.frame_mask[:, None], m_new[None]], dim=0)
    kp = torch.cat([w.kp, z_new[None]], dim=0)                    # (F+1, T, 2)
    _, inv_d, ok = _triangulate(q_ws, p_ws, kp, obs, w.ref_frame)
    return inv_d, ok


def track_baselines(w: WindowState):
    """Per-track baseline (T,): the summed distances between the body
    positions of consecutive observing slots (slot order is time order)."""
    F, T = w.obs_mask.shape
    obs = w.obs_mask & w.frame_mask[:, None]
    slots = torch.arange(F, device=obs.device)[:, None].expand(F, T)
    idx = torch.where(obs, slots, torch.full_like(slots, -1))
    prev_incl = torch.cummax(idx, dim=0).values                  # (F, T)
    prev = torch.cat([torch.full_like(prev_incl[:1], -1), prev_incl[:-1]], dim=0)
    seg = obs & (prev >= 0)
    d = torch.linalg.norm(w.p[:, None, :] - w.p[torch.clamp(prev, 0, F - 1)], dim=-1)
    return torch.sum(torch.where(seg, d, torch.zeros_like(d)), dim=0)

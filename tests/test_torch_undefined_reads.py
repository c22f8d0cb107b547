"""The audit of `ROADMAP.md` §3: no host decision of the port reads a value
that a failed gate leaves undefined.

The port's undefined values are the eigensolver's picks in its DLT
triangulations (`geometry/triangulation.py::triangulate_homogeneous`). A
track seen from one window slot has a rank-2 4x4 normal matrix. Its
smallest eigenvector may then be any unit vector of a 2-d null space:
any point of the track's ray, the camera centre, or the ray's point at
infinity. Every eigenvector's sign is the solver's choice too. On the CPU
the pick is LAPACK's and on the card kernel E1's, so a decision that read
it would part card from CPU by a jump, not by rounding (F6 was one:
`update_parameters`' extents, pinned by `tests/test_torch_planes.py::
test_update_parameters_extent_skips_undefined_points`).

Each test runs one decision twice, under `null_pick`'s two eigensolvers
(`PICKS`: two other unit vectors of every 2-d null space, and opposite
signs). It checks that the undefined value moved and that the decision
did not. The plane stages read no triangulation of their own: they read
the stored depths of flagged tracks. Their test moves the stored depth of
every column without a flag (the initial 1.0 of a column never
triangulated, or the last depth of a track a gate dropped) and holds
their decisions still. Small windows: the plane scene of
`tests/test_torch_planes.py` and the slice scene of
`tests/test_torch_slice.py`, on the CPU at float64.
"""

import copy
import math

import numpy as np
import pytest
import torch

from tests.test_torch_planes import detected, host_windows, kernels, plane_config
from tests.test_torch_slice import _configs

from pvio_torch.core.initializer import Initializer
from pvio_torch.core.kernels import DeviceKernels
from pvio_torch.core.swt import SlidingWindowTracker
from pvio_torch.estimation import ba as ba_mod
from pvio_torch.geometry import triangulation
from pvio_torch.io import synthetic
from pvio_torch.map import window as win
from pvio_torch.map.window import TF_PLANE, TF_VALID
from pvio_torch.ops import eigh as eigh_op

torch.set_num_threads(2)

# (angle in the null space's plane, sign of every eigenvector)
PICKS = [(0.3, 1.0), (1.2, -1.0)]
# a column's undefined point must move at least this far between the picks (m)
MOVED_M = 0.1


def null_pick(angle, sign):
    """An eigensolver that returns, for every matrix whose two smallest
    eigenvalues vanish (a DLT with a 2-d null space), the unit vector at
    `angle` from the first eigenvector in the plane of the first two as
    its first eigenvector, and every eigenvector times `sign`: both are
    choices an eigensolver may make."""
    def eigh(A):
        L, V = torch.linalg.eigh(A)
        null2 = L[..., 1] <= 1e-9 * L[..., -1].abs()
        v = math.cos(angle) * V[..., :, 0] + math.sin(angle) * V[..., :, 1]
        V = torch.cat([torch.where(null2[..., None], v, V[..., :, 0])[..., None], V[..., 1:]],
                      dim=-1)
        return L, sign * V
    return eigh


def under_picks(fn, monkeypatch):
    """fn() once under each of PICKS."""
    out = []
    for angle, sign in PICKS:
        monkeypatch.setattr(eigh_op, "eigh", null_pick(angle, sign))
        out.append(fn())
    return out


def one_slot(hw, cols):
    """Leave each column seen from its reference slot only."""
    keep = np.zeros_like(hw.obs_mask)
    keep[hw.ref_frame[cols], cols] = True
    hw.obs_mask[:, cols] &= keep[:, cols]


def assert_same_fields(a, b, names):
    for name in names:
        np.testing.assert_array_equal(np.asarray(getattr(a, name)), np.asarray(getattr(b, name)),
                                      err_msg=name)


def test_plane_track_escape_reads_no_undefined_point(monkeypatch):
    """`ba.plane_track_escape` (the keyframe step's escape): five plane
    members seen from one slot each. Their fresh points, and the offsets
    from the plane that the escape's gate would read, move between the
    picks; the escape's flags, depths and plane ids stay the same."""
    _, hw, _, _ = detected()
    kern = kernels()[0]
    hw.track_life = hw.track_life + 15
    kp = hw.kp + np.random.default_rng(3).normal(size=hw.kp.shape) * (1.0 / 200.0)
    hw.kp = kp
    s = int(np.nonzero(hw.plane_mask)[0][0])
    members = np.nonzero((hw.plane_id == s) & hw.track_mask)[0]
    cols = members[[1, 5, 9, 13, 17]]
    one_slot(hw, cols)

    def run():
        w = hw.to_device()
        pts, _, ok = win.triangulate_tracks(w, kern.extr)
        w2 = kern._escape(w, torch.as_tensor(hw.track_life))
        signed = (pts[cols] @ w.plane_normal[s] - w.plane_distance[s]).numpy()
        return pts.numpy()[cols], ok.numpy(), signed, w2

    (pa, oka, meda, wa), (pb, okb, medb, wb) = under_picks(run, monkeypatch)
    assert not oka[cols].any() and not okb[cols].any()
    assert np.linalg.norm(pa - pb, axis=-1).min() > MOVED_M
    assert np.abs(meda - medb).min() > MOVED_M
    assert_same_fields(wa, wb, ("track_flags", "inv_depth", "plane_id"))


def test_fresh_track_adoption_reads_no_undefined_depth(monkeypatch):
    """`pnp_step`'s virtual-view triangulation (`window.
    triangulate_tracks_virtual`) as `SlidingWindowTracker.
    _apply_triangulation` adopts it: twenty unflagged tracks seen from
    window slots and the new frame, and ten seen by the new frame only.
    The ten's depths move between the picks; the adopted depths and flags
    stay the same."""
    hw = host_windows()[0]
    kern = kernels()[0]
    tail = int(np.nonzero(hw.frame_mask)[0][-1])
    seen = np.nonzero(hw.track_mask & hw.obs_mask[tail] & hw.obs_mask[:tail].any(axis=0))[0]
    fresh, alone = seen[:20], seen[20:30]
    z_new = torch.as_tensor(hw.kp[tail])
    m_new = torch.as_tensor(hw.obs_mask[tail] & hw.track_mask)
    q_new, p_new = torch.as_tensor(hw.q[tail]), torch.as_tensor(hw.p[tail])
    hw.frame_mask[tail] = False
    hw.obs_mask[tail] = False
    hw.obs_mask[:, alone] = False
    hw.track_flags[np.concatenate([fresh, alone])] = 0

    def run():
        inv_d, ok = win.triangulate_tracks_virtual(hw.to_device(), kern.extr, q_new, p_new,
                                                   z_new, m_new)
        swt = SlidingWindowTracker.__new__(SlidingWindowTracker)
        swt.hw = copy.deepcopy(hw)
        swt._apply_triangulation(inv_d.numpy(), ok.numpy(), swt.hw.track_id.copy(),
                                 swt.hw.frame_id[swt.hw.ref_frame].copy())
        return inv_d.numpy(), ok.numpy(), swt.hw

    (da, oka, ha), (db, okb, hb) = under_picks(run, monkeypatch)
    assert not oka[alone].any() and not okb[alone].any()
    assert np.abs(1.0 / da[alone] - 1.0 / db[alone]).min() > MOVED_M
    assert (ha.track_flags[fresh] & TF_VALID).sum() >= 15
    assert_same_fields(ha, hb, ("track_flags", "inv_depth"))


def test_initializer_triangulation_reads_no_undefined_depth(monkeypatch):
    """`Initializer._triangulate_all`: ten tracks seen from one slot, whose
    DLT depths move between the picks; the depths and flags it writes stay
    the same."""
    hw = host_windows()[0]
    kern = kernels()[0]
    cols = np.nonzero(hw.track_mask)[0][::7][:10]
    one_slot(hw, cols)
    init = Initializer(plane_config(), kern)

    def run():
        inv_d, ok = kern.triangulate_tracks(hw.to_device())
        h = copy.deepcopy(hw)
        n = init._triangulate_all(h)
        return inv_d.numpy(), ok.numpy(), n, h

    (da, oka, na, ha), (db, okb, nb, hb) = under_picks(run, monkeypatch)
    assert not oka[cols].any() and not okb[cols].any()
    assert np.abs(1.0 / da[cols] - 1.0 / db[cols]).min() > MOVED_M
    assert na == nb >= 100
    assert_same_fields(ha, hb, ("track_flags", "inv_depth"))


def test_two_view_selection_reads_no_eigenvector_sign(monkeypatch):
    """The initializer's two-view DLT (`triangulate_two_view`, on
    `torch.linalg.eigh` at every device): its normal matrices have rank 3,
    so only the sign of the homogeneous point is the solver's. With every
    sign flipped the points of failed matches flip, and the selected
    hypothesis, its status, its count and its valid points stay the same."""
    rng = np.random.default_rng(11)
    X = np.concatenate([rng.uniform(-2, 2, (40, 2)), rng.uniform(3, 8, (40, 1))], axis=1)
    X[::9, 2] *= -1.0                    # some points behind both cameras
    R = synthetic._np_quat_to_mat(np.array([0.995, 0.05, -0.08, 0.03]) / np.linalg.norm(
        [0.995, 0.05, -0.08, 0.03]))
    t = np.array([0.4, -0.1, 0.05])
    x1 = X[:, :2] / X[:, 2:]
    X2 = X @ R.T + t
    x2 = X2[:, :2] / X2[:, 2:]
    R2 = R @ synthetic._np_quat_to_mat(np.array([0.0, 0.0, 0.0, 1.0]))
    Rs = torch.as_tensor(np.stack([R, R, R2, R2]))
    Ts = torch.as_tensor(np.stack([t, -t, t, -t]))
    x1t, x2t = torch.as_tensor(x1), torch.as_tensor(x2)
    real = torch.linalg.eigh
    runs = []
    for sign in (1.0, -1.0):
        monkeypatch.setattr(torch.linalg, "eigh", lambda A, s=sign: (lambda L, V: (L, s * V))(
            *real(A)))
        runs.append(triangulation.select_rt_hypothesis(Rs, Ts, x1t, x2t, count_threshold=10))
    (ba_, pa, sa_, ca), (bb, pb, sb, cb) = runs
    assert int(ba_) == int(bb) == 0 and int(ca) == int(cb) >= 30
    assert torch.equal(sa_, sb) and not bool(sa_.all())
    assert torch.equal(pa[sa_], pb[sa_])
    assert torch.allclose(pa[~sa_], -pb[~sa_], rtol=0, atol=1e-12)


def _slice_window():
    """The slice scene's plane-flagged window through the port's own copy of
    the generator, the new frame's observations and IMU span, and the
    engine (`tests/test_torch_slice.py::test_pnp_step_matches_reference`'s
    inputs)."""
    _, cfg = _configs()
    kern = DeviceKernels(cfg, device="cpu")
    scene = synthetic.make_scene(duration=2.0, n_points=200, n_plane_points=80, seed=648)
    kf = [0, 4, 8, 12, 16, 20]
    w, _, info = synthetic.solver_window_from_scene(
        scene, kf, F_cap=cfg.window_frame_capacity, T_cap=cfg.track_capacity,
        dtype=torch.float64, kp_noise=0.002)
    w, _ = synthetic.flag_plane_tracks(w, scene, info)
    new = kf[-1] + 2
    sel = (scene.imu_t >= scene.frame_t[kf[-1]]) & (scene.imu_t < scene.frame_t[new])
    imu = kern.pad_imu_host(scene.imu_t[sel], scene.gyro[sel], scene.accel[sel])
    kp, vis = synthetic.project_points(scene, np.array([new]), kp_noise=0.002, seed=5)
    chosen = np.asarray(info["chosen"])
    T = cfg.track_capacity
    z = np.zeros((T, 2))
    obs = np.zeros(T, bool)
    z[:len(chosen)] = kp[0, chosen]
    obs[:len(chosen)] = vis[0, chosen]
    return kern, w, imu, float(scene.frame_t[new]), len(kf) - 1, z, obs


def test_motion_step_reads_no_undefined_value(monkeypatch):
    """`pnp_step` (the motion-only PnP, the virtual-view triangulation and
    the p80 parallax statistic): eight tracks unflagged and seen from one
    slot, not by the new frame. Between the two runs their stored depths,
    their observations' slots of the new frame and the picks all move;
    the pose, the keyframe statistic, the triangulation flags and every
    depth that passed its gate stay the same."""
    kern, w, imu, t_new, tail, z, obs = _slice_window()
    flags = w.track_flags.numpy().copy()
    valid = ((flags & (TF_VALID | TF_PLANE)) != 0) & w.track_mask.numpy()
    cols = np.nonzero(valid & obs & (w.plane_id.numpy() < 0))[0][:8]
    flags[cols] = 0
    obs_m = w.obs_mask.numpy().copy()
    keep = np.zeros_like(obs_m)
    keep[w.ref_frame.numpy()[cols], cols] = True
    obs_m[:, cols] &= keep[:, cols]
    obs_new = obs.copy()
    obs_new[cols] = False
    pnp_mask = obs & ((flags & (TF_VALID | TF_PLANE)) != 0)
    outs = []
    for k, (angle, sign) in enumerate(PICKS):
        monkeypatch.setattr(eigh_op, "eigh", null_pick(angle, sign))
        inv = w.inv_depth.clone()
        inv[cols] = 0.05 if k == 0 else 3.0
        zk = z.copy()
        zk[cols] = 0.2 * (k + 1)
        wk = w._replace(track_flags=torch.as_tensor(flags), obs_mask=torch.as_tensor(obs_m),
                        inv_depth=inv)
        outs.append([o.numpy() for o in kern.pnp_step(wk, *imu, t_new, tail, zk, pnp_mask,
                                                      obs_new, 2)])
    a, b = outs
    names = ("q1", "p1", "v1", "bg1", "ba1", "delta_q", "inv_d", "tri_ok", "p80", "n_common")
    ra, rb = dict(zip(names, a)), dict(zip(names, b))
    assert not ra["tri_ok"][cols].any()
    assert np.abs(1.0 / ra["inv_d"][cols] - 1.0 / rb["inv_d"][cols]).min() > MOVED_M
    for n in ("q1", "p1", "v1", "bg1", "ba1", "delta_q", "tri_ok", "p80", "n_common"):
        np.testing.assert_array_equal(ra[n], rb[n], err_msg=n)
    ok = ra["tri_ok"]
    assert ok.sum() >= 40
    np.testing.assert_array_equal(ra["inv_d"][ok], rb["inv_d"][ok])


def _stage(name, pe, hw):
    """Run one plane stage (or the post-solve update) on copies; returns
    what it decides."""
    pe, hw = copy.copy(pe), copy.deepcopy(hw)
    pe.areas = dict(pe.areas)
    if name == "post_solve":
        kern = kernels()[0]
        w = ba_mod.post_solve_update(hw.to_device(), kern.extr, kern.K)
        return {f: getattr(w, f).numpy() for f in ("track_flags", "quality")}
    if name == "detect":
        pe.update_map(hw)
    elif name == "issue_promote":
        out = pe.issue_detection(hw)
        pe.store_pending_result(None if out is None else [o.numpy() for o in out])
        pe.promote_pending(hw)
    else:
        getattr(pe, name)(hw)
    out = {f: np.asarray(getattr(hw, f)).copy() for f in
           ("plane_mask", "plane_ids", "plane_id", "track_flags", "inv_depth", "plane_normal",
            "plane_distance")}
    out["areas"] = {s: (a.center, a.basis, a.radii) for s, a in pe.areas.items()}
    return out


@pytest.mark.parametrize("stage", ["detect", "issue_promote", "extend_planes", "merge_planes",
                                   "post_solve"])
def test_plane_stages_read_no_unflagged_depth(stage):
    """The plane stages (`update_map` -> `_promote`, the asynchronous
    `issue_detection` -> `promote_pending` -> `_promote`, `extend_planes`,
    `merge_planes`) and `ba.post_solve_update` read the stored depths of
    flagged tracks only: twenty tracks lose their flags, and the stages
    decide the same whether those tracks' stored depths are 0.05 or 3.0."""
    pe, hw, _, _ = detected()
    if stage in ("detect", "issue_promote"):
        s = int(np.nonzero(hw.plane_mask)[0][0])
        hw.plane_mask[s] = False
        hw.track_flags &= ~TF_PLANE
        hw.plane_id[:] = -1
        pe.areas.clear()
    if stage == "merge_planes":
        s = int(np.nonzero(hw.plane_mask)[0][0])
        members = np.nonzero(hw.plane_id == s)[0]
        dup = 1 if s != 1 else 2
        hw.plane_mask[dup] = True
        hw.plane_normal[dup] = hw.plane_normal[s]
        hw.plane_distance[dup] = hw.plane_distance[s] + 0.02
        hw.plane_id[members[::2]] = dup
        pe.areas[dup] = pe.areas[s]
    if stage == "extend_planes":
        s = int(np.nonzero(hw.plane_mask)[0][0])
        members = np.nonzero((hw.plane_id == s) & ((hw.track_flags & TF_PLANE) != 0))[0]
        hw.track_flags[members[::2]] &= ~TF_PLANE
        hw.plane_id[members[::2]] = -1
    live = hw.track_mask & ((hw.track_flags & (TF_VALID | TF_PLANE)) != 0) & (hw.plane_id < 0)
    cols = np.nonzero(live)[0][::3][:20]
    hw.track_flags[cols] = 0
    runs = []
    for depth in (0.05, 3.0):
        hw.inv_depth[cols] = depth
        runs.append(_stage(stage, pe, hw))
    a, b = runs
    for f in a:
        if f == "inv_depth":
            np.testing.assert_array_equal(np.delete(a[f], cols), np.delete(b[f], cols))
        elif f == "areas":
            assert sorted(a[f]) == sorted(b[f])
            for s in a[f]:
                for x, y in zip(a[f][s], b[f][s]):
                    np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    if stage in ("detect", "issue_promote"):
        assert a["plane_mask"].sum() == 1
    if stage == "merge_planes":
        assert a["plane_mask"].sum() == 1
    if stage == "extend_planes":
        assert ((a["track_flags"][members[::2]] & TF_PLANE) != 0).sum() >= 5

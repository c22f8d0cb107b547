"""Parity of the plane subsystem: `frontend/ransac.find_plane` /
`refine_plane_pca`, `frontend/detect.poisson_disk_filter` and
`core/plane_extractor.PlaneExtractor`, pvio_torch vs pvio_tpu on the CPU at
float64.

The scene and configuration are `tests/test_planes.py`'s (`plane_config`,
`make_scene(duration=3.0, n_points=60, n_plane_points=130, plane_z=4.6,
seed=648)`); the ground-truth window (`make_host_window` there) is built
with the port's numpy copy of the scene generator and handed to both
packages as the same arrays. Each extractor operation runs on copies of
one window through both packages; after each, the plane decisions
(`plane_mask`, `plane_ids`, `plane_id`, `track_flags`, `inv_depth`) are
identical, normals and distances agree within 1e-10, sector areas within
1e-10, and the two key streams hold the same key data. `copy_state` carries
an extractor's state (key, plane ids, sector areas, pending detection) from
the port to the reference, so that both continue from one state.
"""

import copy
import functools
from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_planes import plane_config as ref_plane_config
from tests.test_torch_harness import assert_close, assert_same

from pvio_tpu.core.host_window import HostWindow as RefHostWindow
from pvio_tpu.core.kernels import DeviceKernels as RefKernels
from pvio_tpu.core.plane_extractor import PlaneExtractor as RefExtractor
from pvio_tpu.frontend import detect as ref_detect
from pvio_tpu.frontend import ransac as ref_ransac
from pvio_tpu.map import sector_area as ref_sa
from pvio_torch.core.host_window import HostWindow
from pvio_torch.core.kernels import DeviceKernels
from pvio_torch.core.plane_extractor import PlaneExtractor
from pvio_torch.frontend import detect, ransac
from pvio_torch.io import synthetic
from pvio_torch.io.config import Config
from pvio_torch.map import sector_area as sa
from pvio_torch.map.window import TF_PLANE, TF_VALID
from pvio_torch.utils import threefry, transfer

torch.set_num_threads(2)

KF = [0, 4, 8, 12, 16, 20]
GEOM_TOL = 1e-10


def plane_config(cls=Config):
    """`tests/test_planes.py::plane_config` as a Config of `cls`."""
    ref = ref_plane_config()
    if cls is type(ref):
        return ref
    cfg = cls()
    for f in fields(ref):
        setattr(cfg, f.name, copy.deepcopy(getattr(ref, f.name)))
    return cfg


@functools.lru_cache(maxsize=None)
def scene():
    return synthetic.make_scene(duration=3.0, fps=20.0, imu_rate=200.0, n_points=60,
                                n_plane_points=130, plane_z=4.6, seed=648)


@functools.lru_cache(maxsize=None)
def window_arrays(kf=tuple(KF)):
    """`make_host_window`'s ground-truth fields (numpy) and the scene info."""
    cfg = plane_config()
    sc = scene()
    w, _, info = synthetic.solver_window_from_scene(
        sc, list(kf), F_cap=cfg.window_frame_capacity, T_cap=cfg.track_capacity,
        P_cap=cfg.plane_capacity, dtype=torch.float64)
    d = {name: getattr(w, name).numpy().copy() for name in
         ("q", "p", "v", "frame_mask", "kp", "obs_mask", "track_mask", "inv_depth")}
    d["ref_frame"] = w.ref_frame.numpy().astype(np.int32)
    d["track_flags"] = w.track_flags.numpy().astype(np.int32)
    d["track_life"] = w.obs_mask.numpy().sum(axis=0).astype(np.int32)
    d["frame_t"] = np.zeros(cfg.window_frame_capacity)
    d["frame_t"][: len(kf)] = sc.frame_t[list(kf)]
    d["track_id"] = np.where(d["track_mask"], np.arange(cfg.track_capacity), -1).astype(np.int64)
    return d, info


def host_windows(kf=tuple(KF), **changes):
    """(port HostWindow, reference HostWindow) holding the same fields."""
    cfg = plane_config()
    d, _ = window_arrays(kf)
    out = []
    for cls in (HostWindow, RefHostWindow):
        hw = cls(cfg.window_frame_capacity, cfg.track_capacity, cfg.plane_capacity, np.float64)
        for name, v in d.items():
            setattr(hw, name, v.copy())
        hw.quality[:] = 0.1
        for name, v in changes.items():
            setattr(hw, name, np.array(v))
        out.append(hw)
    return out


@functools.lru_cache(maxsize=None)
def kernels():
    return DeviceKernels(plane_config(), device="cpu"), RefKernels(plane_config(type(ref_plane_config())))


def extractors(**cfg_changes):
    cfg, cfg_ref = plane_config(), plane_config(type(ref_plane_config()))
    for k, v in cfg_changes.items():
        setattr(cfg, k, v)
        setattr(cfg_ref, k, v)
    kern, kern_ref = kernels()
    return PlaneExtractor(cfg, kern), RefExtractor(cfg_ref, kern_ref)


def copy_state(src, dst):
    """Carry a port extractor's state into a reference extractor: the key
    data, the next plane id, the sector areas and a pending detection."""
    dst._key = jnp.asarray(np.asarray(src._key, np.uint32))
    dst.next_plane_id = src.next_plane_id
    dst.areas = {int(s): ref_sa.SectorArea(a.center.copy(), a.basis.copy(), a.radii.copy())
                 for s, a in src.areas.items()}
    dst._pending = copy.deepcopy(src._pending)


def assert_same_planes(pe, hw, pe_ref, hw_ref, what):
    for name in ("plane_mask", "plane_ids", "plane_id", "track_flags", "track_mask",
                 "inv_depth"):
        assert_same(getattr(hw, name), getattr(hw_ref, name), f"{what}: {name}")
    live = hw_ref.plane_mask
    assert_close(hw.plane_normal[live], hw_ref.plane_normal[live], GEOM_TOL, f"{what}: normals")
    assert_close(hw.plane_distance[live], hw_ref.plane_distance[live], GEOM_TOL,
                 f"{what}: distances")
    assert sorted(pe.areas) == sorted(pe_ref.areas), what
    for s in pe_ref.areas:
        a, b = pe.areas[s], pe_ref.areas[s]
        for f in ("center", "basis", "radii"):
            assert_close(getattr(a, f), getattr(b, f), GEOM_TOL, f"{what}: area {s} {f}")
    assert pe.next_plane_id == pe_ref.next_plane_id, what
    np.testing.assert_array_equal(np.asarray(pe._key), np.asarray(pe_ref._key), err_msg=what)


def detected(**cfg_changes):
    """Both packages after update_map on copies of the window (one plane)."""
    pe, pe_ref = extractors(**cfg_changes)
    hw, hw_ref = host_windows()
    pe.update_map(hw)
    pe_ref.update_map(hw_ref)
    assert hw_ref.plane_mask.sum() == 1
    assert_same_planes(pe, hw, pe_ref, hw_ref, "update_map")
    return pe, hw, pe_ref, hw_ref


# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_find_plane_matches_reference(seed):
    """Same key data: the same hypotheses, inlier mask and count; the best
    plane within 1e-12. PCA refinement of the inliers within 1e-12."""
    rng = np.random.default_rng(seed)
    N = 97
    pts = rng.normal(size=(N, 3)) * [2.0, 1.5, 0.01] + [0.3, -0.2, 4.6]
    pts[60:] = rng.normal(size=(N - 60, 3)) * 2.0 + [0.0, 0.0, 3.0]
    mask = rng.uniform(size=N) < 0.9
    key = threefry.split(threefry.PRNGKey(648 + seed))[1]
    n, d, inl, cnt = ransac.find_plane(torch.as_tensor(key.astype(np.int64)),
                                       torch.as_tensor(pts), torch.as_tensor(mask))
    ref = jax.jit(ref_ransac.find_plane)(jnp.asarray(key), jnp.asarray(pts), jnp.asarray(mask))
    assert_same(inl, ref[2], "inliers")
    assert int(cnt) == int(ref[3]) > 40
    assert_close(n, ref[0], 1e-12, "normal")
    assert_close(d, ref[1], 1e-12, "distance")
    rp = ransac.refine_plane_pca(torch.as_tensor(pts), inl)
    rp_ref = jax.jit(ref_ransac.refine_plane_pca)(jnp.asarray(pts), ref[2])
    for a, b, what in zip(rp, rp_ref, ("normal", "distance", "centroid")):
        assert_close(a, b, 1e-12, f"refine_plane_pca {what}")


def test_poisson_disk_filter_matches_reference():
    rng = np.random.default_rng(4)
    xy = rng.uniform(0, 100, size=(200, 2))
    score = np.round(rng.uniform(size=200), 2)         # ties by lower index
    mask = rng.uniform(size=200) < 0.8
    idx, keep = detect.poisson_disk_filter(torch.as_tensor(xy), torch.as_tensor(score),
                                           torch.as_tensor(mask), 9.0, 64)
    idx_ref, keep_ref = jax.jit(ref_detect.poisson_disk_filter, static_argnums=(3, 4))(
        jnp.asarray(xy), jnp.asarray(score), jnp.asarray(mask), 9.0, 64)
    assert_same(keep, keep_ref, "keep")
    assert_same(idx.numpy(), np.asarray(idx_ref).astype(np.int64), "indices")
    assert 0 < int(keep.sum()) < 64


def test_update_map_matches_reference():
    pe, hw, pe_ref, hw_ref = detected()
    flagged = (hw.track_flags & TF_PLANE) != 0
    assert flagged.sum() >= 25
    # a second detection over the remaining tracks: same gate, same key
    pe.update_map(hw)
    pe_ref.update_map(hw_ref)
    assert_same_planes(pe, hw, pe_ref, hw_ref, "second update_map")


@pytest.mark.parametrize("noise_px", [0.0, 2.0])
def test_extend_planes_matches_reference(noise_px):
    """Half the members unflagged, then re-adopted by extend_planes (the
    adoption net of tests/test_planes.py, clean and at 2 px noise)."""
    pe, hw, pe_ref, hw_ref = detected(camera_noise_cov=np.eye(2) * max(noise_px, 0.7) ** 2)
    if noise_px:
        kp = hw.kp + np.random.default_rng(7).normal(size=hw.kp.shape) * (noise_px / 200.0)
        hw.kp, hw_ref.kp = kp.copy(), kp.copy()
    s = int(np.nonzero(hw.plane_mask)[0][0])
    members = np.nonzero((hw.plane_id == s) & ((hw.track_flags & TF_PLANE) != 0))[0]
    for h in (hw, hw_ref):
        h.track_flags[members[::2]] &= ~TF_PLANE
        h.plane_id[members[::2]] = -1
    pe.extend_planes(hw)
    pe_ref.extend_planes(hw_ref)
    assert_same_planes(pe, hw, pe_ref, hw_ref, "extend_planes")
    assert ((hw.track_flags[members[::2]] & TF_PLANE) != 0).sum() >= 5


def test_merge_planes_matches_reference():
    """`test_plane_merge`'s forged duplicate with half the members."""
    pe, hw, pe_ref, hw_ref = detected()
    s = int(np.nonzero(hw.plane_mask)[0][0])
    dup = 1 if s != 1 else 2
    members = np.nonzero(hw.plane_id == s)[0]
    for p, h in ((pe, hw), (pe_ref, hw_ref)):
        h.plane_mask[dup] = True
        h.plane_normal[dup] = h.plane_normal[s] + 0.01
        h.plane_normal[dup] /= np.linalg.norm(h.plane_normal[dup])
        h.plane_distance[dup] = h.plane_distance[s] + 0.02
        h.plane_id[members[::2]] = dup
    copy_state(pe, pe_ref)
    for p, h, area_mod in ((pe, hw, sa), (pe_ref, hw_ref, ref_sa)):
        pts = p._landmarks(h)[members[::2]]
        basis = np.asarray(p.areas[s].basis)
        p.areas[dup] = area_mod.insert(area_mod.SectorArea.empty(pts.mean(axis=0), basis), pts)
    pe.merge_planes(hw)
    pe_ref.merge_planes(hw_ref)
    assert_same_planes(pe, hw, pe_ref, hw_ref, "merge_planes")
    assert hw.plane_mask.sum() == 1 and (hw.plane_id[members] == s).all()


def _fresh(hw, kern):
    w = hw.to_device()
    from pvio_torch.map import window as win

    pts, inv_d, ok = win.triangulate_tracks(w, kern.extr)
    return tuple(a.numpy().copy() for a in (pts, inv_d, ok, win.track_baselines(w)))


@pytest.mark.parametrize("in_solver,with_fresh", [(True, True), (True, False),
                                                  (False, True), (False, False)])
def test_update_parameters_matches_reference(in_solver, with_fresh):
    """Both branches of plane_estimate_in_solver, from the solver's fresh
    triangulations and from the host landmarks. The refit branch needs 50
    mature members (life >= 15), so the window's lives are raised by 15."""
    pe, hw, pe_ref, hw_ref = detected(plane_estimate_in_solver=in_solver)
    rng = np.random.default_rng(3)
    kp = hw.kp + rng.normal(size=hw.kp.shape) * (1.0 / 200.0)   # something to refit
    for h in (hw, hw_ref):
        h.kp = kp.copy()
        h.track_life = h.track_life + 15
    fresh = _fresh(hw, kernels()[0]) if with_fresh else None
    key0 = np.asarray(pe._key).copy()
    pe.update_parameters(hw, fresh=fresh)
    pe_ref.update_parameters(hw_ref, fresh=fresh)
    assert_same_planes(pe, hw, pe_ref, hw_ref, "update_parameters")
    # the refit branch drew a RANSAC key; the in-solve branch did not
    assert np.array_equal(np.asarray(pe._key), key0) == in_solver


def test_async_detection_matches_reference():
    """issue_detection -> (the fetch) -> store_pending_result ->
    promote_pending, against the reference's, and the port's pending
    device outputs packed in one transfer.Fetch with the window."""
    pe, pe_ref = extractors()
    hw, hw_ref = host_windows()
    out = pe.issue_detection(hw)
    out_ref = pe_ref.issue_detection(hw_ref)
    assert out is not None and out_ref is not None
    assert out[0].dtype == torch.bool and out[1].dtype == torch.int64
    fetched = transfer.get(transfer.Fetch((hw.to_device(), out)))[1]
    fetched_ref = jax.device_get(out_ref)
    assert_same(fetched[0], fetched_ref[0], "pending inliers")
    assert int(fetched[1]) == int(fetched_ref[1]) > pe.min_inliers
    pe.store_pending_result(fetched)
    pe_ref.store_pending_result(fetched_ref)
    # a column recycled to another track before the promotion is dropped
    victim = int(np.nonzero(pe._pending["inl"])[0][0])
    for h in (hw, hw_ref):
        h.track_id[victim] = 10_000
    pe.promote_pending(hw)
    pe_ref.promote_pending(hw_ref)
    assert hw.plane_mask.sum() == 1 and not hw.track_flags[victim] & TF_PLANE
    assert pe._pending is None and pe_ref._pending is None
    assert_same_planes(pe, hw, pe_ref, hw_ref, "promote_pending")
    # the carried state continues identically: the next issue draws the
    # same key in both packages
    copy_state(pe, pe_ref)
    assert (pe.issue_detection(hw) is None) == (pe_ref.issue_detection(hw_ref) is None)
    np.testing.assert_array_equal(np.asarray(pe._key), np.asarray(pe_ref._key))


def test_plane_track_points_for_pnp():
    """The port's plane_track_points: plane tracks land on their plane,
    the others keep their landmark (`test_plane_track_points_for_pnp`)."""
    pe, hw, _, _ = detected()
    kern = kernels()[0]
    w = hw.to_device()
    x0 = kern.landmarks(w)
    x1 = pe.plane_track_points(w, x0).numpy()
    is_plane = (hw.track_flags & TF_PLANE) != 0
    s = int(np.nonzero(hw.plane_mask)[0][0])
    d = x1 @ hw.plane_normal[s] - hw.plane_distance[s]
    assert is_plane.sum() >= 25 and np.abs(d[is_plane]).max() < 1e-6
    np.testing.assert_allclose(x1[~is_plane], x0.numpy()[~is_plane])
    assert ((hw.track_flags[is_plane] & TF_VALID) != 0).all()

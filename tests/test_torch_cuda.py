"""Tests of the port that need a CUDA card: the hand-written kernels
against their plain versions, and the keyframe step and the PVIO facade on
the card against the CPU.

They carry the `cuda` marker and skip without a card. The file imports
neither jax nor the reference, so it also runs where JAX is not
installed: `python -m pytest tests/test_torch_cuda.py --noconftest -q`.
"""

import os

import numpy as np
import pytest
import torch

# cuBLAS is deterministic only with a fixed workspace, set before its first
# use in the process (test_kf_step_chained_is_kf_step_on_card runs under
# deterministic algorithms)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

# (H, W, storage offset in floats): chip_smoke.py's shapes, from 1x1 to one
# 24x128 tile, one tile plus a pixel each way, and a contiguous view 4 bytes
# into its storage (TMA cannot load it)
K1_CASES = [(480, 752, 0), (240, 376, 0), (481, 755, 0), (1, 1, 0), (3, 5, 0),
            (7, 130, 0), (24, 128, 0), (25, 129, 0), (1, 752, 0), (480, 752, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,offset", K1_CASES)
def test_shi_tomasi_kernel_matches_plain_on_card(H, W, offset):
    """K1 against its plain version over the full image. Tolerance 1e-6 of
    the response range plus 1e-9: the kernel sums in another order in
    float32. The load stage is TMA exactly for an aligned image whose rows
    are a multiple of 16 B."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from pvio_torch.frontend import detect
    from pvio_torch.ops import stencil

    rng = np.random.default_rng(7)
    flat = torch.as_tensor(rng.uniform(size=H * W + offset), dtype=torch.float32, device="cuda")
    img = flat[offset:].view(H, W)
    plan = stencil.launch_plan(H, W, img.data_ptr())
    assert plan.tma == (offset == 0 and W % 4 == 0)
    assert stencil.kernel_plan(H, W, img.data_ptr()) == plan
    before = stencil.LAUNCHES
    out = stencil.shi_tomasi_response(img)
    torch.cuda.synchronize()
    ref = detect.shi_tomasi_response(img)
    assert stencil.LAUNCHES == before + 1
    err = float((out - ref).abs().max())
    assert err <= 1e-6 * float(ref.abs().max()) + 1e-9, (H, W, offset, err)
    with pytest.raises(ValueError, match="contiguous"):
        stencil.shi_tomasi_response(torch.zeros(8, 6, device="cuda").t())


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,offset", K1_CASES + [(37, 130, 0), (480, 752, 2)])
def test_shi_tomasi_kernel_float64_matches_plain_on_card(H, W, offset):
    """K1 on a float64 image computes in float64 (fault F7's repair): held to
    the plain version at float64 within 1e-13 of the response range plus
    1e-18, where the float32 form parts by ~1e-7 of it. The load stage is
    TMA exactly for an aligned image whose rows are a multiple of 16 B (W
    even)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from pvio_torch.frontend import detect
    from pvio_torch.ops import stencil

    rng = np.random.default_rng(7)
    flat = torch.as_tensor(rng.uniform(size=H * W + offset), dtype=torch.float64, device="cuda")
    img = flat[offset:].view(H, W)
    plan = stencil.launch_plan(H, W, img.data_ptr(), itemsize=8)
    assert plan.tma == (offset % 2 == 0 and W % 2 == 0)
    assert stencil.kernel_plan(H, W, img.data_ptr(), itemsize=8) == plan
    before = stencil.LAUNCHES
    out = stencil.shi_tomasi_response(img)
    torch.cuda.synchronize()
    ref = detect.shi_tomasi_response(img)
    assert stencil.LAUNCHES == before + 1 and out.dtype == torch.float64
    err = float((out - ref).abs().max())
    f32 = float((stencil.shi_tomasi_response(img.float()).double() - ref).abs().max())
    print(f"K1 float64 {H}x{W}+{offset}: max|kernel - plain| {err:.3e} (float32 form {f32:.3e}), "
          f"range {float(ref.abs().max()):.3e}")
    assert err <= 1e-13 * float(ref.abs().max()) + 1e-18, (H, W, offset, err)


# ---------------------------------------------------------------------------
# the keyframe step on the card against the same calls on the CPU (float32,
# the pipeline tests' small configuration, planes on), within the bounds
# chip_smoke.py states for its card-vs-CPU phase


def _small_config():
    from pvio_torch.io.config import Config

    cfg = Config()
    cfg.camera_intrinsic = np.array([200.0, 200.0, 160.0, 120.0])
    cfg.image_size = (320, 240)
    cfg.sliding_window_size = 6
    cfg.window_frame_capacity = 7
    cfg.track_capacity = 96
    cfg.solver_iteration_limit = 8
    cfg.imu_buffer_capacity = 64
    cfg.dtype = "float32"
    cfg.enable_plane_constraint = True
    return cfg


def _keyframe_case():
    """The small window (perturbed as tests/test_ba.py:34 does, with its
    initial prior), its IMU grids, and one keyframe's kf_step arguments:
    every other non-plane track made fresh and re-based off slot 0, the
    new frame 3 mm off the truth, triangulated depths 1% off, the
    adoption mask the host guard of the reference's pipeline."""
    import chip_smoke as cs
    from pvio_torch.estimation import marginalization as marg
    from pvio_torch.geometry import lie
    from pvio_torch.io import synthetic as TS

    cfg = _small_config()
    scene = TS.make_scene(duration=2.0, n_points=200, n_plane_points=80, seed=648)
    kf = [0, 4, 8, 12, 16, 20]
    w, extr, info = TS.solver_window_from_scene(scene, kf, F_cap=7, T_cap=96,
                                                dtype=torch.float32, kp_noise=0.002)
    w, _ = TS.flag_plane_tracks(w, scene, info)
    rng = np.random.default_rng(648)
    F, T = 7, 96
    dq, dp = rng.normal(size=(F, 3)) * 0.005, rng.normal(size=(F, 3)) * 0.01
    dq[0] = dp[0] = 0.0
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    w = w._replace(q=lie.quat_normalize(lie.quat_mul(w.q, lie.expmap(f32(dq)))), p=w.p + f32(dp),
                   inv_depth=w.inv_depth + f32(rng.normal(size=T) * 0.02))
    w = w._replace(prior=marg.make_initial_prior(w))
    wr = marg.rebase_tracks(w, extr, removed_slot=0)
    fresh = ((torch.arange(T) % 2 == 1) & ((w.track_flags & 2) == 0) & w.track_mask
             & (wr.ref_frame != 0))
    w = w._replace(track_flags=torch.where(fresh, w.track_flags & ~1, w.track_flags),
                   ref_frame=torch.where(fresh, wr.ref_frame, w.ref_frame),
                   inv_depth=torch.where(fresh, wr.inv_depth, w.inv_depth))
    new = kf[-1] + 2
    kp, vis = TS.project_points(scene, np.array([new]), kp_noise=0.002, seed=5)
    chosen = np.asarray(info["chosen"])
    nf_kp, nf_obs = np.zeros((T, 2), np.float32), np.zeros(T, bool)
    nf_kp[:len(chosen)], nf_obs[:len(chosen)] = kp[0, chosen], vis[0, chosen]
    nf = tuple(np.asarray(a, np.float32) for a in (scene.q_wb[new], scene.p_wb[new] + 0.003,
                                                   scene.v_wb[new], np.zeros(3), np.zeros(3)))
    grids = cs.imu_grids(scene, kf, F, 64)
    kf_args = (*grids, *cs.imu_grids(scene, kf[1:] + [new], F, 64), *nf, nf_kp, nf_obs,
               w.inv_depth.numpy() * (1.0 + rng.normal(size=T).astype(np.float32) * 0.01))
    life = np.full(T, 20, np.int32)
    obs = (w.obs_mask & w.frame_mask[:, None]).numpy()
    tri_mask_host = (w.track_mask.numpy() & (obs[1:].sum(axis=0) + nf_obs >= 2)
                     & ((w.track_flags.numpy() & 3) == 0) & (w.ref_frame.numpy() != 0))
    tri_ok = rng.uniform(size=T) < 0.9
    assert (tri_mask_host & tri_ok).sum() >= 5
    return cfg, w, grids, kf_args, tri_ok, tri_mask_host, life


def _compare_windows(a, b, what):
    import chip_smoke as cs

    live = (a.frame_mask.cpu() & b.frame_mask.cpu()).numpy()
    dp = float((a.p.cpu() - b.p.cpu()).abs().numpy()[live].max())
    dth = float(cs.rotation_angle(a.q.cpu().numpy(), b.q.cpu().numpy())[live].max())
    agree = float((a.track_flags.cpu() == b.track_flags.cpu()).double().mean())
    print(f"{what}: card vs CPU |dp| {dp:.3e} m, |dtheta| {dth:.3e} rad, flags {agree:.6f}")
    assert dp <= cs.MAX_KF_DP_M and dth <= cs.MAX_KF_DTHETA_RAD, (what, dp, dth)
    assert agree >= cs.MIN_KF_FLAG_AGREEMENT, (what, agree)


def _prior_rel(a, b):
    rel = []
    for p in (a, b):
        S, iv = p.sqrt_info.double().cpu(), p.infovec.double().cpu()
        rel.append((S.T @ S, S.T @ iv))
    return max(float((x - y).abs().max() / y.abs().max()) for x, y in zip(*rel))


def _cast(nt, dtype):
    """A window (nested NamedTuple) with its float fields cast to dtype."""
    return type(nt)(*(_cast(x, dtype) if hasattr(x, "_fields") else
                      (x.to(dtype) if x.is_floating_point() else x) for x in nt))


@pytest.mark.cuda
def test_keyframe_steps_on_card_match_cpu():
    """ba_step and marg_step on the card against the CPU, float32, within
    chip_smoke.py's keyframe bounds; kf_step (do_marg, make_prior) against
    the CPU at float64 to 1e-8, and at float32 checked to lower its cost.
    The test prints how far each device's float32 kf_step lies from the
    CPU's float64 one: on this window that distance is float32's own (the
    CPU alone moved by about a tenth of a millimetre, PERF.md; 1.2e-7 m
    since the BA steps compute in float64), so a float32 card-vs-CPU bound
    would measure float32, not the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke as cs
    from pvio_torch.core.kernels import DeviceKernels

    cfg, w, grids, kf_args, tri_ok, tri_mask_host, life = _keyframe_case()
    kf_mask = tri_mask_host & tri_ok
    out = {}
    for dtype in ("float32", "float64"):
        cfg.dtype = dtype
        for dev in ("cuda", "cpu"):
            k = DeviceKernels(cfg, device=dev)
            wd = cs.to_device(_cast(w, k.dtype), k.device)
            assert k.ba_cfg.fused_preint == (dev == "cuda")
            kf = k.kf_step(wd, *kf_args, kf_mask, life, 5, True, True)
            if dtype == "float32":
                out[dev] = (k.ba_step(wd, *grids, life, False), k.marg_step(wd, *grids))
                cs.check_solve(kf[1], kf[0], f"kf_step float32 on {dev}")
            out[f"kf {dev} {dtype}"] = kf[0]
    (ba_g, mg_g), (ba_c, mg_c) = out["cuda"], out["cpu"]
    _compare_windows(ba_g[0], ba_c[0], "ba_step")
    cs.check_solve(ba_g[1], ba_g[0], "ba_step on the card")
    assert abs(int(ba_g[1]["accepted"]) - int(ba_c[1]["accepted"])) <= cs.MAX_KF_ACCEPTED_DIFF
    _compare_windows(mg_g, mg_c, "marg_step")
    rel = _prior_rel(mg_g.prior, mg_c.prior)
    assert rel <= cs.MAX_KF_PRIOR_REL, rel
    wg, wc = out["kf cuda float64"], out["kf cpu float64"]
    for key in ("kf cuda float32", "kf cpu float32"):
        live = wc.frame_mask.numpy()
        dp = float((out[key].p.cpu().double() - wc.p).abs().numpy()[live].max())
        dth = float(cs.rotation_angle(out[key].q.cpu().numpy(), wc.q.numpy())[live].max())
        print(f"{key} vs kf cpu float64: |dp| {dp:.3e} m, |dtheta| {dth:.3e} rad")
    for f in ("q", "p", "v", "bg", "ba", "inv_depth", "plane_normal", "plane_distance"):
        err = float((getattr(wg, f).cpu() - getattr(wc, f)).abs().max())
        assert err <= 1e-8, ("kf_step float64", f, err)
    assert torch.equal(wg.track_flags.cpu(), wc.track_flags)


@pytest.mark.cuda
def test_kf_step_chained_is_kf_step_on_card():
    """kf_step_chained on device tensors equals kf_step on their host
    copies, every output, under deterministic algorithms."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke as cs
    from pvio_torch.core.kernels import DeviceKernels

    cfg, w, _, kf_args, tri_ok, tri_mask_host, life = _keyframe_case()
    k = DeviceKernels(cfg)
    wd = cs.to_device(w, k.device)
    dev_args = [torch.as_tensor(a, device="cuda") for a in kf_args]
    torch.use_deterministic_algorithms(True)
    try:
        a = k.kf_step_chained(wd, *dev_args, torch.as_tensor(tri_ok, device="cuda"),
                              tri_mask_host, life, 5, False, True)
        b = k.kf_step(wd, *kf_args, tri_mask_host & tri_ok, life, 5, False, True)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    la, lb = cs.leaves(a), cs.leaves(b)
    assert len(la) == len(lb) == 49
    assert all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# the facade on the card against the CPU (float32, the pipeline tests'
# small configuration, planes off, rendered blob frames)

# measured on an H100 (700 W), float32: the initialized pose 1.6e-5 m apart
# and at most 2.8e-5 m until the first host decision differs, after frame
# 25 (the second keyframe step after initialization: 6 observations and 1
# track of the window). From there the trajectories step apart at keyframes,
# 4.2e-3 -> 1.1e-2 -> 2.2e-2 m, ATE 0.118 vs 0.117 m. Since the
# initializer's two-view geometry (fault F4), the marginalization and the BA
# steps (fault F5) compute in float64: no decision differs, at most 3.1e-6
# m over all 30 poses, ATE 0.098291 vs 0.098290 m. float64, the card's
# pipelined depth 2 + chained run against the CPU's sequential one: no
# decision differs, 6.2e-9 m. The bounds keep ~2-16x margin.
MAX_FACADE_INIT_DP_M = 1e-4
MAX_FACADE_DP_M = 5e-2
MAX_FACADE_DATE_M = 1e-2
MAX_FACADE_F64_DP_M = 1e-7

SMALL = dict(camera_intrinsic=np.array([200.0, 200.0, 160.0, 120.0]), image_size=(320, 240),
             sliding_window_size=6, window_frame_capacity=7, track_capacity=96,
             feature_tracker_max_keypoint_detection=60,
             feature_tracker_min_keypoint_distance=12.0, initializer_keyframe_gap=4,
             initializer_min_matches=20, initializer_min_parallax=5.0,
             initializer_min_triangulation=15, initializer_min_landmarks=15,
             keyframe_min_common_tracks=20, keyframe_parallax_px=25.0,
             solver_iteration_limit=8, initializer_max_scale=5.0,
             feature_tracker_detect_min_free=8)


def _blob_stream():
    import chip_smoke as cs
    from pvio_torch.io import synthetic

    cfg = cs.facade_config(**SMALL)
    scene = synthetic.make_scene(duration=2.5, fps=20.0, imu_rate=200.0, n_points=320, seed=648)
    images = [synthetic.render_frame(scene, fi, cfg.K, cfg.image_size).astype(np.float32)
              for fi in range(len(scene.frame_t))]
    torch.set_num_threads(max(1, os.cpu_count() or 1))
    return scene, images


@pytest.mark.cuda
def test_facade_on_card_matches_cpu():
    """pvio_torch.PVIO on the card and on the CPU at float32 over the same
    stream: the same initialization frame and keyframe count; positions
    within MAX_FACADE_INIT_DP_M until the first call after which a host
    decision differs (KLT status, track ids, the window's frames,
    keyframes, tracks, flags or observations), within MAX_FACADE_DP_M
    after it, and ATEs within MAX_FACADE_DATE_M. The init scale gate is
    raised as the golden runs raise it: at the production 1.0 this scene's
    attempts sit near the gate, where float32 rounding can decide the
    initialization frame. test_facade_on_card_float64_matches_cpu is the
    witness that the card's facade path itself adds no gap."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke as cs

    scene, images = _blob_stream()
    card = cs.run_facade(cs.facade_config(**SMALL), scene, images)
    cpu = cs.run_facade(cs.facade_config(**SMALL), scene, images, device="cpu")
    assert card["launches"] == card["n_frames"]
    for rec in (card, cpu):
        assert rec["initialized"] and rec["n_reinits"] == 0
    assert card["init_fi"] == cpu["init_fi"] and card["keyframes"] == cpu["keyframes"]
    assert [t for t, _, _ in card["traj"]] == [t for t, _, _ in cpu["traj"]]
    flip, dp_agreed, dp = cs.facade_gap(card, cpu, scene)
    dps = [float(np.abs(a - b).max()) for (_, _, a), (_, _, b) in zip(card["traj"], cpu["traj"])]
    print(f"facade card vs CPU, float32: init frame {card['init_fi']}, {card['keyframes']} "
          f"keyframes, {len(card['traj'])} poses, first decision flip "
          f"{'none' if flip is None else f'after frame {flip[0]}: {flip[1]}'}, max |dp| before it "
          f"{dp_agreed:.3e} m, over all {dp:.3e} m, per pose {[float(f'{x:.2e}') for x in dps]}, "
          f"ATE card {cs.facade_ate(card['traj'], scene):.6f} m, "
          f"CPU {cs.facade_ate(cpu['traj'], scene):.6f} m")
    assert dp_agreed <= MAX_FACADE_INIT_DP_M, dp_agreed
    assert dp <= (MAX_FACADE_INIT_DP_M if flip is None else MAX_FACADE_DP_M), (flip, dp)
    date = abs(cs.facade_ate(card["traj"], scene) - cs.facade_ate(cpu["traj"], scene))
    assert date <= MAX_FACADE_DATE_M, date


@pytest.mark.cuda
def test_facade_on_card_float64_matches_cpu():
    """The witness of test_facade_on_card_matches_cpu: the same stream at
    float64, detection on every frame. On the card the sequential loop and
    the pipelined loop at depth 2 with fused and chained keyframes (the
    packed uploads, the fetches, the chained hand-off) agree bit for bit
    under deterministic algorithms; against the CPU's sequential loop no
    host decision differs, and positions agree within
    MAX_FACADE_F64_DP_M."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke as cs

    scene, images = _blob_stream()
    common = dict(SMALL, dtype="float64", fused_keyframe=True, feature_tracker_detect_min_free=0)
    torch.use_deterministic_algorithms(True)
    try:
        card = cs.run_facade(cs.facade_config(**common), scene, images)
        pipe = cs.run_facade(cs.facade_config(**common, pipelined_host=True, pipeline_depth=2,
                                              chained_keyframe=True), scene, images)
    finally:
        torch.use_deterministic_algorithms(False)
    cpu = cs.run_facade(cs.facade_config(**common), scene, images, device="cpu")
    assert pipe["depth"] == 2 and card["launches"] == pipe["launches"] == card["n_frames"]
    assert len(card["traj"]) == len(pipe["traj"])
    for (t1, q1, p1), (t2, q2, p2) in zip(card["traj"], pipe["traj"]):
        assert t1 == t2 and np.array_equal(q1, q2) and np.array_equal(p1, p2), t1
    for rec in (card, cpu):
        assert rec["initialized"] and rec["n_reinits"] == 0
    assert card["init_fi"] == cpu["init_fi"] and card["keyframes"] == cpu["keyframes"]
    flip, _, dp = cs.facade_gap(card, cpu, scene)
    print(f"facade card vs CPU, float64: init frame {card['init_fi']}, {card['keyframes']} "
          f"keyframes, {len(card['traj'])} poses, card sequential == pipelined depth 2 + chained, "
          f"first decision flip {'none' if flip is None else f'after frame {flip[0]}: {flip[1]}'}, "
          f"max |dp| {dp:.3e} m")
    assert flip is None and dp <= MAX_FACADE_F64_DP_M, (flip, dp)


# ---------------------------------------------------------------------------
# the facade with planes on: the plane scene of tests/test_planes.py as blob
# frames, its plane_config and the initializer settings of
# test_pipeline_with_planes (tests/test_torch_facade_planes.py's stream)

PLANES = dict(SMALL, track_capacity=128, plane_capacity=4, enable_plane_constraint=True,
              plane_ransac_threshold=0.07, plane_min_inliers=25, plane_min_track_life=4,
              feature_tracker_max_keypoint_detection=120, feature_tracker_detect_min_free=0,
              initializer_max_scale=1.0, fused_keyframe=True)
# float64: frames after PLANES_F64_FRAMES are left out of the witness. Past
# them the runs reach plane adoptions whose gates sit on their edges (one is
# extend_planes' sector-area gate, is_near_boundary): two CPU runs that
# differ only in the BA's preintegration bank, ~1e-10 m apart, take one
# differently after frame 48-52, and so do the card and the CPU.
PLANES_F64_FRAMES = 48
# measured on an H100 (700 W): no decision differs in those frames, and
# positions agree to 1.6e-8 m (planes off, test_facade_on_card_float64_
# matches_cpu: 6.2e-9 m); the bound is that test's
MAX_PLANES_F64_DP_M = MAX_FACADE_F64_DP_M
# float32 with planes on: rounding alone moves positions by millimetres
# before any decision differs. Measured on an H100 (700 W): two CPU runs
# that differ only in the preintegration bank part by 3.5e-3 m before their
# first flip (an adoption after frame 32), the card and the CPU by 5.1e-3 m
# before the same flip and 4.0e-2 m after it.
# The bound before the flip is therefore chip_smoke's float32 facade bound,
# not MAX_FACADE_INIT_DP_M; the test prints the CPU's own bank gap beside it.
MAX_PLANES_F32_INIT_DP_M = 1e-2


def _plane_stream():
    import chip_smoke as cs
    from pvio_torch.io import synthetic

    cfg = cs.facade_config(**PLANES)
    scene = synthetic.make_scene(duration=3.0, fps=20.0, imu_rate=200.0, n_points=60,
                                 n_plane_points=130, plane_z=4.6, seed=648)
    images = [synthetic.render_frame(scene, fi, cfg.K, cfg.image_size)
              for fi in range(len(scene.frame_t))]
    torch.set_num_threads(max(1, os.cpu_count() or 1))
    return scene, images


def _plane_summary(rec):
    pl = rec["planes"]
    return (f"{pl['detected']} planes detected, plane tracks max {max(pl['tracks'])}, "
            f"promoted at keyframe steps {[k for k, _ in pl['promote_pending']]}")


@pytest.mark.cuda
def test_facade_planes_on_card_float64_matches_cpu():
    """Planes on, float64, the first PLANES_F64_FRAMES frames: on the card
    the sequential fused loop and the pipelined loop at depth 2 with chained
    keyframes agree bit for bit under deterministic algorithms; against the
    CPU's sequential loop no host decision differs (plane slots, plane ids
    and the tracks' planes included) and positions agree within
    MAX_PLANES_F64_DP_M. The CPU run takes the card's preintegration bank
    (struct-of-arrays), so that both sides do the same arithmetic."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke as cs

    scene, images = _plane_stream()
    f64, n = dict(PLANES, dtype="float64"), PLANES_F64_FRAMES
    torch.use_deterministic_algorithms(True)
    try:
        card = cs.run_facade(cs.facade_config(**f64), scene, images, n_frames=n)
        pipe = cs.run_facade(cs.facade_config(**f64, pipelined_host=True, pipeline_depth=2,
                                              chained_keyframe=True), scene, images, n_frames=n)
    finally:
        torch.use_deterministic_algorithms(False)
    # the CPU over the whole stream on both banks: the first n frames are
    # compared with the card, the whole stream shows the gate's edge after it
    cpu = cs.run_facade(cs.facade_config(**f64), scene, images, device="cpu", fused_preint=True)
    cpu_vm = cs.run_facade(cs.facade_config(**f64), scene, images, device="cpu",
                           fused_preint=False)
    assert pipe["depth"] == 2 and card["launches"] == pipe["launches"] == card["n_frames"]
    assert len(card["traj"]) == len(pipe["traj"])
    for (t1, q1, p1), (t2, q2, p2) in zip(card["traj"], pipe["traj"]):
        assert t1 == t2 and np.array_equal(q1, q2) and np.array_equal(p1, p2), t1
    for rec in (card, pipe, cpu):
        assert rec["initialized"] and rec["n_reinits"] == 0
        assert rec["planes"]["detected"] >= 1 and max(rec["planes"]["tracks"]) >= 10
    assert len(card["traj"]) == len([t for t, _, _ in cpu["traj"] if t < scene.frame_t[n]])
    flip, _, dp = cs.facade_gap(card, cpu, scene)
    dps = [float(np.abs(a - b).max()) for (_, _, a), (_, _, b) in zip(card["traj"], cpu["traj"])]
    bank_flip, bank_dp_agreed, _ = cs.facade_gap(cpu_vm, cpu, scene)
    print(f"planes-on facade card vs CPU, float64: init frame {card['init_fi']}, "
          f"{card['keyframes']} keyframes, {len(card['traj'])} poses, card sequential == "
          f"pipelined depth 2 + chained; card {_plane_summary(card)}; CPU {_plane_summary(cpu)}; "
          f"first decision flip {'none' if flip is None else f'after frame {flip[0]}: {flip[1]}'}, "
          f"max |dp| {dp:.3e} m over the first {n} frames (per pose "
          f"{[float(f'{x:.2e}') for x in dps]}); the CPU's two preintegration banks "
          f"over all {len(scene.frame_t)} frames: first flip "
          f"{'none' if bank_flip is None else f'after frame {bank_flip[0]}: {bank_flip[1]}'}, "
          f"max |dp| before it {bank_dp_agreed:.3e} m")
    assert flip is None and dp <= MAX_PLANES_F64_DP_M, (flip, dp)


@pytest.mark.cuda
def test_facade_planes_on_card_matches_cpu():
    """Planes on, float32, card against CPU (sequential fused loops, the
    CPU on the card's preintegration bank, as in the float64 witness): the
    same initialization frame; positions within MAX_PLANES_F32_INIT_DP_M
    until the first call after which a host decision differs (named in the
    output), within MAX_FACADE_DP_M after it, and ATEs within
    MAX_FACADE_DATE_M; both detect a plane. Beside it, the gap between the
    CPU's two preintegration banks, the float32 rounding the bound stands
    for."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke as cs

    scene, images = _plane_stream()
    f32 = dict(PLANES, dtype="float32")
    card = cs.run_facade(cs.facade_config(**f32), scene, images)
    cpu = cs.run_facade(cs.facade_config(**f32), scene, images, device="cpu", fused_preint=True)
    cpu_vm = cs.run_facade(cs.facade_config(**f32), scene, images, device="cpu",
                           fused_preint=False)
    assert card["launches"] == card["n_frames"]
    for rec in (card, cpu):
        assert rec["initialized"] and rec["n_reinits"] == 0 and rec["planes"]["detected"] >= 1
    assert card["init_fi"] == cpu["init_fi"]
    flip, dp_agreed, dp = cs.facade_gap(card, cpu, scene)
    bank_flip, bank_dp_agreed, bank_dp = cs.facade_gap(cpu_vm, cpu, scene)
    ate_card, ate_cpu = cs.facade_ate(card["traj"], scene), cs.facade_ate(cpu["traj"], scene)
    print(f"planes-on facade card vs CPU, float32: init frame {card['init_fi']}, "
          f"{card['keyframes']} vs {cpu['keyframes']} keyframes; card {_plane_summary(card)}; "
          f"CPU {_plane_summary(cpu)}; first decision flip "
          f"{'none' if flip is None else f'after frame {flip[0]}: {flip[1]}'}, max |dp| before it "
          f"{dp_agreed:.3e} m, over all {dp:.3e} m, ATE card {ate_card:.6f} m, CPU {ate_cpu:.6f} m; "
          f"the CPU's two preintegration banks: first flip "
          f"{'none' if bank_flip is None else f'after frame {bank_flip[0]}: {bank_flip[1]}'}, "
          f"max |dp| before it {bank_dp_agreed:.3e} m, over all {bank_dp:.3e} m")
    assert dp_agreed <= MAX_PLANES_F32_INIT_DP_M, dp_agreed
    assert dp <= (MAX_PLANES_F32_INIT_DP_M if flip is None else MAX_FACADE_DP_M), (flip, dp)
    assert abs(ate_card - ate_cpu) <= MAX_FACADE_DATE_M


@pytest.mark.cuda
def test_fetch_packs_plane_detection_on_card():
    """The asynchronous plane detection's outputs (a bool inlier mask and a
    0-d int64 count) ride one packed transfer.Fetch with float tensors and
    come back with their dtypes and values, as find_plane returns them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from pvio_torch.frontend import ransac
    from pvio_torch.utils import threefry, transfer

    g = torch.Generator(device="cpu").manual_seed(5)
    pts = (torch.randn(256, 3, generator=g) * torch.tensor([2.0, 1.5, 0.01]) + 4.0).double()
    mask = torch.rand(256, generator=g) < 0.9
    key = torch.as_tensor(threefry.split(threefry.PRNGKey(649))[1].astype(np.int64))
    inl, cnt = ransac.find_plane(key.cuda(), pts.cuda(), mask.cuda())[2:]
    inl_cpu, cnt_cpu = ransac.find_plane(key, pts, mask)[2:]
    w = torch.randn(9, 3, device="cuda")
    (w_h, (inl_h, cnt_h)) = transfer.Fetch((w, (inl, cnt))).result()
    assert inl_h.dtype == np.bool_ and cnt_h.dtype == np.int64 and cnt_h.shape == ()
    np.testing.assert_array_equal(w_h, w.cpu().numpy())
    np.testing.assert_array_equal(inl_h, inl_cpu.numpy())
    assert int(cnt_h) == int(cnt_cpu) > 100


# ---------------------------------------------------------------------------
# K1's batched form, kernel S1 (Poisson-disk selection), the device steps'
# host waits and the vmapped frame step's launches


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W", [(11, 480, 752), (3, 481, 755), (2, 24, 128), (4, 7, 130)])
def test_shi_tomasi_batched_matches_single_launches(B, H, W):
    """One launch for a (B, H, W) stack, directly and through the op's vmap
    rule: each image bit-equal to its own launch, and within K1's tolerance
    of the plain version (1e-6 of the range plus 1e-9)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.func import vmap

    from pvio_torch.frontend import detect
    from pvio_torch.ops import stencil

    imgs = torch.as_tensor(np.random.default_rng(B * H).uniform(size=(B, H, W)),
                           dtype=torch.float32, device="cuda")
    before = stencil.LAUNCHES
    out = stencil.shi_tomasi_response(imgs)
    assert stencil.LAUNCHES == before + 1
    out_v = vmap(stencil.shi_tomasi_response)(imgs)
    assert stencil.LAUNCHES == before + 2
    assert torch.equal(out, out_v)
    for b in range(B):
        single = stencil.shi_tomasi_response(imgs[b].contiguous())
        assert torch.equal(out[b], single), b
        ref = detect.shi_tomasi_response(imgs[b])
        assert float((out[b] - ref).abs().max()) <= 1e-6 * float(ref.abs().max()) + 1e-9


@pytest.mark.cuda
def test_shi_tomasi_batch_seam():
    """A bright last row in image b above a dark first row in image b + 1:
    each image's halo past its own edge is zero (the 3-D tensor map), so
    the stack equals the single launches, where one (B*H, W) image lets
    the rows of its neighbour into the response near the seam."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from pvio_torch.frontend import detect
    from pvio_torch.ops import stencil

    B, H, W = 3, 48, 256
    imgs = torch.full((B, H, W), 0.5, device="cuda")
    imgs[:, H // 2] = 0.8                 # some structure inside each image
    for b in range(B - 1):
        imgs[b, -1] = 1.0                 # bright last row of image b
        imgs[b + 1, 0] = 0.0              # dark first row of image b + 1
    out = stencil.shi_tomasi_response(imgs)
    for b in range(B):
        assert torch.equal(out[b], stencil.shi_tomasi_response(imgs[b].contiguous())), b
        ref = detect.shi_tomasi_response(imgs[b])
        assert float((out[b] - ref).abs().max()) <= 1e-6 * float(ref.abs().max()) + 1e-9
    flat = stencil.shi_tomasi_response(imgs.reshape(B * H, W)).reshape(B, H, W)
    assert not torch.equal(flat[1, :2], out[1, :2])      # the seam matters here


def _selection_case(seed, C, dtype):
    """C candidates, a 0.85-alive mask, and pairs placed min_distance (12)
    apart in random directions, so that the squared distance lands within
    an ulp of d2 and an FMA-contracted dx*dx + dy*dy would flip some."""
    rng = np.random.default_rng(seed)
    cand = rng.uniform(0.0, np.sqrt(C) * 9.0, size=(C, 2))
    theta = rng.uniform(0.0, 2 * np.pi, size=C // 2)
    cand[1::2][:len(theta)] = cand[0::2][:len(theta)] + 12.0 * np.stack(
        [np.cos(theta), np.sin(theta)], axis=-1)
    alive = rng.uniform(size=C) < 0.85
    return torch.as_tensor(cand, dtype=dtype), torch.as_tensor(alive)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("C", [4, 64, 300, 1024])
def test_poisson_select_matches_plain_on_card(C, dtype):
    """S1 equals the plain rounds loop bit for bit, on the card and on the
    CPU, at 12 px and at 12.3 px (d2 rounded to the candidates' type), with
    its round count; a stack of 3 takes one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.func import vmap

    from pvio_torch.ops import poisson

    cases = [_selection_case(C + s, C, dtype) for s in range(3)]
    for min_d in (12.0, 12.3):
        for cand, alive in cases:
            before = poisson.LAUNCHES
            sel = poisson.select_candidates(cand.cuda(), alive.cuda(), min_d)
            rounds = int(poisson.LAST_KERNEL_ROUNDS[0])
            assert poisson.LAUNCHES == before + 1
            plain_card = poisson.select_candidates_plain(cand.cuda(), alive.cuda(), min_d)
            assert torch.equal(sel, plain_card)
            assert rounds == poisson.LAST_ROUNDS
            assert torch.equal(sel.cpu(), poisson.select_candidates_plain(cand, alive, min_d))
        cand_b = torch.stack([c for c, _ in cases]).cuda()
        alive_b = torch.stack([a for _, a in cases]).cuda()
        before = poisson.LAUNCHES
        sel_b = vmap(poisson.select_candidates, in_dims=(0, 0, None))(cand_b, alive_b, min_d)
        assert poisson.LAUNCHES == before + 1
        for b in range(3):
            assert torch.equal(sel_b[b], poisson.select_candidates_plain(
                cand_b[b], alive_b[b], min_d))


def _frames_case(cfg, seeds=(648,)):
    """Two rendered uint8 frames per seed of the small configuration, on
    the card: (len(seeds), 2, H, W)."""
    from pvio_torch.io import synthetic as TS

    out = []
    for s in seeds:
        scene = TS.make_scene(duration=1.0, n_points=200, n_plane_points=80, seed=s)
        out.append([(TS.render_frame(scene, i, cfg.K, cfg.image_size) * 255 + 0.5)
                    .astype(np.uint8) for i in (3, 4)])
    return torch.as_tensor(np.array(out), device="cuda")


@pytest.mark.cuda
def test_device_steps_make_no_host_wait():
    """frame_step, pnp_step and kf_step_chained (do_marg, without and with
    make_prior) on device inputs run under
    torch.cuda.set_sync_debug_mode("error"): no host read, no synchronising
    copy (after one warm-up call of each, which puts the steps' constants
    on the card). The marginalization's two eigen-decompositions (the
    15x15 pseudo-inverse and the (F*15)-square prior) go through kernel
    E2, which reads nothing back; both launch in each keyframe."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke as cs
    from pvio_torch.core.kernels import DeviceKernels
    from pvio_torch.ops import eigh as eigh_op

    cfg, w, _, kf_args, tri_ok, tri_mask_host, life = _keyframe_case()
    k = DeviceKernels(cfg)
    d = lambda a: torch.as_tensor(a, device="cuda")
    wd = cs.to_device(w, k.device)
    imgs = _frames_case(cfg)[0]
    dq = d(np.array([1.0, 0, 0, 0], np.float32))
    key = d(np.array([648, 7], np.int64))
    kf_dev = [d(a) for a in kf_args]
    nf_kp, nf_obs = kf_dev[15], kf_dev[16]
    pnp_imu = k.pad_imu(np.linspace(0.0, 0.05, 11), np.zeros((11, 3)),
                        np.tile([0.0, 0.0, 9.81], (11, 1)))
    t_new, tri_ok_d, tri_mask_d, life_d = (d(np.float32(0.05)), d(tri_ok), d(tri_mask_host),
                                           d(life))

    def frame_and_motion():
        pyr, resp, kp, mask = k.first_frame_step(imgs[0])
        out = k.frame_step(pyr, resp, imgs[1], kp, mask, dq, key)
        return out, k.pnp_step(wd, *pnp_imu, t_new, 5, nf_kp, nf_obs, nf_obs, 0)

    def keyframe(make_prior):
        return k.kf_step_chained(wd, *kf_dev[:15], nf_kp, nf_obs, kf_dev[17], tri_ok_d,
                                 tri_mask_d, life_d, 5, make_prior, True)

    frame_and_motion()
    keyframe(False)
    keyframe(True)
    torch.cuda.synchronize()
    e2 = dict(eigh_op.BLOCK_LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, pnp = frame_and_motion()
        kf = keyframe(False)
        kf_prior = keyframe(True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    F = cfg.window_frame_capacity
    assert {n: eigh_op.BLOCK_LAUNCHES[n] - e2.get(n, 0) for n in (15, F * 15)} == {
        15: 2, F * 15: 2}, dict(eigh_op.BLOCK_LAUNCHES)
    assert cs.finite(out[2], pnp[0], pnp[1], kf[0].p, kf[0].prior.sqrt_info,
                     kf_prior[0].prior.sqrt_info)


@pytest.mark.cuda
def test_transfer_counts_one_wait_per_harvest():
    """`transfer.get` harvests the copies of one stream after ONE host wait
    (on the newest copy), one per stream when copies come from two; a lone
    `result()`, a tensor leaf and `block` wait once each; a harvested
    `Fetch` waits no more. The values are the tensors' (exactly)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from pvio_torch.utils import transfer

    xs = [torch.arange(1000, device="cuda", dtype=torch.float32) * k for k in range(3)]
    fs = [transfer.Fetch((x, x[:3].to(torch.int64))) for x in xs]
    w0 = transfer.WAITS
    vals = transfer.get(fs)
    assert transfer.WAITS == w0 + 1
    for k, (a, b) in enumerate(vals):
        np.testing.assert_array_equal(a, np.arange(1000, dtype=np.float32) * k)
        np.testing.assert_array_equal(b, np.arange(3) * k)
    assert transfer.get(fs[0]) is vals[0] and transfer.WAITS == w0 + 1
    transfer.Fetch(xs[1]).result()
    transfer.get({"x": xs[2]})
    assert transfer.WAITS == w0 + 3
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y = xs[1] + 1.0
        fy = transfer.Fetch(y)
    main_y, side_y = transfer.get([transfer.Fetch(xs[1]), fy])
    np.testing.assert_array_equal(side_y, main_y + 1.0)
    assert transfer.WAITS == w0 + 5
    transfer.block(xs[0])
    assert transfer.WAITS == w0 + 6


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 7, 256, 2816])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sym_eig_matches_eigh_on_card(dtype, B):
    """E1 against torch.linalg.eigh on the card: B DLT normal matrices
    (`chip_smoke.dlt_normals`: a quarter all zero, a quarter poorly
    conditioned; B = 7 leaves a quad of lanes without a matrix, B = 2,816
    is the vmapped chain's 11 x 256), within chip_smoke.py's eig_gap limit
    (1e-5 of the largest eigenvalue at float32, 1e-12 at float64). A call
    is one launch and E1's kernel alone in a profiler trace of 20 calls (no
    cast kernels, and none lost), its outputs in A's dtype; every matrix
    takes the sweeps of its CPU model
    (`eigh_op.jacobi_model`, the kernel's algorithm in float64 PyTorch),
    a zero matrix none; a vmapped stack takes one launch and equals the
    unbatched call bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.func import vmap

    import chip_smoke as cs
    from pvio_torch.ops import eigh as eigh_op

    A = torch.as_tensor(cs.dlt_normals(B), dtype=dtype, device="cuda")
    before = eigh_op.LAUNCHES
    L, V = eigh_op.eigh(A)
    assert eigh_op.LAUNCHES == before + 1
    assert L.dtype == V.dtype == dtype and L.shape == (B, 4) and V.shape == (B, 4, 4)
    sweeps = eigh_op.LAST_SWEEPS.tolist()
    model = [eigh_op.jacobi_model(a)[2] for a in A.double().cpu()]
    assert sweeps == model and max(sweeps) < eigh_op.MAX_SWEEPS, (sweeps, model)
    zero = (A == 0).flatten(1).all(1).tolist()
    assert all(s == 0 for s, z in zip(sweeps, zero) if z)
    gap, lim = cs.eig_gap(A, L, V, torch.linalg.eigh(A)[0])
    assert gap <= lim, (A.shape, gap, lim)
    names = [name for name, _ in cs.trace_kernels(lambda: eigh_op.eigh(A), reps=20, warmup=2)]
    assert len(names) == 20 and all("sym_eig_kernel" in n for n in names), names
    assert eigh_op.LAUNCHES == before + 23
    Lv, Vv = vmap(eigh_op.eigh)(A)
    assert eigh_op.LAUNCHES == before + 24
    assert torch.equal(Lv, L) and torch.equal(Vv, V)


@pytest.mark.cuda
def test_vmapped_frame_step_launches_k1_and_s1_once():
    """torch.func.vmap of first_frame_step and frame_step over B = 3
    sequences launches K1 once and S1 once per frame, and gives each
    sequence what its own unbatched step gives (status agreement >= 0.98,
    tracked keypoints within 1e-3 px: the batched matmuls may round
    differently)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.func import vmap

    from pvio_torch.core.kernels import DeviceKernels
    from pvio_torch.ops import poisson, stencil

    cfg = _small_config()
    k = DeviceKernels(cfg)
    imgs = _frames_case(cfg, seeds=(648, 679, 710))
    dq = torch.zeros(4, device="cuda")
    dq[0] = 1.0
    key = torch.full((2,), 648, dtype=torch.int64, device="cuda")
    l0 = (stencil.LAUNCHES, poisson.LAUNCHES)
    pyr, resp, kp, mask = vmap(k.first_frame_step)(imgs[:, 0])
    l1 = (stencil.LAUNCHES, poisson.LAUNCHES)
    out = vmap(lambda p, r, im, a, m: k.frame_step(p, r, im, a, m, dq, key))(
        pyr, resp, imgs[:, 1], kp, mask)
    torch.cuda.synchronize()
    l2 = (stencil.LAUNCHES, poisson.LAUNCHES)
    assert l1 == (l0[0] + 1, l0[1] + 1) and l2 == (l1[0] + 1, l1[1] + 1), (l0, l1, l2)
    for b in range(3):
        p1, r1, kp1, m1 = k.first_frame_step(imgs[b, 0])
        assert torch.equal(m1, mask[b]) and float((kp1 - kp[b]).abs().max()) <= 1e-3
        o1 = k.frame_step(p1, r1, imgs[b, 1], kp1, m1, dq, key)
        agree = float((o1[4] == out[4][b]).float().mean())
        both = o1[4] & out[4][b]
        assert agree >= 0.98 and int(both.sum()) >= 20, (b, agree)
        assert float((o1[2] - out[2][b])[both].abs().max()) <= 1e-3


# E2 against torch.linalg.eigh at the same dtype: the eigenpairs within
# chip_smoke.eig_gap's limit (at float32 1e-5 of the largest eigenvalue,
# or 16 n unit roundoffs for n > 10; at float64 1e-12), V diag(L) V^T
# within the same of A, and the marginalization's products (the clamped
# pseudo-inverse of a full-rank matrix, S^T S = V diag(clamped L) V^T of a
# rank-deficient one) against torch.linalg.eigh's in float64 of the same
# matrix, which is what E2 computes: within 1e-8 relative for the
# pseudo-inverse (its condition number is ~1e5) and 1e-12 for S^T S at
# float64; at float32 the eigenpairs are rounded on the way out and the
# products summed over n terms in float32: eig_gap's float32 limit.
E2_PINV_REL_F64 = 1e-8
E2_STS_REL_F64 = 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [15, 30, 60, 90, 105, 135, 150, 180, 210, 240])
def test_sym_eig_block_matches_eigh_on_card(n, dtype):
    """Kernel E2 at the marginalization's sizes, every form and cluster
    width its launch picks: 15 (the victim block) and 30 (the prior at
    F = 2), the small form padded to 16 and to 32; 60, 90, 105, 135, 150,
    180, 210 and 240, the (F*15)-square prior at F = 4 to 16, the blocked
    form on clusters of 2, 3, 4, 5, 5, 6, 7 and 8 CTAs (A's rows exchanged
    through a second buffer up to 210, through registers at 240). One
    matrix and a vmapped stack of 11 in one launch, against
    torch.linalg.eigh; it converges within its sweep limit, and refuses
    n = N_MAX + 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.func import vmap

    import chip_smoke as cs
    from pvio_torch.estimation import marginalization as marg
    from pvio_torch.ops import eigh as eigh_op

    rng = np.random.default_rng(n)
    full = torch.as_tensor(cs.marg_like(rng, 11, n, zeroed=0), dtype=dtype, device="cuda")
    deficient = torch.as_tensor(cs.marg_like(rng, 11, n, zeroed=15 if n > 15 else 5),
                                dtype=dtype, device="cuda")
    for A in (full, deficient):
        L_p, _ = torch.linalg.eigh(A)
        before = eigh_op.BLOCK_LAUNCHES[n]
        L1, V1 = eigh_op.eigh(A[0])
        Lv, Vv = vmap(eigh_op.eigh)(A)
        assert eigh_op.BLOCK_LAUNCHES[n] == before + 2
        assert int(eigh_op.LAST_SWEEPS.max()) < eigh_op.MAX_SWEEPS
        assert torch.equal(Lv[0], L1) and torch.equal(Vv[0], V1)
        gap, lim = cs.eig_gap(A, Lv, Vv, L_p)
        assert gap <= lim, (gap, lim)
        scale = float(L_p.abs().max())
        rec = float(((Vv * Lv[..., None, :]) @ Vv.transpose(-1, -2) - A).abs().max()) / scale
        assert rec <= lim, (rec, lim)
        L64, V64 = torch.linalg.eigh(A.double())
        if A is full:
            got = torch.stack([marg._clamped_pinv(a) for a in A]).double()
            want = (V64 * torch.where(L64 > 1e-8, 1.0 / L64, 0.0)[..., None, :]) @ V64.mT
            rel = float((got - want).abs().max() / want.abs().max())
            assert rel <= (E2_PINV_REL_F64 if dtype == torch.float64 else lim), rel
        else:
            lam = torch.where(Lv > 1e-8, Lv, 0.0).double()
            sts = (Vv.double() * lam[..., None, :]) @ Vv.double().mT
            want = (V64 * torch.where(L64 > 1e-8, L64, 0.0)[..., None, :]) @ V64.mT
            rel = float((sts - want).abs().max() / want.abs().max())
            assert rel <= (E2_STS_REL_F64 if dtype == torch.float64 else lim), rel
    with pytest.raises(ValueError):
        eigh_op.sym_eig_cuda(torch.eye(eigh_op.N_MAX + 1, dtype=dtype, device="cuda"))


@pytest.mark.cuda
def test_sym_eig_block_sweeps_match_model_on_card():
    """On the two matrices one marg_step of the bench window (Config()'s 9
    frame slots, float32, 320x240) decomposes on the card, E2's sweep count
    lies within one of its CPU model's (`eigh_op.jacobi_model`, the same
    algorithm in float64 PyTorch; summation order and FMA contraction
    differ), and both match torch.linalg.eigh."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke as cs
    from pvio_torch.core.kernels import DeviceKernels
    from pvio_torch.io.config import Config
    from pvio_torch.ops import eigh as eigh_op

    cfg = Config(camera_intrinsic=np.array([200.0, 200.0, 160.0, 120.0]), image_size=(320, 240))
    cfg.dtype = "float32"
    cfg.enable_plane_constraint = True
    kern = DeviceKernels(cfg)
    w, host = cs.bench_inputs(cfg, 1)
    cases = cs.marg_cases(kern, cs.to_device(w, kern.device), host)
    n_prior = cfg.window_frame_capacity * 15
    for key in ("15x15", f"{n_prior}x{n_prior}"):
        A = cases[key].double()
        A = torch.tril(A) + torch.tril(A, -1).mT
        L, V = eigh_op.eigh(A)
        sweeps = int(eigh_op.LAST_SWEEPS[0])
        L_m, V_m, sweeps_m = eigh_op.jacobi_model(A.cpu())
        L_p = torch.linalg.eigh(A)[0]
        print(f"E2 on the recorded {key}: {sweeps} sweeps, its CPU model {sweeps_m}")
        assert abs(sweeps - sweeps_m) <= 1 and sweeps < eigh_op.MAX_SWEEPS, (key, sweeps, sweeps_m)
        gap, lim = cs.eig_gap(A, L, V, L_p)
        gap_m, _ = cs.eig_gap(A.cpu(), L_m, V_m, L_p.cpu())
        assert gap <= lim and gap_m <= lim, (key, gap, gap_m, lim)


# the card's and the CPU's marginalization at 16 frame slots, float64: the
# prior's S^T S and S^T infovec within 1e-8 relative (kf_step's float64
# bar). E2 against eigh alone moves them 2.0e-12 on the CPU (jacobi_model
# in eigh's place on this window); the rest is the device's rounding of the
# Schur complement, which the clamped pseudo-inverse amplifies.
MARG16_PRIOR_REL_F64 = 1e-8


@pytest.mark.cuda
def test_card_engine_with_16_frame_slots_marginalizes():
    """sliding_window_size 15 (16 frame slots, n = 240: E2's largest
    blocked form, 8 CTAs) builds on the card and its marg_step matches the
    CPU's; 17 slots raise when the engine is built."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke as cs
    from pvio_torch.core.kernels import DeviceKernels
    from pvio_torch.io import synthetic as TS
    from pvio_torch.ops import eigh as eigh_op

    cfg = _small_config()
    cfg.sliding_window_size, cfg.window_frame_capacity, cfg.dtype = 15, 16, "float64"
    scene = TS.make_scene(duration=4.0, n_points=200, n_plane_points=80, seed=648)
    kf = list(range(0, 60, 4))
    w, _, _ = TS.solver_window_from_scene(scene, kf, F_cap=16, T_cap=96, dtype=torch.float64,
                                          kp_noise=0.002)
    grids = cs.imu_grids(scene, kf, 16, 64)
    before = eigh_op.BLOCK_LAUNCHES[240]
    card = DeviceKernels(cfg).marg_step(cs.to_device(w, torch.device("cuda")), *grids)
    torch.cuda.synchronize()
    assert eigh_op.BLOCK_LAUNCHES[240] == before + 1
    assert int(eigh_op.LAST_SWEEPS[0]) < eigh_op.MAX_SWEEPS
    cpu = DeviceKernels(cfg, device="cpu").marg_step(w, *grids)
    rel = _prior_rel(card.prior, cpu.prior)
    dp = float((card.p.cpu() - cpu.p).abs().max())
    print(f"marg_step at 16 frame slots, card vs CPU float64: prior rel {rel:.3e}, |dp| {dp:.3e}")
    assert rel <= MARG16_PRIOR_REL_F64 and dp == 0.0, (rel, dp)
    cfg.sliding_window_size, cfg.window_frame_capacity = 16, 17
    with pytest.raises(ValueError, match="sliding_window_size is at most 15"):
        DeviceKernels(cfg)


@pytest.mark.cuda
def test_find_plane_on_card_makes_no_host_wait():
    """ransac.find_plane (the plane extractor's device RANSAC) on device
    inputs runs under torch.cuda.set_sync_debug_mode("error") after one
    warm-up call, and equals its CPU result: the same inlier mask and
    count, the plane within 1e-12 (float64)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from pvio_torch.frontend import ransac
    from pvio_torch.utils import threefry

    rng = np.random.default_rng(0)
    N = 97
    pts = rng.normal(size=(N, 3)) * [2.0, 1.5, 0.01] + [0.3, -0.2, 4.6]
    pts[60:] = rng.normal(size=(N - 60, 3)) * 2.0 + [0.0, 0.0, 3.0]
    mask = rng.uniform(size=N) < 0.9
    key = torch.as_tensor(threefry.split(threefry.PRNGKey(648))[1].astype(np.int64))
    args = (key, torch.as_tensor(pts), torch.as_tensor(mask))
    want = ransac.find_plane(*args)
    dev = [a.cuda() for a in args]
    ransac.find_plane(*dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ransac.find_plane(*dev)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    n, d, inl, cnt = (x.cpu() for x in got)
    assert n.shape == (3,) and d.dim() == cnt.dim() == 0 and inl.shape == (N,)
    assert torch.equal(inl, want[2]) and int(cnt) == int(want[3]) > 40
    assert float((n - want[0]).abs().max()) <= 1e-12 and abs(float(d - want[1])) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_poisson_select_edge_cases_on_card(dtype):
    """The redesigned S1 equals the plain rounds loop bit for bit, round
    counts included, on chip_smoke.selection_cases (the CPU tests hold the
    plain loop to the reference's rounds on the same cases), one launch
    each; then all cases of 1024 or fewer candidates padded to one C as a
    vmapped stack in one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.func import vmap

    import chip_smoke as cs
    from pvio_torch.ops import poisson

    cases = cs.selection_cases(dtype)
    for name, cand, alive, md in cases:
        before = poisson.LAUNCHES
        sel = poisson.select_candidates(cand.cuda(), alive.cuda(), md)
        rounds = int(poisson.LAST_KERNEL_ROUNDS[0])
        assert poisson.LAUNCHES == before + 1
        plain = poisson.select_candidates_plain(cand, alive, md)
        assert torch.equal(sel.cpu(), plain) and rounds == poisson.LAST_ROUNDS, name
    C = max(c.shape[0] for _, c, _, _ in cases)
    cand_b = torch.stack([torch.cat([c, c.new_zeros(C - c.shape[0], 2)]) for _, c, _, _ in cases])
    alive_b = torch.stack([torch.cat([a, a.new_zeros(C - a.shape[0])]) for _, _, a, _ in cases])
    before = poisson.LAUNCHES
    sel_b = vmap(poisson.select_candidates, in_dims=(0, 0, None))(cand_b.cuda(), alive_b.cuda(),
                                                                 12.0)
    rounds_b = poisson.LAST_KERNEL_ROUNDS.tolist()
    assert poisson.LAUNCHES == before + 1
    for b in range(len(cases)):
        plain = poisson.select_candidates_plain(cand_b[b], alive_b[b], 12.0)
        assert torch.equal(sel_b[b].cpu(), plain) and rounds_b[b] == poisson.LAST_ROUNDS, b


@pytest.mark.cuda
def test_poisson_select_on_bench_frames_on_card():
    """S1 on the candidates of 11 rendered frames at Config()'s 480x752
    (K1's responses, Config()'s min_distance): each image and the 11-image
    vmapped stack (one launch) equal the plain rounds loop bit for bit,
    round counts included, at float32 and float64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.func import vmap

    from pvio_torch.core.kernels import DeviceKernels
    from pvio_torch.frontend import detect
    from pvio_torch.io import synthetic as TS
    from pvio_torch.io.config import Config
    from pvio_torch.ops import poisson, stencil

    cfg = Config()
    cfg.dtype = "float32"
    k = DeviceKernels(cfg)
    scene = TS.make_scene(duration=1.0, n_points=280, n_plane_points=160, seed=648)
    imgs = [k.preprocess(torch.as_tensor((TS.render_frame(scene, i, cfg.K, cfg.image_size) * 255
                                          + 0.5).astype(np.uint8), device="cuda"))[0]
            for i in range(11)]
    stack = torch.stack(imgs).contiguous()
    resp = stencil.shi_tomasi_response(stack)
    md = cfg.feature_tracker_min_keypoint_distance
    cands = [detect.candidates(stack[b], md, border=20, response=resp[b]) for b in range(11)]
    for dtype in (torch.float32, torch.float64):
        cand_b = torch.stack([c for c, _ in cands]).to(dtype).contiguous()
        alive_b = torch.stack([a for _, a in cands]).contiguous()
        before = poisson.LAUNCHES
        sel_b = vmap(poisson.select_candidates, in_dims=(0, 0, None))(cand_b, alive_b, md)
        rounds_b = poisson.LAST_KERNEL_ROUNDS.tolist()
        assert poisson.LAUNCHES == before + 1
        for b in range(11):
            sel = poisson.select_candidates(cand_b[b], alive_b[b], md)
            rounds = int(poisson.LAST_KERNEL_ROUNDS[0])
            plain = poisson.select_candidates_plain(cand_b[b], alive_b[b], md)
            assert torch.equal(sel, plain) and torch.equal(sel_b[b], plain), b
            assert rounds == rounds_b[b] == poisson.LAST_ROUNDS, (b, rounds, rounds_b[b])

"""Port parity of the keyframe entry points of `DeviceKernels`
(`attach_deltas`, `ba_step`, `marg_step`, `kf_step`, `kf_step_chained`),
pvio_torch vs pvio_tpu on the CPU at float64, with the pipeline tests'
small configuration (7 frame slots, 96 tracks), planes ON, on the perturbed
small window of tests/test_torch_factors_ba.py and the scene's own IMU.

Tolerances: flags, plane ids, triangulation gates and accept counts
identical; states, landmarks and depths 1e-8; costs 1e-9 relative; deltas
1e-12 of each field's largest entry; the marginalization prior through S^T S
and S^T infovec, 1e-8 of their largest entry. Inside the port,
`kf_step_chained` equals `kf_step` fed the same values bit for bit, under
`torch.use_deterministic_algorithms(True)`.
"""

import functools

import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from pvio_tpu.core.kernels import DeviceKernels as JKernels
from pvio_tpu.estimation import marginalization as Jmarg
from pvio_torch.core.kernels import DeviceKernels as TKernels
from pvio_torch.map import window as Twin
from tests.test_torch_factors_ba import assert_window_close, ba_window, to_port
from tests.test_torch_harness import assert_close, assert_rel, assert_same, npy
from tests.test_torch_marginalization import assert_prior_matches
from tests.test_torch_slice import _configs

torch.set_num_threads(2)
N_IMU = 64


def imu_grids(scene, frames, F):
    """bench.py's per-slot IMU buffers at float64 (chip_smoke.imu_grids)."""
    return chip_smoke.imu_grids(scene, frames, F, N_IMU, np.float64)


@functools.lru_cache(maxsize=None)
def kernels():
    jcfg, tcfg = _configs()
    return JKernels(jcfg), TKernels(tcfg, device="cpu")


def jargs(*xs):
    return tuple(jnp.asarray(x) for x in xs)


def assert_ba_outputs_match(out_t, out_j, what):
    """(w2, info, landmarks, (tri_pts, tri_inv_d, tri_ok, baseline))."""
    (wt, it, xt, trit), (wj, ij, xj, trij) = out_t, out_j
    assert_window_close(wt, wj, 1e-8, what)
    for f in ("track_flags", "plane_id", "track_mask", "ref_frame", "frame_mask"):
        assert_same(getattr(wt, f), getattr(wj, f), f"{what} {f}")
    assert_close(wt.quality, wj.quality, 1e-6, f"{what} quality px")
    assert int(it["accepted"]) == int(ij["accepted"]) >= 1
    for k in ("initial_cost", "final_cost"):
        assert_rel(it[k], ij[k], 1e-9, f"{what} {k}")
    assert float(it["final_cost"]) < float(it["initial_cost"])
    assert_close(xt, xj, 1e-8, f"{what} landmarks")
    assert_same(trit[2], trij[2], f"{what} tri_ok")
    ok = npy(trij[2])
    assert ok.sum() >= 60
    assert_close(npy(trit[0])[ok], npy(trij[0])[ok], 1e-8, f"{what} tri points")
    assert_close(npy(trit[1])[ok], npy(trij[1])[ok], 1e-8, f"{what} tri inv_d")
    assert_close(trit[3], trij[3], 1e-8, f"{what} baselines")


def test_attach_deltas_matches_reference():
    """Re-integration of every slot's IMU span at the previous frame's
    bias (a vmapped preintegration in both packages)."""
    scene, kf, w, _, _, wt, _ = ba_window()
    jk, tk = kernels()
    grids = imu_grids(scene, kf, w.q.shape[0])
    wj = jk.attach_deltas(w, *jargs(*grids))
    wa = tk.attach_deltas(wt, *grids)
    for name, a, b in zip(wa.delta._fields, wa.delta, wj.delta):
        assert_rel(a, b, 1e-12, f"delta.{name}")
    assert_same(wa.delta_valid, wj.delta_valid, "delta_valid")
    assert_close(wa.bg_lin, wj.bg_lin, 0.0, "bg_lin")


def test_ba_step_matches_reference():
    """ba_step (make_prior=False) on the perturbed window: the solve, the
    plane-track escape and the post-solve update, with the fresh geometry.
    The port's struct-of-arrays preintegration path (the one it takes on
    the card) gives the same step as its batched path."""
    scene, kf, w, _, _, wt, _ = ba_window()
    jk, tk = kernels()
    grids = imu_grids(scene, kf, w.q.shape[0])
    life = np.full(w.inv_depth.shape[0], 20, np.int32)
    out_j = jk.ba_step(w, *jargs(*grids, life), False)
    out_t = tk.ba_step(wt, *grids, life, False)
    assert_ba_outputs_match(out_t, out_j, "ba_step")
    assert not tk.ba_cfg.fused_preint
    tk_soa = TKernels(tk.cfg, device="cpu")
    tk_soa.ba_cfg = tk.ba_cfg._replace(fused_preint=True)
    assert_ba_outputs_match(tk_soa.ba_step(wt, *grids, life, False), out_j, "ba_step soa")


def test_marg_step_matches_reference():
    scene, kf, w, _, _, wt, _ = ba_window()
    jk, tk = kernels()
    grids = imu_grids(scene, kf, w.q.shape[0])
    wj = jk.marg_step(w, *jargs(*grids))
    wm = tk.marg_step(wt, *grids)
    assert_window_close(wm, wj, 1e-12, "marg_step")
    for f in ("frame_mask", "obs_mask", "ref_frame", "track_mask", "track_flags"):
        assert_same(getattr(wm, f), getattr(wj, f), f)
    assert_prior_matches(wm.prior, wj.prior, "marg_step")


@functools.lru_cache(maxsize=None)
def keyframe_inputs():
    """One keyframe at frame kf[-1] + 2 on the small window: every other
    non-plane track made fresh (not TF_VALID) and re-based off slot 0, so
    that the triangulation adoption has work; the new frame's state off the
    truth by a few mm; its observations from the scene; triangulated depths
    1% off the window's. Returns the window pair and the kf_step arguments
    after the window (numpy)."""
    scene, kf, w, extr, info, _, _ = ba_window()
    F, T = w.q.shape[0], w.inv_depth.shape[0]
    rng = np.random.default_rng(21)
    wr = Jmarg.rebase_tracks(w, extr, removed_slot=0)
    flags = np.asarray(w.track_flags).copy()
    fresh = ((np.arange(T) % 2 == 1) & ((flags & Twin.TF_PLANE) == 0)
             & np.asarray(w.track_mask) & (np.asarray(wr.ref_frame) != 0))
    flags[fresh] &= ~Twin.TF_VALID
    inv_d = np.where(fresh, np.asarray(wr.inv_depth), np.asarray(w.inv_depth))
    w = w._replace(track_flags=jnp.asarray(flags), inv_depth=jnp.asarray(inv_d),
                   ref_frame=jnp.where(jnp.asarray(fresh), wr.ref_frame, w.ref_frame))
    new = kf[-1] + 2
    from pvio_torch.io import synthetic as TS

    kp, vis = TS.project_points(scene, np.array([new]), kp_noise=0.002, seed=5)
    chosen = np.asarray(info["chosen"])
    nf_kp, nf_obs = np.zeros((T, 2)), np.zeros(T, bool)
    nf_kp[:len(chosen)], nf_obs[:len(chosen)] = kp[0, chosen], vis[0, chosen]
    nf = (scene.q_wb[new], scene.p_wb[new] + rng.normal(size=3) * 0.003,
          scene.v_wb[new], np.zeros(3), np.zeros(3))
    tri_depth = inv_d * (1.0 + rng.normal(size=T) * 0.01)
    tri_ok = rng.uniform(size=T) < 0.9
    n_obs_final = np.asarray(w.obs_mask)[1:].sum(axis=0) + nf_obs
    tri_mask_host = (np.asarray(w.track_mask) & (n_obs_final >= 2)
                     & ((flags & (Twin.TF_VALID | Twin.TF_PLANE)) == 0)
                     & (np.asarray(w.ref_frame) != 0))
    assert (tri_mask_host & tri_ok).sum() >= 5
    slot = len(kf) - 1                     # the last slot after slot 0 goes
    args = (*imu_grids(scene, kf, F), *imu_grids(scene, kf[1:] + [new], F), *nf,
            nf_kp, nf_obs, tri_depth)
    life = (np.asarray(w.obs_mask).sum(axis=0) + nf_obs).astype(np.int32) + 15
    return w, to_port(w), args, tri_ok, tri_mask_host, life, slot


def test_kf_step_matches_reference():
    """The whole keyframe: marginalize slot 0, splice the new frame into the
    freed slot, adopt the triangulations, make the initial prior, solve."""
    w, wt, args, tri_ok, tri_mask_host, life, slot = keyframe_inputs()
    jk, tk = kernels()
    tri_mask = tri_mask_host & tri_ok
    out_j = jk.kf_step(w, *jargs(*args, tri_mask, life), jnp.int32(slot), True, True)
    out_t = tk.kf_step(wt, *args, tri_mask, life, slot, True, True)
    assert_ba_outputs_match(out_t, out_j, "kf_step")
    assert_prior_matches(out_t[0].prior, out_j[0].prior, "kf_step")
    adopted = tri_mask & ((npy(out_t[0].track_flags) & Twin.TF_VALID) != 0)
    assert adopted.sum() >= 5


def test_kf_step_chained_is_kf_step_bit_for_bit():
    """kf_step_chained on the motion step's device outputs (here CPU
    tensors; tri_ok completes the adoption mask inside) against kf_step fed
    numpy copies of the same values, with and without marginalization:
    every output identical, under deterministic algorithms."""
    w, wt, args, tri_ok, tri_mask_host, life, slot = keyframe_inputs()
    _, tk = kernels()
    dev = [torch.as_tensor(a) for a in args]
    for i in range(10, 16):                 # nf_q .. nf_ba as float64 tensors
        dev[i] = torch.as_tensor(args[i], dtype=torch.float64)
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for do_marg, s in ((True, slot), (False, slot + 1)):
            a = tk.kf_step_chained(wt, *dev, torch.as_tensor(tri_ok), tri_mask_host, life,
                                   torch.tensor(s), False, do_marg)
            b = tk.kf_step(wt, *args, tri_mask_host & tri_ok, life, s, False, do_marg)
            flat_a, flat_b = chip_smoke.leaves(a), chip_smoke.leaves(b)
            assert len(flat_a) == len(flat_b) == 49      # window 40, info 4, cloud 1, tri 4
            for x, y in zip(flat_a, flat_b):
                assert x.dtype == y.dtype and torch.equal(x, y)
    finally:
        torch.use_deterministic_algorithms(det)


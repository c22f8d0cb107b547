"""Batched multi-sequence solving (`pvio_torch/parallel/batch.py`,
`models/presets.batched_solver`) against single solves and against the
reference's `pvio_tpu/parallel/batch.py` on the CPU at float64.

The windows come from the port's numpy copy of the scene generator and are
handed to both packages (`to_jax`), as tests/test_torch_factors_ba.py does.
Tolerances: the vmapped solve against single port solves 1e-10 m
(`tests/test_parallel.py::test_batched_solver_matches_single`'s bound);
against the reference's vmapped solve 1e-8 on every state and the final
costs (rtol 1e-8): the two LM loops reassociate sums differently.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvio_tpu import models as Jmodels
from pvio_tpu.estimation import ba as Jba
from pvio_tpu.map import window as Jwin
from pvio_tpu.parallel import batch as Jbatch
from pvio_torch.estimation import ba as Tba
from pvio_torch.io import synthetic as TS
from pvio_torch.models import presets as Tpresets
from pvio_torch.parallel import batch as Tbatch
from tests.test_torch_factors_ba import small_scene_window, to_jax
from tests.test_torch_harness import assert_close, npy

torch.set_num_threads(2)
STATE = ("q", "p", "v", "bg", "ba", "inv_depth")


@pytest.fixture(scope="module")
def setup():
    """tests/test_parallel.py's setup on the port: 5 keyframes, 64 tracks,
    planes off, 4 LM iterations."""
    scene = TS.make_scene(duration=2.0, n_points=160)
    w, extr, _ = TS.solver_window_from_scene(scene, [0, 4, 8, 12, 16], F_cap=6, T_cap=64,
                                             dtype=torch.float64, kp_noise=0.001)
    cfg = Tba.BAConfig(iterations=4, kp_sqrt_inv_cov=283.0, use_planes=False)
    return w, extr, cfg


def _perturb(w, seed, sigma=0.005):
    rng = np.random.default_rng(seed)
    dp = rng.normal(size=tuple(w.p.shape)) * sigma
    dp[0] = 0.0
    return w._replace(p=w.p + torch.as_tensor(dp))


def _jax_extr(extr):
    return Jwin.Extrinsics(*(jnp.asarray(npy(x)) for x in extr))


def _jax_cfg(cfg):
    return Jba.BAConfig(**{k: v for k, v in cfg._asdict().items()
                           if k in Jba.BAConfig._fields})


def test_batched_solver_matches_single(setup):
    w, extr, cfg = setup
    ws = [_perturb(w, s) for s in range(3)]
    wb, costs = Tbatch.make_batched_solver(extr, cfg)(Tbatch.stack_windows(ws))
    singles = [Tba.solve(wi, extr, cfg)[0] for wi in ws]
    outs = Tbatch.unstack_windows(wb, 3)
    for a, b in zip(outs, singles):
        assert np.allclose(npy(a.p), npy(b.p), atol=1e-10)
    assert tuple(costs.shape) == (3,)


def test_batched_solver_matches_reference(setup):
    w, extr, cfg = setup
    ws = [_perturb(w, s) for s in range(3)]
    wb_t, costs_t = Tbatch.make_batched_solver(extr, cfg)(Tbatch.stack_windows(ws))
    solver_j = Jbatch.make_batched_solver(_jax_extr(extr), _jax_cfg(cfg))
    wb_j, costs_j = solver_j(Jbatch.stack_windows([to_jax(wi) for wi in ws]))
    np.testing.assert_allclose(npy(costs_t), np.asarray(costs_j), rtol=1e-8)
    for f in STATE:
        assert_close(getattr(wb_t, f), getattr(wb_j, f), 1e-8, f)


def test_batched_keyframe_step_matches_reference():
    """With planes on and the camera matrix, the post-solve depth gate and
    track quality ride the batch too; the windows differ by perturbation."""
    scene, kf, wt, et, info = small_scene_window()
    cfg = Tba.BAConfig(iterations=4, kp_sqrt_inv_cov=283.0, use_planes=True,
                       min_plane_tracks=10)
    ws = [_perturb(wt, 10 + s, sigma=0.003) for s in range(2)]
    K = np.array([[200.0, 0, 160.0], [0, 200.0, 120.0], [0, 0, 1.0]])
    step_t = Tbatch.make_batched_keyframe_step(et, cfg, K=torch.as_tensor(K))
    wb_t, costs_t = step_t(Tbatch.stack_windows(ws))
    step_j = Jbatch.make_batched_keyframe_step(_jax_extr(et), _jax_cfg(cfg), K=jnp.asarray(K))
    wb_j, costs_j = step_j(Jbatch.stack_windows([to_jax(wi) for wi in ws]))
    np.testing.assert_allclose(npy(costs_t), np.asarray(costs_j), rtol=1e-8)
    for f in STATE + ("plane_normal", "plane_distance", "quality"):
        assert_close(getattr(wb_t, f), getattr(wb_j, f), 1e-8, f)
    for f in ("track_flags", "track_mask"):
        assert np.array_equal(npy(getattr(wb_t, f)), np.asarray(getattr(wb_j, f))), f
    # the single-sequence keyframe step on the port gives the same windows
    for i, wi in enumerate(ws):
        w1, info1 = Tba.solve(wi, et, cfg)
        w1 = Tba.post_solve_update(w1, et, torch.as_tensor(K))
        assert_close(Tbatch.unstack_windows(wb_t, 2)[i].p, w1.p, 1e-10, "single p")


def test_presets_batched_solver_matches_reference():
    step_t, ba_t = Tpresets.batched_solver(device="cpu")
    step_j, ba_j = Jmodels.batched_solver()
    assert callable(step_t) and callable(step_j)
    assert ba_t._asdict() == ba_j._asdict()

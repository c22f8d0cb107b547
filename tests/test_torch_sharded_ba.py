"""The port's track-sharded BA (`pvio_torch/parallel/sharded_ba.py`) over
gloo process groups on the CPU, against the port's single-process
`ba.solve` and the reference's `make_sharded_solver` on the virtual
8-device mesh, at float64.

The cases are the reference's (`tests/test_parallel.py:47`, `:78`, `:126`)
at dp = 2 x tp = 4, eight spawned processes: planes off (4 windows of 6
slots x 64 tracks), planes on (the same capacities, one plane of >= 25
members) and BASELINE config 5's enlarged window (2 windows of 16
keyframes x 256 tracks, two iterations). The windows come from the port's
numpy copy of the scene generator and go to both packages. Tolerances:
every rank's gathered output identical; positions within 1e-8 m of
`ba.solve` and of the reference's sharded solve (sums reduced in another
order); costs finite and within 1e-8 relative of the reference's (its
`costs[-1]`). A world of one (tp = dp = 1) equals `ba.solve` within
1e-10 m, directly and through `presets.sharded_solver`, and a window or
mesh on a device the backend does not serve raises.

The processes join a gloo group through a file in the test's tmp_path (no
TCP port to clash under xdist), each at one thread. `init_process_group`
and the join have limits of their own, so a hung collective fails its test.
This module imports no JAX at its top: the spawned workers import it.
"""

import os
import time
import traceback
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.utils import _pytree as pytree

from pvio_torch.estimation import ba as Tba
from pvio_torch.io import synthetic as TS
from pvio_torch.parallel import batch as Tbatch
from pvio_torch.parallel import sharded_ba as Tsh

torch.set_num_threads(2)

INIT_TIMEOUT_S = 60     # init_process_group, and each collective after it
JOIN_TIMEOUT_S = 180    # the whole world, from its start
MAX_DP = 1e-8
MAX_DP_WORLD_OF_ONE = 1e-10
COST_RTOL = 1e-8


# ---------------------------------------------------------------------------
# a world of gloo processes


def _entry(target, rank, world, init_file, out_dir, args):
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                world_size=world, timeout=timedelta(seconds=INIT_TIMEOUT_S))
        try:
            result = target(*args)
        finally:
            dist.destroy_process_group()
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_world(tmp_path, world, target, *args):
    """`target(*args)` in `world` spawned processes joined in one gloo
    group; each rank's return value, in rank order. Fails if a process
    fails or the world outlives JOIN_TIMEOUT_S."""
    out = tmp_path / f"world{world}_{target.__name__}"
    out.mkdir()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(target, r, world, str(out / "pg_init"), str(out),
                                              args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    errors = {r: (out / f"error{r}.txt").read_text() for r in range(world)
              if (out / f"error{r}.txt").exists()}
    assert not hung, f"ranks {hung} still running after {JOIN_TIMEOUT_S} s; errors {errors}"
    assert all(p.exitcode == 0 for p in procs), (
        [p.exitcode for p in procs], "\n".join(errors.values()))
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


def solve_worker(dp, tp, cases):
    """Each case's (batched window, extrinsics, BAConfig) through the
    sharded solver on a dp x tp gloo mesh: {name: (windows, costs)}."""
    mesh = Tsh.ProcessMesh(dp, tp, device="cpu")
    return {name: Tsh.make_sharded_solver(mesh, extr, cfg)(wb)
            for name, (wb, extr, cfg) in cases.items()}


def mismatch_worker(wb, extr, cfg):
    """Which device mismatches raise in a world of one over gloo."""
    raised = {}

    def attempt(name, fn):
        try:
            fn()
            raised[name] = None
        except ValueError as e:
            raised[name] = str(e)

    attempt("cuda mesh under gloo", lambda: Tsh.ProcessMesh(1, 1, device="cuda"))
    attempt("default device under gloo", lambda: Tsh.ProcessMesh(1, 1))
    attempt("dp x tp != world", lambda: Tsh.ProcessMesh(2, 1, device="cpu"))
    mesh = Tsh.ProcessMesh(1, 1, device="cpu")
    meta = pytree.tree_map(lambda a: a.to("meta"), wb)
    attempt("meta window", lambda: Tsh.make_sharded_solver(mesh, extr, cfg)(meta))
    attempt("meta extrinsics",
            lambda: Tsh.make_sharded_solver(mesh, pytree.tree_map(lambda a: a.to("meta"), extr),
                                            cfg))
    attempt("meta gather", lambda: Tsh.gather_window(meta, mesh))
    return raised


# ---------------------------------------------------------------------------
# the reference's cases, on the port's scene generator


def _perturb(w, seed, sigma=0.005):
    """tests/test_parallel.py's `_perturb`: positions moved by seeded noise,
    frame 0 kept."""
    rng = np.random.default_rng(seed)
    dp = rng.normal(size=tuple(w.p.shape)) * sigma
    dp[0] = 0.0
    return w._replace(p=w.p + torch.as_tensor(dp))


def _case(scene, kf, F_cap, T_cap, iterations, batch, planes):
    w, extr, info = TS.solver_window_from_scene(scene, kf, F_cap=F_cap, T_cap=T_cap,
                                                dtype=torch.float64, kp_noise=0.001)
    if planes:
        w, members = TS.flag_plane_tracks(w, scene, info)
        assert members >= 25     # enough members to arm the plane factor
    cfg = Tba.BAConfig(iterations=iterations, kp_sqrt_inv_cov=283.0, use_planes=planes,
                       min_plane_tracks=20)
    ws = [_perturb(w, s) for s in range(batch)]
    return ws, extr, cfg


@pytest.fixture(scope="module")
def cases():
    """name -> (list of windows, extrinsics, BAConfig)."""
    return {
        "planes off": _case(TS.make_scene(duration=2.0, n_points=160), [0, 4, 8, 12, 16],
                            6, 64, 4, 4, False),
        "planes on": _case(TS.make_scene(duration=2.0, n_points=40, n_plane_points=90,
                                         plane_z=4.6, seed=648),
                           [0, 4, 8, 12, 16], 6, 64, 3, 4, True),
        "16 x 256": _case(TS.make_scene(duration=6.0, fps=20.0, n_points=300, seed=7),
                          list(range(0, 16 * 4, 4)), 16, 256, 2, 2, False),
    }


@pytest.fixture(scope="module")
def world8(cases, tmp_path_factory):
    """Every case through one dp = 2 x tp = 4 world of eight processes."""
    batched = {k: (Tbatch.stack_windows(ws), extr, cfg) for k, (ws, extr, cfg) in cases.items()}
    return run_world(tmp_path_factory.mktemp("sharded"), 8, solve_worker, 2, 4, batched)


@pytest.fixture(scope="module")
def reference(cases):
    """The reference's sharded solver on the virtual 8-device mesh (dp = 2 x
    tp = 4) on the same windows: name -> (positions (B, F, 3), costs (B,))."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from pvio_tpu.estimation import ba as Jba
    from pvio_tpu.map.window import Extrinsics as JExtrinsics
    from pvio_tpu.parallel import batch as Jbatch, sharded_ba as Jsh
    from tests.test_torch_factors_ba import to_jax

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("dp", "tp"))
    out = {}
    for name, (ws, extr, cfg) in cases.items():
        jextr = JExtrinsics(*(jnp.asarray(a.numpy()) for a in extr))
        solver = Jsh.make_sharded_solver(mesh, jextr, Jba.BAConfig(**cfg._asdict()))
        with mesh:
            wb, costs = solver(Jbatch.stack_windows([to_jax(w) for w in ws]))
        out[name] = (np.asarray(wb.p), np.asarray(costs))
    return out


@pytest.mark.parametrize("name", ["planes off", "planes on", "16 x 256"])
def test_sharded_solver_matches_solve_and_reference(name, cases, world8, reference):
    ws, extr, cfg = cases[name]
    got = [r[name] for r in world8]
    w0, c0 = got[0]
    leaves0 = pytree.tree_leaves(w0)
    for r, (w, c) in enumerate(got[1:], 1):      # every rank holds the same gather
        assert all(torch.equal(a, b) for a, b in zip(pytree.tree_leaves(w), leaves0)), r
        assert torch.equal(c, c0), r
    assert w0.p.shape == (len(ws),) + tuple(ws[0].p.shape)
    assert torch.isfinite(c0).all()
    singles = [Tba.solve(w, extr, cfg)[0] for w in ws]
    for i, s in enumerate(singles):
        err = float(torch.max(torch.abs(w0.p[i] - s.p)))
        assert err < MAX_DP, (name, i, err)
        assert torch.equal(w0.track_flags[i], s.track_flags)
    p_ref, c_ref = reference[name]
    err = float(np.max(np.abs(w0.p.numpy() - p_ref)))
    assert err < MAX_DP, (name, "reference", err)
    np.testing.assert_allclose(c0.numpy(), c_ref, rtol=COST_RTOL)


def world_of_one_worker(wb, extr, cfg, w, preset_cfg):
    """A world of one over gloo: the sharded solver on `wb`, and
    `presets.sharded_solver(mesh, preset_cfg)` on `w` replicated twice."""
    from pvio_torch.models import presets

    mesh = Tsh.ProcessMesh(1, 1, device="cpu")
    return (Tsh.make_sharded_solver(mesh, extr, cfg)(wb),
            presets.sharded_solver(mesh, preset_cfg)(Tsh.replicate_window_batch(w, 2)))


def test_world_of_one_equals_solve(cases, tmp_path):
    """tp = dp = 1: the frame/track split and the collectives reduce to
    `ba.solve` but for the order of a few sums; the same through
    `presets.sharded_solver` (the preset's extrinsics and BAConfig, on the
    mesh's device) on a window that `replicate_window_batch` tiles as the
    reference's does."""
    import jax

    from pvio_torch.models import presets
    from pvio_tpu.parallel import sharded_ba as Jsh
    from tests.test_torch_factors_ba import to_jax

    ws, extr, cfg = cases["planes on"]
    preset_cfg = presets.vio_no_planes()
    preset_cfg.dtype, preset_cfg.solver_iteration_limit = "float64", 3
    (res,) = run_world(tmp_path, 1, world_of_one_worker, Tbatch.stack_windows(ws), extr, cfg,
                       ws[0], preset_cfg)
    (w, costs), (w_pre, costs_pre) = res
    for i, wi in enumerate(ws):
        s = Tba.solve(wi, extr, cfg)[0]
        err = float(torch.max(torch.abs(w.p[i] - s.p)))
        assert err < MAX_DP_WORLD_OF_ONE, (i, err)
    assert torch.isfinite(costs).all() and costs.shape == (len(ws),)
    extr_pre, cfg_pre = presets._solver_parts(preset_cfg, torch.device("cpu"))
    assert cfg_pre.iterations == 3 and not cfg_pre.use_planes
    s = Tba.solve(ws[0], extr_pre, cfg_pre)[0]
    for i in range(2):
        err = float(torch.max(torch.abs(w_pre.p[i] - s.p)))
        assert err < MAX_DP_WORLD_OF_ONE, ("preset", i, err)
    assert torch.isfinite(costs_pre).all()
    rep = Tsh.replicate_window_batch(ws[0], 3)
    ref = Jsh.replicate_window_batch(to_jax(ws[0]), 3)
    for a, b in zip(pytree.tree_leaves(rep), jax.tree.leaves(ref)):
        assert a.shape == b.shape and np.array_equal(a.numpy(), np.asarray(b))


def test_device_mismatch_raises(cases, tmp_path):
    """A mesh or window on a device that the group's backend does not serve
    raises (gloo: the CPU only; a CUDA window would copy through the host)."""
    ws, extr, cfg = cases["planes off"]
    (raised,) = run_world(tmp_path, 1, mismatch_worker, Tbatch.stack_windows(ws), extr, cfg)
    assert all(raised.values()), raised
    assert "pass device='cpu'" in raised["default device under gloo"]

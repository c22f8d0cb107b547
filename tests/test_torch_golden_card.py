"""The golden runs of `tests/test_golden_run.py` through the port on the
card, with the reference tests' bounds unchanged, and the pins of fault F4
(the `synthetic` CLI at float32 on the card).

Each run goes through `pvio_torch.golden_run`'s pieces (the Config from the
YAML and the flags, the scene, the rendered and undistorted frames, the
drive loop and the readout) and prints its ATE, scale, poses,
initialization frame and ms per `track_camera` call by state. The check
functions take the device, so `tests/test_torch_golden_run.py` runs the
same checks on the CPU (`slow`).

The hard-mode comparison (`check_hard_mode_planes_beat_planes_off`) drives
planes on and planes off over one render of the noisy frames. The 60 s
endurance runs (`check_long_horizon_production_gates`) render once into `.artifacts/golden60_port_<key>.npz`, which the later cases and
calls in the same checkout read back; each run also records the device
memory every 100 frames after initialization (which must stay flat), the
median ms per tracking and keyframe call in each quarter, the host waits
per call (`utils/transfer.WAITS`) in the first and last quarters, and the
kernels' launches over the run.

The tests carry the `cuda` marker and skip without a card; the endurance
cases are also `verylong`, which `pytest.ini`'s addopts deselect. The file
imports no JAX, so it runs where only PyTorch is installed:
`python -m pytest tests/test_torch_golden_card.py --noconftest -q -s`, and
one endurance case a process with `-m "cuda and verylong" -k
"long_horizon and float64 and planes_on"`.
"""

import contextlib
import json
import os
import re
import statistics

import numpy as np
import pytest
import torch

from pvio_torch import golden_run

# the rendered frames of each scene, shared by the runs that use the same
# ones, under golden_run.frames_key
_IMAGES = {}
# fault F4: the float32 `synthetic` CLI's ATE on the card, held to the golden
# tier's bound (tests/test_golden_run.py:88) since the repair
CLI_F32_MAX_ATE_M = 0.10


def golden(argv, device, blackout_frames=None, on_frame=None, cache_prefix=None):
    """One golden run on `device`: `argv` are golden_run's flags;
    `blackout_frames` (a range) feeds black frames there; `on_frame(vio,
    scene, fi)` is called after each frame; with `cache_prefix` the frames
    are also kept on disk, in `<cache_prefix>_<frames key>.npz`. Returns
    the engine, the scene, the drive record and the readout."""
    from pvio_torch import PVIO

    args = golden_run.parse_args(list(argv) + (["--cpu"] if device == "cpu" else []))
    cfg = golden_run.build_config(args)
    scene = golden_run.make_scene(args)
    if blackout_frames is not None:
        args.blackout = (scene.frame_t[blackout_frames.start], scene.frame_t[blackout_frames.stop])
    key = golden_run.frames_key(args, scene)
    if key not in _IMAGES:
        if cache_prefix is not None:
            os.makedirs(os.path.dirname(cache_prefix), exist_ok=True)
            args.cache_images = f"{cache_prefix}_{key}.npz"
            _IMAGES.clear()                # one long stack in memory at a time
            _IMAGES[key] = golden_run.load_or_render(scene, cfg, args)
        else:
            _IMAGES[key] = golden_run.render_images(scene, cfg, args)
    vio = PVIO(cfg, device=device)
    rec = golden_run.drive(vio, scene, golden_run.image_source(_IMAGES[key], scene, cfg, args),
                           on_frame=None if on_frame is None else lambda fi: on_frame(vio, scene, fi))
    r = golden_run.readout(vio.get_trajectory(), scene)
    q0 = r["quarters"][0][0]
    print(f"\n{' '.join(argv)} on {device}: ATE {r['ate']:.6f} m, first quarter {q0:.6f} m, "
          f"scale {r['scale']:.6f}, {r['poses']} poses, initialized at frame {rec['init_fi']}, "
          f"re-inits {vio.core.frontend.n_reinits}, planes {len(vio.get_planes())}; median ms "
          "per track_camera call: " + ", ".join(
              f"{k} {v[0]:.3f} ({v[1]} calls)" for k, v in golden_run.state_ms(rec["calls"]).items()))
    return vio, scene, rec, r


def check_production_dtype(device):
    """test_golden_run_f32_production_dtype: euroc.yaml at float32, 12 s."""
    vio, _, _, r = golden(["config/euroc.yaml", "--dtype", "float32"], device)
    assert vio.initialized
    assert vio.core.frontend.n_reinits == 0
    assert r["poses"] >= 180, r["poses"]
    assert abs(r["scale"] - 1.0) < 0.03, f"f32 scale {r['scale']}"
    assert r["ate"] < 0.06, f"f32 ATE {r['ate']} m"
    assert r["quarters"][0][0] < 0.05, f"f32 first-quarter ATE {r['quarters'][0][0]} m"


def check_euroc_shaped(device):
    """test_golden_run_euroc_shaped: euroc.yaml at float64, 12 s."""
    vio, _, _, r = golden(["config/euroc.yaml"], device)
    assert vio.initialized
    assert vio.core.frontend.n_reinits == 0
    assert len(vio.get_planes()) >= 1, "walls must be detected as planes"
    assert r["poses"] >= 180, r["poses"]
    assert r["quarters"][0][0] < 0.05, f"first-quarter ATE {r['quarters'][0][0]} m"
    assert abs(r["scale"] - 1.0) < 0.05, f"scale {r['scale']}"
    assert r["ate"] < 0.10, f"ATE {r['ate']} m"


def check_tumvi_shaped(device, dtype):
    """test_golden_run_tumvi_shaped: tum-vi.yaml, 512x512 equidistant, 8 s."""
    vio, _, _, r = golden(["config/tum-vi.yaml", "--duration", "8", "--dtype", dtype], device)
    assert vio.core.kernels.cfg.image_size == (512, 512)
    assert vio.initialized
    assert vio.core.frontend.n_reinits == 0
    assert len(vio.get_planes()) >= 1, "walls must be detected as planes"
    assert r["poses"] >= 120, r["poses"]
    assert r["quarters"][0][0] < 0.04, f"first-quarter ATE {r['quarters'][0][0]} m"
    assert abs(r["scale"] - 1.0) < 0.05, f"scale {r['scale']}"
    assert r["ate"] < 0.10, f"ATE {r['ate']} m"


def check_production_scale_gate(device):
    """test_golden_run_second_seed_production_scale_gate: seed 1234, the
    sweep at 0.6, the init scale gate at its production 1.0, 8 s."""
    vio, _, _, r = golden(["config/euroc.yaml", "--duration", "8", "--seed", "1234",
                           "--traj-scale", "0.6", "--max-scale", "1.0"], device)
    assert vio.core.kernels.cfg.initializer_max_scale == 1.0
    assert vio.initialized, "must initialize through the production scale gate"
    assert vio.core.frontend.n_reinits == 0
    assert r["poses"] >= 110, r["poses"]
    assert abs(r["scale"] - 1.0) < 0.06, f"scale {r['scale']}"
    assert r["ate"] < 0.20, f"ATE {r['ate']} m"


def check_blackout_reinit(device):
    """test_golden_run_blackout_reinit_production_res: frames 55-61 black in
    a 7 s run; the states after frame 102 in their own gauge."""
    from pvio_torch.geometry import wahba

    blackout = range(55, 62)
    post = []

    def on_frame(vio, scene, fi):
        if fi > blackout.stop + 40 and vio.initialized:
            st = vio.get_latest_state()
            if st is not None:
                post.append((scene.frame_t[fi], st.p.copy()))

    vio, scene, _, _ = golden(["config/euroc.yaml", "--duration", "7"], device,
                              blackout_frames=blackout, on_frame=on_frame)
    assert vio.core.frontend.n_reinits >= 1, "blackout must force re-init"
    assert vio.initialized, "must re-initialize after the blackout"
    assert len(post) >= 20, len(post)
    t2idx = {round(tt, 6): i for i, tt in enumerate(scene.frame_t)}
    est = np.array([p for (tt, p) in post if t2idx.get(round(tt, 6)) is not None])
    gt = np.array([scene.p_wb[t2idx[round(tt, 6)]] for (tt, p) in post
                   if t2idx.get(round(tt, 6)) is not None])
    ate = float(wahba.ate_rmse(torch.as_tensor(est, dtype=torch.float64),
                               torch.as_tensor(gt, dtype=torch.float64), with_scale=False))
    print(f"post-recovery ATE {ate:.6f} m over {len(est)} states, re-inits "
          f"{vio.core.frontend.n_reinits}")
    assert ate < 0.10, f"post-recovery ATE {ate} m"
    assert np.isfinite(est).all()


HARD_MODE = ["config/euroc.yaml", "--duration", "12", "--seed", "648", "--pixel-noise", "8",
             "--noise-after", "3", "--max-kp", "100", "--fb", "4", "--kp-sigma", "1.5",
             "--imu-noise", "1"]


def check_hard_mode_planes_beat_planes_off(device, dtype):
    """test_golden_hard_mode_planes_beat_planes_off, the paper's claim:
    pixel noise sigma 8 after a clean 3 s initialization, a keypoint budget
    of 100, a 4 px forward-backward gate, keypoint sigma 1.5 px and a noisy
    IMU; planes on and planes off over the same frames, and planes on must
    win."""
    runs = {}
    for planes in (True, False):
        vio, _, rec, r = golden(HARD_MODE + ["--dtype", dtype] + ([] if planes else ["--no-planes"]),
                                device)
        runs[planes] = dict(initialized=vio.initialized, reinits=vio.core.frontend.n_reinits,
                            poses=r["poses"], ate=r["ate"], scale=r["scale"],
                            q0=r["quarters"][0][0], planes=len(vio.get_planes()),
                            init_fi=rec["init_fi"])
    on, off = runs[True], runs[False]
    print(f"\nhard mode {dtype} on {device}: planes on ATE {on['ate']:.6f} m (first quarter "
          f"{on['q0']:.6f}, scale {on['scale']:.6f}, {on['planes']} planes), planes off ATE "
          f"{off['ate']:.6f} m (first quarter {off['q0']:.6f}, scale {off['scale']:.6f})")
    for run in (on, off):
        assert run["initialized"] and run["reinits"] == 0, run
        assert run["poses"] >= 180, run["poses"]
    assert on["ate"] < off["ate"], (
        f"planes must WIN under degraded vision: ON {on['ate']:.4f} m vs OFF {off['ate']:.4f} m")
    assert on["ate"] < 0.06, f"hard-mode planes-ON ATE {on['ate']} m"
    assert off["ate"] < 0.12, f"hard-mode planes-OFF ATE {off['ate']} m (sanity)"
    assert abs(on["scale"] - 1.0) < 0.05


LONG_HORIZON = ["config/euroc.yaml", "--duration", "60", "--seed", "648", "--init-ramp", "0.3",
                "--long-profile", "--max-scale", "1.0"]
# the endurance frames on disk, shared by the cases and by later calls
LONG_CACHE = os.path.join(".artifacts", "golden60_port")
MEMORY_EVERY = 100           # frames between device-memory samples
MAX_MEMORY_GROWTH = 1.05     # the peak after 30 s over the peak in 10-30 s
HEALTH_LOG_FROM = 44.0       # s: the backstop's record is kept from the first loss on


def long_horizon_record(calls, waits, memory, n_frames):
    """What only a long run shows, from the drive record's `calls`, the
    host waits of each call and the memory samples [(t, bytes)]: the
    median ms per tracking and keyframe call in each quarter of the frames,
    the host waits per tracking and keyframe call in each quarter, and the
    device memory's peaks between 10 s and 30 s and after 30 s."""
    bounds = [round(k * n_frames / 4) for k in range(5)]
    rec = dict(ms=[], waits=[])
    for k in range(4):
        seg = list(zip(calls, waits))[bounds[k]:bounds[k + 1]]
        ms, per = {}, {}
        for state in ("tracking", "keyframe"):
            x = [(m, w) for (s, m), w in seg if s == state]
            if x:
                ms[state] = (statistics.median(m for m, _ in x), len(x))
                per[state] = sum(w for _, w in x) / len(x)
        rec["ms"].append(ms)
        rec["waits"].append(per)
    mid = [b for t, b in memory if 10.0 <= t <= 30.0]
    late = [b for t, b in memory if t > 30.0]
    rec["memory"] = memory
    rec["memory_peak_10_30"] = max(mid) if mid else None
    rec["memory_peak_after_30"] = max(late) if late else None
    return rec


@contextlib.contextmanager
def health_log(swt_module):
    """Record every decision of the landmark-starvation backstop
    (`swt_module.health_update`, one call a keyframe; the port's
    `pvio_torch.core.swt` or the reference's `pvio_tpu.core.swt`) while the
    block runs. Yields the list of records, one a keyframe: the keyframe's
    time `t`, the count `n_valid` of live tracks flagged TF_VALID or
    TF_PLANE, its parts `n_tf_valid` and `n_tf_plane` (a track may carry
    both flags), the running peak `peak`, the floor max(
    track_health_min_landmarks, 15% of the peak), the consecutive
    below-floor keyframes after the call `unhealthy`, and the verdict
    `lost`."""
    real = swt_module.health_update
    log = []

    def logged(state, cfg, n_valid_now):
        lost = real(state, cfg, n_valid_now)
        hw = state.hw
        live = np.asarray(hw.track_mask, bool)
        flags = np.asarray(hw.track_flags)
        log.append(dict(
            t=float(hw.frame_t[hw.n_frames - 1]), n_valid=int(n_valid_now),
            n_tf_valid=int((live & ((flags & swt_module.TF_VALID) != 0)).sum()),
            n_tf_plane=int((live & ((flags & swt_module.TF_PLANE) != 0)).sum()),
            peak=int(state.peak_valid),
            floor=max(int(cfg.track_health_min_landmarks), int(0.15 * state.peak_valid)),
            unhealthy=int(state.unhealthy_keyframes), lost=bool(lost)))
        return lost

    swt_module.health_update = logged
    try:
        yield log
    finally:
        swt_module.health_update = real


@contextlib.contextmanager
def event_log(fw_module):
    """Record what each tracked frame did to the frontend's state machine
    (`fw_module.FrontendWorker.issue_frame`; the port's `pvio_torch.core.
    frontend_worker` or the reference's `pvio_tpu.core.frontend_worker`)
    while the block runs. Yields the list of records, one for each frame
    that initialized a window or lost tracking: `kind` ("init" or "lost")
    and the frame's time `t`."""
    cls = fw_module.FrontendWorker
    real = cls.issue_frame
    log = []

    def logged(self, raw_frame):
        swt, n = self.swt, self.n_reinits
        out = real(self, raw_frame)
        if self.n_reinits > n:
            log.append(dict(kind="lost", t=float(raw_frame.t)))
        elif self.swt is not None and self.swt is not swt:
            log.append(dict(kind="init", t=float(raw_frame.t)))
        return out

    cls.issue_frame = logged
    try:
        yield log
    finally:
        cls.issue_frame = real


def seg_ate(traj, scene, lo, hi):
    """The ATE (m, with the scale left free) and the scale of the poses of
    `traj` [(t, q, p)] at frame times in [lo, hi) against `scene`'s ground
    truth, and how many there are; (None, None, n) under 20 poses."""
    from pvio_torch.geometry import wahba

    t2idx = {round(t, 6): i for i, t in enumerate(scene.frame_t)}
    kept = [(t, p) for (t, q, p) in traj if lo <= t < hi and t2idx.get(round(t, 6)) is not None]
    if len(kept) < 20:
        return None, None, len(kept)
    est = torch.as_tensor(np.array([p for _, p in kept]), dtype=torch.float64)
    gt = torch.as_tensor(np.array([scene.p_wb[t2idx[round(t, 6)]] for t, _ in kept]),
                         dtype=torch.float64)
    s, _, _ = wahba.find_srt(est, gt)
    return float(wahba.ate_rmse(est, gt, with_scale=False)), float(s), len(kept)


def long_horizon_run(device, dtype, planes, health_from=HEALTH_LOG_FROM):
    """The 60 s endurance run of test_golden_long_horizon_production_gates
    on `device` over one render of its frames (`LONG_CACHE`), and what its
    contract reads: returns the engine, the trajectory, the output gaps
    over 0.5 s, and the record the test prints (the contract's numbers,
    device memory every MEMORY_EVERY frames after initialization, ms and
    host waits per call by quarter, the kernels' launches, the times at
    which tracking was lost and (re)initialized, `event_log`'s records, and
    the backstop's decision at every keyframe from `health_from` s on,
    `health_log`'s records)."""
    from pvio_torch.core import frontend_worker as fw_mod
    from pvio_torch.core import swt as swt_mod
    from pvio_torch.ops import eigh as eigh_op
    from pvio_torch.ops import poisson, stencil
    from pvio_torch.utils import transfer

    waits, memory, first = [], [], []
    last_waits = [transfer.WAITS]

    def on_frame(vio, scene, fi):
        waits.append(transfer.WAITS - last_waits[0])
        last_waits[0] = transfer.WAITS
        if vio.initialized and not first:
            first.append(fi)
        if first and device != "cpu" and (fi - first[0]) % MEMORY_EVERY == 0:
            memory.append((float(scene.frame_t[fi]), torch.cuda.memory_allocated()))

    stencil.LAUNCHES = poisson.LAUNCHES = eigh_op.LAUNCHES = 0
    eigh_op.BLOCK_LAUNCHES.clear()
    with health_log(swt_mod) as health, event_log(fw_mod) as events:
        vio, scene, rec, r = golden(
            LONG_HORIZON + ["--dtype", dtype] + ([] if planes else ["--no-planes"]), device,
            on_frame=on_frame, cache_prefix=LONG_CACHE)
    launches = dict(shi_tomasi=stencil.LAUNCHES, poisson_select=poisson.LAUNCHES,
                    sym_eig=eigh_op.LAUNCHES,
                    sym_eig_block={int(n): c for n, c in sorted(eigh_op.BLOCK_LAUNCHES.items())})

    traj = vio.get_trajectory()
    ts = [t for (t, q, p) in traj]
    reinits = vio.core.frontend.n_reinits
    first30 = seg_ate(traj, scene, 0.0, 30.0)
    gaps = [(ts[i], ts[i + 1]) for i in range(len(ts) - 1) if ts[i + 1] - ts[i] > 0.5]
    t_rec = gaps[-1][1] if gaps else None
    whole = seg_ate(traj, scene, 0.0, 60.0)
    post = seg_ate(traj, scene, t_rec + 1.0, 60.0) if t_rec is not None else (None, None, 0)
    out = dict(device=device, dtype=dtype, planes=planes, initialized=vio.initialized,
               reinits=reinits, poses=len(traj), init_fi=rec["init_fi"],
               n_planes=len(vio.get_planes()), first30=first30, whole=whole, t_rec=t_rec,
               post=post, quarters=r["quarters"], kf_steps=rec["kf_steps"], launches=launches,
               **long_horizon_record(rec["calls"], waits, memory, rec["n_frames"]),
               events=events, health=[h for h in health if h["t"] >= health_from])
    return vio, traj, gaps, out


def check_long_horizon_production_gates(device, dtype, planes):
    """test_golden_long_horizon_production_gates: the 60 s EuRoC-shaped run
    (drifting loops, an aggressive yaw/pitch burst at 25-35 s) with the
    init scale gate at its production 1.0, over one render of the frames.
    Its contract clause by clause: initialized at the end, at most one
    health re-init, >= 900 finite poses; the first 30 s >= 500 poses, ATE
    < 0.20 m, scale within 0.05; without a re-init the whole run's ATE <
    0.60 m and scale within 0.10; with one, the segment from 1 s after the
    recovery (the last output gap > 0.5 s, before 56 s) >= 40 poses, ATE <
    0.30 m and scale within 0.10, or the reference's own xfail. On the card
    the device memory after 30 s stays within MAX_MEMORY_GROWTH of its
    peak between 10 s and 30 s."""
    vio, traj, gaps, out = long_horizon_run(device, dtype, planes)
    print("\nlong horizon " + json.dumps(out))
    reinits, first30, whole, t_rec, post = (out[k] for k in ("reinits", "first30", "whole",
                                                             "t_rec", "post"))

    assert vio.initialized, f"planes={planes}: must end initialized"
    assert reinits <= 1, f"planes={planes}: at most one health re-init, got {reinits}"
    assert len(traj) >= 900, (planes, len(traj))
    assert np.isfinite(np.array([p for (_, _, p) in traj])).all()
    if device != "cpu":
        assert out["memory_peak_10_30"] is not None and out["memory_peak_after_30"] is not None
        assert out["memory_peak_after_30"] <= MAX_MEMORY_GROWTH * out["memory_peak_10_30"], (
            f"device memory grew: {out['memory_peak_10_30']} B at most in 10-30 s, "
            f"{out['memory_peak_after_30']} B after")
    a, s1, n = first30
    assert n >= 500, (planes, n)
    assert a < 0.20, f"planes={planes} first-30s ATE {a} m"
    assert abs(s1 - 1.0) < 0.05, f"planes={planes} first-30s scale {s1}"
    if reinits == 0:
        a, s2, n = whole
        assert a < 0.60, f"planes={planes} full-run ATE {a} m"
        assert abs(s2 - 1.0) < 0.10, f"planes={planes} full scale {s2}"
    else:
        assert gaps, f"planes={planes}: re-init without output gap?"
        assert t_rec < 56.0, f"planes={planes}: recovery too late ({t_rec:.1f}s)"
        a, s2, n = post
        assert n >= 40, (planes, n)
        if not (a < 0.30 and abs(s2 - 1.0) < 0.10):
            # the reference's own expected failure (tests/test_golden_run.py:
            # 423-440): a re-init in the low-excitation pause estimates gravity
            # ~2 deg off, the window absorbs the tilt into an accel bias, and
            # the estimate drifts once the rotation resumes
            pytest.xfail(
                f"planes={planes}: post-recovery gauge diverged "
                f"(ATE {a:.2f} m, scale {s2:.3f}) — known-open tilt/"
                f"bias ambiguity of a low-excitation re-init")


def synthetic_cli(device, fast, capsys):
    """`python -m pvio_torch.run synthetic --dtype float32 [--fast]`: the ATE
    (m) and the poses it prints."""
    from pvio_torch import run

    argv = ["synthetic", "--dtype", "float32", "--output", "/dev/null"]
    argv += ["--fast"] if fast else []
    argv += ["--cpu"] if device == "cpu" else []
    assert run.main(argv) == 0
    out = capsys.readouterr().out
    ate = re.search(r"^ATE RMSE \(SE3\): ([0-9.]+) cm over (\d+) poses", out, re.M)
    print(out)
    return float(ate.group(1)) / 100, int(ate.group(2))


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_golden_f32_production_dtype_on_card():
    needs_card()
    check_production_dtype("cuda")


@pytest.mark.cuda
def test_golden_euroc_shaped_on_card():
    needs_card()
    check_euroc_shaped("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_golden_tumvi_shaped_on_card(dtype):
    needs_card()
    check_tumvi_shaped("cuda", dtype)


@pytest.mark.cuda
def test_golden_production_scale_gate_on_card():
    needs_card()
    check_production_scale_gate("cuda")


@pytest.mark.cuda
def test_golden_blackout_reinit_on_card():
    needs_card()
    check_blackout_reinit("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True], ids=["sequential", "fast"])
def test_synthetic_float32_cli_on_card(fast, capsys):
    """Fault F4's pin: `python -m pvio_torch.run synthetic` at float32 on the
    card reads under CLI_F32_MAX_ATE_M, sequential and with --fast."""
    needs_card()
    ate, poses = synthetic_cli("cuda", fast, capsys)
    print(f"synthetic float32 {'--fast' if fast else 'sequential'} on the card: ATE {ate} m "
          f"over {poses} poses")
    assert ate < CLI_F32_MAX_ATE_M, ate


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_golden_hard_mode_on_card(dtype):
    needs_card()
    check_hard_mode_planes_beat_planes_off("cuda", dtype)


@pytest.mark.cuda
@pytest.mark.verylong
@pytest.mark.parametrize("dtype,planes", [("float64", True), ("float64", False),
                                          ("float32", True)],
                         ids=["float64-planes_on", "float64-planes_off", "float32-planes_on"])
def test_golden_long_horizon_on_card(dtype, planes):
    needs_card()
    check_long_horizon_production_gates("cuda", dtype, planes)

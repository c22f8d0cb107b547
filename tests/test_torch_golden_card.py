"""The golden runs of `tests/test_golden_run.py` through the port on the
card, with the reference tests' bounds unchanged, and the pins of fault F4
(the `synthetic` CLI at float32 on the card).

Each run goes through `pvio_torch.golden_run`'s pieces (the Config from the
YAML and the flags, the scene, the rendered and undistorted frames, the
drive loop and the readout) and prints its ATE, scale, poses,
initialization frame and ms per `track_camera` call by state. The check
functions take the device, so `tests/test_torch_golden_run.py` runs the
same checks on the CPU (`slow`).

The tests carry the `cuda` marker and skip without a card. The file imports
no JAX, so it runs where only PyTorch is installed:
`python -m pytest tests/test_torch_golden_card.py --noconftest -q -s`.
"""

import re

import numpy as np
import pytest
import torch

from pvio_torch import golden_run

# the rendered frames of each scene, shared by the runs that use the same one
_IMAGES = {}
# fault F4: the float32 `synthetic` CLI's ATE on the card, held to the golden
# tier's bound (tests/test_golden_run.py:88) since the repair
CLI_F32_MAX_ATE_M = 0.10


def golden(argv, device, blackout_frames=None, on_frame=None):
    """One golden run on `device`: `argv` are golden_run's flags;
    `blackout_frames` (a range) feeds black frames there; `on_frame(vio,
    scene, fi)` is called after each frame. Returns the
    engine, the scene, the drive record and the readout."""
    from pvio_torch import PVIO

    args = golden_run.parse_args(list(argv) + (["--cpu"] if device == "cpu" else []))
    cfg = golden_run.build_config(args)
    scene = golden_run.make_scene(args)
    if blackout_frames is not None:
        args.blackout = (scene.frame_t[blackout_frames.start], scene.frame_t[blackout_frames.stop])
    key = (args.config, args.duration, args.seed, args.traj_scale)
    if key not in _IMAGES:
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

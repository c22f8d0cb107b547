"""The port held to the reference step by step at the golden hard mode's
own size and frames: `tests/test_torch_hard_mode.py`'s `lockstep` at
`tests/test_golden_run.py::test_golden_hard_mode_planes_beat_planes_off`'s
configuration (`config/euroc.yaml`, 480x752 radtan, float64, the overrides
of its `hard_cfg`) over the 240 frames `pvio_torch.golden_run` renders for
it (`HARD_MODE`, room texture seed 7: clean to 3 s, pixel noise sigma 8
after), planes off and planes on.

Each frame the reference's `FeatureTracker` starts from the port's
keypoints of the frame before and must give the same masks and track ids
and keypoints within 1e-9 px; the reference's `SlidingWindowTracker`,
started from the port's initialized window, must take the same keyframes,
agree with the port's states within 1e-6 m and make the same plane
decisions after every call, normals, distances and polar extents within
1e-8. The reference's window needs no re-seeding: its states stay within
1.5e-11 m of the port's over the 204 calls after initialization. With
planes on the reference builds its extents from the members with a valid
fresh triangulation, as the port does (ROADMAP §3, F6).

Planes off, a second reference `FeatureTracker` tracks the frames left free
against the port's raw frames: they agree within 1e-9 px through the clean
frames, and their keypoints part by the noisy frames' growth of rounding
(~4x a frame, 9e-12 px at frame 60 to 0.9 px at frame 79 on texture 7),
no mask or id differing until the gap has passed 1e-6 px.

At the end each case prints the ATE of both trackers' states in the
lockstep run (the golden readout: SE(3)-aligned, and the first quarter's),
the largest |dp| in each quarter of the calls and the largest keypoint gap.

The frames are rendered once into `.artifacts/golden_hard_<frames key>.npz`
(git-ignored; ~2.5 minutes in a pool of one process per CPU), which
`python -m pvio_torch.golden_run ... --cache-images` and
`scripts/golden_run.py --cache-images` read as well. `slow`: each case takes
~9-10 minutes on a shared 8-core CPU (the port's ~0.45 s and the
reference's ~0.5 s a tracked frame, and the reference's compilations).
"""

import os

import numpy as np
import pytest

from pvio_torch import golden_run
from tests.test_torch_facade_tracking import MAX_KP_PX
from tests.test_torch_golden_card import HARD_MODE
from tests.test_torch_golden_run import ref_hard_config
from tests.test_torch_hard_mode import lockstep

CACHE_PREFIX = os.path.join(".artifacts", "golden_hard")
# the free frontends may differ in a mask or id only once rounding has grown
# past this keypoint gap (px), a thousand times the lockstep's tolerance
FREE_PARTS_AFTER_PX = 1e-6


def hard_mode_frames(flags, cache_prefix=CACHE_PREFIX):
    """The golden run's args, Config, scene and frames for `flags`, the
    frames read from (or rendered into) the cache under their key."""
    args = golden_run.parse_args(list(flags) + ["--cpu"])
    cfg = golden_run.build_config(args)
    scene = golden_run.make_scene(args)
    os.makedirs(os.path.dirname(cache_prefix), exist_ok=True)
    args.cache_images = f"{cache_prefix}_{golden_run.frames_key(args, scene)}.npz"
    return args, cfg, scene, golden_run.load_or_render(scene, cfg, args)


def quarters(xs):
    n = len(xs) // 4
    return [max(xs[k * n:(k + 1) * n if k < 3 else len(xs)]) for k in range(4)]


@pytest.mark.slow
@pytest.mark.parametrize("planes", [False, True], ids=["planes_off", "planes_on"])
def test_hard_mode_full_size_matches_reference(planes):
    flags = HARD_MODE + ["--dtype", "float64"] + ([] if planes else ["--no-planes"])
    args, cfg, scene, images = hard_mode_frames(flags)
    assert cfg.image_size == (752, 480) and len(images) == 240
    run = lockstep(scene, images, cfg, ref_hard_config(args), free_frontend=not planes)
    assert scene.frame_t[run["init_fi"]] < args.noise_after
    assert len(run["dp"]) >= 180
    port = golden_run.readout(run["port_traj"], scene)
    ref = golden_run.readout(run["ref_traj"], scene)
    engine = golden_run.readout(run["vio"].get_trajectory(), scene)
    print(f"\nhard mode at 480x752, planes {'on' if planes else 'off'}: initialized at frame "
          f"{run['init_fi']}, {len(run['dp'])} calls after it, {run['n_keyframes']} keyframes; "
          f"ATE port {port['ate']:.6f} m (first quarter {port['quarters'][0][0]:.6f}, scale "
          f"{port['scale']:.6f}), reference in lockstep {ref['ate']:.6f} m (first quarter "
          f"{ref['quarters'][0][0]:.6f}, scale {ref['scale']:.6f}), the port's engine output "
          f"{engine['ate']:.6f} m over {engine['poses']} poses; max |dp| by quarter "
          + ", ".join(f"{x:.3e}" for x in quarters(run["dp"]))
          + f" m; max |dn|, |dd|, extents {max(run['dn']):.3e}; max keypoint gap by quarter of "
          "the frames " + ", ".join(f"{x:.3e}" for x in quarters(run["dkp"])) + " px")
    if planes:
        return
    gap, parts = np.array(run["free_gap"]), run["free_parts"]
    clean = np.nonzero(scene.frame_t < args.noise_after)[0]
    assert len(gap) > clean[-1] and gap[clean].max() <= MAX_KP_PX, gap[clean].max()
    first = clean[-1] + 1
    print(f"free frontends: largest keypoint gap on the clean frames {gap[clean].max():.3e} px, "
          f"on the noisy ones " + ", ".join(f"frame {fi} {gap[fi]:.3e}"
                                            for fi in range(first, len(gap), 4))
          + f" px; masks or ids first differ at frame {parts}")
    if parts is not None:
        assert gap[parts - 1] > FREE_PARTS_AFTER_PX, (parts, gap[parts - 1])
        rate = (gap[parts - 1] / gap[first]) ** (1.0 / (parts - 1 - first))
        print(f"growth {rate:.2f}x a noisy frame from frame {first} to {parts - 1}")

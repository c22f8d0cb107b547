"""The port held to the reference step by step over the whole 60 s
endurance golden run: `tests/test_torch_hard_mode.py`'s `lockstep` at
`tests/test_golden_run.py::test_golden_long_horizon_production_gates`'s
configuration (`config/euroc.yaml`, 480x752 radtan, float64, the
production scale gate 1.0) over the 1,200 frames `pvio_torch.golden_run`
renders for it (`LONG_HORIZON`: drifting loops, the yaw/pitch burst at
25-35 s, the hover pause), planes on and planes off.

Each frame the reference's `FeatureTracker` starts from the port's
keypoints of the frame before and must give the same masks and track ids
and keypoints within 1e-9 px. The reference's `SlidingWindowTracker`,
started from the port's initialized window, must take the same keyframes,
agree with the port's states within 1e-6 m and make the same plane
decisions after every call; at every keyframe the two landmark-starvation
backstops (`health_update`) must count the same valid landmarks against
the same floor and give the same verdict. The run crosses the backstop's
firing (tracking lost after ~44 s): the reference must declare tracking
lost at the same call, and at the port's re-initializing call its tracker
starts again from the port's new window, as at the first initialization.
A call that parts is run again by a reference tracker started from the
port's whole state before the call (`lockstep(reseed=True)`): planes on,
`extend_planes` meets ties at room corners, a track that fits two walls
to 1e-10 px, which rounding breaks either way; such a call must then
agree, and the case prints it. A second reference `FeatureTracker`
tracks the frames left free, and the case prints where the two
frontends' masks or ids first differ.

At the end each case prints the initializing frames and the frame where
tracking was lost, the ATE of both trackers' states in the lockstep run
(the golden readout), the largest |dp| in each quarter of the tracked
calls, the largest keypoint gap in each quarter of the frames, the free
frontends' gap, and the backstop's record at every keyframe.
`test_reference_replays_the_card` replays the reference's tracker on a
card run recorded from 44 s (`golden_spread.py --record-from 44` on an
NVIDIA H100 80GB HBM3 at 700 W, float64, planes on; gzipped into
`tests/data/f7_card_record.pkl.gz`).

The frames are rendered once into `.artifacts/golden60_port_<frames
key>.npz` (git-ignored; the card tests' cache, ~22 minutes in the pool on
2 cores). `slow` and `verylong`: each case takes about an hour on 2-4
cores of a shared CPU; run one with `python -m pytest
tests/test_torch_long_horizon_full.py -m "slow and verylong" -k planes_on -s`.
"""

import gzip
import os
import pickle
import sys
import time

import numpy as np
import pytest

from pvio_torch import golden_run
from tests.test_torch_golden_card import LONG_CACHE, LONG_HORIZON, health_log
from tests.test_torch_golden_run import ref_long_config
from tests.test_torch_hard_mode import lockstep, ref_tracker
from tests.test_torch_hard_mode_full import hard_mode_frames, quarters
from tests.test_torch_oracle_pipeline import _Frames

from pvio_tpu.core import swt as ref_swt
from pvio_tpu.core.feature_tracker import RawFrame as RefRawFrame
from pvio_tpu.core.kernels import DeviceKernels as RefKernels

PROGRESS_EVERY = 100        # tracked calls between progress lines
MAX_RESEEDS = 4             # calls that may part at a tie (2 in a planes-on run, 0 planes off)
# `python3 golden_spread.py --record-from 44` on the card, gzipped
CARD_RECORD = os.path.join(os.path.dirname(__file__), "data", "f7_card_record.pkl.gz")
BOOK = 60                   # raw frames the replay keeps (the init window's)


def progress_line(record):
    """`lockstep`'s progress callback: one line on stderr every
    PROGRESS_EVERY tracked calls with the largest |dp| since the last."""
    def progress(fi, t, dp):
        record.append(dp)
        if len(record) % PROGRESS_EVERY == 0:
            print(f"  frame {fi} t {t:.2f} s: max |dp| {max(record[-PROGRESS_EVERY:]):.3e} m "
                  f"over the last {PROGRESS_EVERY} calls", file=sys.stderr, flush=True)
    return progress


@pytest.mark.slow
@pytest.mark.verylong
@pytest.mark.parametrize("planes", [True, False], ids=["planes_on", "planes_off"])
def test_long_horizon_full_size_matches_reference(planes):
    flags = LONG_HORIZON + ["--dtype", "float64"] + ([] if planes else ["--no-planes"])
    args, cfg, scene, images = hard_mode_frames(flags, LONG_CACHE)
    assert cfg.image_size == (752, 480) and len(images) == 1200
    assert cfg.initializer_max_scale == 1.0
    t0 = time.perf_counter()
    run = lockstep(scene, images, cfg, ref_long_config(args), free_frontend=True, max_reinits=1,
                   reseed=True, progress=progress_line([]))
    seconds = time.perf_counter() - t0
    assert len(run["dp"]) >= 900
    port = golden_run.readout(run["port_traj"], scene)
    ref = golden_run.readout(run["ref_traj"], scene)
    t_of = scene.frame_t
    print(f"\n60 s endurance at 480x752, planes {'on' if planes else 'off'}, {seconds:.1f} s: "
          "initialized at frames " + ", ".join(f"{fi} ({t_of[fi]:.2f} s)" for fi in run["inits"])
          + "; tracking lost at " + (", ".join(f"frame {fi} ({t_of[fi]:.2f} s)"
                                               for fi in run["lost"]) or "no frame")
          + f"; {len(run['dp'])} tracked calls, {run['n_keyframes']} keyframes since the last "
          f"initialization; ATE port {port['ate']:.6f} m over {port['poses']} poses, reference "
          f"in lockstep {ref['ate']:.6f} m; quarters' ATE port "
          + " / ".join(f"{q[0]:.6f}" for q in port["quarters"] if q)
          + "; max |dp| by quarter " + ", ".join(f"{x:.3e}" for x in quarters(run["dp"]))
          + f" m; max |dn|, |dd|, extents {max(run['dn'], default=0.0):.3e}; max keypoint gap "
          "by quarter of the frames " + ", ".join(f"{x:.3e}" for x in quarters(run["dkp"]))
          + " px")
    print(f"{len(run['reseeds'])} calls parted and were run again from the port's state before "
          "the call, and then agreed (the reference's error of each parted column cast onto the "
          "port's plane and onto its own, px):")
    for fi, why, margins in run["reseeds"]:
        print(f"  frame {fi} ({t_of[fi]:.2f} s): {why}; "
              + (", ".join(f"column {c}: " + ("not weighed" if m is None else
                                              f"{m[0]:.6e} / {m[1]:.6e}")
                           for c, m in margins.items()) or "no plane id parted"))
    assert len(run["reseeds"]) <= MAX_RESEEDS, run["reseeds"]
    print("backstop at each keyframe (t, valid, TF_VALID, TF_PLANE, peak, floor, below-floor "
          "run, lost):")
    for fi, h in run["health"]:
        print(f"  frame {fi} {h['t']:.2f} {h['n_valid']} {h['n_tf_valid']} {h['n_tf_plane']} "
              f"{h['peak']} {h['floor']} {h['unhealthy']} {h['lost']}")
    gap, parts = np.array(run["free_gap"]), run["free_parts"]
    print("free frontends: largest keypoint gap by 100 frames "
          + ", ".join(f"{gap[k:k + 100].max():.3e}" for k in range(0, len(gap), 100))
          + f" px; masks or ids first differ at frame {parts}")


@pytest.mark.slow
@pytest.mark.verylong
def test_reference_replays_the_card():
    """The reference's tracker on the card's own inputs: the card's raw
    frames from 44 s on, its tracker's state at 44 s and its window at each
    re-initialization (`golden_spread.py --record-from 44` on the card,
    the float64 planes-on endurance run). At every keyframe the reference's
    backstop must count what the card's counted, against the same floor,
    and give the same verdict; it must declare tracking lost at the calls
    where the card did. Prints both records side by side and the largest
    |dp| by quarter."""
    with gzip.open(CARD_RECORD, "rb") as f:
        rec = pickle.load(f)
    meta = rec["meta"]
    flags = LONG_HORIZON + ["--dtype", meta["dtype"]] + ([] if meta["planes"] else ["--no-planes"])
    cfg_ref = ref_long_config(golden_run.parse_args(flags))
    kern = RefKernels(cfg_ref)
    book, swt, dp, rows = _Frames([]), None, [], []
    with health_log(ref_swt) as log:
        for row in rec["calls"]:
            rf = RefRawFrame(**row["raw"])
            book.frames = (book.frames + [rf])[-BOOK:]
            if row["kind"] in ("seed", "init"):
                swt = ref_tracker(cfg_ref, kern, book, row["window"],
                                  row if row["kind"] == "seed" else None)
                continue
            if swt is None:
                continue
            mark = len(log)
            ok = swt.track(rf)
            rows.append((row["fi"], row["t"], row["health"], log[mark:]))
            assert log[mark:] == row["health"], (row["fi"], row["health"], log[mark:])
            assert ok == (row["kind"] != "lost"), (row["fi"], row["kind"], ok)
            if not ok:
                swt = None
                continue
            dp.append(float(np.abs(np.asarray(swt.latest_state[2]) - row["p"]).max()))
    print(f"\nthe reference on the card's inputs ({meta['device']}, {meta['dtype']}, planes "
          f"{'on' if meta['planes'] else 'off'}, from {meta['from_t']} s): {len(dp)} tracked "
          "calls, max |dp| by quarter " + ", ".join(f"{x:.3e}" for x in quarters(dp)) + " m")
    print("keyframe (frame, t, valid, floor, below-floor run, lost): card | reference")
    for fi, t, card, ref in rows:
        for a, b in zip(card, ref):
            print(f"  {fi} {t:.2f} {a['n_valid']} {a['floor']} {a['unhealthy']} {a['lost']} | "
                  f"{b['n_valid']} {b['floor']} {b['unhealthy']} {b['lost']}")

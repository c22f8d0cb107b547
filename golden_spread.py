"""The golden hard mode's spread on the card: planes on against planes off
over several room textures, and gap G1's check (kernel K1 against the
plain Shi-Tomasi response at float64 on the hard-mode frames).

    python3 golden_spread.py --seeds 7 1 2 [--dtype float64] [--plain-response] [--cpu]
    python3 golden_spread.py --response-check [--frames 0 59 60 120 239]

Each run goes through the card test's `golden` helper
(`tests/test_torch_golden_card.py`) with its hard-mode flags
(`HARD_MODE`: pixel noise sigma 8 after a clean 3 s, 100 keypoints, a 4 px
gate, keypoint sigma 1.5 px, a noisy IMU) and `--texture-seed`, planes on
and then planes off over the same frames, and prints one JSON line a run
(`spread {...}`: texture seed, dtype, planes, ATE, first quarter, scale,
poses, re-inits, planes held, initialization frame, seconds).
`--plain-response` takes the plain version (`frontend.detect.
shi_tomasi_response`, which computes at the image's dtype) where the
engine launches K1 (which computes in float32). `--response-check` holds
K1's response to the plain version's on the preprocessed hard-mode frames
at float64 and compares the detections each gives (`check {...}` lines;
the frames are rendered alone, so their noise stream starts at the first
noisy frame given).
Without a card it stops unless given `--cpu`.
"""

import argparse
import json
import sys
import time


def spread_run(seed, dtype, planes, device):
    from tests import test_torch_golden_card as card

    t0 = time.perf_counter()
    vio, _, rec, r = card.golden(card.HARD_MODE + ["--dtype", dtype, "--texture-seed", str(seed)]
                                 + ([] if planes else ["--no-planes"]), device)
    return dict(seed=seed, dtype=dtype, planes=planes, device=device, ate=r["ate"],
                q0=r["quarters"][0][0], scale=r["scale"], poses=r["poses"],
                reinits=vio.core.frontend.n_reinits, n_planes=len(vio.get_planes()),
                init_fi=rec["init_fi"], seconds=time.perf_counter() - t0)


def response_check(frames, device):
    """K1 against the plain response on the preprocessed level-0 images of
    the hard-mode frames (float64 engine), and the detections of each."""
    import torch

    from pvio_torch import golden_run
    from pvio_torch.core.kernels import DeviceKernels
    from pvio_torch.frontend import detect
    from pvio_torch.ops import stencil
    from tests import test_torch_golden_card as card

    args = golden_run.parse_args(card.HARD_MODE + ["--dtype", "float64"])
    cfg, scene = golden_run.build_config(args), golden_run.make_scene(args)
    images = golden_run.render_images(scene, cfg, args, frames=frames)
    kern = DeviceKernels(cfg, device=device)
    for fi, img in zip(frames, images):
        lvl0 = kern.preprocess(img)[0].contiguous()
        r_k1, r_plain = stencil.shi_tomasi_response(lvl0), detect.shi_tomasi_response(lvl0)
        kw = dict(max_keypoints=cfg.feature_tracker_max_keypoint_detection,
                  min_distance=cfg.feature_tracker_min_keypoint_distance, border=20)
        (xy1, m1), (xy2, m2) = (detect.detect_keypoints(lvl0, response=r, **kw)
                                for r in (r_k1, r_plain))
        same = bool(torch.equal(m1, m2))
        both = m1 & m2
        dxy = float((xy1[both] - xy2[both]).abs().max()) if bool(both.any()) else 0.0
        out = dict(frame=fi, noisy=bool(scene.frame_t[fi] >= args.noise_after),
                   resp_max=float(r_plain.abs().max()),
                   resp_max_abs_diff=float((r_k1 - r_plain).abs().max()),
                   detected=(int(m1.sum()), int(m2.sum())), same_slots=same,
                   slot_diffs=int((m1 != m2).sum()), max_dxy_px=dxy)
        print("check " + json.dumps(out), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--dtype", default="float64")
    ap.add_argument("--plain-response", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--response-check", action="store_true")
    ap.add_argument("--frames", type=int, nargs="*", default=[0, 59, 60, 120, 239])
    args = ap.parse_args(argv)
    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("golden_spread: no CUDA card; pass --cpu to run on the CPU", file=sys.stderr)
        return 2
    device = "cpu" if args.cpu else "cuda"
    if args.response_check:
        response_check(args.frames, device)
    if args.plain_response:
        from pvio_torch.frontend import detect
        from pvio_torch.ops import stencil

        stencil.shi_tomasi_response = detect.shi_tomasi_response
    for seed in args.seeds:
        for planes in (True, False):
            rec = spread_run(seed, args.dtype, planes, device)
            rec["plain_response"] = args.plain_response
            print("spread " + json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

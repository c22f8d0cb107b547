#!/usr/bin/env python3
"""Where the time of the port's per-frame path goes, on one CUDA card.

    python3 profile_torch.py [--frames N] [--out result.json]

Drives the same chain as `chip_smoke.py` (bench scene, Config() float32,
planes on, 480x752) and reports, after one warm-up frame:
  * stage times: each stage of `frame_step` and `pnp_step` wrapped with a
    device synchronisation before and after (host clock), so they add up
    to the step time and include the host work of launching;
  * a torch.profiler trace of two plain frames: the device's busy share
    of the wall time, the number of kernels launched per frame, and the
    kernels (or operators) that take the most device time;
  * K1's device time per launch from the same trace.
Prints one JSON object as the last line (and writes it to --out).
"""

import argparse
import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path


ROOT = Path(__file__).resolve().parent


def main():
    import torch

    if not torch.cuda.is_available():
        print("profile_torch: needs a CUDA card", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--out", help="also write the result JSON to this file")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))

    import chip_smoke as cs
    from pvio_torch.core import kernels as kmod
    from pvio_torch.core.kernels import DeviceKernels
    from pvio_torch.io.config import Config
    from pvio_torch.ops import stencil

    stencil.build()
    cfg = Config()
    cfg.dtype = "float32"
    cfg.enable_plane_constraint = True
    kern = DeviceKernels(cfg)
    n = args.frames + 3
    w, host = cs.bench_inputs(cfg, n)
    cs.run_chain(kern, w, host, 1)            # warm-up: handles, allocator

    # stage times ------------------------------------------------------------
    times = defaultdict(list)

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.perf_counter() - t0))
            return out
        return wrapper

    stages = [
        (kern, "preprocess", "frame_step: preprocess (uint8 -> CLAHE -> pyramid)"),
        (kern, "response_of", "frame_step: corner response (K1)"),
        (kern, "predict_kp", "frame_step: gyro-predicted keypoints"),
        (kmod.klt_mod, "track_keypoints", "frame_step: KLT (fwd + fb)"),
        (kmod.ransac_mod, "find_fundamental", "frame_step: F-RANSAC"),
        (kern, "detect", "frame_step: detection"),
        (kmod, "_merge", "frame_step: merge"),
        (kmod.pre, "preintegrate", "pnp_step: preintegration"),
        (kmod.pre, "predict", "pnp_step: predict"),
        (kmod.win, "landmark_points", "pnp_step: landmark points"),
        (kern, "plane_points", "pnp_step: plane ray-casts"),
        (kmod.pnp_mod, "solve_pnp", "pnp_step: LM PnP (10 iterations)"),
        (kmod.win, "triangulate_tracks_virtual", "pnp_step: virtual-view triangulation"),
    ]
    saved = []
    for obj, attr, name in stages:
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, timed(name, getattr(obj, attr)))
    kern.frame_step = timed("frame_step (total)", kern.frame_step)
    kern.pnp_step = timed("pnp_step (total)", kern.pnp_step)
    cs.run_chain(kern, w, host, args.frames)
    for obj, attr, fn in saved:
        setattr(obj, attr, fn)
    del kern.frame_step, kern.pnp_step
    stage_ms = {k: statistics.median(v[1:] if len(v) > 2 else v) for k, v in times.items()}
    for k, v in stage_ms.items():
        print(f"{v:10.3f} ms  {k}  (calls {len(times[k])})", flush=True)

    # profiler trace of two frames ---------------------------------------------
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cs.run_chain(kern, w, host, 2)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    k1 = [v for k, v in by_name.items() if "shi_tomasi" in k]
    result = dict(
        device=torch.cuda.get_device_name(0), nvidia_smi=cs.gpu_line(),
        frames_timed=args.frames, stage_ms=stage_ms,
        trace=dict(frames=3, wall_ms=wall_ms, device_busy_ms=dev_us / 1e3,
                   device_busy_share=dev_us / 1e3 / wall_ms if wall_ms else None,
                   device_events=len(kernels),
                   top=[dict(name=k[:120], device_ms=v[0] / 1e3, count=v[1]) for k, v in top]),
        k1_device_ms_per_launch=(k1[0][0] / 1e3 / k1[0][1]) if k1 and k1[0][1] else None,
    )
    print(f"trace: wall {wall_ms:.1f} ms for first_frame_step + 2 frames, device busy "
          f"{dev_us / 1e3:.2f} ms, {len(kernels)} device events")
    for t in result["trace"]["top"]:
        print(f"  {t['device_ms']:9.3f} ms {t['count']:6d}x  {t['name']}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

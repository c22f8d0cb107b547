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
  * K1's device time per launch from the same trace;
  * the keyframe breakdown: `ba_step` (re-integration, and per LM
    iteration linearize, Schur + Cholesky, retract + evaluate_cost; then
    the plane-track escape, the post-solve update and the fresh
    triangulation) and `marg_step` (re-integration, marginalize0), each
    stage synchronised before and after inside a torch.profiler trace of
    --kf-reps calls: host ms, device ms, device events launched and the
    device's busy share, per call of the step;
  * the facade breakdown: `pvio_torch.PVIO` (Config(), planes on) run
    sequentially with fused keyframes on `chip_smoke.py`'s planes-on
    stream (480x752 room renders, FACADE_SECONDS) and, after
    initialization and two warm-up frames, one tracked frame's
    `track_camera` call and the first keyframe call with a plane in the
    window, traced with `FeatureTracker.dispatch_frame` / `finish_frame`,
    `SlidingWindowTracker.track_dispatch` / `track_finish` (and within
    them `frame_step`, `pnp_step`, the keyframe step `kf_step` and the
    plane stages: `issue_detection` with its `find_plane` on the card,
    `promote_pending` + `extend_planes`, `merge_planes` +
    `update_parameters`) each synchronised before and after: host ms,
    device ms, device events and busy share of each, and the Core
    bookkeeping (the call's host time outside those four);
  * the multi-sequence chain (`parallel.multi_seq`, chip_smoke.py's phase 7
    shapes: 2 groups of 4 frames, planes on): one sequence's unbatched
    chain and one vmapped chain of --chain-b sequences, each run once
    inside a torch.profiler trace: wall ms, device ms, device events and
    the device's busy share, and K1's and S1's launches (--no-chain skips
    it).
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
    ap.add_argument("--kf-reps", type=int, default=2)
    ap.add_argument("--no-facade", action="store_true", help="skip the facade breakdown")
    ap.add_argument("--no-chain", action="store_true", help="skip the multi-sequence chain")
    ap.add_argument("--chain-b", type=int, default=11, help="sequences of the vmapped chain")
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
    cs.run_chain(kern, w, host, 1, kf_every=0)   # warm-up: handles, allocator

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
    cs.run_chain(kern, w, host, args.frames, kf_every=0)
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
        cs.run_chain(kern, w, host, 2, kf_every=0)
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
        keyframe=keyframe_breakdown(kern, w, host, args.kf_reps),
        facade=None if args.no_facade else facade_breakdown(),
        chain=None if args.no_chain else chain_breakdown(cfg, args.chain_b),
    )
    print(f"trace: wall {wall_ms:.1f} ms for first_frame_step + 2 frames, device busy "
          f"{dev_us / 1e3:.2f} ms, {len(kernels)} device events")
    for t in result["trace"]["top"]:
        print(f"  {t['device_ms']:9.3f} ms {t['count']:6d}x  {t['name']}")
    for step, stages in result["keyframe"].items():
        for name, v in stages.items():
            print(f"{step:10s} {name:46s} host {v['host_ms']:9.3f} ms, device {v['device_ms']:8.3f} ms, "
                  f"{v['device_events']:8.1f} device events, busy {v['busy_share']:.3f} "
                  f"(calls {v['calls']:g})")
    for kind, rec in (result["facade"] or {}).items():
        for name, v in rec["stages"].items():
            print(f"facade {kind:9s} (frame {rec['frame']}, {rec['planes']} planes) {name:46s} host "
                  f"{v['host_ms']:9.3f} ms, device {v['device_ms']:8.3f} ms, "
                  f"{v['device_events']:8.1f} device events")
    for name, v in (result["chain"] or {}).items():
        print(f"chain {name:24s} wall {v['wall_ms']:9.1f} ms, device {v['device_ms']:8.3f} ms, "
              f"{v['device_events']:7d} device events, busy {v['busy_share']:.3f}, K1 launches "
              f"{v['k1_launches']}, S1 launches {v['s1_launches']}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


def _labelled(name, fn):
    """fn synchronised before and after, inside a profiler range `name`."""
    import torch
    from torch.profiler import record_function

    def wrapper(*a, **k):
        torch.cuda.synchronize()
        with record_function(name):
            out = fn(*a, **k)
            torch.cuda.synchronize()
        return out
    return wrapper


def _attribute(events, names, reps, exclude=()):
    """Per range name of a trace: calls, host ms, device ms, device events
    and busy share per rep; a device event belongs to every range whose
    host span contains its start."""
    import torch

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    device = [e for e in events if e.device_type == cuda and e.name not in exclude]
    if not device:
        raise RuntimeError("profile_torch: the trace holds no device event")
    out = {}
    for name in names:
        ranges = [(e.time_range.start, e.time_range.end) for e in events
                  if e.name == name and e.device_type == cpu]
        if not ranges:
            continue
        inside = [d for d in device if any(a <= d.time_range.start < b for a, b in ranges)]
        host_us = sum(b - a for a, b in ranges)
        dev_us = sum(d.time_range.elapsed_us() for d in inside)
        out[name] = dict(calls=len(ranges) / reps, host_ms=host_us / 1e3 / reps,
                         device_ms=dev_us / 1e3 / reps, device_events=len(inside) / reps,
                         busy_share=dev_us / host_us if host_us else None)
    return out


def keyframe_breakdown(kern, w, host, reps):
    """Per-call host ms, device ms, device events and busy share of ba_step,
    marg_step and their stages (see the module docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from pvio_torch.estimation import ba as ba_mod

    stages = [
        (kern, "attach_deltas", "re-integration (attach_deltas)"),
        (ba_mod, "linearize", "linearize"),
        (ba_mod, "_schur_solve", "Schur + Cholesky"),
        (ba_mod, "_retract_cost", "retract + evaluate_cost"),
        (kern, "_escape", "plane-track escape"),
        (ba_mod, "post_solve_update", "post-solve update"),
        (kern, "_fresh_geometry", "triangulation + baselines + landmarks"),
        (kern, "marginalize0", "rebase + Schur + eigh (marginalize0)"),
    ]
    w_dev = cs.to_device(w, kern.device)
    steps = {"ba_step": lambda: kern.ba_step(w_dev, *host["imu_ops"], host["track_life"], False),
             "marg_step": lambda: kern.marg_step(w_dev, *host["imu_ops"])}
    for fn in steps.values():                  # warm-up
        fn()
    labels = [name for _, _, name in stages]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in stages]
    for obj, attr, name in stages:
        setattr(obj, attr, _labelled(name, getattr(obj, attr)))
    result = {}
    try:
        for step, fn in steps.items():
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    _labelled(step, fn)()
            result[step] = _attribute(prof.events(), [step] + labels, reps,
                                      exclude=set(labels) | set(steps))
    finally:
        for obj, attr, fn in saved:
            if obj is kern:
                delattr(kern, attr)
            else:
                setattr(obj, attr, fn)
    return result


def chain_breakdown(cfg, B):
    """The multi-sequence chain unbatched (one sequence) and vmapped over B
    sequences, each run once after a warm-up run, inside a torch.profiler
    trace (see the module docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from pvio_torch.core.kernels import DeviceKernels
    from pvio_torch.ops import poisson, stencil
    from pvio_torch.parallel import multi_seq

    kern = DeviceKernels(cfg)
    inputs = [multi_seq.build_sequence_inputs(cfg, kern, cs.MS_GROUPS * cs.MS_KF_EVERY,
                                              seed=648 + 31 * i) for i in range(B)]
    ws, arrays = [w for w, _ in inputs], [a for _, a in inputs]
    chain = multi_seq.make_chain(kern, cfg, cs.MS_GROUPS, cs.MS_KF_EVERY)
    zero = torch.zeros((), dtype=kern.dtype, device=kern.device)
    arrays0 = multi_seq.upload_arrays(kern, arrays[0])
    runs = {"unbatched (1 sequence)": lambda: chain(ws[0], arrays0, zero),
            f"vmapped ({B} sequences)": lambda: multi_seq.run_batched(
                kern, cfg, ws, arrays, cs.MS_GROUPS, cs.MS_KF_EVERY)}
    out = {}
    for name, fn in runs.items():
        fn()                                   # warm-up
        torch.cuda.synchronize()
        stencil.LAUNCHES = poisson.LAUNCHES = 0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
        out[name] = dict(wall_ms=wall_ms, device_ms=dev_ms, device_events=len(dev),
                         busy_share=dev_ms / wall_ms, k1_launches=stencil.LAUNCHES,
                         s1_launches=poisson.LAUNCHES)
    return out


def facade_breakdown():
    """One tracked frame's and one keyframe frame's track_camera call of
    the planes-on facade, stage by stage (see the module docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from pvio_torch import PVIO
    from pvio_torch.core import plane_extractor as pe_mod

    cfg = cs.facade_config(fused_keyframe=True, enable_plane_constraint=True)
    scene, images = cs.facade_inputs(cfg)
    vio = PVIO(cfg)
    core = vio.core
    stages = ["FeatureTracker.dispatch_frame", "FeatureTracker.finish_frame",
              "SlidingWindowTracker.track_dispatch", "SlidingWindowTracker.track_finish"]
    plane_stages = {"promote_pending": "plane: promote_pending", "extend_planes":
                    "plane: extend_planes", "issue_detection": "plane: issue_detection",
                    "merge_planes": "plane: merge_planes",
                    "update_parameters": "plane: update_parameters"}
    inner = (["frame_step", "pnp_step", "keyframe step (kf_step)", "plane: find_plane"]
             + list(plane_stages.values()))
    kern = core.kernels
    for attr, name in (("frame_step", "frame_step"), ("frame_step_nodetect", "frame_step"),
                       ("pnp_step", "pnp_step"), ("kf_step", "keyframe step (kf_step)")):
        setattr(kern, attr, _labelled(name, getattr(kern, attr)))
    find_plane = pe_mod.ransac_mod.find_plane
    pe_mod.ransac_mod.find_plane = _labelled("plane: find_plane", find_plane)
    make = core.frontend._pef

    def factory():
        pe = make()
        for attr, name in plane_stages.items():
            setattr(pe, attr, _labelled(name, getattr(pe, attr)))
        return pe
    core.frontend._pef = factory
    ft = core.feature_tracker
    ft.dispatch_frame = _labelled(stages[0], ft.dispatch_frame)
    ft.finish_frame = _labelled(stages[1], ft.finish_frame)
    out, warm, fi = {}, 0, 0
    try:
        for k in range(len(scene.imu_t)):
            t = scene.imu_t[k]
            vio.track_gyroscope(t, *scene.gyro[k])
            vio.track_accelerometer(t, *scene.accel[k])
            while fi < len(scene.frame_t) and scene.frame_t[fi] <= t:
                swt = core.frontend.swt
                # trace the tracked call early, the keyframe call once the
                # window holds a plane (so every plane stage has work)
                wanted = swt is not None and warm >= 2 and (
                    "tracking" not in out or ("keyframe" not in out and swt.hw.plane_mask.any()))
                if not wanted:
                    if swt is not None:
                        warm += 1
                    vio.track_camera(scene.frame_t[fi], images[fi])
                    fi += 1
                    continue
                if "track_dispatch" not in vars(swt):
                    swt.track_dispatch = _labelled(stages[2], swt.track_dispatch)
                    swt.track_finish = _labelled(stages[3], swt.track_finish)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    _labelled("track_camera", vio.track_camera)(scene.frame_t[fi], images[fi])
                fi += 1
                names = ["track_camera"] + stages + inner
                rec = _attribute(prof.events(), names, 1, exclude=set(names))
                kind = "keyframe" if "keyframe step (kf_step)" in rec else "tracking"
                if kind in out:
                    continue
                outside = rec["track_camera"]["host_ms"] - sum(
                    rec[n]["host_ms"] for n in stages if n in rec)
                rec["Core bookkeeping (outside the four above)"] = dict(
                    calls=1.0, host_ms=outside, device_ms=0.0, device_events=0.0, busy_share=None)
                for label, parts in (("plane: promote_pending + extend_planes",
                                      ("plane: promote_pending", "plane: extend_planes")),
                                     ("plane: merge_planes + update_parameters",
                                      ("plane: merge_planes", "plane: update_parameters"))):
                    got = [rec[n] for n in parts if n in rec]
                    if got:
                        rec[label] = {f: sum(g[f] for g in got) for f in
                                      ("calls", "host_ms", "device_ms", "device_events")}
                hw = core.frontend.swt.hw if core.frontend.swt else None
                out[kind] = dict(frame=fi - 1, stages=rec,
                                 planes=int(hw.plane_mask.sum()) if hw is not None else 0)
            if len(out) == 2:
                break
    finally:
        pe_mod.ransac_mod.find_plane = find_plane
    if len(out) < 2:
        raise RuntimeError(f"facade_breakdown: traced only {sorted(out)} (no keyframe call with a "
                           f"plane in the window)")
    return out


if __name__ == "__main__":
    sys.exit(main())

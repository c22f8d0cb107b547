"""The golden hard mode's spread on the card: planes on against planes off
over several room textures, and gap G1's check (kernel K1 against the
plain Shi-Tomasi response at float64 on the hard-mode frames).

    python3 golden_spread.py --seeds 7 1 2 [--dtype float64] [--plain-response] [--cpu]
    python3 golden_spread.py --response-check [--frames 0 59 60 120 239] [--response-long]

Each run goes through the card test's `golden` helper
(`tests/test_torch_golden_card.py`) with its hard-mode flags
(`HARD_MODE`: pixel noise sigma 8 after a clean 3 s, 100 keypoints, a 4 px
gate, keypoint sigma 1.5 px, a noisy IMU) and `--texture-seed`, planes on
and then planes off over the same frames, and prints one JSON line a run
(`spread {...}`: texture seed, dtype, planes, ATE, first quarter, scale,
poses, re-inits, planes held, initialization frame, seconds).
`--plain-response` takes the plain version (`frontend.detect.
shi_tomasi_response`, which computes at the image's dtype) where the
engine launches K1 (the same function at the image's dtype since fault F7's
repair; before it, K1 computed in float32). `--response-check` holds
K1's response to the plain version's on the preprocessed hard-mode frames
(`--response-long`: the 60 s endurance frames) at float64 and compares the
detections each gives, for K1 on the image and on its float32 cast (`f32_`
keys: K1's arithmetic at float64 before fault F7's repair; `check {...}`
lines; the frames are rendered alone, so their noise stream starts at the
first noisy frame given).
Without a card it stops unless given `--cpu`.

    python3 golden_spread.py --long [--dtype float64] [--no-planes] [--cpu [--emulate-card]]
    python3 golden_spread.py --twin-from 44 [--dtype float64] [--no-planes]

`--long` runs the 60 s endurance case of the card test
(`long_horizon_run`, `LONG_HORIZON`, its frame cache) and prints its
record as one JSON line (`long {...}`), with the landmark-starvation
backstop's decision at every keyframe of the run. With `--cpu
--emulate-card` the CPU engine takes the card's algorithms where its plain
versions differ (`emulate_card`): K1's response at its compute dtype, E1's
and E2's Jacobi (`ops/eigh.py::jacobi_model`) for `torch.linalg.eigh`, and
the card's struct-of-arrays preintegration bank in the BA. `--twin-from T`
runs that case on the card and, from the first call at or after T s, a
twin of its tracker on the CPU (with E1, E2 and the bank emulated) that
tracks the card's own raw frames: at each call both backstops' records,
the largest |dp| between the two windows and the fields of the windows
whose discrete values differ (`twin {...}` lines, and a `twin-summary`
line naming the first call at which a discrete field differs). When the
card declares tracking lost the twin must too; at the card's next
initializing call the twin starts again from the card's window.

    python3 golden_spread.py --long --raw-out RAW.json [--imu-seed S --imu-eps E]
        [--plain-response] [--commit SHA] [--program TEXT]

`--imu-seed S --imu-eps E` multiplies every IMU sample of the scene by
1 + E * u (`perturb_imu`; E as a number or as `2**-52`), fault F7's
rounding-level perturbation. `--raw-out` writes the run's raw record (its
trajectory, the frontend's losses and initializations, the backstop's
decision at every keyframe, the card's `nvidia-smi` name and power limit,
`--commit` and `--program`, a note of what the tree holds beyond the commit)
for `tests/test_torch_f7_ensemble.py::f7_record`. `--plain-response`, a
diagnostic of this process only, puts K1's plain version where the engine
launches K1, for `--long` as for `--seeds` (F7's swap: the first of K1, E1
and E2, S1 that the decision called for, and the one that named K1).
`--record-from T [--record-out PATH]` records the card's run from T s (its
raw frames, its tracker's state at T and at each re-initialization, the
backstop's records) for `tests/test_torch_long_horizon_full.py::
test_reference_replays_the_card`, which replays the reference's tracker
on the card's own inputs on the CPU.
"""

import argparse
import contextlib
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


def response_check(frames, device, flags=None):
    """K1 against the plain response on the preprocessed level-0 images of
    the hard-mode frames (or the frames of golden_run `flags`; float64
    engine), and the detections of each; also K1 on the float32 cast of
    the image (its arithmetic at float64 before fault F7's repair)."""
    import torch

    from pvio_torch import golden_run
    from pvio_torch.core.kernels import DeviceKernels
    from pvio_torch.frontend import detect
    from pvio_torch.ops import stencil
    from tests import test_torch_golden_card as card

    args = golden_run.parse_args(flags or card.HARD_MODE + ["--dtype", "float64"])
    cfg, scene = golden_run.build_config(args), golden_run.make_scene(args)
    images = golden_run.render_images(scene, cfg, args, frames=frames)
    kern = DeviceKernels(cfg, device=device)
    for fi, img in zip(frames, images):
        lvl0 = kern.preprocess(img)[0].contiguous()
        r_plain = detect.shi_tomasi_response(lvl0)
        kw = dict(max_keypoints=cfg.feature_tracker_max_keypoint_detection,
                  min_distance=cfg.feature_tracker_min_keypoint_distance, border=20)
        xy2, m2 = detect.detect_keypoints(lvl0, response=r_plain, **kw)
        out = dict(frame=fi, noisy=bool(scene.frame_t[fi] >= args.noise_after),
                   dtype=str(lvl0.dtype), resp_max=float(r_plain.abs().max()))
        for tag, img in (("", lvl0), ("f32_", lvl0.to(torch.float32))):
            r_k1 = stencil.shi_tomasi_response(img).to(lvl0.dtype)
            xy1, m1 = detect.detect_keypoints(lvl0, response=r_k1, **kw)
            both = m1 & m2
            out.update({
                tag + "resp_max_abs_diff": float((r_k1 - r_plain).abs().max()),
                tag + "detected": (int(m1.sum()), int(m2.sum())),
                tag + "same_slots": bool(torch.equal(m1, m2)),
                tag + "slot_diffs": int((m1 != m2).sum()),
                tag + "max_dxy_px": float((xy1[both] - xy2[both]).abs().max())
                if bool(both.any()) else 0.0})
        print("check " + json.dumps(out), flush=True)


def jacobi_eigh(A):
    """`ops.eigh.eigh` with the card's algorithms on CPU tensors: E1's
    Jacobi (`jacobi_model` at n = 4, a batch at a time: a matrix stops at
    the sweep where the model stops), E2's for 5 <= n <= N_MAX (one matrix
    at a time), `torch.linalg.eigh` for any other n; CUDA tensors go to the
    real wrapper."""
    import torch

    from pvio_torch.ops import eigh as eigh_op

    if A.is_cuda:
        return _REAL_EIGH(A)
    n = A.shape[-1]
    if n == eigh_op.N:
        S = A.to(torch.float64).reshape(-1, n, n)
        S = torch.tril(S) + torch.tril(S, -1).mT
        VT = torch.eye(n, dtype=torch.float64).expand_as(S).clone()
        active, sweeps = ~eigh_op._converged(S), 0
        while bool(active.any()) and sweeps < eigh_op.MAX_SWEEPS:
            S2, VT2 = eigh_op._sweep(S, VT)
            S = torch.where(active[:, None, None], S2, S)
            VT = torch.where(active[:, None, None], VT2, VT)
            sweeps += 1
            active &= ~eigh_op._converged(S)
        L, order = torch.sort(torch.diagonal(S, 0, -2, -1), dim=-1, stable=True)
        V = torch.gather(VT, 1, order[:, :, None].expand_as(VT)).mT
    elif 5 <= n <= eigh_op.N_MAX:
        out = [eigh_op.jacobi_model(a)[:2] for a in A.reshape(-1, n, n)]
        L, V = torch.stack([x for x, _ in out]), torch.stack([v for _, v in out])
    else:
        return torch.linalg.eigh(A)
    return L.reshape(A.shape[:-1]).to(A.dtype), V.reshape(A.shape).to(A.dtype)


_REAL_EIGH = None


def emulate_card(response=True):
    """Patch this process's CPU paths to the card's algorithms: E1 and E2
    (`jacobi_eigh`) for `ops.eigh.eigh`, every new engine's BA on the card's
    preintegration bank (the struct-of-arrays `estimation/preint_soa.py`)
    and, with `response`, K1's response computed at `stencil.compute_dtype`
    of the image (the launcher casts any other dtype to float32 and the
    response back) for `ops.stencil.shi_tomasi_response`. The initializer's
    two-view DLT keeps `torch.linalg.eigh`, as on the card."""
    global _REAL_EIGH
    import torch

    from pvio_torch.core import kernels
    from pvio_torch.frontend import detect
    from pvio_torch.ops import eigh as eigh_op
    from pvio_torch.ops import stencil

    _REAL_EIGH = eigh_op.eigh
    eigh_op.eigh = jacobi_eigh
    init = kernels.DeviceKernels.__init__

    def init_on_card_bank(self, *a, **k):
        init(self, *a, **k)
        self.ba_cfg = self.ba_cfg._replace(fused_preint=True)
        self.ba_cfg_vo = self.ba_cfg_vo._replace(fused_preint=True)

    kernels.DeviceKernels.__init__ = init_on_card_bank
    if response:
        def response_as_k1(img):
            H, W = img.shape[-2:]
            flat = img.reshape(-1, H, W).to(stencil.compute_dtype(img.dtype))
            out = torch.stack([detect.shi_tomasi_response(x) for x in flat])
            return out.reshape(img.shape).to(img.dtype)

        stencil.shi_tomasi_response = response_as_k1


def perturb_imu(scene, seed, eps):
    """`scene` (either package's `SyntheticScene`) with every gyroscope and
    accelerometer sample multiplied by 1 + eps * u, u uniform in [-1, 1)
    from `numpy.random.default_rng(seed)` (gyroscope first); times, poses
    and frames are the scene's own."""
    import numpy as np

    rng = np.random.default_rng(seed)
    gyro = scene.gyro * (1.0 + eps * rng.uniform(-1.0, 1.0, np.shape(scene.gyro)))
    accel = scene.accel * (1.0 + eps * rng.uniform(-1.0, 1.0, np.shape(scene.accel)))
    return scene._replace(gyro=gyro, accel=accel)


def long_flags(dtype, planes):
    from tests import test_torch_golden_card as card

    return card.LONG_HORIZON + ["--dtype", dtype] + ([] if planes else ["--no-planes"])


def _to_cpu(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_cpu(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    return x


def cpu_twin(swt, kern_cpu):
    """A copy of a card tracker on the CPU engine `kern_cpu`: its window,
    counters and plane extractor deep-copied with every tensor moved to the
    CPU; it shares the card's raw-frame book and Config."""
    import copy

    import torch

    twin = copy.deepcopy(swt, {id(swt.k): kern_cpu, id(swt.ft): swt.ft, id(swt.cfg): swt.cfg})
    for obj in (twin.hw, twin.planes):
        if obj is not None:
            for k, v in vars(obj).items():
                setattr(obj, k, _to_cpu(v))
    twin.hw.device = torch.device("cpu")
    return twin


DISCRETE = ("frame_id", "keyframe", "frame_mask", "track_id", "track_mask", "track_flags",
            "ref_frame", "obs_mask", "plane_id", "plane_mask", "plane_ids")


def window_diff(a, b):
    """The fields of two trackers' windows whose discrete values differ
    ({name: entries}), and the largest |dp| (m) over the frames both hold
    and |d inv_depth| over the columns both hold as valid."""
    import numpy as np

    ha, hb = a.hw, b.hw
    out = {name: int((np.asarray(getattr(ha, name)) != np.asarray(getattr(hb, name))).sum())
           for name in DISCRETE}
    out = {k: v for k, v in out.items() if v}
    fm = ha.frame_mask & hb.frame_mask
    both = ha.track_mask & hb.track_mask & (ha.track_flags != 0) & (hb.track_flags != 0)
    return out, (float(np.abs(ha.p[fm] - hb.p[fm]).max()) if fm.any() else 0.0,
                 float(np.abs(ha.inv_depth[both] - hb.inv_depth[both]).max()) if both.any()
                 else 0.0)


def long_engine(dtype, planes, device):
    """The endurance case's engine on `device`, its scene and a function
    that drives it over the first `n_frames` frames of the card tests'
    render (`LONG_CACHE`), calling `on_frame(fi)` after each."""
    from pvio_torch import PVIO, golden_run
    from tests import test_torch_golden_card as card

    args = golden_run.parse_args(long_flags(dtype, planes))
    cfg, scene = golden_run.build_config(args), golden_run.make_scene(args)
    args.cache_images = f"{card.LONG_CACHE}_{golden_run.frames_key(args, scene)}.npz"
    images = golden_run.load_or_render(scene, cfg, args)
    vio = PVIO(cfg, device=device)

    def run(on_frame, n_frames=None):
        golden_run.drive(vio, scene, golden_run.image_source(images, scene, cfg, args),
                         on_frame=on_frame, n_frames=n_frames)

    return vio, scene, run


@contextlib.contextmanager
def followed(vio):
    """Follow the port's engine `vio` while the block drives it. Yields a
    record whose `raw` keeps every raw frame its feature tracker finishes,
    whose `log` keeps every decision of the landmark-starvation backstop
    (`health_log` of `pvio_torch.core.swt`: any port tracker's, so a caller
    that runs another one deletes its records), and whose `after_call()`,
    called after each of the engine's calls, returns what the call did:
    its kind ("init": a new window; "lost": tracking declared lost;
    "state": tracking; None: not initialized) and the backstop's records
    of the call."""
    from types import SimpleNamespace

    from pvio_torch.core import swt as swt_mod
    from tests.test_torch_golden_card import health_log

    ft, fw = vio.core.feature_tracker, vio.core.frontend
    run, finish = SimpleNamespace(raw=[]), ft.finish_frame
    seen = dict(swt=None, lost=0, mark=0)

    def finish_frame(handle, fetched=None):
        run.raw.append(finish(handle, fetched))
        return run.raw[-1]

    def after_call():
        if fw.n_reinits > seen["lost"]:
            kind = "lost"
        elif fw.swt is not None:
            kind = "init" if fw.swt is not seen["swt"] else "state"
        else:
            kind = None
        seen.update(swt=fw.swt, lost=fw.n_reinits)
        health, seen["mark"] = run.log[seen["mark"]:], len(run.log)
        return kind, health

    run.after_call = after_call
    ft.finish_frame = finish_frame
    try:
        with health_log(swt_mod) as run.log:
            yield run
    finally:
        del ft.finish_frame


def twin_run(dtype, planes, from_t, device="cuda", n_frames=None):
    """The card's endurance run with a CPU twin of its tracker from `from_t`
    (see the module's docstring), over the first `n_frames` frames (all by
    default); prints a `twin` line a call and a `twin-summary` line.
    `device` is the engine the twin copies ("cpu" rehearses the tool: a
    twin of a CPU engine with the same algorithms must never part)."""
    from pvio_torch.core.kernels import DeviceKernels

    emulate_card(response=False)
    vio, scene, run = long_engine(dtype, planes, device)
    kern_cpu = DeviceKernels(vio.config, device="cpu")
    st = dict(twin=None, first=None)

    def on_frame(fi):
        kind, card_h = card.after_call()
        swt, twin, t = vio.core.frontend.swt, st["twin"], float(scene.frame_t[fi])
        if twin is not None:
            mark = len(card.log)
            ok = twin.track(card.raw[-1])
            twin_h = card.log[mark:]
            del card.log[mark:]
            row = dict(fi=fi, t=t, card=card_h, twin=twin_h, card_lost=kind == "lost",
                       twin_lost=not ok)
            if ok and swt is not None:
                row["fields"], (row["dp"], row["dinv"]) = window_diff(swt, twin)
            if not ok or kind == "lost":
                st["twin"] = None
            apart = row.get("fields") or (kind == "lost") != (not ok) or card_h != twin_h
        elif t >= from_t and swt is not None:
            st["twin"] = cpu_twin(swt, kern_cpu)
            row, apart = dict(fi=fi, t=t, seeded=True, card=card_h), False
        else:
            return
        if st["first"] is None and apart:
            st["first"] = row
        print("twin " + json.dumps(row), flush=True)

    t0 = time.perf_counter()
    with followed(vio) as card:
        run(on_frame, n_frames)
    print("twin-summary " + json.dumps(dict(
        dtype=dtype, planes=planes, from_t=from_t, reinits=vio.core.frontend.n_reinits,
        initialized=vio.initialized, poses=len(vio.get_trajectory()),
        twin_initialized=st["twin"] is not None, first_apart=st["first"],
        seconds=time.perf_counter() - t0)), flush=True)


def window_fields(hw):
    """Every field of a (reference or port) HostWindow as numpy values, the
    prior as a dict of its fields (the input of `HostWindow.from_arrays`)."""
    import numpy as np

    out = {}
    for name, v in vars(hw).items():
        if name in ("F", "T", "P", "dtype", "device"):
            continue
        if name == "prior":
            v = {f: np.array(x.cpu().numpy() if hasattr(x, "cpu") else x)
                 for f, x in zip(v._fields, v)}
        elif isinstance(v, np.ndarray):
            v = v.copy()
        elif isinstance(v, list):
            v = [None if x is None else np.array(x) for x in v]
        elif isinstance(v, dict):
            v = dict(v)
        out[name] = v
    return out


COUNTERS = ("skipped_frames", "n_keyframes", "unhealthy_keyframes", "peak_valid", "_fresh_tri",
            "latest_state")


def tracker_fields(swt):
    """A tracker's counters and its plane extractor's state (key, next plane
    id, polar extents as (center, basis, radii), pending detection), as
    plain values."""
    import copy

    import numpy as np

    pe = swt.planes
    return dict(
        counters={k: copy.deepcopy(getattr(swt, k)) for k in COUNTERS},
        planes=None if pe is None else dict(
            key=np.asarray(pe._key).copy(), next_plane_id=pe.next_plane_id,
            areas={int(k): (a.center.copy(), a.basis.copy(), a.radii.copy())
                   for k, a in pe.areas.items()},
            pending=copy.deepcopy(pe._pending)))


def record_run(dtype, planes, from_t, out, device="cuda", n_frames=None):
    """The card's endurance run, recorded from the first call at or after
    `from_t` s into the pickle `out`: each call's raw frame, what the call
    did ("seed": the tracker's window, counters and plane extractor after
    it; "state"; "lost"; "init": the new window; "before": uninitialized),
    the backstop's records and the newest position. `tests/
    test_torch_long_horizon_full.py::test_reference_replays_the_card`
    replays the reference's tracker on it."""
    import pickle

    import numpy as np
    import torch

    vio, scene, run = long_engine(dtype, planes, device)
    calls = []

    def on_frame(fi):
        kind, health = card.after_call()
        swt, t = vio.core.frontend.swt, float(scene.frame_t[fi])
        if not calls and (t < from_t or swt is None):
            return
        r = card.raw[-1]
        row = dict(fi=fi, t=t, health=health, raw=dict(
            id=r.id, t=r.t, kp=np.array(r.kp), kp_mask=np.array(r.kp_mask),
            track_ids=np.array(r.track_ids), imu_ts=np.array(r.imu_ts),
            imu_w=np.array(r.imu_w), imu_a=np.array(r.imu_a)))
        if not calls:
            row.update(kind="seed", window=window_fields(swt.hw), **tracker_fields(swt))
        elif kind == "init":
            row.update(kind="init", window=window_fields(swt.hw))
        else:
            row["kind"] = kind or "before"
        if swt is not None:
            row["p"] = np.array(swt.latest_state[2])
        calls.append(row)

    with followed(vio) as card:
        run(on_frame, n_frames)
    meta = dict(dtype=dtype, planes=planes, from_t=from_t, reinits=vio.core.frontend.n_reinits,
                initialized=vio.initialized, poses=len(vio.get_trajectory()),
                device=torch.cuda.get_device_name(0) if device == "cuda" else device)
    with open(out, "wb") as f:
        pickle.dump(dict(meta=meta, calls=calls), f)
    print("record " + json.dumps(dict(meta, out=out, calls=len(calls))), flush=True)


def _eps(text):
    return 2.0 ** float(text[3:]) if text.startswith("2**") else float(text)


def long_run(args, device, swaps):
    """`--long`: the endurance case, its `long` line, and with `--raw-out`
    the raw run that `tests/test_torch_f7_ensemble.py::f7_record` reads."""
    import subprocess

    import torch

    from tests import test_torch_f7_ensemble as f7
    from tests import test_torch_golden_card as card

    t0 = time.perf_counter()
    vio, _, _, out = card.long_horizon_run(device, args.dtype, not args.no_planes,
                                          health_from=0.0)
    seconds = time.perf_counter() - t0
    out.update(emulate_card=args.emulate_card, swap=swaps, imu_seed=args.imu_seed,
               imu_eps=args.imu_eps, seconds=seconds)
    print("long " + json.dumps(out), flush=True)
    if args.raw_out:
        smi = None
        if device == "cuda":
            smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True).stdout.strip().splitlines()[0]
        raw = f7.raw_run("pvio_torch", device, args.imu_eps, args.imu_seed, vio, out["events"],
                         out["health"], init_fi=out["init_fi"], swap=swaps, card=smi,
                         commit=args.commit or f7.tree_commit(), program=args.program,
                         seconds=seconds,
                         dtype=args.dtype, planes=not args.no_planes,
                         torch=torch.__version__)
        with open(args.raw_out, "w") as f:
            json.dump(raw, f)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--dtype", default="float64")
    ap.add_argument("--plain-response", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--response-check", action="store_true")
    ap.add_argument("--frames", type=int, nargs="*", default=[0, 59, 60, 120, 239])
    ap.add_argument("--response-long", action="store_true")
    ap.add_argument("--long", action="store_true")
    ap.add_argument("--no-planes", action="store_true")
    ap.add_argument("--emulate-card", action="store_true")
    ap.add_argument("--twin-from", type=float, default=None)
    ap.add_argument("--record-from", type=float, default=None)
    ap.add_argument("--record-out", default=".artifacts/card_record.pkl")
    ap.add_argument("--imu-seed", type=int, default=None)
    ap.add_argument("--imu-eps", type=_eps, default=0.0)
    ap.add_argument("--raw-out", default=None)
    ap.add_argument("--commit", default=None)
    ap.add_argument("--program", default=None)
    args = ap.parse_args(argv)
    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("golden_spread: no CUDA card; pass --cpu to run on the CPU", file=sys.stderr)
        return 2
    device = "cpu" if args.cpu else "cuda"
    if args.emulate_card:
        if not args.cpu:
            print("golden_spread: --emulate-card emulates the card on the CPU: pass --cpu",
                  file=sys.stderr)
            return 2
        emulate_card()
    swaps = None
    if args.plain_response:
        from pvio_torch.frontend import detect
        from pvio_torch.ops import stencil

        stencil.shi_tomasi_response = detect.shi_tomasi_response
        swaps = "K1"
    if args.imu_eps:
        from pvio_torch import golden_run

        make_scene = golden_run.make_scene
        golden_run.make_scene = lambda a: perturb_imu(make_scene(a), args.imu_seed,
                                                      args.imu_eps)
    if args.long:
        long_run(args, device, swaps)
    if args.record_from is not None:
        record_run(args.dtype, not args.no_planes, args.record_from, args.record_out, device)
    if args.twin_from is not None:
        twin_run(args.dtype, not args.no_planes, args.twin_from)
    if args.response_check:
        response_check(args.frames, device,
                       long_flags(args.dtype, True) if args.response_long else None)
    for seed in args.seeds:
        for planes in (True, False):
            rec = spread_run(seed, args.dtype, planes, device)
            rec["plain_response"] = args.plain_response
            print("spread " + json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

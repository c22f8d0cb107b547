"""The hard mode of the golden tier at the image tier: the port's `PVIO`
facade against the reference's feature tracker and sliding-window tracker
on noisy imagery with the reduced keypoint budget and the 4 px gate.

`tests/test_golden_run.py::test_golden_hard_mode_planes_beat_planes_off`
runs 480x752 EuRoC-shaped frames with pixel noise sigma 8 after a clean
initialization, a keypoint budget of 100 (the YAML's 150 cut by a third),
a 4 px forward-backward gate, keypoint sigma 1.5 px and a noisy IMU
(gyro 1e-3, accel 1e-2). Here the same overrides go onto `small_config`
(320x240, float64, planes off) with its budget of 60 cut by the same third
to 40, over the blob stream of `test_torch_facade_tracking.py`: 8-bit
frames, clean through the initializing frame (28) and noised with sigma 8
counts from NOISE_AFTER on, from `default_rng(NOISE_SEED)`.

`lockstep` holds the two packages together step by step on any
configuration and frames; `tests/test_torch_hard_mode_full.py` runs it at
the golden hard mode's own size and frames. `pvio_torch.PVIO(device="cpu")`
runs the whole stream. The reference's `FeatureTracker` tracks the same
images with the same IMU spans and must give the same raw frames (masks
and track ids identical, keypoints within 1e-9 px); its
`SlidingWindowTracker` (with a fresh `PlaneExtractor` when planes are on,
as the port's is at that point) starts from the port's initialized window
and must, after every call, have taken the same keyframes, agree with the
port's state within 1e-6 m and have made the same plane decisions
(`plane_state`: plane masks and ids, the tracks' plane ids and flags
identical; normals, distances and the planes' polar extents within 1e-8).
The reference's extractor builds its extents from the members with a
valid fresh triangulation, as the port's does
(`test_torch_planes.extent_from_valid_members`): the point of a member seen
from one window slot is undefined, and the two eigensolvers pick different
points of its ray. One compilation of the reference's path.

On noisy frames the KLT solve amplifies rounding: the two trackers left to
run free part by ~1e-12 px at the first noisy frame and by ~2e-8 px twenty
noisy frames later, growing ~1.5x a frame along each track (on the clean
frames they stay under 3e-12 px). So each frame the reference's tracker
starts from the port's keypoints of the frame before (`_kp_dev`, the
device-resident state its step chains on; masks and ids are its own and
are held identical), and each step is held to 1e-9 px.
"""

import contextlib
import copy
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np

from golden_spread import followed, tracker_fields, window_fields

from tests.test_torch_facade import drive
from tests.test_torch_facade_tracking import MAX_DP_M, MAX_KP_PX
from tests.test_torch_golden_card import health_log
from tests.test_torch_harness import small_config
from tests.test_torch_oracle_planes import MAX_PLANE_TOL, plane_state
from tests.test_torch_planes import copy_state, extent_from_valid_members
from tests.test_torch_oracle_pipeline import ref_window

from pvio_tpu.core.feature_tracker import FeatureTracker as RefFeatureTracker
from pvio_tpu.core.kernels import DeviceKernels as RefKernels
from pvio_tpu.core.plane_extractor import PlaneExtractor as RefExtractor
from pvio_tpu.core import swt as ref_swt
from pvio_tpu.core.swt import SlidingWindowTracker as RefSWT
from pvio_tpu.io.config import Config as RefConfig
from pvio_torch import PVIO
from pvio_torch.io import synthetic

NOISE_AFTER = 1.45     # s: frame 29, the first after the initializing frame
NOISE_SIGMA = 8.0      # 8-bit counts, as the golden hard mode
NOISE_SEED = 649
HARD = dict(feature_tracker_max_keypoint_detection=40, feature_tracker_fb_threshold=4.0,
            camera_noise_cov=np.eye(2) * 1.5 ** 2)
PLANE_DECISIONS = ("plane_mask", "plane_ids", "plane_id", "tf_plane")


def hard_config(cls=None):
    return small_config(cls, **HARD)


def hard_stream(duration=2.5):
    """The noisy-IMU blob scene and its 8-bit frames, noised from NOISE_AFTER."""
    scene = synthetic.make_scene(duration=duration, fps=20.0, imu_rate=200.0, n_points=320,
                                 seed=648, gyro_noise=1e-3, accel_noise=1e-2)
    cfg = hard_config()
    rng = np.random.default_rng(NOISE_SEED)
    images = []
    for fi in range(len(scene.frame_t)):
        u8f = synthetic.render_frame(scene, fi, cfg.K, cfg.image_size) * 255.0
        if scene.frame_t[fi] >= NOISE_AFTER:
            u8f = u8f + rng.normal(size=u8f.shape) * NOISE_SIGMA
        images.append(np.clip(u8f + 0.5, 0, 255).astype(np.uint8))
    return scene, images


def step_state(swt):
    """What the two trackers are held to after a call: the plane decisions
    and values (`plane_state`), the planes' polar extents, the whole latest
    state and the keyframes."""
    st = plane_state(swt)
    areas = {} if swt.planes is None else swt.planes.areas
    st.update(state=tuple(np.array(x) for x in swt.latest_state), n_keyframes=swt.n_keyframes,
              areas={int(k): np.concatenate([np.ravel(x) for x in a]) for k, a in areas.items()})
    return st


def ref_tracker(cfg_ref, kern, book, window, state=None):
    """A reference tracker on the raw-frame book `book`, holding a port
    window's fields and, given `state` (`golden_spread.tracker_fields` of a
    port tracker), that tracker's counters and plane extractor. Its
    extractor builds extents from valid members (`extent_from_valid_members`)."""
    planes = cfg_ref.enable_plane_constraint
    pe = extent_from_valid_members(RefExtractor(cfg_ref, kern)) if planes else None
    swt = RefSWT(cfg_ref, kern, ref_window(window), book, pe)
    if state is not None:
        for k, v in copy.deepcopy(state["counters"]).items():
            setattr(swt, k, v)
        if planes:
            st = state["planes"]
            copy_state(SimpleNamespace(
                _key=st["key"], next_plane_id=st["next_plane_id"], _pending=st["pending"],
                areas={s: SimpleNamespace(center=c, basis=b, radii=r)
                       for s, (c, b, r) in st["areas"].items()}), pe)
    return swt


def run_port_events(scene, images, cfg, full=False):
    """The port's facade at `cfg` over the scene's IMU and `images`:
    returns the engine, every raw frame, the calls' events {frame index:
    (kind, value)}, the backstop's records of each call {frame index:
    [`health_log` record, ...]} and, with `full`, the tracker's whole state
    after each call that leaves one ({frame index: its window's fields and
    `golden_spread.tracker_fields`}). The
    kinds: "init" at each initializing call (the window's fields), "lost"
    where tracking was declared lost, "state" after every other call while
    tracking (`step_state`)."""
    vio = PVIO(cfg, device="cpu")
    events, health, states = {}, {}, {}

    def after_call(fi):
        kind, health[fi] = port.after_call()
        swt = vio.core.frontend.swt
        if kind == "lost":
            events[fi] = ("lost", None)
        elif kind == "init":
            events[fi] = ("init", window_fields(swt.hw))
        elif kind == "state":
            events[fi] = ("state", step_state(swt))
        if full and swt is not None:
            states[fi] = dict(window=window_fields(swt.hw), **tracker_fields(swt))

    with followed(vio) as port:
        drive(vio, scene, images, after_call=after_call)
    return vio, port.raw, events, health, states


def parted(fi, kind, ok, a, b, port_health, ref_health):
    """Why the reference's call at frame `fi` parts from the port's (None if
    it does not): the backstops' records, the verdict, the keyframes, the
    plane decisions and extents, and the state within MAX_DP_M. `a` and `b`
    are the port's and the reference's `step_state`."""
    if ref_health != port_health:
        return f"frame {fi}: backstop {port_health} (port) vs {ref_health}"
    if kind == "lost":
        return None if not ok else f"frame {fi}: the port lost tracking, the reference did not"
    if not ok:
        return f"the reference lost tracking at frame {fi}"
    if a["t"] != b["t"] or a["n_keyframes"] != b["n_keyframes"]:
        return f"frame {fi}: keyframes {a['n_keyframes']} (port) vs {b['n_keyframes']}"
    for name in PLANE_DECISIONS:
        if not np.array_equal(a[name], b[name]):
            cols = np.nonzero(np.asarray(a[name]) != np.asarray(b[name]))[0]
            return (f"frame {fi}: {name} differs at {cols.tolist()}: "
                    f"{np.asarray(a[name])[cols].tolist()} (port) vs {np.asarray(b[name])[cols].tolist()}")
    if sorted(a["areas"]) != sorted(b["areas"]):
        return f"frame {fi}: extents {sorted(a['areas'])} (port) vs {sorted(b['areas'])}"
    dn = plane_gap(a, b)
    if dn > MAX_PLANE_TOL:
        return f"frame {fi}: plane values {dn:.3e} apart"
    dx = max(float(np.abs(x - np.asarray(y)).max()) for x, y in zip(a["state"][1:], b["state"][1:]))
    if dx > MAX_DP_M:
        return f"frame {fi}: state {dx:.3e} apart"
    return None


def plane_gap(a, b):
    """The largest of |dn|, |dd| and the extents' difference of two
    `step_state`s."""
    return max([float(np.abs(a[k] - b[k]).max()) for k in ("normal", "distance") if len(b[k])]
               + [float(np.abs(a["areas"][k] - b["areas"][k]).max()) for k in b["areas"]],
               default=0.0)


@contextlib.contextmanager
def plane_casts(swt):
    """While the block runs, record the reprojection errors the reference
    tracker `swt`'s plane extractor weighs in `extend_planes` (each track
    column cast onto each plane): yields a list that gets (columns, plane
    slots, errors (C, P) px) for each call."""
    casts, pe = [], swt.planes
    if pe is None:
        yield casts
        return
    real = pe._rpe_batch

    def recorded(hw, points, cols=None):
        out = real(hw, points, cols=cols)
        if cols is not None and np.ndim(points) == 3:
            casts.append((np.asarray(cols), np.nonzero(np.asarray(hw.plane_mask))[0],
                          np.array(out)))
        return out

    pe._rpe_batch = recorded
    try:
        yield casts
    finally:
        del pe._rpe_batch


def plane_margins(a, b, casts):
    """For each column whose plane differs between the port's and the
    reference's `step_state` (`a`, `b`): {column: (error cast onto the
    port's plane, onto the reference's)} in px, from the reference's last
    `extend_planes` weighing (`plane_casts`); None where it did not weigh
    the column on both planes."""
    if a is None or b is None or not casts:
        return {}
    cols, slots, err = casts[-1]
    out = {}
    for c in np.nonzero(np.asarray(a["plane_id"]) != np.asarray(b["plane_id"]))[0]:
        i = np.nonzero(cols == c)[0]
        j = [np.nonzero(slots == x["plane_id"][c])[0] for x in (a, b)]
        out[int(c)] = (None if len(i) == 0 or not all(len(x) for x in j)
                       else tuple(float(err[i[0], x[0]]) for x in j))
    return out


def lockstep(scene, images, cfg, cfg_ref, free_frontend=False, max_reinits=0, reseed=False,
             progress=None):
    """The port's facade at `cfg` over the scene's IMU and `images`, and the
    reference's trackers at `cfg_ref` held to it step by step (see the
    module's docstring); the first call that parts fails, naming its frame.
    Each keyframe the two backstops (`health_update`) must see the same
    valid landmarks, peak, floor and below-floor run and give the same
    verdict. Up to `max_reinits` times the port may declare tracking lost:
    the reference must do so at the same call, and at the port's next
    initializing call its tracker starts again from the port's window.
    With `reseed`, a call that parts is run again by a reference tracker
    started from the port's whole state after the call before (window,
    counters, plane extractor): if it then agrees, the parting came from
    the rounding carried into the call (a decision at a tie), the record
    keeps it in `reseeds` [(frame, why, margins)] and the reference goes
    on from there; if not, the call itself parts and the test fails.
    `margins` are the reference's errors of each column whose plane id
    parted, cast onto either plane (`plane_margins`).
    Returns the port's engine, the initializing frames (`inits`, the first
    as `init_fi`) and the frames where tracking was lost (`lost`), the
    keyframes, the largest |dp| (m) and the largest of |dn|, |dd| and the
    extents' difference after each tracked call, the largest keypoint gap
    (px) of each frame, the backstop's records [(frame, record)], and both
    trackers' states after each call from an initializing one on as
    trajectories [(t, q, p)]. With `free_frontend` a second reference
    `FeatureTracker` tracks the same frames left free, and the record adds
    its largest keypoint gap to the port's raw frames on each frame before
    their masks or ids first differ, and that frame (`free_parts`, None if
    they never do). `progress(fi, t, dp)`, if given, is called after each
    tracked call."""
    planes = cfg.enable_plane_constraint
    vio, raw, events, port_health, port_full = run_port_events(scene, images, cfg, full=reseed)
    inits = sorted(fi for fi, (kind, _) in events.items() if kind == "init")
    lost = sorted(fi for fi, (kind, _) in events.items() if kind == "lost")
    assert vio.initialized and inits
    assert len(lost) == vio.core.frontend.n_reinits <= max_reinits, lost
    assert len(raw) == len(images)

    kern = RefKernels(cfg_ref)
    ft = RefFeatureTracker(cfg_ref, kern)
    free = RefFeatureTracker(cfg_ref, kern) if free_frontend else None
    free_gap, free_parts = [], None

    swt, dp, dn, dkp, health, reseeds = None, [], [], [], [], []
    port_traj, ref_traj = [], []
    with health_log(ref_swt) as ref_health:
        for fi, rf in enumerate(raw):
            kind, val = events.get(fi, (None, None))
            if free is not None:
                f = free.track_frame(rf.id, rf.t, images[fi], rf.imu_ts, rf.imu_w, rf.imu_a)
                free.initialized = kind == "init" or (kind != "lost" and free.initialized)
                if (np.array_equal(f.kp_mask, rf.kp_mask)
                        and np.array_equal(f.track_ids, rf.track_ids)):
                    gap = np.abs(f.kp[f.kp_mask] - rf.kp[rf.kp_mask])
                    free_gap.append(float(gap.max()) if gap.size else 0.0)
                else:
                    free, free_parts = None, fi
            if fi > 0:
                ft._kp_dev = jnp.asarray(raw[fi - 1].kp)
            r = ft.track_frame(rf.id, rf.t, images[fi], rf.imu_ts, rf.imu_w, rf.imu_a)
            assert r.t == rf.t
            np.testing.assert_array_equal(r.kp_mask, rf.kp_mask, err_msg=f"frame {fi}")
            np.testing.assert_array_equal(r.track_ids, rf.track_ids, err_msg=f"frame {fi}")
            gap = np.abs(r.kp[r.kp_mask] - rf.kp[rf.kp_mask])
            dkp.append(float(gap.max()) if gap.size else 0.0)
            np.testing.assert_allclose(r.kp[r.kp_mask], rf.kp[rf.kp_mask], rtol=0,
                                       atol=MAX_KP_PX, err_msg=f"frame {fi}")
            if kind == "init":
                assert swt is None, f"frame {fi}: the port initialized while tracking"
                swt = ref_tracker(cfg_ref, kern, ft, val)
                ft.initialized = True
                t, q, p = swt.latest_state[:3]
                port_traj.append((t, np.array(q), np.array(p)))
                ref_traj.append((t, np.array(q), np.array(p)))
                continue
            if swt is None:
                continue

            def call(swt):
                mark = len(ref_health)
                with plane_casts(swt) as casts:
                    ok = swt.track(r)
                b = step_state(swt) if ok and kind != "lost" else None
                why = parted(fi, kind, ok, val, b, port_health[fi], ref_health[mark:])
                return ok, b, why, casts

            ok, b, why, casts = call(swt)
            if why is not None and reseed and fi - 1 in port_full:
                margins = plane_margins(val, b, casts)
                swt = ref_tracker(cfg_ref, kern, ft, port_full[fi - 1]["window"], port_full[fi - 1])
                ok, b, again, _ = call(swt)
                assert again is None, f"{why}; from the port's state before the call: {again}"
                reseeds.append((fi, why, margins))
            else:
                assert why is None, why
            health += [(fi, h) for h in port_health[fi]]
            if kind == "lost":
                swt, ft.initialized = None, False
                continue
            a = val
            dp.append(float(np.abs(a["p"] - np.asarray(b["p"])).max()))
            dn.append(plane_gap(a, b))
            if progress is not None:
                progress(fi, a["t"], dp[-1])
            port_traj.append((a["t"], a["state"][1], a["state"][2]))
            ref_traj.append((b["t"], np.array(b["state"][1]), np.array(b["state"][2])))
    assert swt.n_keyframes == vio.core.frontend.swt.n_keyframes
    return dict(vio=vio, init_fi=inits[0], inits=inits, lost=lost, n_keyframes=swt.n_keyframes,
                dp=dp, dn=dn, dkp=dkp, health=health, reseeds=reseeds, port_traj=port_traj,
                ref_traj=ref_traj, free_gap=free_gap, free_parts=free_parts)


def test_hard_mode_tracking_matches_reference_on_noisy_images():
    scene, images = hard_stream()
    run = lockstep(scene, images, hard_config(), hard_config(RefConfig))
    init_fi, n_noisy = run["init_fi"], len(run["dp"])
    assert scene.frame_t[init_fi] < NOISE_AFTER <= scene.frame_t[init_fi + 1]
    assert n_noisy >= 20 and run["n_keyframes"] >= 3
    dp = max(run["dp"])
    assert dp <= MAX_DP_M, dp
    print(f"hard mode vs the reference: initialized at frame {init_fi}, {n_noisy} noisy "
          f"frames after it, {run['n_keyframes']} keyframes, max |dp| {dp:.3e} m")

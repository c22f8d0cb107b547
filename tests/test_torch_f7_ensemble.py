"""Fault F7 against the reference's own rounding spread.

F7 is the 60 s float64 planes-on endurance run on the card
(`tests/test_torch_golden_card.py::test_golden_long_horizon_on_card`), which
ends with two health re-inits and not initialized where the reference's
test on the CPU ends with one. The card and the CPU part by rounding from
the initializing frame on, so the question is whether the reference's own
algorithm, under rounding of the same size or smaller, reaches the card's
outcome. This file answers it with an ensemble: the reference (`pvio_tpu`
itself, driven by its own test's helpers `_long_horizon_images` and
`_run_cached_images`) over the same scene, unperturbed and with every IMU
sample multiplied by 1 + eps * u (`golden_spread.perturb_imu`) at eps =
2^-52 and 2^-40, three seeds each; the port's run on the card comes from
`golden_spread.py --long --raw-out`. One function, `f7_record`, turns each
run into its record; `decide` applies the rule written before the runs:

  (i)  at least one perturbed reference run fails as the card does (not
       initialized at the end, or two re-inits or more);
  (ii) the card's first loss time, first re-init time, and first-30 s ATE
       and scale each lie within the ensemble's range (unperturbed and
       perturbed reference runs) widened by half its width on each side.

Both hold: F7 is the reference's behaviour under rounding at this
profile's edge. Either fails: the card runs again with one kernel swapped
for its plain version (K1's first, `golden_spread.py --plain-response`,
then E1 and E2's, then S1's); the first swap that lands inside names the
kernel, and a run of the repaired program is held to the same rule. The
committed summary is `tests/data/f7_ensemble.json`;
the tier-1 tests here hold the perturbation, the record and the verdict
that ROADMAP.md states to it. The ensemble itself is `verylong`:

    python -m tests.test_torch_f7_ensemble run --seed 1 --eps 2**-52   # one reference run
    python -m tests.test_torch_f7_ensemble summarize --card RAW.json    # the summary file

A reference run takes 23-27 minutes on two cores of an 8-core CPU with four
side by side (`taskset -c 0,1`, ...); it reads the reference test's frame
cache `.artifacts/golden60_<key>.npz` (rendered serially if missing, ~20
minutes); `run` writes its raw output to `.artifacts/f7/` and prints its
record.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUMMARY = os.path.join(ROOT, "tests", "data", "f7_ensemble.json")
RAW_DIR = os.path.join(ROOT, ".artifacts", "f7")
SEEDS = (1, 2, 3)
SPLIT_T = 44.0       # s: the float32-response card run's first loss; keyframes are counted before it
FIRST_T = 30.0       # s: the reference contract's first segment
# the unperturbed run, then three seeds at each level
RUNS = [(None, 0.0)] + [(s, e) for e in (2.0 ** -52, 2.0 ** -40) for s in SEEDS]


def _golden_spread():
    sys.path.insert(0, ROOT)
    import golden_spread

    return golden_spread


def scene_kwargs():
    """The endurance scene of tests/test_golden_run.py::
    test_golden_long_horizon_production_gates."""
    return dict(duration=60.0, fps=20.0, imu_rate=200.0, n_points=8, seed=648,
                init_ramp=0.3, long_profile=True)


def port_scene():
    from pvio_torch.io import synthetic

    return synthetic.make_scene(**scene_kwargs())


def tree_commit():
    try:
        return subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                              text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return None


def raw_run(package, device, eps, seed, vio, events, health, init_fi=None, **extra):
    """What a finished run leaves for `f7_record`, as JSON-able values: its
    trajectory as [t, x, y, z] rows, the frontend's events (`event_log`),
    every backstop record (`health_log`) and the end state."""
    traj = vio.get_trajectory()
    return dict(package=package, device=device, eps=eps, seed=seed,
                initialized=bool(vio.initialized), n_reinits=int(vio.core.frontend.n_reinits),
                init_fi=init_fi, traj=[[float(t)] + [float(x) for x in p] for (t, q, p) in traj],
                events=list(events), health=list(health), **extra)


def _pose_map(raw):
    return {round(r[0], 6): np.array(r[1:]) for r in raw["traj"]}


def f7_record(raw, scene, base=None):
    """Every run's record, the reference's and the port's alike, from
    `raw_run`'s output: the end state (initialized, re-inits, poses), the
    initializing frame, the times of each loss and each re-initialization,
    the first-30 s ATE and scale (`seg_ate` of the card test), the keyframes
    and the backstop's below-floor keyframes before SPLIT_T, the backstop's
    decision at every keyframe as [t, n_valid, floor, unhealthy, lost] rows,
    and, given the unperturbed run `base`, the largest |dp| (m) from it at
    its initializing frame and over the first 30 s."""
    from tests.test_torch_golden_card import seg_ate

    traj = [(r[0], None, np.array(r[1:])) for r in raw["traj"]]
    inits = [e["t"] for e in raw["events"] if e["kind"] == "init"]
    losses = [e["t"] for e in raw["events"] if e["kind"] == "lost"]
    init_fi = raw.get("init_fi")
    if init_fi is None and inits:
        init_fi = int(np.argmin(np.abs(np.asarray(scene.frame_t) - inits[0])))
    a, s, n = seg_ate(traj, scene, 0.0, FIRST_T)
    early = [h for h in raw["health"] if h["t"] < SPLIT_T]
    rec = {k: raw.get(k) for k in ("package", "device", "card", "eps", "seed", "commit",
                                   "program", "swap", "seconds")}
    rec.update(initialized=raw["initialized"], n_reinits=raw["n_reinits"],
               poses=len(raw["traj"]), init_fi=init_fi, init_t=inits[0] if inits else None,
               losses=losses, reinit_ts=inits[1:], first30_ate=a, first30_scale=s,
               first30_poses=n, kf_before_44=len(early),
               below_floor_before_44=sum(h["n_valid"] < h["floor"] for h in early),
               health=[[h["t"], h["n_valid"], h["floor"], h["unhealthy"], int(h["lost"])]
                       for h in raw["health"]])
    rec["dp_init"] = rec["dp_first30"] = None
    if base is not None and base is not raw:
        mine, theirs = _pose_map(raw), _pose_map(base)
        both = sorted(t for t in mine if t in theirs and t < FIRST_T)
        if both:
            rec["dp_first30"] = max(float(np.abs(mine[t] - theirs[t]).max()) for t in both)
        t0 = base["events"][0]["t"] if base["events"] else None
        if t0 is not None and round(t0, 6) in mine:
            rec["dp_init"] = float(np.abs(mine[round(t0, 6)] - theirs[round(t0, 6)]).max())
    return rec


def fails_as_card(rec):
    """The card test's first two assertions ("must end initialized", at most
    one health re-init) fail on this run."""
    return (not rec["initialized"]) or rec["n_reinits"] >= 2


def _first(xs):
    return xs[0] if xs else None


METRICS = (("first loss", lambda r: _first(r["losses"])),
           ("first re-init", lambda r: _first(r["reinit_ts"])),
           ("first-30 s ATE", lambda r: r["first30_ate"]),
           ("first-30 s scale", lambda r: r["first30_scale"]))


def widened_range(values):
    """The range of `values` widened by half its width on each side, or
    None when none is defined."""
    xs = [v for v in values if v is not None]
    if not xs:
        return None
    lo, hi = min(xs), max(xs)
    return lo - (hi - lo) / 2, hi + (hi - lo) / 2


def decide(records, card):
    """The rule of F7's decision on the reference's records (the unperturbed
    run first) and a card run's: (i) k of the N perturbed runs fail as the
    card run does, k >= 1 (for a card run that does not fail, a swap's, some
    perturbed run does not fail either); (ii) each of the card's METRICS
    lies in the ensemble's widened range (a time the card never reaches is
    inside only if some ensemble run never reaches it either). Returns the
    verdict's parts; `settled` when both hold."""
    perturbed = [r for r in records if r["eps"]]
    k = sum(fails_as_card(r) for r in perturbed)
    i_holds = k >= 1 if fails_as_card(card) else k < len(perturbed)
    inside = {}
    for name, get in METRICS:
        vals, mine = [get(r) for r in records], get(card)
        rng = widened_range(vals)
        if mine is None:
            inside[name] = dict(card=None, range=rng, inside=any(v is None for v in vals))
        else:
            inside[name] = dict(card=mine, range=rng,
                                inside=rng is not None and rng[0] <= mine <= rng[1])
    ii_holds = all(v["inside"] for v in inside.values())
    return dict(swap=card.get("swap"), k=k, n=len(perturbed), i=i_holds, ii=ii_holds,
                metrics=inside, settled=i_holds and ii_holds)


def verdict(data):
    """ROADMAP's sentence for the summary `data` (the card runs in order: the
    unperturbed run of the program as it was, the swap runs, then any run
    of a repaired program): settled by the first, or open with the first
    swap run that lands inside, if any, and whether the repaired program's
    run lands inside."""
    d = data["decisions"][0]
    head = f"{d['k']} of {d['n']} perturbed reference runs fail as the card does"
    if d["settled"]:
        return f"F7 verdict: the reference's behaviour, {head}"
    cards = data["card"][1:]
    swaps = [x for c, x in zip(cards, data["decisions"][1:]) if c["swap"]]
    named = next((x["swap"] for x in swaps if x["settled"]), None)
    out = (f"F7 verdict: outside the reference's spread, {head}; swap that brings the card "
           f"inside: {named or 'none'}")
    for c, x in zip(cards, data["decisions"][1:]):
        if c.get("program"):
            out += (f"; the repaired program ({c['program']}) lands "
                    f"{'inside' if x['settled'] else 'outside'}")
    return out


def reference_raw(seed, eps):
    """One run of the reference (`pvio_tpu`, float64, planes on) over the
    endurance scene with its IMU perturbed (`perturb_imu`; eps = 0 leaves it
    as it is), driven by its own test's helpers; the backstop and the
    frontend are followed through the card test's `health_log` and
    `event_log` on the reference's modules."""
    import jax

    jax.config.update("jax_enable_x64", True)
    from pvio_tpu import Config
    from pvio_tpu.core import frontend_worker, swt
    from pvio_tpu.io import synthetic
    from tests import test_golden_run as ref
    from tests.test_torch_golden_card import event_log, health_log

    t0 = time.perf_counter()
    cfg0 = Config.from_yaml(os.path.join(ROOT, "config", "euroc.yaml"))
    scene = synthetic.make_scene(**scene_kwargs())
    images = ref._long_horizon_images(cfg0, scene)
    if eps:
        scene = _golden_spread().perturb_imu(scene, seed, eps)
    cfg = Config.from_yaml(os.path.join(ROOT, "config", "euroc.yaml"))
    cfg.dtype = "float64"
    cfg.enable_plane_constraint = True
    with health_log(swt) as health, event_log(frontend_worker) as events:
        vio = ref._run_cached_images(cfg, scene, images)
    return raw_run("pvio_tpu", "cpu", eps, seed, vio, events, health, commit=tree_commit(),
                   seconds=time.perf_counter() - t0)


def raw_path(seed, eps):
    tag = "base" if not eps else f"s{seed}_e{int(round(-math.log2(eps)))}"
    return os.path.join(RAW_DIR, f"ref_{tag}.json")


def _load(path):
    with open(path) as f:
        return json.load(f)


def summarize(card_raws, out=SUMMARY):
    """The summary file from the reference's raw runs on disk and the card's
    raw runs (`golden_spread.py --long --raw-out`; the unperturbed one first,
    then any swap run)."""
    scene = port_scene()
    raws = [_load(raw_path(s, e)) for s, e in RUNS]
    base = raws[0]
    records = [f7_record(r, scene, base) for r in raws]
    cards = [f7_record(_load(p), scene, base) for p in card_raws]
    data = dict(scene=scene_kwargs(), dtype="float64", planes=True, imu_eps=[2.0 ** -52,
                2.0 ** -40], seeds=list(SEEDS), reference=records, card=cards,
                decisions=[decide(records, c) for c in cards])
    with open(out, "w") as f:
        json.dump(data, f, indent=1)
    return data


# ---------------------------------------------------------------- tier-1 tests

def _small_scenes():
    from pvio_tpu.io import synthetic as ref_synth
    from pvio_torch.io import synthetic as port_synth

    kw = dict(scene_kwargs(), duration=2.0)
    return ref_synth.make_scene(**kw), port_synth.make_scene(**kw)


@pytest.mark.parametrize("eps", [2.0 ** -52, 2.0 ** -40], ids=["ulp", "2^-40"])
def test_perturb_imu_is_seeded_and_bounded(eps):
    """perturb_imu is a function of its seed, moves each IMU sample by at most
    eps relative (plus the product's own rounding, half an ulp), leaves zero
    samples, times, poses and the other fields as they are, and perturbs
    both packages' scenes alike."""
    gs = _golden_spread()
    ref_scene, port_scene_ = _small_scenes()
    ref_scene = ref_scene._replace(gyro=ref_scene.gyro.copy())
    ref_scene.gyro[3] = 0.0
    a, b = gs.perturb_imu(ref_scene, 5, eps), gs.perturb_imu(ref_scene, 5, eps)
    c = gs.perturb_imu(ref_scene, 6, eps)
    for name in ("gyro", "accel"):
        x, y = getattr(ref_scene, name), getattr(a, name)
        assert np.array_equal(y, getattr(b, name))
        assert np.all(np.abs(y - x) <= eps * np.abs(x) + np.spacing(np.abs(x)) / 2)
        assert not np.array_equal(y, getattr(c, name))
        assert (y != x).mean() > 0.25, name
    assert np.all(a.gyro[3] == 0.0)
    for name in a._fields:
        if name not in ("gyro", "accel"):
            assert np.array_equal(np.asarray(getattr(a, name)),
                                  np.asarray(getattr(ref_scene, name))), name
    p = gs.perturb_imu(port_scene_, 5, eps)
    q = gs.perturb_imu(ref_scene._replace(gyro=port_scene_.gyro), 5, eps)
    assert np.array_equal(p.gyro, q.gyro) and np.array_equal(p.accel, a.accel)


def _fake_raw(eps, seed, losses, inits, initialized=True, shift=0.0):
    scene = port_scene()
    traj = [[float(t)] + list(map(float, scene.p_wb[i] + shift))
            for i, t in enumerate(scene.frame_t) if t >= inits[0]]
    events = sorted([dict(kind="init", t=t) for t in inits]
                    + [dict(kind="lost", t=t) for t in losses], key=lambda e: e["t"])
    health = [dict(t=float(t), n_valid=40 if t < 44 else 5, floor=15, unhealthy=0, lost=False)
              for t in np.arange(1.0, 60.0, 0.5)]
    return dict(package="pvio_tpu", device="cpu", eps=eps, seed=seed, initialized=initialized,
                n_reinits=len(losses), init_fi=None, traj=traj, events=events, health=health)


def test_f7_record_and_rule():
    """f7_record reads the events, the trajectory and the backstop's log as
    stated, and decide applies the rule: (i) counts the perturbed runs that
    end uninitialized or with two re-inits or more, (ii) holds each card
    metric to the ensemble's range widened by half its width."""
    scene = port_scene()
    base = _fake_raw(0.0, None, [44.7], [1.0, 50.2])
    rec = f7_record(base, scene)
    assert rec["losses"] == [44.7] and rec["reinit_ts"] == [50.2] and rec["init_t"] == 1.0
    assert rec["init_fi"] == 20 and rec["poses"] == len(base["traj"])
    assert rec["first30_ate"] < 1e-9 and abs(rec["first30_scale"] - 1.0) < 1e-9
    assert rec["kf_before_44"] == 86 and rec["below_floor_before_44"] == 0
    assert rec["dp_init"] is None
    moved = f7_record(_fake_raw(2.0 ** -52, 1, [44.5, 59.0], [1.0, 49.8], False, 1e-3),
                      scene, base)
    assert abs(moved["dp_first30"] - 1e-3) < 1e-12 and abs(moved["dp_init"] - 1e-3) < 1e-12
    assert fails_as_card(moved) and not fails_as_card(rec)
    records = [rec, moved, f7_record(_fake_raw(2.0 ** -40, 2, [44.9], [1.0, 50.0]), scene,
                                     base)]
    card = f7_record(_fake_raw(0.0, None, [44.25, 59.45], [1.0, 49.6], False), scene, base)
    d = decide(records, card)
    assert d["k"] == 1 and d["n"] == 2 and d["i"]
    assert d["metrics"]["first loss"]["range"] == pytest.approx((44.3, 45.1))
    assert not d["metrics"]["first loss"]["inside"] and not d["settled"]
    card2 = f7_record(_fake_raw(0.0, None, [44.4, 59.45], [1.0, 49.6], False), scene, base)
    assert decide(records, card2)["settled"]
    assert not decide(records[:1] + records[2:], card2)["i"]
    healed = f7_record(_fake_raw(0.0, None, [44.4], [1.0, 50.1]), scene, base)
    healed["swap"] = "K1"
    assert decide(records, healed)["settled"]
    fixed = dict(healed, swap=None, program="K1 in float64")
    data = dict(card=[card, healed, fixed],
                decisions=[decide(records, card), decide(records, healed),
                           decide(records, fixed)])
    assert verdict(data) == ("F7 verdict: outside the reference's spread, 1 of 2 perturbed "
                             "reference runs fail as the card does; swap that brings the card "
                             "inside: K1; the repaired program (K1 in float64) lands inside")


def test_f7_summary_verdict_matches_roadmap():
    """The committed summary holds the unperturbed reference run, three
    seeds at each eps, and the card's unperturbed run; the verdict its
    records give under the rule is the one ROADMAP.md states."""
    with open(SUMMARY) as f:
        data = json.load(f)
    refs = data["reference"]
    assert all(r["package"] == "pvio_tpu" and r["device"] == "cpu" for r in refs)
    assert [(r["seed"], r["eps"]) for r in refs] == RUNS
    cards = data["card"]
    assert all(c["package"] == "pvio_torch" and c["device"] == "cuda" and c["card"]
               and c["eps"] == 0.0 for c in cards)
    assert cards[0]["swap"] is None and cards[0]["program"] is None
    assert all(bool(c["swap"]) != bool(c["program"]) for c in cards[1:])
    decisions = [decide(refs, c) for c in cards]
    assert json.loads(json.dumps(decisions)) == data["decisions"]
    with open(os.path.join(ROOT, "ROADMAP.md")) as f:
        roadmap = " ".join(f.read().split())
    assert verdict(data) in roadmap, verdict(data)


# ---------------------------------------------------------------- the ensemble

@pytest.mark.slow
@pytest.mark.verylong
@pytest.mark.parametrize("seed,eps", RUNS, ids=[
    "unperturbed" if not e else f"seed{s}-eps2^{int(round(math.log2(e)))}" for s, e in RUNS])
def test_reference_f7_ensemble(seed, eps):
    """One run of the reference's ensemble (~25 minutes on 2 cores): its raw output
    goes to `.artifacts/f7/` and its record is printed."""
    raw = reference_raw(seed, eps)
    os.makedirs(RAW_DIR, exist_ok=True)
    with open(raw_path(seed, eps), "w") as f:
        json.dump(raw, f)
    base = _load(raw_path(*RUNS[0])) if os.path.exists(raw_path(*RUNS[0])) else None
    rec = f7_record(raw, port_scene(), base)
    print("f7 " + json.dumps({k: v for k, v in rec.items() if k != "health"}))
    assert rec["poses"] > 0 and np.isfinite(np.array(raw["traj"])).all()


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="F7's reference ensemble")
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--seed", type=int, default=None)
    r.add_argument("--eps", type=_golden_spread()._eps, default=0.0)
    s = sub.add_parser("summarize")
    s.add_argument("--card", nargs="*", default=[])
    args = ap.parse_args(argv)
    if args.cmd == "run":
        raw = reference_raw(args.seed, args.eps)
        os.makedirs(RAW_DIR, exist_ok=True)
        with open(raw_path(args.seed, args.eps), "w") as f:
            json.dump(raw, f)
        rec = f7_record(raw, port_scene())
        print("f7 " + json.dumps({k: v for k, v in rec.items() if k != "health"}), flush=True)
    else:
        data = summarize(args.card)
        print(json.dumps(data["decisions"], indent=1))
        print(verdict(data))
    return 0


if __name__ == "__main__":
    sys.exit(main())

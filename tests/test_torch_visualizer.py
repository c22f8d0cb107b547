"""The port's visual modules (`pvio_torch/io/viewer3d.py`,
`pvio_torch/io/visualizer.py`) against the reference's, on the CPU, in one
process, from equal forensics-bus contents.

The bus holds what the port's host loop writes (a painter snapshot of a
seeded 240x320 frame with tracked and fresh keypoints, landmark points,
keyframe poses, two planes, rates, timings and biases over twelve frames).
Tolerances: none. The snapshot dicts are equal, `render_view3d`'s HTML is
equal byte for byte (the default titles differ only in the package's
name), the recorders take equal samples, the overlay and the dashboard
decode to equal pixel arrays, and `LiveVisualizer`'s status line and live
page are equal (the page up to the package's name).
"""

import numpy as np
import pytest

from pvio_torch.geometry import nplie
from pvio_torch.io import viewer3d as Tv3
from pvio_torch.io import visualizer as Tvis
from pvio_torch.utils.forensics import Forensics as TForensics

N_FRAMES = 12


def _frames(seed=648):
    """Per-frame slot contents: [(t, {slot: value})]."""
    rng = np.random.default_rng(seed)
    H, W, K = 240, 320, 60
    out = []
    prev = None
    for i in range(N_FRAMES):
        kp = rng.uniform([0, 0], [W, H], size=(K, 2))
        mask = rng.random(K) < 0.8
        tracked = (rng.random(K) < 0.7) if prev is not None else np.zeros(K, bool)
        q = nplie.expmap(rng.normal(size=3) * 0.2)
        slots = {
            "feature_tracker_painter": {
                "frame_id": i, "t": 0.05 * i,
                "image": rng.integers(0, 256, size=(H, W)).astype(np.uint8),
                "kp": kp, "mask": mask, "tracked": tracked,
                "prev_kp": None if prev is None else prev + rng.normal(size=(K, 2)),
            },
            "camera_input_rate": 20.0, "camera_real_rate": 15.0 + rng.random(),
            "input_output_lag": 0.05 + 0.01 * rng.random(),
            "feature_tracker_time": 0.004 * rng.random(),
            "bundle_adjustor_solve_time": 0.02 * rng.random(),
            "bundle_adjustor_marginalization_time": 0.003 * rng.random(),
            "sliding_window_landmarks": int(rng.integers(50, 120)),
            "sliding_window_planes": 2,
            "imu_bias_gyroscope": rng.normal(size=3) * 1e-3,
            "imu_bias_accelerometer": rng.normal(size=3) * 1e-2,
            "sliding_window_landmark_points": np.concatenate(
                [rng.normal(size=(80, 3)) * 3.0, [[np.nan, 0, 0], [2e3, 0, 0]]]),
            "sliding_window_keyframe_poses": [(0.05 * j, q, rng.normal(size=3))
                                              for j in range(5)],
            "sliding_window_plane_states": [(np.array([0.0, 0.0, 1.0]), 0.0),
                                            (np.array([0.1, 1.0, 0.0]), 3.5)],
        }
        if i == 0:       # a slot not yet written samples as NaN
            del slots["bundle_adjustor_solve_time"]
        prev = kp
        out.append((0.05 * i, slots))
    return out


def _trajectory():
    rng = np.random.default_rng(7)
    return [(0.05 * i, np.array([1.0, 0, 0, 0]), rng.normal(size=3)) for i in range(30)]


def _bus(cls, slots):
    bus = cls()
    for k, v in slots.items():
        bus.set(k, v)
    return bus


@pytest.fixture(scope="module")
def buses():
    from pvio_tpu.utils.forensics import Forensics as JForensics

    frames = _frames()
    return frames, _bus(TForensics, frames[-1][1]), _bus(JForensics, frames[-1][1])


def test_view3d_html_matches_reference(buses, tmp_path):
    from pvio_tpu.io import viewer3d as Jv3

    _, tbus, jbus = buses
    traj = _trajectory()
    snap = Tv3.scene_snapshot(bus=tbus, trajectory=traj)
    assert snap == Jv3.scene_snapshot(bus=jbus, trajectory=traj)
    assert len(snap["landmarks"]) == 80 and len(snap["planes"]) == 2
    for live in (False, True):
        a = Tv3.render_view3d(str(tmp_path / f"port{live}.html"), bus=tbus, trajectory=traj,
                              live=live, title="map")
        b = Jv3.render_view3d(str(tmp_path / f"ref{live}.html"), snapshot=snap, live=live,
                              title="map")
        assert open(a, "rb").read() == open(b, "rb").read()
    a = open(Tv3.render_view3d(str(tmp_path / "p.html"), snapshot=snap)).read()
    b = open(Jv3.render_view3d(str(tmp_path / "r.html"), snapshot=snap)).read()
    assert a == b.replace("pvio_tpu 3D map", "pvio_torch 3D map") and "pvio_torch" in a


def _recorded(rec_cls, bus_cls):
    bus = bus_cls()
    rec = rec_cls(bus)
    for t, slots in _frames():
        for k, v in slots.items():
            bus.set(k, v)
        rec.sample(t)
    return rec


def test_history_recorder_matches_reference():
    from pvio_tpu.io import visualizer as Jvis
    from pvio_tpu.utils.forensics import Forensics as JForensics

    a = _recorded(Tvis.HistoryRecorder, TForensics)
    b = _recorded(Jvis.HistoryRecorder, JForensics)
    assert a.t == b.t and len(a.t) == N_FRAMES
    for k in Tvis.HistoryRecorder.SCALARS:
        np.testing.assert_array_equal(a.scalars[k], b.scalars[k])
    assert np.isnan(a.scalars["bundle_adjustor_solve_time"][0])
    for k in Tvis.HistoryRecorder.VECTORS:
        np.testing.assert_array_equal(np.asarray(a.vectors[k]), np.asarray(b.vectors[k]))


def _pixels(path):
    import matplotlib.image

    return matplotlib.image.imread(path)


def test_overlay_and_dashboard_pixels_match_reference(buses, tmp_path):
    from pvio_tpu.io import visualizer as Jvis
    from pvio_tpu.utils.forensics import Forensics as JForensics

    _, tbus, jbus = buses
    a = _pixels(Tvis.render_feature_overlay(str(tmp_path / "po.png"), bus=tbus))
    b = _pixels(Jvis.render_feature_overlay(str(tmp_path / "ro.png"), bus=jbus))
    assert a.shape == (240, 320, 4) and np.array_equal(a, b)
    traj = _trajectory()
    a = _pixels(Tvis.render_dashboard(str(tmp_path / "pd.png"), trajectory=traj,
                                      history=_recorded(Tvis.HistoryRecorder, TForensics),
                                      bus=tbus, title="dashboard"))
    b = _pixels(Jvis.render_dashboard(str(tmp_path / "rd.png"), trajectory=traj,
                                      history=_recorded(Jvis.HistoryRecorder, JForensics),
                                      bus=jbus, title="dashboard"))
    assert a.shape == b.shape and np.array_equal(a, b)
    assert a.std() > 0.01      # the panels drew something


def test_live_visualizer_matches_reference(capsys, tmp_path):
    from pvio_tpu.io import visualizer as Jvis
    from pvio_tpu.utils.forensics import Forensics as JForensics

    assert Tvis._sparkline([1.0, np.nan, 3.0, 2.0], 6) == Jvis._sparkline([1.0, np.nan, 3.0, 2.0], 6)
    outs = []
    for mod, cls, name in ((Tvis, TForensics, "port"), (Jvis, JForensics, "ref")):
        bus = cls()
        live = mod.LiveVisualizer(directory=str(tmp_path / name), every=N_FRAMES,
                                  terminal=True, bus=bus, get_trajectory=_trajectory)
        for t, slots in _frames():
            for k, v in slots.items():
                bus.set(k, v)
            live.frame(t)
        outs.append((capsys.readouterr().err, tmp_path / name))
    (err_t, dir_t), (err_j, dir_j) = outs
    assert err_t == err_j and err_t.count("\r\x1b[2K") == N_FRAMES
    html_t = (dir_t / "live.html").read_text()
    assert html_t == (dir_j / "live.html").read_text().replace("pvio_tpu", "pvio_torch")
    for f in ("overlay.png", "dashboard.png", "view3d.html"):
        assert (dir_t / f).stat().st_size > 0, f

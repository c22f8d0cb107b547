"""Parity of the port's dataset path against the reference modules, on the
CPU: `io/undistort.py` (radtan and equidistant), `io/tum_writer.py`,
`io/synthetic.py`'s distorted room renders, `render_frame_textured`,
`write_asl_dataset` and `load_asl_groundtruth`, `io/datasets.py`'s EuRoC
reader and scheme dispatch, `io/native_loader.py` against the Python
reader, `io/sensors_log.py` and `models/presets.py`.

Remap tables agree within 1e-12 (they are computed by the same numpy code,
so exactly), uint8 remaps are identical, the TUM files are byte for byte
equal, and the event streams of the readers are equal (times, IMU values
and images).
"""

import functools
import warnings
from dataclasses import fields

import numpy as np
import pytest

from pvio_tpu.io import datasets as ref_datasets
from pvio_tpu.io import sensors_log as ref_sensors_log
from pvio_tpu.io import synthetic as ref_syn
from pvio_tpu.io import tum_writer as ref_tum
from pvio_tpu.io import undistort as ref_und
from pvio_tpu.io.config import Config as RefConfig
from pvio_tpu.models import presets as ref_presets
from pvio_torch.io import datasets, native_loader, sensors_log, synthetic, tum_writer, undistort
from pvio_torch.io.config import Config
from pvio_torch.models import presets

RADTAN = [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
FISHEYE = [0.003, 0.0008, -0.001, 0.0002]
SMALL_K = np.array([[120.0, 0, 80.0], [0, 118.0, 60.0], [0, 0, 1]])
SMALL_SIZE = (160, 120)


def assert_events_equal(a, b):
    assert [(k, t) for k, t, _ in a] == [(k, t) for k, t, _ in b]
    for (k, _, pa), (_, _, pb) in zip(a, b):
        if k == "camera":
            assert pa.dtype == pb.dtype
            np.testing.assert_array_equal(pa, pb)
        else:
            assert tuple(pa) == tuple(pb)


@pytest.mark.parametrize("model,dist", [("radtan", RADTAN), ("equidistant", FISHEYE),
                                        ("none", None)])
def test_undistorter_matches_reference(model, dist):
    rng = np.random.default_rng(11)
    K = np.array([[190.0, 0, 161.3], [0, 188.0, 119.7], [0, 0, 1]])
    xd, yd = rng.uniform(-0.8, 0.8, size=(2, 500))
    for a, b in zip(undistort.undistort_points(xd, yd, dist, model),
                    ref_und.undistort_points(xd, yd, dist, model)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    und, und_ref = (m.ImageUndistorter(K, dist, model, (320, 240)) for m in (undistort, ref_und))
    for name in ("map_x", "map_y", "_x0", "_y0", "_fx", "_fy"):
        np.testing.assert_allclose(getattr(und, name), getattr(und_ref, name), rtol=0,
                                   atol=1e-12, err_msg=name)
    img = rng.integers(0, 256, size=(240, 320)).astype(np.uint8)
    out, out_ref = und.apply(img), und_ref.apply(img)
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, out_ref)
    f = img.astype(np.float32) / 255.0
    np.testing.assert_array_equal(und.apply(f), und_ref.apply(f))


def test_tum_writer_bytes_and_roundtrip(tmp_path):
    rng = np.random.default_rng(2)
    poses = [(10.0 + 0.05 * k, rng.normal(size=4), rng.normal(size=3)) for k in range(7)]
    for _, q, _ in poses:
        q /= np.linalg.norm(q)
    paths = []
    for m in (tum_writer, ref_tum):
        path = tmp_path / f"{m.__name__.split('.')[0]}.tum"
        with m.TumTrajectoryWriter(path) as w:
            for t, q, p in poses:
                w.write_pose(t, q, p)
        paths.append(path)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    t, q, p = tum_writer.load_tum(paths[0])
    for a, b in zip((t, q, p), ref_tum.load_tum(paths[0])):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(q, np.array([x for _, x, _ in poses]), atol=1e-15)
    np.testing.assert_allclose(p, np.array([x for _, _, x in poses]), atol=1e-15)


def test_synthetic_renders_match_reference():
    scene = synthetic.make_scene(duration=0.3, n_points=8, seed=648)
    scene_ref = ref_syn.make_scene(duration=0.3, n_points=8, seed=648)
    for model, dist in (("radtan", RADTAN), ("equidistant", FISHEYE)):
        np.testing.assert_array_equal(
            synthetic.render_frame_room(scene, 2, SMALL_K, SMALL_SIZE, distortion=dist,
                                        distortion_model=model),
            ref_syn.render_frame_room(scene_ref, 2, SMALL_K, SMALL_SIZE, distortion=dist,
                                      distortion_model=model))
    np.testing.assert_array_equal(
        synthetic.render_frame_textured(scene, 3, SMALL_K, SMALL_SIZE),
        ref_syn.render_frame_textured(scene_ref, 3, SMALL_K, SMALL_SIZE))


@functools.lru_cache(maxsize=None)
def _asl_scene():
    return synthetic.make_scene(duration=0.4, fps=20.0, imu_rate=200.0, n_points=8, seed=648)


def write_asl(root, module=synthetic):
    """A small ASL directory (8 distorted room frames at 160x120)."""
    return module.write_asl_dataset(_asl_scene(), root, SMALL_K, SMALL_SIZE,
                                    distortion=RADTAN, distortion_model="radtan")


def small_config(cls):
    cfg = cls()
    cfg.camera_intrinsic = np.array([120.0, 118.0, 80.0, 60.0])
    cfg.image_size = SMALL_SIZE
    cfg.camera_distortion = np.array(RADTAN)
    cfg.camera_distortion_model = "radtan"
    return cfg


def test_asl_writer_and_euroc_reader_match_reference(tmp_path):
    write_asl(tmp_path / "port")
    write_asl(tmp_path / "ref", ref_syn)
    for sub in ("cam0/data.csv", "imu0/data.csv", "state_groundtruth_estimate0/data.csv"):
        assert ((tmp_path / "port" / "mav0" / sub).read_bytes()
                == (tmp_path / "ref" / "mav0" / sub).read_bytes()), sub
    for a, b in zip(synthetic.load_asl_groundtruth(tmp_path / "port"),
                    ref_syn.load_asl_groundtruth(tmp_path / "ref")):
        np.testing.assert_array_equal(a, b)
    root = tmp_path / "port"
    cfg, cfg_ref = small_config(Config), small_config(RefConfig)
    und = undistort.ImageUndistorter(cfg.K, cfg.camera_distortion, "radtan", cfg.image_size)
    und_ref = ref_und.ImageUndistorter(cfg.K, cfg.camera_distortion, "radtan", cfg.image_size)
    ev = list(datasets.EurocDatasetReader(root, und))
    ev_ref = list(ref_datasets.EurocDatasetReader(root, und_ref))
    assert_events_equal(ev, ev_ref)
    assert sum(k == "camera" for k, _, _ in ev) == len(_asl_scene().frame_t)
    assert [t for _, t, _ in ev] == sorted(t for _, t, _ in ev)
    # scheme dispatch: both take their native loader (uint8 frames)
    nat = list(datasets.open_dataset(f"euroc://{root}", cfg))
    nat_ref = list(ref_datasets.open_dataset(f"euroc://{root}", cfg_ref))
    assert_events_equal(nat, nat_ref)
    assert all(x.dtype == np.uint8 for k, _, x in nat if k == "camera")


def test_native_loader_matches_python_reader(tmp_path):
    """The native loader builds into pvio_torch/_build/ and streams the
    Python reader's events (PNG frames equal to the uint8 the Python reader
    decodes; a second pass replays the stream)."""
    assert native_loader.available(), "the native loader did not build"
    assert native_loader._SO.parent.name == "_build"
    write_asl(tmp_path)
    reader = native_loader.NativeEurocReader(tmp_path)
    nat = list(reader)
    py = list(datasets.EurocDatasetReader(tmp_path))
    assert [(k, round(t, 9)) for k, t, _ in nat] == [(k, round(t, 9)) for k, t, _ in py]
    for (k, _, pn), (_, _, pp) in zip(nat, py):
        if k == "camera":
            assert pn.dtype == np.uint8
            np.testing.assert_array_equal(pn, np.round(pp * 255.0).astype(np.uint8))
        else:
            np.testing.assert_array_equal(pn, pp)
    assert_events_equal(list(reader), nat)
    reader.close()
    with pytest.raises(RuntimeError):
        next(iter(reader))


def test_python_reader_fallback_is_audible(tmp_path, monkeypatch):
    write_asl(tmp_path)
    monkeypatch.setattr(native_loader, "load", lambda: None)
    with pytest.warns(RuntimeWarning, match="native dataset loader unavailable"):
        reader = datasets.open_dataset(f"euroc://{tmp_path}")
    assert isinstance(reader, datasets.EurocDatasetReader)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert isinstance(datasets.open_dataset(f"tum://{tmp_path}", native=False),
                          datasets.TumDatasetReader)
    with pytest.raises(ValueError, match="scheme"):
        datasets.open_dataset("ftp://nowhere")


def test_sensors_log_roundtrip_and_dispatch(tmp_path):
    """The port's writer and readers against the reference's on one log:
    chunked parse across 8192-byte boundaries, the reference's tie-breaks,
    the legacy accelerometer scale and the scheme dispatch."""
    rng = np.random.default_rng(0)
    path = tmp_path / "log.pvsn"
    t = 0.0
    with sensors_log.SensorsLogWriter(path) as wtr:
        for i in range(60):
            t += 0.005
            wtr.put_gyroscope(t, rng.normal(size=3))
            wtr.put_accelerometer(t, rng.normal(size=3))
            if i % 10 == 0:
                wtr.put_image(t, rng.integers(0, 256, size=(90, 120), dtype=np.uint8))
    assert path.stat().st_size > 2 * sensors_log.CHUNK
    for cls, ref_cls in ((sensors_log.SensorsDatasetReader, ref_sensors_log.SensorsDatasetReader),
                         (sensors_log.LegacySensorsDatasetReader,
                          ref_sensors_log.LegacySensorsDatasetReader)):
        got, want = list(cls(path)), list(ref_cls(path))
        assert_events_equal(got, want)
        kinds = [k for k, _, _ in got]
        assert kinds[:3] == ["accelerometer", "gyroscope", "camera"]
    out = tmp_path / "copy.pvsn"
    sensors_log.convert_events_to_log(list(ref_sensors_log.SensorsDatasetReader(path)), out)
    assert_events_equal(list(sensors_log.SensorsDatasetReader(out)),
                        list(ref_sensors_log.SensorsDatasetReader(path)))
    for scheme, cls in (("sensors", sensors_log.SensorsDatasetReader),
                        ("legacy-sensors", sensors_log.LegacySensorsDatasetReader)):
        assert type(datasets.open_dataset(f"{scheme}://{path}")) is cls


@pytest.mark.parametrize("name", sorted(ref_presets.PRESETS))
def test_presets_match_reference(name):
    cfg, ref = presets.config(name), ref_presets.config(name)
    for f in fields(ref):
        a, b = getattr(cfg, f.name), getattr(ref, f.name)
        assert np.array_equal(a, b) if isinstance(b, np.ndarray) else a == b, (name, f.name)
    assert sorted(presets.PRESETS) == sorted(ref_presets.PRESETS)
    with pytest.raises(KeyError):
        presets.config("nope")

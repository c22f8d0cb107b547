"""The port's window checkpoint (`pvio_torch/io/checkpoint.py`) and version
(`pvio_torch/version.py`) against the reference's, on the CPU.

The window is `tests/test_parallel.py`'s (6 slots x 64 tracks, float64,
from the port's numpy copy of the scene generator), with a marginalization
prior and plane slots filled so that every leaf carries values. A file
written by either package loads in the other with equal leaves (the index
leaves int32 in the reference's files and int64 in the port's), and a
loaded window solves exactly as the original.
"""

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import jax

import pvio_torch
from pvio_torch.estimation import ba as Tba
from pvio_torch.io import checkpoint as Tck
from pvio_torch.io import synthetic as TS
from tests.test_torch_factors_ba import to_jax
from tests.test_torch_sharded_ba import _perturb

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def window():
    scene = TS.make_scene(duration=2.0, n_points=40, n_plane_points=90, plane_z=4.6, seed=648)
    w, extr, info = TS.solver_window_from_scene(scene, [0, 4, 8, 12, 16], F_cap=6, T_cap=64,
                                                dtype=torch.float64, kp_noise=0.001)
    w, _ = TS.flag_plane_tracks(w, scene, info)
    rng = np.random.default_rng(648)
    D = w.prior.sqrt_info.shape[0]
    w = w._replace(prior=w.prior._replace(
        sqrt_info=torch.as_tensor(rng.normal(size=(D, D))),
        infovec=torch.as_tensor(rng.normal(size=D)), valid=torch.tensor(True)))
    cfg = Tba.BAConfig(iterations=4, kp_sqrt_inv_cov=283.0, use_planes=True)
    return w, extr, cfg


def _assert_same_leaves(port_leaves, ref_leaves):
    assert len(port_leaves) == len(ref_leaves) == 40
    for i, (a, b) in enumerate(zip(port_leaves, ref_leaves)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype.kind == b.dtype.kind, (i, a.dtype, b.dtype)
        assert np.array_equal(a, b), i


def test_checkpoint_roundtrip(window, tmp_path):
    """tests/test_parallel.py::test_checkpoint_roundtrip on the port."""
    w, extr, cfg = window
    path = tmp_path / "window.npz"
    Tck.save_window(path, w)
    w2 = Tck.load_window(path, device="cpu")
    for a, b in zip(pytree.tree_leaves(w), pytree.tree_leaves(w2)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    r1, _ = Tba.solve(_perturb(w, 1), extr, cfg)
    r2, _ = Tba.solve(_perturb(w2, 1), extr, cfg)
    assert torch.equal(r1.p, r2.p) and torch.equal(r1.inv_depth, r2.inv_depth)


def test_checkpoint_files_cross_packages(window, tmp_path):
    from pvio_tpu.io import checkpoint as Jck

    w, _, _ = window
    w_ref = to_jax(w)
    port_file, ref_file = tmp_path / "port.npz", tmp_path / "ref.npz"
    Tck.save_window(port_file, w)
    Jck.save_window(ref_file, w_ref)
    with np.load(port_file) as a, np.load(ref_file) as b:
        assert sorted(a.files) == sorted(b.files) and int(a["__n"]) == 40
    # the reference's file in the port: the port's int64 index leaves
    w_from_ref = Tck.load_window(ref_file, device="cpu")
    _assert_same_leaves(pytree.tree_leaves(w_from_ref), pytree.tree_leaves(w))
    for f in ("ref_frame", "track_flags", "plane_id"):
        assert getattr(w_from_ref, f).dtype == torch.int64
    # the port's file in the reference, up to the int width
    leaves = [np.asarray(x) for x in jax.tree.leaves(Jck.load_window(port_file))]
    _assert_same_leaves([x.astype(np.int32) if x.dtype.kind == "i" else x for x in leaves],
                        jax.tree.leaves(w_ref))


def test_load_window_dtype_and_device(window, tmp_path):
    w, _, _ = window
    path = tmp_path / "window.npz"
    Tck.save_window(path, w)
    w32 = Tck.load_window(path, dtype=torch.float32, device="cpu")
    for a, b in zip(pytree.tree_leaves(w32), pytree.tree_leaves(w)):
        assert a.dtype == (torch.float32 if b.is_floating_point() else b.dtype)
    if torch.cuda.is_available():
        assert Tck.load_window(path).p.is_cuda
    else:   # the CPU must be asked for
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Tck.load_window(path)


def test_version_matches_reference():
    import pvio_tpu

    assert pvio_torch.version_info == pvio_tpu.version_info == (0, 1, 0)
    assert pvio_torch.__version__ == pvio_tpu.__version__ == "0.1.0"
    assert {"__version__", "version_info"} <= set(pvio_torch.__all__)

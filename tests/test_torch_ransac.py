"""Port parity: the threefry random bits and the F-RANSAC gate,
pvio_torch vs pvio_tpu on the CPU.

The port's `threefry.uniform` must be bit-exact with `jax.random.uniform`
on a threefry2x32 key (identical, f32 and f64); hypothesis indices, inlier
masks and counts are identical; the bordered elimination solve agrees to
1e-12 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvio_tpu.frontend import ransac as Jr
from pvio_torch.frontend import ransac as Tr
from pvio_torch.utils import threefry
from tests.test_torch_harness import assert_close, assert_same, t64

torch.set_num_threads(2)


def _jkey(kd):
    return jax.random.wrap_key_data(jnp.asarray(kd, jnp.uint32), impl="threefry2x32")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_threefry_uniform_is_bit_exact(dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    for kd in ([648, 0], [648, 7], [0, 0], [0xFFFFFFFF, 0x12345678]):
        for shape in [(128, 150), (3,), (5, 7, 2), ()]:
            ref = np.asarray(jax.random.uniform(_jkey(kd), shape, dtype=jdt))
            out = threefry.uniform(np.asarray(kd, np.uint32), shape, tdt).numpy()
            assert out.dtype == ref.dtype and out.shape == ref.shape
            assert out.tobytes() == ref.tobytes(), (kd, shape)


def _matches(rng, N=60, outliers=12):
    """Pixel correspondences of a 3-D scene seen from two poses, with a
    block of gross outliers and a few masked-out rows."""
    X = rng.uniform(-2, 2, size=(N, 3)) + np.array([0, 0, 6.0])
    K = np.array([[200.0, 0, 160], [0, 200.0, 120], [0, 0, 1]])
    a = 0.05
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    t = np.array([0.3, 0.05, 0.02])
    x1 = (X / X[:, 2:]) @ K.T
    Y = X @ R.T + t
    x2 = (Y / Y[:, 2:]) @ K.T
    x1, x2 = x1[:, :2] + rng.normal(size=(N, 2)) * 0.2, x2[:, :2] + rng.normal(size=(N, 2)) * 0.2
    # off the (near-horizontal) epipolar lines
    x2[:outliers, 1] += rng.choice([-1.0, 1.0], outliers) * rng.uniform(15, 40, outliers)
    mask = np.ones(N, bool)
    mask[-4:] = False
    return x1, x2, mask


def test_sample_indices_match_reference():
    rng = np.random.default_rng(31)
    mask = rng.uniform(size=150) < 0.7
    kd = np.array([648, 3], np.uint32)
    ref = Jr._sample_indices(_jkey(kd), 128, 8, jnp.asarray(mask))
    out = Tr._sample_indices(kd, 128, 8, t64(mask), torch.float64)
    assert_same(out, ref, "indices")
    assert mask[np.asarray(ref)].all()


def test_ge_solve_matches_reference():
    rng = np.random.default_rng(32)
    A = rng.normal(size=(16, 9, 9)) + 4 * np.eye(9)
    b = rng.normal(size=(16, 9))
    assert_close(Tr._ge_solve(t64(A), t64(b)), Jr._ge_solve(jnp.asarray(A), jnp.asarray(b)),
                 1e-12, "ge_solve")


def test_find_fundamental_matches_reference():
    """Same key data -> same hypotheses -> identical inlier mask and count;
    F within 1e-9 relative (the 9x9 unpivoted elimination amplifies
    reassociation differences)."""
    for seed, kd in [(33, [648, 0]), (34, [648, 5])]:
        x1, x2, mask = _matches(np.random.default_rng(seed))
        kd = np.asarray(kd, np.uint32)
        Fj, inl_j, cnt_j = jax.jit(Jr.find_fundamental)(
            _jkey(kd), jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask))
        Ft, inl_t, cnt_t = Tr.find_fundamental(kd, t64(x1), t64(x2), t64(mask))
        assert_same(inl_t, inl_j, "inliers")
        assert int(cnt_t) == int(cnt_j)
        assert 30 <= int(cnt_j) <= 46
        assert not np.asarray(inl_j)[:12].any()       # gross outliers rejected
        Ft, Fj = Ft.numpy(), np.asarray(Fj)
        assert_close(Ft / np.abs(Ft).max(), Fj / np.abs(Fj).max(), 1e-9, "F")

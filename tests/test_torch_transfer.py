"""The host loop's batched transfers (`utils/transfer.py`), on the CPU.

The card path packs every array into one byte buffer and views it back;
the same packing and views are run here on a CPU byte tensor, for every
dtype and shape the host loop ships (0-d scalars, empty IMU spans, uint8
images, bool masks, int32 indices widened to int64, float64 cast to the
engine's float32). `Fetch` / `get` return numpy copies of nested trees.
"""

from collections import namedtuple

import numpy as np
import pytest
import torch

from pvio_torch.utils import transfer


def _arrays(rng):
    return [np.float64(1.25), np.int32(7), rng.normal(size=(3, 4)), np.zeros((0, 3)),
            rng.integers(0, 255, (5, 7)).astype(np.uint8), rng.uniform(size=9) < 0.5,
            rng.integers(-5, 5, 11).astype(np.int32), np.array([648, 3], np.uint32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pack_views_roundtrip(dtype):
    rng = np.random.default_rng(4)
    arrays = _arrays(rng)
    np_float = np.float32 if dtype == torch.float32 else np.float64
    host = [transfer._host_array(a, np_float) for a in arrays]
    offsets, total = transfer._layout(host)
    assert all(o % 16 == 0 for o in offsets)
    raw = np.zeros(total, np.uint8)
    transfer._pack(raw, host, offsets)
    views = transfer._views(torch.from_numpy(raw), host, offsets)
    plain = transfer.upload(arrays, "cpu", dtype)
    for a, v, p in zip(arrays, views, plain):
        a = np.asarray(a)
        want = {"f": dtype, "b": torch.bool}.get(a.dtype.kind,
                                                 torch.uint8 if a.dtype == np.uint8 else torch.int64)
        assert v.dtype == p.dtype == want and tuple(v.shape) == a.shape
        assert torch.equal(v, p)
        np.testing.assert_array_equal(v.numpy(), a.astype(v.numpy().dtype))


def test_upload_copies_the_mirror():
    a = np.arange(6.0)
    (t,) = transfer.upload([a], "cpu", torch.float64)
    a[:] = -1.0
    assert torch.equal(t, torch.arange(6.0, dtype=torch.float64))


def test_fetch_and_get_trees():
    P = namedtuple("P", "x y")
    tree = ({"b": torch.ones(2, dtype=torch.bool), "a": torch.tensor(3)}, P(torch.zeros(2, 2), None), 5)
    f = transfer.Fetch(tree)
    out = transfer.get((f, torch.arange(3)))
    (d, p, five), r = out
    assert isinstance(p, P) and p.y is None and five == 5
    np.testing.assert_array_equal(d["b"], [True, True])
    assert d["a"].shape == () and int(d["a"]) == 3
    np.testing.assert_array_equal(r, [0, 1, 2])
    assert transfer.get(f) is transfer.get(f)

"""Threefry-2x32 counter-based random bits, bit-exact with `jax.random`.

Matches `jax.random.uniform(jax.random.wrap_key_data(key_data,
impl="threefry2x32"), shape, dtype)` under `jax_threefry_partitionable=True`
(the default since JAX 0.5): element i of a row-major `shape` is hashed from
the 64-bit counter i, split into (hi, lo) 32-bit words, by Threefry-2x32 with
20 rounds. 32-bit floats take `bits1 ^ bits2`, 64-bit floats take
`bits1 << 32 | bits2`; the top mantissa bits then fill [1, 2) and 1 is
subtracted.

`PRNGKey(seed)` and `split(key, num)` match `jax.random.PRNGKey` and
`jax.random.split` on raw threefry keys (uint32 pairs): the seed's high and
low words, and new key i hashed from the counter i. The initializer draws
its RANSAC keys that way (`pvio_tpu/core/initializer.py:71-79`).

Reproducing the reference's bits lets the RANSACs draw the very same
hypotheses (`pvio_tpu/frontend/ransac.py::_sample_indices`), so the tracking
status masks can be compared exactly. PyTorch has no unsigned 32-bit
arithmetic, so every word lives in an int64 tensor masked to 32 bits.
"""

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _MASK32


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 block function on int64 tensors holding uint32 values.
    k1, k2: scalar tensors (key words); x1, x2: counter words (any shape).
    Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _MASK32, (x2 + ks[1]) & _MASK32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK32
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & _MASK32
    return x[0], x[1]


def uniform(key_data, shape, dtype, device=None):
    """U[0, 1) samples of `shape` in `dtype` (torch.float32 or
    torch.float64) from a (2,) uint32 key (sequence, numpy array or
    tensor). Bit-exact with jax.random.uniform on a threefry2x32 key."""
    if device is None:
        device = key_data.device if isinstance(key_data, torch.Tensor) else "cpu"
    if not isinstance(key_data, torch.Tensor):
        key_data = np.asarray(key_data).astype(np.int64)
    key = torch.as_tensor(key_data, device=device).to(torch.int64) & _MASK32
    n = 1
    for s in shape:
        n *= int(s)
    count = torch.arange(n, dtype=torch.int64, device=device)
    bits1, bits2 = threefry2x32(key[0], key[1], count >> 32, count & _MASK32)
    if dtype == torch.float32:
        mant = (bits1 ^ bits2) >> 9                    # top 23 of 32 bits
        out = mant.to(torch.float32) * (2.0 ** -23)
    elif dtype == torch.float64:
        mant = (bits1 << 20) | (bits2 >> 12)           # top 52 of 64 bits
        out = mant.to(torch.float64) * (2.0 ** -52)
    else:
        raise TypeError(f"uniform: unsupported dtype {dtype}")
    return out.reshape(tuple(shape))


def PRNGKey(seed):
    """(2,) uint32 numpy key of an integer seed: its high and low 32-bit
    words (`jax.random.PRNGKey` on the threefry implementation)."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([seed >> 32, seed & _MASK32], np.uint32)


def split(key, num=2):
    """(num, 2) uint32 numpy keys from a (2,) key: key i is the
    Threefry-2x32 hash of the 64-bit counter i (`jax.random.split` under
    the partitionable threefry). Host-side: keys are tiny and are consumed
    by `uniform`, which takes them as key data."""
    key = torch.as_tensor(np.asarray(key, np.uint32).astype(np.int64))
    count = torch.arange(int(num), dtype=torch.int64)
    b1, b2 = threefry2x32(key[0], key[1], count >> 32, count & _MASK32)
    return torch.stack([b1, b2], dim=-1).numpy().astype(np.uint32)

"""Multi-sequence coupled-chain batching (`pvio_torch/parallel/multi_seq.py`)
against the reference's `pvio_tpu/parallel/multi_seq.py` on the CPU, with
the reference tests' `small_cfg` (`tests/test_multi_seq.py:16-32`: 320x240,
7 frame slots, 128 tracks, 4 planes, 6 LM iterations, float64, planes on,
`preint_assoc=False` as the reference's CPU tests set it).

Tolerances: `build_sequence_inputs`' arrays and window 1e-12 (masks,
indices and the slot association exactly); the port's single-sequence
chain against the reference's jitted chain: costs rtol 1e-9, positions
atol 1e-9 (the chain's LM solves reassociate sums); the vmapped batch
against unbatched port chains: rtol 1e-9, atol 1e-9, as the reference
holds its own batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvio_tpu.core.kernels import DeviceKernels as JKernels
from pvio_tpu.parallel import multi_seq as Jms
from pvio_torch.core.kernels import DeviceKernels as TKernels
from pvio_torch.io.config import Config as TConfig
from pvio_torch.parallel import multi_seq as Tms
from tests.test_multi_seq import small_cfg
from tests.test_torch_harness import assert_close, npy, tree_to_numpy

torch.set_num_threads(2)
SEED = 648


def _port_cfg():
    jcfg = small_cfg()
    tcfg = TConfig()
    for f in jcfg.__dataclass_fields__:
        setattr(tcfg, f, getattr(jcfg, f))
    return tcfg


@pytest.fixture(scope="module")
def kernels():
    cfg = _port_cfg()
    return cfg, TKernels(cfg, device="cpu")


def _compare_trees(port, ref, tol, what):
    a, b = tree_to_numpy(port), tree_to_numpy(ref)
    assert a.keys() == b.keys(), what
    for k in a:
        if isinstance(a[k], dict):
            _compare_trees(getattr(port, k), getattr(ref, k), tol, f"{what}.{k}")
        elif a[k].dtype.kind == "f":
            assert_close(a[k], b[k], tol, f"{what}.{k}")
        else:
            assert np.array_equal(a[k], b[k]), f"{what}.{k}"


@pytest.fixture(scope="module")
def reference(kernels):
    """The reference's inputs for SEED and its jitted chain at GROUPS = 1,
    KF_EVERY = 2 on them."""
    jcfg = small_cfg()
    jk = JKernels(jcfg)
    w, a = Jms.build_sequence_inputs(jcfg, jk, 2, seed=SEED)
    chain = jax.jit(Jms.make_chain(jk, jcfg, 1, 2))
    costs, wf = chain(w, jax.tree.map(jnp.asarray, a), jnp.asarray(0.0, jk.dtype))
    return w, a, np.asarray(costs), np.asarray(wf.p)


def test_build_sequence_inputs_matches_reference(kernels, reference):
    cfg, kern = kernels
    w_t, a_t = Tms.build_sequence_inputs(cfg, kern, 2, seed=SEED)
    w_j, a_j = reference[:2]
    assert a_t.keys() == a_j.keys()
    for k in a_t:
        x, y = np.asarray(a_t[k]), np.asarray(a_j[k])
        assert x.shape == y.shape, k
        if y.dtype.kind == "f":
            assert_close(x, y, 1e-12, k)
        else:
            assert np.array_equal(x, y), k
    assert (a_t["slot_of_col"] >= 0).sum() >= 20
    _compare_trees(w_t, w_j, 1e-12, "window")


def test_chain_matches_reference(kernels, reference):
    """The port's unbatched chain (GROUPS = 1, KF_EVERY = 2: two frames, one
    BA + marginalization) on the port's inputs against the reference's
    jitted chain on its own."""
    cfg, kern = kernels
    w, a = Tms.build_sequence_inputs(cfg, kern, 2, seed=SEED)
    chain = Tms.make_chain(kern, cfg, 1, 2)
    costs, wf = chain(w, Tms.upload_arrays(kern, a), torch.zeros((), dtype=kern.dtype))
    costs_j, p_j = reference[2:]
    assert costs.shape == (1,) and np.isfinite(npy(costs)).all()
    np.testing.assert_allclose(npy(costs), costs_j, rtol=1e-9)
    np.testing.assert_allclose(npy(wf.p), p_j, rtol=0, atol=1e-9)


def _batch_case(kern, cfg, n_seq, groups, kf_every):
    ws, arrays = [], []
    for i in range(n_seq):
        w, a = Tms.build_sequence_inputs(cfg, kern, groups * kf_every, seed=SEED + 31 * i)
        ws.append(w)
        arrays.append(a)
    chain = Tms.make_chain(kern, cfg, groups, kf_every)
    ref = []
    for w, a in zip(ws, arrays):
        costs, wf = chain(w, Tms.upload_arrays(kern, a), torch.zeros((), dtype=kern.dtype))
        ref.append((npy(costs), npy(wf.p)))
    costs_b, wfs = Tms.run_batched(kern, cfg, ws, arrays, groups, kf_every)
    assert costs_b.shape == (n_seq, groups) and np.isfinite(costs_b).all()
    # distinct scenes must yield distinct solves
    assert len({round(float(c[-1]), 6) for c in costs_b}) == n_seq
    for i in range(n_seq):
        np.testing.assert_allclose(costs_b[i], ref[i][0], rtol=1e-9)
        np.testing.assert_allclose(npy(wfs[i].p), ref[i][1], rtol=0, atol=1e-9)


def test_vmapped_batch_matches_unbatched(kernels):
    """B = 3 sequences through one vmapped chain (GROUPS = 1, KF_EVERY = 2)
    against three unbatched port chains."""
    cfg, kern = kernels
    _batch_case(kern, cfg, 3, 1, 2)


@pytest.mark.slow
def test_vmapped_batch_matches_unbatched_full(kernels):
    """The reference's contract (tests/test_multi_seq.py): four sequences,
    GROUPS = 2, KF_EVERY = 4."""
    cfg, kern = kernels
    _batch_case(kern, cfg, 4, 2, 4)

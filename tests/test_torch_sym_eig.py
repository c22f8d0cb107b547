"""The eigen-decomposition behind the device steps' triangulation
(`pvio_torch/ops/eigh.py`, the custom op `pvio::sym_eig`, kernel E1 on the
card) on the CPU: the plain version is `torch.linalg.eigh` itself, so the
reference parity of the triangulation tests is untouched; here the op's
dispatch, its vmap rule, that the window's triangulation goes through it,
and its cost model. Tolerance: bit for bit (the CPU implementation is eigh
on the same stack)."""

import numpy as np
import pytest
import torch
from torch.func import vmap

from pvio_torch.map import window as win
from pvio_torch.ops import eigh as eigh_op

torch.set_num_threads(2)


def _spd(rng, B, n):
    J = rng.normal(size=(B, 2 * n, n))
    return torch.as_tensor(J.transpose(0, 2, 1) @ J)


@pytest.mark.parametrize("n", [eigh_op.N])
def test_op_is_eigh_on_cpu_and_vmaps(n):
    A = _spd(np.random.default_rng(n), 5, n)
    before = eigh_op.LAUNCHES
    L, V = eigh_op.eigh(A)
    Lp, Vp = torch.linalg.eigh(A)
    assert torch.equal(L, Lp) and torch.equal(V, Vp)
    Lv, Vv = vmap(eigh_op.eigh)(A)
    assert torch.equal(Lv, Lp) and torch.equal(Vv, Vp)
    # nested: a batch of batches
    Ln, Vn = vmap(vmap(eigh_op.eigh))(A.reshape(5, 1, n, n))
    assert torch.equal(Ln.reshape(5, n), Lp) and torch.equal(Vn.reshape(5, n, n), Vp)
    assert eigh_op.LAUNCHES == before


def test_window_triangulation_goes_through_the_op():
    """The device steps' DLT (`window._triangulate`) takes its smallest
    eigenvectors from the op: one call for all tracks."""
    rng = np.random.default_rng(3)
    q_ws = torch.tensor([[1.0, 0.0, 0.0, 0.0]] * 3, dtype=torch.float64)
    p_ws = torch.as_tensor(rng.normal(size=(3, 3)) * 0.3)
    X = rng.normal(size=(7, 3)) + [0.0, 0.0, 5.0]
    rel = X[None] - p_ws.numpy()[:, None]                      # (3, 7, 3)
    kp = torch.as_tensor(rel[..., :2] / rel[..., 2:])
    obs = torch.ones(3, 7, dtype=torch.bool)
    calls = []
    real = eigh_op.eigh
    eigh_op.eigh = lambda A: calls.append(tuple(A.shape)) or real(A)
    try:
        pts, _, ok = win._triangulate(q_ws, p_ws, kp, obs, torch.zeros(7, dtype=torch.int64))
    finally:
        eigh_op.eigh = real
    assert calls == [(7, 4, 4)] and bool(ok.all())
    np.testing.assert_allclose(pts.numpy(), X, atol=1e-9)


def test_wrapper_refuses_cpu_tensors_and_counts_work():
    with pytest.raises(ValueError, match="CUDA"):
        eigh_op.sym_eig_cuda(torch.eye(4))
    n_bytes, ops = eigh_op.cost(4, [3, 5])
    assert n_bytes == 2 * (2 * 16 + 4) * 8
    assert ops == 8 * eigh_op.flops_per_sweep(4) == 8 * 6 * (12 * 4 + 20)

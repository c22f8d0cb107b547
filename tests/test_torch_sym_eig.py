"""The eigen-decompositions behind the device steps' triangulation and the
marginalization (`pvio_torch/ops/eigh.py`, the custom op `pvio::sym_eig`:
kernel E1 at 4x4 and kernel E2 at the marginalization's 15x15 and
(F*15)-square matrices on the card) on the CPU: the plain version is
`torch.linalg.eigh` itself, so the reference parity of the triangulation
and marginalization tests is untouched; here the op's dispatch at every
size its callers give it, its vmap rule, that the window's triangulation
and the marginalization go through it, and its cost model. Tolerances: bit
for bit against eigh (the CPU implementation is eigh on the same stack);
the marginalization's prior through the op against the reference's, S^T S
and S^T infovec within 1e-10 of their largest entry (eigh leaves the
eigenvectors' signs and the basis inside the 15 zeroed dimensions free,
and the two libraries' LAPACK calls round differently). Then the kernels'
algorithm itself, `eigh_op.jacobi_model`, which the card tests hold the
kernels' sweep counts to: against eigh within chip_smoke.eig_gap's float64
limit at E1's 4x4 (the card test's DLT normal matrices and a seeded
window's, as chip_smoke.eig_cases forms them) and at E2's sizes, on
matrices one marg_step records, and in the marginalization against the
reference's.
"""

import jax
import numpy as np
import pytest
import torch
from torch.func import vmap

from pvio_tpu.estimation import marginalization as Jmarg
from pvio_torch.estimation import marginalization as Tmarg
from pvio_torch.map import window as win
from pvio_torch.ops import eigh as eigh_op
from tests.test_torch_factors_ba import ba_window, bacfg
from tests.test_torch_harness import assert_rel, npy

torch.set_num_threads(2)


def _spd(rng, B, n):
    J = rng.normal(size=(B, 2 * n, n))
    return torch.as_tensor(J.transpose(0, 2, 1) @ J)


@pytest.mark.parametrize("n", [eigh_op.N, 15, 105, 135])
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


def _deficient(rng, B, n):
    """B symmetric positive semi-definite n x n matrices with their last 15
    rows and columns exactly zero, as after the marginalization's
    `_shift_out` (at n = 15, the zero matrix)."""
    A = _spd(rng, B, n).numpy()
    A[:, -15:, :] = 0.0
    A[:, :, -15:] = 0.0
    return torch.as_tensor(A)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [15, 105, 135])
def test_op_is_eigh_on_rank_deficient_matrices(n, dtype):
    """The op's CPU path at E2's sizes on matrices with 15 zeroed rows and
    columns (at n = 15 the zero matrix), one matrix and a vmapped stack of
    3 (the priors of 3 sequences under `parallel.multi_seq.run_batched`),
    equals torch.linalg.eigh and launches nothing."""
    A = _deficient(np.random.default_rng(n), 3, n).to(dtype)
    k1, k2 = eigh_op.LAUNCHES, sum(eigh_op.BLOCK_LAUNCHES.values())
    Lp, Vp = torch.linalg.eigh(A)
    L1, V1 = eigh_op.eigh(A[1])
    assert L1.dtype == dtype and torch.equal(L1, Lp[1]) and torch.equal(V1, Vp[1])
    Lv, Vv = vmap(eigh_op.eigh)(A)
    assert torch.equal(Lv, Lp) and torch.equal(Vv, Vp)
    assert (eigh_op.LAUNCHES, sum(eigh_op.BLOCK_LAUNCHES.values())) == (k1, k2)


def test_marginalization_goes_through_the_op_and_matches_reference():
    """marginalize_and_remove decomposes the 15x15 victim block and the
    (F*15)-square prior through the op (one call each), and its prior
    matches the reference's `marginalize_and_remove` at float64 on the
    same window: S^T S and S^T infovec within 1e-10 relative."""
    _, _, w, extr, _, wt, et = ba_window()
    cj, ct = bacfg(False)
    F = wt.kp.shape[0]
    calls = []
    real = eigh_op.eigh
    eigh_op.eigh = lambda A: calls.append(tuple(A.shape)) or real(A)
    try:
        wmt = Tmarg.marginalize_and_remove(wt, et, ct, index=0)
    finally:
        eigh_op.eigh = real
    assert calls == [(15, 15), (F * 15, F * 15)], calls
    wmj = jax.jit(lambda w_: Jmarg.marginalize_and_remove(w_, extr, cj, index=0))(w)
    S_t, iv_t = npy(wmt.prior.sqrt_info), npy(wmt.prior.infovec)
    S_j, iv_j = np.asarray(wmj.prior.sqrt_info), np.asarray(wmj.prior.infovec)
    assert_rel(S_t.T @ S_t, S_j.T @ S_j, 1e-10, "S^T S")
    assert_rel(S_t.T @ iv_t, S_j.T @ iv_j, 1e-10, "S^T infovec")


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
    with pytest.raises(ValueError, match="CUDA"):
        eigh_op.sym_eig_cuda(torch.eye(135))
    n_bytes, ops = eigh_op.cost(4, 2)
    assert n_bytes == 2 * (2 * 16 + 4) * 8
    assert ops == 2 * 9 * 4 ** 3
    n_bytes, _ = eigh_op.cost(4, 256, itemsize=4)     # E1 at float32: read and written so
    assert n_bytes == 256 * (2 * 16 + 4) * 4
    n_bytes, ops = eigh_op.cost(135, 11)
    assert n_bytes == 11 * (2 * 135 ** 2 + 135) * 8
    assert ops == 11 * 9 * 135 ** 3


@pytest.mark.parametrize("window", [7, 9, 11, 16, 17])
def test_card_engine_checks_its_window_against_e2(window):
    """A CUDA engine refuses, when it is built, a window whose prior E2
    cannot decompose (F * 15 > N_MAX = 240: more than 16 frame slots); the
    check comes before any tensor is made on the card, so it runs here."""
    from pvio_torch.core.kernels import DeviceKernels
    from pvio_torch.io.config import Config

    cfg = Config(sliding_window_size=window - 1)
    assert cfg.window_frame_capacity == window
    if window * 15 <= eigh_op.N_MAX:
        eigh_op.check_window(window)
        return
    with pytest.raises(ValueError, match="sliding_window_size is at most"):
        DeviceKernels(cfg, device="cuda")


# E1's algorithm on the CPU (`eigh_op.jacobi_model` at n = 4: round-robin
# Jacobi over the 4 indices, unpadded) against torch.linalg.eigh, within
# chip_smoke.eig_gap's float64 limit (1e-12 of the largest eigenvalue).


@pytest.mark.parametrize("r", [0, 1, 2])
def test_e1_rounds_pair_lanes_by_xor(r):
    """Round r of the model's ordering over 4 indices (`_pairs(4, r)`) is
    the kernel's: index j pairs with j ^ (3 - r), and (r, 3) is a pair."""
    P, Q = eigh_op._pairs(eigh_op.N, r, "cpu")
    pairs = sorted(zip(P.tolist(), Q.tolist()))
    assert pairs == sorted({tuple(sorted((j, j ^ (3 - r)))) for j in range(4)})
    assert (r, 3) in pairs


def _model_against_eigh(A):
    """jacobi_model on each 4x4 matrix of A (float64): the largest eig_gap
    and its limit, and the sweeps."""
    import chip_smoke as cs

    worst, lim, sweeps = 0.0, None, []
    for a in A:
        L, V, s = eigh_op.jacobi_model(a)
        gap, lim = cs.eig_gap(a, L, V, torch.linalg.eigh(a)[0])
        worst = max(worst, gap)
        sweeps.append(s)
    return worst, lim, sweeps


@pytest.mark.parametrize("kind", ["zero", "poorly_conditioned", "full_rank"])
def test_jacobi_model_is_eigh_at_4(kind):
    """The card test's DLT normal matrices (`chip_smoke.dlt_normals` at
    B = 256), by quarter: the zero matrices take no sweep, the others (the
    last column scaled by 1e-3, or none) converge below MAX_SWEEPS to
    eigh's eigenpairs."""
    import chip_smoke as cs

    A = torch.as_tensor(cs.dlt_normals(256))
    A = {"zero": A[0::4], "poorly_conditioned": A[1::4],
         "full_rank": torch.cat([A[2::4], A[3::4]])}[kind]
    gap, lim, sweeps = _model_against_eigh(A)
    assert gap <= lim, (gap, lim)
    if kind == "zero":
        assert set(sweeps) == {0}
    else:
        assert 0 < min(sweeps) and max(sweeps) < eigh_op.MAX_SWEEPS, sweeps


@pytest.mark.parametrize("copy", [None, 1, -1])
def test_jacobi_model_is_eigh_on_window_normals(copy):
    """The DLT normal matrices of the seeded bench window (320x240,
    float32, chip_smoke.eig_cases): every track's (copy None), and copies 1
    and MS_B - 1 of the vmapped chain's perturbed stack of them, read by
    the model in float64 as the kernel reads them: eigh's eigenpairs below
    MAX_SWEEPS."""
    import chip_smoke as cs
    from pvio_torch.core.kernels import DeviceKernels
    from pvio_torch.io.config import Config

    cfg = Config(camera_intrinsic=np.array([200.0, 200.0, 160.0, 120.0]), image_size=(320, 240))
    cfg.dtype = "float32"
    kern = DeviceKernels(cfg, device="cpu")
    w, _ = cs.bench_inputs(cfg, 1)
    cases = cs.eig_cases(kern, w)
    A = cases["4x4"] if copy is None else cases[f"{cs.MS_B}x{w.kp.shape[1]}x4x4"][copy]
    assert A.dtype == torch.float32 and A.shape == (w.kp.shape[1], 4, 4)
    gap, lim, sweeps = _model_against_eigh(A.double())
    assert gap <= lim, (gap, lim)
    assert 0 < min(sweeps) and max(sweeps) < eigh_op.MAX_SWEEPS, sweeps


# E2's algorithm on the CPU (`eigh_op.jacobi_model`: the small form up to
# WARP_N, the blocked form over tiles of TILE rows above it) against
# torch.linalg.eigh, within chip_smoke.eig_gap's float64 limit (1e-12 of
# the largest eigenvalue: eigenvalue gap, residual, orthonormality).


@pytest.mark.parametrize("zeroed", [0, 15])
@pytest.mark.parametrize("n", [15, 30, 60, 90, 105, 135, 150, 180, 210, 240])
def test_jacobi_model_is_eigh(n, zeroed):
    """Full-rank and rank-deficient marginalization-like matrices (the last
    15 rows and columns zero; at n <= 30, the last 5) at the sizes E2 takes:
    the 15x15 victim block, the prior at F = 2 (both in the small form, at
    its two paddings, 16 and 32) and at F = 4, 6, 7, 9, 10, 12, 14 and 16
    (the blocked form on clusters of 2 to 8 CTAs)."""
    import chip_smoke as cs

    z = zeroed if n > 30 else zeroed // 3
    A = torch.as_tensor(cs.marg_like(np.random.default_rng(n + zeroed), 1, n, z)[0])
    L, V, sweeps = eigh_op.jacobi_model(A)
    gap, lim = cs.eig_gap(A, L, V, torch.linalg.eigh(A)[0])
    assert gap <= lim, (gap, lim)
    assert 0 < sweeps < eigh_op.MAX_SWEEPS


def test_jacobi_model_one_block_is_eigh():
    """The earlier one-block kernel's scalar round-robin ordering over the
    whole matrix (`one_block`, which time_eig.py --facade-check compares
    with the blocked one), at n = 135 on a rank-deficient
    marginalization-like matrix: eigh within eig_gap's float64 limit below
    MAX_SWEEPS."""
    import chip_smoke as cs

    A = torch.as_tensor(cs.marg_like(np.random.default_rng(135), 1, 135)[0])
    L, V, sweeps = eigh_op.jacobi_model(A, one_block=True)
    gap, lim = cs.eig_gap(A, L, V, torch.linalg.eigh(A)[0])
    assert gap <= lim and 0 < sweeps < eigh_op.MAX_SWEEPS, (gap, sweeps)


def test_jacobi_model_converges_on_recorded_marginalization():
    """The two matrices one marg_step of the bench window (Config()'s 9
    frame slots, float32, at 320x240) decomposes, recorded as chip_smoke's
    phase 2 records them: the model converges below MAX_SWEEPS and matches
    eigh on each (the prior's float32 Schur complement is not exactly
    symmetric, so both read its lower triangle)."""
    import chip_smoke as cs
    from pvio_torch.core.kernels import DeviceKernels
    from pvio_torch.io.config import Config

    cfg = Config(camera_intrinsic=np.array([200.0, 200.0, 160.0, 120.0]), image_size=(320, 240))
    cfg.dtype = "float32"
    cfg.enable_plane_constraint = True
    kern = DeviceKernels(cfg, device="cpu")
    w, host = cs.bench_inputs(cfg, 1)
    cases = cs.marg_cases(kern, w, host)
    n_prior = cfg.window_frame_capacity * 15
    for key in ("15x15", f"{n_prior}x{n_prior}"):
        A = cases[key].double()
        A = torch.tril(A) + torch.tril(A, -1).mT
        L, V, sweeps = eigh_op.jacobi_model(A)
        gap, lim = cs.eig_gap(A, L, V, torch.linalg.eigh(A)[0])
        assert gap <= lim and 0 < sweeps < eigh_op.MAX_SWEEPS, (key, gap, sweeps)


def test_marginalization_through_the_model_matches_reference():
    """marginalize_and_remove with jacobi_model in the op's place (both of
    its decompositions) matches the reference's marginalize_and_remove at
    float64, as test_marginalization_goes_through_the_op_and_matches_reference
    holds the op: S^T S and S^T infovec within 1e-10 relative."""
    _, _, w, extr, _, wt, et = ba_window()
    cj, ct = bacfg(False)
    real, sizes = eigh_op.eigh, []

    def model(A):
        sizes.append(A.shape[-1])
        L, V, _ = eigh_op.jacobi_model(A)
        return L.to(A.dtype), V.to(A.dtype)

    eigh_op.eigh = model
    try:
        wmt = Tmarg.marginalize_and_remove(wt, et, ct, index=0)
    finally:
        eigh_op.eigh = real
    assert sizes == [15, wt.kp.shape[0] * 15]
    wmj = jax.jit(lambda w_: Jmarg.marginalize_and_remove(w_, extr, cj, index=0))(w)
    S_t, iv_t = npy(wmt.prior.sqrt_info), npy(wmt.prior.infovec)
    S_j, iv_j = np.asarray(wmj.prior.sqrt_info), np.asarray(wmj.prior.infovec)
    assert_rel(S_t.T @ S_t, S_j.T @ S_j, 1e-10, "S^T S")
    assert_rel(S_t.T @ iv_t, S_j.T @ iv_j, 1e-10, "S^T infovec")

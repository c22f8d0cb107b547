"""Parity of the initializer's two-view geometry: threefry keys, the 5-point
and 8-point essential solvers, homographies, hypothesis selection, the
two-view RANSACs and the trajectory alignment of `geometry/wahba.py`.

The same numpy inputs, made from a seed, go through `pvio_tpu` (jitted,
float64 on the CPU) and `pvio_torch` (float64, device="cpu"). Factors that
an eigendecomposition or SVD fixes only up to sign or basis (the 5-point
nullspace, E's singular vectors) are compared as what they determine:
E's up to scale and sign, the chosen (R, T), triangulated points and
counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_harness import assert_close, assert_same, npy, t64

from pvio_tpu.frontend import ransac as ransac_ref
from pvio_tpu.geometry import essential as ess_ref
from pvio_tpu.geometry import homography as hom_ref
from pvio_tpu.geometry import triangulation as tri_ref
from pvio_tpu.geometry import wahba as wahba_ref
from pvio_torch.frontend import ransac
from pvio_torch.geometry import essential as ess
from pvio_torch.geometry import homography as hom
from pvio_torch.geometry import triangulation as tri
from pvio_torch.geometry import wahba
from pvio_torch.utils import threefry


def _rot(rng, angle):
    w = rng.normal(size=3)
    w *= angle / np.linalg.norm(w)
    th = np.linalg.norm(w)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def two_view(seed, n=60, planar=False, angle=0.15, baseline=0.4, noise=0.0):
    """n correspondences x1, x2 (normalized) of points seen by camera 1 at
    the origin and camera 2 with x2 ~ R x1 + t."""
    rng = np.random.default_rng(seed)
    R = _rot(rng, angle)
    t = rng.normal(size=3)
    t *= baseline / np.linalg.norm(t)
    X = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.0, n),
                  np.full(n, 4.0) if planar else rng.uniform(3.0, 6.0, n)], axis=-1)
    if planar:
        X[:, 2] += 0.3 * X[:, 0]
    Y = X @ R.T + t
    x1 = X[:, :2] / X[:, 2:]
    x2 = Y[:, :2] / Y[:, 2:]
    x1 = x1 + rng.normal(size=x1.shape) * noise
    x2 = x2 + rng.normal(size=x2.shape) * noise
    return x1, x2, R, t


def _unit_sign(E):
    E = np.asarray(E, np.float64).reshape(-1, 9)
    E = E / np.linalg.norm(E, axis=-1, keepdims=True)
    i = np.argmax(np.abs(E), axis=-1)
    return E * np.sign(E[np.arange(len(E)), i])[:, None]


@pytest.mark.parametrize("seed", [0, 1, 648, 2**32 + 7])
def test_threefry_prngkey_and_split_bit_exact(seed):
    k_ref = jax.random.PRNGKey(seed)
    k = threefry.PRNGKey(seed)
    assert_same(k, np.asarray(k_ref), "PRNGKey")
    for depth in range(5):
        for num in (2, 3):
            assert_same(threefry.split(k, num), np.asarray(jax.random.split(k_ref, num)),
                        f"split depth {depth} num {num}")
        # the initializer's key stream: keep key 0, consume key 1
        k_ref, sub_ref = jax.random.split(k_ref)
        k, sub = threefry.split(k)
        assert_same(sub, np.asarray(sub_ref), "subkey")
        u_ref = jax.random.uniform(sub_ref, (3, 7))
        assert_same(threefry.uniform(sub, (3, 7), torch.float64), np.asarray(u_ref), "uniform")


@pytest.mark.parametrize("seed", [3, 11, 648])
def test_solve_essential_5pt_from_one_basis(seed):
    """From the reference's nullspace basis, the port's constraint matrix,
    Gauss-Jordan, z-polynomial, root scan and back-substitution give the
    reference's candidates in the reference's order at 1e-9."""
    x1, x2, R, t = two_view(seed, n=5)
    XYZW, _ = jax.jit(ess_ref._nullspace_basis)(jnp.asarray(x1), jnp.asarray(x2))

    def ref_from_basis(B):
        A = ess_ref._gauss_jordan(ess_ref._constraints_matrix(B))
        return A, ess_ref._poly_z_forms(A[:, 10:])

    A_ref, K_ref = jax.jit(ref_from_basis)(XYZW)
    B = t64(np.asarray(XYZW))
    A = ess._gauss_jordan(ess._constraints_matrix(B))
    assert_close(A, A_ref, 1e-9, "reduced constraint matrix")
    assert_close(ess._poly_z_forms(A[:, 10:]), K_ref, 1e-9, "K(z)")
    Es, m = ess._solve_from_basis(B)
    Es_ref, m_ref = jax.jit(ess_ref.solve_essential_5pt)(jnp.asarray(x1), jnp.asarray(x2))
    assert_same(m, m_ref, "root mask")
    mk = npy(m)
    assert_close(_unit_sign(npy(Es)[mk]), _unit_sign(np.asarray(Es_ref)[mk]), 1e-9, "E's")


@pytest.mark.parametrize("seed", [3, 11, 648])
def test_solve_essential_5pt_same_candidate_set(seed):
    """End to end the nullspace basis is LAPACK's choice within a 4-d
    eigenspace, so the candidates come in another order and carry another
    rounding: the same set, each E within 2e-6 of its reference twin
    (measured 9.7e-7 on seed 3), and the true E among them at 1e-6 (the
    reference's own candidate is 1.4e-7 off it on seed 3)."""
    x1, x2, R, t = two_view(seed, n=5)
    Es_ref, m_ref = jax.jit(ess_ref.solve_essential_5pt)(jnp.asarray(x1), jnp.asarray(x2))
    Es, m = ess.solve_essential_5pt(t64(x1), t64(x2))
    m_ref = np.asarray(m_ref)
    assert int(npy(m).sum()) == int(m_ref.sum()) >= 1
    a = _unit_sign(npy(Es)[npy(m)])
    b = _unit_sign(np.asarray(Es_ref)[m_ref])
    d = np.abs(a[:, None, :] - b[None, :, :]).max(axis=-1)
    assert d.min(axis=0).max() <= 2e-6, d.min(axis=0)
    assert d.min(axis=1).max() <= 2e-6, d.min(axis=1)
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E_true = _unit_sign((tx @ R)[None])
    assert np.abs(a - E_true).max(axis=-1).min() < 1e-6
    assert np.abs(b - E_true).max(axis=-1).min() < 1e-6


def test_solve_essential_8pt_and_decompose():
    x1, x2, R, t = two_view(5, n=30)
    E_ref = jax.jit(ess_ref.solve_essential_8pt)(jnp.asarray(x1), jnp.asarray(x2))
    E = ess.solve_essential_8pt(t64(x1), t64(x2))
    assert_close(_unit_sign(npy(E)[None]), _unit_sign(np.asarray(E_ref)[None]), 1e-9, "E 8pt")
    R1r, R2r, Tr = jax.jit(ess_ref.decompose_essential)(E_ref)
    R1, R2, T = ess.decompose_essential(t64(np.asarray(E_ref)))
    # {R1, R2} as a set, T up to sign
    Rr = np.stack([np.asarray(R1r), np.asarray(R2r)])
    Rp = np.stack([npy(R1), npy(R2)])
    d = np.abs(Rp[:, None] - Rr[None]).max(axis=(-1, -2))
    assert d.min(axis=1).max() <= 1e-9 and d.min(axis=0).max() <= 1e-9, d
    assert min(np.abs(npy(T) - np.asarray(Tr)).max(), np.abs(npy(T) + np.asarray(Tr)).max()) <= 1e-9
    assert min(np.abs(Rp - R).max(axis=(-1, -2))) < 1e-6


@pytest.mark.parametrize("planar", [True, False])
def test_homography_solve_and_decompose(planar):
    x1, x2, _, _ = two_view(7, n=4 if planar else 12, planar=True)
    H_ref = jax.jit(hom_ref.solve_homography)(jnp.asarray(x1), jnp.asarray(x2))
    H = hom.solve_homography(t64(x1), t64(x2))
    assert_close(H, H_ref, 1e-9, "H")
    assert_close(hom.inv3(H), hom_ref.inv3(H_ref), 1e-9, "inv3")
    assert_close(hom.homography_geometric_error(H, t64(x1), t64(x2)),
                 hom_ref.homography_geometric_error(H_ref, x1, x2), 1e-12, "transfer error")
    out_ref = jax.jit(hom_ref.decompose_homography)(H_ref)
    out = hom.decompose_homography(t64(np.asarray(H_ref)))
    for a, b, name in zip(out, out_ref, ("Rs", "Ts", "ns", "pure_rot")):
        assert_close(a, b, 1e-9, name)


def test_decompose_homography_pure_rotation():
    rng = np.random.default_rng(9)
    R = _rot(rng, 0.2)
    H = 1.7 * R
    out_ref = jax.jit(hom_ref.decompose_homography)(jnp.asarray(H))
    out = hom.decompose_homography(t64(H))
    assert bool(out[3]) and bool(out_ref[3])
    for a, b, name in zip(out, out_ref, ("Rs", "Ts", "ns")):
        assert_close(a, b, 1e-9, name)
    assert_close(out[0][0], R, 1e-9, "R")


def _hypotheses(E, H):
    """The initializer's 8 candidates (initializer.py:199-206), numpy."""
    R1, R2, T = (np.asarray(a) for a in ess_ref.decompose_essential(jnp.asarray(E)))
    RsH, TsH, _, _ = (np.asarray(a) for a in hom_ref.decompose_homography(jnp.asarray(H)))

    def nrm(v):
        return v / max(np.linalg.norm(v), 1e-12)

    Rs = np.stack([RsH[0], RsH[0], RsH[1], RsH[1], R1, R1, R2, R2])
    Ts = np.stack([nrm(TsH[0]), -nrm(TsH[0]), nrm(TsH[1]), -nrm(TsH[1]),
                   nrm(T), -nrm(T), nrm(T), -nrm(T)])
    return Rs, Ts


@pytest.mark.parametrize("prior", [False, True])
def test_select_rt_hypothesis(prior):
    x1, x2, R, t = two_view(21, n=80, noise=1e-3)
    E = np.asarray(ess_ref.solve_essential_8pt(jnp.asarray(x1), jnp.asarray(x2)))
    H = np.asarray(hom_ref.solve_homography(jnp.asarray(x1), jnp.asarray(x2)))
    Rs, Ts = _hypotheses(E, H)
    kw = dict(count_threshold=15)
    if prior:
        kw.update(prior_max_angle=np.deg2rad(10.0))
    ref = jax.jit(lambda a, b, c, d, Rp: tri_ref.select_rt_hypothesis(
        a, b, c, d, R_prior=Rp if prior else None, **kw))(Rs, Ts, x1, x2, R)
    out = tri.select_rt_hypothesis(t64(Rs), t64(Ts), t64(x1), t64(x2),
                                   R_prior=t64(R) if prior else None, **kw)
    best, best_ref = int(out[0]), int(ref[0])
    assert_close(Rs[best], Rs[best_ref], 1e-12, "chosen R")
    assert_close(Ts[best], Ts[best_ref], 1e-12, "chosen T")
    assert_same(out[2], ref[2], "status")
    assert int(out[3]) == int(ref[3])
    st = npy(out[2])
    assert_close(npy(out[1])[st], np.asarray(ref[1])[st], 1e-9, "points")
    assert_close(Rs[best], R, 1e-2, "true rotation")


def _ransac_inputs(seed, n=70, N=96, outliers=10):
    x1, x2, _, _ = two_view(seed, n=n, noise=5e-4)
    rng = np.random.default_rng(seed + 100)
    x2[:outliers] += rng.uniform(-0.2, 0.2, size=(outliers, 2))
    x1p = np.zeros((N, 2))
    x2p = np.zeros((N, 2))
    mp = np.zeros(N, bool)
    x1p[:n], x2p[:n], mp[:n] = x1, x2, True
    return x1p, x2p, mp


@pytest.mark.parametrize("seed", [31, 648])
def test_find_essential_same_model(seed):
    x1, x2, m = _ransac_inputs(seed)
    key = np.asarray(jax.random.split(jax.random.PRNGKey(648))[1])
    thr = 0.7 / 200.0
    E_ref, inl_ref, c_ref = jax.jit(lambda k, a, b, c: ransac_ref.find_essential(
        k, a, b, c, threshold=thr))(key, x1, x2, m)
    E, inl, c = ransac.find_essential(key, t64(x1), t64(x2), torch.as_tensor(m), threshold=thr)
    assert int(c) == int(c_ref)
    assert_same(inl, inl_ref, "inliers")
    assert_close(_unit_sign(npy(E)[None]), _unit_sign(np.asarray(E_ref)[None]), 1e-9, "E")


@pytest.mark.parametrize("seed", [41, 648])
def test_find_homography_same_model(seed):
    rng = np.random.default_rng(seed)
    x1, x2, _, _ = two_view(seed, n=70, planar=True, noise=5e-4)
    x2[:8] += rng.uniform(-0.2, 0.2, size=(8, 2))
    N = 96
    x1p, x2p, mp = np.zeros((N, 2)), np.zeros((N, 2)), np.zeros(N, bool)
    x1p[:70], x2p[:70], mp[:70] = x1, x2, True
    key = np.asarray(jax.random.split(jax.random.PRNGKey(seed))[1])
    thr = 0.7 / 200.0
    H_ref, inl_ref, c_ref = jax.jit(lambda k, a, b, c: ransac_ref.find_homography(
        k, a, b, c, threshold=thr))(key, x1p, x2p, mp)
    H, inl, c = ransac.find_homography(key, t64(x1p), t64(x2p), torch.as_tensor(mp),
                                       threshold=thr)
    assert int(c) == int(c_ref)
    assert_same(inl, inl_ref, "inliers")
    assert_close(H, H_ref, 1e-9, "H")


def test_wahba_find_srt_and_ate():
    rng = np.random.default_rng(12)
    gt = rng.normal(size=(40, 3))
    R = _rot(rng, 0.7)
    est = 0.8 * gt @ R.T + np.array([0.3, -1.0, 2.0]) + rng.normal(size=gt.shape) * 1e-2
    s_r, R_r, t_r = jax.jit(wahba_ref.find_srt)(est, gt)
    s, Rp, tp = wahba.find_srt(t64(est), t64(gt))
    assert_close(s, s_r, 1e-12, "scale")
    assert_close(Rp, R_r, 1e-12, "R")
    assert_close(tp, t_r, 1e-12, "t")
    for with_scale in (True, False):
        a_r = jax.jit(lambda a, b: wahba_ref.ate_rmse(a, b, with_scale=with_scale))(est, gt)
        assert_close(wahba.ate_rmse(t64(est), t64(gt), with_scale=with_scale), a_r, 1e-12,
                     f"ate with_scale={with_scale}")

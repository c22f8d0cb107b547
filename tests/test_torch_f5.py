"""Fault F5: the float32 blob facade parted card from CPU after the first
marginalization (2.6e-3 m at frame 25, against the 1e-4 m of
`tests/test_torch_cuda.py::test_facade_on_card_matches_cpu`, with no host
decision differing).

The victim's Schur complement cancels entries of ~1e7, so in float32 its
rounding (negative eigenvalues of ~1e2) picks the prior's retained
eigenspace; and the BA after it, not converged in its 8 LM steps, takes
its weakest directions from a float32 Gram product and Cholesky of a
system whose eigenvalues span ~1e7. Two devices round differently there.
The marginalization and every LM step now compute in float64 whatever the
window's dtype. Here, on the CPU, the eigensolver stands in for the
device: the card's E2 algorithm (`ops/eigh.jacobi_model`) against LAPACK,
in the marginalization, on the test's stream at float32.
"""

import pytest
import torch

from pvio_torch.estimation import ba as ba_mod
from pvio_torch.estimation import marginalization as marg
from pvio_torch.map import window as win
from pvio_torch.ops import eigh as eigh_op
from tests.test_torch_cuda import MAX_FACADE_INIT_DP_M, SMALL, _blob_stream

N_FRAMES = 36          # the first marginalization comes at frame 25


@pytest.fixture(scope="module")
def runs():
    """The float32 facade on the CPU over N_FRAMES frames, the
    marginalization's decompositions by LAPACK and by E2's algorithm, and
    the inputs of the first marginalization."""
    import chip_smoke as cs

    scene, images = _blob_stream()
    real_eigh, real_marg = eigh_op.eigh, marg.marginalize_and_remove
    first = []

    def capture(w, extr, cfg, index=0):
        if not first:
            first.append((w, extr, cfg, index))
        return real_marg(w, extr, cfg, index)

    def e2_algorithm(A):
        if A.shape[-1] < 5:               # the 4x4 DLTs: as the plain run
            return real_eigh(A)
        L, V, _ = eigh_op.jacobi_model(A)
        return L.to(A.dtype), V.to(A.dtype)

    out = {}
    for name, solve in (("lapack", real_eigh), ("e2", e2_algorithm)):
        eigh_op.eigh, marg.marginalize_and_remove = solve, capture
        try:
            out[name] = cs.run_facade(cs.facade_config(**SMALL), scene, images, device="cpu",
                                      n_frames=N_FRAMES)
        finally:
            eigh_op.eigh, marg.marginalize_and_remove = real_eigh, real_marg
    return out, first[0], scene


def _reduced_information(w, extr, cfg, index):
    """The matrix whose eigen-decomposition `marginalize_and_remove` makes
    the prior of, at the window's dtype (the reference's arithmetic)."""
    F = w.kp.shape[0]
    H, _ = marg.accumulate_information(w, extr, cfg, index)
    sl = slice(index * 15, (index + 1) * 15)
    Hk = H[:, sl]
    H2 = H - Hk @ marg._clamped_pinv(H[sl, sl]) @ Hk.T
    keep = torch.ones(F * 15, dtype=torch.bool)
    keep[sl] = False
    return H2[keep][:, keep]


def test_float32_schur_complement_is_rounding_dominated(runs):
    """At float32 the first marginalization's Schur complement has
    eigenvalues below -1e-6 of its largest (a positive semi-definite matrix
    has none); built in float64 from the same float32 window its most
    negative eigenvalue lies within 1e-9 of its largest."""
    _, (w, extr, cfg, index), _ = runs
    assert w.p.dtype == torch.float32
    lam32 = torch.linalg.eigvalsh(_reduced_information(w, extr, cfg, index).double())
    lam64 = torch.linalg.eigvalsh(_reduced_information(win.as_float64(w), win.as_float64(extr),
                                                      cfg, index))
    print(f"float32 Schur complement: eigenvalues {float(lam32[0]):.4g} .. {float(lam32[-1]):.4g}; "
          f"float64: {float(lam64[0]):.4g} .. {float(lam64[-1]):.4g}")
    assert float(lam32[0]) < -1e-6 * float(lam32[-1])
    assert float(lam64[0]) > -1e-9 * float(lam64[-1])


def test_marginalization_and_lm_step_compute_in_float64(runs):
    """A float32 window's prior comes back at float32 and its LM step
    returns float64 costs and a float32 window."""
    _, (w, extr, cfg, index), _ = runs
    w2 = marg.marginalize_and_remove(w, extr, cfg, index)
    assert w2.prior.sqrt_info.dtype == w2.prior.infovec.dtype == torch.float32
    w3, c0, c1 = ba_mod._lm_step(w2, extr, cfg, torch.tensor(1e-4, dtype=torch.float32))
    assert c0.dtype == c1.dtype == torch.float64 and w3.p.dtype == torch.float32
    assert torch.isfinite(c0) and torch.isfinite(c1)


def test_facade_is_independent_of_the_eigensolver(runs):
    """LAPACK and E2's algorithm in the marginalization: the same
    initialization, keyframes and host decisions, and positions within the
    card test's bound before a differing decision, over every pose."""
    import chip_smoke as cs

    out, _, scene = runs
    a, b = out["e2"], out["lapack"]
    assert a["init_fi"] == b["init_fi"] is not None and a["keyframes"] == b["keyframes"]
    flip, _, dp = cs.facade_gap(a, b, scene)
    print(f"E2's algorithm vs LAPACK in the marginalization, float32, {len(a['traj'])} poses: "
          f"first decision flip {flip}, max |dp| {dp:.3e} m")
    assert flip is None and dp <= MAX_FACADE_INIT_DP_M, (flip, dp)

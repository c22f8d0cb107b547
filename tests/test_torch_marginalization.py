"""Port parity of the frame marginalization (`estimation/marginalization.py`),
pvio_torch vs pvio_tpu on the CPU at float64, on the small configuration's
perturbed window with its initial prior (tests/test_torch_factors_ba.py).

`eigh` fixes neither the eigenvectors' signs nor the basis inside a
repeated eigenvalue, in either library, so the new prior is compared through
what a solve uses of it: S^T S and S^T infovec, within 1e-8 of their
largest entry, and through the solve that follows (states 1e-8). The
accumulated information is the same sums in another order (1e-12 of its
largest entry); index sets, flags and masks are identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvio_tpu.estimation import ba as Jba, marginalization as Jmarg
from pvio_torch.estimation import ba as Tba, marginalization as Tmarg
from tests.test_torch_factors_ba import (STATE_FIELDS, assert_window_close, ba_window, bacfg,
                                         to_port)
from tests.test_torch_harness import assert_close, assert_rel, assert_same, npy, t64

torch.set_num_threads(2)


def invariants(prior):
    S, iv = npy(prior.sqrt_info), npy(prior.infovec)
    return S.T @ S, S.T @ iv


def assert_prior_matches(pt, pj, what):
    (StS_t, Siv_t), (StS_j, Siv_j) = invariants(pt), invariants(pj)
    assert_rel(StS_t, StS_j, 1e-8, f"{what} S^T S")
    assert_rel(Siv_t, Siv_j, 1e-8, f"{what} S^T infovec")
    for f in ("q0", "p0", "v0", "bg0", "ba0"):
        assert_close(getattr(pt, f), getattr(pj, f), 1e-12, f"{what} {f}")
    assert bool(npy(pt.valid)) == bool(np.asarray(pj.valid))


@pytest.mark.parametrize("index", [0, 2])
def test_accumulate_information_matches_reference(index):
    _, _, w, extr, _, wt, et = ba_window()
    cj, ct = bacfg(False)
    Hj, bj = jax.jit(lambda w_: Jmarg.accumulate_information(w_, extr, cj, index))(w)
    Ht, bt = Tmarg.accumulate_information(wt, et, ct, index)
    assert_rel(Ht, Hj, 1e-12, "H")
    assert_rel(bt, bj, 1e-12, "b")
    M = npy(Ht)[index * 15:(index + 1) * 15, index * 15:(index + 1) * 15]
    assert_rel(Tmarg._clamped_pinv(t64(M)), jax.jit(Jmarg._clamped_pinv)(jnp.asarray(M)), 1e-9,
               "clamped pinv")


def test_make_initial_prior_matches_reference():
    _, _, w, _, _, wt, _ = ba_window()
    for index in (0, 2):
        for yaw_only in (True, False):
            pj = Jmarg.make_initial_prior(w, index=index, yaw_only=yaw_only)
            pt = Tmarg.make_initial_prior(wt, index=index, yaw_only=yaw_only)
            assert_close(pt.sqrt_info, pj.sqrt_info, 1e-12, "sqrt_info")
            assert_close(pt.infovec, pj.infovec, 0.0, "infovec")
            assert_close(pt.q0, pj.q0, 0.0, "q0")


def test_rebase_tracks_matches_reference():
    """Tracks referenced to slot 0 move to their next observing slot (the
    first one: argmax's first-index rule over a bool mask cast to int);
    tracks seen only in slot 0 are dropped."""
    _, _, w, extr, info, wt, et = ba_window()
    # one track seen by slot 0 alone, to be dropped
    w = w._replace(obs_mask=w.obs_mask.at[1:, 4].set(False))
    wt = to_port(w)
    wj = jax.jit(lambda w_: Jmarg.rebase_tracks(w_, extr, removed_slot=0))(w)
    wr = Tmarg.rebase_tracks(wt, et, removed_slot=0)
    for f in ("ref_frame", "track_flags", "track_mask"):
        assert_same(getattr(wr, f), getattr(wj, f), f)
    assert_close(wr.inv_depth, wj.inv_depth, 1e-12, "inv_depth")
    moved = npy(wr.ref_frame) != npy(wt.ref_frame)
    assert moved.sum() > 20 and not npy(wr.track_mask)[4]


def test_marginalize_and_remove_matches_reference():
    """rebase + marginalize slot 0 (the reference's `marginalize0`): the
    shifted window identical or within 1e-12, the prior's invariants within
    1e-8; then a re-solve of the reduced window, the gauge held by the
    prior alone, agrees to 1e-8."""
    _, _, w, extr, _, wt, et = ba_window()
    cj, ct = bacfg(False)

    wmj = jax.jit(lambda w_: Jmarg.marginalize_and_remove(
        Jmarg.rebase_tracks(w_, extr, removed_slot=0), extr, cj, index=0))(w)
    wmt = Tmarg.marginalize_and_remove(Tmarg.rebase_tracks(wt, et, removed_slot=0), et, ct,
                                       index=0)
    for f in STATE_FIELDS + ("bg_lin", "ba_lin", "kp"):
        assert_close(getattr(wmt, f), getattr(wmj, f), 1e-12, f)
    for f in ("frame_mask", "fix_mask", "delta_valid", "obs_mask", "ref_frame", "track_mask",
              "track_flags"):
        assert_same(getattr(wmt, f), getattr(wmj, f), f)
    for a, b in zip(wmt.delta, wmj.delta):
        assert_close(a, b, 0.0, "delta")
    assert_prior_matches(wmt.prior, wmj.prior, "marginalized")
    assert float(np.abs(invariants(wmt.prior)[0]).max()) > 1e3

    wmj = wmj._replace(fix_mask=jnp.zeros_like(wmj.fix_mask))
    wmt = wmt._replace(fix_mask=torch.zeros_like(wmt.fix_mask))
    wsj, ij = jax.jit(lambda w_: Jba.solve(w_, extr, cj))(wmj)
    wst, it = Tba.solve(wmt, et, ct)
    assert_window_close(wst, wsj, 1e-8, "solve after marginalization")
    assert int(it["accepted"]) == int(ij["accepted"])
    assert_rel(it["final_cost"], ij["final_cost"], 1e-9, "final cost")

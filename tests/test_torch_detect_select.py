"""Poisson-disk selection behind `select_candidates` (the custom op
`pvio::poisson_select`, kernel S1 on the card) and the two custom ops under
`torch.func.vmap`, on the CPU.

Tolerances: selection masks, detection masks and round counts identical;
detected positions 1e-12 against the reference (float64, as in
test_torch_frontend); vmapped calls equal single calls bit for bit (the
CPU implementations run the plain version image by image).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

import chip_smoke as cs
from pvio_tpu.frontend import detect as Jdet
from pvio_torch.frontend import detect as Tdet
from pvio_torch.ops import poisson, stencil
from tests.test_torch_harness import assert_close, assert_same, t64

torch.set_num_threads(2)
TOL = 1e-12


def _greedy(cand, alive, min_distance):
    """Sequential greedy Poisson-disk selection in candidate order, in
    numpy: take a candidate when it is alive and no taken one is near."""
    d2 = min_distance * min_distance
    taken = []
    for i in range(len(cand)):
        if alive[i] and all(((cand[i] - cand[j]) ** 2).sum() >= d2 for j in taken):
            taken.append(i)
    out = np.zeros(len(cand), bool)
    out[taken] = True
    return out


@functools.partial(jax.jit, static_argnums=2)
def _reference_rounds(cand, alive, d2):
    """The reference's selection rounds as `detect_keypoints` runs them
    (pvio_tpu/frontend/detect.py:124-151; d2 a Python float, weakly typed as
    there), returning the selected mask and the round count."""
    dist2 = jnp.sum((cand[:, None, :] - cand[None, :, :]) ** 2, axis=-1)
    near = dist2 < d2
    C_ = cand.shape[0]
    ii = jax.lax.broadcasted_iota(jnp.int32, (C_, C_), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (C_, C_), 1)
    dominates = near & (jj < ii)

    def round_(carry):
        alive, selected, n = carry
        dominated = jnp.any(dominates & alive[None, :], axis=1)
        winners = alive & ~dominated
        selected = selected | winners
        killed = jnp.any(near & winners[None, :], axis=1) & ~winners
        return alive & ~winners & ~killed, selected, n + 1

    def not_done(carry):
        alive, _, n = carry
        return jnp.any(alive) & (n < C_)

    _, selected, n = jax.lax.while_loop(not_done, round_,
                                        (alive, jnp.zeros_like(alive), jnp.int32(0)))
    return selected, n


SELECTION_CASES = [name for name, _, _, _ in cs.selection_cases(torch.float64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", range(len(SELECTION_CASES)), ids=SELECTION_CASES)
def test_selection_edge_cases_match_reference_rounds(case, dtype):
    """S1's edge cases (`chip_smoke.selection_cases`, which the card test of
    the kernel reuses): the plain rounds loop equals the reference's
    lax.while_loop rounds bit for bit, round count included, and the
    sequential greedy selection."""
    name, cand, alive, md = cs.selection_cases(dtype)[case]
    sel = poisson.select_candidates(cand, alive, md)
    rounds = poisson.LAST_ROUNDS
    sel_j, n_j = _reference_rounds(jnp.asarray(cand.numpy()), jnp.asarray(alive.numpy()),
                                   md * md)
    assert_same(sel, sel_j, name)
    assert rounds == int(n_j), (name, rounds, int(n_j))
    assert_same(sel, _greedy(cand.numpy(), alive.numpy(), md), f"{name}: sequential greedy")


def _candidates(rng, C, extent, dtype):
    cand = rng.uniform(0.0, extent, size=(C, 2))
    # pairs exactly min_distance (12) apart: not near (dist2 < d2 is false)
    cand[1] = cand[0] + [12.0, 0.0]
    cand[3] = cand[2] + [0.0, 12.0]
    alive = rng.uniform(size=C) < 0.85
    return torch.as_tensor(cand, dtype=dtype), torch.as_tensor(alive)


def _chain_image(H=240, W=320, step=10.0, sigma=1.6):
    """Rows of blobs 10 px apart (under the 12 px min_distance) with
    falling amplitude: each blob's candidates are dominated by the previous
    blob's, so the greedy chain runs many rounds deep."""
    yy, xx = np.mgrid[0:H, 0:W].astype(float)
    img = np.zeros((H, W))
    for y in range(40, H - 40, 40):
        n = int((W - 80) // step)
        for k in range(n):
            x = 40 + k * step
            img += (1.0 - 0.6 * k / n) * np.exp(
                -((xx - x) ** 2 + (yy - y - 0.3 * k) ** 2) / (2 * sigma ** 2))
    return np.clip(img, 0.0, 1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("C,extent", [(4, 10.0), (64, 60.0), (300, 150.0), (1024, 400.0)])
def test_select_candidates_is_the_rounds_loop_and_greedy(C, extent, dtype):
    cand, alive = _candidates(np.random.default_rng(C), C, extent, dtype)
    sel = poisson.select_candidates(cand, alive, 12.0)
    rounds = poisson.LAST_ROUNDS
    plain = poisson.select_candidates_plain(cand, alive, 12.0)
    assert sel.dtype == torch.bool and sel.shape == (C,)
    assert_same(sel, plain, "op vs rounds loop")
    assert rounds == poisson.LAST_ROUNDS
    assert_same(sel, _greedy(cand.numpy(), alive.numpy(), 12.0), "op vs sequential greedy")
    assert bool(sel[0]) == bool(alive[0])      # the first candidate wins when alive


def test_select_candidates_runs_to_exhaustion_on_a_deep_chain():
    """Candidates 0.9 min_distance apart on a line: each round takes one
    more link of the chain, so the rounds equal half its length."""
    n = 25
    cand = torch.as_tensor(np.stack([np.arange(n) * 10.8, np.zeros(n)], axis=-1))
    alive = torch.ones(n, dtype=torch.bool)
    sel = poisson.select_candidates(cand, alive, 12.0)
    assert poisson.LAST_ROUNDS == 13
    assert_same(sel, np.arange(n) % 2 == 0, "every other link")


def test_detect_keypoints_matches_reference_on_a_deep_selection():
    """An image whose selection takes more than 5 rounds: the port's
    detection equals the reference's lax.while_loop selection."""
    img = _chain_image()
    xy_j, m_j = Jdet.detect_keypoints(jnp.asarray(img), max_keypoints=60, min_distance=12.0)
    xy_t, m_t = Tdet.detect_keypoints(t64(img), max_keypoints=60, min_distance=12.0)
    assert poisson.LAST_ROUNDS > 5, poisson.LAST_ROUNDS
    assert_same(m_t, m_j, "mask")
    assert int(np.asarray(m_j).sum()) >= 30
    assert_close(xy_t, xy_j, TOL, "xy")


def test_custom_ops_vmap_equals_single_calls_on_cpu():
    """torch.func.vmap over B = 3 of K1's op (the plain version on the
    CPU), of the selection op and of detect_keypoints equals three single
    calls bit for bit, and launches nothing."""
    rng = np.random.default_rng(11)
    imgs = torch.as_tensor(np.stack([_chain_image(), rng.uniform(size=(240, 320)),
                                     _chain_image(step=11.0)]))
    k1, s1 = stencil.LAUNCHES, poisson.LAUNCHES
    resp_b = vmap(stencil.shi_tomasi_response)(imgs)
    for b in range(3):
        assert torch.equal(resp_b[b], Tdet.shi_tomasi_response(imgs[b]))
    cands = [_candidates(np.random.default_rng(b), 200, 120.0, torch.float64) for b in range(3)]
    cand_b = torch.stack([c for c, _ in cands])
    alive_b = torch.stack([a for _, a in cands])
    sel_b = vmap(poisson.select_candidates, in_dims=(0, 0, None))(cand_b, alive_b, 12.0)
    for b in range(3):
        assert torch.equal(sel_b[b], poisson.select_candidates_plain(cand_b[b], alive_b[b], 12.0))
    # one alive mask shared by every image (in_dims None)
    sel_s = vmap(poisson.select_candidates, in_dims=(0, None, None))(cand_b, alive_b[0], 12.0)
    for b in range(3):
        assert torch.equal(sel_s[b], poisson.select_candidates_plain(cand_b[b], alive_b[0], 12.0))

    def det(img):
        return Tdet.detect_keypoints(img, max_keypoints=60, min_distance=12.0)

    xy_b, m_b = vmap(det)(imgs)
    for b in range(3):
        xy, m = det(imgs[b])
        assert torch.equal(xy_b[b], xy) and torch.equal(m_b[b], m)
    assert (stencil.LAUNCHES, poisson.LAUNCHES) == (k1, s1)


def test_selection_wrapper_refuses_cpu_tensors():
    cand, alive = _candidates(np.random.default_rng(0), 16, 50.0, torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        poisson.poisson_select_cuda(cand, alive, 12.0)
    n_bytes, ops = poisson.cost([16, 3], 16)
    assert n_bytes == 2 * 16 * (2 * 4 + 2) and ops == poisson.OPS_PER_PAIR * (120 + 3)

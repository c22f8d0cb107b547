"""Keypoint detection: Shi-Tomasi response + Poisson-disk-spaced top-K.

Matches `pvio_tpu/frontend/detect.py`: `shi_tomasi_response` (the plain
version of kernel K1 and its oracle), `_nms`, `detect_keypoints` (split
here into `candidates` and the selection) and `poisson_disk_filter`
(which, as in the reference, no pipeline step calls).

Two details carry the reference's results:
  * `lax.top_k` orders ties by lower index, and the greedy-equivalence of
    the parallel Poisson-disk rounds depends on it; `torch.topk` promises
    no tie order, so candidates come from a stable descending sort.
  * the selection rounds run to exhaustion (an early "enough selected"
    exit would change the result). They sit behind `select_candidates`
    (`ops/poisson.py`, the custom op `pvio::poisson_select`): on the CPU the
    plain rounds loop, on the card kernel S1, which runs every round on the
    device, so detection reads nothing back to the host there.
"""

import torch
import torch.nn.functional as F

from pvio_torch.frontend import image as img_ops
from pvio_torch.ops.poisson import select_candidates


def shi_tomasi_response(img, window=3):
    """Min-eigenvalue corner response (GFTT's score), same shape as img."""
    Ix, Iy = img_ops.gradients(img)
    k = [[1.0 / (window * window)] * window] * window
    a = img_ops._conv2(Ix * Ix, k)
    b = img_ops._conv2(Ix * Iy, k)
    c = img_ops._conv2(Iy * Iy, k)
    tr = 0.5 * (a + c)
    det = torch.sqrt(torch.clamp((0.5 * (a - c)) ** 2 + b * b, min=0.0))
    return tr - det


def _nms(resp, radius=1):
    """(2r+1)^2 non-maximum suppression mask (-inf outside the image)."""
    m = F.max_pool2d(resp[None, None], 2 * radius + 1, stride=1, padding=radius)[0, 0]
    return resp >= m


def _sorted_desc(x):
    """Values and indices sorted descending, ties by lower index first
    (`lax.top_k` order)."""
    return torch.sort(x, descending=True, stable=True)


def candidates(
    img,
    min_distance=20.0,
    existing_xy=None,
    existing_mask=None,
    border=20,
    quality_level=1e-3,
    min_response=1e-8,
    num_candidates=1024,
    response=None,
):
    """The response-sorted corner candidates of `detect_keypoints` before
    the Poisson-disk selection: (cand (C, 2) sub-pixel positions, alive (C,)
    past the quality gate and clear of the existing keypoints)."""
    H, W = img.shape
    dtype, dev = img.dtype, img.device
    resp = shi_tomasi_response(img) if response is None else response
    keep = _nms(resp)
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    inb = (xx >= border) & (xx < W - border) & (yy >= border) & (yy < H - border)
    resp_m = torch.where(keep & inb, resp, torch.full_like(resp, -torch.inf))

    flat = resp_m.reshape(-1)
    C = min(num_candidates, flat.shape[0])
    scores, idx = _sorted_desc(flat)
    scores, idx = scores[:C], idx[:C]
    ix = idx % W
    iy = idx // W
    ixc = torch.clamp(ix, 1, W - 2)
    iyc = torch.clamp(iy, 1, H - 2)
    r0 = resp[iyc, ixc]
    rl = resp[iyc, ixc - 1]
    rr = resp[iyc, ixc + 1]
    ru = resp[iyc - 1, ixc]
    rd = resp[iyc + 1, ixc]
    denx = rl - 2 * r0 + rr
    deny = ru - 2 * r0 + rd
    zero = torch.zeros_like(denx)
    dx = torch.where(torch.abs(denx) > 1e-12, 0.5 * (rl - rr) / denx, zero)
    dy = torch.where(torch.abs(deny) > 1e-12, 0.5 * (ru - rd) / deny, zero)
    dx = torch.clamp(dx, -0.5, 0.5)
    dy = torch.clamp(dy, -0.5, 0.5)
    cand = torch.stack([ix.to(dtype) + dx, iy.to(dtype) + dy], dim=-1)  # (C, 2)
    floor = torch.clamp(scores[0] * quality_level, min=min_response)
    alive = (scores > floor) & torch.isfinite(scores)

    d2 = min_distance * min_distance
    if existing_xy is not None:
        dist2 = torch.sum((cand[:, None, :] - existing_xy[None, :, :]) ** 2, dim=-1)
        if existing_mask is not None:
            dist2 = torch.where(existing_mask[None, :], dist2,
                                torch.full_like(dist2, torch.inf))
        alive = alive & torch.all(dist2 >= d2, dim=1)
    return cand, alive


def detect_keypoints(
    img,
    max_keypoints=150,
    min_distance=20.0,
    existing_xy=None,
    existing_mask=None,
    border=20,
    quality_level=1e-3,
    min_response=1e-8,
    num_candidates=1024,
    response=None,
):
    """Detect up to `max_keypoints` corners with Poisson-disk spacing.

    img (H, W) in [0, 1]; response: optional precomputed corner response
    (shared with the KLT gate). existing_xy (E, 2) / existing_mask (E,)
    suppress nearby detections. Returns (xy (K, 2) pixels, mask (K,))."""
    dtype, dev = img.dtype, img.device
    cand, alive = candidates(img, min_distance, existing_xy, existing_mask, border,
                             quality_level, min_response, num_candidates, response)
    C = cand.shape[0]

    # exact greedy Poisson-disk selection in parallel rounds: a candidate
    # wins when no alive earlier-sorted candidate is near it
    selected = select_candidates(cand, alive, min_distance)
    ar = torch.arange(C, device=dev)

    # first K selected in response order
    K = max_keypoints
    Kc = min(K, C)
    key = torch.where(selected, -ar, torch.full_like(ar, -C - 1))
    topv, topi = _sorted_desc(key)
    topv, topi = topv[:Kc], topi[:Kc]
    sel_mask = topv > -C - 1
    sel_xy = torch.where(sel_mask[:, None], cand[topi], torch.zeros_like(cand[topi]))
    if Kc < K:
        sel_xy = torch.cat([sel_xy, torch.zeros((K - Kc, 2), dtype=dtype, device=dev)])
        sel_mask = torch.cat([sel_mask, torch.zeros(K - Kc, dtype=torch.bool, device=dev)])
    return sel_xy, sel_mask


def poisson_disk_filter(xy, score, mask, min_distance, max_out):
    """Standalone greedy Poisson-disk culling of a point set, highest score
    first (ties by lower index). Returns (indices (max_out,), keep_mask);
    unused entries hold index 0 and False."""
    dev = xy.device
    d2 = min_distance * min_distance
    alive = torch.ones(xy.shape[0], dtype=torch.bool, device=dev)
    sel_idx = torch.zeros(max_out, dtype=torch.int64, device=dev)
    sel_mask = torch.zeros(max_out, dtype=torch.bool, device=dev)
    neg_inf = torch.full_like(score, -torch.inf)
    for k in range(max_out):
        s = torch.where(alive & mask, score, neg_inf)
        i = torch.argmax(s)
        ok = s[i] > -torch.inf
        sel_idx[k] = torch.where(ok, i, torch.zeros_like(i))
        sel_mask[k] = ok
        dist2 = torch.sum((xy - xy[i]) ** 2, dim=-1)
        alive = alive & (~ok | (dist2 >= d2))
    return sel_idx, sel_mask

"""Pyramidal Lucas-Kanade tracking, batched over keypoints.

Matches the outputs of `pvio_tpu/frontend/klt.py::track_keypoints` (with
`_track_level` and `_bilinear`): 21x21 patches, a gain/bias-invariant
Gauss-Newton per level (`klt.py:203-230`), fewer iterations on the coarse
levels, the corner-response trackability gate sampled from the shared
response maps or, without them, the per-patch `min_eig_response`
(`klt.py:390-395`), and the forward-backward gate
(`klt.py:399-413`).

The reference samples patches with banded one-hot matmuls on per-keypoint
(32, 256) windows, a TPU layout (`klt.py:78-146`). Here a bilinear gather
from the padded image replaces the matmuls, and everything in that layout
that changes results is reproduced:
  * every level is edge-padded to at least 32 x 256 (and to multiples of
    8 x 128) before tracking (`klt.py:167-172`);
  * the window origins are clamped exactly as `_extract_windows` does
    (`klt.py:97-99`); the next-image window stays where the initial guess
    put it for all iterations;
  * a patch that leaves its window is sampled at the clamped position, and
    the final residual's `ok` flag sets err = inf (`klt.py:115`, `:241`);
  * the dx/dy step and flow clips (`klt.py:228-230`);
  * `_bilinear`'s W - 1.001 clamp (`klt.py:24-25`).
"""

import torch
import torch.nn.functional as F

WIN_H = 32    # per-keypoint search window rows
WIN_W = 256   # per-keypoint search window columns


def _bilinear(img, xy):
    """Sample img (H, W) at xy (..., 2) pixel coords, clamped borders."""
    H, W = img.shape
    x = torch.clamp(xy[..., 0], 0.0, W - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0
    fy = y - y0
    i00 = img[y0, x0]
    i01 = img[y0, x0 + 1]
    i10 = img[y0 + 1, x0]
    i11 = img[y0 + 1, x0 + 1]
    return (i00 * (1 - fy) * (1 - fx) + i01 * (1 - fy) * fx
            + i10 * fy * (1 - fx) + i11 * fy * fx)


def _window_origins(Hp, Wp, cx, cy):
    """Top-left corners of the (WIN_H, WIN_W) windows `_extract_windows`
    takes around (cx, cy): two adjacent 128-column tiles with >= 64 px
    margin, rows centred and clamped into the image."""
    ntx = Wp // 128
    xi = torch.floor(cx).to(torch.int64)
    yi = torch.floor(cy).to(torch.int64)
    tx = torch.clamp(torch.div(xi - 64, 128, rounding_mode="floor"), 0, ntx - 2)
    wy = torch.clamp(yi - WIN_H // 2, 0, Hp - WIN_H)
    return tx * 128, wy


def _axis(l, P, N):
    """`_band` along one axis: clamped integer origin, fraction, in-window
    flag for a P-sample run starting at window offset l (K,)."""
    li = torch.floor(l)
    f = l - li
    li = li.to(torch.int64)
    ok = (li >= 0) & (li + P + 1 <= N)
    return torch.clamp(li, 0, N - P - 1), f, ok


def _sample(img, wx, wy, lx, ly, P):
    """(K, P, P) patches whose top-left sample sits at window offset
    (lx, ly) inside the windows at (wx, wy) of the padded image; the
    bilinear blend of `Rv @ window @ Rh^T`. Returns (patches, ok)."""
    cx, fx, okx = _axis(lx, P, WIN_W)
    cy, fy, oky = _axis(ly, P, WIN_H)
    ar = torch.arange(P + 1, device=img.device)
    rows = (wy + cy)[:, None] + ar                       # (K, P+1)
    cols = (wx + cx)[:, None] + ar
    blk = img[rows[:, :, None], cols[:, None, :]]        # (K, P+1, P+1)
    fy = fy[:, None, None]
    fx = fx[:, None, None]
    v = blk[:, :P, :] * (1.0 - fy) + blk[:, 1:, :] * fy  # (K, P, P+1)
    return v[:, :, :P] * (1.0 - fx) + v[:, :, 1:] * fx, okx & oky


def _track_level(img_prev, img_next, kp_prev, guess, iters, half):
    """One pyramid level of LK for all keypoints. kp_prev (K, 2) in this
    level's coords, guess (K, 2) current flow. Returns (flow, err)."""
    H0, W0 = img_prev.shape
    P = 2 * half + 1
    Hp = max(-(-H0 // 8) * 8, WIN_H)
    Wp = max(-(-W0 // 128) * 128, WIN_W)
    if (Hp, Wp) != (H0, W0):
        pad = (0, Wp - W0, 0, Hp - H0)
        img_prev = F.pad(img_prev[None, None], pad, mode="replicate")[0, 0]
        img_next = F.pad(img_next[None, None], pad, mode="replicate")[0, 0]

    cx = kp_prev[:, 0]
    cy = kp_prev[:, 1]
    wxp, wyp = _window_origins(Hp, Wp, cx, cy)
    wxn, wyn = _window_origins(Hp, Wp, cx + guess[:, 0], cy + guess[:, 1])

    lxp = cx - half - wxp
    lyp = cy - half - wyp
    t, _ = _sample(img_prev, wxp, wyp, lxp, lyp, P)
    gx = (_sample(img_prev, wxp, wyp, lxp + 0.5, lyp, P)[0]
          - _sample(img_prev, wxp, wyp, lxp - 0.5, lyp, P)[0])
    gy = (_sample(img_prev, wxp, wyp, lxp, lyp + 0.5, P)[0]
          - _sample(img_prev, wxp, wyp, lxp, lyp - 0.5, P)[0])

    # gain/bias-invariant residual: zero-mean patches, per-patch gain fit
    t0 = t - torch.mean(t, dim=(1, 2), keepdim=True)
    tt = torch.clamp(torch.sum(t0 * t0, dim=(1, 2)), min=1e-12)
    a = torch.sum(gx * gx, dim=(1, 2))
    b = torch.sum(gx * gy, dim=(1, 2))
    c = torch.sum(gy * gy, dim=(1, 2))
    det = a * c - b * b
    det_s = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    cap = float(P)
    fcap = float(max(Hp, Wp))

    def residual(gflow):
        nlx = cx + gflow[:, 0] - half - wxn
        nly = cy + gflow[:, 1] - half - wyn
        w, ok = _sample(img_next, wxn, wyn, nlx, nly, P)
        w0 = w - torch.mean(w, dim=(1, 2), keepdim=True)
        s = torch.clamp(torch.sum(w0 * t0, dim=(1, 2)) / tt, 0.5, 2.0)
        return w0 - s[:, None, None] * t0, ok

    gflow = guess
    for _ in range(iters):
        e, _ = residual(gflow)
        bx = torch.sum(e * gx, dim=(1, 2))
        by = torch.sum(e * gy, dim=(1, 2))
        dx = torch.clamp((c * bx - b * by) / det_s, -cap, cap)
        dy = torch.clamp((a * by - b * bx) / det_s, -cap, cap)
        gflow = torch.clamp(gflow - torch.stack([dx, dy], dim=-1), -fcap, fcap)
    e, ok = residual(gflow)
    rms = torch.sqrt(tt) / float(P)
    err = torch.mean(torch.abs(e), dim=(1, 2)) / torch.clamp(rms, min=1e-6)
    err = torch.where(ok, err, torch.full_like(err, torch.inf))
    return gflow, err


def _sample_patch(img, cx, cy, half):
    """(K, P, P) bilinear patches centred at (cx, cy) (K,), the centre
    clamped off the border, every sample of a patch sharing one fractional
    offset (`klt.py:48-75`)."""
    P = 2 * half + 1
    H, W = img.shape
    cx = torch.clamp(cx, half + 1.0, W - half - 3.0)
    cy = torch.clamp(cy, half + 1.0, H - half - 3.0)
    wx = torch.floor(cx).to(torch.int64) - half - 1
    wy = torch.floor(cy).to(torch.int64) - half - 1
    lx = cx - half - wx.to(cx.dtype)
    ly = cy - half - wy.to(cy.dtype)
    lxi = torch.clamp(torch.floor(lx).to(torch.int64), 0, 2)
    lyi = torch.clamp(torch.floor(ly).to(torch.int64), 0, 2)
    fx = (lx - lxi.to(cx.dtype))[:, None, None]
    fy = (ly - lyi.to(cy.dtype))[:, None, None]
    ar = torch.arange(P + 1, device=img.device)
    S = img[(wy + lyi)[:, None, None] + ar[None, :, None],
            (wx + lxi)[:, None, None] + ar[None, None, :]]      # (K, P+1, P+1)
    rows = S[:, 0:P, :] * (1.0 - fy) + S[:, 1:P + 1, :] * fy
    return rows[:, :, 0:P] * (1.0 - fx) + rows[:, :, 1:P + 1] * fx


def min_eig_response(img, kp, half):
    """Per-keypoint min eigenvalue of the patch gradient matrix, normalized
    per pixel (`klt.py:293-313`): the trackability gate when no response
    maps are given."""
    cx, cy = kp[:, 0], kp[:, 1]
    gx = _sample_patch(img, cx + 0.5, cy, half) - _sample_patch(img, cx - 0.5, cy, half)
    gy = _sample_patch(img, cx, cy + 0.5, half) - _sample_patch(img, cx, cy - 0.5, half)
    a = torch.sum(gx * gx, dim=(-2, -1))
    b = torch.sum(gx * gy, dim=(-2, -1))
    c = torch.sum(gy * gy, dim=(-2, -1))
    P = 2 * half + 1
    return 0.5 * ((a + c) - torch.sqrt((a - c) ** 2 + 4.0 * b * b)) / (P * P)


def track_keypoints(
    pyr_prev, pyr_next, kp_prev, kp_init, mask, resp_prev=None, resp_next=None,
    patch=21, iters=10, max_error=2.5, border=20.0, min_eig=1e-6,
    fb_threshold=0.0, coarse_iters=8, fb_iters=6,
):
    """Track keypoints from the previous to the next image.

    pyr_prev/pyr_next: pyramid lists (level 0 = full res); kp_prev (K, 2)
    pixel coords at level 0; kp_init (K, 2) initial guesses; mask (K,);
    resp_prev/resp_next: corner-response maps of the level-0 images (the
    trackability gate samples them at both endpoints); without them the
    gate is each endpoint patch's `min_eig_response`.

    Returns (kp_next (K, 2), status (K,) bool)."""
    half = patch // 2
    levels = len(pyr_prev)
    scale = 2.0 ** (levels - 1)
    flow = (kp_init - kp_prev) / scale

    for lv in range(levels - 1, -1, -1):
        s = 2.0 ** lv
        flow, err = _track_level(
            pyr_prev[lv], pyr_next[lv], kp_prev / s, flow,
            iters if lv == 0 else coarse_iters, half)
        if lv > 0:
            flow = flow * 2.0

    kp_next = kp_prev + flow
    H, W = pyr_prev[0].shape
    inb = ((kp_next[:, 0] >= border) & (kp_next[:, 0] < W - border)
           & (kp_next[:, 1] >= border) & (kp_next[:, 1] < H - border))
    finite = torch.all(torch.isfinite(kp_next), dim=-1)
    kp_n = torch.where(finite[:, None], kp_next, kp_prev)
    if resp_prev is not None and resp_next is not None:
        lam_p = _bilinear(resp_prev, kp_prev)
        lam_n = _bilinear(resp_next, kp_n)
    else:
        lam_p = min_eig_response(pyr_prev[0], kp_prev, half)
        lam_n = min_eig_response(pyr_next[0], kp_n, half)
    status = (mask & inb & (err < max_error) & finite
              & (lam_p > min_eig) & (lam_n > min_eig))

    if fb_threshold and fb_threshold > 0.0:
        flow_f = kp_n - kp_prev
        flow_b = -flow_f / scale
        for lv in range(levels - 1, -1, -1):
            s = 2.0 ** lv
            flow_b, _ = _track_level(pyr_next[lv], pyr_prev[lv], kp_n / s,
                                     flow_b, fb_iters, half)
            if lv > 0:
                flow_b = flow_b * 2.0
        roundtrip = torch.linalg.norm(flow_f + flow_b, dim=-1)
        status = status & (roundtrip < fb_threshold)
    return kp_next, status

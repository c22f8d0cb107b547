"""Image preprocessing: normalization, CLAHE, gradients, pyramid.

Matches `pvio_tpu/frontend/image.py`: `normalize`, `_conv2` (zero-padded
same-size correlation), `gradients` (Scharr / 32), `downsample2`,
`build_pyramid` and `clahe(6.0, 8, 64)`. Images are (H, W) float tensors
in [0, 1].

CLAHE reproduces the reference's outputs, not its TPU layout: the
per-pixel LUT lookup the reference does as a one-hot matmul at HIGHEST
precision (exact by construction) is an integer-indexed gather here, which
is exact too. What shapes the result is kept: the edge-padded tile grid,
the half-tile blocks with their static four neighbour tiles, the bin index
clipped to n_bins - 2, and the bilinear ramps.
"""

import numpy as np
import torch
import torch.nn.functional as F


def normalize(img):
    lo = torch.min(img)
    hi = torch.max(img)
    return (img - lo) / torch.clamp(hi - lo, min=1e-6)


def _conv2(img, k):
    """Same-size 2-D correlation of (H, W) with a small static kernel
    (numpy or nested sequence), zero padding. Shifted adds in the
    reference's tap order; zero taps are skipped."""
    karr = np.asarray(k, np.float64)
    kh, kw = karr.shape
    ph, pw = kh // 2, kw // 2
    H, W = img.shape
    pad = F.pad(img, (pw, pw, ph, ph))
    out = None
    for dy in range(kh):
        for dx in range(kw):
            w = float(karr[dy, dx])
            if w == 0.0:
                continue
            term = w * pad[dy:dy + H, dx:dx + W]
            out = term if out is None else out + term
    return out if out is not None else torch.zeros_like(img)


_SCHARR_X = np.array([[-3.0, 0, 3], [-10, 0, 10], [-3, 0, 3]]) / 32.0
_SCHARR_Y = np.array([[-3.0, -10, -3], [0, 0, 0], [3, 10, 3]]) / 32.0


def gradients(img):
    """Scharr image gradients (Ix, Iy), same shape as img."""
    return _conv2(img, _SCHARR_X), _conv2(img, _SCHARR_Y)


def downsample2(img):
    """2x2 average-pool downsample (H, W) -> (H//2, W//2)."""
    H, W = img.shape
    return img[: H - H % 2, : W - W % 2].reshape(H // 2, 2, W // 2, 2).mean(dim=(1, 3))


def build_pyramid(img, levels=3):
    """List of `levels + 1` images, level 0 = full resolution."""
    pyr = [img]
    for _ in range(levels):
        pyr.append(downsample2(pyr[-1]))
    return pyr


def _bins(n_bins, dtype, device):
    """Bin centres as jnp.linspace(0, 1, n_bins) computes them on the
    reference's CPU backend (iota times the rounded reciprocal of the
    step count), so bin-boundary membership matches bit for bit."""
    npdt = np.float32 if dtype == torch.float32 else np.float64
    step = np.arange(n_bins - 1, dtype=npdt) * npdt(npdt(1) / npdt(n_bins - 1))
    vals = np.concatenate([npdt(0) * (npdt(1) - step) + npdt(1) * step, [npdt(1)]])
    return torch.as_tensor(vals.astype(npdt), device=device)


def clahe(img, clip_limit=6.0, grid=8, n_bins=64):
    """Contrast-limited adaptive histogram equalization (cv::CLAHE(6.0,
    8x8) role): per-tile histograms -> clipped and redistributed ->
    per-tile CDF -> lookup with linear interpolation between bins ->
    bilinear blend of the four surrounding tile CDFs. img in [0, 1]."""
    H, W = img.shape
    dtype, dev = img.dtype, img.device
    gh = gw = grid
    th, tw = -(-H // gh), -(-W // gw)
    th += th % 2
    tw += tw % 2
    Hp, Wp = th * gh, tw * gw
    pad = F.pad(img[None, None], (0, Wp - W, 0, Hp - H), mode="replicate")[0, 0]
    tiles = pad.reshape(gh, th, gw, tw).permute(0, 2, 1, 3).reshape(gh * gw, th * tw)

    # histogram with the reference's membership rule |x - bin| <= half a
    # bin step (a value on a boundary counts in both neighbours): only the
    # nearest bin and its two neighbours can qualify
    bins = _bins(n_bins, dtype, dev)
    half = torch.tensor(0.5 / (n_bins - 1), dtype=dtype, device=dev)
    k0 = torch.round(tiles * (n_bins - 1)).to(torch.int64)
    hist = torch.zeros(gh * gw, n_bins, dtype=dtype, device=dev)
    for off in (-1, 0, 1):
        k = k0 + off
        kc = k.clamp(0, n_bins - 1)
        hit = (k == kc) & (torch.abs(tiles - bins[kc]) <= half)
        hist.scatter_add_(1, kc, hit.to(dtype))
    hist = hist.reshape(gh, gw, n_bins)

    npix = th * tw
    clip = clip_limit * npix / n_bins
    excess = torch.sum(torch.clamp(hist - clip, min=0.0), dim=-1, keepdim=True)
    hist = torch.clamp(hist, max=clip) + excess / n_bins

    cdf = torch.cumsum(hist, dim=-1)
    cdf = cdf / cdf[..., -1:]

    # edge-replicated tile grid; static 4-neighbour tiles per half-tile block
    cdfp = F.pad(cdf.permute(2, 0, 1)[None], (1, 1, 1, 1), mode="replicate")[0]
    cdfp = cdfp.permute(1, 2, 0)                       # (gh+2, gw+2, nb)
    a = np.arange(2 * gh)
    b = np.arange(2 * gw)
    ty0 = torch.as_tensor((a - 1) // 2 + 1, device=dev)
    tx0 = torch.as_tensor((b - 1) // 2 + 1, device=dev)
    l00 = cdfp[ty0[:, None], tx0[None, :]]             # (2gh, 2gw, nb)
    l01 = cdfp[ty0[:, None], tx0[None, :] + 1]
    l10 = cdfp[ty0[:, None] + 1, tx0[None, :]]
    l11 = cdfp[ty0[:, None] + 1, tx0[None, :] + 1]
    L = torch.stack([l00, l01, l10, l11], dim=0).reshape(4, -1)  # (4, blocks*nb)

    hh, hw = th // 2, tw // 2
    blk = pad.reshape(2 * gh, hh, 2 * gw, hw).permute(0, 2, 1, 3)
    v = blk.reshape(2 * gh, 2 * gw, hh * hw) * (n_bins - 1)
    vi = torch.clamp(torch.floor(v), 0, n_bins - 2)
    vf = v - vi
    blk_id = torch.arange(4 * gh * gw, device=dev).reshape(2 * gh, 2 * gw, 1)
    flat = blk_id * n_bins + vi.to(torch.int64)        # (2gh, 2gw, pix)
    lo = L[:, flat]                                    # (4, 2gh, 2gw, pix)
    hi = L[:, flat + 1]
    pick = (lo * (1 - vf) + hi * vf).reshape(4, 2 * gh, 2 * gw, hh, hw)

    yy = (np.arange(Hp) + 0.5) / th - 0.5
    xx = (np.arange(Wp) + 0.5) / tw - 0.5
    fy = torch.as_tensor(np.clip(yy - np.floor(yy) if gh > 1 else yy * 0.0, 0.0, 1.0)
                         .reshape(2 * gh, hh), dtype=dtype, device=dev)
    fx = torch.as_tensor(np.clip(xx - np.floor(xx) if gw > 1 else xx * 0.0, 0.0, 1.0)
                         .reshape(2 * gw, hw), dtype=dtype, device=dev)
    wy = fy[:, None, :, None]                          # (2gh, 1, hh, 1)
    wx = fx[None, :, None, :]                          # (1, 2gw, 1, hw)
    out = (pick[0] * (1 - wy) * (1 - wx) + pick[1] * (1 - wy) * wx
           + pick[2] * wy * (1 - wx) + pick[3] * wy * wx)
    out = out.permute(0, 2, 1, 3).reshape(Hp, Wp)
    return out[:H, :W]

"""Port parity: image preprocessing, the corner response (plain version of
kernel K1), detection and KLT tracking, pvio_torch vs pvio_tpu on the CPU
at float64.

Tolerances: masks, index sets and counts identical; image values and the
corner response 1e-12 (same formulas, float64, other summation order);
detected sub-pixel positions 1e-12; KLT landing points 1e-9 (ten
Gauss-Newton steps per level amplify the reassociation differences of the
patch sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pvio_tpu.frontend import detect as Jdet, image as Jimg, klt as Jklt
from pvio_tpu.io import synthetic as S
from pvio_torch.frontend import detect as Tdet, image as Timg, klt as Tklt
from tests.test_torch_harness import assert_close, assert_same, t64

torch.set_num_threads(2)
TOL = 1e-12


def _texture(rng, H=240, W=320):
    """Smooth random texture in [0, 1]: blurred noise plus a few edges."""
    x = rng.uniform(size=(H, W))
    k = np.ones(5) / 5.0
    x = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, x)
    x = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, x)
    x[:, W // 3:] += 0.2
    x[H // 2:, :] -= 0.15
    return np.clip((x - x.min()) / (x.max() - x.min()), 0.0, 1.0)


def test_clahe_and_pyramid_match_reference():
    img = _texture(np.random.default_rng(21))
    ja, ta = jnp.asarray(img), t64(img)
    assert_close(Timg.normalize(ta * 0.7 + 0.1), Jimg.normalize(ja * 0.7 + 0.1), TOL, "normalize")
    cj, ct = Jimg.clahe(ja), Timg.clahe(ta)
    assert_close(ct, cj, TOL, "clahe")
    for lv, (a, b) in enumerate(zip(Timg.build_pyramid(ct, 2), Jimg.build_pyramid(cj, 2))):
        assert_close(a, b, TOL, f"pyramid level {lv}")
    gx_t, gy_t = Timg.gradients(ta)
    gx_j, gy_j = Jimg.gradients(ja)
    assert_close(gx_t, gx_j, TOL, "Ix")
    assert_close(gy_t, gy_j, TOL, "Iy")
    # odd sizes: the edge-padded tile grid and the downsample crop
    odd = img[:237, :311]
    assert_close(Timg.clahe(t64(odd)), Jimg.clahe(jnp.asarray(odd)), TOL, "clahe odd")
    assert_close(Timg.downsample2(t64(odd)), Jimg.downsample2(jnp.asarray(odd)), TOL, "downsample odd")


def test_shi_tomasi_plain_matches_reference_full_image():
    """The plain version of K1 against detect.shi_tomasi_response over the
    WHOLE image, borders included."""
    for H, W in [(240, 320), (37, 53)]:
        img = _texture(np.random.default_rng(H), H, W)
        r_t = Tdet.shi_tomasi_response(t64(img))
        r_j = Jdet.shi_tomasi_response(jnp.asarray(img))
        assert_close(r_t, r_j, TOL, f"response {H}x{W}")
        assert_same(Tdet._nms(r_t), Jdet._nms(r_j), "nms")


def _splats(H=240, W=320):
    """Tie-heavy input: a flat background with identical blobs pasted at
    integer offsets, so many candidates carry bit-equal responses."""
    yy, xx = np.mgrid[-6:7, -6:7]
    blob = np.exp(-(xx ** 2 + yy ** 2) / (2 * 1.6 ** 2))
    img = np.zeros((H, W))
    for y in range(30, H - 30, 23):
        for x in range(30, W - 30, 17):
            img[y - 6:y + 7, x - 6:x + 7] += blob
    return np.clip(img, 0.0, 1.0)


def test_detect_keypoints_matches_reference():
    cases = [("texture", _texture(np.random.default_rng(5))), ("ties", _splats())]
    for name, img in cases:
        ja, ta = jnp.asarray(img), t64(img)
        xy_j, m_j = Jdet.detect_keypoints(ja, max_keypoints=60, min_distance=12.0)
        xy_t, m_t = Tdet.detect_keypoints(ta, max_keypoints=60, min_distance=12.0)
        assert_same(m_t, m_j, f"{name} mask")
        assert int(np.asarray(m_j).sum()) >= 20, name
        assert_close(xy_t, xy_j, TOL, f"{name} xy")
        # with existing keypoints suppressing their surroundings, half masked
        ex = np.asarray(xy_j)[::3] + 1.5
        exm = np.arange(len(ex)) % 2 == 0
        xy_j2, m_j2 = Jdet.detect_keypoints(ja, 60, 12.0, jnp.asarray(ex), jnp.asarray(exm))
        xy_t2, m_t2 = Tdet.detect_keypoints(ta, 60, 12.0, t64(ex), t64(exm))
        assert_same(m_t2, m_j2, f"{name} mask with existing")
        assert_close(xy_t2, xy_j2, TOL, f"{name} xy with existing")
        assert not np.array_equal(np.asarray(xy_j2), np.asarray(xy_j))   # suppression acted


def _render_pair():
    cfg_K = np.array([[200.0, 0, 160.0], [0, 200.0, 120.0], [0, 0, 1.0]])
    scene = S.make_scene(duration=1.0, n_points=200, n_plane_points=60, seed=648)
    imgs = [S.render_frame(scene, i, cfg_K, (320, 240)) for i in (3, 4)]
    return [Jimg.clahe(jnp.asarray(im)) for im in imgs]


def test_track_keypoints_matches_reference():
    """Forward-backward gate at 1 px and the response-map trackability
    gate: landing points within 1e-9, status identical."""
    a, b = _render_pair()
    pyr_a, pyr_b = Jimg.build_pyramid(a, 2), Jimg.build_pyramid(b, 2)
    resp_a, resp_b = Jdet.shi_tomasi_response(a), Jdet.shi_tomasi_response(b)
    kp, m = Jdet.detect_keypoints(a, 60, 12.0)
    kp = np.array(kp)
    m = np.asarray(m).copy()
    m[-3:] = False
    # a couple of guesses far off, one keypoint near the border
    guess = kp + np.random.default_rng(3).normal(size=kp.shape) * 0.7
    guess[:2] += 9.0
    kp[5] = [21.0, 30.0]

    track = jax.jit(lambda pa, pb, k, g, mm, ra, rb: Jklt.track_keypoints(
        pa, pb, k, g, mm, fb_threshold=1.0, resp_prev=ra, resp_next=rb))
    kn_j, st_j = track(pyr_a, pyr_b, jnp.asarray(kp), jnp.asarray(guess), jnp.asarray(m),
                       resp_a, resp_b)
    to_t = lambda xs: [t64(x) for x in xs]
    kn_t, st_t = Tklt.track_keypoints(to_t(pyr_a), to_t(pyr_b), t64(kp), t64(guess), t64(m),
                                      t64(resp_a), t64(resp_b), fb_threshold=1.0)
    assert_same(st_t, st_j, "status")
    st = np.asarray(st_j)
    assert st.sum() >= 20 and (~st).sum() >= 3
    assert_close(kn_t, kn_j, 1e-9, "kp_next")
    # the bilinear sampler's border clamp
    xy = np.array([[-3.0, 5.0], [319.5, 239.9], [100.25, 50.75]])
    assert_close(Tklt._bilinear(t64(a), t64(xy)), Jklt._bilinear(a, jnp.asarray(xy)), TOL, "bilinear")

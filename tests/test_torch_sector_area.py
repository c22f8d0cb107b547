"""Parity of `pvio_torch/map/sector_area.py`, the port's numpy copy of
`pvio_tpu/map/sector_area.py`: every function on seeded inputs gives the
reference's radii, centers, vertices and booleans exactly, and the five
cases of `tests/test_sector_area.py` hold for the port (one parametrised
test), with the same values as the reference's on the same draws.
"""

import numpy as np
import pytest

from pvio_tpu.map import sector_area as ref_sa
from pvio_torch.map import sector_area as sa

BASIS = np.array([[1.0, 0.0], [0.0, 1.0], [0.0, 0.0]])


def disk_points(rng, n, r, center=(0, 0)):
    ang = rng.uniform(-np.pi, np.pi, n)
    rad = r * np.sqrt(rng.uniform(0, 1, n))
    return np.stack([center[0] + rad * np.cos(ang),
                     center[1] + rad * np.sin(ang),
                     np.zeros(n)], axis=-1)


def tilted(rng):
    """A random plane: center, orthonormal in-plane basis, points on it."""
    n = rng.normal(size=3)
    n /= np.linalg.norm(n)
    u = np.cross(n, [0.0, 0.0, 1.0])
    u /= np.linalg.norm(u)
    basis = np.stack([u, np.cross(n, u)], axis=-1)
    center = rng.normal(size=3)
    uv = rng.normal(size=(150, 2)) * [2.0, 0.7]
    return center, basis, center + uv @ basis.T


def assert_area_equal(a, b, what):
    for f in ("center", "basis", "radii"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f"{what} {f}")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_every_function_matches_reference(seed):
    rng = np.random.default_rng(seed)
    center, basis, pts = tilted(rng)
    a, a_ref = sa.SectorArea.empty(center, basis), ref_sa.SectorArea.empty(center, basis)
    assert_area_equal(a, a_ref, "empty")
    assert len(sa.boundary_vertices(a)) == 0 and sa.centralize(a) is a
    np.testing.assert_array_equal(sa._sector_of(np.linspace(-4, 4, 101)),
                                  ref_sa._sector_of(np.linspace(-4, 4, 101)))
    for x, y in zip(sa._polar(a, pts), ref_sa._polar(a_ref, pts)):
        np.testing.assert_array_equal(x, y)
    # only some sectors filled, so the empty-sector fallback is exercised
    half = pts[pts @ basis[:, 0] - center @ basis[:, 0] > 0.3]
    a, a_ref = sa.insert(a, half), ref_sa.insert(a_ref, half)
    assert_area_equal(a, a_ref, "insert")
    assert (a.radii == 0).any() and (a.radii > 0).any()
    assert_area_equal(sa.insert(a, np.zeros((0, 3))), a_ref, "insert nothing")
    np.testing.assert_array_equal(sa.boundary_vertices(a), ref_sa.boundary_vertices(a_ref))
    probe = center + rng.normal(size=(300, 2)) * 2.5 @ basis.T
    for inside in (True, False):
        got = sa.is_near_boundary_batch(a, probe, inside, 1.2, 0.1)
        want = ref_sa.is_near_boundary_batch(a_ref, probe, inside, 1.2, 0.1)
        np.testing.assert_array_equal(got, want)
        single = [sa.is_near_boundary(a, p, inside) for p in probe[:60]]
        assert single == [ref_sa.is_near_boundary(a_ref, p, inside) for p in probe[:60]]
        assert 0 < sum(single) < 60
    assert sa.is_near_boundary_batch(a, np.zeros((0, 3))).shape == (0,)
    b_pts = pts[::3] + 0.5 * basis[:, 1]
    b = sa.insert(sa.SectorArea.empty(center + 0.5 * basis[:, 1], basis), b_pts)
    b_ref = ref_sa.insert(ref_sa.SectorArea.empty(center + 0.5 * basis[:, 1], basis), b_pts)
    assert_area_equal(sa.merge(a, b), ref_sa.merge(a_ref, b_ref), "merge")
    assert sa.overlap_ratio(a, b) == ref_sa.overlap_ratio(a_ref, b_ref)
    for points in (None, pts):
        assert_area_equal(sa.centralize(a, points), ref_sa.centralize(a_ref, points),
                          "centralize")


def _insert_tracks_max_radius(m, rng):
    a = m.insert(m.SectorArea.empty(np.zeros(3), BASIS), disk_points(rng, 400, 2.0))
    assert (a.radii > 1.5).all() and (a.radii <= 2.0 + 1e-9).all()
    return a.radii


def _near_boundary_gate(m, rng):
    a = m.insert(m.SectorArea.empty(np.zeros(3), BASIS), disk_points(rng, 400, 2.0))
    got = [m.is_near_boundary(a, np.array([x, 0.0, 0.0])) for x in (1.0, 2.3, 3.5)]
    assert got == [True, True, False]          # ratio 1.2
    return got


def _merge_covers_union(m, rng):
    a = m.insert(m.SectorArea.empty(np.zeros(3), BASIS), disk_points(rng, 300, 1.0))
    b = m.insert(m.SectorArea.empty(np.zeros(3), BASIS),
                 disk_points(rng, 300, 1.0, center=(2.5, 0.0)))
    merged = m.merge(a, b)
    assert m.is_near_boundary(merged, np.array([3.2, 0.0, 0.0]))
    return merged.radii


def _centralize_moves_center(m, rng):
    m.insert(m.SectorArea.empty(np.zeros(3), BASIS), disk_points(rng, 400, 1.0, center=(3.0, 0.0)))
    pts = disk_points(rng, 400, 1.0, center=(3.0, 0.0))
    a = m.insert(m.SectorArea.empty(np.zeros(3), BASIS), pts)
    c = m.centralize(a, points=pts)
    assert c.center[0] > 1.5 and m.is_near_boundary(c, np.array([3.0, 0.5, 0.0]))
    return np.concatenate([c.center, c.radii])


def _overlap_ratio(m, rng):
    a = m.insert(m.SectorArea.empty(np.zeros(3), BASIS), disk_points(rng, 400, 2.0))
    b_inside = m.insert(m.SectorArea.empty(np.zeros(3), BASIS), disk_points(rng, 200, 0.8))
    b_far = m.insert(m.SectorArea.empty(np.array([10.0, 0, 0]), BASIS),
                     disk_points(rng, 200, 0.8, center=(10.0, 0.0)))
    ratios = [m.overlap_ratio(a, b_inside), m.overlap_ratio(a, b_far)]
    assert ratios[0] > 0.9 and ratios[1] < 0.2
    return ratios


@pytest.mark.parametrize("case", [_insert_tracks_max_radius, _near_boundary_gate,
                                  _merge_covers_union, _centralize_moves_center,
                                  _overlap_ratio], ids=lambda f: f.__name__.strip("_"))
def test_reference_cases_hold_for_port(case):
    got = case(sa, np.random.default_rng(648))
    want = case(ref_sa, np.random.default_rng(648))
    np.testing.assert_array_equal(got, want)

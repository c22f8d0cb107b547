"""SectorArea: polar-binned planar extent of a plane's member landmarks.

The port's own copy of `pvio_tpu/map/sector_area.py`, host numpy as there:
`SectorArea` (`empty`), `_polar`, `_sector_of`, `insert`, `merge`,
`boundary_vertices`, `centralize`, `is_near_boundary`,
`is_near_boundary_batch` and `overlap_ratio`, with the same formulas. The
boundary of a plane's point set is approximated by N polar sectors around
a center point, each keeping the maximum radius seen in that sector; plane
extension asks whether a ray-cast point lies near that boundary.
"""

from typing import NamedTuple

import numpy as np

N_SECTORS = 12  # reference uses SectorArea<12> (map/plane.h:36)


class SectorArea(NamedTuple):
    center: np.ndarray   # (3,) reference point on the plane
    basis: np.ndarray    # (3, 2) in-plane orthonormal basis
    radii: np.ndarray    # (N_SECTORS,) max radius per sector (0 = empty)

    @staticmethod
    def empty(center, basis):
        return SectorArea(np.asarray(center, float), np.asarray(basis, float),
                          np.zeros(N_SECTORS))


def _polar(area: SectorArea, points):
    """Project points onto the plane basis -> (angles (M,), radii (M,))."""
    d = np.atleast_2d(points) - area.center
    uv = d @ area.basis  # (M, 2)
    ang = np.arctan2(uv[:, 1], uv[:, 0])  # [-pi, pi)
    rad = np.linalg.norm(uv, axis=-1)
    return ang, rad


def _sector_of(angles):
    k = np.floor((angles + np.pi) / (2 * np.pi) * N_SECTORS).astype(int)
    return np.clip(k, 0, N_SECTORS - 1)


def insert(area: SectorArea, points) -> SectorArea:
    """Grow the area to cover `points` (sector_area.h insert)."""
    if len(np.atleast_2d(points)) == 0:
        return area
    ang, rad = _polar(area, points)
    sec = _sector_of(ang)
    radii = area.radii.copy()
    np.maximum.at(radii, sec, rad)
    return area._replace(radii=radii)


def merge(a: SectorArea, b: SectorArea) -> SectorArea:
    """Union of two areas expressed in a's frame (sector_area.h merge):
    b's sector boundary vertices are inserted into a."""
    verts = boundary_vertices(b)
    return insert(a, verts)


def boundary_vertices(area: SectorArea):
    """One representative boundary vertex per non-empty sector -> (M, 3)."""
    ks = np.nonzero(area.radii > 0)[0]
    if len(ks) == 0:
        return np.zeros((0, 3))
    ang = (ks + 0.5) / N_SECTORS * 2 * np.pi - np.pi
    uv = np.stack([np.cos(ang), np.sin(ang)], axis=-1) * area.radii[ks, None]
    return area.center + uv @ area.basis.T


def centralize(area: SectorArea, points=None) -> SectorArea:
    """Re-center on the boundary centroid and re-bin
    (sector_area.h centralize). When the member `points` are available,
    re-binning uses them (Plane::update_sector_area re-inserts member
    tracks); vertex-only re-binning loses coverage when the mass sits in
    few sectors."""
    verts = boundary_vertices(area)
    if len(verts) == 0:
        return area
    new_center = verts.mean(axis=0)
    out = SectorArea(new_center, area.basis, np.zeros(N_SECTORS))
    return insert(out, verts if points is None else np.vstack([verts, points]))


def is_near_boundary(area: SectorArea, point, inside=True, ratio=1.2,
                     margin=0.1) -> bool:
    """True when `point` lies within ratio * sector_radius + margin of the
    area (the adoption gate of plane extension,
    plane_extractor.cpp:131-140 / sector_area.h:57-118)."""
    ang, rad = _polar(area, np.asarray(point)[None])
    k = _sector_of(ang)[0]
    r = area.radii[k]
    if r <= 0:
        # empty sector: fall back to the neighbors' max
        r = max(area.radii[(k - 1) % N_SECTORS], area.radii[(k + 1) % N_SECTORS])
        if r <= 0:
            return False
    limit = ratio * r + margin
    if inside:
        return bool(rad[0] <= limit)
    return bool(abs(rad[0] - r) <= ratio * r * 0.2 + margin)


def is_near_boundary_batch(area: SectorArea, points, inside=True, ratio=1.2,
                           margin=0.1):
    """Vectorized is_near_boundary over (M, 3) points -> (M,) bool."""
    pts = np.atleast_2d(points)
    if len(pts) == 0:
        return np.zeros(0, bool)
    ang, rad = _polar(area, pts)
    k = _sector_of(ang)
    r = area.radii[k]
    # empty sector: fall back to the neighbors' max
    rn = np.maximum(area.radii[(k - 1) % N_SECTORS],
                    area.radii[(k + 1) % N_SECTORS])
    r = np.where(r > 0, r, rn)
    if inside:
        ok = rad <= ratio * r + margin
    else:
        ok = np.abs(rad - r) <= ratio * r * 0.2 + margin
    return ok & (r > 0)


def overlap_ratio(a: SectorArea, b: SectorArea) -> float:
    """Fraction of b's boundary vertices inside a (Plane::overlap_ratio,
    plane.cpp:35-54 role)."""
    verts = boundary_vertices(b)
    if len(verts) == 0:
        return 0.0
    inside = [is_near_boundary(a, v, inside=True, ratio=1.0, margin=0.0)
              for v in verts]
    return float(np.mean(inside))

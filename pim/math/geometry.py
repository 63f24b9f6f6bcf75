"""Geometry math: signed-distance fields, AABBs, frusta, areas.

Counterpart of the reference headers
the reference's src/math/{sdf.h,box.h,frustum.h,area.h}: pure jnp,
broadcastable over leading batch dims (points are V3 of [...] or
[..., 3] arrays at the caller's choice via V3.from_aos).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from pim.math.vec3 import V3, cross, dot, length, normalize

PI = 3.14159265358979


# ---------------------------------------------------------------------------
# Signed distance fields (ref sdf.h)
# ---------------------------------------------------------------------------


def sd_sphere(center: V3, radius, pt: V3):
    """ref sdf.h:15-18."""
    return length(pt - center) - radius


class Plane3D(NamedTuple):
    """n.x*x + n.y*y + n.z*z + d = 0 (ref sdf.h Plane3D)."""

    n: V3
    d: jnp.ndarray


def plane_new(direction: V3, pt: V3) -> Plane3D:
    """ref sdf.h:25-30: plane through ``pt`` with normal ``direction``."""
    n = normalize(direction)
    return Plane3D(n, -dot(n, pt))


def sd_plane(plane: Plane3D, pt: V3):
    """ref sdf.h:32-35."""
    return dot(plane.n, pt) + plane.d


def sd_capsule(a: V3, b: V3, radius, pt: V3):
    """ref sdf.h:45-51 (sdLine3D)."""
    pa = pt - a
    ba = b - a
    h = jnp.clip(dot(pa, ba) / jnp.maximum(dot(ba, ba), 1e-20), 0.0, 1.0)
    return length(pa - ba * h) - radius


def sd_box(center: V3, extents: V3, pt: V3):
    """ref sdf.h:61-67 (sdBox3D): center + half-extents."""
    d = V3(
        jnp.abs(pt.x - center.x) - extents.x,
        jnp.abs(pt.y - center.y) - extents.y,
        jnp.abs(pt.z - center.z) - extents.z,
    )
    outside = length(V3(jnp.maximum(d.x, 0.0), jnp.maximum(d.y, 0.0),
                        jnp.maximum(d.z, 0.0)))
    inside = jnp.minimum(jnp.maximum(d.x, jnp.maximum(d.y, d.z)), 0.0)
    return outside + inside


def sd_plane_sphere(plane: Plane3D, center: V3, radius):
    """ref sdf.h:74-77."""
    return sd_plane(plane, center) - radius


def sd_plane_box(plane: Plane3D, center: V3, extents: V3):
    """ref sdf.h:86-97: conservative box-plane distance."""
    d = sd_plane(plane, center)
    r = (jnp.abs(plane.n.x) * extents.x + jnp.abs(plane.n.y) * extents.y
         + jnp.abs(plane.n.z) * extents.z)
    return d - r


def sd_triangle(a: V3, b: V3, c: V3, pt: V3):
    """Unsigned distance to a 3D triangle (ref sdf.h:158-189)."""
    ba = b - a
    cb = c - b
    ac = a - c
    nor = cross(ba, ac)

    pa = pt - a
    pb = pt - b
    pc = pt - c

    s = (jnp.sign(dot(cross(ba, nor), pa))
         + jnp.sign(dot(cross(cb, nor), pb))
         + jnp.sign(dot(cross(ac, nor), pc)))

    def edge_d(e: V3, p: V3):
        h = jnp.clip(dot(e, p) / jnp.maximum(dot(e, e), 1e-20), 0.0, 1.0)
        q = p - e * h
        return dot(q, q)

    d_edge = jnp.minimum(edge_d(ba, pa), jnp.minimum(edge_d(cb, pb), edge_d(ac, pc)))
    d_face = dot(nor, pa) ** 2 / jnp.maximum(dot(nor, nor), 1e-20)
    return jnp.sqrt(jnp.where(s < 2.0, d_edge, d_face))


# ---------------------------------------------------------------------------
# Ray intersections (ref sdf.h:191-250)
# ---------------------------------------------------------------------------


def isect_sphere(ro: V3, rd: V3, center: V3, radius):
    """(t0, t1) of ray-sphere, t0 > t1 means miss (ref isectSphere3D)."""
    oc = ro - center
    b = dot(oc, rd)
    c = dot(oc, oc) - radius * radius
    disc = b * b - c
    s = jnp.sqrt(jnp.maximum(disc, 0.0))
    t0 = -b - s
    t1 = -b + s
    miss = disc < 0.0
    return jnp.where(miss, 1.0, t0), jnp.where(miss, -1.0, t1)


def isect_plane(ro: V3, rd: V3, plane: Plane3D):
    """ref isectPlane3D: t of intersection (negative -> behind/parallel)."""
    denom = dot(rd, plane.n)
    return -sd_plane(plane, ro) / jnp.where(jnp.abs(denom) > 1e-20, denom, 1e-20)


def isect_box(ro: V3, rd: V3, lo: V3, hi: V3):
    """Slab test (ref isectBox3D): (tnear, tfar); tnear > tfar -> miss."""
    inv = V3(1.0 / rd.x, 1.0 / rd.y, 1.0 / rd.z)
    t0x = (lo.x - ro.x) * inv.x
    t1x = (hi.x - ro.x) * inv.x
    t0y = (lo.y - ro.y) * inv.y
    t1y = (hi.y - ro.y) * inv.y
    t0z = (lo.z - ro.z) * inv.z
    t1z = (hi.z - ro.z) * inv.z
    tnear = jnp.maximum(jnp.maximum(jnp.minimum(t0x, t1x), jnp.minimum(t0y, t1y)),
                        jnp.minimum(t0z, t1z))
    tfar = jnp.minimum(jnp.minimum(jnp.maximum(t0x, t1x), jnp.maximum(t0y, t1y)),
                       jnp.maximum(t0z, t1z))
    return tnear, tfar


# ---------------------------------------------------------------------------
# AABB ops (ref box.h)
# ---------------------------------------------------------------------------


class Box3D(NamedTuple):
    lo: V3
    hi: V3

    @property
    def center(self) -> V3:
        return (self.lo + self.hi) * 0.5

    @property
    def extents(self) -> V3:
        return (self.hi - self.lo) * 0.5


def box_empty() -> Box3D:
    """ref box.h:16-19."""
    big = jnp.float32(3.0e38)
    return Box3D(V3.splat(jnp.asarray([big] * 3)), V3.splat(jnp.asarray([-big] * 3)))


def box_from_pts(pts: V3) -> Box3D:
    """Reduce over the last batch axis (ref box_from_pts box.h:53-68)."""
    return Box3D(
        V3(pts.x.min(-1), pts.y.min(-1), pts.z.min(-1)),
        V3(pts.x.max(-1), pts.y.max(-1), pts.z.max(-1)),
    )


def box_union(a: Box3D, b: Box3D) -> Box3D:
    """ref box.h:70-73."""
    return Box3D(
        V3(jnp.minimum(a.lo.x, b.lo.x), jnp.minimum(a.lo.y, b.lo.y),
           jnp.minimum(a.lo.z, b.lo.z)),
        V3(jnp.maximum(a.hi.x, b.hi.x), jnp.maximum(a.hi.y, b.hi.y),
           jnp.maximum(a.hi.z, b.hi.z)),
    )


def box_intersect(a: Box3D, b: Box3D) -> Box3D:
    """ref box.h:75-84."""
    return Box3D(
        V3(jnp.maximum(a.lo.x, b.lo.x), jnp.maximum(a.lo.y, b.lo.y),
           jnp.maximum(a.lo.z, b.lo.z)),
        V3(jnp.minimum(a.hi.x, b.hi.x), jnp.minimum(a.hi.y, b.hi.y),
           jnp.minimum(a.hi.z, b.hi.z)),
    )


def box_contains(box: Box3D, pt: V3):
    """ref box.h:36-40."""
    return ((pt.x >= box.lo.x) & (pt.x <= box.hi.x)
            & (pt.y >= box.lo.y) & (pt.y <= box.hi.y)
            & (pt.z >= box.lo.z) & (pt.z <= box.hi.z))


def box_volume(box: Box3D):
    """ref box.h:41-46."""
    s = box.hi - box.lo
    return s.x * s.y * s.z


def box_area(box: Box3D):
    """Surface area (ref box.h:47-52)."""
    s = box.hi - box.lo
    return 2.0 * (s.x * s.y + s.y * s.z + s.z * s.x)


# ---------------------------------------------------------------------------
# Frustum (ref frustum.h) — 6-plane SDF culling
# ---------------------------------------------------------------------------


class Frustum(NamedTuple):
    """Six outward planes, x0/x1/y0/y1/z0/z1 (ref frustum.h Frustum)."""

    n: V3              # [6] stacked plane normals (component arrays of [6])
    d: jnp.ndarray     # [6]


def frustum_new(eye: V3, right: V3, up: V3, fwd: V3,
                lo, hi, fov_y, aspect, z_near, z_far) -> Frustum:
    """Build from camera basis + NDC window [lo, hi] (ref frus_new
    frustum.h:90-127).  lo/hi are (x, y) pairs in [-1, 1]."""
    slope_y = jnp.tan(fov_y * 0.5)
    slope_x = slope_y * aspect

    def corner(x, y, z):
        t = z  # z in {near, far} distance
        return eye + (right * (x * slope_x) + up * (y * slope_y) + fwd) * t

    lbn = corner(lo[0], lo[1], z_near)
    rbn = corner(hi[0], lo[1], z_near)
    ltn = corner(lo[0], hi[1], z_near)
    rtn = corner(hi[0], hi[1], z_near)
    lbf = corner(lo[0], lo[1], z_far)
    rbf = corner(hi[0], lo[1], z_far)
    ltf = corner(lo[0], hi[1], z_far)
    rtf = corner(hi[0], hi[1], z_far)

    corners = [lbn, rbn, ltn, rtn, lbf, rbf, ltf, rtf]
    cx = sum(c.x for c in corners) * 0.125
    cy = sum(c.y for c in corners) * 0.125
    cz = sum(c.z for c in corners) * 0.125
    centroid = V3(cx, cy, cz)

    def tri_plane(a: V3, b: V3, c: V3) -> Plane3D:
        # outward orientation: the frustum centroid must be inside (d < 0)
        n = normalize(cross(b - a, c - a))
        d = -dot(n, a)
        flip = jnp.where(dot(n, centroid) + d > 0.0, -1.0, 1.0)
        return Plane3D(n * flip, d * flip)

    planes = [
        tri_plane(lbn, lbf, ltn),  # x0 (left)
        tri_plane(rbn, rtn, rbf),  # x1 (right)
        tri_plane(lbn, rbn, lbf),  # y0 (bottom)
        tri_plane(ltn, ltf, rtn),  # y1 (top)
        tri_plane(lbn, ltn, rbn),  # z0 (near)
        tri_plane(lbf, rbf, ltf),  # z1 (far)
    ]
    n = V3(
        jnp.stack([p.n.x.reshape(()) for p in planes]),
        jnp.stack([p.n.y.reshape(()) for p in planes]),
        jnp.stack([p.n.z.reshape(()) for p in planes]),
    )
    d = jnp.stack([p.d.reshape(()) for p in planes])
    return Frustum(n, d)


def sd_frustum(frus: Frustum, pt: V3):
    """Max signed distance over the 6 planes (ref sdFrus frustum.h:129-144).
    Negative inside.  pt components broadcast against the [6] plane axis."""
    d = (frus.n.x * pt.x[..., None] + frus.n.y * pt.y[..., None]
         + frus.n.z * pt.z[..., None] + frus.d)
    return d.max(-1)


def sd_frustum_sphere(frus: Frustum, center: V3, radius):
    """ref sdFrusSph frustum.h:146-161."""
    return sd_frustum(frus, center) - radius


def sd_frustum_box(frus: Frustum, box: Box3D):
    """Conservative box-frustum distance (ref sdFrusBox frustum.h:163-186)."""
    c = box.center
    e = box.extents
    d = (frus.n.x * c.x[..., None] + frus.n.y * c.y[..., None]
         + frus.n.z * c.z[..., None] + frus.d)
    r = (jnp.abs(frus.n.x) * e.x[..., None] + jnp.abs(frus.n.y) * e.y[..., None]
         + jnp.abs(frus.n.z) * e.z[..., None])
    return (d - r).max(-1)


# ---------------------------------------------------------------------------
# Areas (ref area.h)
# ---------------------------------------------------------------------------


def sphere_area(radius):
    """ref area.h:8-12."""
    return 4.0 * PI * radius * radius


def disk_area(radius):
    """ref area.h:13-17."""
    return PI * radius * radius


def tube_area(radius, width):
    """Cylinder side + caps (ref area.h:18-22)."""
    return 2.0 * PI * radius * width + 2.0 * PI * radius * radius


def rect_area(width, height):
    """ref area.h:23-27."""
    return width * height


def tri_area_3d(a: V3, b: V3, c: V3):
    """ref TriArea3D area.h:28-32 — used by emissive power weighting."""
    return 0.5 * length(cross(b - a, c - a))

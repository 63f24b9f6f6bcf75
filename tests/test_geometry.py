"""Geometry math + curve fit tests (ref src/math/{sdf,box,frustum,area,cubic_fit}.h)."""

import jax.numpy as jnp
import numpy as np

from pim.math import cubic_fit as cf
from pim.math import geometry as g
from pim.math.vec3 import V3


def v3(*a):
    arr = np.asarray(a, np.float32).reshape(-1, 3)
    return V3(jnp.asarray(arr[:, 0]), jnp.asarray(arr[:, 1]), jnp.asarray(arr[:, 2]))


def test_sd_sphere_box_plane():
    c = v3(0, 0, 0)
    p = v3(3, 0, 0)
    np.testing.assert_allclose(np.asarray(g.sd_sphere(c, 1.0, p)), 2.0, atol=1e-6)
    box_d = g.sd_box(c, v3(1, 1, 1), v3(2, 0, 0))
    np.testing.assert_allclose(np.asarray(box_d), 1.0, atol=1e-6)
    inside = g.sd_box(c, v3(1, 1, 1), v3(0.5, 0, 0))
    assert float(np.asarray(inside)) < 0.0
    pl = g.plane_new(v3(0, 1, 0), v3(0, 2, 0))
    np.testing.assert_allclose(np.asarray(g.sd_plane(pl, v3(5, 3, 1))), 1.0, atol=1e-6)


def test_sd_triangle_and_area():
    a, b, c = v3(0, 0, 0), v3(1, 0, 0), v3(0, 1, 0)
    d = g.sd_triangle(a, b, c, v3(0.25, 0.25, 2.0))
    np.testing.assert_allclose(np.asarray(d), 2.0, atol=1e-5)
    # edge distance outside
    d2 = g.sd_triangle(a, b, c, v3(-1.0, 0.0, 0.0))
    np.testing.assert_allclose(np.asarray(d2), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(g.tri_area_3d(a, b, c)), 0.5, atol=1e-6)
    np.testing.assert_allclose(g.sphere_area(2.0), 16 * np.pi, rtol=1e-6)


def test_ray_isects():
    ro, rd = v3(-5, 0, 0), v3(1, 0, 0)
    t0, t1 = g.isect_sphere(ro, rd, v3(0, 0, 0), 1.0)
    np.testing.assert_allclose(np.asarray(t0), 4.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(t1), 6.0, atol=1e-5)
    tn, tf = g.isect_box(ro, rd, v3(-1, -1, -1), v3(1, 1, 1))
    np.testing.assert_allclose(np.asarray(tn), 4.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(tf), 6.0, atol=1e-5)
    # miss
    t0m, t1m = g.isect_sphere(v3(-5, 5, 0), rd, v3(0, 0, 0), 1.0)
    assert float(np.asarray(t0m)) > float(np.asarray(t1m))


def test_box_ops():
    pts = V3(jnp.asarray([[0.0, 1.0, -2.0]]), jnp.asarray([[0.0, 3.0, 1.0]]),
             jnp.asarray([[0.0, -1.0, 0.5]]))
    box = g.box_from_pts(pts)
    np.testing.assert_allclose(np.asarray(box.lo.x), -2.0)
    np.testing.assert_allclose(np.asarray(box.hi.y), 3.0)
    b2 = g.Box3D(v3(0, 0, 0), v3(2, 2, 2))
    np.testing.assert_allclose(float(np.asarray(g.box_volume(b2))), 8.0)
    np.testing.assert_allclose(float(np.asarray(g.box_area(b2))), 24.0)
    assert bool(np.asarray(g.box_contains(b2, v3(1, 1, 1))))
    assert not bool(np.asarray(g.box_contains(b2, v3(3, 1, 1))))


def test_frustum_culling():
    frus = g.frustum_new(
        eye=v3(0, 0, 0), right=v3(1, 0, 0), up=v3(0, 1, 0), fwd=v3(0, 0, -1),
        lo=(-1.0, -1.0), hi=(1.0, 1.0), fov_y=np.pi / 2, aspect=1.0,
        z_near=0.1, z_far=100.0)
    inside = g.sd_frustum(frus, v3(0, 0, -10))
    outside = g.sd_frustum(frus, v3(0, 0, 10))
    assert float(np.asarray(inside)) < 0.0
    assert float(np.asarray(outside)) > 0.0
    box_in = g.Box3D(v3(-1, -1, -11), v3(1, 1, -9))
    box_out = g.Box3D(v3(-1, -1, 9), v3(1, 1, 11))
    assert float(np.asarray(g.sd_frustum_box(frus, box_in))) < 0.0
    assert float(np.asarray(g.sd_frustum_box(frus, box_out))) > 0.0


def test_cubic_fit_recovers_curve():
    xs = np.linspace(0.0, 1.0, 32, dtype=np.float32)
    ys = 0.5 * xs + 0.25 * xs**2 + 0.125 * xs**3
    coeffs, err = cf.curve_fit(xs, ys, kind="cubic", iterations=48, population=32)
    assert float(err) < 2e-3
    y_fit = np.asarray(cf.cubic_eval(jnp.asarray(xs), coeffs))
    np.testing.assert_allclose(y_fit, ys, atol=6e-3)


def test_tmap_fit_reinhard():
    xs = np.linspace(0.0, 4.0, 48, dtype=np.float32)
    ys = xs / (1.0 + xs)  # Reinhard: exactly representable by tmap
    coeffs, err = cf.curve_fit(xs, ys, kind="tmap", iterations=64, population=64)
    assert float(err) < 5e-3

import jax.numpy as jnp
import numpy as np

from pim.core import rng
from pim.geom.bvh import BvhArrays, build_bvh, validate_bvh
from pim.geom.cornell import build_cornell_box
from pim.geom.entities import flatten
from pim.math.sampling import sample_unit_sphere
from pim.render import intersect as isect


def _cornell_positions():
    ents, pool = build_cornell_box("boxes")
    flat = flatten(ents)
    return flat.positions


def test_single_triangle_hit():
    tri = jnp.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], jnp.float32)
    ro = jnp.asarray([[0.25, 0.25, 1.0], [2.0, 2.0, 1.0]], jnp.float32)
    rd = jnp.asarray([[0, 0, -1.0], [0, 0, -1.0]], jnp.float32)
    hit = isect.intersect_brute(tri, ro, rd, 0.0, 100.0)
    t = np.asarray(hit.t)
    assert np.isclose(t[0], 1.0, atol=1e-5)
    assert t[1] < 0  # miss
    # barycentric: hitpoint = w*A + u*B + v*C
    assert np.isclose(float(hit.u[0]), 0.25, atol=1e-5)
    assert np.isclose(float(hit.v[0]), 0.25, atol=1e-5)
    # normal faces the ray origin: cross(b-a, c-a) = +Z, ray from +Z: front
    assert not bool(hit.backface[0])
    np.testing.assert_allclose(np.asarray(hit.ng.aos())[0], [0, 0, 1], atol=1e-6)


def test_backface_flag():
    tri = jnp.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], jnp.float32)
    ro = jnp.asarray([[0.25, 0.25, -1.0]], jnp.float32)
    rd = jnp.asarray([[0, 0, 1.0]], jnp.float32)
    hit = isect.intersect_brute(tri, ro, rd, 0.0, 100.0)
    assert bool(hit.backface[0])
    # ng flipped to oppose ray
    np.testing.assert_allclose(np.asarray(hit.ng.aos())[0], [0, 0, -1], atol=1e-6)


def test_cornell_center_ray():
    pos = jnp.asarray(_cornell_positions())
    # ray from center toward the floor must hit y ≈ -4.95 (inner slab face)
    ro = jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32)
    rd = jnp.asarray([[0.0, -1.0, 0.0]], jnp.float32)
    hit = isect.intersect_brute(pos, ro, rd, 0.0, 100.0)
    assert 4.9 < float(hit.t[0]) < 5.0


def test_bvh_build_valid():
    pos = _cornell_positions()
    bvh = build_bvh(pos)
    validate_bvh(bvh, pos)


def test_bvh_matches_brute():
    pos_np = _cornell_positions()
    pos = jnp.asarray(pos_np)
    bvh_np = build_bvh(pos_np)
    bvh = BvhArrays(*[jnp.asarray(a) for a in bvh_np])

    n = 512
    state = rng.make_state(jnp.arange(n), 0, seed=123)
    state, (x, y, z) = rng.next_f32x3(state)
    state, (u, v) = rng.next_f32x2(state)
    ro = jnp.stack([x, y, z], -1) * 8.0 - 4.0  # random origins inside the box
    rd = sample_unit_sphere(u, v).aos()

    hb = isect.intersect_brute(pos, ro, rd, 0.0, 1e6)
    hv = isect.intersect_bvh(bvh, pos, ro, rd, 0.0, 1e6)

    tb, tv = np.asarray(hb.t), np.asarray(hv.t)
    np.testing.assert_allclose(tb, tv, atol=1e-3, rtol=1e-4)
    # same triangle except where coplanar overlaps make ties ambiguous
    same_tri = (np.asarray(hb.tri) == np.asarray(hv.tri)).mean()
    assert same_tri > 0.98


def test_occlusion_matches():
    pos_np = _cornell_positions()
    pos = jnp.asarray(pos_np)
    bvh = BvhArrays(*[jnp.asarray(a) for a in build_bvh(pos_np)])

    n = 256
    state = rng.make_state(jnp.arange(n), 1, seed=7)
    state, (x, y, z) = rng.next_f32x3(state)
    state, (u, v) = rng.next_f32x2(state)
    ro = jnp.stack([x, y, z], -1) * 8.0 - 4.0
    rd = sample_unit_sphere(u, v).aos()
    t_far = jnp.full((n,), 3.0, jnp.float32)

    ob = isect.occluded_brute(pos, ro, rd, 0.0, t_far)
    ov = isect.occluded_bvh(bvh, pos, ro, rd, 0.0, t_far)
    np.testing.assert_array_equal(np.asarray(ob), np.asarray(ov))

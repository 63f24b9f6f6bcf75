"""The BVH traversal kernel (render/bvh_kernel.py) against the XLA
intersectors.

On the CPU the kernel runs in Pallas interpret mode; the `gpu`-marked tests
compile it for the card (run there with `PIM_TEST_GPU=1 python -m pytest -m
gpu tests/test_bvh_kernel.py`, as chip_smoke.py does).  The kernel is
float32 arithmetic with no matrix product, so TF32 does not apply on the
card: hits must match the references' triangle ids apart from ties where
two triangles meet.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pim.geom.bvh import build_bvh
from pim.geom.cornell import build_cornell_box
from pim.geom.entities import flatten
from pim.math.vec3 import V3
from pim.render import bvh_kernel as K
from pim.render import intersect as isect


def _soup(t, seed=1, extent=10.0, size=0.8):
    rng = np.random.default_rng(seed)
    a = rng.random((t, 3), np.float32) * extent
    e1 = (rng.random((t, 3), np.float32) - 0.5) * size
    e2 = (rng.random((t, 3), np.float32) - 0.5) * size
    return np.stack([a, a + e1, a + e2], axis=1).reshape(-1, 3).astype(np.float32)


def _rays(n, seed=3, lo=0.0, hi=10.0):
    rng = np.random.default_rng(seed)
    ro = lo + rng.random((n, 3), np.float32) * (hi - lo)
    rd = rng.standard_normal((n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return jnp.asarray(ro), jnp.asarray(rd)


def _cornell():
    ents, _ = build_cornell_box("boxes")
    return flatten(ents).positions


SCENES = {
    "cornell": (_cornell, dict(lo=-4.0, hi=4.0)),
    "soup3k": (lambda: _soup(3000), dict(lo=0.0, hi=10.0)),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    make, ray_box = SCENES[request.param]
    pos = make()
    bvh = build_bvh(pos, max_leaf=4)
    arrs = tuple(jnp.asarray(a) for a in bvh)
    return request.param, jnp.asarray(pos), arrs, K.bvh_depth(bvh.node_a, bvh.node_b), ray_box


def _kernel(scene, ro, rd, t_near, t_far, any_hit):
    _, pos, bvh, depth, _ = scene
    return K.traverse(bvh, pos, V3.from_aos(ro), V3.from_aos(rd), t_near,
                      t_far, stack=depth, max_leaf=4, any_hit=any_hit)


def _interpreted() -> bool:
    """On the CPU the kernel is interpreted with XLA's own arithmetic, so
    it must match the references exactly; compiled, see below."""
    return jax.default_backend() == "cpu"


def _assert_hits_agree(t, tri, t_ref, tri_ref):
    """Interpreted: the same triangle on every lane.  Compiled, the
    kernel's and XLA's float32 expressions may contract differently, so a
    ray through the crossing of two triangles may pick the other one:
    then the triangle agrees on >= 99.9% of lanes and t, where it
    differs, to 1e-5 (chip_smoke.py's bounds)."""
    t, tri, t_ref, tri_ref = map(np.asarray, (t, tri, t_ref, tri_ref))
    if _interpreted():
        np.testing.assert_array_equal(tri, tri_ref)
        np.testing.assert_allclose(t, t_ref, rtol=1e-5, atol=1e-6)
        return
    diff = tri != tri_ref
    assert diff.mean() <= 1e-3, diff.mean()
    assert ((tri[diff] >= 0) & (tri_ref[diff] >= 0)).all()
    np.testing.assert_allclose(t[diff], t_ref[diff], rtol=1e-5)


def _closest_matches(scene, n):
    _, pos, bvh, _, box = scene
    ro, rd = _rays(n, seed=5, **box)
    t, tri = _kernel(scene, ro, rd, 0.0, 1e6, False)
    hb = isect.intersect_brute(pos, ro, rd, 0.0, 1e6)
    tv, triv, _, _, _ = isect._traverse(*bvh, pos, ro, rd, 0.0,
                                        jnp.full((n,), 1e6), max_leaf=4,
                                        any_hit=False)
    _assert_hits_agree(t, tri, hb.t, hb.tri)
    _assert_hits_agree(t, tri, jnp.where(triv >= 0, tv, -1.0), triv)
    assert (np.asarray(tri) >= 0).mean() > 0.2  # the rays do hit things


def _anyhit_matches(scene, n):
    _, pos, bvh, _, box = scene
    ro, rd = _rays(n, seed=9, **box)
    t_far = jnp.asarray(np.random.default_rng(2).uniform(0.05, 3.0, n),
                        jnp.float32)
    _, tri = _kernel(scene, ro, rd, 0.0, t_far, True)
    ob = isect.occluded_brute(pos, ro, rd, 0.0, t_far)
    _, triv, _, _, _ = isect._traverse(*bvh, pos, ro, rd, 0.0, t_far,
                                       max_leaf=4, any_hit=True)
    flags = np.asarray(tri) >= 0
    for ref in (np.asarray(ob), np.asarray(triv) >= 0):
        if _interpreted():
            np.testing.assert_array_equal(flags, ref)
        else:  # compiled: the smoke's bound, >= 99.99% of lanes
            assert (flags != ref).mean() <= 1e-4
    blocked = float(np.asarray(ob).mean())
    assert 0.02 < blocked < 0.98, blocked  # both outcomes are exercised


def test_closest_hit_matches_brute_and_traverse(scene):
    _closest_matches(scene, 300)


def test_any_hit_matches_brute_and_traverse(scene):
    _anyhit_matches(scene, 300)


def test_dead_lanes_and_per_ray_t_far(scene):
    """t_far <= 0 lanes never enter (miss); per-ray t_far clips hits."""
    _, pos, _, _, box = scene
    n = 200
    ro, rd = _rays(n, seed=11, **box)
    t_far = np.random.default_rng(4).uniform(0.1, 4.0, n).astype(np.float32)
    t_far[::3] = 0.0
    t_far[1::7] = -1.0
    t, tri = _kernel(scene, ro, rd, 0.0, jnp.asarray(t_far), False)
    hb = isect.intersect_brute(pos, ro, rd, 0.0, jnp.asarray(t_far))
    tri = np.asarray(tri)
    dead = t_far <= 0
    assert (tri[dead] == -1).all() and (np.asarray(t)[dead] == -1.0).all()
    np.testing.assert_array_equal(tri, np.asarray(hb.tri))
    hit = tri >= 0
    assert (np.asarray(t)[hit] < t_far[hit]).all()
    _, occ = _kernel(scene, ro, rd, 0.0, jnp.asarray(t_far), True)
    assert (np.asarray(occ)[dead] == -1).all()
    np.testing.assert_array_equal(
        np.asarray(occ) >= 0,
        np.asarray(isect.occluded_brute(pos, ro, rd, 0.0, jnp.asarray(t_far))))


@pytest.mark.parametrize("n", [1, 31, 33, 100])
def test_lane_count_not_a_block_multiple(n):
    pos = _soup(64, seed=7, extent=2.0)
    bvh = build_bvh(pos, max_leaf=4)
    scene = ("soup64", jnp.asarray(pos), tuple(jnp.asarray(a) for a in bvh),
             K.bvh_depth(bvh.node_a, bvh.node_b), dict(lo=0.0, hi=2.0))
    ro, rd = _rays(n, seed=13, lo=0.0, hi=2.0)
    t, tri = _kernel(scene, ro, rd, 0.0, 1e6, False)
    assert t.shape == (n,) and tri.shape == (n,)
    hb = isect.intersect_brute(jnp.asarray(pos), ro, rd, 0.0, 1e6)
    np.testing.assert_array_equal(np.asarray(tri), np.asarray(hb.tri))


def test_empty_and_one_triangle_scenes():
    ro, rd = _rays(40, seed=17, lo=-1.0, hi=1.0)
    empty = np.zeros((0, 3), np.float32)
    bvh = build_bvh(empty, max_leaf=4, prefer_native=False)
    t, tri = K.traverse(tuple(jnp.asarray(a) for a in bvh), jnp.asarray(empty),
                        V3.from_aos(ro), V3.from_aos(rd), 0.0, 1e6, stack=0,
                        max_leaf=4, any_hit=False)
    assert (np.asarray(tri) == -1).all() and (np.asarray(t) == -1.0).all()

    one = np.asarray([[-5, -5, 0], [5, -5, 0], [0, 5, 0]], np.float32)
    bvh = build_bvh(one, max_leaf=4)
    assert K.bvh_depth(bvh.node_a, bvh.node_b) == 0
    ro = jnp.asarray(np.tile([[0.0, 0.0, -2.0]], (40, 1)), jnp.float32)
    ro = ro.at[:, 0].set(jnp.linspace(-8.0, 8.0, 40))
    rd = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32), (40, 1))
    t, tri = K.traverse(tuple(jnp.asarray(a) for a in bvh), jnp.asarray(one),
                        V3.from_aos(ro), V3.from_aos(rd), 0.0, 1e6, stack=0,
                        max_leaf=4, any_hit=False)
    hb = isect.intersect_brute(jnp.asarray(one), ro, rd, 0.0, 1e6)
    np.testing.assert_array_equal(np.asarray(tri), np.asarray(hb.tri))
    assert 0 < (np.asarray(tri) == 0).sum() < 40
    np.testing.assert_allclose(np.asarray(t)[np.asarray(tri) == 0], 2.0,
                               rtol=1e-6)


def test_bvh_depth_bounds_the_stack():
    """The stack holds at most one pending sibling per level, so a stack of
    bvh_depth slots never overflows: depth of a balanced tree is log2."""
    pos = _soup(4096, seed=21)
    bvh = build_bvh(pos, max_leaf=4)
    d = K.bvh_depth(bvh.node_a, bvh.node_b)
    # walk every root-to-leaf path on the host and compare
    best, stack = 0, [(0, 0)]
    while stack:
        node, depth = stack.pop()
        if bvh.node_b[node] < 0:
            best = max(best, depth)
        else:
            stack += [(bvh.node_a[node], depth + 1), (bvh.node_b[node], depth + 1)]
    assert d == best and 10 <= d <= 48


def test_gradient_through_kernel_matches_brute():
    """The kernel's outputs carry no gradient; scene._finalize_hit_fused
    recomputes t, u, v from the fetched vertices, so the camera-position
    gradient of a rendered quantity equals the brute path's."""
    from pim.geom.cornell import build_cornell_box
    from pim.render.scene import build_scene, scene_intersect

    ents, pool = build_cornell_box("boxes")
    meta_k, arrays, _ = build_scene(ents, pool, backend="kernel")
    import dataclasses

    meta_b = dataclasses.replace(meta_k, backend="brute")
    _, rd = _rays(64, seed=23, lo=-1.0, hi=1.0)
    rd = V3.from_aos(rd)

    def loss(eye, meta):
        n = rd.x.shape[0]
        ro = V3(jnp.full((n,), eye[0]), jnp.full((n,), eye[1]),
                jnp.full((n,), eye[2]))
        hit = scene_intersect(meta, arrays, ro, rd, 0.0, 1e6)
        return jnp.sum(hit.t * hit.t + hit.u - hit.v)

    eye = jnp.asarray([0.1, -0.2, 0.3], jnp.float32)
    gk = jax.grad(loss)(eye, meta_k)
    gb = jax.grad(loss)(eye, meta_b)
    np.testing.assert_allclose(np.asarray(gk), np.asarray(gb), rtol=1e-4,
                               atol=1e-4)
    assert float(jnp.abs(gk).sum()) > 0.0


@pytest.mark.gpu
def test_compiled_closest_hit_on_card(gpu, scene):
    _closest_matches(scene, 1 << 16)


@pytest.mark.gpu
def test_compiled_any_hit_on_card(gpu, scene):
    _anyhit_matches(scene, 1 << 16)

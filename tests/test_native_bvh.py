"""Native (C++) BVH builder: invariants + traversal equivalence vs brute.

The native builder (pim/native/bvh_builder.cpp) must produce arrays the
traversal consumes identically to the numpy oracle builder — same
invariants, same hits.  (Ref scene build: src/rendering/path_tracer.c:
618-690, Embree RTC_BUILD_QUALITY_HIGH.)
"""

import numpy as np
import pytest

from pim import native
from pim.geom.bvh import build_bvh_numpy, validate_bvh


def _soup(n_tris: int, seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    base = rng.uniform(-4, 4, (n_tris, 1, 3)).astype(np.float32)
    offs = rng.uniform(-0.4, 0.4, (n_tris, 3, 3)).astype(np.float32)
    return (base + offs).reshape(-1, 3)


needs_native = pytest.mark.skipif(
    native.load() is None, reason="no C++ toolchain for the native builder"
)


@needs_native
def test_native_invariants():
    for n in (1, 2, 5, 33, 500):
        pos = _soup(n, seed=n)
        bvh = native.build_bvh_native(pos)
        validate_bvh(bvh, pos)


@needs_native
def test_native_empty_scene():
    bvh = native.build_bvh_native(np.zeros((0, 3), np.float32))
    assert bvh.node_b[0] < 0 and bvh.tri_order.size == 0


@needs_native
def test_native_degenerate_identical_tris():
    pos = np.tile(_soup(1), (64, 1))
    bvh = native.build_bvh_native(pos)
    validate_bvh(bvh, pos)


@needs_native
def test_native_traversal_matches_brute():
    import jax.numpy as jnp

    from pim.render.intersect import intersect_brute, intersect_bvh

    pos_np = _soup(300, seed=3)
    bvh = native.build_bvh_native(pos_np)
    validate_bvh(bvh, pos_np)

    rng = np.random.default_rng(11)
    n_rays = 256
    ro = jnp.asarray(rng.uniform(-6, 6, (n_rays, 3)).astype(np.float32))
    rd_np = rng.normal(size=(n_rays, 3)).astype(np.float32)
    rd_np /= np.linalg.norm(rd_np, axis=-1, keepdims=True)
    rd = jnp.asarray(rd_np)
    pos = jnp.asarray(pos_np)
    t_near = jnp.full(n_rays, 1e-4, jnp.float32)
    t_far = jnp.full(n_rays, 1e9, jnp.float32)

    hb = intersect_brute(pos, ro, rd, t_near, t_far)
    hv = intersect_bvh(bvh, pos, ro, rd, t_near, t_far)
    np.testing.assert_allclose(np.asarray(hv.t), np.asarray(hb.t),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(hv.tri), np.asarray(hb.tri))


@needs_native
def test_native_matches_numpy_quality():
    # Not bit-identical trees (partition order differs), but comparable
    # node counts — i.e. both are real SAH builds, not degenerate chains.
    pos = _soup(2000, seed=5)
    nat = native.build_bvh_native(pos)
    ref = build_bvh_numpy(pos)
    assert nat.node_a.size < ref.node_a.size * 2
    assert ref.node_a.size < nat.node_a.size * 2

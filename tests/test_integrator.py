import jax.numpy as jnp
import numpy as np
import pytest

from pim.core import rng
from pim.geom.cornell import build_cornell_box
from pim.render.camera import Camera, DofInfo, camera_arrays, generate_primary_rays
from pim.render.integrator import luminance_stddev, trace_rays
from pim.render.scene import build_scene


@pytest.fixture(scope="module")
def cornell():
    ents, pool = build_cornell_box("boxes")
    meta, arrays, lights = build_scene(ents, pool, backend="brute")
    return ents, meta, arrays, lights


def _trace(meta, arrays, lights, n=32, sample=0, bounces=4):
    cam = Camera(position=np.array([-4, 0, 4], np.float32))
    cam.look_at([0, -1, 0])
    ca = camera_arrays(cam, DofInfo(autofocus=False), n, n)
    state = rng.make_state(jnp.arange(n * n), sample)
    state, ro, rd = generate_primary_rays(ca, n, n, state)
    return trace_rays(meta, arrays, lights, ro, rd, state, max_bounces=bounces)


def test_radiance_finite_positive(cornell):
    _, meta, arrays, lights = cornell
    res = _trace(meta, arrays, lights)
    c = np.asarray(res.color)
    assert np.isfinite(c).all()
    assert (c >= 0).all()
    assert c.mean() > 0.01  # the light illuminates the scene
    assert c.mean() < 10.0  # but radiance stays bounded


def test_deterministic(cornell):
    """Same seeds -> identical image (counter-based RNG, no atomics)."""
    _, meta, arrays, lights = cornell
    r1 = _trace(meta, arrays, lights, sample=3)
    r2 = _trace(meta, arrays, lights, sample=3)
    np.testing.assert_array_equal(np.asarray(r1.color), np.asarray(r2.color))


def test_backends_agree():
    """brute and bvh backends give the same radiance for the same seeds —
    the traversal is exact, not approximate (ties on coplanar geometry may
    differ, so compare statistically)."""
    ents, pool = build_cornell_box("boxes")
    meta_b, arrays_b, lights_b = build_scene(ents, pool, backend="brute")
    meta_v, arrays_v, lights_v = build_scene(ents, pool, backend="bvh")
    rb = _trace(meta_b, arrays_b, lights_b, n=24)
    rv = _trace(meta_v, arrays_v, lights_v, n=24)
    cb, cv_ = np.asarray(rb.color), np.asarray(rv.color)
    exact = np.isclose(cb, cv_, atol=1e-4).all(axis=-1).mean()
    assert exact > 0.95
    np.testing.assert_allclose(cb.mean(), cv_.mean(), rtol=0.05)


@pytest.mark.slow
def test_progressive_convergence(cornell):
    """Monte-Carlo contract: averaging k independent samples divides the
    per-pixel variance by ~k.  Collect 16 one-sample images, compare the
    pixel variance across 4 singles vs across 4 means-of-4 (expected 4x
    reduction; assert >2x to leave statistical slack).
    Measured on radiance clipped at 5 — raw path-traced radiance is heavy-
    tailed (fireflies up to kEmissionScale=100) and a 4-sample variance
    estimate of it is dominated by single outliers (measured: clipped ratio
    4.7 ≈ ideal 4, raw ratio ~1)."""
    _, meta, arrays, lights = cornell
    imgs = np.clip(
        [np.asarray(_trace(meta, arrays, lights, n=24, sample=s).color)
         for s in range(16)],
        0.0, 5.0,
    )
    singles = imgs[:4]
    means4 = np.stack([np.mean(imgs[4 * g : 4 * g + 4], axis=0) for g in range(4)])
    var_single = np.var(singles, axis=0).mean()
    var_mean4 = np.var(means4, axis=0).mean()
    assert var_mean4 < var_single / 2.0


@pytest.mark.slow
def test_compaction_bit_identical(cornell):
    """Lane compaction is a pure permutation: per-pixel output must match
    with compact on/off (each lane's RNG stream travels with it).  ULP
    tolerance: the two programs fuse/contract FMA differently, so exact
    bit equality does not hold across compiles (measured max 1.5e-6)."""
    _, meta, arrays, lights = cornell
    n = 16
    cam = Camera(position=np.array([-4, 0, 4], np.float32))
    cam.look_at([0, -1, 0])
    ca = camera_arrays(cam, DofInfo(autofocus=False), n, n)
    state = rng.make_state(jnp.arange(n * n), 5)
    state, ro, rd = generate_primary_rays(ca, n, n, state)
    r_on = trace_rays(meta, arrays, lights, ro, rd, state, max_bounces=5,
                      compact=True)
    r_off = trace_rays(meta, arrays, lights, ro, rd, state, max_bounces=5,
                       compact=False)
    np.testing.assert_allclose(np.asarray(r_on.color), np.asarray(r_off.color),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(r_on.albedo), np.asarray(r_off.albedo),
                               rtol=1e-4, atol=1e-5)
    assert float(r_on.rays_traced) == float(r_off.rays_traced)


def test_light_histogram_learning(cornell):
    _, meta, arrays, lights = cornell
    res = _trace(meta, arrays, lights, bounces=6)
    live = np.asarray(res.live)
    assert live.sum() > 0  # indirect hits on the light feed the histogram
    assert live.shape == (meta.grid_len, meta.emissive_count)


def test_stddev_metric():
    c = jnp.ones((64, 3), jnp.float32)
    assert float(luminance_stddev(c)) == 0.0
    c = jnp.asarray(np.random.default_rng(0).random((1024, 3)), jnp.float32)
    sd = float(luminance_stddev(c))
    assert 0.1 < sd < 0.5


def test_emissive_seen_directly(cornell):
    """A ray aimed straight at the ceiling light returns ~the emission
    (ref UnpackEmission: albedo * e^2 * 100 with e≈1)."""
    _, meta, arrays, lights = cornell
    ro = jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32)
    rd = jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32)
    state = rng.make_state(jnp.asarray([0]), 0)
    res = trace_rays(meta, arrays, lights, ro, rd, state, max_bounces=1)
    c = np.asarray(res.color)[0]
    assert (c > 50.0).all()  # kEmissionScale=100 minus roundtrip loss
    assert (c < 120.0).all()

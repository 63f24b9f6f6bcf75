import jax.numpy as jnp
import numpy as np

from pim.math import dist1d


def test_bake_normalizes():
    pdf = jnp.asarray([[1.0, 2.0, 1.0], [0.0, 0.0, 0.0]], jnp.float32)
    d = dist1d.bake(pdf)
    cdf = np.asarray(d.cdf)
    np.testing.assert_allclose(cdf[0, -1], 1.0, atol=1e-6)
    # zero row falls back to uniform cdf
    np.testing.assert_allclose(cdf[1], [0, 1 / 3, 2 / 3, 1.0], atol=1e-6)
    np.testing.assert_allclose(np.asarray(d.integral), [4.0 / 3.0, 0.0], atol=1e-6)


def test_sample_discrete_matches_pdf():
    pdf = jnp.asarray([[0.1, 0.6, 0.3]], jnp.float32)
    d = dist1d.bake(pdf)
    n = 1 << 16
    u = (jnp.arange(n, dtype=jnp.float32) + 0.5) / n
    cells = jnp.zeros((n,), jnp.int32)
    idx = np.asarray(dist1d.sample_discrete(d, cells, u))
    counts = np.bincount(idx, minlength=3) / n
    np.testing.assert_allclose(counts, [0.1, 0.6, 0.3], atol=2e-3)
    # pdf_discrete returns the actual selection probability
    p = np.asarray(dist1d.pdf_discrete(d, jnp.asarray([0, 0, 0]), jnp.asarray([0, 1, 2])))
    np.testing.assert_allclose(p, [0.1, 0.6, 0.3], atol=1e-5)


def test_update_folds_live_histogram():
    pdf = jnp.asarray([[0.5, 0.5]], jnp.float32)
    d = dist1d.bake(pdf)
    # strong histogram: all hits on bucket 1
    live = jnp.asarray([[0, 1000]], jnp.uint32)
    d2, live2 = dist1d.update(d, live)
    p = np.asarray(d2.pdf)[0]
    assert p[1] > p[0]
    # live decays by >>1
    np.testing.assert_array_equal(np.asarray(live2), [[0, 500]])
    # below-threshold histogram: no change
    weak = jnp.asarray([[0, 10]], jnp.uint32)
    d3, live3 = dist1d.update(d, weak)
    np.testing.assert_allclose(np.asarray(d3.pdf), np.asarray(d.pdf))
    np.testing.assert_array_equal(np.asarray(live3), np.asarray(weak))


def test_update_converges_to_histogram():
    pdf = jnp.asarray([[0.25, 0.25, 0.25, 0.25]], jnp.float32)
    d = dist1d.bake(pdf)
    live = jnp.zeros((1, 4), jnp.uint32)
    target = jnp.asarray([[800, 100, 50, 50]], jnp.uint32)
    for _ in range(30):
        live = live + target
        d, live = dist1d.update(d, live)
    # baked pdf is normalized to mean 1 (sum = N); probability = pdf / N
    p = np.asarray(d.pdf)[0] / 4.0
    np.testing.assert_allclose(p, [0.8, 0.1, 0.05, 0.05], atol=0.05)


def test_sample_continuous():
    pdf = jnp.asarray([[1.0, 1.0]], jnp.float32)
    d = dist1d.bake(pdf)
    u = jnp.asarray([0.25, 0.75], jnp.float32)
    cells = jnp.zeros((2,), jnp.int32)
    x = np.asarray(dist1d.sample_continuous(d, cells, u))
    np.testing.assert_allclose(x, [0.25, 0.75], atol=1e-6)

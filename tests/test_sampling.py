import jax
import jax.numpy as jnp
import numpy as np

from pim.core import rng
from pim.math import sampling


def _uniform2(n, seed=0):
    state = rng.make_state(jnp.arange(n), 0, seed=seed)
    _, (u, v) = rng.next_f32x2(state)
    return u, v


def _aos(v3):
    return np.asarray(v3.aos())


def test_normal_to_tbn_orthonormal():
    n = 4096
    u, v = _uniform2(n)
    d = sampling.sample_unit_sphere(u, v)
    t, b = sampling.normal_to_tbn(d)
    d_np, t_np, b_np = _aos(d), _aos(t), _aos(b)
    assert np.abs(np.sum(t_np * d_np, -1)).max() < 1e-4
    assert np.abs(np.sum(b_np * d_np, -1)).max() < 1e-4
    assert np.abs(np.sum(t_np * b_np, -1)).max() < 1e-4
    assert np.abs(np.linalg.norm(t_np, axis=-1) - 1).max() < 1e-4
    assert np.abs(np.linalg.norm(b_np, axis=-1) - 1).max() < 1e-4


def test_cosine_hemisphere_distribution():
    n = 1 << 16
    u, v = _uniform2(n)
    d = _aos(sampling.sample_cosine_hemisphere(u, v))
    assert (d[:, 2] >= 0).all()
    assert np.abs(np.linalg.norm(d, axis=-1) - 1).max() < 1e-3
    assert abs(d[:, 2].mean() - 2.0 / 3.0) < 5e-3


def test_unit_sphere_uniform():
    n = 1 << 16
    u, v = _uniform2(n)
    d = _aos(sampling.sample_unit_sphere(u, v))
    assert np.abs(np.linalg.norm(d, axis=-1) - 1).max() < 1e-3
    assert np.abs(d.mean(axis=0)).max() < 0.01


def test_ggx_microfacet_stats():
    n = 1 << 16
    alpha = jnp.float32(0.25)
    u, v = _uniform2(n)
    m = _aos(sampling.sample_ggx_microfacet(u, v, alpha))
    assert (m[:, 2] > 0).all()
    c2 = m[:, 2] ** 2
    a2 = float(alpha) ** 2
    uu = (1 - c2) / (c2 * (a2 - 1) + 1)
    hist, _ = np.histogram(uu, bins=16, range=(0, 1))
    assert hist.min() > 0.8 * n / 16


def test_power_heuristic():
    f = jnp.float32(2.0)
    g = jnp.float32(1.0)
    assert np.isclose(float(sampling.power_heuristic(f, g)), 4.0 / 5.0, atol=1e-6)


def test_bary_coord_valid():
    u, v = _uniform2(4096)
    w, bu, bv = sampling.sample_bary_coord(u, v)
    s = np.asarray(w) + np.asarray(bu) + np.asarray(bv)
    np.testing.assert_allclose(s, 1.0, atol=1e-5)
    assert (np.asarray(w) > -1e-6).all()
    assert (np.asarray(bu) > -1e-6).all()


def test_ngon_inside_polygon():
    n = 4096
    u, v = _uniform2(n)
    state = rng.make_state(jnp.arange(n), 9)
    _, side = rng.next_u32(state)
    px, py = sampling.sample_ngon(u, v, side, 6, 0.0)
    r = np.sqrt(np.asarray(px) ** 2 + np.asarray(py) ** 2)
    assert (r <= 1.0 + 1e-5).all()


def test_phase_functions_normalized():
    n = 1 << 16
    u, v = _uniform2(n)
    d = sampling.sample_unit_sphere(u, v)
    cos_t = np.asarray(d.z)
    for g in (0.0, 0.3, -0.5, 0.758):
        ph = np.asarray(sampling.hg_phase(jnp.asarray(cos_t), jnp.float32(g)))
        integral = ph.mean() * 4.0 * np.pi
        # MC tolerance widens with anisotropy (heavy forward tail)
        tol = 0.02 + 0.05 * abs(g)
        assert abs(integral - 1.0) < tol, (g, integral)
    phm = np.asarray(sampling.mie_phase(jnp.asarray(cos_t), jnp.float32(0.5)))
    assert abs(phm.mean() * 4.0 * np.pi - 1.0) < 0.1


def test_gauss_filter_matches_ref_formula():
    u = jnp.asarray([0.25], jnp.float32)
    v = jnp.asarray([0.5], jnp.float32)
    gx, gy = sampling.sample_gauss_pixel_filter(u, v, 1.0)
    radius = np.sqrt(-np.log(0.5))
    want = np.array([np.cos(0.25 * 2 * np.pi), np.sin(0.25 * 2 * np.pi)]) * radius
    np.testing.assert_allclose([float(gx[0]), float(gy[0])], want, atol=1e-5)

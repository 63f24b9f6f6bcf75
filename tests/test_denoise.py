"""Denoiser: noise reduction + edge preservation (the OIDN-analog,
ref src/rendering/denoise.{c,h} — filter types, AOV-guided signature)."""

import jax
import jax.numpy as jnp
import numpy as np

from pim.render.denoise import DenoiseType, denoise

H = W = 64


def _make_two_region():
    """Left/right regions with an albedo edge; noisy constant radiance."""
    key = jax.random.PRNGKey(0)
    base = jnp.where(
        (jnp.arange(W) < W // 2)[None, :, None],
        jnp.asarray([0.2, 0.4, 0.8]),
        jnp.asarray([0.9, 0.5, 0.1]),
    ) * jnp.ones((H, W, 3))
    noise = jax.random.normal(key, (H, W, 3)) * 0.25
    color = jnp.clip(base + noise, 0.0, None)
    albedo = base
    normal = jnp.zeros((H, W, 3)).at[..., 2].set(1.0)
    return base, color, albedo, normal


def test_noise_reduction():
    base, color, albedo, normal = _make_two_region()
    out = denoise(DenoiseType.Image, W, H, color, albedo, normal)
    err_in = float(jnp.mean((color - base) ** 2))
    err_out = float(jnp.mean((out - base) ** 2))
    assert err_out < 0.25 * err_in, (err_in, err_out)


def test_edge_preserved():
    base, color, albedo, normal = _make_two_region()
    out = np.asarray(denoise(DenoiseType.Image, W, H, color, albedo, normal))
    # the albedo edge at W/2 must survive: left/right means stay separated
    left = out[:, : W // 2 - 2].mean(axis=(0, 1))
    right = out[:, W // 2 + 2 :].mean(axis=(0, 1))
    sep = np.abs(left - right)
    base_sep = np.abs(
        np.asarray(base)[:, 0].mean(0) - np.asarray(base)[:, -1].mean(0)
    )
    assert np.all(sep > 0.8 * base_sep), (sep, base_sep)


def test_flat_input_shape_and_color_only():
    key = jax.random.PRNGKey(1)
    color = jax.random.uniform(key, (H * W, 3))
    out = denoise(DenoiseType.Image, W, H, color)  # guides optional
    assert out.shape == (H * W, 3)
    assert bool(jnp.all(jnp.isfinite(out)))
    # color-only filtering still smooths
    assert float(jnp.std(jnp.mean(out, -1))) < float(
        jnp.std(jnp.mean(color, -1))
    )


def test_lightmap_type_runs():
    base, color, albedo, normal = _make_two_region()
    out = denoise(DenoiseType.Lightmap, W, H, color, albedo, normal)
    assert out.shape == color.shape
    assert bool(jnp.all(jnp.isfinite(out)))

"""AOV-guided denoiser: edge-avoiding a-trous wavelet filtering.

Counterpart of src/rendering/denoise.{c,h} (the OIDN wrapper, ref
denoise.c:9-27 lazy device + 8-filter LRU keyed on buffer shape;
DenoiseType_Image|Lightmap).  OIDN is an external CNN with pretrained
weights; the replacement here is the standard real-time-path-tracer
filter instead: an edge-avoiding a-trous wavelet transform (Dammertz et
al. 2010, the SVGF family) guided by the same three AOVs the reference
feeds OIDN — color, albedo, normal (ref Denoise_Execute signature,
denoise.h:23-30).

Mapping: each a-trous level is 25 static shifts of the [H, W, C]
planes (pad + slice, no gathers) with per-pixel edge-stopping weights —
pure elementwise math that XLA fuses into a handful of HBM passes; the
filter-LRU of the reference becomes jit's shape-keyed compilation cache.

The filter lives OUTSIDE the gradient path (SURVEY.md §7.9: "optional
OIDN-analog conv denoiser outside grad path").
"""

from __future__ import annotations

from enum import Enum
from functools import partial

import jax
import jax.numpy as jnp


class DenoiseType(Enum):
    """ref denoise.h:10-14."""

    Image = 0
    Lightmap = 1


# B3-spline 5-tap weights (Dammertz et al., the a-trous generator)
_H5 = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)


def _shift2d(img: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """Shift [H, W, C] by (dy, dx) with edge-clamp padding; static offsets."""
    h, w = img.shape[0], img.shape[1]
    py0, py1 = max(dy, 0), max(-dy, 0)
    px0, px1 = max(dx, 0), max(-dx, 0)
    padded = jnp.pad(img, ((py0, py1), (px0, px1), (0, 0)), mode="edge")
    return jax.lax.dynamic_slice(
        padded, (py1, px1, 0), (h, w, img.shape[2])
    )


def _atrous_level(color, albedo, normal, lum_sigma_rcp, step: int,
                  sigma_albedo: float, sigma_normal: float):
    """One a-trous level: 5x5 dilated B3 kernel with edge-stopping weights.

    color/albedo/normal [H, W, 3]; lum_sigma_rcp [H, W, 1] (1/sigma_c per
    pixel, from the local luminance variance estimate); returns filtered
    color.
    """
    lum_c = jnp.mean(color, axis=-1, keepdims=True)

    acc = jnp.zeros_like(color)
    wacc = jnp.zeros_like(lum_c)
    for iy, hy in enumerate(_H5):
        for ix, hx in enumerate(_H5):
            dy = (iy - 2) * step
            dx = (ix - 2) * step
            c_q = _shift2d(color, dy, dx)
            a_q = _shift2d(albedo, dy, dx)
            n_q = _shift2d(normal, dy, dx)
            # edge-stopping: luminance (variance-normalized), albedo, normal
            dl = jnp.abs(jnp.mean(c_q, -1, keepdims=True) - lum_c)
            w_l = jnp.exp(-dl * lum_sigma_rcp)
            da = jnp.sum((a_q - albedo) ** 2, -1, keepdims=True)
            w_a = jnp.exp(-da / sigma_albedo)
            ndn = jnp.sum(n_q * normal, -1, keepdims=True)
            w_n = jnp.maximum(ndn, 0.0) ** sigma_normal
            w = (hy * hx) * w_l * w_a * w_n
            acc = acc + c_q * w
            wacc = wacc + w
    return acc / jnp.maximum(wacc, 1e-8)


@partial(jax.jit, static_argnames=("iterations", "sigma_normal"))
def _denoise_hwc(color, albedo, normal, iterations: int = 5,
                 sigma_luminance: float = 4.0, sigma_albedo: float = 0.01,
                 sigma_normal: float = 32.0):
    nrm = normal / jnp.sqrt(
        jnp.maximum(jnp.sum(normal**2, -1, keepdims=True), 1e-12)
    )
    # local luminance std-dev estimate (3x3) drives the color sigma so the
    # filter widens where the Monte-Carlo noise is strong (SVGF-style)
    lum = jnp.mean(color, -1, keepdims=True)
    m1 = jnp.zeros_like(lum)
    m2 = jnp.zeros_like(lum)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            lq = _shift2d(lum, dy, dx)
            m1 = m1 + lq
            m2 = m2 + lq * lq
    m1 = m1 / 9.0
    m2 = m2 / 9.0
    sigma_c = jnp.sqrt(jnp.maximum(m2 - m1 * m1, 0.0))
    lum_sigma_rcp = 1.0 / (sigma_luminance * jnp.maximum(sigma_c, 1e-4))

    out = color
    for i in range(iterations):
        out = _atrous_level(out, albedo, nrm, lum_sigma_rcp, 1 << i,
                            sigma_albedo, sigma_normal)
    return out


def denoise(dtype: DenoiseType, width: int, height: int, color,
            albedo=None, normal=None, iterations: int = 5):
    """Denoise a [H*W, 3] (or [H, W, 3]) HDR buffer (ref Denoise_Execute,
    denoise.h:23-30: color3+albedo3+normal3 -> output3).

    Missing guides fall back to neutral planes (OIDN also accepts
    color-only input).  Lightmap filtering uses fewer iterations — texel
    neighborhoods are small and chart borders must not bleed.
    """
    flat_in = color.ndim == 2
    c = color.reshape(height, width, 3)
    a = (albedo.reshape(height, width, 3) if albedo is not None
         else jnp.zeros_like(c))
    n = (normal.reshape(height, width, 3) if normal is not None
         else jnp.concatenate(
             [jnp.zeros((height, width, 2), c.dtype),
              jnp.ones((height, width, 1), c.dtype)], -1))
    if dtype == DenoiseType.Lightmap:
        iterations = min(iterations, 3)
    out = _denoise_hwc(c, a, n, iterations=iterations)
    return out.reshape(-1, 3) if flat_in else out

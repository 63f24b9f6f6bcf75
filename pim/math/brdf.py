"""Physically-based BRDF building blocks (GGX / Smith / Schlick / Burley).

Counterpart of the reference's src/math/lighting.h, plus the split-sum BRDF
LUT bake from src/math/lighting.c:86-144.  Colors are SoA V3 (vec3.py);
scalars are flat [N] arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from pim.math.vec3 import EPS, EPS_SQ, PI, V3, lerp, saturate

K_MIN_DENOM = jnp.float32(1.0 / (1 << 10))
K_MIN_ALPHA = K_MIN_DENOM


def brdf_alpha(roughness):
    """Perceptual roughness -> alpha (ref lighting.h:57-60)."""
    return jnp.maximum(roughness * roughness, K_MIN_ALPHA)


def f_0(albedo: V3, metallic) -> V3:
    """Reflectance at normal incidence (ref lighting.h:69-72)."""
    return V3(
        lerp(jnp.float32(0.04), albedo.x, metallic),
        lerp(jnp.float32(0.04), albedo.y, metallic),
        lerp(jnp.float32(0.04), albedo.z, metallic),
    )


def f_90(f0: V3):
    """Grazing reflectance (ref lighting.h:75-78)."""
    return saturate(50.0 * 0.33 * (f0.x + f0.y + f0.z))


def f_schlick(f0: V3, f90, cos_theta) -> V3:
    """Schlick fresnel (ref lighting.h:90-95)."""
    t = 1.0 - cos_theta
    t5 = t * t * t * t * t
    return V3(
        lerp(f0.x, f90, t5), lerp(f0.y, f90, t5), lerp(f0.z, f90, t5)
    )


def f_schlick1(f0, f90, cos_theta):
    t = 1.0 - cos_theta
    t5 = t * t * t * t * t
    return lerp(f0, f90, t5)


def f_dielectric(cos_theta_i, eta_i, eta_t):
    """Exact dielectric fresnel w/ TIR (ref lighting.h:138-162).
    Negative cosθ = transmission side (etas swap)."""
    cos_theta_i = jnp.clip(cos_theta_i, -1.0, 1.0)
    trans = cos_theta_i < 0.0
    cos_i = jnp.abs(cos_theta_i)
    ei = jnp.where(trans, eta_t, eta_i)
    et = jnp.where(trans, eta_i, eta_t)
    sin_i = jnp.sqrt(jnp.maximum(1.0 - cos_i * cos_i, EPS_SQ))
    sin_t = (ei / et) * sin_i
    tir = sin_t >= 1.0
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin_t * sin_t, EPS_SQ))
    r_parl = ((et * cos_i) - (ei * cos_t)) / jnp.maximum((et * cos_i) + (ei * cos_t), EPS)
    r_perp = ((ei * cos_i) - (et * cos_t)) / jnp.maximum((ei * cos_i) + (et * cos_t), EPS)
    f = saturate((r_parl * r_parl + r_perp * r_perp) * 0.5)
    return jnp.where(tir, jnp.float32(1.0), f)


def d_gtr(noh, alpha):
    """GGX Trowbridge-Reitz NDF (ref lighting.h:218-224)."""
    a2 = alpha * alpha
    f = lerp(jnp.float32(1.0), a2, noh * noh)
    f = f * f * PI
    return a2 / jnp.maximum(f, EPS)


def v_smith_correlated(nol, nov, alpha):
    """Height-correlated Smith visibility (ref lighting.h:246-253)."""
    a2 = alpha * alpha
    v = nol * jnp.sqrt(jnp.maximum(a2 + (nov - nov * a2) * nov, EPS_SQ))
    l = nov * jnp.sqrt(jnp.maximum(a2 + (nol - nol * a2) * nol, EPS_SQ))
    return 0.5 / jnp.maximum(v + l, EPS)


def fd_lambert():
    return 1.0 / PI


def fd_burley(nol, nov, hov, roughness):
    """Disney diffuse (ref lighting.h:266-276)."""
    fd90 = 0.5 + 2.0 * hov * hov * roughness
    light_scatter = f_schlick1(1.0, fd90, nol)
    view_scatter = f_schlick1(1.0, fd90, nov)
    return (light_scatter * view_scatter) / PI


def diffuse_color(albedo: V3, metallic) -> V3:
    return albedo * (1.0 - metallic)


def sigma_a_from_reflectance(albedo: V3, beta_n) -> V3:
    """Chiang et al. color reparameterization (ref lighting.h:193-206)."""
    r2 = beta_n * beta_n
    r3 = r2 * beta_n
    r4 = r3 * beta_n
    r5 = r4 * beta_n
    t = jnp.maximum(
        5.969 - 0.215 * beta_n + 2.532 * r2 - 10.73 * r3 + 5.574 * r4 + 0.245 * r5,
        EPS,
    )

    def chan(a):
        s = jnp.log(jnp.maximum(a, EPS)) / t
        return s * s

    return V3(chan(albedo.x), chan(albedo.y), chan(albedo.z))


def albedo_to_transmittance(albedo: V3, roughness, thickness) -> V3:
    """Beer-Lambert interior transmittance (ref lighting.h:208-212)."""
    sig = sigma_a_from_reflectance(albedo, roughness)
    return V3(
        jnp.exp(-sig.x * thickness),
        jnp.exp(-sig.y * thickness),
        jnp.exp(-sig.z * thickness),
    )


# ---------------------------------------------------------------------------
# Split-sum BRDF LUT (GGX energy compensation).
# The reference bakes this progressively on the task system
# (src/math/lighting.c:86-144); one jitted QMC integration fills the whole
# LUT at init.
# ---------------------------------------------------------------------------


class BrdfLut(NamedTuple):
    # texels[..., 0] = ∫ Fc·D·V·NoL (dielectric fresnel weighted)
    # texels[..., 1] = ∫ D·V·NoL
    texels: jnp.ndarray  # [size, size, 2] over (NoV, alpha)


def _integrate_brdf(nov, alpha, num_samples: int):
    """Split-sum integration for one (NoV, alpha) texel
    (matches src/math/lighting.c:58-81 under GGX half-vector sampling)."""
    from pim.math.sampling import hammersley_2d, sample_ggx_microfacet

    vx = jnp.sqrt(jnp.maximum(1.0 - nov * nov, 0.0))
    i = jnp.arange(num_samples, dtype=jnp.uint32)
    hu, hv = hammersley_2d(i, num_samples)
    m = sample_ggx_microfacet(hu, hv, alpha)  # V3 of [S]
    vm = vx * m.x + nov * m.z  # dot(V, m) with V = (vx, 0, nov)
    # L = reflect(-V, m) => L = 2(V.m)m - V
    lz = 2.0 * vm * m.z - nov
    nol = lz
    noh = saturate(m.z)
    voh = vm
    valid = nol > EPS
    g = v_smith_correlated(jnp.maximum(nol, 0.0), jnp.maximum(nov, EPS), alpha)
    g_vis = jnp.where(valid, (g * voh * nol * 4.0) / jnp.maximum(noh, EPS), 0.0)
    fc = f_dielectric(voh, jnp.float32(1.000293), jnp.float32(1.52))
    n = jnp.float32(num_samples)
    return jnp.stack([jnp.sum(fc * g_vis) / n, jnp.sum(g_vis) / n])


def bake_brdf_lut(size: int = 16, num_samples: int = 4096) -> BrdfLut:
    """Bake the split-sum LUT; texel i at coordinate i/(size-1) to match
    the bilinear fetch convention (sampler.h LinearClamp)."""
    nov = jnp.clip(jnp.arange(size, dtype=jnp.float32) / (size - 1), EPS, 1.0 - EPS)
    alpha = jnp.clip(jnp.arange(size, dtype=jnp.float32) / (size - 1), K_MIN_ALPHA, 1.0)
    fn = jax.vmap(
        jax.vmap(lambda a, n: _integrate_brdf(n, a, num_samples), (None, 0)), (0, None)
    )
    texels = fn(alpha, nov)  # [alpha, nov, 2]
    return BrdfLut(texels=jnp.swapaxes(texels, 0, 1))  # [nov, alpha, 2]


def brdf_lut_sample(lut: BrdfLut, nov, alpha):
    """Bilinear clamped fetch at (NoV, alpha) (ref lighting.h:52-55).

    Returns (dvf, dv) as two flat [N] arrays.  Separable formulation: the
    bilinear weight of texel i along an axis is the tent max(0, 1-|i-x|),
    so the fetch is a [2S, S] @ [S, N] contraction over the NoV axis
    followed by a [S, 2, N] tent-weighted reduction over alpha (a single
    product would need a [S², N] weighted one-hot, ~4x the bytes).
    """
    import jax

    size = lut.texels.shape[0]
    x = jnp.clip(nov, 0.0, 1.0) * (size - 1)
    y = jnp.clip(alpha, 0.0, 1.0) * (size - 1)
    ix = jax.lax.broadcasted_iota(jnp.float32, (size, x.shape[0]), 0)
    wx = jnp.maximum(0.0, 1.0 - jnp.abs(ix - x[None, :]))  # [S, N] tents
    wy = jnp.maximum(0.0, 1.0 - jnp.abs(ix - y[None, :]))
    # texels [nov=x, alpha=y, 2] -> [(y, c), x] then contract over x.
    # HIGHEST: a reduced-precision product (TF32 on the GPU) would quantize both the
    # tent weights and the LUT values (visible as a staircase in the
    # energy-compensation term and a piecewise-flat roughness gradient)
    l_t = lut.texels.reshape(size, size * 2).T  # [(y c), x] loop-invariant
    p = jnp.dot(l_t, wx, preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST)  # [2S, N]
    p = p.reshape(size, 2, x.shape[0])
    out = jnp.sum(p * wy[:, None, :], axis=0)  # [2, N]
    return out[0], out[1]


def ggx_energy_compensation(lut: BrdfLut, f0: V3, nov, alpha) -> V3:
    """Multi-scatter energy compensation (ref lighting.h:294-303)."""
    _, dv = brdf_lut_sample(lut, nov, alpha)
    t = (1.0 / jnp.maximum(dv, EPS)) - 1.0
    return V3(f0.x * t + 1.0, f0.y * t + 1.0, f0.z * t + 1.0)


def env_brdf(lut: BrdfLut, f0: V3, nov, alpha) -> V3:
    """Pre-integrated environment BRDF (ref lighting.h:278-291)."""
    dvf, dv = brdf_lut_sample(lut, nov, alpha)
    return V3(
        (1.0 - f0.x) * dvf + f0.x * dv,
        (1.0 - f0.y) * dvf + f0.y * dv,
        (1.0 - f0.z) * dvf + f0.z * dv,
    )

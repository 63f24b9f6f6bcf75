"""Spherical gaussians: basis eval, irradiance, progressive fitting.

Counterpart of src/math/sphgauss.{c,h} — the 5-lobe SG basis used by the
GI lightmapper (lightmap.h:12-21).  Everything is batched jnp: an SG set is
(axes [K, 4] (xyz dir + sharpness), amplitudes [..., K, 4] (rgb + running
basis weight in w)).

The progressive fit (`sg_accumulate`) is Roughton's running least-squares:
each new (direction, radiance) sample nudges every lobe's amplitude toward
the residual it should explain; sample_weight = 1/N gives the running
average (same math as SG_Accumulate, sphgauss.c:19-58).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from pim.math.vec import EPS, TAU, lerp, saturate

# the lightmapper's 5 fixed GI directions (ref lightmap.h:14-21)
GI_AXII = np.array(
    [
        [0.000000, 0.000000, 1.000000, 4.999773],
        [0.577350, 0.577350, 0.577350, 4.999773],
        [-0.577350, 0.577350, 0.577350, 4.999773],
        [0.577350, -0.577350, 0.577350, 4.999773],
        [-0.577350, -0.577350, 0.577350, 4.999773],
    ],
    np.float32,
)


def sg_basis_eval(axes, dirs):
    """e^(sharpness * (cosθ - 1)); axes [K, 4], dirs [..., 3] -> [..., K]."""
    cos_t = jnp.einsum("kc,...c->...k", axes[:, :3], dirs, precision="highest")
    return jnp.exp(axes[:, 3] * (cos_t - 1.0))


def sg_eval(axes, amplitudes, dirs):
    """Radiance of the SG set along dirs: [..., K, 4] amps -> [..., 3]."""
    basis = sg_basis_eval(axes, dirs)  # [..., K]
    return jnp.sum(amplitudes[..., :3] * basis[..., None], axis=-2)


def sg_basis_integral(sharpness):
    return TAU * (1.0 - jnp.exp(-2.0 * sharpness)) / sharpness


def sg_irradiance(axes, amplitudes, normal):
    """Hill's fitted hemispherical irradiance (ref sphgauss.h:66-100).
    axes [K,4], amplitudes [..., K, 4], normal [..., 3] -> [..., 3]."""
    mu_dot_n = jnp.einsum("kc,...c->...k", axes[:, :3], normal, precision="highest")  # [..., K]
    lam = axes[:, 3]
    c0 = 0.36
    c1 = 1.0 / (4.0 * 0.36)
    eml = jnp.exp(-lam)
    eml2 = eml * eml
    rl = 1.0 / lam
    scale = 1.0 + 2.0 * eml2 - rl
    bias = (eml - eml2) * rl - eml2
    x = jnp.sqrt(jnp.maximum(1.0 - scale, EPS))
    x0 = c0 * mu_dot_n
    x1 = c1 * x
    n = x0 + x1
    y = jnp.where(jnp.abs(x0) <= x1, (n * n) / x, saturate(mu_dot_n))
    norm_irr = scale * y + bias  # [..., K]
    integral = amplitudes[..., :3] * sg_basis_integral(lam)[..., None]
    return jnp.sum(integral * norm_irr[..., None], axis=-2)


def sg_accumulate(sample_weight, dirs, radiance, axes, amplitudes):
    """Progressive SG fit of one sample per texel (Roughton running fit).

    dirs [..., 3], radiance [..., 3], amplitudes [..., K, 4]
    (w channel = running basis weight).  Returns new amplitudes.
    sample_weight scalar or [...]: 1/sampleCount per texel.
    """
    sw = jnp.asarray(sample_weight, jnp.float32)
    if sw.ndim < dirs.ndim - 1:
        sw = jnp.broadcast_to(sw, dirs.shape[:-1])
    first = (sw >= 1.0)[..., None, None]
    amplitudes = jnp.where(first, 0.0, amplitudes)

    basis = sg_basis_eval(axes, dirs)  # [..., K]
    estimate = jnp.sum(amplitudes[..., :3] * basis[..., None], axis=-2)  # [..., 3]

    amp_rgb = amplitudes[..., :3]
    weight = amplitudes[..., 3]
    new_weight = lerp(weight, basis, sw[..., None])
    other = estimate[..., None, :] - amp_rgb * basis[..., None]
    this_lobe = (radiance[..., None, :] - other) * (
        basis / jnp.maximum(new_weight, EPS)
    )[..., None]
    new_rgb = lerp(amp_rgb, this_lobe, sw[..., None, None])
    new_rgb = jnp.maximum(new_rgb, 0.0)
    active = (basis > 0.0)[..., None]
    out_rgb = jnp.where(active, new_rgb, amp_rgb)
    out_w = jnp.where(basis > 0.0, new_weight, weight)
    return jnp.concatenate([out_rgb, out_w[..., None]], axis=-1)

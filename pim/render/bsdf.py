"""Principled BSDF: evaluation and sampling, SoA over flat [N] lanes.

Counterpart of Eval/Scatter_{Diffuse,Specular,Refractive,Principled}
(ref: src/rendering/path_tracer.c:1476-1707).  The principled surface is a
stochastic lobe mix: specular weight lerp(0.5, 1.0, metallic), the rest
diffuse; refractive materials switch to a GGX-microfacet dielectric with
Beer-Lambert interior transmittance.

All per-lane discrete decisions (lobe choice, reflect-vs-refract) are
`where`-selected; gradient flow stays on the radiance weights (lobe
decisions depend only on uniforms and are naturally detached).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from pim.core import rng
from pim.geom.material import MatFlag
from pim.math.brdf import (
    BrdfLut,
    albedo_to_transmittance,
    brdf_alpha,
    d_gtr,
    f_0,
    f_90,
    f_dielectric,
    fd_burley,
    ggx_energy_compensation,
    v_smith_correlated,
)
from pim.math.sampling import (
    ggx_pdf,
    lambert_pdf,
    sample_cosine_hemisphere,
    sample_ggx_microfacet,
    tan_to_world,
)
from pim.math.vec3 import (
    EPS,
    MILLI,
    V3,
    dot,
    dotsat,
    lerp,
    lerp3,
    normalize,
    reflect,
    refract,
    where3,
)
from pim.render.surface import Surface, fix_shading_normal


class Scatter(NamedTuple):
    """One BSDF sample (ref PtScatter :74-81)."""

    pos: V3
    dir: V3
    attenuation: V3  # brdf * NoL
    pdf: jnp.ndarray


def eval_diffuse(surf: Surface, i: V3, l: V3):
    """Burley diffuse eval (ref Eval_Diffuse :1476-1497).
    Returns (attenuation V3, pdf [N])."""
    n = surf.n
    nol = dot(n, l)
    pdf = lambert_pdf(nol)
    valid = pdf > EPS
    v = -i
    h = normalize(v + l)
    hov = dotsat(h, v)
    nov = dotsat(n, v)
    s = fd_burley(nol, nov, hov, surf.roughness) * nol
    s = jnp.where(valid, s, 0.0)
    return surf.albedo * s, jnp.where(valid, pdf, 0.0)


def eval_specular(lut: BrdfLut, surf: Surface, i: V3, l: V3):
    """GGX specular eval with energy compensation (ref Eval_Specular
    :1516-1548)."""
    n = surf.n
    nol = dot(n, l)
    alpha = brdf_alpha(surf.roughness)
    v = -i
    h = normalize(v + l)
    noh = dot(n, h)
    hov = dot(h, v)
    pdf = ggx_pdf(noh, hov, alpha)
    valid = (nol > EPS) & (pdf > EPS)
    nov = dotsat(n, v)
    f_d = jnp.clip(f_dielectric(hov, jnp.float32(1.0), jnp.float32(1.5)), 0.0, 1.0)
    f0 = f_0(surf.albedo, surf.metallic)
    f90 = f_90(f0)
    f = V3(lerp(f0.x, f90, f_d), lerp(f0.y, f90, f_d), lerp(f0.z, f90, f_d))
    d = d_gtr(noh, alpha)
    g = v_smith_correlated(nol, nov, alpha)
    comp = ggx_energy_compensation(lut, f0, nov, alpha)
    s = jnp.where(valid, d * g * nol, 0.0)
    atten = f * comp * s
    return atten, jnp.where(valid, pdf, 0.0)


def eval_principled(lut: BrdfLut, surf: Surface, i: V3, l: V3):
    """Mixed-lobe eval for NEE (ref Eval_Principled :1641-1668).
    Refractive lanes evaluate to zero."""
    nol = dot(surf.n, l)
    amt_spec = lerp(jnp.float32(0.5), jnp.float32(1.0), surf.metallic)
    amt_diff = 1.0 - amt_spec
    spec_a, spec_p = eval_specular(lut, surf, i, l)
    diff_a, diff_p = eval_diffuse(surf, i, l)
    atten = lerp3(spec_a, diff_a, amt_diff)
    pdf = lerp(spec_p, diff_p, amt_diff)
    refractive = (surf.flags & int(MatFlag.REFRACTIVE)) != 0
    dead = refractive | (nol <= EPS)
    zero = jnp.float32(0.0)
    return (
        where3(dead, V3(zero, zero, zero), atten),
        jnp.where(dead, 0.0, pdf),
    )


def scatter_principled(lut: BrdfLut, surf: Surface, i: V3, state, occluded_fn=None):
    """One-sample lobe-mixed BSDF sample (ref Scatter_Principled :1670-1707).
    Returns (state, Scatter).

    `occluded_fn(ro V3, rd V3) -> t_hit [N]` supplies the interior-thickness
    probe for refractive transmission; None compiles the refractive path out.
    """
    state, u_lobe = rng.next_f32(state)
    state, (xu, xv) = rng.next_f32x2(state)
    amt_spec = lerp(jnp.float32(0.5), jnp.float32(1.0), surf.metallic)
    amt_diff = 1.0 - amt_spec
    use_spec = u_lobe < amt_spec

    # specular sample (ref Scatter_Specular :1550-1565)
    alpha = brdf_alpha(surf.roughness)
    m = tan_to_world(surf.n, sample_ggx_microfacet(xu, xv, alpha))
    m = fix_shading_normal(surf.m, m)
    l_spec = reflect(i, m)
    # diffuse sample (ref Scatter_Diffuse :1499-1514), same 2D draw
    l_diff = tan_to_world(surf.n, sample_cosine_hemisphere(xu, xv))

    l = where3(use_spec, l_spec, l_diff)
    # evaluate both lobes at the chosen direction (one-sample MIS mix)
    e_spec_a, e_spec_p = eval_specular(lut, surf, i, l)
    e_diff_a, e_diff_p = eval_diffuse(surf, i, l)

    atten_spec_branch = lerp3(e_spec_a, e_diff_a, amt_diff)
    pdf_spec_branch = lerp(e_spec_p, e_diff_p, amt_diff)
    atten_diff_branch = lerp3(e_diff_a, e_spec_a, amt_spec)
    pdf_diff_branch = lerp(e_diff_p, e_spec_p, amt_spec)

    atten = where3(use_spec, atten_spec_branch, atten_diff_branch)
    pdf = jnp.where(use_spec, pdf_spec_branch, pdf_diff_branch)
    pos = surf.p

    if occluded_fn is not None:
        refractive = (surf.flags & int(MatFlag.REFRACTIVE)) != 0
        state, refr = _scatter_refractive(surf, i, state, occluded_fn,
                                          refractive)
        pos = where3(refractive, refr.pos, pos)
        l = where3(refractive, refr.dir, l)
        atten = where3(refractive, refr.attenuation, atten)
        pdf = jnp.where(refractive, refr.pdf, pdf)

    return state, Scatter(pos=pos, dir=l, attenuation=atten, pdf=pdf)


def _scatter_refractive(surf: Surface, i: V3, state, thickness_fn, mask):
    """GGX microfacet dielectric with Beer-Lambert interior transmittance
    (ref Scatter_Refractive :1576-1638).

    mask: lanes whose result is actually used (refractive materials); the
    interior-thickness probe carries it so non-refractive lanes trace with
    t_far = 0 and retire before their first node (unmasked, the probe
    would be a full extra closest-hit per bounce for a handful of glass
    lanes)."""
    eta_i = jnp.float32(1.000277)
    eta_t = jnp.maximum(1.0, surf.ior)
    alpha = brdf_alpha(surf.roughness)

    state, (xu, xv) = rng.next_f32x2(state)
    state, u_fresnel = rng.next_f32(state)

    v = -i
    m = tan_to_world(surf.n, sample_ggx_microfacet(xu, xv, alpha))
    m = fix_shading_normal(surf.m, m)
    entering = ~surf.backface

    cos_i = jnp.clip(jnp.abs(dot(v, m)), 0.0, 1.0)
    fres = f_dielectric(jnp.where(entering, cos_i, -cos_i), eta_i, eta_t)

    do_reflect = u_fresnel < fres
    l_reflect = reflect(i, m)
    k = jnp.where(entering, eta_i / eta_t, eta_t / eta_i)
    l_refract = refract(i, m, k)
    tir = dot(l_refract, l_refract) < 1e-8
    l_refract = where3(tir, l_reflect, l_refract)
    l = where3(do_reflect, l_reflect, l_refract)
    pdf = jnp.where(do_reflect, fres, 1.0 - fres)

    below = dot(l, surf.m) < 0.0
    pos = where3(below, surf.p - surf.m * (MILLI * 0.1), surf.p)

    refracting_in = (~do_reflect) & entering & ~tir
    t_hit = thickness_fn(pos, l, mask & refracting_in)
    thickness = jnp.where(t_hit >= 0.0, jnp.maximum(t_hit, EPS), jnp.float32(1e6))
    tr = albedo_to_transmittance(surf.albedo, surf.roughness, thickness)
    atten = where3(refracting_in, tr * pdf, V3(pdf, pdf, pdf))

    return state, Scatter(pos=pos, dir=l, attenuation=atten, pdf=pdf)

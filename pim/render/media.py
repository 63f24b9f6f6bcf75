"""Heterogeneous participating media: null scattering + ratio tracking (SoA).

Counterpart of the reference's media system (ref: src/rendering/
path_tracer.c:91-118 PtMediaDesc, 2146-2304 Media_Sample / CalcTransmittance
/ ScatterRay): constant + fBm-noise-banded scattering, dual-lobe Mie phase,
Woodcock-style free-path sampling against the majorant, ratio-tracked
transmittance.

Redesign: the reference's unbounded `while` marches become
fixed-iteration masked `lax.scan`s (MEDIA_STEPS); phase-direction sampling
replaces the ref's rejection loop with a fixed number of masked retries.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from pim.core import rng
from pim.math.noise import fbm_gradient_noise3
from pim.math.sampling import mie_phase, sample_free_path, sample_unit_sphere
from pim.math.vec3 import EPS, V3, lerp, max3, saturate, where3

MEDIA_STEPS = 32       # fixed trip count for free-path marches
PHASE_RETRIES = 8      # fixed trip count for phase rejection sampling


class MediaDesc(NamedTuple):
    """Static media description (ref PtMediaDesc :91-111 +
    media_desc_new :1944-1961 defaults)."""

    constant_mu: V3        # scattering coefficient (constant term)
    noise_mu: V3           # scattering coefficient (noise band term)
    absorption: jnp.ndarray
    noise_octaves: int     # static
    noise_gain: jnp.ndarray
    noise_lacunarity: jnp.ndarray
    noise_freq: jnp.ndarray
    noise_scale: jnp.ndarray
    noise_height: jnp.ndarray
    noise_range: jnp.ndarray
    rcp_majorant: jnp.ndarray
    phase_dir_a: jnp.ndarray
    phase_dir_b: jnp.ndarray
    phase_blend: jnp.ndarray


def make_media_desc(
    constant_color=(0.5, 0.5, 0.5),
    noise_color=(0.5, 0.5, 0.5),
    constant_mfp: float = 40.0e3,
    noise_mfp: float = 40.0e3,
    absorption: float = 0.1,
    noise_octaves: int = 1,
    noise_gain: float = 0.9,
    noise_lacunarity: float = 2.0666,
    noise_freq: float = 1.0,
    noise_scale: float = 1.0,
    noise_height: float = 20.0,
    phase_dir_a: float = 0.0,
    phase_dir_b: float = 0.0,
    phase_blend: float = 0.5,
) -> MediaDesc:
    """Defaults match media_desc_new/update (ref :1944-1987)."""
    import numpy as np

    cc = np.asarray(constant_color, np.float32)
    nc = np.asarray(noise_color, np.float32)
    c_mfp = constant_mfp * (0.5 + 1.5 * cc)  # lerp(0.5x, 2x, color)
    n_mfp = noise_mfp * (0.5 + 1.5 * nc)
    c_mu = 1.0 / c_mfp
    n_mu = 1.0 / n_mfp
    amp = sum(noise_gain**i for i in range(noise_octaves))
    noise_range = amp * noise_scale * 1.5
    a = 1.0 + absorption
    majorant = float(2.0 * a * (c_mu.max() + n_mu.max()))
    return MediaDesc(
        constant_mu=V3.splat(c_mu),
        noise_mu=V3.splat(n_mu),
        absorption=jnp.float32(absorption),
        noise_octaves=noise_octaves,
        noise_gain=jnp.float32(noise_gain),
        noise_lacunarity=jnp.float32(noise_lacunarity),
        noise_freq=jnp.float32(noise_freq),
        noise_scale=jnp.float32(noise_scale),
        noise_height=jnp.float32(noise_height),
        noise_range=jnp.float32(noise_range),
        rcp_majorant=jnp.float32(1.0 / majorant),
        phase_dir_a=jnp.float32(np.clip(phase_dir_a, -0.99, 0.99)),
        phase_dir_b=jnp.float32(np.clip(phase_dir_b, -0.99, 0.99)),
        phase_blend=jnp.float32(np.clip(phase_blend, 0.0, 1.0)),
    )


def media_sample(desc: MediaDesc, p: V3):
    """Scattering/extinction at a point (ref Media_Sample :2146-2181).
    Returns (scattering V3, extinction V3)."""
    scattering = V3(
        jnp.broadcast_to(desc.constant_mu.x, p.x.shape),
        jnp.broadcast_to(desc.constant_mu.y, p.x.shape),
        jnp.broadcast_to(desc.constant_mu.z, p.x.shape),
    )
    in_band = jnp.abs(p.y - desc.noise_height) <= desc.noise_range
    noise = fbm_gradient_noise3(
        p * desc.noise_freq, desc.noise_lacunarity, desc.noise_gain,
        desc.noise_octaves,
    )
    height = desc.noise_height + desc.noise_scale * noise
    dist = jnp.abs(p.y - height) / jnp.maximum(desc.noise_scale, EPS)
    density = saturate(1.0 - dist) * in_band.astype(jnp.float32)
    scattering = scattering + desc.noise_mu * density
    extinction = scattering * (1.0 + desc.absorption)
    return scattering, extinction


def calc_phase(desc: MediaDesc, cos_theta):
    """Dual-lobe Mie phase blend (ref CalcPhase :2198-2206)."""
    return lerp(
        mie_phase(cos_theta, desc.phase_dir_a),
        mie_phase(cos_theta, desc.phase_dir_b),
        desc.phase_blend,
    )


def calc_transmittance(desc: MediaDesc, state, ro: V3, rd: V3, ray_len):
    """Ratio-tracked transmittance along a segment
    (ref CalcTransmittance :2223-2249).  Returns (state, V3)."""
    rcp_maj = desc.rcp_majorant

    def body(carry, _):
        state, t, atten, live = carry
        state, xi = rng.next_f32(state)
        dt = sample_free_path(xi, rcp_maj)
        live = live & ((t + dt) < ray_len)
        p = ro + rd * t
        scat, ext = media_sample(desc, p)
        ratio = V3(
            1.0 - ext.x * rcp_maj, 1.0 - ext.y * rcp_maj, 1.0 - ext.z * rcp_maj
        )
        m = live.astype(jnp.float32)
        atten = V3(
            atten.x * (1.0 + (ratio.x - 1.0) * m),
            atten.y * (1.0 + (ratio.y - 1.0) * m),
            atten.z * (1.0 + (ratio.z - 1.0) * m),
        )
        t = t + jnp.where(live, dt, 0.0)
        return (state, t, atten, live), None

    n = ro.x.shape
    init = (state, jnp.zeros(n), V3.ones(n), jnp.ones(n, bool))
    (state, _, atten, _), _ = jax.lax.scan(body, init, None, length=MEDIA_STEPS)
    return state, atten


class MediaScatter(NamedTuple):
    pos: V3
    dir: V3
    attenuation: V3
    luminance: V3
    pdf: jnp.ndarray      # 0 where no in-media scattering happened
    scattered: jnp.ndarray  # bool


def sample_phase_dir(desc: MediaDesc, state, rd: V3):
    """Rejection-sample a phase-function direction (ref SamplePhaseDir
    :2208-2221) with a fixed number of masked retries."""
    n = rd.x.shape

    def body(carry, _):
        state, best, best_ph, found = carry
        state, (u, v) = rng.next_f32x2(state)
        state, ur = rng.next_f32(state)
        l = sample_unit_sphere(u, v)
        from pim.math.vec3 import dot

        ph = calc_phase(desc, dot(rd, l))
        accept = (~found) & (ur <= ph)
        best = where3(accept, l, best)
        best_ph = jnp.where(accept, ph, best_ph)
        return (state, best, best_ph, found | accept), None

    init = (state, rd, jnp.ones(n), jnp.zeros(n, bool))
    (state, l, ph, found), _ = jax.lax.scan(body, init, None, length=PHASE_RETRIES)
    return state, l, ph


def scatter_ray(desc: MediaDesc, state, ro: V3, rd: V3, ray_len,
                evaluate_light=None):
    """Null-scattering march (ref ScatterRay :2251-2304).

    evaluate_light(state, p V3) -> (state, lum V3, dir V3, ok) supplies NEE
    from within the medium (ref EvaluateLight :1921-1942); None skips it.
    Returns (state, MediaScatter).
    """
    from pim.math.vec3 import dot

    rcp_maj = desc.rcp_majorant
    n = ro.x.shape

    def body(carry, _):
        state, t, atten, live, scattered, spos = carry
        state, xi = rng.next_f32(state)
        dt = sample_free_path(xi, rcp_maj)
        t_new = t + dt
        live = live & (t_new < ray_len)
        p = ro + rd * t_new
        scat, ext = media_sample(desc, p)
        m = live.astype(jnp.float32)
        atten = V3(
            atten.x * (1.0 + ((1.0 - ext.x * rcp_maj) - 1.0) * m),
            atten.y * (1.0 + ((1.0 - ext.y * rcp_maj) - 1.0) * m),
            atten.z * (1.0 + ((1.0 - ext.z * rcp_maj) - 1.0) * m),
        )
        scatter_prob = max3(scat) * rcp_maj
        state, us = rng.next_f32(state)
        does_scatter = live & (us < scatter_prob)
        spos = where3(does_scatter & ~scattered, p, spos)
        scattered = scattered | does_scatter
        live = live & ~does_scatter
        t = jnp.where(live, t_new, t)
        return (state, t, atten, live, scattered, spos), None

    init = (
        state, jnp.zeros(n), V3.ones(n), jnp.ones(n, bool),
        jnp.zeros(n, bool), ro,
    )
    (state, _, atten, _, scattered, spos), _ = jax.lax.scan(
        body, init, None, length=MEDIA_STEPS
    )

    # phase sampling + in-media NEE at the (first) scatter point
    state, new_dir, _ph_sample = sample_phase_dir(desc, state, rd)
    lum = V3.zeros(n)
    if evaluate_light is not None:
        state, li, ldir, ok = evaluate_light(state, spos)
        ph = calc_phase(desc, dot(rd, ldir))
        w = ok.astype(jnp.float32) * scattered.astype(jnp.float32) * ph
        lum = atten * li * w

    ph_out = calc_phase(desc, dot(rd, new_dir))
    atten_out = where3(scattered, atten * ph_out, atten)
    pdf = jnp.where(scattered, ph_out, 0.0)
    return state, MediaScatter(
        pos=spos,
        dir=where3(scattered, new_dir, rd),
        attenuation=atten_out,
        luminance=lum,
        pdf=pdf,
        scattered=scattered,
    )

"""Monte-Carlo sampling library — SoA jnp, batched over flat [N] lanes.

Counterpart of the reference's src/math/sampling.h.  2D random variables are
(u, v) tuples of [N] float32; directions are V3 (math/vec3.py).  File:line
cites point at the C formulas each function replicates; the code is an
independent SoA jnp design (see vec3.py for why SoA).
"""

from __future__ import annotations

import jax.numpy as jnp

from pim.math.vec3 import (
    EPS,
    EPS_SQ,
    PI,
    SQRT5_CONJ,
    TAU,
    V2,
    V3,
    dot,
    lerp,
    normalize,
    reflect,
    saturate,
)


def normal_to_tbn(n: V3):
    """Orthonormal basis from unit normal (Duff et al.; ref sampling.h:26-60).
    Returns (t, b)."""
    s = jnp.where(n.z < 0.0, -1.0, 1.0)
    a = -1.0 / (s + n.z)
    b = n.x * n.y * a
    t_vec = V3(1.0 + s * n.x * n.x * a, s * b, -s * n.x)
    b_vec = V3(b, s + n.y * n.y * a, -n.y)
    return t_vec, b_vec


def tbn_to_world(n: V3, v_ts: V3) -> V3:
    t, b = normal_to_tbn(n)
    return t * v_ts.x + b * v_ts.y + n * v_ts.z


def tan_to_world(normal_ws: V3, normal_ts: V3) -> V3:
    return tbn_to_world(normal_ws, normal_ts)


def radical_inverse_base2(bits):
    """Bit-reversed uint32 scaled to [0,1) (ref sampling.h:75-83)."""
    bits = bits.astype(jnp.uint32)
    bits = (bits << 16) | (bits >> 16)
    bits = ((bits & jnp.uint32(0x55555555)) << 1) | ((bits & jnp.uint32(0xAAAAAAAA)) >> 1)
    bits = ((bits & jnp.uint32(0x33333333)) << 2) | ((bits & jnp.uint32(0xCCCCCCCC)) >> 2)
    bits = ((bits & jnp.uint32(0x0F0F0F0F)) << 4) | ((bits & jnp.uint32(0xF0F0F0F0)) >> 4)
    bits = ((bits & jnp.uint32(0x00FF00FF)) << 8) | ((bits & jnp.uint32(0xFF00FF00)) >> 8)
    return bits.astype(jnp.float32) * jnp.float32(2.3283064365386963e-10)


def hammersley_2d(i, n):
    """Stratified 2D sequence (ref sampling.h:86-90). Returns (u, v)."""
    i = jnp.asarray(i)
    return (
        (i.astype(jnp.float32) + 0.5) / jnp.float32(n),
        radical_inverse_base2(i),
    )


def power_heuristic(f, g):
    """MIS power heuristic (ref sampling.h:93-96)."""
    return (f * f) / jnp.maximum(f * f + g * g, EPS)


def map_square_to_disk(u, v):
    """Concentric square->disk (ref sampling.h:100-118). Returns (x, y)."""
    u = lerp(EPS, 1.0 - EPS, u)
    v = lerp(EPS, 1.0 - EPS, v)
    a = 2.0 * u - 1.0
    b = 2.0 * v - 1.0
    use_a = (a * a) > (b * b)
    r = jnp.where(use_a, a, b)
    safe_a = jnp.where(jnp.abs(a) > 0, a, 1.0)
    safe_b = jnp.where(jnp.abs(b) > 0, b, 1.0)
    phi = jnp.where(
        use_a,
        (PI / 4.0) * (b / safe_a),
        (PI / 2.0) - (PI / 4.0) * (a / safe_b),
    )
    return r * jnp.cos(phi), r * jnp.sin(phi)


def sample_bary_coord(u, v):
    """Uniform barycentric sample (ref sampling.h:120-128).
    Returns (w, u, v) weights for vertices (A, B, C)."""
    r1 = jnp.sqrt(jnp.maximum(u, EPS_SQ))
    bu = r1 * (1.0 - v)
    bv = v * r1
    return 1.0 - (bu + bv), bu, bv


def sample_ngon(u, v, side, n, rot):
    """Uniform point in a regular N-gon fan triangle (ref sampling.h:130-139).
    Returns (x, y)."""
    side = side.astype(jnp.uint32) % jnp.uint32(n)
    r = TAU / jnp.float32(n)
    fs = side.astype(jnp.float32)
    a = rot + (1.0 + fs) * r
    b = rot + (2.0 + fs) * r
    _, wu, wv = sample_bary_coord(u, v)
    return (
        jnp.cos(a) * wu + jnp.cos(b) * wv,
        jnp.sin(a) * wu + jnp.sin(b) * wv,
    )


def sample_pentagram(u, v, side):
    """Uniform point in a pentagram star (ref sampling.h:141-156)."""
    r = TAU / 5.0
    s = PI * 0.1
    q = (1.0 - SQRT5_CONJ) * 0.5
    side = side.astype(jnp.uint32) % jnp.uint32(5)
    fs = side.astype(jnp.float32)
    a = s + (1.0 + fs) * r
    b = s + (1.5 + fs) * r
    c = s + (2.0 + fs) * r
    ax, ay = q * jnp.cos(a), q * jnp.sin(a)
    bx, by = jnp.cos(b), jnp.sin(b)
    cx, cy = q * jnp.cos(c), q * jnp.sin(c)
    # bilerp(A, B, 0, C, (u, v))
    return (
        ax * (1 - u) * (1 - v) + bx * u * (1 - v) + cx * u * v,
        ay * (1 - u) * (1 - v) + by * u * (1 - v) + cy * u * v,
    )


def spherical_to_cartesian(cos_theta, phi) -> V3:
    """(cosθ, φ) -> unit vector with N=+Z (ref sampling.h:158-165)."""
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 0.0))
    return V3(sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi), cos_theta)


def sample_unit_sphere(u, v) -> V3:
    """Uniform sphere (ref sampling.h:168-173)."""
    return spherical_to_cartesian(v * 2.0 - 1.0, TAU * u)


def sample_unit_hemisphere(u, v) -> V3:
    """Uniform hemisphere, N=+Z (ref sampling.h:176-181)."""
    return spherical_to_cartesian(v, TAU * u)


def sample_cosine_hemisphere(u, v) -> V3:
    """Cosine-weighted hemisphere, N=+Z (ref sampling.h:271-276)."""
    dx, dy = map_square_to_disk(u, v)
    z = jnp.sqrt(jnp.maximum(1.0 - (dx * dx + dy * dy), EPS_SQ))
    return V3(dx, dy, z)


def sample_ggx_microfacet(u, v, alpha) -> V3:
    """GGX NDF half-vector in tangent space (ref sampling.h:280-287)."""
    a2 = alpha * alpha
    phi = TAU * u
    b = jnp.maximum(1.0 + (a2 - 1.0) * v, EPS)
    cos_theta = jnp.sqrt(jnp.maximum((1.0 - v) / b, EPS_SQ))
    return spherical_to_cartesian(cos_theta, phi)


def importance_sample_ggx(i: V3, n: V3, u, v, alpha) -> V3:
    m = tan_to_world(n, sample_ggx_microfacet(u, v, alpha))
    return reflect(i, m)


def importance_sample_lambert(n: V3, u, v) -> V3:
    return tan_to_world(n, sample_cosine_hemisphere(u, v))


def lambert_pdf(nol):
    return nol * (1.0 / PI)


def ggx_pdf(noh, hov, alpha):
    """pdf of GGX-sampled reflection dir (ref sampling.h:311-315)."""
    from pim.math.brdf import d_gtr

    d = d_gtr(noh, alpha)
    return (d * noh) / jnp.maximum(4.0 * hov, EPS)


def light_pdf(area, cos_theta, dist_sq):
    """Solid-angle pdf of an area light sample (ref sampling.h:321-325)."""
    return dist_sq / jnp.maximum(cos_theta * area, EPS)


def sample_gauss_pixel_filter(u, v, stddev=1.0):
    """AA jitter (ref sampling.h:327-335 + the ref's Rayleigh-style
    'gauss_invcdf', scalar.h:299-302, replicated exactly). Returns (x, y)."""
    angle = u * TAU
    radius = stddev * jnp.sqrt(-jnp.log(jnp.maximum(1.0 - v, EPS)))
    return jnp.cos(angle) * radius, jnp.sin(angle) * radius


def sample_free_path(xi, mfp):
    """Exponential free-path sample (ref sampling.h:340-343)."""
    return -jnp.log(jnp.maximum(1.0 - xi, EPS)) * mfp


def mie_phase(cos_theta, g):
    """Mie phase fn (ref atmosphere.h:36-43)."""
    k = (3.0 / (8.0 * PI)) * (1.0 - g * g) / (2.0 + g * g)
    l = 1.0 + g * g - 2.0 * g * cos_theta
    l = l * jnp.sqrt(jnp.maximum(EPS_SQ, l))
    return k * (1.0 + cos_theta * cos_theta) / jnp.maximum(EPS, l)


def rayleigh_phase(cos_theta):
    """Rayleigh phase fn (ref atmosphere.h:31-34)."""
    return (3.0 / (16.0 * PI)) * (1.0 + cos_theta * cos_theta)


def hg_phase(cos_theta, g):
    """Henyey-Greenstein phase fn (ref atmosphere.h:48-55)."""
    g2 = g * g
    denom = 1.0 + g2 + 2.0 * g * cos_theta
    denom = denom * jnp.sqrt(jnp.maximum(EPS_SQ, denom))
    return (1.0 - g2) / jnp.maximum(4.0 * PI * denom, EPS)


def importance_sample_hg_phase(u, v, g) -> V3:
    """Sample an HG-phase scattering dir about +Z (ref atmosphere.h:57-77)."""
    g_safe = jnp.where(jnp.abs(g) > 1e-3, g, jnp.float32(1e-3))
    a = -1.0 / (2.0 * g_safe)
    b = 1.0 + g_safe * g_safe
    c = (1.0 - g_safe * g_safe) / jnp.maximum(1.0 + g_safe - 2.0 * g_safe * u, EPS)
    cos_aniso = jnp.clip(a * (b - c * c), -1.0, 1.0)
    cos_iso = u * 2.0 - 1.0
    cos_theta = jnp.where(jnp.abs(g) > 1e-3, cos_aniso, cos_iso)
    return spherical_to_cartesian(cos_theta, TAU * v)

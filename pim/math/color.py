"""Color science: luminance, sRGB, tonemapping, emission packing, spaces.

Counterpart of the reference's src/math/color.{c,h} + color_gen.h.  The
scene colorspace is Rec.709 linear (the reference's default build config,
COLOR_SCENE_REC709), so SDR<->scene conversions are identity; the Rec.2020 /
ACES matrices are provided for parity with the color_gen tables.
"""

from __future__ import annotations

import jax.numpy as jnp

from pim.math.vec import EPS, lerp, saturate

K_EMISSION_SCALE = jnp.float32(100.0)  # ref r_config.h:113


def avg_lum(c):
    """Mean of rgb — the reference's 'average luminance' (color.h:261-264)."""
    return (c[..., 0] + c[..., 1] + c[..., 2]) * jnp.float32(1.0 / 3.0)


def luminance_709(c):
    """True Rec.709 relative luminance."""
    return c[..., 0] * 0.2126 + c[..., 1] * 0.7152 + c[..., 2] * 0.0722


def pack_emission(emission):
    """HDR emission -> unorm byte scale (ref color.h:582-586)."""
    e = saturate(jnp.max(emission[..., :3], axis=-1) * (1.0 / K_EMISSION_SCALE))
    return jnp.sqrt(e)


def unpack_emission(albedo, e):
    """(albedo, rome.w) -> HDR emission (ref color.h:588-591)."""
    return albedo * ((e * e) * K_EMISSION_SCALE)[..., None]


# --- transfer functions ----------------------------------------------------


def srgb_oetf(linear):
    """Linear -> sRGB encode."""
    linear = jnp.maximum(linear, 0.0)
    lo = linear * 12.92
    hi = 1.055 * jnp.power(jnp.maximum(linear, 1e-7), 1.0 / 2.4) - 0.055
    return jnp.where(linear <= 0.0031308, lo, hi)


def srgb_eotf(encoded):
    """sRGB -> linear decode."""
    encoded = jnp.maximum(encoded, 0.0)
    lo = encoded / 12.92
    hi = jnp.power((encoded + 0.055) / 1.055, 2.4)
    return jnp.where(encoded <= 0.04045, lo, hi)


# --- GT tonemap (Gran Turismo; ref color.h:372-416) ------------------------

# defaults used by the reference screenshot path
GT_DEFAULTS = dict(P=1.0, a=1.0, m=0.22, l=0.4, c=1.33, b=0.0)


def gt_tonemap(x, P=1.0, a=1.0, m=0.22, l=0.4, c=1.33, b=0.0):
    """GT tonemap operator, elementwise over any shape."""
    x = jnp.maximum(x, 1e-7)
    l0 = ((P - m) * l) / a
    s0 = m + l0
    s1 = m + a * l0
    c2 = (a * P) / (P - s1)
    lin = m + a * (x - m)
    toe = m * jnp.power(x / m, c) + b
    shoulder = P - (P - s1) * jnp.exp(-(c2 * (x - s0)) / P)
    t = jnp.clip(x / jnp.float32(m), 0.0, 1.0)
    w0 = 1.0 - (t * t * (3.0 - 2.0 * t))  # smoothstep(0, m, x)
    w2 = jnp.where(x < s0, 0.0, 1.0)
    w1 = 1.0 - w0 - w2
    return toe * w0 + lin * w1 + shoulder * w2


def reinhard(x, wp=4.0):
    """Extended Reinhard with whitepoint (ref color.h tmap4_reinhard)."""
    n = x * (1.0 + x / (wp * wp))
    return n / (1.0 + x)


def aces_fitted(x):
    """Narkowicz ACES fit (ref color.h tmap4_aceskfit)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return saturate((x * (a * x + b)) / (x * (c * x + d) + e))


# --- colorspace matrices (ref color_gen.h) ---------------------------------

# Constants are spec parity with the autogenerated tables in
# src/math/color_gen.h:100-180 (columns there are c0/c1/c2 basis vectors;
# rows here), covering the full working-space set: Rec709/Rec2020 plus the
# ACES AP0 (2065-1) and AP1 (ACEScg) primaries.

M_REC709_TO_REC2020 = jnp.array(
    [
        [0.62740374, 0.32928297, 0.04331309],
        [0.06909731, 0.91954046, 0.01136230],
        [0.01639142, 0.08801328, 0.89559555],
    ],
    dtype=jnp.float32,
)
M_REC2020_TO_REC709 = jnp.array(
    [
        [1.66049135, -0.58764112, -0.07284993],
        [-0.12455052, 1.13289988, -0.00834937],
        [-0.01815073, -0.10057884, 1.11872911],
    ],
    dtype=jnp.float32,
)
M_REC709_TO_AP0 = jnp.array(
    [
        [0.44510370, 0.38536844, 0.18198957],
        [0.09173784, 0.83761758, 0.09955067],
        [0.01810628, 0.11489374, 0.89585471],
    ],
    dtype=jnp.float32,
)
M_AP0_TO_REC709 = jnp.array(
    [
        [2.48728561, -1.09167457, -0.38397157],
        [-0.27056241, 1.33109200, -0.09295224],
        [-0.01557129, -0.14864914, 1.13593400],
    ],
    dtype=jnp.float32,
)
M_REC709_TO_AP1 = jnp.array(
    [
        [0.62045252, 0.33653942, 0.04805727],
        [0.07202560, 0.94427723, 0.01386732],
        [0.02121311, 0.11278329, 0.89472198],
    ],
    dtype=jnp.float32,
)
M_AP1_TO_REC709 = jnp.array(
    [
        [1.68300891, -0.59011865, -0.08125103],
        [-0.12802380, 1.10586488, -0.01026359],
        [-0.02376486, -0.12540756, 1.12088573],
    ],
    dtype=jnp.float32,
)
M_REC2020_TO_AP0 = jnp.array(
    [
        [0.68778974, 0.15671833, 0.16795367],
        [0.04619727, 0.88501531, 0.09769358],
        [-0.00050517, 0.02941909, 0.99994063],
    ],
    dtype=jnp.float32,
)
M_AP0_TO_REC2020 = jnp.array(
    [
        [1.47076619, -0.25305325, -0.22231197],
        [-0.07710528, 1.14687216, -0.09909794],
        [0.00301148, -0.03386985, 1.00286269],
    ],
    dtype=jnp.float32,
)
M_REC2020_TO_AP1 = jnp.array(
    [
        [0.98746759, 0.01182853, 0.00575322],
        [0.00173593, 1.02605176, 0.00238259],
        [0.00493710, 0.02531640, 0.99846458],
    ],
    dtype=jnp.float32,
)
M_AP1_TO_REC2020 = jnp.array(
    [
        [1.01274061, -0.01153201, -0.00580782],
        [-0.00170165, 0.97468698, -0.00231617],
        [-0.00496459, -0.02465655, 1.00162518],
    ],
    dtype=jnp.float32,
)


def _apply(m, c):
    return jnp.einsum("ij,...j->...i", m, c, precision="highest")


def rec709_to_rec2020(c):
    return _apply(M_REC709_TO_REC2020, c)


def rec2020_to_rec709(c):
    return _apply(M_REC2020_TO_REC709, c)


def rec709_to_ap0(c):
    return _apply(M_REC709_TO_AP0, c)


def ap0_to_rec709(c):
    return _apply(M_AP0_TO_REC709, c)


def rec709_to_ap1(c):
    return _apply(M_REC709_TO_AP1, c)


def ap1_to_rec709(c):
    return _apply(M_AP1_TO_REC709, c)


def rec2020_to_ap0(c):
    return _apply(M_REC2020_TO_AP0, c)


def ap0_to_rec2020(c):
    return _apply(M_AP0_TO_REC2020, c)


def rec2020_to_ap1(c):
    return _apply(M_REC2020_TO_AP1, c)


def ap1_to_rec2020(c):
    return _apply(M_AP1_TO_REC2020, c)


# The scene working colorspace, as a config switch mirroring the
# reference's compile-time COLOR_SCENE_* (color.h:24-82; default Rec709).
SCENE_SPACE = "rec709"

_SDR_TO_SCENE = {
    "rec709": lambda c: c,
    "rec2020": rec709_to_rec2020,
    "ap0": rec709_to_ap0,
    "ap1": rec709_to_ap1,
}
_SCENE_TO_SDR = {
    "rec709": lambda c: c,
    "rec2020": rec2020_to_rec709,
    "ap0": ap0_to_rec709,
    "ap1": ap1_to_rec709,
}
_SCENE_TO_HDR = {
    "rec709": rec709_to_rec2020,
    "rec2020": lambda c: c,
    "ap0": ap0_to_rec2020,
    "ap1": ap1_to_rec2020,
}


def color_sdr_to_scene(c, space: str = None):
    """sRGB-primaries linear -> scene working space (ref Color_SDRToScene,
    color.h:28-41)."""
    return _SDR_TO_SCENE[space or SCENE_SPACE](c)


def color_scene_to_sdr(c, space: str = None):
    """Scene working space -> Rec709-primaries linear (ref Color_SceneToSDR,
    color.h:56-68)."""
    return _SCENE_TO_SDR[space or SCENE_SPACE](c)


def color_scene_to_hdr(c, space: str = None):
    """Scene working space -> Rec2020-primaries linear, the HDR10 signal
    space (ref Color_SceneToHDR, color.h:70-82)."""
    return _SCENE_TO_HDR[space or SCENE_SPACE](c)


# --- Rec.2100 HDR transfer functions (ref color.h:455-567, Color.hlsl) ------


def g_rec709(e):
    """Rec709 camera OETF scaled for the PQ OOTF (ref f1_GRec709,
    color.h:458-465): scene linear -> nonlinear signal."""
    e = jnp.maximum(e, 0.0)
    a = e * 267.84
    b = jnp.power(jnp.maximum(e * 59.5208, 1e-12), 0.45) * 1.099 - 0.099
    return jnp.where(e <= 0.0003024, a, b)


def g_rec1886(ep):
    """Rec1886 reference display EOTF (ref f1_GRec1886, color.h:476-486):
    nonlinear signal -> display linear light."""
    return jnp.power(jnp.maximum(ep, 0.0), 2.4) * 100.0


def pq_ootf(e):
    """Scene linear -> display luminance in [0, 10000] cd/m² (ref
    f1_PQ_OOTF, color.h:490-499)."""
    return g_rec1886(g_rec709(e))


# SMPTE ST.2084 constants (ref color.h:512-524)
_PQ_C1 = 0.8359375
_PQ_C2 = 18.8515625
_PQ_C3 = 18.6875
_PQ_M1 = 0.15930175781
_PQ_M2 = 78.84375


def pq_eotf(ep):
    """Nonlinear signal [0,1] -> display luminance [0,10000] cd/m² (ref
    f4_PQ_EOTF, color.h:512-524)."""
    t = jnp.power(jnp.maximum(ep, 0.0), 1.0 / _PQ_M2)
    y = jnp.maximum(t - _PQ_C1, 0.0) / (_PQ_C2 - t * _PQ_C3)
    return jnp.power(y, 1.0 / _PQ_M1) * 10000.0


def pq_inverse_eotf(fd):
    """Display luminance [0,10000] -> signal [0,1] (ref f4_PQ_InverseEOTF,
    color.h:537-550)."""
    y = jnp.power(jnp.maximum(fd, 0.0) * (1.0 / 10000.0), _PQ_M1)
    return jnp.power((y * _PQ_C2 + _PQ_C1) / (y * _PQ_C3 + 1.0), _PQ_M2)


def pq_oetf(e):
    """Scene linear -> PQ signal (ref f4_PQ_OETF, color.h:559-562)."""
    return pq_inverse_eotf(pq_ootf(e))


def pq_oetf_fit(e):
    """Rational fit of the PQ OETF (ref f4_PQ_OETF_Fit, color.h:564-583)."""
    b, c, d = 1.187727332, 3.204350948, 0.026951289
    ee, f, g, h = 0.006190614, 1.839250684, 2.521239042, 0.015978092
    e2 = e * e
    e3 = e2 * e
    return (b * e + c * e2 + d * e3) / (ee + f * e + g * e2 + h * e3)


def hlg_oetf(l):
    """Hybrid log-gamma: display luminance [0,1] -> signal [0,1] (ref
    HLG_OETF, src/shaders/Color.hlsl:264-272; Rec.2100)."""
    a = 0.17883277
    b = 1.0 - 4.0 * a
    c = 0.5 - a * jnp.log(4.0 * a)
    l = jnp.maximum(l, 0.0)
    lo = jnp.sqrt(3.0 * l)
    hi = a * jnp.log(jnp.maximum(12.0 * l - b, 1e-12)) + c
    return jnp.where(l <= 1.0 / 12.0, lo, hi)


def hlg_ootf(s, peak_nits=1000.0):
    """HLG system gamma: scene luminance -> display luminance at a given
    peak (ref HLG_OOTF, src/shaders/Color.hlsl:286-293)."""
    ys = (s[..., 0] * 0.2627 + s[..., 1] * 0.6780 + s[..., 2] * 0.0593)
    g = 1.2 + 0.42 * jnp.log10(peak_nits / 1000.0)
    return peak_nits * jnp.power(jnp.maximum(ys, EPS), g - 1.0)[..., None] * s


# --- dithering (screenshot path; ref render_system.c:697-729) --------------


def dither_u8(x, noise):
    """x in [0,1], noise in [0,1): triangular-ish dither then quantize to u8."""
    q = x * 255.0 + (noise - 0.5)
    return jnp.clip(jnp.round(q), 0.0, 255.0).astype(jnp.uint8)

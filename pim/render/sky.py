"""Physically-based sky: Rayleigh/Mie single scattering + sky cubemap.

Counterpart of src/math/atmosphere.{c,h} (the raymarcher) and the sky bake
(BakeSkyFn, src/rendering/render_system.c:403-425).  The reference's
unbounded while-march becomes a fixed-iteration masked `lax.scan` (XLA
needs static trip counts); march step and termination thresholds match the
C (median free path of the majorant, 1e-5 density cutoff).

Differentiability: radiance is smooth in sun direction/luminance and the
scattering coefficients — this is the BASELINE.json 'sun params' gradient
surface.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from pim.math.sampling import mie_phase, rayleigh_phase
from pim.math.vec import EPS, dot, normalize

# fixed trip counts for the masked marches
VIEW_STEPS = 224
SUN_STEPS = 96


class SkyMedium(NamedTuple):
    """Atmosphere parameters (ref SkyMedium + kEarthAtmosphere,
    atmosphere.c:3-19)."""

    r_crust: jnp.ndarray   # planet radius, m
    r_atmos: jnp.ndarray   # (unused by the march; kept for parity)
    mu_r: jnp.ndarray      # [3] rayleigh scattering coeff
    rho_r: jnp.ndarray     # 1 / rayleigh scale height
    mu_m: jnp.ndarray      # mie scattering coeff
    rho_m: jnp.ndarray     # 1 / mie scale height
    g_m: jnp.ndarray       # mie anisotropy


def earth_atmosphere() -> SkyMedium:
    return SkyMedium(
        r_crust=jnp.float32(6360e3),
        r_atmos=jnp.float32(60.0),
        mu_r=jnp.asarray([1.0 / 192428.0, 1.0 / 82354.0, 1.0 / 33732.0], jnp.float32),
        rho_r=jnp.float32(1.0 / 8500.0),
        mu_m=jnp.float32(1.0 / 47619.0),
        rho_m=jnp.float32(1.0 / 1200.0),
        g_m=jnp.float32(0.758),
    )


def atmosphere_from_cvars() -> SkyMedium:
    from pim.core import cvars as cv

    rlh = cv.cv_sky_rlh_mfp.get()
    return SkyMedium(
        r_crust=jnp.float32(cv.cv_sky_rad_cr.get() * 1e3),
        r_atmos=jnp.float32(cv.cv_sky_rad_at.get()),
        mu_r=jnp.asarray([1e-3 / max(v, 1e-3) for v in rlh[:3]], jnp.float32),
        rho_r=jnp.float32(1e-3 / cv.cv_sky_rlh_sh.get()),
        mu_m=jnp.float32(1e-3 / cv.cv_sky_mie_mfp.get()),
        rho_m=jnp.float32(1e-3 / cv.cv_sky_mie_sh.get()),
        g_m=jnp.float32(cv.cv_sky_mie_g.get()),
    )


def atmosphere(sky: SkyMedium, ro, rd, light_dir, luminance, steps: int):
    """Single-scatter march (ref Atmosphere, atmosphere.h:79-182).

    ro/rd [..., 3] with planet center at origin; returns [..., 3].
    """
    majorant = jnp.maximum(sky.mu_m, jnp.max(sky.mu_r)) * steps
    # bias: median free path instead of random sampling (ref :96-98)
    mfp = -jnp.log(jnp.float32(0.5)) / majorant
    k_min_density = 1e-5

    def density(p):
        h = jnp.sqrt(jnp.maximum(jnp.sum(p * p, -1), EPS)) - sky.r_crust
        # below-crust lanes (h << 0) are masked out of the march, but an
        # unclamped exp overflows to inf there and reverse-mode then forms
        # 0 * inf = NaN through the where mask, poisoning sun_dir grads;
        # clip the exponent (densities are <= 1 above the crust anyway)
        dr = jnp.exp(jnp.minimum(-h * sky.rho_r, 0.0))
        dm = jnp.exp(jnp.minimum(-h * sky.rho_m, 0.0))
        return h, dr, dm

    def sun_march(pos_v):
        """Optical depth along light_dir from pos_v; masked fixed march."""

        def body(carry, _):
            t_l, od_r, od_m, live, hit_crust = carry
            p = pos_v + light_dir * t_l[..., None]
            h, dr, dm = density(p)
            crust = h < 0.0
            done = (dr + dm) < k_min_density
            step_live = live & ~crust & ~done
            od_r = od_r + jnp.where(step_live, dr * mfp, 0.0)
            od_m = od_m + jnp.where(step_live, dm * mfp, 0.0)
            hit_crust = hit_crust | (live & crust)
            live = step_live
            return (t_l + mfp, od_r, od_m, live, hit_crust), None

        shape = pos_v.shape[:-1]
        init = (
            jnp.zeros(shape), jnp.zeros(shape), jnp.zeros(shape),
            jnp.ones(shape, bool), jnp.zeros(shape, bool),
        )
        (t_l, od_r, od_m, live, hit_crust), _ = jax.lax.scan(
            body, init, None, length=SUN_STEPS
        )
        return od_r, od_m, hit_crust

    def body(carry, _):
        t_v, od_r_v, od_m_v, tr_r, tr_m, live = carry
        p = ro + rd * t_v[..., None]
        h, dr, dm = density(p)
        live = live & (h >= 0.0) & ((dr + dm) >= k_min_density)
        od_r_i = dr * mfp
        od_m_i = dm * mfp
        od_r_v = od_r_v + jnp.where(live, od_r_i, 0.0)
        od_m_v = od_m_v + jnp.where(live, od_m_i, 0.0)

        od_r_l, od_m_l, hit_crust = sun_march(p)
        od = (
            sky.mu_r * (od_r_v + od_r_l)[..., None]
            + sky.mu_m * (od_m_v + od_m_l)[..., None]
        )
        tr_i = jnp.exp(-od)
        m = (live & ~hit_crust).astype(jnp.float32)
        tr_r = tr_r + tr_i * (od_r_i * m)[..., None]
        tr_m = tr_m + tr_i * (od_m_i * m)[..., None]
        return (t_v + mfp, od_r_v, od_m_v, tr_r, tr_m, live), None

    shape = jnp.broadcast_shapes(ro.shape[:-1], rd.shape[:-1])
    ro = jnp.broadcast_to(ro, shape + (3,))
    rd = jnp.broadcast_to(rd, shape + (3,))
    init = (
        jnp.zeros(shape), jnp.zeros(shape), jnp.zeros(shape),
        jnp.zeros(shape + (3,)), jnp.zeros(shape + (3,)),
        jnp.ones(shape, bool),
    )
    (t_v, _, _, tr_r, tr_m, live), _ = jax.lax.scan(body, init, None, length=steps_to_trips(steps))

    cos_theta = dot(rd, light_dir)
    ph_r = rayleigh_phase(cos_theta)
    ph_m = mie_phase(cos_theta, sky.g_m)
    out = tr_r * sky.mu_r * ph_r[..., None] + tr_m * (sky.mu_m * ph_m)[..., None]
    return out * luminance


def steps_to_trips(steps: int) -> int:
    """The ref march runs until density cutoff; higher `steps` (cvar
    r_sun_steps) shrinks the step length by the same factor, so the trip
    count needed scales with it."""
    return min(VIEW_STEPS * max(steps, 1) // 4, 1024)


def earth_sky(ro, rd, light_dir, luminance, steps: int, sky: SkyMedium = None):
    """EarthAtmosphere wrapper (ref atmosphere.h:184-201): origin at north
    pole surface."""
    if sky is None:
        sky = earth_atmosphere()
    ro = ro + jnp.asarray([0.0, 1.0, 0.0]) * sky.r_crust
    return atmosphere(sky, ro, rd, light_dir, luminance, steps)


# ---------------------------------------------------------------------------
# Sky cubemap bake + sampling (ref BakeSkyFn + Cubemap_CalcUv/ReadColor)
# ---------------------------------------------------------------------------

# face conventions (ref cubemap.c:14-42)
_FORWARDS = np.array(
    [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]], np.float32
)
_UPS = np.array(
    [[0, 1, 0], [0, 1, 0], [0, 0, -1], [0, 0, -1], [0, 1, 0], [0, 1, 0]], np.float32
)
_RIGHTS = np.array(
    [[0, 0, -1], [0, 0, 1], [1, 0, 0], [-1, 0, 0], [1, 0, 0], [-1, 0, 0]], np.float32
)


def cubemap_dirs(size: int) -> jnp.ndarray:
    """Per-texel unit directions [6, size, size, 3] (ref Cubemap_CalcDir)."""
    ts = (np.arange(size, dtype=np.float32) + 0.5) / size * 2.0 - 1.0
    u, v = np.meshgrid(ts, ts, indexing="xy")  # [S, S]
    dirs = (
        _FORWARDS[:, None, None, :]
        + _RIGHTS[:, None, None, :] * u[None, ..., None]
        + _UPS[:, None, None, :] * v[None, ..., None]
    )
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    return jnp.asarray(dirs)


def bake_sky_cubemap(sky: SkyMedium, sun_dir, sun_lum, size: int, steps: int):
    """[6, size, size, 3] radiance cubemap (ref BakeSkyFn: ro at crust)."""
    dirs = cubemap_dirs(size).reshape(-1, 3)
    ro = jnp.asarray([0.0, 1.0, 0.0]) * sky.r_crust
    sun_dir = normalize(jnp.asarray(sun_dir, jnp.float32))
    lum = jnp.asarray(sun_lum, jnp.float32)
    out = atmosphere(sky, ro[None, :], dirs, sun_dir, lum, steps)
    return out.reshape(6, size, size, 3)


def sample_sky_cubemap_soa(cube: jnp.ndarray, rd):
    """SoA wrapper: V3 dirs -> V3 radiance (per-channel gathers, no [N, 3]
    intermediates beyond the 4 corner fetch rounds)."""
    from pim.math.vec3 import V3

    size = cube.shape[1]
    ax = jnp.abs(rd.x)
    ay = jnp.abs(rd.y)
    az = jnp.abs(rd.z)
    vmax = jnp.maximum(ax, jnp.maximum(ay, az))
    ma = 0.5 / jnp.maximum(vmax, EPS)
    is_x = vmax == ax
    is_y = (~is_x) & (vmax == ay)
    face = jnp.where(
        is_x,
        jnp.where(rd.x < 0, 1, 0),
        jnp.where(is_y, jnp.where(rd.y < 0, 3, 2), jnp.where(rd.z < 0, 5, 4)),
    )
    # face-basis components as arithmetic selects, not per-lane table
    # gathers (`_RIGHTS[face, c]` would be six full-wavefront gathers).
    # The bases are sparse ±1 patterns (see _RIGHTS/_UPS):
    #   right = [0,0,-1],[0,0,1],[1,0,0],[-1,0,0],[1,0,0],[-1,0,0]
    #   up    = [0,1,0],[0,1,0],[0,0,-1],[0,0,-1],[0,1,0],[0,1,0]
    f = face
    one = jnp.float32(1.0)
    odd = (f & 1) == 1
    rx = jnp.where(f < 2, 0.0, jnp.where(odd, -one, one))
    rz = jnp.where(f == 0, -one, jnp.where(f == 1, one, 0.0))
    is_y_face = (f == 2) | (f == 3)
    uy = jnp.where(is_y_face, 0.0, one)
    uz = jnp.where(is_y_face, -one, 0.0)
    u = (rx * rd.x + rz * rd.z) * ma + 0.5
    v = (uy * rd.y + uz * rd.z) * ma + 0.5

    fx = jnp.clip(u, 0.0, 1.0) * (size - 1)
    fy = jnp.clip(v, 0.0, 1.0) * (size - 1)
    x0 = jnp.floor(fx).astype(jnp.int32)
    y0 = jnp.floor(fy).astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, size - 1)
    y1 = jnp.minimum(y0 + 1, size - 1)
    tx = fx - x0.astype(jnp.float32)
    ty = fy - y0.astype(jnp.float32)
    base = face * size * size
    i00 = base + y0 * size + x0
    i10 = base + y0 * size + x1
    i01 = base + y1 * size + x0
    i11 = base + y1 * size + x1

    planes = cube.reshape(-1, 3).T  # [3, 6*S*S], hoisted out of the scan
    out = []
    for ch in range(3):
        plane = planes[ch]
        t00 = plane[i00]
        t10 = plane[i10]
        t01 = plane[i01]
        t11 = plane[i11]
        top = t00 + (t10 - t00) * tx
        bot = t01 + (t11 - t01) * tx
        out.append(top + (bot - top) * ty)
    return V3(out[0], out[1], out[2])


def sample_sky_cubemap(cube: jnp.ndarray, dirs: jnp.ndarray) -> jnp.ndarray:
    """Bilinear-clamp cubemap fetch (ref Cubemap_CalcUv :71-100 +
    UvBilinearClamp).  cube [6, S, S, 3], dirs [..., 3] -> [..., 3]."""
    size = cube.shape[1]
    absd = jnp.abs(dirs)
    vmax = jnp.max(absd, axis=-1)
    ma = 0.5 / jnp.maximum(vmax, EPS)

    is_x = vmax == absd[..., 0]
    is_y = (~is_x) & (vmax == absd[..., 1])
    face = jnp.where(
        is_x,
        jnp.where(dirs[..., 0] < 0, 1, 0),
        jnp.where(
            is_y,
            jnp.where(dirs[..., 1] < 0, 3, 2),
            jnp.where(dirs[..., 2] < 0, 5, 4),
        ),
    )
    rights = jnp.asarray(_RIGHTS)[face]
    ups = jnp.asarray(_UPS)[face]
    u = jnp.sum(rights * dirs, -1) * ma + 0.5
    v = jnp.sum(ups * dirs, -1) * ma + 0.5

    fx = jnp.clip(u, 0.0, 1.0) * (size - 1)
    fy = jnp.clip(v, 0.0, 1.0) * (size - 1)
    x0 = jnp.floor(fx).astype(jnp.int32)
    y0 = jnp.floor(fy).astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, size - 1)
    y1 = jnp.minimum(y0 + 1, size - 1)
    tx = (fx - x0.astype(jnp.float32))[..., None]
    ty = (fy - y0.astype(jnp.float32))[..., None]
    flat = cube.reshape(-1, 3)
    base = face * size * size
    taa = flat[base + y0 * size + x0]
    tba = flat[base + y0 * size + x1]
    tab = flat[base + y1 * size + x0]
    tbb = flat[base + y1 * size + x1]
    top = taa + (tba - taa) * tx
    bot = tab + (tbb - tab) * tx
    return top + (bot - top) * ty

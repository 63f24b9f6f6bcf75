"""Gradient noise + fBm for heterogeneous media density (SoA).

Counterpart of src/math/noise.h: hash-gradient lattice noise with
smoothstep interpolation, octave-summed (FbmGradientNoise3) — feeds the
null-scattering media sampler (ref Media_Sample, path_tracer.c:2146-2181).
"""

from __future__ import annotations

import jax.numpy as jnp

from pim.math.vec3 import V3, lerp


def _pcg4_x(x, y, z, w):
    """First component of Pcg4 (ref pcg.h:126-176)."""
    m = jnp.uint32(1664525)
    a = jnp.uint32(1013904223)
    x = x * m + a
    y = y * m + a
    z = z * m + a
    w = w * m + a
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = x + y * w
    return x


def _gradient_cell(ix, iy, iz, seed):
    """Signed unit-corner gradient from the cell hash (ref noise.h:16-25).
    Returns (gx, gy, gz)."""
    i = _pcg4_x(
        ix.astype(jnp.uint32), iy.astype(jnp.uint32), iz.astype(jnp.uint32),
        jnp.uint32(seed) if not hasattr(seed, "dtype") else seed.astype(jnp.uint32),
    )
    gx = jnp.where(i & jnp.uint32(1 << 31), 1.0, -1.0)
    gy = jnp.where(i & jnp.uint32(1 << 30), 1.0, -1.0)
    gz = jnp.where(i & jnp.uint32(1 << 29), 1.0, -1.0)
    return gx, gy, gz


def gradient_noise3(p: V3, seed) -> jnp.ndarray:
    """Lattice gradient noise (ref GradientNoise3, noise.h:27-70)."""
    fx = jnp.floor(p.x)
    fy = jnp.floor(p.y)
    fz = jnp.floor(p.z)
    ix = fx.astype(jnp.int32)
    iy = fy.astype(jnp.int32)
    iz = fz.astype(jnp.int32)
    rx = p.x - fx
    ry = p.y - fy
    rz = p.z - fz

    def corner(ox, oy, oz):
        gx, gy, gz = _gradient_cell(ix + ox, iy + oy, iz + oz, seed)
        return gx * (rx - ox) + gy * (ry - oy) + gz * (rz - oz)

    c000 = corner(0, 0, 0)
    c001 = corner(0, 0, 1)
    c010 = corner(0, 1, 0)
    c011 = corner(0, 1, 1)
    c100 = corner(1, 0, 0)
    c101 = corner(1, 0, 1)
    c110 = corner(1, 1, 0)
    c111 = corner(1, 1, 1)

    # f4_unormstep = smoothstep(0, 1, f)
    def ss(t):
        return t * t * (3.0 - 2.0 * t)

    ux, uy, uz = ss(rx), ss(ry), ss(rz)
    c00 = lerp(c000, c001, uz)
    c01 = lerp(c010, c011, uz)
    c10 = lerp(c100, c101, uz)
    c11 = lerp(c110, c111, uz)
    c0 = lerp(c00, c01, uy)
    c1 = lerp(c10, c11, uy)
    return lerp(c0, c1, ux)


def fbm_gradient_noise3(p: V3, lacunarity, gain, octaves: int, seed: int = 1):
    """Octave-summed gradient noise (ref FbmGradientNoise3, noise.h:72-84).
    `octaves` must be a static int (unrolled)."""
    total = jnp.zeros_like(p.x)
    freq = 1.0
    ampl = 1.0
    for i in range(octaves):
        total = total + gradient_noise3(p * freq, seed + i + 1) * ampl
        freq = freq * lacunarity
        ampl = ampl * gain
    return total


def interleaved_gradient_noise(x, y):
    """Screen-space dither noise (ref noise.h:11-14)."""
    v = x * 0.06711056 + y * 0.00583715
    return jnp.mod(jnp.mod(v, 1.0) * 52.9829189, 1.0)

"""Surface interaction: fused attribute fetch + hit-point shading state (SoA).

Counterpart of GetSurface / GetNormal / GetUV / SampleAlbedo / SampleRome
(ref: src/rendering/path_tracer.c:1180-1419) and the CPU bilinear sampler
(src/rendering/sampler.h:176-249).

All per-hit attributes come from ONE fetch against the fused [48, T]
triangle table (render/fetch.py); the result is an [F, N] block whose rows
are [N] arrays.  Atlas sampling is per-channel against flat planes and only
exists in the compiled program when the scene has real textures.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from pim.geom.material import MatFlag
from pim.math.color import K_EMISSION_SCALE
from pim.math.sampling import tan_to_world
from pim.math.vec3 import (
    MILLI,
    V2,
    V3,
    dot,
    normalize,
    reflect,
    where3,
)
from pim.render import fetch as F


class Surface(NamedTuple):
    """Per-lane surface description (ref PtSurfHit, path_tracer.c:58-72)."""

    p: V3
    m: V3          # macro (geometric-interp) normal
    n: V3          # micro (shading) normal
    albedo: V3
    emission: V3
    roughness: jnp.ndarray
    occlusion: jnp.ndarray
    metallic: jnp.ndarray
    ior: jnp.ndarray
    flags: jnp.ndarray   # i32
    backface: jnp.ndarray


def fix_shading_normal(m: V3, n: V3) -> V3:
    """Reflect shading normals that dip below the geometric hemisphere
    (ref FixShadingNormal :1354-1361)."""
    below = dot(m, n) <= 0.0
    return where3(below, reflect(n, m), n)


def _gather_corners(plane, idx4):
    """plane [M] f32, idx4 [4, N] i32 -> [4, N]: the four bilinear corner
    texels of one channel in ONE lax.gather.

    Pinned with optimization_barriers so the gather stays a standalone op
    instead of fusing with its consumers inside the bounce scan (whether
    the pin still pays on the GPU is not measured yet)."""
    plane, idx4 = jax.lax.optimization_barrier((plane, idx4))
    out = plane[idx4]
    return jax.lax.optimization_barrier(out)


def _bilinear_setup(rec_t, tex_id, uv: V2):
    """Corner indices + lerp weights for one texture-id set.
    Returns (idx4 [4, N] i32, tx, ty)."""
    rec = F.fetch_cols(rec_t, jnp.maximum(tex_id, 0)).astype(jnp.int32)  # [5, N]
    x0 = rec[0]
    y0 = rec[1]
    w = rec[2]
    h = rec[3]
    stride = rec[4]  # atlas width replicated per record

    def wrap(u):
        # NOT a true modular wrap: negative uvs are mirrored before frac,
        # deliberately matching the reference's LinearWrap exactly
        # (sampler.h:185-190: `u = (u >= 0) ? u : 1 - u; u = frac(u)`),
        # so e1m1-class assets with negative uvs sample identically.
        u = jnp.where(u >= 0.0, u, 1.0 - u)
        return u - jnp.floor(u)

    fx = wrap(uv.x) * jnp.maximum(w - 1, 0).astype(jnp.float32)
    fy = wrap(uv.y) * jnp.maximum(h - 1, 0).astype(jnp.float32)
    ax = jnp.floor(fx)
    ay = jnp.floor(fy)
    tx = fx - ax
    ty = fy - ay
    ax = ax.astype(jnp.int32)
    ay = ay.astype(jnp.int32)
    bx = jnp.minimum(ax + 1, w - 1)
    by = jnp.minimum(ay + 1, h - 1)

    i00 = (y0 + ay) * stride + x0 + ax
    i10 = (y0 + ay) * stride + x0 + bx
    i01 = (y0 + by) * stride + x0 + ax
    i11 = (y0 + by) * stride + x0 + bx
    return jnp.stack([i00, i10, i01, i11], axis=0), tx, ty


def _bilinear_out(corners, tx, ty, missing, default):
    """corners: 4 arrays [N] per channel -> lerped channels with default."""
    out = []
    for c in range(4):
        t00, t10, t01, t11 = corners[c]
        top = t00 + (t10 - t00) * tx
        bot = t01 + (t11 - t01) * tx
        val = top + (bot - top) * ty
        out.append(jnp.where(missing, jnp.float32(default[c]), val))
    return out


def sample_atlas_bilinear_multi(atlas_planes, rec_t, fetches):
    """Bilinear-wrap fetch of SEVERAL texture-id sets against the same
    atlas: one barrier-pinned [4, N] corner gather per channel and fetch.

    fetches: list of (tex_id [N] i32, uv V2, default 4-tuple).  Returns a
    list of 4-channel-array lists, one per fetch."""
    outs = []
    for tex_id, uv, default in fetches:
        idx4, tx, ty = _bilinear_setup(rec_t, tex_id, uv)
        corners = [_gather_corners(atlas_planes[c], idx4) for c in range(4)]
        outs.append(_bilinear_out(corners, tx, ty, tex_id < 0, default))
    return outs


def sample_atlas_bilinear(atlas_planes, rec_t, tex_id, uv: V2, default):
    """Bilinear-wrap fetch; atlas_planes [4, H*W] flat channel planes,
    rec_t [5, Ntex] transposed records (x0, y0, w, h, stride), uv V2 of [N].
    Returns 4 channel arrays [N].  tex_id < 0 -> default (tuple of 4)."""
    return sample_atlas_bilinear_multi(
        atlas_planes, rec_t, [(tex_id, uv, default)])[0]


class HitAttribs(NamedTuple):
    """Everything the shading path needs about a hit, from one fused fetch."""

    rows: jnp.ndarray    # [48, N] raw table block
    p: V3                # interpolated position
    m: V3                # interpolated macro normal (side-fixed)
    uv: V2
    flags: jnp.ndarray   # i32
    albedo: V3
    rome: tuple          # 4 channel arrays [N]
    emission: V3
    nm: tuple = None     # (x, y) sampled normal-map channels, or None


def sampled_rows(meta) -> int:
    """Rows of the packed per-hit sampled-texture block (pack_sampled)."""
    if not (meta.textured or meta.has_normal_maps):
        return 0
    return 7 + (2 if meta.has_normal_maps else 0)


def pack_sampled(meta, at: HitAttribs) -> jnp.ndarray:
    """Pack the atlas-sampled shading channels of a HitAttribs into one
    [S, N] f32 block so the integrator can CARRY them across the bounce
    scan instead of re-sampling the atlas for the same hit.
    Layout: albedo rgb, rome x4 [, nm x/y]."""
    parts = [at.albedo.x, at.albedo.y, at.albedo.z, *at.rome]
    if meta.has_normal_maps:
        parts += [at.nm[0], at.nm[1]]
    return jnp.stack(parts, axis=0)


def fetch_hit_attribs(meta, arrays, hit) -> HitAttribs:
    """Fused fetch + interpolation for a Hit batch."""
    tri = jnp.maximum(hit.tri, 0)
    rows = F.fetch_cols(arrays.tri_table, tri)  # [48, N]
    return attribs_from_rows(meta, arrays, rows, hit)


def attribs_from_rows(meta, arrays, rows, hit, sampled=None) -> HitAttribs:
    """Interpolation/shading-state build from an already-fetched [48, N]
    attribute block (the integrator carries `rows` across scan iterations
    to avoid re-gathering the same hit).

    sampled: a pack_sampled block carried with `rows` — when given, the
    atlas is NOT touched; albedo/rome/normal-map channels are unpacked
    from it (bit-identical values: they were sampled from the same hit
    at the end of the previous bounce).

    Macro normal = barycentric vertex-normal blend, flipped to the side of
    the geometric normal (ref GetNormal :1192-1204)."""
    w = 1.0 - hit.u - hit.v
    u = hit.u
    v = hit.v
    pa = F.v3_rows(rows, F.PA)
    pb = F.v3_rows(rows, F.PB)
    pc = F.v3_rows(rows, F.PC)
    p = pa * w + pb * u + pc * v
    na = F.v3_rows(rows, F.NA)
    nb = F.v3_rows(rows, F.NB)
    nc = F.v3_rows(rows, F.NC)
    n = na * w + nb * u + nc * v
    flip = dot(hit.ng, n) <= 0.0
    m = normalize(where3(flip, -n, n))
    uv = V2(
        rows[F.UVA.start] * w + rows[F.UVB.start] * u + rows[F.UVC.start] * v,
        rows[F.UVA.start + 1] * w + rows[F.UVB.start + 1] * u + rows[F.UVC.start + 1] * v,
    )
    flags = rows[F.FLAGS].astype(jnp.int32)

    nm = None
    if sampled is not None and sampled_rows(meta) > 0:
        albedo4 = [sampled[0], sampled[1], sampled[2], None]
        rome = [sampled[3 + c] for c in range(4)]
        if meta.has_normal_maps:
            nm = (sampled[7], sampled[8])
    else:
        albedo4 = [rows[F.ALBEDO.start + c] for c in range(4)]
        rome = [rows[F.ROME.start + c] for c in range(4)]
        fetches = []
        if meta.textured:
            a_tex = rows[F.ALBEDO_TEX].astype(jnp.int32)
            r_tex = rows[F.ROME_TEX].astype(jnp.int32)
            fetches += [(a_tex, uv, (0, 0, 0, 0)), (r_tex, uv, (0, 0, 0, 0))]
        if meta.has_normal_maps:
            nm_tex = rows[F.NORMAL_TEX].astype(jnp.int32)
            fetches.append((nm_tex, uv, (0.0, 0.0, 1.0, 0.0)))
        if fetches:
            # albedo + rome + normal map of this hit; get_surface
            # consumes `nm`
            smps = sample_atlas_bilinear_multi(
                arrays.atlas_planes, arrays.tex_rec_t, fetches)
            if meta.textured:
                a_smp, r_smp = smps[0], smps[1]
                albedo4 = [
                    jnp.where(a_tex >= 0, a_smp[c], albedo4[c]) for c in range(4)
                ]
                rome = [jnp.where(r_tex >= 0, r_smp[c], rome[c]) for c in range(4)]
            if meta.has_normal_maps:
                nm4 = smps[-1]
                nm = (nm4[0], nm4[1])

    albedo = V3(albedo4[0], albedo4[1], albedo4[2])
    # UnpackEmission (ref color.h:588-591)
    e = rome[3]
    emission = albedo * (e * e * K_EMISSION_SCALE)
    return HitAttribs(
        rows=rows, p=p, m=m, uv=uv, flags=flags,
        albedo=albedo, rome=tuple(rome), emission=emission, nm=nm,
    )


def _apply_sky(meta, arrays, rd: V3, is_sky, albedo: V3, emission: V3, m: V3,
               sky_col: V3 = None):
    if sky_col is None:
        if meta.has_sky:
            from pim.render.sky import sample_sky_cubemap_soa

            sky_col = sample_sky_cubemap_soa(arrays.sky, rd)
        else:
            sky_col = V3.zeros(is_sky.shape)
    zero = V3.zeros(is_sky.shape)
    albedo = where3(is_sky, zero, albedo)
    emission = where3(is_sky, sky_col, emission)
    m = where3(is_sky, -rd, m)
    return albedo, emission, m


def get_surface(meta, arrays, ro: V3, rd: V3, hit, attribs: HitAttribs = None,
                sky_col: V3 = None) -> Surface:
    """Full surface fetch (ref GetSurface :1377-1419).

    sky_col: optionally a precomputed sky radiance for `rd` (the caller
    usually already sampled it for the miss path — one cubemap gather
    instead of two per bounce)."""
    at = attribs if attribs is not None else fetch_hit_attribs(meta, arrays, hit)
    p = at.p + at.m * (0.01 * MILLI)

    n = at.m
    if meta.has_normal_maps:
        nm_tex = at.rows[F.NORMAL_TEX].astype(jnp.int32)
        nm = at.nm
        if nm is None:
            nm = sample_atlas_bilinear_multi(
                arrays.atlas_planes, arrays.tex_rec_t,
                [(nm_tex, at.uv, (0.0, 0.0, 1.0, 0.0))])[0]
        nz = jnp.sqrt(jnp.maximum(1.0 - (nm[0] * nm[0] + nm[1] * nm[1]), 1e-6))
        n_ts = V3(nm[0], nm[1], nz)
        n_mapped = fix_shading_normal(at.m, tan_to_world(at.m, n_ts))
        n = where3(nm_tex >= 0, n_mapped, n)

    is_sky = (at.flags & int(MatFlag.SKY)) != 0
    albedo, emission, m = _apply_sky(meta, arrays, rd, is_sky, at.albedo,
                                     at.emission, at.m, sky_col=sky_col)
    n = where3(is_sky, -rd, n)

    return Surface(
        p=p,
        m=m,
        n=n,
        albedo=albedo,
        emission=emission,
        roughness=jnp.where(is_sky, 1.0, at.rome[0]),
        occlusion=jnp.where(is_sky, 0.0, at.rome[1]),
        metallic=jnp.where(is_sky, 0.0, at.rome[2]),
        ior=jnp.where(is_sky, 1.0, at.rows[F.IOR]),
        flags=at.flags,
        backface=hit.backface,
    )


def get_emission_from_attribs(meta, arrays, rd: V3, at: HitAttribs,
                              sky_col: V3 = None) -> V3:
    """Emission-only view of a fetched hit (ref GetEmission :1293-1326).

    sky_col: optionally a precomputed sky radiance for `rd` (dedupes the
    cubemap gather with the caller's miss-path sample)."""
    is_sky = (at.flags & int(MatFlag.SKY)) != 0
    if meta.has_sky:
        if sky_col is None:
            from pim.render.sky import sample_sky_cubemap_soa

            sky_col = sample_sky_cubemap_soa(arrays.sky, rd)
        return where3(is_sky, sky_col, at.emission)
    return where3(is_sky, V3.zeros(is_sky.shape), at.emission)


def get_emission(meta, arrays, ro: V3, rd: V3, hit) -> V3:
    at = fetch_hit_attribs(meta, arrays, hit)
    return get_emission_from_attribs(meta, arrays, rd, at)

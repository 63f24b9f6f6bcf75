"""Next-event estimation over the adaptive light grid (SoA).

Counterpart of LightSelect / SampleLight / LightEvalPdf / EstimateDirect /
LightOnHit (ref: src/rendering/path_tracer.c:1709-1942).

Re-design: full-MIS with a shared continuation ray.  The
reference's EstimateDirect picks one of two strategies stochastically and
traces a dedicated ray; here the BSDF-strategy sample IS the path's
continuation ray (its emission is MIS-weighted when the next hit lands on
a light), so NEE costs exactly one *any-hit shadow ray* per bounce and
needs no extra attribute fetch.  The light-grid state (cdf/pdf/active) is
fetched as ONE fused [2E+2, G] table gather, and the sampled light's
vertices come from a compact [16, E] emissive table instead of the full
triangle table.  LightOnHit's atomic histogram is a scatter-add into the
[G, E] live tensor, psum'd across devices at frame end.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from pim.geom.material import MatFlag
from pim.math.grid import grid_index_soa
from pim.math.sampling import light_pdf, power_heuristic, sample_bary_coord
from pim.math.vec3 import (
    EPS,
    LOG2_EPS,
    V3,
    avg_lum3,
    dot,
)
from pim.render import fetch as F
from pim.render.bsdf import eval_principled
from pim.render.scene import SceneArrays, SceneMeta, scene_occluded
from pim.render.surface import Surface


# Per-cell compacted light list size.  The fused table holds only the K
# highest-pdf lights of each cell, renormalized: at map scale (E in the
# hundreds) fetching all E pdf rows per lane is a [2E+2, N] multi-GB
# tensor per bounce (1.2 GB at E=600, 512²), while the
# visibility-seeded per-cell distributions are ~K-sparse anyway.  The
# truncation is UNBIASED: a light outside the cell's top-K has select
# pdf 0, so the BSDF-strategy power heuristic carries its full
# contribution (the same zero-select-pdf path as ref EstimateDirect
# :1891-1906 — see light_select_pdf_from_rows).
LIGHT_TOP_K = 32


def light_k(e: int) -> int:
    return min(e, LIGHT_TOP_K)


def make_light_table(lights, cell_active_f) -> jnp.ndarray:
    """Fuse the per-cell light-selection state into one [3K+2, G] table:
    rows [0 : K+1] cdf, [K+1 : 2K+1] discrete pdf, [2K+1 : 3K+1] emissive
    ids (f32-exact ints), [3K+1] active flag.  Rebuilt once per trace call
    (the distributions adapt every frame); K = light_k(E).

    lights.pdf rows follow the Dist1D convention (normalized to sum E per
    active row, discrete prob = pdf/E); the compacted q rows below are
    plain discrete probabilities summing to <= 1."""
    e = lights.pdf.shape[1]
    k = light_k(e)
    vals, ids = jax.lax.top_k(lights.pdf, k)           # [G, K]
    total = jnp.sum(vals, axis=-1, keepdims=True)      # [G, 1]
    q = vals / jnp.maximum(total, EPS)                 # zero rows stay zero
    g = q.shape[0]
    cdf = jnp.concatenate(
        [jnp.zeros((g, 1), q.dtype), jnp.cumsum(q, axis=-1)], axis=-1
    )                                                  # [G, K+1]
    return jnp.concatenate(
        [cdf.T, q.T, ids.astype(jnp.float32).T, cell_active_f], axis=0
    )


class LightSelection(NamedTuple):
    emit: jnp.ndarray        # [N] i32 selected emissive index
    select_pdf: jnp.ndarray  # [N] discrete selection pdf (uniform-u mapped)
    ok: jnp.ndarray          # [N] bool
    pdf_rows: jnp.ndarray    # [K, N] the cell's compacted discrete pdfs
    id_rows: jnp.ndarray     # [K, N] i32 the cell's compacted emissive ids
    active: jnp.ndarray      # [N] bool cell-active flags


def light_select(meta: SceneMeta, light_table: jnp.ndarray, grid_lo,
                 position: V3, u) -> LightSelection:
    """Pick an emissive triangle from the position's cell distribution
    (ref LightSelect :1735-1764) via one fused table gather."""
    k = light_k(meta.emissive_count)
    grid = meta.grid_spec(grid_lo)
    cell = grid_index_soa(grid, position)
    rows = F.fetch_cols(light_table, cell)               # [3K+2, N]
    cdf_rows = rows[0 : k + 1]
    pdf_rows = rows[k + 1 : 2 * k + 1]
    id_rows = rows[2 * k + 1 : 3 * k + 1].astype(jnp.int32)
    active = rows[3 * k + 1] > 0.5
    slot = jnp.sum((cdf_rows <= u[None, :]).astype(jnp.int32), axis=0) - 1
    slot = jnp.clip(slot, 0, k - 1)
    pdf = F.select_columns(pdf_rows, slot)
    emit = jnp.sum(
        jnp.where(jnp.arange(k, dtype=jnp.int32)[:, None] == slot[None, :],
                  id_rows, 0), axis=0)
    ok = active & (pdf > EPS)
    return LightSelection(emit=emit, select_pdf=pdf, ok=ok,
                          pdf_rows=pdf_rows, id_rows=id_rows, active=active)


def light_select_pdf_from_rows(pdf_rows, id_rows, emit_of_hit):
    """Probability that light_select would pick the hit's emissive from the
    same cell (ref LightSelectPdf :1766-1783).

    Mirrors the reference exactly: 1.0 only when the hit is not in the
    emissive table (iEmit < 0); otherwise the cell's compacted-dist pdf,
    WHICH MAY BE ZERO (fully occluded per the visibility seeding, inactive
    cell, or outside the cell's top-K list).  A zero here drives the BSDF
    strategy's power heuristic to weight 1 — NEE cannot sample this light
    from this cell, so the BSDF sample must carry the full contribution.
    Returning a positive floor instead silently discards that energy
    (the round-2 12.8%-dark diffuse bias)."""
    valid = emit_of_hit >= 0
    match = id_rows == jnp.maximum(emit_of_hit, 0)[None, :]
    pdf = jnp.sum(jnp.where(match, pdf_rows, 0.0), axis=0)
    return jnp.where(valid, pdf, 1.0)


def light_on_hit(meta: SceneMeta, live, cell, emit, emission: V3, active):
    """Accumulate the light-learning histogram (ref LightOnHit :1709-1733)."""
    lum = avg_lum3(emission)
    loglum = jnp.log2(jnp.maximum(lum, EPS)) - LOG2_EPS
    loglum = jnp.clip(loglum, 0.0, 46.0)
    amt = (loglum * (255.0 / 46.0) + 0.5).astype(jnp.uint32)
    ok = active & (emit >= 0) & (lum > EPS)
    amt = jnp.where(ok, amt, 0)
    cell = jnp.where(ok, cell, 0)
    emit = jnp.where(ok, jnp.maximum(emit, 0), 0)
    return live.at[cell, emit].add(amt)


# Compact emissive-table layout (SceneArrays.emissive_table, [24, E]);
# built host-side in scene.build_emissive_table:
E_PA = slice(0, 3)
E_PB = slice(3, 6)
E_PC = slice(6, 9)
E_AREA = 9
E_TRI = 10
E_ALBEDO = slice(11, 14)  # flat albedo rgb (valid when E_ALBEDO_TEX < 0)
E_UVA = slice(14, 16)
E_UVB = slice(16, 18)
E_UVC = slice(18, 20)
E_ALBEDO_TEX = 20
E_ROME_TEX = 21
E_FLAGS = 22
E_EMIT_A = 23             # flat emission alpha (valid when E_ROME_TEX < 0)
E_ROWS = 24


class LightSample(NamedTuple):
    """A sampled point on a selected emissive triangle."""

    dir: V3                  # unit direction from the shading point
    dist: jnp.ndarray        # [N]
    emission: V3             # radiance toward the shading point
    lp: jnp.ndarray          # [N] full light-strategy pdf (area x select)
    tri: jnp.ndarray         # [N] i32 source triangle id of the light
    ok: jnp.ndarray          # [N] bool
    pdf_rows: jnp.ndarray    # [K, N] compacted discrete pdfs
    id_rows: jnp.ndarray     # [K, N] i32 compacted emissive ids
    active: jnp.ndarray      # [N] bool


def sample_light(meta: SceneMeta, arrays: SceneArrays, light_table, p: V3,
                 u_sel, bu, bv) -> LightSample:
    """Light selection + barycentric point sample + emission evaluation
    (ref SampleLight :1785-1822) from the compact emissive table — one
    [2E+2, G] grid gather plus one [24, E] emissive gather."""
    sel = light_select(meta, light_table, arrays.grid_lo, p, u_sel)
    rows = F.fetch_cols(arrays.emissive_table, sel.emit)  # [24, N]
    a = F.v3_rows(rows, E_PA)
    b = F.v3_rows(rows, E_PB)
    c = F.v3_rows(rows, E_PC)
    area = rows[E_AREA]
    tri = rows[E_TRI].astype(jnp.int32)
    w_, wu, wv = sample_bary_coord(bu, bv)
    target = a * w_ + b * wu + c * wv
    delta = target - p
    dist_sq = jnp.maximum(dot(delta, delta), 1e-12)
    dist = jnp.sqrt(dist_sq)
    rd = delta * (1.0 / dist)

    # emission at the sampled point (texture-faithful: the BSDF-strategy
    # side of MIS sees the textured value, so NEE must too);
    # UnpackEmission: albedo * e^2 * kEmissionScale (ref color.h:588-591)
    from pim.math.color import K_EMISSION_SCALE

    albedo = V3(rows[E_ALBEDO.start], rows[E_ALBEDO.start + 1],
                rows[E_ALBEDO.start + 2])
    emit_a = rows[E_EMIT_A]
    if meta.textured:
        from pim.math.vec3 import V2, where3
        from pim.render.surface import sample_atlas_bilinear_multi

        a_tex = rows[E_ALBEDO_TEX].astype(jnp.int32)
        r_tex = rows[E_ROME_TEX].astype(jnp.int32)
        uv = V2(
            rows[E_UVA.start] * w_ + rows[E_UVB.start] * wu + rows[E_UVC.start] * wv,
            rows[E_UVA.start + 1] * w_ + rows[E_UVB.start + 1] * wu
            + rows[E_UVC.start + 1] * wv,
        )
        alb, rom = sample_atlas_bilinear_multi(
            arrays.atlas_planes, arrays.tex_rec_t,
            [(a_tex, uv, (0, 0, 0, 0)), (r_tex, uv, (0, 0, 0, 0))])
        albedo = where3(a_tex >= 0, V3(alb[0], alb[1], alb[2]), albedo)
        emit_a = jnp.where(r_tex >= 0, rom[3], emit_a)
    emission = albedo * (emit_a * emit_a * K_EMISSION_SCALE)
    if meta.has_sky:
        from pim.math.vec3 import where3
        from pim.render.sky import sample_sky_cubemap_soa

        is_sky = (rows[E_FLAGS].astype(jnp.int32) & int(MatFlag.SKY)) != 0
        emission = where3(is_sky, sample_sky_cubemap_soa(arrays.sky, rd),
                          emission)

    from pim.math.vec3 import cross, normalize

    ng = normalize(cross(b - a, c - a))
    cos_theta = jnp.abs(dot(rd, ng))
    lp = light_pdf(area, cos_theta, dist_sq) * sel.select_pdf
    return LightSample(
        dir=rd, dist=dist, emission=emission, lp=lp, tri=tri,
        ok=sel.ok, pdf_rows=sel.pdf_rows, id_rows=sel.id_rows,
        active=sel.active,
    )


def nee_light_strategy(
    meta: SceneMeta,
    arrays: SceneArrays,
    light_table,
    lut,
    surf: Surface,
    src_tri,
    i_dir: V3,
    u_sel, bu, bv,
    active=None,
    transmittance_fn=None,
):
    """Light-strategy half of the MIS estimator (ref EstimateDirect
    :1849-1890): sample a light point, trace ONE any-hit shadow ray, weight
    by the power heuristic against the BSDF pdf at that direction.

    The BSDF-strategy half lives in the integrator: the continuation ray's
    emission at the next hit is MIS-weighted there (ref :1891-1919).

    active: optional [N] bool; inactive lanes get t_far = 0, so their
    any-hit traversal retires before its first node.

    Returns (radiance V3, LightSample) — radiance is zero where invalid.
    """
    ls = sample_light(meta, arrays, light_table, surf.p, u_sel, bu, bv)

    # shadow ray: the target sits ON the light tri at t == dist, so clip
    # t_far a relative epsilon short of it (the ref instead closest-hits and
    # compares tri ids, path_tracer.c:1868-1875)
    t_far = ls.dist * jnp.float32(1.0 - 1e-3)
    if active is not None:
        t_far = jnp.where(active, t_far, 0.0)
    blocked = scene_occluded(meta, arrays, surf.p, ls.dir, 0.0, t_far)

    brdf_a, bp = eval_principled(lut, surf, i_dir, ls.dir)
    w = power_heuristic(ls.lp, bp) / jnp.maximum(ls.lp, EPS)
    refractive = (surf.flags & int(MatFlag.REFRACTIVE)) != 0
    ok = (
        ls.ok & ~blocked & (src_tri != ls.tri)
        & (ls.lp > EPS) & (bp > EPS) & ~refractive
    )
    radiance = ls.emission * brdf_a * (w * ok.astype(jnp.float32))
    if transmittance_fn is not None:
        # medium transmittance along the shadow ray (ref SampleLight
        # :1820-1823) — compiled in only when media is enabled
        radiance = radiance * transmittance_fn(surf.p, ls.dir, ls.dist)
    return radiance, ls

"""The wavefront path-tracing integrator (SoA lanes, hit-carried).

Counterpart of Pt_TraceRay / TraceFn / Pt_Trace (ref: src/rendering/
path_tracer.c:2306-2585) — redesigned as a wavefront:

  reference                      this design
  ---------------------------    ------------------------------------------
  per-pixel while(bounce) loop   `lax.scan` over bounce index, all rays in
                                 lockstep with an `alive` mask
  64 worker threads              one dense [N]-lane wavefront (or a shard)
  per-thread PCG stream          per-ray counter RNG, (pixel, sample)-keyed
  Russian roulette `break`       RR folds into the alive mask
  atomic light histogram         scatter-add into the carried [G, E] tensor
  float4 SIMD values             SoA V3 over flat [N] arrays (vec3.py)

Round-2 restructure (the perf path): the loop is
*hit-carried* — each scan iteration starts from an already-traced hit
(+ its fetched [48, N] attribute block, carried across iterations), does
NEE with ONE any-hit shadow ray, then samples the BSDF once; that sample
is simultaneously the MIS BSDF strategy AND the continuation ray, traced
with ONE closest-hit call whose emission at the next hit is MIS-weighted.
Per bounce: 1 closest-hit + 1 any-hit + 1 attribute gather (the reference
stochastic EstimateDirect needs 2 closest-hits + 4-5 gathers for the same
estimator family).  The estimator is deterministic full MIS — smooth in
the material parameters, so the differentiable path shares it (the old
`mis_both` flag is accepted and ignored).

Radiance math stays line-comparable per lane: RR scaling, NEE MIS power
heuristic, refractive chains carrying full emission weight, media lanes
skipping surface work, and the albedo/normal AOV weighting all follow the
reference (cited inline).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from pim.core import rng
from pim.geom.material import MatFlag
from pim.math.brdf import BrdfLut
from pim.math.grid import grid_index_soa
from pim.math.sampling import light_pdf, power_heuristic
from pim.math.vec3 import (
    EPS,
    PI,
    RCP_EPS,
    V3,
    avg_lum3,
    dot,
    saturate,
    where3,
)
from pim.render import fetch as F
from pim.render.bsdf import scatter_principled
from pim.render.intersect import Hit
from pim.render.lights import (
    light_on_hit,
    light_select_pdf_from_rows,
    make_light_table,
    nee_light_strategy,
    sample_light,
)
from pim.render.scene import (
    LightState,
    SceneArrays,
    SceneMeta,
    scene_intersect,
    scene_occluded,
)
from pim.render.surface import (
    attribs_from_rows,
    fetch_hit_attribs,
    get_emission_from_attribs,
    get_surface,
    pack_sampled,
    sampled_rows,
)


def _compact_perm(alive: jnp.ndarray) -> jnp.ndarray:
    """Alive-first stable-partition permutation (wavefront compaction,
    SURVEY.md §7 hard part #2).

    The reference compacts by overwriting dead SIMD lanes from a work
    queue; here a cumsum-based partition reorders lanes so dead ones pack
    into trailing RAY_BLOCK-sized blocks, which the Pallas kernels then
    skip wholesale (t_far <= 0 marks them).  Returns perm such that
    x[perm] is alive-first; costs 2 cumsums + 1 scatter + the carry
    gathers (~0.25 ms/bounce at 512²) against the dead-lane fraction of
    every traced segment."""
    n = alive.shape[0]
    a = alive.astype(jnp.int32)
    na = jnp.cumsum(a)
    pos = jnp.where(alive, na - 1, na[-1] + jnp.cumsum(1 - a) - 1)
    return jnp.zeros((n,), jnp.int32).at[pos].set(jnp.arange(n, dtype=jnp.int32))


def _permute_carry(carry: dict, perm: jnp.ndarray) -> dict:
    """Apply a lane permutation to every per-lane entry of the scan carry
    (live histogram and ray counter are lane-free and pass through).

    Lanes are stacked into TWO [F, N] blocks — one f32, one u32 — each
    gathered with a single take, pinned by optimization_barriers as a
    standalone op so XLA does not fuse one gather per row into its
    consumers inside the bounce scan (whether the pin still pays on the
    GPU is not measured yet).  Integer lanes must NOT ride an f32
    bitcast: patterns like -1 / full-range rng words are NaN payloads,
    which float datapaths may canonicalize (silent corruption)."""
    skip = {"live", "rays"}
    leaves = []   # flat list of [N] arrays
    treedef = {}
    for k, v in carry.items():
        if k in skip:
            continue
        if isinstance(v, (V3, rng.RngState)):
            parts = list(v)
            treedef[k] = (type(v), parts[0].dtype, 1, len(parts))
        elif v.ndim == 2:
            parts = list(v)
            treedef[k] = (None, v.dtype, 2, len(parts))
        else:
            parts = [v]
            treedef[k] = (None, v.dtype, 1, 1)
        leaves.extend(parts)

    is_f32 = [a.dtype == jnp.float32 for a in leaves]

    def to_u32(a):
        if a.dtype == jnp.bool_:
            return a.astype(jnp.uint32)
        if a.dtype == jnp.uint32:
            return a
        return jax.lax.bitcast_convert_type(a, jnp.uint32)

    gathered = [None] * len(leaves)
    for sel, prep in ((True, lambda a: a), (False, to_u32)):
        idxs = [i for i, f in enumerate(is_f32) if f == sel]
        if not idxs:
            continue
        stacked = jnp.stack([prep(leaves[i]) for i in idxs], axis=0)
        stacked = jax.lax.optimization_barrier(stacked)
        g = jnp.take(stacked, perm, axis=1)
        g = jax.lax.optimization_barrier(g)
        for j, i in enumerate(idxs):
            gathered[i] = g[j]

    def restore(a, dt):
        if dt == jnp.float32 or dt == jnp.uint32:
            return a
        if dt == jnp.bool_:
            return a > 0
        return jax.lax.bitcast_convert_type(a, dt)

    out = {k: carry[k] for k in skip if k in carry}
    i = 0
    for k, v in carry.items():
        if k in skip:
            continue
        cls, dtype, ndim, cnt = treedef[k]
        rows = gathered[i : i + cnt]
        i += cnt
        if cls is not None:  # V3 / RngState
            out[k] = cls(*(restore(rows[j], dtype) for j in range(cnt)))
        elif ndim == 2:
            out[k] = restore(jnp.stack(rows, axis=0), dtype)
        else:
            out[k] = restore(rows[0], dtype)
    return out


class TraceResult(NamedTuple):
    color: jnp.ndarray    # [N, 3] radiance (AoS at the API edge)
    albedo: jnp.ndarray   # [N, 3] AOV
    normal: jnp.ndarray   # [N, 3] AOV
    live: jnp.ndarray     # [G, E] u32 light-learning histogram delta
    rays_traced: jnp.ndarray  # scalar f32: total rays actually cast


def _evaluate_light(meta, arrays, light_table, state, p: V3,
                    media_desc=None):
    """In-media NEE (ref EvaluateLight :1921-1942): select a light from the
    grid, sample a point on it, verify visibility with one any-hit ray.
    With media, the sampled luminance carries the ratio-tracked medium
    transmittance along the shadow ray (ref SampleLight :1820-1823 — its
    omission was a measured ~2x in-media NEE overcount, caught by
    tests/test_media.py::test_media_brute_vs_framework, r5).
    Returns (state, lum V3, dir V3, ok)."""
    state, u_sel = rng.next_f32(state)
    state, (bu, bv) = rng.next_f32x2(state)
    ls = sample_light(meta, arrays, light_table, p, u_sel, bu, bv)
    blocked = scene_occluded(meta, arrays, p, ls.dir,
                             0.0, ls.dist * jnp.float32(1.0 - 1e-3))
    ok = ls.ok & ~blocked & (ls.lp > EPS)
    lum = ls.emission * (1.0 / jnp.maximum(ls.lp, EPS))
    if media_desc is not None:
        from pim.render.media import calc_transmittance

        state, tr = calc_transmittance(media_desc, state, p, ls.dir, ls.dist)
        lum = lum * tr
    return state, lum, ls.dir, ok


def _sky_radiance(meta: SceneMeta, arrays: SceneArrays, rd: V3) -> V3:
    if meta.has_sky:
        from pim.render.sky import sample_sky_cubemap_soa

        return sample_sky_cubemap_soa(arrays.sky, rd)
    return V3.zeros(rd.x.shape)


def _finish_segment(meta, arrays, light_table, media_desc, state,
                    ro, rd, hit, at, atten, lum, alive, live, emis_w,
                    is_primary: bool):
    """Shared tail of every traced segment: sky on miss (ref :2334-2339),
    media scatter along the segment (ScatterRay :2346-2367), backface kill
    (:2340-2343), light learning (:2370-2373), weighted emission
    (:2375-2378), sky-surface termination (:2379-2382).

    `emis_w` is the per-lane weight for the emission at this segment's hit
    (1 for primary rays / refractive chains; the MIS power-heuristic weight
    from the BSDF sample otherwise).

    Returns the sampled sky radiance as its last element so callers can
    CARRY it to the next bounce's get_surface — the cubemap is gathered
    once per segment instead of three times (miss path, sky-surface
    emission, next-bounce surface build all see the same (sky, rd) pair;
    media-scattered lanes change rd mid-segment but never consume surface
    emission — surf_alive excludes them — so the reuse is exact)."""
    n = ro.x.shape[0]
    missed = hit.tri < 0

    sky = _sky_radiance(meta, arrays, rd)
    lum = lum + atten * sky * (alive & missed).astype(jnp.float32)

    media_scattered = jnp.zeros((n,), bool)
    if meta.media_enabled:
        from pim.render.media import scatter_ray

        e = meta.emissive_count
        ray_len = jnp.where(missed, RCP_EPS, hit.t)

        def eval_light_in_media(st, p):
            return _evaluate_light(meta, arrays, light_table, st, p,
                                   media_desc=media_desc)

        state, ms = scatter_ray(
            media_desc, state, ro, rd, ray_len,
            evaluate_light=eval_light_in_media if e > 0 else None,
        )
        media_scattered = alive & ms.scattered
        msf = media_scattered.astype(jnp.float32)
        lum = lum + atten * ms.luminance * msf
        inv_mpdf = 1.0 / jnp.maximum(ms.pdf, EPS)
        atten = where3(
            media_scattered,
            atten * ms.attenuation * inv_mpdf,
            where3(alive, atten * ms.attenuation, atten),
        )
        ro = where3(media_scattered, ms.pos, ro)
        rd = where3(media_scattered, ms.dir, rd)

    refr_hit = (at.flags & int(MatFlag.REFRACTIVE)) != 0
    dead_backface = hit.backface & ~refr_hit
    alive = alive & (media_scattered | (~missed & ~dead_backface))
    surf_alive = alive & ~media_scattered

    emission = get_emission_from_attribs(meta, arrays, rd, at, sky_col=sky)

    if meta.emissive_count > 0 and not is_primary:
        cell = grid_index_soa(meta.grid_spec(arrays.grid_lo), ro)
        emit = at.rows[F.EMIT_IDX].astype(jnp.int32)
        live = light_on_hit(meta, live, cell, emit, emission, surf_alive)

    lum = lum + emission * atten * (emis_w * surf_alive.astype(jnp.float32))

    is_sky_surf = (at.flags & int(MatFlag.SKY)) != 0
    alive = alive & (media_scattered | ~is_sky_surf)

    return state, ro, rd, atten, lum, alive, media_scattered, live, sky


def trace_rays(
    meta: SceneMeta,
    arrays: SceneArrays,
    lights: LightState,
    ro,
    rd,
    state,
    max_bounces: int,
    media_desc=None,
    mis_both: bool = False,
    use_rr: bool = True,
    compact: bool = False,
) -> TraceResult:
    """Trace a batch of rays to completion.

    compact: alive-first lane compaction at each bounce (a pure lane
    permutation — per-pixel output matches either way since each lane's
    RNG stream travels with it; dead lanes pack together, so whole
    blocks of the traversal kernel retire at once).  Default OFF: the
    permutation moves the ~81-row carry every bounce, and whether that
    pays on the GPU is not measured yet (ROADMAP).  Without it dead
    lanes still carry t_far = 0 and retire before their first node.

    ro/rd: V3 of [N] (or [N, 3] arrays, converted); state: rng.RngState.
    media_desc: MediaDesc when meta.media_enabled (captured statically).
    mis_both: accepted for API compatibility and ignored — the integrator
    is always deterministic full-MIS now (the BSDF strategy rides the
    continuation ray for free).
    use_rr: Russian roulette termination (ref :2319-2331).  The
    differentiable path disables it — the survive/die comparison depends
    on the throughput, so parameter perturbations flip lanes discretely,
    which AD cannot follow (SURVEY.md §7 hard part #3); a fixed bounce
    budget keeps the estimator smooth.  The RR uniform is drawn either
    way so RNG streams stay aligned between the two modes.
    """
    del mis_both
    if meta.media_enabled and media_desc is None:
        from pim.render.media import make_media_desc

        media_desc = make_media_desc()
    if not isinstance(ro, V3):
        ro = V3.from_aos(ro)
    if not isinstance(rd, V3):
        rd = V3.from_aos(rd)
    n = ro.x.shape[0]
    lut = BrdfLut(texels=arrays.brdf_lut)
    g, e_live = lights.live.shape
    e = meta.emissive_count
    light_table = make_light_table(lights, arrays.cell_active_f) if e > 0 else None

    if meta.has_refractive:
        def thickness_fn(p, l, mask):
            # masked lanes carry t_far = 0: the intersect kernels skip
            # whole blocks with no refracting lanes (glass is sparse)
            t_far = jnp.where(mask, RCP_EPS, 0.0)
            h = scene_intersect(meta, arrays, p, l, 0.0, t_far)
            return h.t
    else:
        thickness_fn = None

    # --- primary segment ------------------------------------------------
    alive0 = jnp.ones((n,), bool)
    live0 = jnp.zeros((g, e_live), jnp.uint32)
    rays0 = jnp.float32(n)
    hit0 = scene_intersect(meta, arrays, ro, rd, 0.0, RCP_EPS)
    at0 = fetch_hit_attribs(meta, arrays, hit0)
    state, ro, rd, atten0, lum0, alive0, mskip0, live0, sky0 = _finish_segment(
        meta, arrays, light_table, media_desc, state, ro, rd, hit0, at0,
        V3.ones((n,)), V3.zeros((n,)), alive0, live0,
        jnp.float32(1.0), is_primary=True,
    )

    init = dict(
        ro=ro, rd=rd,
        t=hit0.t, tri=hit0.tri, u=hit0.u, v=hit0.v,
        backface=hit0.backface, ngx=hit0.ng.x, ngy=hit0.ng.y, ngz=hit0.ng.z,
        rows=at0.rows,
        state=state,
        lum=lum0,
        atten=atten0,
        alive=alive0,
        media_skip=mskip0,
        aov_albedo=V3.zeros((n,)),
        aov_normal=V3.zeros((n,)),
        aov_weight=jnp.zeros((n,), jnp.float32),
        pixel=jnp.arange(n, dtype=jnp.int32),
        live=live0,
        rays=rays0,
    )
    # atlas-sampled channels + sky travel with the hit (one atlas gather
    # and one cubemap gather per bounce instead of 3+2 — r5 perf fix)
    if sampled_rows(meta) > 0:
        init["tex"] = pack_sampled(meta, at0)
    if meta.has_sky:
        init["sky"] = sky0

    def bounce(carry, b):
        del b
        if compact:
            carry = _permute_carry(carry, _compact_perm(carry["alive"]))
        ro = carry["ro"]
        rd = carry["rd"]
        state = carry["state"]
        alive = carry["alive"]
        atten = carry["atten"]
        lum = carry["lum"]
        media_skip = carry["media_skip"]
        hit = Hit(
            t=carry["t"], tri=carry["tri"], u=carry["u"], v=carry["v"],
            backface=carry["backface"],
            ng=V3(carry["ngx"], carry["ngy"], carry["ngz"]),
        )

        at = attribs_from_rows(meta, arrays, carry["rows"], hit,
                               sampled=carry.get("tex"))
        surf = get_surface(meta, arrays, ro, rd, hit, attribs=at,
                           sky_col=carry.get("sky"))
        surf_alive = alive & ~media_skip

        # --- NEE: light strategy, one any-hit shadow ray (ref :1849-1890)
        rays = carry["rays"]
        state, u_sel = rng.next_f32(state)
        state, (bu, bv) = rng.next_f32x2(state)
        if e > 0:
            if meta.media_enabled:
                # surface NEE through the medium: ratio-tracked shadow-ray
                # transmittance (ref SampleLight :1820-1823); the rng state
                # threads through the closure cell
                from pim.render.media import calc_transmittance

                st_box = [state]

                def tr_fn(p, ldir, ldist):
                    st, tr = calc_transmittance(media_desc, st_box[0], p,
                                                ldir, ldist)
                    st_box[0] = st
                    return tr
            else:
                st_box = [state]
                tr_fn = None
            li, ls = nee_light_strategy(
                meta, arrays, light_table, lut, surf, hit.tri, rd, u_sel, bu, bv,
                active=surf_alive, transmittance_fn=tr_fn,
            )
            state = st_box[0]
            lum = lum + li * atten * surf_alive.astype(jnp.float32)
            rays = rays + jnp.sum(surf_alive.astype(jnp.float32))

        # --- continuation = BSDF strategy (ref Scatter_Principled
        # :1670-1707; its MIS weight is applied to the NEXT hit's emission)
        state, scat = scatter_principled(lut, surf, rd, state,
                                         occluded_fn=thickness_fn)
        cont = surf_alive & (scat.pdf > EPS)
        inv_pdf = 1.0 / jnp.maximum(scat.pdf, EPS)
        atten = where3(cont, atten * scat.attenuation * inv_pdf, atten)
        ro2 = where3(cont, scat.pos, ro)
        rd2 = where3(cont, scat.dir, rd)
        prev_refr = cont & ((surf.flags & int(MatFlag.REFRACTIVE)) != 0)
        alive2 = cont | (alive & media_skip)

        # --- AOV accumulation (ref :2400-2406)
        w = saturate(1.0 - avg_lum3(atten) * (1.0 / PI)) * cont.astype(jnp.float32)
        aov_albedo = carry["aov_albedo"] + surf.albedo * w
        aov_normal = carry["aov_normal"] + surf.n * w
        aov_weight = carry["aov_weight"] + w

        # --- Russian roulette before the trace (ref :2319-2331)
        state, u_rr = rng.next_f32(state)
        if use_rr:
            p = saturate(avg_lum3(atten))
            survive = u_rr < p
            scale = jnp.where(alive2 & survive, 1.0 / jnp.maximum(p, EPS), 1.0)
            atten = atten * scale
            alive2 = alive2 & survive

        # --- trace the continuation segment (ref :2333); dead lanes carry
        # t_far = 0 so compacted-away blocks skip all triangle work
        rays = rays + jnp.sum(alive2.astype(jnp.float32))
        t_far2 = jnp.where(alive2, RCP_EPS, 0.0)
        hit2 = scene_intersect(meta, arrays, ro2, rd2, 0.0, t_far2)
        at2 = fetch_hit_attribs(meta, arrays, hit2)

        # MIS weight for emission at the new hit (ref EstimateDirect BSDF
        # strategy :1891-1919): media-scattered lanes carry zero (the ref
        # `continue`s past surface work, and in-media NEE covers direct
        # light at the scatter point), refractive chains carry one.
        if e > 0:
            h_dist_sq = jnp.maximum(hit2.t * hit2.t, EPS)
            lp_area = light_pdf(at2.rows[F.AREA], jnp.abs(dot(rd2, hit2.ng)),
                                h_dist_sq)
            lp2 = lp_area * light_select_pdf_from_rows(
                ls.pdf_rows, ls.id_rows, at2.rows[F.EMIT_IDX].astype(jnp.int32)
            )
            bp2 = scat.pdf
            # Gate mirrors ref :1891-1906 exactly: the area pdf must be
            # valid, but the SELECT pdf may be zero (light unreachable by
            # NEE from this cell) — then PowerHeuristic(bp2, 0) == 1 and
            # the BSDF sample carries full weight.  Gating on lp2 here
            # discards that energy (round-2 diffuse parity bias).
            ok_b = (bp2 > EPS) & (lp_area > EPS)
            w_mis = power_heuristic(bp2, lp2) * ok_b.astype(jnp.float32)
        else:
            w_mis = jnp.ones((n,), jnp.float32)
        emis_w = jnp.where(prev_refr, 1.0, w_mis)
        emis_w = jnp.where(media_skip, 0.0, emis_w)

        live = carry["live"]
        state, ro3, rd3, atten, lum, alive3, mskip, live, sky2 = _finish_segment(
            meta, arrays, light_table, media_desc, state, ro2, rd2, hit2, at2,
            atten, lum, alive2, live, emis_w, is_primary=False,
        )

        out = dict(
            ro=ro3, rd=rd3,
            t=hit2.t, tri=hit2.tri, u=hit2.u, v=hit2.v,
            backface=hit2.backface,
            ngx=hit2.ng.x, ngy=hit2.ng.y, ngz=hit2.ng.z,
            rows=at2.rows,
            state=state, lum=lum, atten=atten, alive=alive3,
            media_skip=mskip,
            aov_albedo=aov_albedo, aov_normal=aov_normal,
            aov_weight=aov_weight, pixel=carry["pixel"],
            live=live, rays=rays,
        )
        if "tex" in carry:
            out["tex"] = pack_sampled(meta, at2)
        if "sky" in carry:
            out["sky"] = sky2
        return out, None

    carry, _ = jax.lax.scan(bounce, init, jnp.arange(max_bounces))

    # undo the lane compaction: scatter per-lane results back to pixel order
    # (without compaction lanes never move, so there is nothing to undo)
    pix = carry["pixel"]

    def unscatter(v: V3) -> jnp.ndarray:
        if not compact:
            return v.aos()
        out = jnp.zeros((n, 3), jnp.float32)
        return out.at[pix, 0].set(v.x).at[pix, 1].set(v.y).at[pix, 2].set(v.z)

    s = 1.0 / jnp.maximum(carry["aov_weight"], EPS)
    return TraceResult(
        color=unscatter(carry["lum"]),
        albedo=unscatter(carry["aov_albedo"] * s),
        normal=unscatter(carry["aov_normal"] * s),
        live=carry["live"],
        rays_traced=carry["rays"],
    )


# ---------------------------------------------------------------------------
# Progressive accumulation (ref Pt_Trace + TraceFn EMA :2550-2552)
# ---------------------------------------------------------------------------


class TraceBuffers(NamedTuple):
    """Progressive accumulation state (ref PtTrace, path_tracer.h:67-84)."""

    color: jnp.ndarray    # [H*W, 3]
    albedo: jnp.ndarray   # [H*W, 3]
    normal: jnp.ndarray   # [H*W, 3]


def make_trace_buffers(width: int, height: int) -> TraceBuffers:
    n = width * height
    z = jnp.zeros((n, 3), jnp.float32)
    return TraceBuffers(color=z, albedo=z, normal=z)


def accumulate(buffers: TraceBuffers, result: TraceResult, sample_weight) -> TraceBuffers:
    """Progressive EMA: lerp(prev, new, 1/sampleCount)."""
    sw = jnp.asarray(sample_weight, jnp.float32)
    return TraceBuffers(
        color=buffers.color + (result.color - buffers.color) * sw,
        albedo=buffers.albedo + (result.albedo - buffers.albedo) * sw,
        normal=buffers.normal + (result.normal - buffers.normal) * sw,
    )


def luminance_stddev(color: jnp.ndarray) -> jnp.ndarray:
    """pt_stddev convergence metric (ref CalcStdDev,
    render_system.c:1374-1394)."""
    lum = jnp.mean(color, axis=-1)
    n = lum.shape[0]
    mean = jnp.mean(lum)
    var = jnp.sum((lum - mean) ** 2) / (n - 1)
    return jnp.sqrt(var)

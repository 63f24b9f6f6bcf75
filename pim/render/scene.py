"""TraceScene: the device-resident flat scene + build pipeline (SoA).

Counterpart of PtScene (ref: src/rendering/path_tracer.c:122-166) and
its build steps PtScene_Update/FlattenDrawables/SetupEmissives/
SetupLightGrid (:618-1049).  The scene is split into:

  SceneArrays — a pytree of jnp arrays (geometry, fused attribute table,
                atlas planes, BVH, light grid); passed as an argument to
                jitted kernels so scene swaps don't recompile.
  SceneMeta   — hashable static config (counts, grid dims, backend); a new
                meta means a new compile, like an Embree scene commit.
  LightState  — the adaptive light-sampling state (batched Dist1D + live
                hit histograms); updated functionally every frame.

Layout: the attribute table is [48, T] (fetched as [48, N] column blocks,
render/fetch.py), texture channels are flat planes, ray data is SoA V3.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pim.core import rng
from pim.core.console import LogSev, con_logf
from pim.geom.bvh import BvhArrays, build_bvh
from pim.geom.entities import Entities, FlatScene, flatten
from pim.geom.material import MatFlag, TexturePool, material_soa
from pim.math import dist1d
from pim.math.brdf import bake_brdf_lut
from pim.math.grid import GridSpec, grid_index, grid_len, grid_position, make_grid
from pim.math.sampling import hammersley_2d, sample_bary_coord, sample_unit_sphere
from pim.math.vec3 import MILLI, RCP_EPS, V3, cross, dot, where3
from pim.render import intersect as isect
from pim.render.intersect import Hit


class SceneArrays(NamedTuple):
    # geometry
    positions: jnp.ndarray   # [V, 3]
    normals: jnp.ndarray     # [V, 3]
    uvs: jnp.ndarray         # [V, 2]
    mat_ids: jnp.ndarray     # [T] i32
    tri_table: jnp.ndarray   # [48, T] fused attribute table (fetch.py layout)
    # bvh
    bvh_lo: jnp.ndarray
    bvh_hi: jnp.ndarray
    bvh_a: jnp.ndarray
    bvh_b: jnp.ndarray
    tri_order: jnp.ndarray
    # textures: flat per-channel planes + transposed records
    atlas_planes: jnp.ndarray  # [4, H*W]
    tex_rec_t: jnp.ndarray     # [5, Ntex] f32 (x0, y0, w, h, atlas_stride)
    # emissives
    tri_to_emit: jnp.ndarray   # [T] i32
    emit_to_tri_f: jnp.ndarray  # [1, E] f32 (for one-hot fetch)
    emissive_table: jnp.ndarray  # [24, E] compact NEE table (lights.E_* rows)
    # light grid
    grid_lo: jnp.ndarray       # [3]
    cell_active: jnp.ndarray   # [G] bool
    cell_active_f: jnp.ndarray  # [1, G] f32
    # BRDF LUT
    brdf_lut: jnp.ndarray      # [L, L, 2]
    # sky cubemap [6, R, R, 3] (R=1 zeros when absent)
    sky: jnp.ndarray


@dataclass(frozen=True)
class SceneMeta:
    vert_count: int
    tri_count: int
    mat_count: int
    emissive_count: int
    grid_size: Tuple[int, int, int]
    cells_per_meter: float
    backend: str            # 'brute' | 'bvh' | 'kernel' (render/platform.py)
    max_leaf: int
    bvh_depth: int          # longest root-to-leaf path: the kernel's stack
    has_sky: bool
    has_refractive: bool
    media_enabled: bool
    textured: bool
    has_normal_maps: bool

    @property
    def grid_len(self) -> int:
        return self.grid_size[0] * self.grid_size[1] * self.grid_size[2]

    def grid_spec(self, grid_lo) -> GridSpec:
        return GridSpec(lo=grid_lo, size=self.grid_size, cells_per_meter=self.cells_per_meter)


class LightState(NamedTuple):
    pdf: jnp.ndarray       # [G, E]
    cdf: jnp.ndarray       # [G, E+1]
    integral: jnp.ndarray  # [G]
    sum: jnp.ndarray       # [G] u32
    live: jnp.ndarray      # [G, E] u32


def _mt_soa(ro: V3, rd: V3, a: V3, e1: V3, e2: V3):
    """Möller-Trumbore on SoA V3 lanes; returns (t, u, v, det)."""
    p = cross(rd, e2)
    det = dot(e1, p)
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
    tv = ro - a
    u = dot(tv, p) * inv_det
    q = cross(tv, e1)
    v = dot(rd, q) * inv_det
    t = dot(e2, q) * inv_det
    return t, u, v, det


def _finalize_hit_fused(arrays: SceneArrays, tri, ro: V3, rd: V3) -> Hit:
    """Hit completion from the kernel's triangle ids: t, u, v and the normal
    are recomputed from the fetched vertices, so they carry the gradient
    that the kernel's outputs do not."""
    from pim.render import fetch as F

    rows = F.fetch_cols(arrays.tri_table, jnp.maximum(tri, 0))
    a = F.v3_rows(rows, F.PA)
    b = F.v3_rows(rows, F.PB)
    c = F.v3_rows(rows, F.PC)
    t, u, v, det = _mt_soa(ro, rd, a, b - a, c - a)
    miss = tri < 0
    ng = cross(b - a, c - a)
    backface = det < 0.0
    inv_len = jax.lax.rsqrt(jnp.maximum(dot(ng, ng), 1e-24))
    sign = jnp.where(backface, -inv_len, inv_len)
    ng = ng * sign
    zero = jnp.float32(0.0)
    return Hit(
        t=jnp.where(miss, -1.0, t),
        tri=tri,
        u=jnp.where(miss, 0.0, jnp.clip(u, 0.0, 1.0)),
        v=jnp.where(miss, 0.0, jnp.clip(v, 0.0, 1.0)),
        backface=jnp.where(miss, False, backface),
        ng=where3(miss, V3(zero, zero, zero), ng),
    )


def _bvh(arrays: SceneArrays) -> BvhArrays:
    return BvhArrays(arrays.bvh_lo, arrays.bvh_hi, arrays.bvh_a, arrays.bvh_b,
                     arrays.tri_order)


def _kernel_trace(meta: SceneMeta, arrays: SceneArrays, ro: V3, rd: V3,
                  t_near, t_far, any_hit: bool):
    from pim.render import bvh_kernel

    return bvh_kernel.traverse(
        _bvh(arrays), arrays.positions, ro, rd, t_near, t_far,
        stack=meta.bvh_depth, max_leaf=meta.max_leaf, any_hit=any_hit)


def scene_intersect(meta: SceneMeta, arrays: SceneArrays, ro: V3, rd: V3,
                    t_near, t_far) -> Hit:
    if meta.backend == "kernel":
        _, tri = _kernel_trace(meta, arrays, ro, rd, t_near, t_far, False)
        return _finalize_hit_fused(arrays, tri, ro, rd)
    ro_a = ro.aos()
    rd_a = rd.aos()
    if meta.backend == "bvh":
        return isect.intersect_bvh(_bvh(arrays), arrays.positions, ro_a, rd_a,
                                   t_near, t_far, meta.max_leaf)
    return isect.intersect_brute(arrays.positions, ro_a, rd_a, t_near, t_far)


def scene_occluded(meta: SceneMeta, arrays: SceneArrays, ro: V3, rd: V3,
                   t_near, t_far) -> jnp.ndarray:
    if meta.backend == "kernel":
        _, tri = _kernel_trace(meta, arrays, ro, rd, t_near, t_far, True)
        return tri >= 0
    ro_a = ro.aos()
    rd_a = rd.aos()
    if meta.backend == "bvh":
        return isect.occluded_bvh(_bvh(arrays), arrays.positions, ro_a, rd_a,
                                  t_near, t_far, meta.max_leaf)
    return isect.occluded_brute(arrays.positions, ro_a, rd_a, t_near, t_far)


# ---------------------------------------------------------------------------
# Emissive detection (ref SetupEmissives :845-883, EmissionPdf :784-822)
# ---------------------------------------------------------------------------


def _emission_pdf_host(flat: FlatScene, pool_atlas, pool_rec, attempts: int = 1000) -> np.ndarray:
    """Per-triangle emissive probability: fraction of random surface samples
    whose rome alpha is > 0 (MC emissive-texel test).  Host numpy, one-time."""
    tri_count = flat.mat_ids.shape[0]
    pdfs = np.zeros(tri_count, np.float32)
    rng_np = np.random.default_rng(0xE)
    uvs = flat.uvs.reshape(tri_count, 3, 2)
    for mat_idx in np.unique(flat.mat_ids):
        mat = flat.materials[mat_idx]
        sel = np.nonzero(flat.mat_ids == mat_idx)[0]
        if mat.flags & MatFlag.SKY:
            pdfs[sel] = 1.0
            continue
        if mat.rome_tex < 0:
            continue
        x0, y0, w, h = pool_rec[mat.rome_tex]
        tex = pool_atlas[y0 : y0 + h, x0 : x0 + w, 3]
        if w == 1 and h == 1:
            pdfs[sel] = 1.0 if tex[0, 0] > 0.0 else 0.0
            continue
        xi = rng_np.random((attempts, 2), dtype=np.float32)
        r1 = np.sqrt(np.maximum(xi[:, 0], 1e-12))
        u = r1 * (1 - xi[:, 1])
        v = xi[:, 1] * r1
        wgt = np.stack([1 - u - v, u, v], axis=-1)
        for ti in sel:
            uv = wgt @ uvs[ti]
            px = np.floor(uv[:, 0] * w).astype(np.int64) % w
            py = np.floor(uv[:, 1] * h).astype(np.int64) % h
            pdfs[ti] = (tex[py, px] > 0.0).mean()
    return pdfs


def build_emissive_table(flat: FlatScene, atlas, tex_rec,
                         emissive_tris: np.ndarray) -> np.ndarray:
    """Compact [24, E] NEE table (layout: lights.E_* rows) — vertices, area,
    tri id, flat albedo + emission alpha (textured lights carry atlas ids
    instead and are sampled per-point), flags.  Host-side, once per build."""
    e = len(emissive_tris)
    t = np.zeros((max(e, 1), 24), np.float32)
    if e == 0:
        return jnp.asarray(t.T)
    tri_count = flat.mat_ids.shape[0]
    pos = flat.positions.reshape(tri_count, 3, 3)
    uvs = flat.uvs.reshape(tri_count, 3, 2)
    p = pos[emissive_tris]
    t[:, 0:3] = p[:, 0]
    t[:, 3:6] = p[:, 1]
    t[:, 6:9] = p[:, 2]
    e1 = p[:, 1] - p[:, 0]
    e2 = p[:, 2] - p[:, 0]
    t[:, 9] = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    t[:, 10] = emissive_tris.astype(np.float32)
    uv = uvs[emissive_tris]
    t[:, 14:16] = uv[:, 0]
    t[:, 16:18] = uv[:, 1]
    t[:, 18:20] = uv[:, 2]
    t[:, 20] = -1.0
    t[:, 21] = -1.0
    for k, ti in enumerate(emissive_tris):
        mat = flat.materials[flat.mat_ids[ti]]
        t[k, 22] = float(int(mat.flags))

        def texel(tex_id, default):
            if tex_id < 0:
                return np.asarray(default, np.float32)
            x0, y0, w, h = tex_rec[tex_id]
            if w == 1 and h == 1:
                return atlas[y0, x0]
            return None  # genuinely textured

        alb = texel(mat.albedo_tex, [1, 1, 1, 1])
        rom = texel(mat.rome_tex, [0.5, 1, 0, 0])
        # flat albedo rgb + flat emission alpha; -1 tex ids mean "use flat"
        if alb is not None:
            t[k, 11:14] = alb[:3]
        else:
            t[k, 20] = float(mat.albedo_tex)
        if rom is not None:
            t[k, 23] = rom[3]
        else:
            t[k, 21] = float(mat.rome_tex)
    return jnp.asarray(t.T)


# ---------------------------------------------------------------------------
# Light grid bake (ref SetupLightGrid :891-1009)
# ---------------------------------------------------------------------------


def _min_dist_to_tris(positions: jnp.ndarray, points: jnp.ndarray) -> jnp.ndarray:
    """Unsigned min distance from each point [G, 3] to any triangle
    (replaces the Embree point query, ref :565-616). Chunked over tris."""
    tri_count = positions.shape[0] // 3
    tris = positions[: tri_count * 3].reshape(tri_count, 3, 3)

    from pim.math.geometry import sd_triangle

    p3 = V3(points[:, 0, None], points[:, 1, None], points[:, 2, None])

    def dist_chunk(carry, tri_chunk):
        def vert(i):
            return V3(tri_chunk[None, :, i, 0], tri_chunk[None, :, i, 1],
                      tri_chunk[None, :, i, 2])

        d = sd_triangle(vert(0), vert(1), vert(2), p3)  # [G, C]
        return jnp.minimum(carry, jnp.min(d, axis=-1)), None

    chunk = 128
    pad = (-tri_count) % chunk
    if pad:
        far = jnp.full((pad, 3, 3), 1e9, jnp.float32)
        tris = jnp.concatenate([tris, far])
    tris = tris.reshape(-1, chunk, 3, 3)
    init = jnp.full((points.shape[0],), jnp.inf, jnp.float32)
    out, _ = jax.lax.scan(dist_chunk, init, tris)
    return out


def bake_light_grid(meta: SceneMeta, arrays: SceneArrays) -> Tuple[jnp.ndarray, LightState]:
    """Visibility-seeded per-cell light distributions (ref :891-1009)."""
    g = meta.grid_len
    e = meta.emissive_count
    grid = meta.grid_spec(arrays.grid_lo)
    radius = (1.0 / meta.cells_per_meter) * 0.666

    centers_aos = grid_position(grid, jnp.arange(g, dtype=jnp.int32))  # [G, 3]

    if e == 0 or meta.tri_count == 0:
        ee = max(e, 1)
        return jnp.zeros((g,), bool), LightState(
            pdf=jnp.zeros((g, ee), jnp.float32),
            cdf=jnp.zeros((g, ee + 1), jnp.float32),
            integral=jnp.zeros((g,), jnp.float32),
            sum=jnp.zeros((g,), jnp.uint32),
            live=jnp.zeros((g, ee), jnp.uint32),
        )

    # interior test
    dists = _min_dist_to_tris(arrays.positions, centers_aos)
    near_surface = dists <= radius
    hu, hv = hammersley_2d(jnp.arange(16, dtype=jnp.uint32), 16)
    hamm = sample_unit_sphere(hu, hv)  # V3 of [16]
    centers = V3.from_aos(centers_aos)
    ro = V3(
        jnp.repeat(centers.x, 16), jnp.repeat(centers.y, 16), jnp.repeat(centers.z, 16)
    )
    rd = V3(
        jnp.tile(hamm.x, g), jnp.tile(hamm.y, g), jnp.tile(hamm.z, g)
    )
    hit = scene_intersect(meta, arrays, ro, rd, 0.0, RCP_EPS)
    hit_ratio = jnp.mean((hit.t >= 0.0).reshape(g, 16).astype(jnp.float32), axis=-1)
    cell_active = near_surface | (hit_ratio >= 0.5)

    # visibility seeding: [G * E * S] rays, chunked over cells so the ray
    # batch stays bounded at map-scale emissive counts (the reference streams
    # the same work through the task pool, :959).  RNG is keyed by the global
    # ray id, so chunked and unchunked bakes are bit-identical.
    s = 16
    from pim.render import fetch as F

    emit_tris = arrays.emit_to_tri_f[0].astype(jnp.int32)  # [E]

    def chunk_pdf(cell_idx: jnp.ndarray) -> jnp.ndarray:
        gc = cell_idx.shape[0]
        ray_id = (cell_idx[:, None] * (e * s)
                  + jnp.arange(e * s, dtype=jnp.int32)).reshape(-1)
        key_state = rng.make_state(ray_id.astype(jnp.uint32), 0, seed=0x11671)
        key_state, (ox, oy, oz, _) = rng.next_f32x4(key_state)
        key_state, (bu, bv) = rng.next_f32x2(key_state)

        def rep(x):
            return jnp.repeat(x[cell_idx], e * s)

        origins = V3(
            rep(centers.x) + (ox * 3.0 - 1.5) * radius,
            rep(centers.y) + (oy * 3.0 - 1.5) * radius,
            rep(centers.z) + (oz * 3.0 - 1.5) * radius,
        )
        tri = jnp.repeat(jnp.tile(emit_tris, (gc,)), s)  # [Gc*E*S]
        rows = F.fetch_cols(arrays.tri_table, tri)
        a = F.v3_rows(rows, F.PA)
        b = F.v3_rows(rows, F.PB)
        c = F.v3_rows(rows, F.PC)
        w_, u_, v_ = sample_bary_coord(bu, bv)
        target = a * w_ + b * u_ + c * v_
        delta = target - origins
        dist = jnp.sqrt(jnp.maximum(dot(delta, delta), 1e-12))
        rd2 = delta * (1.0 / dist)
        blocked = scene_occluded(meta, arrays, origins, rd2, 0.0, dist - 0.01 * MILLI)
        vis = 1.0 - blocked.astype(jnp.float32)
        return jnp.mean(vis.reshape(gc, e, s), axis=-1)

    max_rays = 4 << 20
    gc = max(1, min(g, max_rays // max(e * s, 1)))
    if gc >= g:
        pdf = chunk_pdf(jnp.arange(g, dtype=jnp.int32))
    else:
        # uniform chunk shape (clamped tail indices) -> one compile
        parts = []
        for g0 in range(0, g, gc):
            idx = jnp.clip(jnp.arange(g0, g0 + gc, dtype=jnp.int32), 0, g - 1)
            parts.append(chunk_pdf(idx))
        pdf = jnp.concatenate(parts, axis=0)[:g]
    pdf = pdf * cell_active[:, None].astype(jnp.float32)

    baked = dist1d.bake(pdf)
    return cell_active, LightState(
        pdf=baked.pdf, cdf=baked.cdf, integral=baked.integral,
        sum=baked.sum, live=jnp.zeros((g, e), jnp.uint32),
    )


# ---------------------------------------------------------------------------
# Full build
# ---------------------------------------------------------------------------


def build_scene(
    entities: Entities,
    pool: TexturePool,
    cells_per_meter: Optional[float] = None,
    backend: str = "auto",
    max_leaf: int = 4,
    sky: Optional[np.ndarray] = None,
    media_enabled: bool = False,
    brute_threshold: int = 4096,
) -> Tuple[SceneMeta, SceneArrays, LightState]:
    """Entities + textures -> (meta, device arrays, light state).

    backend: 'auto' takes render/platform.py's rule; 'brute' and 'bvh'
    name an XLA intersector, 'kernel' the traversal kernel."""
    from pim.core.cvars import cv_pt_dist_meters
    from pim.render.bvh_kernel import bvh_depth
    from pim.render.fetch import build_tri_table
    from pim.render.platform import intersect_backend

    if cells_per_meter is None:
        cells_per_meter = 1.0 / cv_pt_dist_meters.get()

    flat = flatten(entities)
    tri_count = flat.mat_ids.shape[0]
    atlas, tex_rec = pool.pack()

    # emissives
    pdfs = _emission_pdf_host(flat, atlas, tex_rec)
    emissive_tris = np.nonzero(pdfs > 0.01)[0].astype(np.int32)
    tri_to_emit = np.full(max(tri_count, 1), -1, np.int32)
    tri_to_emit[emissive_tris] = np.arange(len(emissive_tris), dtype=np.int32)

    if backend == "auto":
        backend = intersect_backend(tri_count, brute_threshold)
    if backend not in ("brute", "bvh", "kernel"):
        raise ValueError(f"unknown intersector backend {backend!r}")
    bvh = build_bvh(flat.positions, max_leaf=max_leaf)

    if tri_count > 0:
        lo = flat.positions.min(axis=0)
        hi = flat.positions.max(axis=0)
    else:
        lo = np.zeros(3, np.float32)
        hi = np.ones(3, np.float32)
    grid = make_grid(lo, hi, cells_per_meter)

    # One-shot LUT bake sized from r_brdflut_spf: the reference converges
    # ~spf samples/frame progressively (lighting.c:86-144, default 10/frame
    # over hundreds of frames); here spf*512 Hammersley samples in one bake
    # reaches the same converged table (4096+ is visually converged).
    from pim.core.cvars import cv_r_brdflut_spf

    lut = bake_brdf_lut(
        num_samples=max(4096, int(cv_r_brdflut_spf.get()) * 512))

    if sky is None:
        # scenes with MatFlag.SKY surfaces are sky scenes even before a
        # cubemap exists: has_sky=True with a 1-texel black cube lets the
        # render system's dirty-checked BakeSky fill arrays.sky on the
        # first frame (ref PtScene_FindSky, path_tracer.c:1011-1041 —
        # previously the mapload path silently rendered skyless, r4)
        sky_arr = jnp.zeros((6, 1, 1, 3), jnp.float32)
        has_sky = any(m.flags & MatFlag.SKY for m in flat.materials)
    else:
        sky_arr = jnp.asarray(sky, jnp.float32)
        has_sky = True

    meta = SceneMeta(
        vert_count=flat.positions.shape[0],
        tri_count=tri_count,
        mat_count=len(flat.materials),
        emissive_count=len(emissive_tris),
        grid_size=grid.size,
        cells_per_meter=float(cells_per_meter),
        backend=backend,
        max_leaf=max_leaf,
        bvh_depth=bvh_depth(bvh.node_a, bvh.node_b),
        has_sky=has_sky,
        has_refractive=any(m.flags & MatFlag.REFRACTIVE for m in flat.materials),
        media_enabled=media_enabled,
        textured=any(
            (m.albedo_tex >= 0 and tuple(tex_rec[m.albedo_tex][2:]) != (1, 1))
            or (m.rome_tex >= 0 and tuple(tex_rec[m.rome_tex][2:]) != (1, 1))
            for m in flat.materials
        ),
        has_normal_maps=any(m.normal_tex >= 0 for m in flat.materials),
    )

    # texture planes: [4, H*W] + transposed records with stride row
    atlas_h, atlas_w = atlas.shape[:2]
    planes = atlas.reshape(-1, 4).T.copy()  # [4, H*W]
    ntex = max(tex_rec.shape[0], 1)
    rec_t = np.zeros((5, ntex), np.float32)
    if tex_rec.shape[0] > 0:
        rec_t[:4] = tex_rec.T.astype(np.float32)
    rec_t[4] = float(atlas_w)

    g = grid_len(grid)
    arrays = SceneArrays(
        positions=jnp.asarray(flat.positions),
        normals=jnp.asarray(flat.normals),
        uvs=jnp.asarray(flat.uvs),
        mat_ids=jnp.asarray(flat.mat_ids),
        tri_table=build_tri_table(flat, flat.materials, tri_to_emit, atlas, tex_rec),
        bvh_lo=jnp.asarray(bvh.node_lo),
        bvh_hi=jnp.asarray(bvh.node_hi),
        bvh_a=jnp.asarray(bvh.node_a),
        bvh_b=jnp.asarray(bvh.node_b),
        tri_order=jnp.asarray(bvh.tri_order),
        atlas_planes=jnp.asarray(planes),
        tex_rec_t=jnp.asarray(rec_t),
        tri_to_emit=jnp.asarray(tri_to_emit[:max(tri_count, 1)]),
        emissive_table=build_emissive_table(flat, atlas, tex_rec, emissive_tris),
        emit_to_tri_f=jnp.asarray(
            emissive_tris.astype(np.float32).reshape(1, -1)
            if len(emissive_tris)
            else np.zeros((1, 1), np.float32)
        ),
        grid_lo=jnp.asarray(grid.lo),
        cell_active=jnp.zeros((g,), bool),
        cell_active_f=jnp.zeros((1, g), jnp.float32),
        brdf_lut=lut.texels,
        sky=sky_arr,
    )

    cell_active, light_state = bake_light_grid(meta, arrays)
    arrays = arrays._replace(
        cell_active=cell_active,
        cell_active_f=cell_active.astype(jnp.float32).reshape(1, -1),
    )

    con_logf(
        LogSev.Info, "scene",
        "built scene: %d tris, %d mats, %d emissives, grid %s (%d cells), backend=%s",
        tri_count, meta.mat_count, meta.emissive_count, meta.grid_size,
        meta.grid_len, backend,
    )
    return meta, arrays, light_state


def update_light_state(state: LightState) -> LightState:
    """Per-frame adaptive fold of the live histograms (ref UpdateDists)."""
    d = dist1d.Dist1D(pdf=state.pdf, cdf=state.cdf, integral=state.integral, sum=state.sum)
    d2, live2 = dist1d.update(d, state.live)
    return LightState(pdf=d2.pdf, cdf=d2.cdf, integral=d2.integral, sum=d2.sum, live=live2)

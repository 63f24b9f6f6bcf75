"""Progressive spherical-gaussian GI lightmaps: charting, packing, baking.

Counterpart of src/rendering/lightmap.{c,h} (1,409 LoC):
- triangles cluster into planar charts (chart_group :451-646 — normal/plane
  thresholds; oversized charts split),
- charts rasterize occupancy and pack into square atlases (:174-283, 680),
- each texel embeds world position/normal (EmbedTaskFn :947),
- a progressive stochastic bake fits 5 spherical gaussians per texel
  (BakeFn :1125-1201): hemisphere rays through the path tracer,
  Roughton running-fit accumulation, per-texel sample counts (resumable).

Redesign: charting/packing are host numpy (one-time, like the ref's
init); the bake is a single jitted wavefront — ALL live texels trace
together through trace_rays (the ref timeslices with random skips; here the
timeslice selects a contiguous texel shard per frame, which on SPMD
hardware is strictly better).  Multi-host: shard the texel axis (config #5
in BASELINE.json).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pim.core import rng
from pim.core.console import LogSev, con_logf
from pim.math.sphgauss import GI_AXII, sg_accumulate
from pim.math.vec3 import V3
from pim.render.integrator import trace_rays
from pim.render.scene import LightState, SceneArrays, SceneMeta


# ---------------------------------------------------------------------------
# Charting + packing (host)
# ---------------------------------------------------------------------------


@dataclass
class Chart:
    tri_ids: np.ndarray     # triangle indices in the flat scene
    normal: np.ndarray      # dominant plane normal
    origin: np.ndarray      # plane origin
    tangent: np.ndarray
    bitangent: np.ndarray
    uv_min: np.ndarray = None
    uv_max: np.ndarray = None
    # atlas placement
    atlas_x: int = 0
    atlas_y: int = 0
    w: int = 0
    h: int = 0


def _build_charts(positions: np.ndarray, normal_thresh: float = 0.707,
                  dist_thresh: float = 1.0, max_tris: int = 4096) -> List[Chart]:
    """Greedy planar clustering (the shape of chart_group :451-646):
    triangles join a chart when their normal and plane offset are close."""
    tri_count = positions.shape[0] // 3
    tris = positions.reshape(tri_count, 3, 3)
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    n = np.cross(e1, e2)
    lens = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.maximum(lens, 1e-12)
    centers = tris.mean(axis=1)
    d = np.sum(n * centers, axis=-1)  # plane offset

    charts: List[Chart] = []
    assigned = np.full(tri_count, -1, np.int64)
    for ti in range(tri_count):
        placed = False
        for ci in range(len(charts) - 1, max(len(charts) - 32, -1), -1):
            ch = charts[ci]
            if len(ch.tri_ids) >= max_tris:
                continue
            if (
                np.dot(ch.normal, n[ti]) >= normal_thresh
                and abs(np.dot(ch.normal, centers[ti]) - np.dot(ch.normal, ch.origin))
                <= dist_thresh
            ):
                ch.tri_ids = np.append(ch.tri_ids, ti)
                assigned[ti] = ci
                placed = True
                break
        if not placed:
            nn = n[ti]
            t = np.cross(nn, [0.0, 1.0, 0.0])
            if np.linalg.norm(t) < 1e-3:
                t = np.cross(nn, [1.0, 0.0, 0.0])
            t = t / np.linalg.norm(t)
            b = np.cross(nn, t)
            charts.append(
                Chart(
                    tri_ids=np.asarray([ti], np.int64), normal=nn,
                    origin=centers[ti].copy(), tangent=t, bitangent=b,
                )
            )
            assigned[ti] = len(charts) - 1
    return charts


class LmPack(NamedTuple):
    """Packed lightmap atlas (ref LmPack, lightmap.h:37-44) + bake state.

    Per-texel device arrays (flat over all atlas texels):
      position [3, T], normal [3, T]  — embedded world attributes
      probes   [T, K, 4]              — SG amplitudes (rgb + running weight)
      sample_counts [T]               — 0 = dead texel, resumable
    """

    size: int                # atlas dimension (square)
    texels_per_meter: float
    position: jnp.ndarray    # [3, T]
    normal: jnp.ndarray      # [3, T]
    probes: jnp.ndarray      # [T, K, 4]
    sample_counts: jnp.ndarray  # [T]
    axii: jnp.ndarray        # [K, 4] world-fixed SG axes


def pack_lightmaps(positions: np.ndarray, normals: np.ndarray,
                   texels_per_meter: float = 4.0,
                   atlas_size: Optional[int] = None,
                   ) -> Optional[LmPack]:
    """Chart + rasterize + embed (ref LmPack_Pack :1047 + EmbedTaskFn :947).

    Returns None when the scene is empty.  Shelf-packs chart bounding boxes
    (the ref packs occupancy masks; bounding boxes trade some atlas waste
    for a fully-vectorizable embed).  ``atlas_size=None`` auto-sizes: the
    smallest power of two (≤1024, the ref's page size lightmap.c:680) whose
    area covers the summed chart rects with 2x slack — keeping the dense
    bake wavefront proportional to live texels, not a fixed page."""
    tri_count = positions.shape[0] // 3
    if tri_count == 0:
        return None
    tris = positions.reshape(tri_count, 3, 3)
    charts = _build_charts(positions)

    # project each chart to its plane, compute texel rects
    for ch in charts:
        pts = tris[ch.tri_ids].reshape(-1, 3) - ch.origin
        u = pts @ ch.tangent
        v = pts @ ch.bitangent
        ch.uv_min = np.asarray([u.min(), v.min()])
        ch.uv_max = np.asarray([u.max(), v.max()])
        ext = ch.uv_max - ch.uv_min
        ch.w = max(int(np.ceil(ext[0] * texels_per_meter)) + 1, 1)
        ch.h = max(int(np.ceil(ext[1] * texels_per_meter)) + 1, 1)

    auto_grow = atlas_size is None
    if auto_grow:
        area = sum(ch.w * ch.h for ch in charts)
        wmax = max(max(ch.w for ch in charts), max(ch.h for ch in charts))
        atlas_size = 32
        while atlas_size < 1024 and (
            atlas_size * atlas_size < 2 * area or atlas_size < wmax
        ):
            atlas_size *= 2

    # shelf pack; on real overflow retry with a doubled atlas (up to the
    # ref's 1024 page, lightmap.c:680) instead of silently dropping charts
    def _shelf_pack(size: int) -> bool:
        order = sorted(range(len(charts)), key=lambda i: -charts[i].h)
        shelf_x = shelf_y = shelf_h = 0
        for ci in order:
            ch = charts[ci]
            if ch.w > size or ch.h > size:
                return False
            if shelf_x + ch.w > size:
                shelf_y += shelf_h
                shelf_x = 0
                shelf_h = 0
            if shelf_y + ch.h > size:
                return False
            ch.atlas_x = shelf_x
            ch.atlas_y = shelf_y
            shelf_x += ch.w
            shelf_h = max(shelf_h, ch.h)
        return True

    while not _shelf_pack(atlas_size):
        if auto_grow and atlas_size < 1024:
            atlas_size *= 2
            continue
        # terminal overflow: clamp oversize charts and pack what fits
        con_logf(LogSev.Warning, "lm", "atlas overflow at %d; clamping charts",
                 atlas_size)
        for ch in charts:
            ch.w = min(ch.w, atlas_size)
            ch.h = min(ch.h, atlas_size)
        order = sorted(range(len(charts)), key=lambda i: -charts[i].h)
        shelf_x = shelf_y = shelf_h = 0
        for ci in order:
            ch = charts[ci]
            if shelf_x + ch.w > atlas_size:
                shelf_y += shelf_h
                shelf_x = 0
                shelf_h = 0
            if shelf_y + ch.h > atlas_size:
                ch.w = ch.h = 0
                continue
            ch.atlas_x = shelf_x
            ch.atlas_y = shelf_y
            shelf_x += ch.w
            shelf_h = max(shelf_h, ch.h)
        break

    # embed world attributes per texel (rasterize chart tris in uv space)
    t = atlas_size * atlas_size
    pos = np.zeros((t, 3), np.float32)
    nrm = np.zeros((t, 3), np.float32)
    counts = np.zeros(t, np.float32)
    mpt = 1.0 / texels_per_meter
    for ch in charts:
        if ch.w == 0:
            continue
        for ti in ch.tri_ids:
            tri = tris[ti]
            tn = np.cross(tri[1] - tri[0], tri[2] - tri[0])
            tl = np.linalg.norm(tn)
            if tl < 1e-12:
                continue
            tn = tn / tl
            # uv coords of the triangle in chart space
            uvs = np.stack(
                [
                    (tri - ch.origin) @ ch.tangent,
                    (tri - ch.origin) @ ch.bitangent,
                ],
                axis=-1,
            )  # [3, 2]
            tex = (uvs - ch.uv_min) * texels_per_meter  # texel coords
            lo = np.maximum(np.floor(tex.min(axis=0)).astype(int), 0)
            hi = np.minimum(
                np.ceil(tex.max(axis=0)).astype(int) + 1,
                np.asarray([ch.w, ch.h]),
            )
            if (hi <= lo).any():
                continue
            xs = np.arange(lo[0], hi[0])
            ys = np.arange(lo[1], hi[1])
            gx, gy = np.meshgrid(xs, ys, indexing="xy")
            px = gx.ravel() + 0.5
            py = gy.ravel() + 0.5
            # barycentric test in texel space
            a2 = tex[1] - tex[0]
            b2 = tex[2] - tex[0]
            den = a2[0] * b2[1] - a2[1] * b2[0]
            if abs(den) < 1e-12:
                continue
            qx = px - tex[0, 0]
            qy = py - tex[0, 1]
            wu = (qx * b2[1] - qy * b2[0]) / den
            wv = (qy * a2[0] - qx * a2[1]) / den
            # half-texel tolerance keeps seams lit (ref rasterizes w/ padding)
            tol = 0.75
            inside = (wu >= -tol) & (wv >= -tol) & (wu + wv <= 1.0 + tol)
            if not inside.any():
                continue
            wuc = np.clip(wu[inside], 0.0, 1.0)
            wvc = np.clip(wv[inside], 0.0, 1.0)
            ws = np.clip(1.0 - wuc - wvc, 0.0, 1.0)
            norm = np.maximum(ws + wuc + wvc, 1e-6)
            world = (
                ws[:, None] * tri[0]
                + wuc[:, None] * tri[1]
                + wvc[:, None] * tri[2]
            ) / norm[:, None]
            ax = gx.ravel()[inside] + ch.atlas_x
            ay = gy.ravel()[inside] + ch.atlas_y
            idx = ay * atlas_size + ax
            pos[idx] = world
            nrm[idx] = tn
            counts[idx] = np.maximum(counts[idx], 1.0)

    k = GI_AXII.shape[0]
    live = int((counts > 0).sum())
    con_logf(
        LogSev.Info, "lm",
        "packed %d charts, %d/%d live texels (%.1f%%)",
        len(charts), live, t, 100.0 * live / t,
    )
    return LmPack(
        size=atlas_size,
        texels_per_meter=texels_per_meter,
        position=jnp.asarray(pos.T),
        normal=jnp.asarray(nrm.T),
        probes=jnp.zeros((t, k, 4), jnp.float32),
        sample_counts=jnp.asarray(counts),
        axii=jnp.asarray(GI_AXII),
    )


# ---------------------------------------------------------------------------
# Progressive bake (device)
# ---------------------------------------------------------------------------


import functools as _functools


@_functools.partial(jax.jit, static_argnums=(0,),
                    static_argnames=("max_bounces", "texel_offset",
                                     "texel_count"))
def bake_step(meta: SceneMeta, arrays: SceneArrays, lights: LightState,
              pack: LmPack, frame, max_bounces: int = 4,
              texel_offset: int = 0, texel_count: Optional[int] = None):
    """One progressive bake pass over a texel shard (ref BakeFn :1125-1201).
    Jitted (meta/shard bounds static): repeated bake passes reuse one
    compilation per (shape, offset) instead of retracing eagerly.

    Per live texel: jitter the origin inside the texel footprint, sample a
    uniform hemisphere direction about the embedded normal, trace, and fold
    the radiance into the texel's SG probes with weight 1/sampleCount.
    Returns an updated LmPack.  Dead texels trace but accumulate nothing
    (masked — the wavefront stays dense).
    """
    from pim.math.sampling import normal_to_tbn, sample_unit_hemisphere

    t_total = pack.position.shape[1]
    if texel_count is None:
        texel_count = t_total
    sl = slice(texel_offset, texel_offset + texel_count)

    pos = V3(pack.position[0, sl], pack.position[1, sl], pack.position[2, sl])
    nrm = V3(pack.normal[0, sl], pack.normal[1, sl], pack.normal[2, sl])
    counts = pack.sample_counts[sl]
    probes = pack.probes[sl]
    alive = counts > 0.0

    texel_ids = jnp.arange(texel_count, dtype=jnp.uint32) + texel_offset
    state = rng.make_state(texel_ids, jnp.uint32(frame), seed=0x1A57)

    # TBN about the embedded normal; guard dead texels with +Z
    safe_n = V3(
        jnp.where(alive, nrm.x, 0.0),
        jnp.where(alive, nrm.y, 0.0),
        jnp.where(alive, nrm.z, 1.0),
    )
    tan, bit = normal_to_tbn(safe_n)

    state, (hu, hv) = rng.next_f32x2(state)
    l_ts = sample_unit_hemisphere(hu, hv)
    rd = tan * l_ts.x + bit * l_ts.y + safe_n * l_ts.z

    mpt = 1.0 / pack.texels_per_meter
    state, (ju, jv) = rng.next_f32x2(state)
    ro = (
        pos + safe_n * 1e-3
        + tan * ((ju - 0.5) * mpt)
        + bit * ((jv - 0.5) * mpt)
    )

    result = trace_rays(meta, arrays, lights, ro, rd, state, max_bounces)
    radiance = result.color  # [T, 3] AoS at the edge

    # world-space SG axes per texel: rotate the canonical axes by TBN
    axes = pack.axii  # [K, 4]
    ax_ts = axes[:, :3]  # [K, 3] tangent-space axis dirs
    # axis_world[t, k] = tan*ax.x + bit*ax.y + n*ax.z
    axw_x = (
        tan.x[:, None] * ax_ts[None, :, 0]
        + bit.x[:, None] * ax_ts[None, :, 1]
        + safe_n.x[:, None] * ax_ts[None, :, 2]
    )
    axw_y = (
        tan.y[:, None] * ax_ts[None, :, 0]
        + bit.y[:, None] * ax_ts[None, :, 1]
        + safe_n.y[:, None] * ax_ts[None, :, 2]
    )
    axw_z = (
        tan.z[:, None] * ax_ts[None, :, 0]
        + bit.z[:, None] * ax_ts[None, :, 1]
        + safe_n.z[:, None] * ax_ts[None, :, 2]
    )

    # per-texel SG accumulate (Roughton running fit; sphgauss.py)
    sharp = axes[:, 3]  # [K]
    rd_aos = jnp.stack([rd.x, rd.y, rd.z], axis=-1)  # [T, 3]
    cos_t = (
        axw_x * rd.x[:, None] + axw_y * rd.y[:, None] + axw_z * rd.z[:, None]
    )  # [T, K]
    basis = jnp.exp(sharp[None, :] * (cos_t - 1.0))
    sw = jnp.where(alive, 1.0 / jnp.maximum(counts, 1.0), 0.0)

    amp_rgb = probes[..., :3]
    weight = probes[..., 3]
    estimate = jnp.sum(amp_rgb * basis[..., None], axis=-2)  # [T, 3]
    new_weight = weight + (basis - weight) * sw[:, None]
    other = estimate[:, None, :] - amp_rgb * basis[..., None]
    this_lobe = (radiance[:, None, :] - other) * (
        basis / jnp.maximum(new_weight, 1e-6)
    )[..., None]
    new_rgb = amp_rgb + (this_lobe - amp_rgb) * sw[:, None, None]
    new_rgb = jnp.maximum(new_rgb, 0.0)
    active = (basis > 0.0) & alive[:, None]
    out_rgb = jnp.where(active[..., None], new_rgb, amp_rgb)
    out_w = jnp.where(active, new_weight, weight)
    new_probes = jnp.concatenate([out_rgb, out_w[..., None]], axis=-1)

    new_counts = counts + alive.astype(jnp.float32)
    return pack._replace(
        probes=pack.probes.at[sl].set(new_probes),
        sample_counts=pack.sample_counts.at[sl].set(new_counts),
    )


def lightmap_irradiance(pack: LmPack, normal: jnp.ndarray) -> jnp.ndarray:
    """Evaluate baked SG probes for display (ref SGv_Irradiance usage in
    brush.hlsl / GI.hlsl).  normal [T, 3] (usually the embedded normals) ->
    irradiance [T, 3]."""
    from pim.math.sphgauss import sg_irradiance

    return sg_irradiance(pack.axii, pack.probes, normal)


# ---------------------------------------------------------------------------
# Crate persistence (resumable bake; ref LmPack_Save/Load :1225+)
# ---------------------------------------------------------------------------


def lmpack_to_crate_entry(pack: LmPack) -> dict:
    return {
        "version": 2,  # kLmPackVersion
        "size": pack.size,
        "texels_per_meter": pack.texels_per_meter,
        "position": np.asarray(pack.position),
        "normal": np.asarray(pack.normal),
        "probes": np.asarray(pack.probes),
        "sample_counts": np.asarray(pack.sample_counts),
        "axii": np.asarray(pack.axii),
    }


def lmpack_from_crate_entry(entry: dict) -> LmPack:
    return LmPack(
        size=int(entry["size"]),
        texels_per_meter=float(entry["texels_per_meter"]),
        position=jnp.asarray(entry["position"]),
        normal=jnp.asarray(entry["normal"]),
        probes=jnp.asarray(entry["probes"]),
        sample_counts=jnp.asarray(entry["sample_counts"]),
        axii=jnp.asarray(entry["axii"]),
    )

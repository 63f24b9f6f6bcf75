"""Reference-parity oracle: a slow numpy transliteration of Pt_TraceRay.

This is a TEST FIXTURE, not framework code.  It mirrors the reference
integrator's math line-by-line (citations below are into the reference's sources):

  - trace loop / RR / emission gating   path_tracer.c:2306-2420 (Pt_TraceRay)
  - principled BSDF eval + scatter      path_tracer.c:1475-1727
  - NEE + MIS strategy selection        path_tracer.c:1849-1919 (EstimateDirect)
  - light sampling + pdfs               path_tracer.c:1784-1847
  - BRDF formulas                       math/lighting.h:57-307
  - BRDF energy-compensation LUT bake   math/lighting.c:40-144
  - sampling routines                   math/sampling.h:26-340
  - emission packing                    math/color.h:582-591 (kEmissionScale=100)

It uses its OWN sampling strategies and RNG (uniform light selection instead
of the adaptive grid, numpy Generator streams), so it is an independent
unbiased estimator of the same rendering equation: converged images must
agree with the framework integrator within Monte-Carlo tolerance.

Scope: flat (1x1) OR textured materials (bilinear-wrap sampler parity,
sampler.h:176-249), optional sky cubemap (GetSky/SampleSkyTex parity —
misses return sky radiance, MatFlag.SKY surfaces emit it and act as NEE
lights), normal maps (SampleNormal, path_tracer.c:1363-1375), and
refractive surfaces (Scatter_Refractive, path_tracer.c:1576-1638 — GGX
dielectric with Beer-Lambert interior transmittance, full-weight emission
on refractive chains).  Media remains out of scope (the framework's
trace_brute arbiter covers it, tests/test_media.py).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

EPS = 1.0 / ((1 << 23) - 1)             # kEpsilon, scalar.h:26
EPS_SQ = 1.0 / ((1 << 46) - 1)          # kEpsilonSq
MIN_ALPHA = 1.0 / (1 << 10)             # kMinAlpha, lighting.h:36-39
EMISSION_SCALE = 100.0                  # r_config.h:113
BIG = 1.0 / EPS                         # kRcpEpsilon
PI = np.pi
TAU = 2.0 * np.pi


# ---------------------------------------------------------------------------
# vector helpers ([..., 3] float64 arrays)
# ---------------------------------------------------------------------------

def dot(a, b):
    return np.sum(a * b, axis=-1)


def normalize(v):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-30)


def reflect(i, n):
    return i - 2.0 * dot(i, n)[..., None] * n


def avglum(c):  # f4_avglum: mean of rgb
    return np.mean(c[..., :3], axis=-1)


def normal_to_tbn(n):
    """Duff et al. orthonormal basis (sampling.h:26-60). n: [N,3] ->
    (t, b) each [N,3] with the convention TBN.c0=t, c1=b, c2=n."""
    s = np.where(n[..., 2] < 0.0, -1.0, 1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    b1 = np.stack(
        [1.0 + s * n[..., 0] * n[..., 0] * a, s * b, -s * n[..., 0]], axis=-1
    )
    b2 = np.stack([b, s + n[..., 1] * n[..., 1] * a, -n[..., 1]], axis=-1)
    return b1, b2


def tan_to_world(n, v_ts):
    t, b = normal_to_tbn(n)
    return (
        t * v_ts[..., 0:1] + b * v_ts[..., 1:2] + n * v_ts[..., 2:3]
    )


def spherical_to_cartesian(cos_theta, phi):
    sin_theta = np.sqrt(np.maximum(1.0 - cos_theta * cos_theta, 0.0))
    return np.stack(
        [sin_theta * np.cos(phi), sin_theta * np.sin(phi), cos_theta], axis=-1
    )


# ---------------------------------------------------------------------------
# sampling (sampling.h)
# ---------------------------------------------------------------------------

def map_square_to_disk(xi):
    """sampling.h:100-119 (concentric map)."""
    xi = EPS + (1.0 - 2.0 * EPS) * xi
    a = 2.0 * xi[..., 0] - 1.0
    b = 2.0 * xi[..., 1] - 1.0
    use_a = a * a > b * b
    r = np.where(use_a, a, b)
    phi = np.where(
        use_a,
        (PI / 4.0) * np.divide(b, np.where(a == 0, 1.0, a)),
        (PI / 2.0) - (PI / 4.0) * np.divide(a, np.where(b == 0, 1.0, b)),
    )
    return np.stack([r * np.cos(phi), r * np.sin(phi)], axis=-1)


def sample_cosine_hemisphere(xi):
    """sampling.h:271-276."""
    d = map_square_to_disk(xi)
    z = np.sqrt(np.maximum(1.0 - np.sum(d * d, axis=-1), EPS_SQ))
    return np.concatenate([d, z[..., None]], axis=-1)


def sample_ggx_microfacet(xi, alpha):
    """sampling.h:280-287."""
    a2 = alpha * alpha
    phi = TAU * xi[..., 0]
    b = np.maximum(1.0 + (a2 - 1.0) * xi[..., 1], EPS)
    cos_theta = np.sqrt(np.maximum((1.0 - xi[..., 1]) / b, EPS_SQ))
    return spherical_to_cartesian(cos_theta, phi)


def sample_bary_coord(xi):
    """sampling.h:120-128. Returns (w, u, v)."""
    r1 = np.sqrt(np.maximum(xi[..., 0], EPS_SQ))
    r2 = xi[..., 1]
    u = r1 * (1.0 - r2)
    v = r2 * r1
    return 1.0 - (u + v), u, v


def power_heuristic(f, g):
    """sampling.h:93-95."""
    return (f * f) / np.maximum(f * f + g * g, EPS)


def light_pdf(area, cos_theta, dist_sq):
    """sampling.h:321-325."""
    return dist_sq / np.maximum(cos_theta * area, EPS)


def lambert_pdf(nol):
    return nol * (1.0 / PI)


# ---------------------------------------------------------------------------
# BRDF (lighting.h)
# ---------------------------------------------------------------------------

def brdf_alpha(roughness):
    return np.maximum(roughness * roughness, MIN_ALPHA)


def f_0(albedo, metallic):
    return 0.04 + (albedo - 0.04) * metallic[..., None]


def f_90(f0):
    return np.clip(50.0 * dot(f0, np.full_like(f0, 0.33)), 0.0, 1.0)


def f_schlick1(f0, f90, cos_theta):
    t = (1.0 - cos_theta) ** 5
    return f0 + (f90 - f0) * t


def f_dielectric(cos_i, eta_i, eta_t):
    """lighting.h:138-162 (vectorized; handles transmission sign)."""
    cos_i = np.clip(cos_i, -1.0, 1.0)
    swap = cos_i < 0.0
    ei = np.where(swap, eta_t, eta_i)
    et = np.where(swap, eta_i, eta_t)
    ci = np.abs(cos_i)
    si = np.sqrt(np.maximum(1.0 - ci * ci, EPS_SQ))
    st = (ei / et) * si
    tir = st >= 1.0
    ct = np.sqrt(np.maximum(1.0 - st * st, EPS_SQ))
    rparl = (et * ci - ei * ct) / (et * ci + ei * ct)
    rperp = (ei * ci - et * ct) / (ei * ci + et * ct)
    f = np.clip(0.5 * (rparl * rparl + rperp * rperp), 0.0, 1.0)
    return np.where(tir, 1.0, f)


def d_gtr(noh, alpha):
    a2 = alpha * alpha
    f = 1.0 + (a2 - 1.0) * noh * noh
    return a2 / np.maximum(f * f * PI, EPS)


def v_smith_correlated(nol, nov, alpha):
    a2 = alpha * alpha
    v = nol * np.sqrt(np.maximum(a2 + (nov - nov * a2) * nov, EPS_SQ))
    l = nov * np.sqrt(np.maximum(a2 + (nol - nol * a2) * nol, EPS_SQ))
    return 0.5 / np.maximum(v + l, EPS)


def fd_burley(nol, nov, hov, roughness):
    fd90 = 0.5 + 2.0 * hov * hov * roughness
    return f_schlick1(1.0, fd90, nol) * f_schlick1(1.0, fd90, nov) / PI


def ggx_pdf(noh, hov, alpha):
    return d_gtr(noh, alpha) * noh / np.maximum(4.0 * hov, EPS)


# --- BRDF LUT (energy compensation), own MC bake (lighting.c:40-144) -------

_LUT_N = 32
_LUT_CACHE = os.path.join(os.path.dirname(__file__), "_brdf_lut_cache.npz")


def _bake_lut(n=_LUT_N, spp=4096, seed=7, chunk=256):
    rng = np.random.default_rng(seed)
    nov = np.clip((np.arange(n) + 0.5) / n, EPS, 1.0 - EPS)
    alpha = np.clip((np.arange(n) + 0.5) / n, MIN_ALPHA, 1.0)
    novg, alg = np.meshgrid(nov, alpha, indexing="xy")  # [a, nov]
    novg = novg.ravel()[:, None]
    alg = alg.ravel()[:, None]
    dvf = np.zeros(novg.shape[0])
    dv = np.zeros(novg.shape[0])
    for s0 in range(0, spp, chunk):
        c = min(chunk, spp - s0)
        v = spherical_to_cartesian(
            np.broadcast_to(novg, (novg.shape[0], c)),
            rng.random((novg.shape[0], c)) * TAU,
        )
        xi = rng.random((novg.shape[0], c, 2))
        h = sample_ggx_microfacet(xi, alg)  # alg [N,1] broadcasts vs [N,c]
        l = reflect(-v, h)
        nol = l[..., 2]
        noh = h[..., 2]
        hov = dot(h, v)
        pdf = ggx_pdf(noh, hov, alg)
        ok = (nol > EPS) & (pdf > EPS)
        d = np.where(ok, d_gtr(noh, alg) / np.maximum(pdf, EPS), 0.0)
        g = v_smith_correlated(np.maximum(nol, 0), novg, alg)
        fc = f_dielectric(hov, 1.000293, 1.52)
        dg_nol = np.where(ok, d * g * nol, 0.0)
        dvf += np.sum(dg_nol * fc, axis=-1)
        dv += np.sum(dg_nol, axis=-1)
    return (dvf / spp).reshape(n, n), (dv / spp).reshape(n, n)  # [alpha, nov]


def _get_lut():
    if os.path.exists(_LUT_CACHE):
        z = np.load(_LUT_CACHE)
        return z["dvf"], z["dv"]
    dvf, dv = _bake_lut()
    np.savez(_LUT_CACHE, dvf=dvf, dv=dv)
    return dvf, dv


def _lut_sample(nov, alpha):
    """Bilinear clamp fetch (lighting.h:52-55, uv=(NoV, alpha))."""
    dvf, dv = _get_lut()
    n = _LUT_N
    x = np.clip(nov * n - 0.5, 0.0, n - 1.0)
    y = np.clip(alpha * n - 0.5, 0.0, n - 1.0)
    x0 = np.floor(x).astype(int)
    y0 = np.floor(y).astype(int)
    x1 = np.minimum(x0 + 1, n - 1)
    y1 = np.minimum(y0 + 1, n - 1)
    fx = x - x0
    fy = y - y0

    def bil(t):
        return (
            t[y0, x0] * (1 - fy) * (1 - fx) + t[y0, x1] * (1 - fy) * fx
            + t[y1, x0] * fy * (1 - fx) + t[y1, x1] * fy * fx
        )

    return bil(dvf), bil(dv)


def ggx_energy_compensation(f0, nov, alpha):
    """lighting.h:294-307: 1 + f0 * (1/dv - 1)."""
    _dvf, dv = _lut_sample(nov, alpha)
    t = 1.0 / np.maximum(dv, EPS) - 1.0
    return 1.0 + f0 * t[..., None]


# ---------------------------------------------------------------------------
# scene
# ---------------------------------------------------------------------------

class OracleScene(NamedTuple):
    positions: np.ndarray   # [V, 3] f64
    normals: np.ndarray     # [V, 3]
    albedo: np.ndarray      # [T, 4] flat per-tri
    rome: np.ndarray        # [T, 4]
    flags: np.ndarray       # [T] i32
    ior: np.ndarray         # [T]
    areas: np.ndarray       # [T]
    emissive: np.ndarray    # [E] tri indices
    # --- textured + sky scope (BASELINE configs #3/#4) ---------------------
    uvs: np.ndarray = None         # [V, 2] f64 (None = untextured scene)
    albedo_tex: np.ndarray = None  # [T] i32 texture index (-1 = flat)
    rome_tex: np.ndarray = None    # [T] i32
    normal_tex: np.ndarray = None  # [T] i32 (-1 = no normal map)
    textures: tuple = ()           # per-index [H, W, 4] f64 images
    sky: np.ndarray = None         # [6, S, S, 3] f64 cubemap (None = black)


def scene_from_entities(entities, pool, sky=None) -> OracleScene:
    """Flatten entities into the oracle's per-triangle soup.  1x1 textures
    fold into flat per-tri albedo/rome; larger ones ride the bilinear-wrap
    sampler (sampler.h:176-249).  `sky` ([6,S,S,3]) enables the cubemap
    scope: misses return sky radiance and MatFlag.SKY surfaces emit it
    (GetSky/GetEmission, path_tracer.c:1247-1326)."""
    from pim.geom.entities import flatten
    from pim.geom.material import MatFlag

    f = flatten(entities)
    t = f.mat_ids.shape[0]
    albedo = np.ones((t, 4))
    rome = np.tile(np.array([0.5, 1.0, 0.0, 0.0]), (t, 1))
    flags = np.zeros(t, np.int32)
    ior = np.ones(t)
    albedo_tex = np.full(t, -1, np.int32)
    rome_tex = np.full(t, -1, np.int32)
    normal_tex = np.full(t, -1, np.int32)
    textures = [np.asarray(pool.get(i), np.float64) for i in range(len(pool))]
    for i, mid in enumerate(f.mat_ids):
        mat = f.materials[mid]
        if mat.albedo_tex >= 0:
            img = textures[mat.albedo_tex]
            if img.shape[:2] == (1, 1):
                albedo[i] = img[0, 0]
            else:
                albedo_tex[i] = mat.albedo_tex
        if mat.rome_tex >= 0:
            img = textures[mat.rome_tex]
            if img.shape[:2] == (1, 1):
                rome[i] = img[0, 0]
            else:
                rome_tex[i] = mat.rome_tex
        if mat.normal_tex >= 0 and textures[mat.normal_tex].shape[:2] != (1, 1):
            normal_tex[i] = mat.normal_tex
        flags[i] = int(mat.flags)
        ior[i] = mat.ior
    pos = f.positions.astype(np.float64)
    a = pos[0::3]
    b = pos[1::3]
    c = pos[2::3]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)
    # lights: emissive rome alpha OR sky panels (the framework's emissive
    # detection marks MatFlag.SKY tris pdf=1, scene.py SetupEmissives)
    tex_emissive = np.zeros(t, bool)
    for i in range(t):
        if rome_tex[i] >= 0:
            tex_emissive[i] = textures[rome_tex[i]][..., 3].max() > 0.0
    is_sky = (flags & int(MatFlag.SKY)) != 0
    emissive = np.nonzero((rome[:, 3] > 0.0) | tex_emissive
                          | (is_sky if sky is not None else False))[0]
    return OracleScene(
        positions=pos, normals=f.normals.astype(np.float64),
        albedo=albedo, rome=rome, flags=flags, ior=ior,
        areas=areas, emissive=emissive,
        uvs=f.uvs.astype(np.float64),
        albedo_tex=albedo_tex, rome_tex=rome_tex, normal_tex=normal_tex,
        textures=tuple(textures),
        sky=None if sky is None else np.asarray(sky, np.float64),
    )


def uv_bilinear_wrap(img, uv):
    """CPU bilinear sampler parity (sampler.h:176-249 UvBilinearWrap):
    negative-mirror wrap `u = (u >= 0) ? u : 1 - u; frac`, corner at
    min(x0+1, w-1).  img [H, W, 4], uv [N, 2] -> [N, 4]."""
    h, w = img.shape[:2]
    u = uv[:, 0]
    v = uv[:, 1]
    u = np.where(u >= 0.0, u, 1.0 - u)
    v = np.where(v >= 0.0, v, 1.0 - v)
    u = u - np.floor(u)
    v = v - np.floor(v)
    fx = u * max(w - 1, 0)
    fy = v * max(h - 1, 0)
    x0 = np.floor(fx).astype(np.int64)
    y0 = np.floor(fy).astype(np.int64)
    tx = (fx - x0)[:, None]
    ty = (fy - y0)[:, None]
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    t00 = img[y0, x0]
    t10 = img[y0, x1]
    t01 = img[y1, x0]
    t11 = img[y1, x1]
    top = t00 + (t10 - t00) * tx
    bot = t01 + (t11 - t01) * tx
    return top + (bot - top) * ty


def _tri_uv(scene, tri, w, u, v):
    iv = tri * 3
    return (
        scene.uvs[iv] * w[:, None] + scene.uvs[iv + 1] * u[:, None]
        + scene.uvs[iv + 2] * v[:, None]
    )


def _fetch_material(scene, tri, w, u, v):
    """Per-hit (albedo [N,4], rome [N,4]) honoring textured tris."""
    albedo = scene.albedo[tri].copy()
    rome = scene.rome[tri].copy()
    if scene.uvs is None or scene.albedo_tex is None:
        return albedo, rome
    a_tex = scene.albedo_tex[tri]
    r_tex = scene.rome_tex[tri]
    if (a_tex >= 0).any() or (r_tex >= 0).any():
        uv = _tri_uv(scene, tri, w, u, v)
        for ti, img in enumerate(scene.textures):
            sel_a = np.nonzero(a_tex == ti)[0]
            if sel_a.size:
                albedo[sel_a] = uv_bilinear_wrap(img, uv[sel_a])
            sel_r = np.nonzero(r_tex == ti)[0]
            if sel_r.size:
                rome[sel_r] = uv_bilinear_wrap(img, uv[sel_r])
    return albedo, rome


# cubemap face bases (parity with render/sky.py _FORWARDS/_RIGHTS/_UPS,
# itself Cubemap_CalcUv, cubemap.h:71-100)
_CUBE_FORWARD = np.array([
    [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
], np.float64)
_CUBE_RIGHT = np.array([
    [0, 0, -1], [0, 0, 1], [1, 0, 0], [-1, 0, 0], [1, 0, 0], [-1, 0, 0],
], np.float64)
_CUBE_UP = np.array([
    [0, 1, 0], [0, 1, 0], [0, 0, -1], [0, 0, -1], [0, 1, 0], [0, 1, 0],
], np.float64)


def sample_sky(scene, dirs):
    """Bilinear-clamp cubemap fetch (Cubemap_Read parity).  dirs [N, 3]
    -> [N, 3]; zeros when the scene has no sky."""
    if scene.sky is None:
        return np.zeros((dirs.shape[0], 3))
    cube = scene.sky
    size = cube.shape[1]
    ad = np.abs(dirs)
    vmax = ad.max(axis=-1)
    ma = 0.5 / np.maximum(vmax, EPS)
    is_x = vmax == ad[:, 0]
    is_y = (~is_x) & (vmax == ad[:, 1])
    face = np.where(
        is_x, np.where(dirs[:, 0] < 0, 1, 0),
        np.where(is_y, np.where(dirs[:, 1] < 0, 3, 2),
                 np.where(dirs[:, 2] < 0, 5, 4)))
    r = _CUBE_RIGHT[face]
    up = _CUBE_UP[face]
    u = np.sum(r * dirs, -1) * ma + 0.5
    v = np.sum(up * dirs, -1) * ma + 0.5
    fx = np.clip(u, 0.0, 1.0) * (size - 1)
    fy = np.clip(v, 0.0, 1.0) * (size - 1)
    x0 = np.floor(fx).astype(np.int64)
    y0 = np.floor(fy).astype(np.int64)
    x1 = np.minimum(x0 + 1, size - 1)
    y1 = np.minimum(y0 + 1, size - 1)
    tx = (fx - x0)[:, None]
    ty = (fy - y0)[:, None]
    t00 = cube[face, y0, x0]
    t10 = cube[face, y0, x1]
    t01 = cube[face, y1, x0]
    t11 = cube[face, y1, x1]
    top = t00 + (t10 - t00) * tx
    bot = t01 + (t11 - t01) * tx
    return top + (bot - top) * ty


def _emission_at(scene, tri, albedo, rome, rd):
    """Emission of a surface point: UnpackEmission, with MatFlag.SKY
    overridden by the cubemap along the incoming direction (GetEmission
    parity, path_tracer.c:1293-1326)."""
    e = albedo[:, :3] * (rome[:, 3] ** 2 * EMISSION_SCALE)[:, None]
    if scene.sky is not None:
        sky_f = (scene.flags[tri] & SKY) != 0
        if sky_f.any():
            e = np.where(sky_f[:, None], sample_sky(scene, rd), e)
    return e


def intersect(scene: OracleScene, ro, rd, t_max):
    """Brute-force Möller-Trumbore closest hit. ro/rd [N,3], t_max [N].
    Returns (t [N] (<0 = miss), tri [N], w/u/v bary, geom normal [N,3])."""
    pos = scene.positions
    a = pos[0::3][None]          # [1, T, 3]
    e1 = (pos[1::3] - pos[0::3])[None]
    e2 = (pos[2::3] - pos[0::3])[None]
    ro_ = ro[:, None]
    rd_ = rd[:, None]
    pvec = np.cross(rd_, e2)
    det = np.sum(e1 * pvec, axis=-1)
    inv = np.where(np.abs(det) > 1e-18, 1.0 / np.where(det == 0, 1, det), 0.0)
    tvec = ro_ - a
    u = np.sum(tvec * pvec, axis=-1) * inv
    qvec = np.cross(tvec, e1)
    v = np.sum(rd_ * qvec, axis=-1) * inv
    t = np.sum(e2 * qvec, axis=-1) * inv
    ok = (
        (np.abs(det) > 1e-18) & (u >= 0) & (v >= 0) & (u + v <= 1)
        & (t > 1e-7) & (t <= t_max[:, None])
    )
    t = np.where(ok, t, np.inf)
    tri = np.argmin(t, axis=-1)
    rows = np.arange(ro.shape[0])
    t_hit = t[rows, tri]
    miss = ~np.isfinite(t_hit)
    u_hit = np.clip(u[rows, tri], 0.0, 1.0)
    v_hit = np.clip(v[rows, tri], 0.0, 1.0)
    w_hit = np.clip(1.0 - u_hit - v_hit, 0.0, 1.0)
    ng = normalize(np.cross(e1[0][tri], e2[0][tri]))
    return (
        np.where(miss, -1.0, t_hit), np.where(miss, -1, tri),
        w_hit, u_hit, v_hit, ng,
    )


def occluded_same_tri(scene, ro, rd, dist, target_tri):
    """SampleLight's visibility test (path_tracer.c:1812-1814): the shadow
    ray must hit exactly the chosen light triangle."""
    t, tri, *_ , ng = intersect(scene, ro, rd, dist + 0.01e-3)
    return (t >= 0) & (tri == target_tri), ng, t


class Surf(NamedTuple):
    p: np.ndarray
    m: np.ndarray          # geometric-ish normal (GetNormal)
    n: np.ndarray          # shading normal (normal-mapped when present)
    albedo: np.ndarray     # [N, 4]
    rome: np.ndarray
    emission: np.ndarray   # [N, 3]
    flags: np.ndarray
    ior: np.ndarray
    backface: np.ndarray   # [N] bool (PtHit_Backface)


def fix_shading_normal(m, n):
    """FixShadingNormal (path_tracer.c:1355-1360)."""
    return np.where(dot(m, n)[:, None] > 0.0, n, reflect(n, m))


def get_surface(scene, tri, w, u, v, rd, ng):
    """GetSurface (path_tracer.c:1377-1418) incl. SampleNormal
    (:1363-1375)."""
    iv = tri * 3
    pos = scene.positions
    p = (
        pos[iv] * w[:, None] + pos[iv + 1] * u[:, None] + pos[iv + 2] * v[:, None]
    )
    nrm = scene.normals
    n = (
        nrm[iv] * w[:, None] + nrm[iv + 1] * u[:, None] + nrm[iv + 2] * v[:, None]
    )
    # GetNormal flips interpolated N to the geometric hemisphere (:1202);
    # hit.normal is the geometric normal flipped against rd (:1441-1446)
    ng_f = np.where(dot(ng, rd)[:, None] > 0.0, -ng, ng)
    n = np.where(dot(ng_f, n)[:, None] > 0.0, n, -n)
    n = normalize(n)
    p = p + n * (0.01e-3)  # :1394
    m = n
    if scene.normal_tex is not None and (scene.normal_tex[tri] >= 0).any():
        # SampleNormal: tangent-space xy from the map, z reconstructed —
        # mirrors the framework decode (surface.get_surface): the oracle
        # and framework must sample the SAME stored channels
        nm_tex = scene.normal_tex[tri]
        uv = _tri_uv(scene, tri, w, u, v)
        n = n.copy()
        for ti, img in enumerate(scene.textures):
            sel = np.nonzero(nm_tex == ti)[0]
            if not sel.size:
                continue
            nm = uv_bilinear_wrap(img, uv[sel])
            nz = np.sqrt(np.maximum(
                1.0 - (nm[:, 0] ** 2 + nm[:, 1] ** 2), 1e-6))
            nts = np.stack([nm[:, 0], nm[:, 1], nz], axis=-1)
            n[sel] = fix_shading_normal(m[sel], tan_to_world(m[sel], nts))
    albedo, rome = _fetch_material(scene, tri, w, u, v)
    emission = _emission_at(scene, tri, albedo, rome, rd)
    backface = dot(ng, rd) > 0.0
    return Surf(
        p=p, m=m, n=n, albedo=albedo, rome=rome, emission=emission,
        flags=scene.flags[tri], ior=scene.ior[tri], backface=backface,
    )


# ---------------------------------------------------------------------------
# BSDF eval/scatter (path_tracer.c:1475-1727)
# ---------------------------------------------------------------------------

def eval_diffuse(surf, i_dir, l):
    nol = dot(surf.n, l)
    pdf = lambert_pdf(nol)
    v = -i_dir
    h = normalize(v + l)
    hov = np.clip(dot(h, v), 0.0, 1.0)
    nov = np.clip(dot(surf.n, v), 0.0, 1.0)
    fd = surf.albedo[:, :3] * fd_burley(nol, nov, hov, surf.rome[:, 0])[:, None]
    atten = fd * nol[:, None]
    ok = pdf > EPS
    return np.where(ok[:, None], atten, 0.0), np.where(ok, pdf, 0.0)


def eval_specular(surf, i_dir, l):
    n = surf.n
    nol = dot(n, l)
    alpha = brdf_alpha(surf.rome[:, 0])
    v = -i_dir
    h = normalize(v + l)
    noh = dot(n, h)
    hov = dot(h, v)
    pdf = ggx_pdf(noh, hov, alpha)
    nov = np.clip(dot(n, v), 0.0, 1.0)
    f = f_dielectric(hov, 1.0, 1.5)
    f0 = f_0(surf.albedo[:, :3], surf.rome[:, 2])
    fr90 = f_90(f0)
    fcol = f0 + (fr90[:, None] - f0) * f[:, None]
    d = d_gtr(noh, alpha)
    g = v_smith_correlated(nol, nov, alpha)
    frc = fcol * (d * g)[:, None]
    frc = frc * ggx_energy_compensation(f0, nov, alpha)
    atten = frc * nol[:, None]
    ok = (nol > EPS) & (pdf > EPS)
    return np.where(ok[:, None], atten, 0.0), np.where(ok, pdf, 0.0)


def eval_principled(surf, i_dir, l):
    """Eval_Principled (:1640-1668)."""
    nol = dot(surf.n, l)
    amt_a = 0.5 + 0.5 * surf.rome[:, 2]  # lerp(0.5, 1, metallic)
    amt_b = 1.0 - amt_a
    ea, pa = eval_specular(surf, i_dir, l)
    eb, pb = eval_diffuse(surf, i_dir, l)
    atten = ea + (eb - ea) * amt_b[:, None]
    pdf = pa + (pb - pa) * amt_b
    ok = nol > EPS
    return np.where(ok[:, None], atten, 0.0), np.where(ok, pdf, 0.0)


def scatter_principled(rng, surf, i_dir):
    """Scatter_Principled (:1670-1707): one-sample mixture."""
    amt_spec = 0.5 + 0.5 * surf.rome[:, 2]
    amt_diff = 1.0 - amt_spec
    pick_spec = rng.random(surf.p.shape[0]) < amt_spec

    # specular branch
    m = sample_ggx_microfacet(
        rng.random((surf.p.shape[0], 2)), brdf_alpha(surf.rome[:, 0])
    )
    m = tan_to_world(surf.n, m)
    m = np.where(dot(surf.m, m)[:, None] > 0.0, m, reflect(m, surf.m))
    l_spec = reflect(i_dir, m)
    es_a, es_p = eval_specular(surf, i_dir, l_spec)
    ed_a, ed_p = eval_diffuse(surf, i_dir, l_spec)
    spec_atten = es_a + (ed_a - es_a) * amt_diff[:, None]
    spec_pdf = es_p + (ed_p - es_p) * amt_diff

    # diffuse branch
    l_diff = tan_to_world(
        surf.n, sample_cosine_hemisphere(rng.random((surf.p.shape[0], 2)))
    )
    dd_a, dd_p = eval_diffuse(surf, i_dir, l_diff)
    ds_a, ds_p = eval_specular(surf, i_dir, l_diff)
    diff_atten = dd_a + (ds_a - dd_a) * amt_spec[:, None]
    diff_pdf = dd_p + (ds_p - dd_p) * amt_spec

    l = np.where(pick_spec[:, None], l_spec, l_diff)
    atten = np.where(pick_spec[:, None], spec_atten, diff_atten)
    pdf = np.where(pick_spec, spec_pdf, diff_pdf)
    return l, atten, pdf


def sigma_a_from_reflectance(albedo, beta_n):
    """SigmaAFromReflectance (lighting.h:193-206, Chiang et al. 4.2)."""
    r2 = beta_n * beta_n
    r3 = r2 * beta_n
    r4 = r3 * beta_n
    r5 = r4 * beta_n
    t = (5.969 - 0.215 * beta_n + 2.532 * r2 - 10.73 * r3 + 5.574 * r4
         + 0.245 * r5)
    sig = np.log(np.maximum(albedo, 1e-30)) / np.maximum(t, EPS)[..., None]
    return sig * sig


def albedo_to_transmittance(albedo, roughness, thickness):
    """AlbedoToTransmittance (lighting.h:208-212)."""
    sig = sigma_a_from_reflectance(albedo, roughness)
    return np.exp(-sig * thickness[:, None])


def scatter_refractive(rng, scene, surf, i_dir):
    """Scatter_Refractive (path_tracer.c:1576-1638): GGX-microfacet
    dielectric; reflect-vs-refract by Fresnel, Beer-Lambert interior
    transmittance from an interior-thickness probe on entering
    refraction.  Returns (pos, l, atten [N,3], pdf)."""
    n_rays = surf.p.shape[0]
    eta_i = 1.000277
    eta_t = np.maximum(1.0, surf.ior)
    alpha = brdf_alpha(surf.rome[:, 0])

    v = -i_dir
    m = tan_to_world(
        surf.n, sample_ggx_microfacet(rng.random((n_rays, 2)), alpha))
    m = fix_shading_normal(surf.m, m)
    entering = ~surf.backface

    cos_i = np.clip(np.abs(dot(v, m)), 0.0, 1.0)
    fres = f_dielectric(np.where(entering, cos_i, -cos_i), eta_i, eta_t)
    do_reflect = rng.random(n_rays) < fres

    l_reflect = reflect(i_dir, m)
    # f4_refract3 (float4_funcs.h:713-719)
    k = np.where(entering, eta_i / eta_t, eta_t / eta_i)
    cos_t = np.minimum(1.0, dot(-i_dir, m))
    r_perp = (m * cos_t[:, None] + i_dir) * k[:, None]
    r_par = m * (-np.sqrt(np.abs(1.0 - np.sum(r_perp * r_perp, -1))))[:, None]
    l_refract = normalize(r_perp + r_par)

    l = np.where(do_reflect[:, None], l_reflect, l_refract)
    pdf = np.where(do_reflect, fres, 1.0 - fres)
    below = dot(l, surf.m) < 0.0
    pos = np.where(below[:, None], surf.p - surf.m * 0.1e-3, surf.p)

    # interior-thickness probe (:1621-1628); miss -> kRcpEpsilon
    t_h = intersect(scene, pos, l, np.full(n_rays, BIG))[0]
    thickness = np.where(t_h >= 0.0, np.maximum(t_h, EPS), BIG)
    refr_in = (~do_reflect) & entering
    tr = albedo_to_transmittance(
        surf.albedo[:, :3], surf.rome[:, 0], thickness)
    atten = np.where(refr_in[:, None], tr * pdf[:, None],
                     np.broadcast_to(pdf[:, None], (n_rays, 3)))
    return pos, l, atten, pdf


# ---------------------------------------------------------------------------
# NEE (EstimateDirect, path_tracer.c:1849-1919) — uniform light selection
# ---------------------------------------------------------------------------

def estimate_direct(rng, scene, surf, src_tri, i_dir, alive):
    n_rays = surf.p.shape[0]
    e_count = scene.emissive.shape[0]
    result = np.zeros((n_rays, 3))
    if e_count == 0:
        return result
    select_pdf = 1.0 / e_count
    p_rough = 0.05 + 0.9 * surf.rome[:, 0]  # lerp(.05,.95,roughness)
    p_smooth = 1.0 - p_rough
    pick_light = rng.random(n_rays) < p_rough

    # --- light strategy -----------------------------------------------------
    pick = rng.integers(0, e_count, n_rays)
    l_tri = scene.emissive[pick]
    w, u, v = sample_bary_coord(rng.random((n_rays, 2)))
    iv = l_tri * 3
    pt = (
        scene.positions[iv] * w[:, None]
        + scene.positions[iv + 1] * u[:, None]
        + scene.positions[iv + 2] * v[:, None]
    )
    delta = pt - surf.p
    dist_sq = np.maximum(dot(delta, delta), EPS_SQ)
    dist = np.sqrt(dist_sq)
    rd = delta / dist[:, None]
    vis, ng_l, _t = occluded_same_tri(scene, surf.p, rd, dist, l_tri)
    cos_theta = np.abs(dot(rd, ng_l))
    s_pdf = light_pdf(scene.areas[l_tri], cos_theta, dist_sq)
    l_alb, l_rome = _fetch_material(scene, l_tri, w, u, v)
    li = _emission_at(scene, l_tri, l_alb, l_rome, rd)
    lp = s_pdf * select_pdf * p_rough
    brdf_a, brdf_p = eval_principled(surf, i_dir, rd)
    bp = brdf_p * p_smooth
    wgt = power_heuristic(lp, bp) / np.maximum(lp, EPS)
    light_term = li * brdf_a * wgt[:, None]
    light_ok = (
        pick_light & vis & (src_tri != l_tri) & (lp > EPS) & (bp > EPS)
        & (np.max(li, axis=-1) > EPS)
    )
    result += np.where(light_ok[:, None], light_term, 0.0)

    # --- BSDF strategy --------------------------------------------------------
    l, atten, pdf = scatter_principled(rng, surf, i_dir)
    bp2 = pdf * p_smooth
    t_h, tri_h, _w, _u, _v, ng_h = intersect(
        scene, surf.p, l, np.full(n_rays, BIG)
    )
    hit_ok = t_h >= 0.0
    cos_h = np.abs(dot(l, ng_h))
    lp2 = (
        light_pdf(scene.areas[np.maximum(tri_h, 0)], cos_h,
                  np.maximum(t_h * t_h, EPS))
        * p_rough * select_pdf
    )
    h_tri = np.maximum(tri_h, 0)
    h_alb, h_rome = _fetch_material(scene, h_tri, _w, _u, _v)
    li2 = _emission_at(scene, h_tri, h_alb, h_rome, l) * atten
    wgt2 = power_heuristic(bp2, lp2) / np.maximum(bp2, EPS)
    bsdf_ok = (
        (~pick_light) & hit_ok & (bp2 > EPS) & (lp2 > EPS)
        & (np.max(li2, axis=-1) > EPS)
    )
    result += np.where(bsdf_ok[:, None], li2 * wgt2[:, None], 0.0)
    return np.where(alive[:, None], result, 0.0)


# ---------------------------------------------------------------------------
# trace loop (Pt_TraceRay, path_tracer.c:2306-2420)
# ---------------------------------------------------------------------------

REFRACTIVE = 1 << 5
SKY = 1 << 1


def trace(scene: OracleScene, ro, rd, rng, max_bounces=10):
    """Trace a batch of rays; returns radiance [N, 3]."""
    n = ro.shape[0]
    lum = np.zeros((n, 3))
    atten = np.ones((n, 3))
    alive = np.ones(n, bool)
    prev_refr = np.zeros(n, bool)
    ro = ro.astype(np.float64).copy()
    rd = normalize(rd.astype(np.float64))

    for b in range(max_bounces):
        # Russian roulette (:2321-2331)
        p = np.clip(avglum(atten), 0.0, 1.0)
        cont = rng.random(n) < p
        alive &= cont
        if not alive.any():
            break
        atten = np.where(
            alive[:, None], atten / np.maximum(p, EPS)[:, None], atten
        )

        t, tri, w, u, v, ng = intersect(scene, ro, rd, np.full(n, BIG))
        hit = (t >= 0.0) & alive
        # miss -> sky and terminate (:2334-2339); unweighted — NEE never
        # samples the void sky, so there is no MIS partner to weight against
        if scene.sky is not None:
            miss = alive & ~hit
            if miss.any():
                lum[miss] += atten[miss] * sample_sky(scene, rd[miss])
        alive &= hit
        if not alive.any():
            break
        tri_s = np.maximum(tri, 0)
        backface = dot(ng, rd) > 0.0
        is_refr = (scene.flags[tri_s] & REFRACTIVE) != 0
        alive &= ~(backface & ~is_refr)  # :2340-2343

        surf = get_surface(scene, tri_s, w, u, v, rd, ng)

        # emission gating: primary hits AND refractive chains contribute
        # directly ((b == 0) || (prevFlags & Refractive), :2375-2378)
        emis_gate = alive if b == 0 else (alive & prev_refr)
        lum += np.where(emis_gate[:, None], surf.emission * atten, 0.0)
        sky_hit = (scene.flags[tri_s] & SKY) != 0
        alive &= ~sky_hit

        # EstimateDirect returns zero on refractive surfaces (:1858-1861)
        li = estimate_direct(rng, scene, surf, tri_s, rd, alive & ~is_refr)
        lum += li * atten

        l, s_atten, s_pdf = scatter_principled(rng, surf, rd)
        pos = surf.p
        if is_refr.any():
            # Scatter_Principled routes refractive materials to
            # Scatter_Refractive (:1678-1681)
            p_r, l_r, a_r, pdf_r = scatter_refractive(rng, scene, surf, rd)
            l = np.where(is_refr[:, None], l_r, l)
            s_atten = np.where(is_refr[:, None], a_r, s_atten)
            s_pdf = np.where(is_refr, pdf_r, s_pdf)
            pos = np.where(is_refr[:, None], p_r, pos)
        ok = s_pdf > EPS
        alive &= ok
        atten = np.where(
            alive[:, None],
            atten * s_atten / np.maximum(s_pdf, EPS)[:, None],
            atten,
        )
        ro = pos
        rd = l
        prev_refr = is_refr & alive

    return lum


def pinhole_rays(width, height, eye, fwd, up, fov_y_deg):
    """Deterministic pixel-center pinhole rays, shared by oracle and
    framework in the parity tests (camera parity is tested elsewhere)."""
    eye = np.asarray(eye, np.float64)
    fwd = normalize(np.asarray(fwd, np.float64))
    right = normalize(np.cross(fwd, np.asarray(up, np.float64)))
    upv = np.cross(right, fwd)
    tan_y = np.tan(np.radians(fov_y_deg) * 0.5)
    tan_x = tan_y * (width / height)
    ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    ndc_x = ((xs + 0.5) / width * 2.0 - 1.0) * tan_x
    ndc_y = ((ys + 0.5) / height * 2.0 - 1.0) * tan_y
    d = (
        fwd[None, None] + right[None, None] * ndc_x[..., None]
        + upv[None, None] * ndc_y[..., None]
    )
    d = normalize(d.reshape(-1, 3))
    o = np.broadcast_to(eye, d.shape).copy()
    return o, d


def trace_brute(scene: OracleScene, ro, rd, rng, max_bounces=10):
    """Third, independent arbiter estimator: NO NEE/MIS — emission is
    accumulated at EVERY path vertex.  With `max_bounces` NEE bounces the
    MIS estimators see emission at vertices 0..max_bounces (the last via
    NEE), so this loop runs max_bounces+1 vertices.  Shares the BSDF /
    intersect / RR code above, so it arbitrates the NEE/MIS estimator
    structure specifically."""
    n = ro.shape[0]
    lum = np.zeros((n, 3))
    atten = np.ones((n, 3))
    alive = np.ones(n, bool)
    ro = ro.astype(np.float64).copy()
    rd = normalize(rd.astype(np.float64))

    for b in range(max_bounces + 1):
        p = np.clip(avglum(atten), 0.0, 1.0)
        cont = rng.random(n) < p
        alive &= cont
        if not alive.any():
            break
        atten = np.where(
            alive[:, None], atten / np.maximum(p, EPS)[:, None], atten
        )

        t, tri, w, u, v, ng = intersect(scene, ro, rd, np.full(n, BIG))
        hit = (t >= 0.0) & alive
        if scene.sky is not None:
            miss = alive & ~hit
            if miss.any():
                lum[miss] += atten[miss] * sample_sky(scene, rd[miss])
        alive &= hit
        if not alive.any():
            break
        tri_s = np.maximum(tri, 0)
        backface = dot(ng, rd) > 0.0
        is_refr = (scene.flags[tri_s] & REFRACTIVE) != 0
        alive &= ~(backface & ~is_refr)

        surf = get_surface(scene, tri_s, w, u, v, rd, ng)
        lum += np.where(alive[:, None], surf.emission * atten, 0.0)
        sky_hit = (scene.flags[tri_s] & SKY) != 0
        alive &= ~sky_hit

        l, s_atten, s_pdf = scatter_principled(rng, surf, rd)
        pos = surf.p
        if is_refr.any():
            p_r, l_r, a_r, pdf_r = scatter_refractive(rng, scene, surf, rd)
            l = np.where(is_refr[:, None], l_r, l)
            s_atten = np.where(is_refr[:, None], a_r, s_atten)
            s_pdf = np.where(is_refr, pdf_r, s_pdf)
            pos = np.where(is_refr[:, None], p_r, pos)
        ok = s_pdf > EPS
        alive &= ok
        atten = np.where(
            alive[:, None],
            atten * s_atten / np.maximum(s_pdf, EPS)[:, None],
            atten,
        )
        ro = pos
        rd = l

    return lum


def render(scene, ro, rd, spp, max_bounces=10, seed=3, brute=False,
           clip=None):
    """Mean radiance over spp independent samples.

    clip: when set, each SINGLE-SAMPLE radiance is clamped to [0, clip]
    per channel before accumulation.  The clipped mean is a *different,
    well-defined* statistic that both the oracle and the framework compute
    identically; it suppresses the firefly variance that dominates the
    unclipped estimator (~8%/128-spp-chunk image-mean std on the GGX
    Cornell), giving the parity suite a tight transport gate
    (tools/derive_parity.py derives the numbers)."""
    rng = np.random.default_rng(seed)
    fn = trace_brute if brute else trace
    acc = np.zeros((ro.shape[0], 3))
    for _ in range(spp):
        s = fn(scene, ro, rd, rng, max_bounces)
        acc += np.minimum(s, clip) if clip is not None else s
    return acc / spp

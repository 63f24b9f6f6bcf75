"""Reflection-probe cubemaps: progressive path-traced bake + GGX prefilter.

Analog of the reference cubemap system
(the reference's src/rendering/cubemap.{c,h}):

- ``Cubemap_Bake`` (cubemap.c:150-190): per-texel tent-jittered direction,
  one path-traced sample, EMA blend into the mip-0 ``color`` planes.  Here
  one bake step is a single batched ``trace_rays`` call over all
  6*size*size texels — the task-pool fork-join becomes one wavefront.
- ``Cubemap_Convolve``/``PrefilterEnvMap`` (cubemap.c:191-303): split-sum
  N=V GGX prefilter of the mip chain, ``MipToRoughness(m) = m / maxMip``
  (cubemap.h:60-69).  The reference draws ``sampleCount`` RNG half-vectors
  per texel per frame; we draw a Hammersley set rotated per progressive
  step, batched as [texels, samples] so the bilinear fetches vectorize.
- ``Cubemap_ReadConvolved`` (cubemap.h:102-115): trilinear-clamp read
  with fractional mip; mips have distinct static shapes, so the lerp is
  an unrolled masked sum over the (small) mip count.
- ``Cubemaps`` registry (cubemap.c:44-95): host-side name->probe table.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from pim.math.sampling import (
    hammersley_2d,
    sample_ggx_microfacet,
    tbn_to_world,
)
from pim.math.vec3 import V3, dot, normalize, reflect
from pim.render.sky import _FORWARDS, _RIGHTS, _UPS, sample_sky_cubemap


def calc_mip_count(size: int) -> int:
    """log2 chain length (ref CalcMipCount, math/int2_funcs.h)."""
    return max(int(size).bit_length(), 1)


def mip_to_roughness(mip, max_mip: float):
    """ref cubemap.h:66-69 (roughness, not alpha)."""
    return mip / max_mip


def roughness_to_mip(roughness, max_mip: float):
    """ref cubemap.h:60-64."""
    return roughness * max_mip


class Cubemap(NamedTuple):
    """A probe: raw radiance + GGX-prefiltered mip chain (ref Cubemap_s
    cubemap.h:28-34; color / convolved planes)."""

    color: jnp.ndarray            # [6, S, S, 3] path-traced radiance
    mips: Tuple[jnp.ndarray, ...]  # ([6, S>>m, S>>m, 3] for m in mips)

    @property
    def size(self) -> int:
        return self.color.shape[1]

    @property
    def mip_count(self) -> int:
        return len(self.mips)


def cubemap_new(size: int) -> Cubemap:
    """Zeroed probe with full mip chain (ref Cubemap_New cubemap.c:96-115)."""
    mips = tuple(
        jnp.zeros((6, max(size >> m, 1), max(size >> m, 1), 3), jnp.float32)
        for m in range(calc_mip_count(size))
    )
    return Cubemap(color=jnp.zeros((6, size, size, 3), jnp.float32), mips=mips)


def calc_dirs_jittered(size: int, xi: jnp.ndarray) -> jnp.ndarray:
    """Per-texel outward directions with [-1,1] subpixel jitter
    (ref Cubemap_CalcDir cubemap.h:190-208).  xi: [6*size*size, 2] in
    [-1, 1); returns [6*size*size, 3] unit dirs."""
    ts = (np.arange(size, dtype=np.float32) + 0.5) / size * 2.0 - 1.0
    u, v = np.meshgrid(ts, ts, indexing="xy")
    uv = np.stack(
        [np.broadcast_to(u, (6, size, size)), np.broadcast_to(v, (6, size, size))],
        axis=-1,
    ).reshape(-1, 2)
    uv = jnp.asarray(uv) + xi * (2.0 / size)
    fwd = np.repeat(_FORWARDS, size * size, axis=0)
    right = np.repeat(_RIGHTS, size * size, axis=0)
    up = np.repeat(_UPS, size * size, axis=0)
    dirs = (
        jnp.asarray(fwd)
        + jnp.asarray(right) * uv[:, :1]
        + jnp.asarray(up) * uv[:, 1:2]
    )
    return normalize(V3.from_aos(dirs)).aos()


def bake_step(
    meta,
    arrays,
    lights,
    cm: Cubemap,
    origin,
    sample_idx,
    weight,
    max_bounces: int = 4,
) -> Cubemap:
    """One progressive bake pass: path-trace every texel once from
    ``origin`` and EMA-blend (ref BakeFn cubemap.c:143-162).  Jittable;
    ``weight`` is typically 1/sampleCount."""
    from pim.core import rng
    from pim.render.integrator import trace_rays

    size = cm.size
    n = 6 * size * size
    state = rng.make_state(
        jnp.arange(n, dtype=jnp.uint32), sample_idx, seed=0x0C0B0E00
    )
    state, (x1, x2) = rng.next_f32x2(state)
    # tent filter over [-1, 1] (ref f2_tent)
    xi = jnp.stack([_tent(x1), _tent(x2)], axis=-1)
    dirs = calc_dirs_jittered(size, xi)
    ro = V3.splat(jnp.asarray(origin, jnp.float32), (n,))
    res = trace_rays(meta, arrays, lights, ro, V3.from_aos(dirs), state, max_bounces)
    new = res.color.reshape(6, size, size, 3)
    color = cm.color + (new - cm.color) * weight
    return cm._replace(color=color)


def _tent(x):
    """[0,1) -> [-1,1] tent-distributed (ref f2_tent sampling.h)."""
    t = 2.0 * x - 1.0
    return jnp.sign(t) * (1.0 - jnp.sqrt(jnp.maximum(1.0 - jnp.abs(t), 0.0)))


def prefilter_mip(
    color: jnp.ndarray,
    mip: int,
    max_mip: float,
    sample_count: int,
    sample_idx,
) -> jnp.ndarray:
    """Split-sum N=V GGX prefilter of one mip (ref PrefilterEnvMap
    cubemap.c:191-222).  Hammersley half-vector set, rotated per
    progressive step by a per-step Cranley-Patterson offset; fetches are
    batched [texels, samples] bilinear reads of the mip-0 color planes."""
    from pim.core import rng as _rng

    size = color.shape[1]
    msize = max(size >> mip, 1)
    n = 6 * msize * msize
    # tent-jitter the per-texel normal per progressive step (ref PrefilterFn
    # cubemap.c:254-256 jitters N per pass) so the estimate integrates over
    # the texel footprint instead of a fixed quadrature
    st = _rng.make_state(
        jnp.arange(n, dtype=jnp.uint32),
        jnp.asarray(sample_idx, jnp.uint32),
        seed=0x0C0B0E01 + mip,
    )
    st, (jx, jy) = _rng.next_f32x2(st)
    xi = jnp.stack([_tent(jx), _tent(jy)], axis=-1)
    dirs = calc_dirs_jittered(msize, xi)
    nrm = V3.from_aos(dirs)

    roughness = mip_to_roughness(float(mip), max_mip)
    alpha = max(roughness * roughness, 1e-3)

    i = jnp.arange(sample_count, dtype=jnp.uint32)
    u, v = hammersley_2d(i, sample_count)
    # per-step Cranley-Patterson rotation of BOTH strata keeps the
    # progressive average converging to the true GGX integral rather than
    # one fixed sample_count-point quadrature (ADVICE r1)
    s_idx = jnp.asarray(sample_idx, jnp.float32)
    u = jnp.mod(u + s_idx * 0.61803398875, 1.0)
    v = jnp.mod(v + s_idx * 0.7548776662466927, 1.0)

    def one_sample(us, vs):
        h_ts = sample_ggx_microfacet(us, vs, alpha)
        h = tbn_to_world(nrm, _splat_dir(h_ts, nrm))
        l = reflect(-nrm, h)  # I = -N (split-sum N=V), L = reflect(I, H)
        nol = dot(l, nrm)
        valid = nol > 0.0
        w = jnp.where(valid, nol, 0.0)
        s = sample_sky_cubemap(color, l.aos())
        return s * w[:, None], w

    acc = jnp.zeros((n, 3), jnp.float32)
    wacc = jnp.zeros((n,), jnp.float32)
    for k in range(sample_count):
        s, w = one_sample(u[k], v[k])
        acc = acc + s
        wacc = wacc + w
    out = acc / jnp.maximum(wacc, 1e-6)[:, None]
    return out.reshape(6, msize, msize, 3)


def _splat_dir(d_ts: V3, like: V3) -> V3:
    """Broadcast a single tangent-space dir across the texel batch."""
    ones = jnp.ones_like(like.x)
    return V3(d_ts.x * ones, d_ts.y * ones, d_ts.z * ones)


def convolve(cm: Cubemap, sample_count: int, weight, sample_idx=0) -> Cubemap:
    """Prefilter every mip and EMA-blend into the chain
    (ref Cubemap_Convolve cubemap.c:265-303)."""
    max_mip = float(max(cm.mip_count - 1, 1))
    mips: List[jnp.ndarray] = []
    for m in range(cm.mip_count):
        new = prefilter_mip(cm.color, m, max_mip, sample_count, sample_idx)
        mips.append(cm.mips[m] + (new - cm.mips[m]) * weight)
    return cm._replace(mips=tuple(mips))


def read_convolved(cm: Cubemap, dirs: jnp.ndarray, roughness) -> jnp.ndarray:
    """Trilinear-clamp fetch with fractional mip from roughness
    (ref Cubemap_ReadConvolved cubemap.h:102-115 + RoughnessToMip).
    dirs [..., 3]; roughness scalar or [...]; returns [..., 3]."""
    max_mip = float(max(cm.mip_count - 1, 1))
    mip = jnp.clip(roughness_to_mip(jnp.asarray(roughness, jnp.float32), max_mip),
                   0.0, cm.mip_count - 1)
    m0 = jnp.floor(mip)
    frac = mip - m0
    out = jnp.zeros(dirs.shape[:-1] + (3,), jnp.float32)
    for m in range(cm.mip_count):
        lo = sample_sky_cubemap(cm.mips[m], dirs)
        w = jnp.where(
            m0 == m, 1.0 - frac, jnp.where(m0 == m - 1, frac, 0.0)
        )
        out = out + lo * w[..., None]
    return out


class CubemapRegistry:
    """Host-side named probe table (ref Cubemaps_s cubemap.c:36-95)."""

    def __init__(self) -> None:
        self._probes: Dict[str, Cubemap] = {}
        self._bounds: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        self._samples: Dict[str, int] = {}
        self._origins: Dict[str, np.ndarray] = {}
        self._baked_from: Dict[str, np.ndarray] = {}

    def add(self, name: str, size: int, lo=None, hi=None) -> Cubemap:
        if name in self._probes:
            raise KeyError(f"cubemap exists: {name}")
        cm = cubemap_new(size)
        self._probes[name] = cm
        self._bounds[name] = (
            np.asarray(lo if lo is not None else [-1e9] * 3, np.float32),
            np.asarray(hi if hi is not None else [1e9] * 3, np.float32),
        )
        self._samples[name] = 0
        return cm

    def remove(self, name: str) -> bool:
        if name not in self._probes:
            return False
        del self._probes[name], self._bounds[name], self._samples[name]
        return True

    def find(self, name: str) -> Optional[Cubemap]:
        return self._probes.get(name)

    def names(self):
        return list(self._probes)

    def reset_samples(self, name: Optional[str] = None) -> None:
        """Restart a probe's (or all probes') progressive average — the ref
        resets sampleCount when cv_r_refl_gen goes dirty."""
        for n in ([name] if name else list(self._samples)):
            self._samples[n] = 0

    def probe_origin(self, name: str, fallback_origin=None) -> np.ndarray:
        """Bake origin: the probe's bounds center (ref box_center(bounds),
        render_system.c:235-239) when bounded, else the frozen fallback."""
        lo, hi = self._bounds[name]
        if np.all(np.isfinite(lo)) and np.all(np.abs(lo) < 1e8) and np.all(np.abs(hi) < 1e8):
            return ((lo + hi) * 0.5).astype(np.float32)
        if name not in self._origins:
            self._origins[name] = np.asarray(
                fallback_origin if fallback_origin is not None else [0, 0, 0],
                np.float32,
            )
        return self._origins[name]

    def bake(self, name: str, meta, arrays, lights, fallback_origin=None,
             max_bounces: int = 4, convolve_samples: int = 32) -> Cubemap:
        """One progressive bake+convolve step (ref render_system.c:216-245
        Cubemap_Trace: weight = 1/++sampleCount).  The origin is fixed per
        probe; if it ever changes, the running average resets rather than
        mixing radiance baked from two viewpoints."""
        cm = self._probes[name]
        origin = self.probe_origin(name, fallback_origin)
        prev = self._baked_from.get(name)
        if prev is not None and not np.allclose(prev, origin):
            self._samples[name] = 0
        self._baked_from[name] = np.asarray(origin, np.float32).copy()
        self._samples[name] += 1
        w = 1.0 / self._samples[name]
        cm = bake_step(meta, arrays, lights, cm, origin, self._samples[name] - 1,
                       w, max_bounces)
        cm = convolve(cm, convolve_samples, w, self._samples[name] - 1)
        self._probes[name] = cm
        return cm


_registry: Optional[CubemapRegistry] = None


def get_registry() -> CubemapRegistry:
    global _registry
    if _registry is None:
        _registry = CubemapRegistry()
    return _registry

"""Batched 1-D piecewise-constant distributions with online adaptation.

Batched re-design of the reference's Dist1D (src/math/dist1d.c).  The reference
keeps one heap-allocated Dist1D per light-grid cell and rebuilds them with
scalar loops + atomics; here ALL cells are one dense batch:

    pdf  [G, N]   float32
    cdf  [G, N+1] float32
    live [G, N]   uint32   (scatter-add accumulated hit histogram)
    sum  [G]      uint32   (previous live sum, drives the EMA alpha)

bake = prefix-sum, sample = vectorized branchless binary search
(searchsorted semantics of FindInterval, dist1d.c:75-94), update = masked EMA
fold of the live histogram (dist1d.c:128-163), all one XLA op per stage and
trivially shardable over G.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from pim.math.vec import EPS


class Dist1D(NamedTuple):
    pdf: jnp.ndarray   # [G, N]
    cdf: jnp.ndarray   # [G, N+1]
    integral: jnp.ndarray  # [G]
    sum: jnp.ndarray   # [G] uint32 — previous live-histogram sum


def bake(pdf: jnp.ndarray, prev_sum=None) -> Dist1D:
    """Build cdf from (unnormalized) pdf rows; normalizes pdf in place.

    Mirrors Dist1D_Bake (dist1d.c:33-73): zero-integral rows get a uniform
    cdf (pdf stays zero — sampling still works, pdf lookups return 0).
    """
    g, n = pdf.shape
    rcp_len = jnp.float32(1.0 / n)
    csum = jnp.cumsum(pdf * rcp_len, axis=-1)
    cdf = jnp.concatenate([jnp.zeros((g, 1), pdf.dtype), csum], axis=-1)
    integral = cdf[:, -1]
    zero = integral == 0.0
    uniform = jnp.arange(n + 1, dtype=pdf.dtype)[None, :] * rcp_len
    safe_integral = jnp.where(zero, 1.0, integral)
    cdf = jnp.where(zero[:, None], uniform, cdf / safe_integral[:, None])
    pdf = jnp.where(zero[:, None], pdf, pdf / safe_integral[:, None])
    if prev_sum is None:
        prev_sum = jnp.zeros((g,), jnp.uint32)
    return Dist1D(pdf=pdf, cdf=cdf, integral=integral, sum=prev_sum)


def sample_discrete(dist: Dist1D, cell: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
    """Sample a bucket index per (cell, u) pair.

    cell: int32 [...], u: float32 [...] -> int32 [...].
    FindInterval(cdf, u) == (# of cdf entries <= u) - 1, clamped.
    """
    n = dist.pdf.shape[1]
    cdf_rows = dist.cdf[cell]  # [..., N+1]
    idx = jnp.sum((cdf_rows <= u[..., None]).astype(jnp.int32), axis=-1) - 1
    return jnp.clip(idx, 0, n - 1)


def pdf_discrete(dist: Dist1D, cell: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Probability of bucket idx in cell (ref Dist1D_PdfD: pdf[i]/length)."""
    n = dist.pdf.shape[1]
    return dist.pdf[cell, idx] / jnp.float32(n)


def sample_continuous(dist: Dist1D, cell: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
    """Continuous inverse-cdf sample in [0,1) (ref Dist1D_SampleC)."""
    n = dist.pdf.shape[1]
    idx = sample_discrete(dist, cell, u)
    u0 = dist.cdf[cell, idx]
    u1 = dist.cdf[cell, idx + 1]
    w = u1 - u0
    du = jnp.where(w > 0.0, (u - u0) / jnp.maximum(w, EPS), u - u0)
    return (idx.astype(jnp.float32) + du) / jnp.float32(n)


def update(dist: Dist1D, live: jnp.ndarray):
    """Fold the live hit histogram into the pdf by ratio-derived EMA.

    Mirrors Dist1D_Update (dist1d.c:128-163): rows with < 30 hits are left
    untouched; alpha = sat(sum/prevSum * 0.9)^2 (0.5 on first fold); live
    counters decay by >>1.  Returns (new_dist, new_live).
    """
    g, n = dist.pdf.shape
    live = live.astype(jnp.uint32)
    s = jnp.sum(live, axis=-1)  # [G] uint32
    active = s >= 30

    s_f = s.astype(jnp.float32)
    prev_f = dist.sum.astype(jnp.float32)
    ratio = jnp.where(prev_f > 0.0, s_f / jnp.maximum(prev_f, 1.0), 0.0)
    alpha_ratio = jnp.clip(ratio, 0.0, 1.0) * 0.9
    alpha = jnp.where(dist.sum > 0, alpha_ratio * alpha_ratio, 0.5)

    scale = 1.0 / jnp.maximum(s_f, 1.0)
    target = live.astype(jnp.float32) * scale[:, None]
    new_pdf_active = dist.pdf + (target - dist.pdf) * alpha[:, None]
    new_pdf = jnp.where(active[:, None], new_pdf_active, dist.pdf)

    rebaked = bake(new_pdf, prev_sum=jnp.where(active, s, dist.sum))
    # inactive rows keep their previous cdf/integral (bake normalized pdf
    # rows again, which is idempotent for already-normalized rows)
    cdf = jnp.where(active[:, None], rebaked.cdf, dist.cdf)
    pdf = jnp.where(active[:, None], rebaked.pdf, dist.pdf)
    integral = jnp.where(active, rebaked.integral, dist.integral)
    new_live = jnp.where(active[:, None], live >> 1, live)
    return Dist1D(pdf=pdf, cdf=cdf, integral=integral, sum=rebaked.sum), new_live

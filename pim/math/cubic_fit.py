"""Randomized curve fitting for tonemap curves.

Counterpart of the reference's src/math/cubic_fit.{c,h}: the
reference runs one annealed random search per worker thread (FitFn
cubic_fit.c:111-143 — random init, then `iterations` rounds of 22
mutation scales 1/2^bit, keep-best) and takes the best thread's fit
(CreateFit :146-171).  Here the "threads" are a population axis and all
candidates × mutation scales evaluate as one batched tensor op per round
— the whole search is a single `lax.fori_loop` under jit.

Curve models (ref cubic_fit.h:14-44):
  cubic:  a*x + b*x^2 + c*x^3
  sqrtic: a*sqrt(x) + b*x^(1/4) + c*x^(1/8)
  tmap:   (x*(a*x + b)) / (x*(c*x + d) + e)       (GT-tonemap-ish rational)
  poly:   (b*x + c*x^2 + d*x^3) / (e + f*x + g*x^2 + h*x^3)
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

_NUM_COEFFS = 8
_MUT_BITS = 22


def cubic_eval(x, coeffs):
    """ref CubicEval cubic_fit.h:14-17.  coeffs [..., 8] (first 3 used)."""
    a, b, c = coeffs[..., 0], coeffs[..., 1], coeffs[..., 2]
    return a * x + b * x * x + c * x * x * x


def sqrtic_eval(x, coeffs):
    """ref SqrticEval cubic_fit.h:19-25."""
    s1 = jnp.sqrt(jnp.maximum(x, 0.0))
    s2 = jnp.sqrt(s1)
    s3 = jnp.sqrt(s2)
    return coeffs[..., 0] * s1 + coeffs[..., 1] * s2 + coeffs[..., 2] * s3


def tmap_eval(x, coeffs):
    """ref TMapEval cubic_fit.h:27-35."""
    a, b, c, d, e = (coeffs[..., i] for i in range(5))
    denom = x * (c * x + d) + e
    return (x * (a * x + b)) / jnp.where(jnp.abs(denom) > 1e-12, denom, 1e-12)


def poly_eval(x, coeffs):
    """ref PolyEval cubic_fit.h:37-43."""
    x2 = x * x
    x3 = x2 * x
    nom = coeffs[..., 1] * x + coeffs[..., 2] * x2 + coeffs[..., 3] * x3
    den = coeffs[..., 4] + coeffs[..., 5] * x + coeffs[..., 6] * x2 + coeffs[..., 7] * x3
    return nom / jnp.where(jnp.abs(den) > 1e-12, den, 1e-12)


_EVALS = {
    "cubic": cubic_eval,
    "sqrtic": sqrtic_eval,
    "tmap": tmap_eval,
    "poly": poly_eval,
}


def _rms_error(eval_fn, xs, ys, coeffs):
    """sqrt(mean((f(x) - y)^2)) (ref CubicError etc. cubic_fit.c:11-60).
    coeffs [..., 8]; xs/ys [S] -> error [...]."""
    y = eval_fn(xs, coeffs[..., None, :])
    d = y - ys
    return jnp.sqrt(jnp.mean(d * d, axis=-1))


@partial(jax.jit, static_argnames=("kind", "iterations", "population"))
def curve_fit(
    xs: jnp.ndarray,
    ys: jnp.ndarray,
    kind: str = "cubic",
    iterations: int = 64,
    population: int = 64,
    seed: int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Fit ``kind`` to samples (xs, ys); returns (coeffs [8], rms error).

    Population-parallel annealed search: P independent candidates (the
    ref's per-thread fits) each try 22 mutation scales per round in one
    [P, 22, 8] batch; best-of-population wins (ref CreateFit)."""
    eval_fn = _EVALS[kind]
    xs = jnp.asarray(xs, jnp.float32)
    ys = jnp.asarray(ys, jnp.float32)
    iters = max(iterations, 2 * (xs.shape[0] + 1))

    key = jax.random.PRNGKey(seed)
    k0, key = jax.random.split(key)
    fits = jax.random.uniform(k0, (population, _NUM_COEFFS))  # randFit
    errs = _rms_error(eval_fn, xs, ys, fits)

    scales = (1.0 / (2.0 ** jnp.arange(_MUT_BITS, dtype=jnp.float32)))[None, :, None]

    def round_body(i, carry):
        fits, errs, key = carry
        kmut, key = jax.random.split(key)
        # signed mutation (the ref's is one-sided uniform [0,1)*amt,
        # cubic_fit.c:100-108; centered converges measurably better)
        xi = jax.random.uniform(kmut, (population, _MUT_BITS, _NUM_COEFFS),
                                minval=-1.0, maxval=1.0)
        cand = fits[:, None, :] + xi * scales  # mutateFit at 22 scales
        cerr = _rms_error(eval_fn, xs, ys, cand)  # [P, 22]
        best = jnp.argmin(cerr, axis=1)
        bdx = jnp.take_along_axis(cand, best[:, None, None], axis=1)[:, 0]
        berr = jnp.take_along_axis(cerr, best[:, None], axis=1)[:, 0]
        better = berr < errs
        fits = jnp.where(better[:, None], bdx, fits)
        errs = jnp.where(better, berr, errs)
        return fits, errs, key

    fits, errs, _ = jax.lax.fori_loop(0, iters, round_body, (fits, errs, key))
    win = jnp.argmin(errs)
    return fits[win], errs[win]

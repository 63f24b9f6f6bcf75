"""Histogram auto-exposure: 256-bin log-luminance, cdf-windowed average.

Re-design of the reference's 3-dispatch Vulkan compute chain
(Clear/Build/AdaptHistogram, src/rendering/vulkan/vkr_exposure.c:352-382 +
src/shaders/{Build,Adapt}Histogram.hlsl) and the photometric EV100 math of
src/rendering/exposure.h.  The histogram is one segment-sum; the
cdf-weighted average is a cumulative-sum expression; adaptation is an EMA.
All of it fuses into the frame's XLA program — no separate passes, no
readback fence (the exposure scalar stays on device).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from pim.math.color import avg_lum
from pim.math.vec import EPS, LOG2_EPS, saturate

HISTOGRAM_SIZE = 256  # ref r_config.h:118


class ExposureParams(NamedTuple):
    """Mirror of vkrExposure (ref vkr.h / exposure.h legend)."""

    manual: jnp.ndarray       # bool scalar
    standard: jnp.ndarray     # bool: standard vs saturation exposure
    aperture: jnp.ndarray     # f-stops
    shutter_time: jnp.ndarray
    iso: jnp.ndarray
    adapt_rate: jnp.ndarray
    offset_ev: jnp.ndarray
    min_ev: jnp.ndarray
    max_ev: jnp.ndarray
    min_cdf: jnp.ndarray
    max_cdf: jnp.ndarray

    @classmethod
    def from_cvars(cls) -> "ExposureParams":
        from pim.core import cvars as cv

        f = lambda x: jnp.float32(x)
        return cls(
            manual=jnp.asarray(cv.cv_exp_manual.get()),
            standard=jnp.asarray(cv.cv_exp_standard.get()),
            aperture=f(cv.cv_exp_aperture.get()),
            shutter_time=f(cv.cv_exp_shutter.get()),
            iso=f(100.0),
            adapt_rate=f(cv.cv_exp_adaptrate.get()),
            offset_ev=f(cv.cv_exp_evoffset.get()),
            min_ev=f(cv.cv_exp_evmin.get()),
            max_ev=f(cv.cv_exp_evmax.get()),
            min_cdf=f(cv.cv_exp_cdfmin.get()),
            max_cdf=f(cv.cv_exp_cdfmax.get()),
        )


class ExposureState(NamedTuple):
    avg_lum: jnp.ndarray   # adapted average luminance
    exposure: jnp.ndarray  # final scale factor


def make_exposure_state() -> ExposureState:
    return ExposureState(avg_lum=jnp.float32(0.0), exposure=jnp.float32(1.0))


# --- EV100 math (ref exposure.h:33-116) ------------------------------------


def lum_to_ev100(lum):
    return jnp.log2(jnp.maximum(lum, EPS)) + 3.0


def ev100_to_lum(ev100):
    return jnp.exp2(ev100 - 3.0)


def lum_to_bin(lum, min_ev, max_ev):
    """(ref exposure.h:48-57): bin 0 holds near-black."""
    ev = lum_to_ev100(lum)
    t = (ev - min_ev) / jnp.maximum(max_ev - min_ev, EPS)
    bin_ = (1.5 + t * (HISTOGRAM_SIZE - 2)).astype(jnp.int32)
    bin_ = jnp.clip(bin_, 0, HISTOGRAM_SIZE - 1)
    return jnp.where(lum > EPS, bin_, 0)


def bin_to_ev(i, min_ev, max_ev):
    rcp = 1.0 / (HISTOGRAM_SIZE - 1)
    ev = min_ev + (max_ev - min_ev) * ((i.astype(jnp.float32) - 0.5) * rcp)
    return jnp.where(i != 0, ev, LOG2_EPS)


def manual_ev100(aperture, shutter_time, iso):
    a = (aperture * aperture) / shutter_time
    b = 100.0 / iso
    return jnp.log2(a * b)


def saturation_exposure(ev100):
    factor = 78.0 / (100.0 * 0.65)
    return 1.0 / (factor * jnp.exp2(ev100))


def standard_exposure(ev100):
    mid_grey = 0.18
    factor = 10.0 / (100.0 * 0.65)
    return mid_grey / (factor * jnp.exp2(ev100))


def exposure_compensation_curve(ev100):
    """Krawczyk key value (ref exposure.h:110-116)."""
    l = ev100_to_lum(ev100)
    key = 1.03 - 2.0 / (jnp.log10(l + 1.0) + 2.0)
    return key / 0.18


def adapt_luminance(lum0, lum1, dt, tau):
    lum0 = jnp.maximum(lum0, EPS)
    lum1 = jnp.maximum(lum1, EPS)
    t = saturate(1.0 - jnp.exp(-dt * tau))
    return lum0 + (lum1 - lum0) * t


def calc_exposure(params: ExposureParams, avg):
    """(ref exposure.h:118-147)."""
    avg = jnp.maximum(avg, EPS)
    ev100 = jnp.where(
        params.manual,
        manual_ev100(params.aperture, params.shutter_time, params.iso),
        lum_to_ev100(avg),
    )
    comp = exposure_compensation_curve(ev100)
    ev100 = jnp.clip(ev100 - params.offset_ev, params.min_ev, params.max_ev)
    exp_ = jnp.where(
        params.standard, standard_exposure(ev100), saturation_exposure(ev100)
    )
    return exp_ * comp


# --- the full pass ---------------------------------------------------------


def build_histogram(light, min_ev, max_ev):
    """light [N, 3] -> counts [256] (ref BuildHistogram.hlsl)."""
    lum = avg_lum(light)
    bins = lum_to_bin(lum, jnp.maximum(min_ev, LOG2_EPS), max_ev)
    return jnp.zeros((HISTOGRAM_SIZE,), jnp.int32).at[bins].add(1)


def exposure_pass(light, params: ExposureParams, state: ExposureState, dt) -> ExposureState:
    """One frame of auto-exposure (ref AdaptHistogram.hlsl).

    The cdf-windowed weighting w = pdf * w0 * w1 discards the darkest
    min_cdf and brightest (1-max_cdf) fractions of pixels.
    """
    n = light.shape[0]
    min_ev = jnp.maximum(params.min_ev, LOG2_EPS)
    counts = build_histogram(light, min_ev, params.max_ev)
    pdf = counts.astype(jnp.float32) / jnp.float32(n)
    cdf_before = jnp.concatenate([jnp.zeros(1), jnp.cumsum(pdf)[:-1]])
    rcp_pdf = 1.0 / jnp.maximum(pdf, EPS)
    w0 = 1.0 - saturate((params.min_cdf - cdf_before) * rcp_pdf)
    w1 = saturate((params.max_cdf - cdf_before) * rcp_pdf)
    w = pdf * w0 * w1
    i = jnp.arange(HISTOGRAM_SIZE)
    lum_i = ev100_to_lum(bin_to_ev(i, min_ev, params.max_ev))
    avg = jnp.sum(lum_i * w)
    adapted = adapt_luminance(state.avg_lum, avg, dt, params.adapt_rate)
    exposure = calc_exposure(params, adapted)
    return ExposureState(avg_lum=adapted, exposure=exposure)

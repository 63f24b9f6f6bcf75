"""Differentiable-rendering parameter surface.

The reference has no gradients anywhere; this module defines the
BASELINE.md differentiability contract: the rendered
image is differentiable w.r.t.

  - per-material flat albedo / ROME (emission = albedo * e^2 * scale,
    ref GetSurface, src/rendering/path_tracer.c:1377-1419)
  - the texture atlas texels (textured materials)
  - sun direction / luminance (the sky cubemap is re-baked INSIDE the
    traced function so grads flow through the Rayleigh/Mie march,
    ref src/math/atmosphere.h:79-182)
  - camera position (ray origins are smooth in the eye point)

Design: parameters are a small pytree (`DiffParams`); `apply_params`
grafts them into the scene arrays on-device (one-hot matmul writes into
the fused tri-table rows — differentiable, no host round trip).  All
discrete sampling decisions ride the uint32 counter RNG and are naturally
detached, so fixed-seed AD equals finite differences of the same
estimator (reparameterized gradients; SURVEY.md §7 hard part #3).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from pim.core import rng
from pim.render import fetch as F
from pim.render.camera import CameraArrays, generate_primary_rays
from pim.render.integrator import trace_rays
from pim.render.scene import LightState, SceneArrays, SceneMeta


class DiffParams(NamedTuple):
    """The learnable parameter pytree."""

    mat_albedo: jnp.ndarray    # [M, 4] flat per-material albedo (rgba)
    mat_rome: jnp.ndarray      # [M, 4] roughness/occlusion/metallic/emission
    atlas_planes: jnp.ndarray  # [4, H*W] texture atlas texels
    sun_dir: jnp.ndarray       # [3] (normalized inside apply)
    sun_lum: jnp.ndarray       # [3]
    cam_eye: jnp.ndarray       # [3]


def extract_params(meta: SceneMeta, arrays: SceneArrays, cam: CameraArrays,
                   sun_dir=(0.0, 1.0, 0.0), sun_lum=(1.0, 1.0, 1.0)) -> DiffParams:
    """Pull the current parameter values out of a built scene (host-side)."""
    tt = np.asarray(arrays.tri_table)
    mat_ids = np.asarray(arrays.mat_ids)
    m = meta.mat_count
    alb = np.zeros((m, 4), np.float32)
    rom = np.full((m, 4), np.float32(0.0))
    for i in range(m):
        sel = np.nonzero(mat_ids == i)[0]
        if sel.size:
            alb[i] = tt[F.ALBEDO, sel[0]]
            rom[i] = tt[F.ROME, sel[0]]
    return DiffParams(
        mat_albedo=jnp.asarray(alb),
        mat_rome=jnp.asarray(rom),
        atlas_planes=arrays.atlas_planes,
        sun_dir=jnp.asarray(sun_dir, jnp.float32),
        sun_lum=jnp.asarray(sun_lum, jnp.float32),
        cam_eye=cam.eye,
    )


def apply_params(meta: SceneMeta, arrays: SceneArrays, cam: CameraArrays,
                 params: DiffParams, sky_steps: int = 16):
    """Graft `params` into (arrays, cam) on-device; fully differentiable.

    Flat materials get their tri-table ALBEDO/ROME rows rewritten from the
    [M, 4] tables via the same one-hot fetch the integrator uses; textured
    triangles (ALBEDO_TEX/ROME_TEX >= 0) keep their zero rows and read the
    (learnable) atlas instead.  When the scene has a sky, the cubemap is
    re-baked from (sun_dir, sun_lum) so sun gradients flow.
    """
    tt = arrays.tri_table
    mat_ids = arrays.mat_ids

    alb_rows = F.fetch_cols(params.mat_albedo.T, mat_ids)  # [4, T]
    rom_rows = F.fetch_cols(params.mat_rome.T, mat_ids)    # [4, T]
    alb_flat = tt[F.ALBEDO_TEX] < 0.0   # [T] — flat (non-textured) lanes
    rom_flat = tt[F.ROME_TEX] < 0.0
    tt = tt.at[F.ALBEDO].set(jnp.where(alb_flat[None, :], alb_rows, tt[F.ALBEDO]))
    tt = tt.at[F.ROME].set(jnp.where(rom_flat[None, :], rom_rows, tt[F.ROME]))
    arrays = arrays._replace(tri_table=tt, atlas_planes=params.atlas_planes)

    # The NEE side of the estimator reads emission from the compact
    # emissive table, not the tri table — without this graft the dominant
    # (light-strategy) share of the emission gradient is silently
    # stop-gradded and d(image)/d(emission) collapses to the small
    # BSDF-strategy sliver (caught by test_grad_emission).
    if meta.emissive_count > 0:
        from pim.render import lights as L

        et = arrays.emissive_table
        mat_e = mat_ids[et[L.E_TRI].astype(jnp.int32)]         # [E]
        alb_e = F.fetch_cols(params.mat_albedo.T, mat_e)       # [4, E]
        rome_e = F.fetch_cols(params.mat_rome.T, mat_e)        # [4, E]
        a_flat_e = et[L.E_ALBEDO_TEX] < 0.0
        r_flat_e = et[L.E_ROME_TEX] < 0.0
        et = et.at[L.E_ALBEDO].set(
            jnp.where(a_flat_e[None, :], alb_e[0:3], et[L.E_ALBEDO]))
        et = et.at[L.E_EMIT_A].set(
            jnp.where(r_flat_e, rome_e[3], et[L.E_EMIT_A]))
        arrays = arrays._replace(emissive_table=et)

    if meta.has_sky:
        from pim.render.sky import bake_sky_cubemap, earth_atmosphere

        size = int(arrays.sky.shape[1])
        sd = params.sun_dir / jnp.sqrt(
            jnp.maximum(jnp.sum(params.sun_dir**2), 1e-12)
        )
        sky = bake_sky_cubemap(earth_atmosphere(), sd, params.sun_lum, size, sky_steps)
        arrays = arrays._replace(sky=sky)

    cam = cam._replace(eye=params.cam_eye)
    return arrays, cam


def make_render_fn(meta: SceneMeta, width: int, height: int,
                   max_bounces: int = 3, sky_steps: int = 16):
    """render(params, arrays, lights, cam, sample_idx[, pixel_ids])
    -> ([N, 3] color, [G, E] live).  Jit/grad-compatible."""

    def render(params: DiffParams, arrays, lights, cam, sample_idx, pixel_ids=None):
        arrays, cam = apply_params(meta, arrays, cam, params, sky_steps)
        if pixel_ids is None:
            pixel_ids = jnp.arange(width * height, dtype=jnp.uint32)
        state = rng.make_state(pixel_ids, sample_idx)
        state, ro, rd = generate_primary_rays(cam, width, height, state,
                                              pixel_ids=pixel_ids)
        # deterministic full-MIS NEE + no Russian roulette: the estimator
        # stays smooth in the parameters (no strategy/termination flips)
        res = trace_rays(meta, arrays, lights, ro, rd, state, max_bounces,
                         mis_both=True, use_rr=False)
        return res.color, res.live

    return render


def make_loss_fn(meta: SceneMeta, width: int, height: int,
                 max_bounces: int = 3, sky_steps: int = 16):
    """L2 image loss vs a target; returns (loss, live) with has_aux shape."""
    render = make_render_fn(meta, width, height, max_bounces, sky_steps)

    def loss_fn(params, arrays, lights, cam, target, sample_idx, pixel_ids=None):
        color, live = render(params, arrays, lights, cam, sample_idx, pixel_ids)
        return jnp.mean((color - target) ** 2), live

    return loss_fn


def make_train_step(meta: SceneMeta, width: int, height: int,
                    max_bounces: int = 3, sky_steps: int = 16,
                    learning_rate: float = 2e-2,
                    trainable: Optional[DiffParams] = None):
    """Single-device inverse-rendering step (adam over DiffParams).

    `trainable`: optional DiffParams of bools selecting which parameter
    groups receive updates (default: all).  Freezing groups matters for
    adam — its per-parameter normalization amplifies tiny Monte-Carlo
    gradient noise in groups that are already correct.

    Returns (init_opt_state, step) where
      step(params, opt_state, arrays, lights, cam, target, sample_idx)
        -> (loss, new_params, new_opt_state)
    """
    import optax

    loss_fn = make_loss_fn(meta, width, height, max_bounces, sky_steps)
    tx = optax.adam(learning_rate)

    @jax.jit
    def step(params, opt_state, arrays, lights, cam, target, sample_idx):
        (loss, _live), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, arrays, lights, cam, target, sample_idx
        )
        if trainable is not None:
            grads = jax.tree.map(
                lambda g, t: g if t else jnp.zeros_like(g), grads, trainable
            )
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return loss, params, opt_state

    return tx.init, step

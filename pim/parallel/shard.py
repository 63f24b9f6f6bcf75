"""Sharded render/train steps over a jax.sharding.Mesh.

The reference's Task_Run(TraceFn, W*H) fork-join over 64 threads
(src/threading/task.c:179-230) becomes `shard_map` over a 'dp' mesh axis:

  rays/pixels   -> sharded along 'dp' (the leading ray axis)
  scene arrays  -> replicated (BVH + textures ≈ TP=1, per SURVEY.md §2.9)
  light 'live'  -> per-device partials, `psum` over 'dp' (the atomics analog)
  param grads   -> `psum` over 'dp' (the all-reduce, NCCL between cards)

The training step differentiates the rendered image w.r.t. material
parameters (atlas texels) — the reference has no gradients; this is the
BASELINE.json differentiability surface.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pim.core import rng
from pim.render.camera import CameraArrays, generate_primary_rays
from pim.render.integrator import trace_rays
from pim.render.scene import LightState, SceneArrays, SceneMeta


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def make_sharded_render_step(meta: SceneMeta, mesh: Mesh, width: int, height: int,
                             max_bounces: int = 4):
    """Returns step(arrays, lights, cam, sample_idx) -> (color, albedo,
    normal, live) with rays sharded over mesh axis 'dp'."""
    n = width * height
    n_dev = mesh.devices.size
    assert n % n_dev == 0, f"pixels {n} must divide devices {n_dev}"

    def shard_body(arrays, lights, cam, pixel_ids, sample_idx):
        # pixel_ids: local shard of the pixel index space
        state = rng.make_state(pixel_ids, sample_idx)
        state, ro, rd = _raygen_for_pixels(cam, width, height, pixel_ids, state)
        res = trace_rays(meta, arrays, lights, ro, rd, state, max_bounces)
        live = jax.lax.psum(res.live, "dp")
        return res.color, res.albedo, res.normal, live

    sharded = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(), P(), P(), P("dp"), P()),
        out_specs=(P("dp"), P("dp"), P("dp"), P()),
        check_vma=False,
    )

    @jax.jit
    def step(arrays, lights, cam, sample_idx):
        pixel_ids = jnp.arange(n, dtype=jnp.uint32)
        return sharded(arrays, lights, cam, pixel_ids, sample_idx)

    return step


def _raygen_for_pixels(cam: CameraArrays, width: int, height: int, pixel_ids, state):
    """Primary rays for an arbitrary pixel-id subset (sharded raygen)."""
    from pim.render.camera import generate_primary_rays

    return generate_primary_rays(cam, width, height, state, pixel_ids=pixel_ids)


def make_sharded_train_step(meta: SceneMeta, mesh: Mesh, width: int, height: int,
                            max_bounces: int = 3, lr: float = 0.05,
                            serialize_reduce: bool = False):
    """The FULL differentiable training step, sharded over 'dp'.

    Loss = L2 between the rendered image and a target; parameters = the
    whole DiffParams surface (flat material albedo/ROME, atlas texels,
    sun, camera — see render.diff).  Per-device: raygen -> wavefront
    trace -> local loss; gradients all-reduce with psum over the mesh
    (the overlap-with-backward-wavefront pattern rides XLA's scheduler).
    Returns step(params, arrays, lights, cam, target, sample_idx)
        -> (loss, new_params, new_lights).

    serialize_reduce=True pins an optimization_barrier between the whole
    backward sweep and the gradient pmeans, forbidding XLA from starting
    any collective before every grad is final — the A/B control
    tools/overlap_ab.py times against the default overlapped schedule.
    """
    from pim.render.diff import make_loss_fn

    n = width * height
    n_dev = mesh.devices.size
    assert n % n_dev == 0
    loss_fn = make_loss_fn(meta, width, height, max_bounces)

    def shard_body(params, arrays, lights, cam, target, pixel_ids, sample_idx):
        (loss, live), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, arrays, lights, cam, target, sample_idx, pixel_ids
        )
        if serialize_reduce:
            loss, grads, live = jax.lax.optimization_barrier(
                (loss, grads, live))
        # gradient + loss all-reduce across the data-parallel axis (the
        # reference's only cross-worker communication is its atomic light
        # histogram — here it is the psum'd live tensor, SURVEY.md §2.9)
        loss = jax.lax.pmean(loss, "dp")
        grads = jax.tree.map(lambda g: jax.lax.pmean(g, "dp"), grads)
        live = jax.lax.psum(live, "dp")
        new_params = jax.tree.map(lambda p, g: p - lr * g, params, grads)
        return loss, new_params, live

    sharded = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P("dp"), P("dp"), P()),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )

    @jax.jit
    def step(params, arrays, lights, cam, target, sample_idx):
        pixel_ids = jnp.arange(n, dtype=jnp.uint32)
        loss, new_params, live = sharded(
            params, arrays, lights, cam, target, pixel_ids, sample_idx
        )
        return loss, new_params, lights._replace(live=lights.live + live)

    return step

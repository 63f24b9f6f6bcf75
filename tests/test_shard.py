"""Sharded render/train step tests on the 8-virtual-device CPU mesh.

Guards the driver's `dryrun_multichip` contract: the full differentiable
train step (pixel-DP shard_map, replicated scene, psum'd grads/histograms)
must compile and execute, and the sharded render must match the unsharded
wavefront bit-for-bit (same counter RNG per pixel id).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pim.core import rng
from pim.geom.cornell import build_cornell_box
from pim.parallel.shard import (
    make_mesh,
    make_sharded_render_step,
    make_sharded_train_step,
)
from pim.render.camera import Camera, DofInfo, camera_arrays, generate_primary_rays
from pim.render.integrator import trace_rays
from pim.render.scene import build_scene


@pytest.fixture(scope="module")
def cornell():
    ents, pool = build_cornell_box("boxes")
    meta, arrays, lights = build_scene(ents, pool, backend="brute")
    return meta, arrays, lights


def _cam(w, h):
    cam = Camera(position=np.array([-4, 0, 4], np.float32))
    cam.look_at([0, -1, 0])
    return camera_arrays(cam, DofInfo(autofocus=False), w, h)


def test_sharded_render_matches_unsharded(cornell):
    meta, arrays, lights = cornell
    w = h = 16
    cam = _cam(w, h)
    mesh = make_mesh(8)
    step = make_sharded_render_step(meta, mesh, w, h, max_bounces=3)
    color, albedo, normal, live = step(arrays, lights, cam, jnp.uint32(0))

    n = w * h
    state = rng.make_state(jnp.arange(n, dtype=jnp.uint32), jnp.uint32(0))
    state, ro, rd = generate_primary_rays(cam, w, h, state)
    ref = trace_rays(meta, arrays, lights, ro, rd, state, max_bounces=3)

    # per-shard XLA fusion reassociates fp ops; allow ~1e-4 relative slack
    np.testing.assert_allclose(np.asarray(color), np.asarray(ref.color), rtol=3e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(live), np.asarray(ref.live))


@pytest.mark.slow
def test_sharded_train_step_runs_and_learns(cornell):
    from pim.render.diff import extract_params

    meta, arrays, lights = cornell
    w = h = 16
    cam = _cam(w, h)
    mesh = make_mesh(8)
    step = make_sharded_train_step(meta, mesh, w, h, max_bounces=2, lr=0.05)
    params = extract_params(meta, arrays, cam)
    target = jnp.zeros((w * h, 3), jnp.float32)

    loss0, params1, lights1 = step(params, arrays, lights, cam, target,
                                   jnp.uint32(0))
    assert np.isfinite(float(loss0))
    # gradients must actually flow into the material table
    moved = float(jnp.max(jnp.abs(params1.mat_albedo - params.mat_albedo)))
    assert moved > 0.0
    # a second step with the updated params must lower the same-seed loss
    loss1, _, _ = step(params1, arrays, lights1, cam, target, jnp.uint32(0))
    assert float(loss1) < float(loss0)
